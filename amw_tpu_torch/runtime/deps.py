"""Request dependencies: user extraction, rate limits, feature flags
(reference: backend/app/deps.py).

The port's copy of ``amw_tpu/runtime/deps.py``.
"""

from __future__ import annotations

import time
from collections import defaultdict, deque

from aiohttp import web

from . import settings_store, users
from .auth import api_key_hash, decode_token
from .config import settings

# per-IP deques of timestamps
_weekly_usage: dict[str, int] = defaultdict(int)
_weekly_stamp: dict[str, str] = {}
_auth_attempts: dict[str, deque] = defaultdict(deque)
_global_hits: dict[str, deque] = defaultdict(deque)


def _is_trusted_proxy(peer: str | None) -> bool:
    """Only the reverse proxy in front of us may supply forwarding headers.

    Default trusted set: loopback + RFC1918 (the shipped nginx runs on the
    same host / private network).  Override with the ``trusted_proxies``
    setting (comma-separated exact IPs; empty string disables header trust
    entirely)."""
    if not peer:
        return False
    conf = (getattr(settings, "trusted_proxies", None) or "").strip()
    if conf:
        return peer in {p.strip() for p in conf.split(",") if p.strip()}
    if peer in ("127.0.0.1", "::1", "localhost"):
        return True
    return (peer.startswith("10.") or peer.startswith("192.168.")
            or any(peer.startswith(f"172.{i}.") for i in range(16, 32)))


def client_ip(request: web.Request) -> str:
    """Client IP for rate limiting / whitelists.

    Forwarding headers are attacker-controlled unless the direct peer is our
    own reverse proxy, so: (1) ignore them entirely from untrusted peers;
    (2) from a trusted proxy prefer X-Real-IP (nginx sets it to $remote_addr,
    unforgeable), else take the LAST X-Forwarded-For hop — the one appended
    by our proxy — never the first, which the client chooses."""
    peer = request.remote
    if _is_trusted_proxy(peer):
        real = request.headers.get("X-Real-IP")
        if real and real.strip():
            return real.strip()
        fwd = request.headers.get("X-Forwarded-For")
        if fwd:
            return fwd.split(",")[-1].strip()
    return peer or "unknown"


def get_current_user_optional(request: web.Request) -> dict | None:
    """JWT bearer or X-API-Key -> user payload dict (sub, email, tier,
    is_admin), with subscription-expiry downgrade (deps.py:20-77)."""
    auth = request.headers.get("Authorization", "")
    payload = None
    if auth.lower().startswith("bearer "):
        payload = decode_token(auth[7:].strip())
    if payload is None:
        api_key = request.headers.get("X-API-Key")
        if api_key:
            u = users.find_user_by_api_key_hash(api_key_hash(api_key))
            if u and not u.get("is_blocked"):
                payload = {"sub": str(u["id"]), "email": u["email"],
                           "tier": u["tier"],
                           "is_admin": bool(u["is_admin"])}
    if payload is None:
        return None
    # subscription expiry downgrade
    try:
        u = users.get_user_by_id(int(payload["sub"]))
    except (TypeError, ValueError):
        u = None
    if u is not None:
        if u.get("is_blocked"):
            return None
        until = u.get("subscription_until")
        tier = (u.get("tier") or "free").lower()
        if tier in ("pro", "studio") and until and until < time.time():
            users.update_user(int(u["id"]), tier="free",
                              subscription_status="expired")
            payload["tier"] = "free"
        else:
            payload["tier"] = tier
        payload["is_admin"] = bool(u.get("is_admin"))
    return payload


def _week_key() -> str:
    t = time.gmtime()
    return f"{t.tm_year}-{time.strftime('%U', t)}"


def check_free_weekly_limit(ip: str) -> dict:
    """Free anonymous users: 1 mastering per IP per week (deps.py:81-120)."""
    wk = _week_key()
    if _weekly_stamp.get(ip) != wk:
        _weekly_stamp[ip] = wk
        _weekly_usage[ip] = 0
    limit = settings_store.get_setting_int("free_weekly_limit", 1)
    used = _weekly_usage[ip]
    return {"used": used, "limit": limit, "allowed": used < limit}


def record_free_usage(ip: str, n: int = 1) -> None:
    _weekly_usage[ip] += n


def reset_rate_limits() -> None:
    """Test hook (reference tests clear in-memory counters)."""
    _weekly_usage.clear()
    _weekly_stamp.clear()
    _auth_attempts.clear()
    _global_hits.clear()


def check_auth_rate_limit(ip: str) -> bool:
    """10 auth attempts per minute per IP (deps.py:125)."""
    now = time.time()
    q = _auth_attempts[ip]
    while q and q[0] < now - 60.0:
        q.popleft()
    if len(q) >= settings.auth_rate_per_minute:
        return False
    q.append(now)
    return True


def check_global_rate_limit(ip: str) -> bool:
    """300 requests per minute per IP (main.py:151-187)."""
    now = time.time()
    q = _global_hits[ip]
    while q and q[0] < now - 60.0:
        q.popleft()
    if len(q) >= settings.rate_limit_per_minute:
        return False
    q.append(now)
    return True


def is_priority_user(user: dict | None) -> bool:
    return bool(user) and (user.get("tier") or "").lower() in ("pro", "studio")


def require_feature(name: str) -> None:
    if not settings_store.get_setting_bool(name, True):
        raise web.HTTPServiceUnavailable(
            text='{"detail": "Feature disabled"}',
            content_type="application/json")
