"""Auth / account routes (reference: backend/app/routers/auth.py).

register/login/me/logout, email verification, forgot/reset password (single-
use tokens), profile, change-password, mastering history (+CSV export),
API keys CRUD, saved presets CRUD.

The port's copy of ``amw_tpu/runtime/auth_routes.py``.
"""

from __future__ import annotations

import asyncio
import csv
import io
import json
import secrets
import time

from aiohttp import web

from . import deps, mailer, users
from .auth import (create_token, hash_password, new_api_key,
                   verify_password)
from .config import settings

_VERIFY_TTL = 24 * 3600
_RESET_TTL = 3600
_verify_tokens: dict[str, dict] = {}
_reset_tokens: dict[str, dict] = {}


def _cleanup(tokens: dict) -> None:
    now = time.time()
    for t in [t for t, e in tokens.items() if e["exp"] < now]:
        tokens.pop(t, None)


def _err(status: int, detail: str):
    cls = {400: web.HTTPBadRequest, 401: web.HTTPUnauthorized,
           403: web.HTTPForbidden, 404: web.HTTPNotFound,
           409: web.HTTPConflict, 429: web.HTTPTooManyRequests,
           503: web.HTTPServiceUnavailable}.get(status, web.HTTPBadRequest)
    return cls(text=json.dumps({"detail": detail}),
               content_type="application/json")


def _require_user(request) -> dict:
    user = deps.get_current_user_optional(request)
    if not user:
        raise _err(401, "Not authorized")
    return user


async def _body(request) -> dict:
    try:
        return await request.json()
    except Exception:  # noqa: BLE001
        return {}


def _token_response(u: dict) -> dict:
    token = create_token(str(u["id"]), email=u["email"], tier=u["tier"],
                         is_admin=bool(u["is_admin"]))
    return {"access_token": token, "token_type": "bearer",
            "email": u["email"], "tier": u["tier"],
            "is_admin": bool(u["is_admin"])}


async def h_register(request):
    deps.require_feature("registration_enabled")
    if not deps.check_auth_rate_limit(deps.client_ip(request)):
        raise _err(429, "Too many attempts. Wait 1 minute.")
    body = await _body(request)
    email = (body.get("email") or "").strip().lower()
    password = body.get("password") or ""
    if "@" not in email or len(password) < 6:
        raise _err(400, "Valid email and a password of 6+ characters required")
    if users.get_user_by_email(email):
        raise _err(400, "A user with this email already exists")
    u = users.create_user(email, hash_password(password), tier="pro")

    ref = (body.get("ref") or "").strip().upper()
    if ref:
        inviter = users.get_user_by_referral_code(ref)
        if inviter and inviter["id"] != u["id"]:
            users.update_user(u["id"], referred_by=inviter["id"])
            from . import db

            with db.connect() as c:
                c.execute(
                    "INSERT INTO referrals (inviter_id, invitee_id, rewarded,"
                    " created_at) VALUES (?,?,0,?)",
                    (inviter["id"], u["id"], time.time()))
            users.add_tokens(u["id"],
                             max(1, settings.referral_reward_invitee_tokens))

    if settings.require_email_verify:
        users.update_user(u["id"], is_verified=0)
        _cleanup(_verify_tokens)
        vtoken = secrets.token_urlsafe(32)
        _verify_tokens[vtoken] = {"email": email,
                                  "exp": time.time() + _VERIFY_TTL}
        base = str(request.url.origin())
        asyncio.get_event_loop().run_in_executor(
            None, mailer.send_email_verification, email,
            f"{base}/verify-email?token={vtoken}")
        resp = {"message": "Account created. Check your email and confirm "
                           "your address to sign in.",
                "email": email, "requires_verification": True}
        if settings.debug:
            resp["debug_token"] = vtoken
        return web.json_response(resp)
    users.update_user(u["id"], is_verified=1)
    asyncio.get_event_loop().run_in_executor(
        None, mailer.send_welcome_email, email, email)
    return web.json_response(_token_response(users.get_user_by_id(u["id"])))


async def h_login(request):
    if not deps.check_auth_rate_limit(deps.client_ip(request)):
        raise _err(429, "Too many login attempts. Wait 1 minute.")
    body = await _body(request)
    u = users.get_user_by_email(body.get("email") or "")
    if not u or not verify_password(body.get("password") or "",
                                    u["password_hash"]):
        raise _err(401, "Invalid email or password")
    if u.get("is_blocked"):
        raise _err(403, "Account blocked. Contact support.")
    if settings.require_email_verify and not u.get("is_verified"):
        raise _err(403, "Email not confirmed. Check your inbox.")
    users.update_user(u["id"], last_login_at=time.time())
    return web.json_response(_token_response(u))


async def h_me(request):
    user = _require_user(request)
    return web.json_response({
        "email": user.get("email"),
        "tier": user.get("tier", "free"),
        "user_id": user.get("sub"),
        "is_admin": bool(user.get("is_admin", False)),
    })


async def h_logout(request):
    return web.json_response({"message": "Token removed client-side"})


async def h_profile(request):
    user = _require_user(request)
    u = users.get_user_by_email(user.get("email") or "")
    if not u:
        raise _err(404, "User not found")
    return web.json_response({
        "email": u["email"],
        "tier": u["tier"],
        "is_admin": bool(u["is_admin"]),
        "is_blocked": bool(u.get("is_blocked")),
        "tokens": int(u.get("tokens") or 0),
        "subscription_status": u.get("subscription_status") or "none",
        "subscription_expires_at": u.get("subscription_until"),
        "referral_code": u.get("referral_code"),
        "created_at": u["created_at"],
        "last_login_at": u.get("last_login_at"),
        "stats": users.user_stats(int(u["id"])),
    })


async def h_change_password(request):
    user = _require_user(request)
    body = await _body(request)
    u = users.get_user_by_email(user.get("email") or "")
    if not u or not verify_password(body.get("old_password") or "",
                                    u["password_hash"]):
        raise _err(400, "Current password is incorrect")
    new = body.get("new_password") or ""
    if len(new) < 6:
        raise _err(400, "New password must be 6+ characters")
    users.update_user(u["id"], password_hash=hash_password(new))
    return web.json_response({"message": "Password changed"})


async def h_forgot_password(request):
    if not deps.check_auth_rate_limit(deps.client_ip(request)):
        raise _err(429, "Too many attempts. Wait 1 minute.")
    body = await _body(request)
    u = users.get_user_by_email(body.get("email") or "")
    if u:
        _cleanup(_reset_tokens)
        token = secrets.token_urlsafe(32)
        _reset_tokens[token] = {"uid": u["id"], "exp": time.time() + _RESET_TTL}
        base = str(request.url.origin())
        asyncio.get_event_loop().run_in_executor(
            None, mailer.send_password_reset, u["email"],
            f"{base}/reset-password?token={token}")
        resp = {"message": "If the account exists, a reset link was sent."}
        if settings.debug:
            resp["debug_token"] = token
        return web.json_response(resp)
    return web.json_response(
        {"message": "If the account exists, a reset link was sent."})


async def h_reset_password(request):
    body = await _body(request)
    token = body.get("token") or ""
    _cleanup(_reset_tokens)
    entry = _reset_tokens.get(token)
    if not entry:
        raise _err(400, "Link is invalid or expired.")
    new = body.get("new_password") or ""
    if len(new) < 6:
        raise _err(400, "New password must be 6+ characters")
    users.update_user(entry["uid"], password_hash=hash_password(new))
    _reset_tokens.pop(token, None)  # single use
    return web.json_response({"message": "Password updated. You can log in."})


async def h_record(request):
    user = _require_user(request)
    body = await _body(request)
    users.add_history_record(
        int(user["sub"]), body.get("filename"), body.get("style"),
        body.get("target_lufs"), body.get("before_lufs"),
        body.get("after_lufs"), body.get("out_format"), source="web")
    return web.json_response({"message": "recorded"})


async def h_history(request):
    user = _require_user(request)
    rows = users.list_history(int(user["sub"]))
    return web.json_response({"items": rows, "count": len(rows)})


async def h_history_delete(request):
    user = _require_user(request)
    rid = int(request.match_info["record_id"])
    if not users.delete_history_record(int(user["sub"]), rid):
        raise _err(404, "Record not found")
    return web.json_response({"message": "deleted"})


async def h_history_csv(request):
    user = _require_user(request)
    rows = users.list_history(int(user["sub"]), limit=10000)
    buf = io.StringIO()
    w = csv.writer(buf)
    w.writerow(["id", "filename", "style", "target_lufs", "before_lufs",
                "after_lufs", "out_format", "source", "created_at"])
    for r in rows:
        w.writerow([r["id"], r["filename"], r["style"], r["target_lufs"],
                    r["before_lufs"], r["after_lufs"], r["out_format"],
                    r["source"], r["created_at"]])
    return web.Response(
        text=buf.getvalue(), content_type="text/csv",
        headers={"Content-Disposition": 'attachment; filename="history.csv"'})


async def h_api_keys_list(request):
    user = _require_user(request)
    return web.json_response({"items": users.list_api_keys(int(user["sub"]))})


async def h_api_keys_create(request):
    user = _require_user(request)
    body = await _body(request)
    raw, prefix, key_hash = new_api_key()
    kid = users.create_api_key(int(user["sub"]), key_hash, prefix,
                               body.get("name") or "api-key")
    return web.json_response(
        {"id": kid, "key": raw, "prefix": prefix,
         "message": "Store the key now; it is not shown again."},
        status=201)


async def h_api_keys_delete(request):
    user = _require_user(request)
    if not users.revoke_api_key(int(user["sub"]),
                                int(request.match_info["key_id"])):
        raise _err(404, "Key not found")
    return web.json_response({"message": "revoked"})


async def h_presets_list(request):
    user = _require_user(request)
    items = users.list_presets(int(user["sub"]))
    for it in items:
        try:
            it["config"] = json.loads(it.pop("config_json"))
        except Exception:  # noqa: BLE001
            it["config"] = None
    return web.json_response({"items": items})


async def h_presets_create(request):
    user = _require_user(request)
    body = await _body(request)
    name = (body.get("name") or "").strip()
    config = body.get("config")
    if not name or not isinstance(config, dict):
        raise _err(400, "name and config are required")
    pid = users.save_preset(int(user["sub"]), name, json.dumps(config))
    return web.json_response({"id": pid, "name": name})


async def h_presets_get(request):
    user = _require_user(request)
    p = users.get_preset(int(user["sub"]), int(request.match_info["preset_id"]))
    if not p:
        raise _err(404, "Preset not found")
    p["config"] = json.loads(p.pop("config_json"))
    return web.json_response(p)


async def h_presets_delete(request):
    user = _require_user(request)
    if not users.delete_preset(int(user["sub"]),
                               int(request.match_info["preset_id"])):
        raise _err(404, "Preset not found")
    return web.json_response({"message": "deleted"})


async def h_verify_email(request):
    token = request.query.get("token", "")
    _cleanup(_verify_tokens)
    entry = _verify_tokens.get(token)
    if not entry:
        raise _err(400, "Link is invalid or expired.")
    u = users.get_user_by_email(entry["email"])
    if not u:
        raise _err(404, "User not found")
    users.update_user(int(u["id"]), is_verified=1)
    _verify_tokens.pop(token, None)
    asyncio.get_event_loop().run_in_executor(
        None, mailer.send_welcome_email, u["email"], u["email"])
    return web.json_response({"message": "Email confirmed! You can sign in.",
                              "email": u["email"]})


async def h_resend_verification(request):
    if not deps.check_auth_rate_limit(deps.client_ip(request)):
        raise _err(429, "Too many attempts. Wait 1 minute.")
    body = await _body(request)
    u = users.get_user_by_email(body.get("email") or "")
    resp = {"message": "If the account awaits verification, a mail was sent."}
    if u and not u.get("is_verified"):
        _cleanup(_verify_tokens)
        vtoken = secrets.token_urlsafe(32)
        _verify_tokens[vtoken] = {"email": u["email"],
                                  "exp": time.time() + _VERIFY_TTL}
        base = str(request.url.origin())
        asyncio.get_event_loop().run_in_executor(
            None, mailer.send_email_verification, u["email"],
            f"{base}/verify-email?token={vtoken}")
        if settings.debug:
            resp["debug_token"] = vtoken
    return web.json_response(resp)


async def h_telegram_link_code(request):
    user = _require_user(request)
    from .bot import create_link_code

    code = create_link_code(int(user["sub"]))
    return web.json_response({"code": code, "expires_in_sec": 3600})


def register_routes(app: web.Application) -> None:
    r = app.router
    r.add_post("/api/auth/register", h_register)
    r.add_post("/api/auth/login", h_login)
    r.add_get("/api/auth/me", h_me)
    r.add_post("/api/auth/logout", h_logout)
    r.add_get("/api/auth/profile", h_profile)
    r.add_post("/api/auth/change-password", h_change_password)
    r.add_post("/api/auth/forgot-password", h_forgot_password)
    r.add_post("/api/auth/reset-password", h_reset_password)
    r.add_post("/api/auth/record", h_record)
    r.add_get("/api/auth/history", h_history)
    r.add_delete("/api/auth/history/{record_id}", h_history_delete)
    r.add_get("/api/auth/history/export.csv", h_history_csv)
    r.add_get("/api/auth/api-keys", h_api_keys_list)
    r.add_post("/api/auth/api-keys", h_api_keys_create)
    r.add_delete("/api/auth/api-keys/{key_id}", h_api_keys_delete)
    r.add_get("/api/auth/presets", h_presets_list)
    r.add_post("/api/auth/presets", h_presets_create)
    r.add_get("/api/auth/presets/{preset_id}", h_presets_get)
    r.add_post("/api/auth/telegram-link-code", h_telegram_link_code)
    r.add_get("/api/auth/verify-email", h_verify_email)
    r.add_post("/api/auth/resend-verification", h_resend_verification)
    r.add_delete("/api/auth/presets/{preset_id}", h_presets_delete)
