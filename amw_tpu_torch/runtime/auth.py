"""Auth primitives: password hashing + HS256 JWT (reference: auth.py:47-109,
which uses bcrypt + python-jose; neither is in this image, so passwords use
stdlib PBKDF2-HMAC-SHA256 and JWTs are hand-rolled HS256 — same token wire
format).

The port's copy of ``amw_tpu/runtime/auth.py``: a token signed by either
package with the same secret decodes to the same claims in the other.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import os
import time

from .config import settings

_PBKDF2_ITERS = 200_000


def hash_password(password: str) -> str:
    salt = os.urandom(16)
    dk = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, _PBKDF2_ITERS)
    return f"pbkdf2${_PBKDF2_ITERS}${salt.hex()}${dk.hex()}"


def verify_password(password: str, stored: str) -> bool:
    try:
        scheme, iters, salt_hex, dk_hex = stored.split("$")
        if scheme != "pbkdf2":
            return False
        dk = hashlib.pbkdf2_hmac(
            "sha256", password.encode(), bytes.fromhex(salt_hex), int(iters)
        )
        return hmac.compare_digest(dk.hex(), dk_hex)
    except Exception:
        return False


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_dec(s: str) -> bytes:
    return base64.urlsafe_b64decode(s + "=" * (-len(s) % 4))


def create_token(sub: str, expires_minutes: int | None = None, **claims) -> str:
    header = {"alg": "HS256", "typ": "JWT"}
    exp_min = expires_minutes or settings.jwt_expire_minutes
    payload = {"sub": sub, "exp": int(time.time()) + exp_min * 60, **claims}
    signing = (_b64url(json.dumps(header, separators=(",", ":")).encode())
               + "." + _b64url(json.dumps(payload, separators=(",", ":")).encode()))
    sig = hmac.new(settings.jwt_secret.encode(), signing.encode(),
                   hashlib.sha256).digest()
    return signing + "." + _b64url(sig)


def decode_token(token: str) -> dict | None:
    try:
        signing, sig = token.rsplit(".", 1)
        expect = hmac.new(settings.jwt_secret.encode(), signing.encode(),
                          hashlib.sha256).digest()
        if not hmac.compare_digest(_b64url(expect), sig):
            return None
        payload = json.loads(_b64url_dec(signing.split(".")[1]))
        if payload.get("exp", 0) < time.time():
            return None
        return payload
    except Exception:
        return None


def new_api_key() -> tuple[str, str, str]:
    """-> (full_key, prefix, key_hash)."""
    raw = "mm_" + base64.urlsafe_b64encode(os.urandom(24)).rstrip(b"=").decode()
    return raw, raw[:10], hashlib.sha256(raw.encode()).hexdigest()


def api_key_hash(key: str) -> str:
    return hashlib.sha256(key.encode()).hexdigest()
