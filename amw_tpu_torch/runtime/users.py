"""User/API-key/preset/history accessors over sqlite3 (reference:
backend/app/database.py accessor functions).

The port's copy of ``amw_tpu/runtime/users.py``.
"""

from __future__ import annotations

import secrets
import time

from . import db


def _migrate() -> None:
    with db.connect() as c:
        cols = {r["name"] for r in c.execute("PRAGMA table_info(users)")}
        for col, ddl in (
            ("is_blocked", "INTEGER NOT NULL DEFAULT 0"),
            ("last_login_at", "REAL"),
            ("subscription_status", "TEXT DEFAULT 'none'"),
        ):
            if col not in cols:
                c.execute(f"ALTER TABLE users ADD COLUMN {col} {ddl}")


def ensure_schema() -> None:
    db.create_tables()
    _migrate()


def _row_to_user(r) -> dict | None:
    return dict(r) if r is not None else None


def get_user_by_email(email: str) -> dict | None:
    with db.connect() as c:
        r = c.execute("SELECT * FROM users WHERE email=?",
                      (email.strip().lower(),)).fetchone()
    return _row_to_user(r)


def get_user_by_id(uid: int) -> dict | None:
    with db.connect() as c:
        r = c.execute("SELECT * FROM users WHERE id=?", (uid,)).fetchone()
    return _row_to_user(r)


def create_user(email: str, password_hash: str, tier: str = "pro",
                referred_by: int | None = None) -> dict:
    code = secrets.token_hex(4).upper()
    with db.connect() as c:
        cur = c.execute(
            "INSERT INTO users (email, password_hash, tier, tokens,"
            " referral_code, referred_by, created_at)"
            " VALUES (?,?,?,?,?,?,?)",
            (email.strip().lower(), password_hash, tier, 0, code,
             referred_by, time.time()),
        )
        uid = cur.lastrowid
    return get_user_by_id(uid)


def update_user(uid: int, **fields) -> None:
    if not fields:
        return
    cols = ", ".join(f"{k}=?" for k in fields)
    with db.connect() as c:
        c.execute(f"UPDATE users SET {cols} WHERE id=?",
                  (*fields.values(), uid))


def get_user_by_referral_code(code: str) -> dict | None:
    with db.connect() as c:
        r = c.execute("SELECT * FROM users WHERE referral_code=?",
                      (code.strip().upper(),)).fetchone()
    return _row_to_user(r)


def add_tokens(uid: int, n: int) -> None:
    with db.connect() as c:
        c.execute("UPDATE users SET tokens = tokens + ? WHERE id=?", (n, uid))


def user_stats(uid: int) -> dict:
    with db.connect() as c:
        total = c.execute(
            "SELECT COUNT(*) AS n FROM mastering_records WHERE user_id=?",
            (uid,)).fetchone()["n"]
        last = c.execute(
            "SELECT created_at FROM mastering_records WHERE user_id=?"
            " ORDER BY created_at DESC LIMIT 1", (uid,)).fetchone()
    return {"masterings_total": int(total),
            "last_mastering_at": last["created_at"] if last else None}


# --- history --------------------------------------------------------------


def add_history_record(uid: int | None, filename, style, target_lufs,
                       before_lufs, after_lufs, out_format,
                       source="web") -> None:
    db.record_mastering(uid, filename, style, target_lufs, before_lufs,
                        after_lufs, out_format, source)


def list_history(uid: int, limit: int = 100) -> list[dict]:
    with db.connect() as c:
        rows = c.execute(
            "SELECT * FROM mastering_records WHERE user_id=?"
            " ORDER BY created_at DESC LIMIT ?", (uid, limit)).fetchall()
    return [dict(r) for r in rows]


def delete_history_record(uid: int, record_id: int) -> bool:
    with db.connect() as c:
        cur = c.execute(
            "DELETE FROM mastering_records WHERE id=? AND user_id=?",
            (record_id, uid))
        return cur.rowcount > 0


# --- API keys -------------------------------------------------------------


def list_api_keys(uid: int) -> list[dict]:
    with db.connect() as c:
        rows = c.execute(
            "SELECT id, prefix, name, created_at, last_used_at FROM api_keys"
            " WHERE user_id=? AND revoked=0 ORDER BY created_at DESC",
            (uid,)).fetchall()
    return [dict(r) for r in rows]


def create_api_key(uid: int, key_hash: str, prefix: str, name: str) -> int:
    with db.connect() as c:
        cur = c.execute(
            "INSERT INTO api_keys (user_id, key_hash, prefix, name,"
            " created_at) VALUES (?,?,?,?,?)",
            (uid, key_hash, prefix, name, time.time()))
        return cur.lastrowid


def revoke_api_key(uid: int, key_id: int) -> bool:
    with db.connect() as c:
        cur = c.execute(
            "UPDATE api_keys SET revoked=1 WHERE id=? AND user_id=?",
            (key_id, uid))
        return cur.rowcount > 0


def find_user_by_api_key_hash(key_hash: str) -> dict | None:
    with db.connect() as c:
        r = c.execute(
            "SELECT u.* FROM api_keys k JOIN users u ON u.id = k.user_id"
            " WHERE k.key_hash=? AND k.revoked=0", (key_hash,)).fetchone()
        if r is not None:
            c.execute("UPDATE api_keys SET last_used_at=? WHERE key_hash=?",
                      (time.time(), key_hash))
    return _row_to_user(r)


# --- saved presets --------------------------------------------------------


def list_presets(uid: int) -> list[dict]:
    with db.connect() as c:
        rows = c.execute(
            "SELECT id, name, config_json, created_at FROM saved_presets"
            " WHERE user_id=? ORDER BY created_at DESC", (uid,)).fetchall()
    return [dict(r) for r in rows]


def save_preset(uid: int, name: str, config_json: str) -> int:
    with db.connect() as c:
        cur = c.execute(
            "INSERT INTO saved_presets (user_id, name, config_json,"
            " created_at) VALUES (?,?,?,?)",
            (uid, name, config_json, time.time()))
        return cur.lastrowid


def get_preset(uid: int, preset_id: int) -> dict | None:
    with db.connect() as c:
        r = c.execute(
            "SELECT * FROM saved_presets WHERE id=? AND user_id=?",
            (preset_id, uid)).fetchone()
    return dict(r) if r else None


def delete_preset(uid: int, preset_id: int) -> bool:
    with db.connect() as c:
        cur = c.execute(
            "DELETE FROM saved_presets WHERE id=? AND user_id=?",
            (preset_id, uid))
        return cur.rowcount > 0


def list_community_presets(limit: int = 50) -> list[dict]:
    with db.connect() as c:
        rows = c.execute(
            "SELECT id, name, config_json, created_at FROM saved_presets"
            " WHERE is_community=1 ORDER BY created_at DESC LIMIT ?",
            (limit,)).fetchall()
    return [dict(r) for r in rows]
