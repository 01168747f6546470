"""SQLite persistence (stdlib sqlite3; the reference uses SQLAlchemy —
database.py:39-260 — with graceful degradation, mirrored here).

Schema covers the reference's models: users, mastering_jobs,
mastering_records, saved_presets, transactions, system_settings, api_keys,
audit_log, news_posts, referrals, telegram_link_codes, telegram_engagement,
email_campaigns, prompt_templates, ai_usage_log, mastering_job_events.
Accessors are added as the runtime grows; everything is thread-safe via a
per-call connection (WAL mode).

The port's copy of ``amw_tpu/runtime/db.py``, with its own module-level
connection state (``set_db_path``), separate from the JAX package's.
"""

from __future__ import annotations

import json
import os
import sqlite3
import threading
import time
from contextlib import contextmanager

from .config import settings

_lock = threading.Lock()
DB_AVAILABLE = True

_SCHEMA = """
CREATE TABLE IF NOT EXISTS users (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    email TEXT UNIQUE NOT NULL,
    password_hash TEXT NOT NULL,
    display_name TEXT,
    tier TEXT NOT NULL DEFAULT 'free',
    tokens INTEGER NOT NULL DEFAULT 0,
    is_admin INTEGER NOT NULL DEFAULT 0,
    is_verified INTEGER NOT NULL DEFAULT 0,
    verify_token TEXT,
    reset_token TEXT,
    reset_token_used INTEGER NOT NULL DEFAULT 0,
    subscription_until REAL,
    telegram_id INTEGER,
    referral_code TEXT,
    referred_by INTEGER,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS mastering_jobs (
    job_id TEXT PRIMARY KEY,
    status TEXT NOT NULL DEFAULT 'pending',
    progress REAL NOT NULL DEFAULT 0,
    message TEXT,
    created_at REAL NOT NULL,
    done_at REAL,
    result_path TEXT,
    preview_path TEXT,
    error TEXT,
    user_id INTEGER,
    meta_json TEXT
);
CREATE TABLE IF NOT EXISTS mastering_records (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    user_id INTEGER,
    filename TEXT,
    style TEXT,
    target_lufs REAL,
    before_lufs REAL,
    after_lufs REAL,
    out_format TEXT,
    source TEXT DEFAULT 'web',
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS saved_presets (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    user_id INTEGER NOT NULL,
    name TEXT NOT NULL,
    config_json TEXT NOT NULL,
    is_community INTEGER NOT NULL DEFAULT 0,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS transactions (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    user_id INTEGER,
    amount REAL,
    currency TEXT,
    status TEXT,
    provider TEXT,
    provider_id TEXT,
    plan TEXT,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS system_settings (
    key TEXT PRIMARY KEY,
    value TEXT,
    updated_at REAL
);
CREATE TABLE IF NOT EXISTS api_keys (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    user_id INTEGER NOT NULL,
    key_hash TEXT NOT NULL,
    prefix TEXT NOT NULL,
    name TEXT,
    created_at REAL NOT NULL,
    last_used_at REAL,
    revoked INTEGER NOT NULL DEFAULT 0
);
CREATE TABLE IF NOT EXISTS audit_log (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    admin_id INTEGER,
    action TEXT,
    target TEXT,
    details TEXT,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS news_posts (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    title TEXT NOT NULL,
    body TEXT NOT NULL,
    published INTEGER NOT NULL DEFAULT 1,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS referrals (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    inviter_id INTEGER NOT NULL,
    invitee_id INTEGER NOT NULL,
    rewarded INTEGER NOT NULL DEFAULT 0,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS telegram_link_codes (
    code TEXT PRIMARY KEY,
    user_id INTEGER NOT NULL,
    created_at REAL NOT NULL,
    used INTEGER NOT NULL DEFAULT 0
);
CREATE TABLE IF NOT EXISTS telegram_engagement (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    telegram_id INTEGER NOT NULL,
    stage INTEGER NOT NULL DEFAULT 0,
    last_sent_at REAL,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS email_campaigns (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    subject TEXT NOT NULL,
    body TEXT NOT NULL,
    status TEXT NOT NULL DEFAULT 'draft',
    sent_count INTEGER NOT NULL DEFAULT 0,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS prompt_templates (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    name TEXT NOT NULL,
    version INTEGER NOT NULL DEFAULT 1,
    template TEXT NOT NULL,
    active INTEGER NOT NULL DEFAULT 1,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS ai_usage_log (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    user_id INTEGER,
    kind TEXT,
    created_at REAL NOT NULL
);
CREATE TABLE IF NOT EXISTS mastering_job_events (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    job_id TEXT,
    user_id INTEGER,
    event TEXT,
    created_at REAL NOT NULL
);
"""

_db_path_cache: str | None = None


def db_path() -> str:
    global _db_path_cache
    if _db_path_cache is None:
        _db_path_cache = os.environ.get("AMW_DB_PATH", settings.db_path)
    return _db_path_cache


def set_db_path(path: str) -> None:
    global _db_path_cache
    _db_path_cache = path
    create_tables()


@contextmanager
def connect():
    conn = sqlite3.connect(db_path(), timeout=30.0)
    conn.row_factory = sqlite3.Row
    try:
        conn.execute("PRAGMA journal_mode=WAL")
        yield conn
        conn.commit()
    finally:
        conn.close()


def create_tables() -> None:
    with _lock, connect() as c:
        c.executescript(_SCHEMA)


# --- jobs mirror ----------------------------------------------------------


def job_upsert(job_id: str, job: dict) -> None:
    meta = {k: v for k, v in job.items()
            if k not in ("result_bytes", "original_bytes")
            and isinstance(v, (str, int, float, bool, type(None)))}
    with connect() as c:
        c.execute(
            "INSERT INTO mastering_jobs (job_id, status, progress, message,"
            " created_at, done_at, error, user_id, meta_json)"
            " VALUES (?,?,?,?,?,?,?,?,?)"
            " ON CONFLICT(job_id) DO UPDATE SET status=excluded.status,"
            " progress=excluded.progress, message=excluded.message,"
            " done_at=excluded.done_at, error=excluded.error,"
            " meta_json=excluded.meta_json",
            (job_id, job.get("status", "pending"), float(job.get("progress", 0)),
             job.get("message"), job.get("created_at", time.time()),
             job.get("done_at"), job.get("error"), job.get("notify_user_id"),
             json.dumps(meta, default=str)),
        )


def job_load_recent(max_age_sec: float = 24 * 3600) -> list[dict]:
    cutoff = time.time() - max_age_sec
    with connect() as c:
        rows = c.execute(
            "SELECT * FROM mastering_jobs WHERE created_at > ?", (cutoff,)
        ).fetchall()
    return [dict(r) for r in rows]


def job_mark_interrupted() -> int:
    """running -> error on boot (jobs_store.py:190-238 restore semantics)."""
    with connect() as c:
        cur = c.execute(
            "UPDATE mastering_jobs SET status='error',"
            " error='Service was restarted' WHERE status IN ('running','pending')"
        )
        return cur.rowcount


# --- records / settings ---------------------------------------------------


def record_mastering(user_id, filename, style, target_lufs, before_lufs,
                     after_lufs, out_format, source="web") -> None:
    with connect() as c:
        c.execute(
            "INSERT INTO mastering_records (user_id, filename, style,"
            " target_lufs, before_lufs, after_lufs, out_format, source,"
            " created_at) VALUES (?,?,?,?,?,?,?,?,?)",
            (user_id, filename, style, target_lufs, before_lufs, after_lufs,
             out_format, source, time.time()),
        )


def setting_get(key: str):
    with connect() as c:
        row = c.execute(
            "SELECT value FROM system_settings WHERE key=?", (key,)
        ).fetchone()
    return None if row is None else row["value"]


def setting_set(key: str, value) -> None:
    with connect() as c:
        c.execute(
            "INSERT INTO system_settings (key, value, updated_at) VALUES (?,?,?)"
            " ON CONFLICT(key) DO UPDATE SET value=excluded.value,"
            " updated_at=excluded.updated_at",
            (key, None if value is None else str(value), time.time()),
        )


def settings_all() -> dict:
    with connect() as c:
        rows = c.execute("SELECT key, value FROM system_settings").fetchall()
    return {r["key"]: r["value"] for r in rows}
