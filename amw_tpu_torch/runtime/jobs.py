"""Job store + admission control (reference: backend/app/jobs_store.py).

In-memory dict of job dicts keyed by UUID, mirrored to SQLite (without the
audio payloads), TTL-pruned; two asyncio semaphores gate concurrency
(priority 2 / normal 1, env-tunable).  ``restore_from_db`` marks jobs that
were running at shutdown as errored ("service restarted") — recovery is
status-truthfulness, not resume (SURVEY §5.4).

The port's copy of ``amw_tpu/runtime/jobs.py``.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Optional

from . import db
from .config import settings
from . import settings_store

# Semaphores are created per event loop: a Semaphore whose holder task dies
# with its loop would otherwise stay acquired forever (and asyncio primitives
# must not be shared across loops).
_sems: dict[tuple[int, str], asyncio.Semaphore] = {}

_jobs: dict[str, dict] = {}


def all_jobs() -> dict[str, dict]:
    return _jobs


def new_job(job_id: str, *, target_lufs: float, style: str, data: bytes,
            filename: str, out_format: str,
            notify_user_id: Optional[int] = None, **extra: Any) -> dict:
    job = {
        "status": "running",
        "progress": 0,
        "message": "Waiting…",
        "created_at": time.time(),
        "done_at": None,
        "result_bytes": None,
        "filename": None,
        "error": None,
        "before_lufs": None,
        "after_lufs": None,
        "target_lufs": target_lufs,
        "style": style,
        "original_bytes": data,
        "original_filename": filename,
        "out_format": out_format.lower(),
        "notify_user_id": notify_user_id,
        **extra,
    }
    _jobs[job_id] = job
    _mirror(job_id)
    return job


def get_job(job_id: str) -> Optional[dict]:
    return _jobs.get(job_id)


def update_job(job_id: str, **fields: Any) -> None:
    job = _jobs.get(job_id)
    if job is None:
        return
    job.update(fields)
    if fields.get("status") in ("done", "error") or "error" in fields:
        job.setdefault("done_at", None)
        if job.get("status") in ("done", "error") and not job.get("done_at"):
            job["done_at"] = time.time()
        _mirror(job_id)


def _mirror(job_id: str) -> None:
    try:
        db.job_upsert(job_id, _jobs[job_id])
    except Exception:
        pass


def prune_jobs() -> None:
    now = time.time()
    ttl = settings_store.get_setting_int("jobs_done_ttl_seconds", 3600)
    max_entries = settings.jobs_max_entries
    dead = [jid for jid, j in _jobs.items()
            if j.get("status") in ("done", "error") and j.get("done_at")
            and now - j["done_at"] > ttl]
    for jid in dead:
        _jobs.pop(jid, None)
    if len(_jobs) > max_entries:
        by_created = sorted(_jobs.items(), key=lambda kv: kv[1].get("created_at", 0))
        for jid, _ in by_created[: len(_jobs) - max_entries]:
            _jobs.pop(jid, None)


def restore_from_db() -> int:
    """Mark interrupted jobs as errored after a restart."""
    try:
        return db.job_mark_interrupted()
    except Exception:
        return 0


def select_semaphore(is_priority: bool) -> asyncio.Semaphore:
    loop = asyncio.get_running_loop()
    kind = "priority" if is_priority else "normal"
    key = (id(loop), kind)
    sem = _sems.get(key)
    if sem is None:
        slots = settings.semaphore_priority if is_priority else settings.semaphore_normal
        sem = asyncio.Semaphore(max(1, slots))
        if len(_sems) > 64:
            _sems.clear()
        _sems[key] = sem
    return sem


def counts() -> dict:
    running = sum(1 for j in _jobs.values() if j.get("status") == "running")
    return {"jobs_running": running, "jobs_total": len(_jobs)}
