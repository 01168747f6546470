"""DB-backed runtime settings overrides (reference: settings_store.py:103-225).

Resolution order: system_settings table -> env/config default.  Includes the
derived upload-limit policy ``get_max_upload_mb(filename, tier)`` =
min(tier cap, format cap).

The port's copy of ``amw_tpu/runtime/settings_store.py``.
"""

from __future__ import annotations

from . import db
from .config import settings


def _get(key: str):
    try:
        return db.setting_get(key)
    except Exception:
        return None


def get_setting_str(key: str, default: str | None = None) -> str | None:
    v = _get(key)
    if v is not None:
        return v
    return getattr(settings, key, default)


def get_setting_int(key: str, default: int = 0) -> int:
    v = _get(key)
    if v is not None:
        try:
            return int(float(v))
        except ValueError:
            pass
    return int(getattr(settings, key, default))


def get_setting_float(key: str, default: float = 0.0) -> float:
    v = _get(key)
    if v is not None:
        try:
            return float(v)
        except ValueError:
            pass
    return float(getattr(settings, key, default))


def get_setting_bool(key: str, default: bool = False) -> bool:
    v = _get(key)
    if v is not None:
        return str(v).strip().lower() in ("1", "true", "yes", "on", "y")
    return bool(getattr(settings, key, default))


def set_setting(key: str, value) -> None:
    db.setting_set(key, value)


def get_max_upload_mb(filename: str, tier: str = "free") -> int:
    ext = (filename or "").rsplit(".", 1)[-1].lower()
    fmt_cap = {
        "wav": get_setting_int("max_upload_mb_wav", 800),
        "mp3": get_setting_int("max_upload_mb_mp3", 300),
        "flac": get_setting_int("max_upload_mb_flac", 500),
    }.get(ext, get_setting_int("max_upload_mb_mp3", 300))
    tier_cap = {
        "free": get_setting_int("tier_upload_mb_free", 100),
        "pro": get_setting_int("tier_upload_mb_pro", 300),
        "studio": get_setting_int("tier_upload_mb_studio", 800),
    }.get(tier, get_setting_int("tier_upload_mb_free", 100))
    return min(fmt_cap, tier_cap)
