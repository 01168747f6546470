"""Admin notifications via Telegram (reference: backend/app/notifier.py).

Sends through the Telegram Bot HTTP API when a token/chat id is configured;
throttles repeated alerts per key; logs otherwise.  Zero-egress/dev
environments simply log.

The port's copy of ``amw_tpu/runtime/notifier.py``.
"""

from __future__ import annotations

import json
import logging
import os
import time
import urllib.request

logger = logging.getLogger("amw_tpu_torch.notifier")

_THROTTLE_SEC = 600.0
_last_sent: dict[str, float] = {}


def _conf():
    from .config import settings

    token = (settings.telegram_bot_token
             or os.environ.get("MAGIC_MASTER_TELEGRAM_BOT_TOKEN")
             or os.environ.get("AMW_TELEGRAM_BOT_TOKEN"))
    chat = (settings.telegram_admin_chat_id
            or os.environ.get("MAGIC_MASTER_TELEGRAM_ADMIN_CHAT_ID")
            or os.environ.get("AMW_TELEGRAM_ADMIN_CHAT_ID"))
    if not token or not chat:
        return None
    return {"token": token, "chat": chat}


def send_telegram(text: str, chat_id: str | None = None) -> bool:
    conf = _conf()
    if conf is None:
        logger.info("notifier (no telegram configured): %s", text[:200])
        return False
    try:
        req = urllib.request.Request(
            f"https://api.telegram.org/bot{conf['token']}/sendMessage",
            data=json.dumps({"chat_id": chat_id or conf["chat"],
                             "text": text, "parse_mode": "HTML"}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=20) as resp:
            return resp.status == 200
    except Exception as e:  # noqa: BLE001
        logger.warning("notifier failed: %s", e)
        return False


def notify_admin(text: str, throttle_key: str | None = None) -> bool:
    if throttle_key:
        now = time.time()
        if now - _last_sent.get(throttle_key, 0) < _THROTTLE_SEC:
            return False
        _last_sent[throttle_key] = now
    return send_telegram(text)


def notify_server_startup(version: str) -> bool:
    return notify_admin(f"🚀 Magic Master TPU started, version {version}")


def notify_job_error(job_id: str, error: str) -> bool:
    return notify_admin(f"❌ Mastering job {job_id} failed: {error[:300]}",
                        throttle_key="job_error")


def notify_new_user(email: str, tier: str) -> bool:
    return notify_admin(f"👤 New user: {email} ({tier})",
                        throttle_key="new_user")


def notify_payment(email: str, amount, plan: str) -> bool:
    return notify_admin(f"💰 Payment: {email} — {amount} ({plan})")
