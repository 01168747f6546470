"""Transactional mail (reference: backend/app/mailer.py — SMTP).

Sends via stdlib smtplib when SMTP settings are configured; otherwise logs
the message (CI/dev behavior, same as the reference without SMTP creds).

The port's copy of ``amw_tpu/runtime/mailer.py``.
"""

from __future__ import annotations

import logging
import os
import smtplib
from email.message import EmailMessage

logger = logging.getLogger("amw_tpu_torch.mailer")


def _smtp_conf():
    from .config import settings

    host = (settings.smtp_host
            or os.environ.get("MAGIC_MASTER_SMTP_HOST")
            or os.environ.get("AMW_SMTP_HOST"))
    if not host:
        return None
    return {
        "host": host,
        "port": int(os.environ.get("MAGIC_MASTER_SMTP_PORT",
                                   str(settings.smtp_port))),
        "user": os.environ.get("MAGIC_MASTER_SMTP_USER", settings.smtp_user),
        "password": os.environ.get("MAGIC_MASTER_SMTP_PASSWORD",
                                   settings.smtp_password),
        "from": os.environ.get("MAGIC_MASTER_SMTP_FROM", settings.smtp_from),
        "use_tls": settings.smtp_use_tls,
    }


def send_email(to: str, subject: str, body: str) -> bool:
    conf = _smtp_conf()
    if conf is None:
        logger.info("mailer (no SMTP configured): to=%s subject=%s", to, subject)
        return False
    try:
        msg = EmailMessage()
        msg["From"] = conf["from"]
        msg["To"] = to
        msg["Subject"] = subject
        msg.set_content(body)
        with smtplib.SMTP(conf["host"], conf["port"], timeout=20) as s:
            if conf["use_tls"]:
                s.starttls()
            if conf["user"]:
                s.login(conf["user"], conf["password"])
            s.send_message(msg)
        return True
    except Exception as e:  # noqa: BLE001
        logger.warning("mailer failed: %s", e)
        return False


def send_welcome_email(to: str, name: str) -> bool:
    return send_email(to, "Welcome to Magic Master",
                      f"Hi {name}, your mastering account is ready.")


def send_email_verification(to: str, verify_url: str) -> bool:
    return send_email(to, "Confirm your email",
                      f"Confirm your account: {verify_url}")


def send_password_reset(to: str, reset_url: str) -> bool:
    return send_email(to, "Password reset",
                      f"Reset your password: {reset_url}")
