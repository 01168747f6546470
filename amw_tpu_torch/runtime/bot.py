"""Telegram user bot (reference: backend/app/bot/** — aiogram 3 webhook bot).

Implemented directly over the Telegram Bot HTTP API (aiogram is not in this
image) with an injectable transport so the whole flow is testable offline.

Covered flows (bot/handlers/master.py, analyze.py, link.py, admin_reports.py):
- /start /help command menus
- /master FSM: audio document → preset keyboard → mastering under the same
  admission semaphores as the web path → document sent back
- /analyze: LUFS/peak/correlation summary for an uploaded file
- /presets: platform preset list
- /ai <text>: rule-based (or LLM) mastering chat
- /link <code>: account linking via one-time codes
- /report (admin): server + job metrics

The port's copy of ``amw_tpu/runtime/bot.py``, with one difference: the
JAX package's bot masters on the module's ``get_engine()``, the port's
``Bot`` on the engine it is given (``engine=``; ``get_engine()`` where none
is, looked up at the first job).  The service passes its own engine, so a
service on a CPU engine runs its bot there instead of building a second
engine on ``cuda``; the bot's analysis runs on that engine's device too.
"""

from __future__ import annotations

import asyncio
import io
import json
import logging
import os
import secrets
import time
import urllib.request

from ..constants import PRESET_LUFS
from ..models.analyze import analyze
from . import db, jobs, users
from .engine import get_engine

logger = logging.getLogger("amw_tpu_torch.bot")

# chat_id -> {"state": str, "file_id": str, "ts": float, ...}
_chat_state: dict[int, dict] = {}

# FSM timeout (reference bot clears stale states; a user who walked away
# mid-flow gets a fresh start instead of a confusing stale keyboard).
STATE_TTL_SEC = 15 * 60
BATCH_MAX_FILES = 10  # mirrors the web batch cap (mastering.py:90)


def _get_state(chat_id: int) -> dict | None:
    st = _chat_state.get(chat_id)
    if st is None:
        return None
    if time.time() - st.get("ts", 0) > STATE_TTL_SEC:
        _chat_state.pop(chat_id, None)
        return None
    return st


def _set_state(chat_id: int, st: dict) -> None:
    st["ts"] = time.time()
    _chat_state[chat_id] = st


def bot_token() -> str | None:
    return (os.environ.get("MAGIC_MASTER_TELEGRAM_BOT_TOKEN")
            or os.environ.get("AMW_TELEGRAM_BOT_TOKEN"))


def _http_api_tok(token: str, method: str, payload: dict) -> dict:
    req = urllib.request.Request(
        f"https://api.telegram.org/bot{token}/{method}",
        data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30) as resp:
        return json.loads(resp.read())


def _http_api(method: str, payload: dict) -> dict:
    return _http_api_tok(bot_token(), method, payload)


def _http_download(file_id: str) -> bytes:
    token = bot_token()
    info = _http_api("getFile", {"file_id": file_id})
    path = info["result"]["file_path"]
    with urllib.request.urlopen(
            f"https://api.telegram.org/file/bot{token}/{path}",
            timeout=120) as resp:
        return resp.read()


class Bot:
    """Telegram bot with injectable transport (tests pass fakes)."""

    def __init__(self, api_call=None, download=None, send_document=None,
                 *, engine=None):
        self.api = api_call or _http_api
        self.download = download or _http_download
        self.send_document = send_document or self._send_document_http
        self._engine = engine

    @property
    def engine(self):
        """The engine the bot masters and analyses on."""
        if self._engine is None:
            self._engine = get_engine()
        return self._engine

    # -- outgoing ----------------------------------------------------------

    def send_text(self, chat_id: int, text: str, keyboard=None) -> None:
        payload = {"chat_id": chat_id, "text": text, "parse_mode": "HTML"}
        if keyboard:
            payload["reply_markup"] = {"inline_keyboard": keyboard}
        try:
            self.api("sendMessage", payload)
        except Exception as e:  # noqa: BLE001
            logger.warning("sendMessage failed: %s", e)

    def _send_document_http(self, chat_id: int, filename: str,
                            blob: bytes, caption: str = "") -> None:
        import uuid

        token = bot_token()
        boundary = uuid.uuid4().hex
        body = io.BytesIO()

        def field(name, value):
            body.write(f"--{boundary}\r\nContent-Disposition: form-data; "
                       f"name=\"{name}\"\r\n\r\n{value}\r\n".encode())

        field("chat_id", chat_id)
        if caption:
            field("caption", caption)
        body.write(f"--{boundary}\r\nContent-Disposition: form-data; "
                   f"name=\"document\"; filename=\"{filename}\"\r\n"
                   "Content-Type: application/octet-stream\r\n\r\n".encode())
        body.write(blob)
        body.write(f"\r\n--{boundary}--\r\n".encode())
        req = urllib.request.Request(
            f"https://api.telegram.org/bot{token}/sendDocument",
            data=body.getvalue(),
            headers={"Content-Type":
                     f"multipart/form-data; boundary={boundary}"})
        urllib.request.urlopen(req, timeout=300)

    # -- incoming ----------------------------------------------------------

    async def handle_update(self, update: dict) -> None:
        if "callback_query" in update:
            await self._on_callback(update["callback_query"])
            return
        msg = update.get("message") or {}
        chat_id = (msg.get("chat") or {}).get("id")
        if chat_id is None:
            return
        text = (msg.get("text") or "").strip()
        doc = msg.get("document") or msg.get("audio")
        if doc:
            await self._on_file(chat_id, doc)
        elif text.startswith("/"):
            await self._on_command(chat_id, msg, text)
        elif (_get_state(chat_id) or {}).get("state") == "ai":
            await self._on_ai(chat_id, text)

    async def _on_command(self, chat_id: int, msg: dict, text: str) -> None:
        cmd, _, arg = text.partition(" ")
        cmd = cmd.split("@")[0].lower()
        if cmd in ("/start", "/help"):
            self.send_text(chat_id, (
                "🎛 <b>Magic Master</b> — TPU mastering bot\n\n"
                "/master — master a track (send an audio file)\n"
                "/analyze — loudness analysis\n"
                "/presets — platform presets\n"
                "/ai — mastering assistant chat\n"
                "/link CODE — link your web account\n"))
        elif cmd == "/master":
            _set_state(chat_id, {"state": "await_file", "mode": "master"})
            self.send_text(chat_id, (
                "Send an audio file (WAV/MP3/FLAC) to master. Send several "
                f"files (up to {BATCH_MAX_FILES}) for a batch."))
        elif cmd == "/analyze":
            _set_state(chat_id, {"state": "await_file", "mode": "analyze"})
            self.send_text(chat_id, "Send an audio file to analyze.")
        elif cmd == "/presets":
            rows = "\n".join(f"• {k}: {v} LUFS" for k, v in PRESET_LUFS.items())
            self.send_text(chat_id, f"Platform presets:\n{rows}")
        elif cmd == "/ai":
            if arg:
                await self._on_ai(chat_id, arg)
            else:
                _set_state(chat_id, {"state": "ai"})
                self.send_text(chat_id, "Ask me anything about mastering.")
        elif cmd == "/link":
            await self._on_link(chat_id, arg.strip())
        elif cmd == "/report":
            await self._on_report(chat_id)
        else:
            self.send_text(chat_id, "Unknown command. /help")

    async def _on_file(self, chat_id: int, doc: dict) -> None:
        st = _get_state(chat_id) or {"mode": "master"}
        mode = st.get("mode", "master")
        fname = doc.get("file_name") or "audio.wav"
        if mode == "analyze":
            self.send_text(chat_id, "Analyzing…")
            try:
                data = await asyncio.to_thread(self.download, doc["file_id"])
                from ..utils.audio_io import load_audio_from_bytes

                audio, sr = load_audio_from_bytes(data, fname)
                a = await asyncio.to_thread(analyze, audio, sr, False,
                                            device=self.engine.device)
                corr = a.get("stereo_correlation")
                self.send_text(chat_id, (
                    f"📊 <b>{fname}</b>\n"
                    f"LUFS: {a.get('lufs')}\nPeak: {a.get('peak_dbfs')} dBFS\n"
                    f"Duration: {a.get('duration_sec')} s\n"
                    + (f"Correlation: {corr}\n" if corr is not None else "")))
            except Exception as e:  # noqa: BLE001
                self.send_text(chat_id, f"Analysis failed: {e}")
            _chat_state.pop(chat_id, None)
            return
        # master flow: collect file(s), offer preset keyboard.  Additional
        # audio files sent before picking a preset become a batch (the bot
        # analog of /api/v2/batch, capped like the web path).
        files = (st.get("files") or []) if st.get("state") == "await_preset" \
            else []
        if len(files) >= BATCH_MAX_FILES:
            self.send_text(chat_id,
                           f"Batch is full ({BATCH_MAX_FILES} files) — pick a "
                           "preset to start mastering.")
            return
        files = files + [(doc["file_id"], fname)]
        _set_state(chat_id, {"state": "await_preset", "files": files})
        kb = [[{"text": f"{k} ({PRESET_LUFS[k]})", "callback_data": f"preset:{k}"}
               for k in row] for row in [["spotify", "apple"], ["club", "youtube"]]]
        label = ("Choose a target preset:" if len(files) == 1 else
                 f"{len(files)} files queued — add more or choose a preset:")
        self.send_text(chat_id, label, keyboard=kb)

    async def _on_callback(self, cq: dict) -> None:
        chat_id = ((cq.get("message") or {}).get("chat") or {}).get("id")
        data = cq.get("data") or ""
        if chat_id is None or not data.startswith("preset:"):
            return
        preset = data.split(":", 1)[1]
        st = _get_state(chat_id)
        if not st or st.get("state") != "await_preset":
            self.send_text(chat_id, "Send a file first: /master")
            return
        target = PRESET_LUFS.get(preset, -14.0)
        files = st.get("files") or [(st.get("file_id"), st.get("fname"))]
        _chat_state.pop(chat_id, None)
        if len(files) == 1:
            self.send_text(chat_id, f"Mastering to {preset} ({target} LUFS)…")
        else:
            self.send_text(chat_id, (f"Mastering {len(files)} files to "
                                     f"{preset} ({target} LUFS)…"))
        linked = _user_by_telegram(chat_id)
        user_id = linked["id"] if linked else None
        sem = jobs.select_semaphore(False)
        for file_id, fname in files:
            try:
                # Telegram I/O happens OUTSIDE the admission semaphore, and
                # the slot is re-acquired per file: one user's 10-file batch
                # must not pin a mastering slot for minutes of downloads/
                # uploads and starve the web jobs sharing the semaphore
                # (reference holds it only around run_mastering_sync,
                # bot/handlers/master.py:168-177).
                data_bytes = await asyncio.to_thread(self.download, file_id)
                async with sem:
                    res = await asyncio.to_thread(
                        self.engine.master_v2_bytes, data_bytes, fname,
                        target_lufs=target, out_format="wav", style="standard")
                out_name = fname.rsplit(".", 1)[0] + "_mastered.wav"
                await asyncio.to_thread(
                    self.send_document, chat_id, out_name, res["bytes"],
                    f"✅ {res['after_lufs']:.1f} LUFS"
                    if res.get("after_lufs") else "✅ done")
                db.record_mastering(user_id, fname, "standard", target,
                                    res.get("before_lufs"),
                                    res.get("after_lufs"), "wav",
                                    source="telegram")
            except Exception as e:  # noqa: BLE001
                self.send_text(chat_id, f"❌ {fname}: mastering failed: {e}")

    async def _on_ai(self, chat_id: int, text: str) -> None:
        from . import ai, llm_guard

        ok, err, cleaned = llm_guard.validate_llm_input(text, "chat")
        if not ok:
            self.send_text(chat_id, f"⚠️ {err}")
            return
        out = await asyncio.to_thread(
            ai.chat, [{"role": "user", "content": cleaned}])
        self.send_text(chat_id, out["reply"][:4000])

    async def _on_link(self, chat_id: int, code: str) -> None:
        if not code:
            self.send_text(chat_id, "Usage: /link CODE "
                                    "(get the code in your web profile)")
            return
        with db.connect() as c:
            row = c.execute(
                "SELECT * FROM telegram_link_codes WHERE code=? AND used=0",
                (code.strip().upper(),)).fetchone()
            if row is None or time.time() - row["created_at"] > 3600:
                self.send_text(chat_id, "Code is invalid or expired.")
                return
            c.execute("UPDATE telegram_link_codes SET used=1 WHERE code=?",
                      (row["code"],))
        users.update_user(int(row["user_id"]), telegram_id=chat_id)
        self.send_text(chat_id, "✅ Account linked.")

    async def _on_report(self, chat_id: int) -> None:
        u = _user_by_telegram(chat_id)
        if not u or not u.get("is_admin"):
            self.send_text(chat_id, "Admin only.")
            return
        from .server_metrics import server_metrics_text

        c = jobs.counts()
        with db.connect() as conn:
            day = time.time() - 86400
            m24 = conn.execute(
                "SELECT COUNT(*) n FROM mastering_records WHERE created_at > ?",
                (day,)).fetchone()["n"]
            e24 = conn.execute(
                "SELECT COUNT(*) n FROM mastering_jobs WHERE status='error'"
                " AND created_at > ?", (day,)).fetchone()["n"]
        self.send_text(chat_id, (
            f"📈 <b>Report</b>\nJobs running: {c['jobs_running']}\n"
            f"Masterings 24h: {m24}\nErrors 24h: {e24}\n\n"
            + server_metrics_text()))


def _user_by_telegram(chat_id: int) -> dict | None:
    with db.connect() as c:
        r = c.execute("SELECT * FROM users WHERE telegram_id=?",
                      (chat_id,)).fetchone()
    return dict(r) if r else None


def create_link_code(user_id: int) -> str:
    code = secrets.token_hex(3).upper()
    with db.connect() as c:
        c.execute("INSERT INTO telegram_link_codes (code, user_id,"
                  " created_at, used) VALUES (?,?,?,0)",
                  (code, user_id, time.time()))
    return code


# --- notify/admin bot (reference: bot/notify_bot_setup.py,
# notify_handlers.py — webhook /bot/notify/webhook) --------------------------
#
# A SECOND bot on the alert token (settings.telegram_bot_token — the same
# token the notifier sends server alerts with): the admin chat gets a
# bottom-menu of operational reports plus /broadcast relayed through the
# USER bot.  Admin commands are served ONLY to the configured
# settings.telegram_admin_chat_id — anyone else (or everyone, when no
# admin chat is configured) gets the help hint.  The reference
# additionally gates by webhook secret + bot membership
# (notify_handlers.py:108); the secret check lives in
# service.h_notify_bot_webhook.

NOTIFY_MENU = ("📊 Stats", "🧰 Jobs", "⚠️ Errors", "💰 Revenue",
               "🖥 Server", "📢 Broadcast", "❓ Help")

_NOTIFY_HINT = ("This chat is for <b>service notifications</b> and admin "
                "reports.\nFor mastering, analysis and AI open the client "
                "bot.")


def notify_bot_token() -> str | None:
    from .config import settings

    tok = (settings.telegram_bot_token or "").strip()
    return tok or None


class NotifyBot:
    """Admin/notify bot with injectable transport (tests pass fakes)."""

    def __init__(self, api_call=None):
        self.api = api_call or (
            lambda m, p: _http_api_tok(notify_bot_token(), m, p))

    def send_text(self, chat_id: int, text: str) -> None:
        payload = {"chat_id": chat_id, "text": text, "parse_mode": "HTML",
                   "disable_web_page_preview": True,
                   "reply_markup": {"keyboard": [[{"text": t}] for t in
                                                 NOTIFY_MENU],
                                    "resize_keyboard": True}}
        try:
            self.api("sendMessage", payload)
        except Exception as e:  # noqa: BLE001
            logger.warning("notify sendMessage failed: %s", e)

    @staticmethod
    def _is_admin_chat(chat_id) -> bool:
        from .config import settings

        admin = str(settings.telegram_admin_chat_id or "").strip()
        return bool(admin) and str(chat_id) == admin

    async def handle_update(self, update: dict) -> None:
        self.handle_update_sync(update)

    def handle_update_sync(self, update: dict) -> None:
        """Synchronous body — the transport is blocking urllib and
        /broadcast loops over every linked user, so the webhook offloads
        this to a worker thread (service.h_notify_bot_webhook) instead of
        running it on the event loop."""
        msg = update.get("message") or {}
        chat_id = (msg.get("chat") or {}).get("id")
        text = (msg.get("text") or "").strip()
        if chat_id is None or not text:
            return
        if text.startswith("/start") or text.startswith("/help") \
                or text == "❓ Help":
            self.send_text(chat_id, _NOTIFY_HINT)
        elif not self._is_admin_chat(chat_id):
            # Reports and /broadcast are admin-only; with no admin chat
            # configured, nobody gets them (safe default).
            self.send_text(chat_id, _NOTIFY_HINT)
        elif text.startswith("/broadcast") or text == "📢 Broadcast":
            body = text.split(maxsplit=1)[1].strip() \
                if text.startswith("/broadcast") and " " in text else ""
            if not body:
                self.send_text(chat_id,
                               "Send:\n<code>/broadcast your message</code>")
            else:
                n = broadcast_to_users(body)
                self.send_text(chat_id, f"📢 Sent to {n} user chat(s).")
        elif text == "📊 Stats":
            self.send_text(chat_id, _report_stats())
        elif text == "🧰 Jobs":
            self.send_text(chat_id, _report_jobs())
        elif text == "⚠️ Errors":
            self.send_text(chat_id, _report_errors())
        elif text == "💰 Revenue":
            self.send_text(chat_id, _report_revenue())
        elif text == "🖥 Server":
            from .server_metrics import server_metrics_text

            self.send_text(chat_id, "🖥 <b>Server</b>\n"
                           + server_metrics_text())


def broadcast_to_users(body: str) -> int:
    """Send ``body`` to every linked Telegram chat via the USER bot
    (reference notify_handlers.py:108-131 relays through the user bot so
    subscribers see the familiar sender)."""
    if not bot_token():
        return 0
    ub = Bot()
    with db.connect() as c:
        rows = c.execute("SELECT DISTINCT telegram_id FROM users"
                         " WHERE telegram_id IS NOT NULL").fetchall()
    n = 0
    for r in rows:
        # Call the API directly (Bot.send_text swallows errors internally)
        # so the returned count reflects DELIVERED messages, matching the
        # reference's success accounting.
        try:
            ub.api("sendMessage", {"chat_id": int(r["telegram_id"]),
                                   "text": body[:4000],
                                   "parse_mode": "HTML"})
            n += 1
        except Exception:  # noqa: BLE001
            pass
    return n


def _report_stats() -> str:
    with db.connect() as c:
        users_n = c.execute("SELECT COUNT(*) n FROM users").fetchone()["n"]
        day = time.time() - 86400
        m24 = c.execute("SELECT COUNT(*) n FROM mastering_records"
                        " WHERE created_at > ?", (day,)).fetchone()["n"]
        m_all = c.execute(
            "SELECT COUNT(*) n FROM mastering_records").fetchone()["n"]
    return (f"📊 <b>Stats</b>\nUsers: {users_n}\n"
            f"Masterings 24h: {m24}\nMasterings total: {m_all}")


def _report_jobs() -> str:
    c = jobs.counts()
    return (f"🧰 <b>Jobs</b>\nRunning: {c['jobs_running']}\n"
            f"Total tracked: {c['jobs_total']}")


def _report_errors(limit: int = 10) -> str:
    day = time.time() - 86400
    with db.connect() as c:
        rows = c.execute(
            "SELECT error, created_at FROM mastering_jobs"
            " WHERE status='error' AND created_at > ?"
            " ORDER BY created_at DESC LIMIT ?", (day, limit)).fetchall()
    if not rows:
        return "⚠️ <b>Errors 24h</b>\nNone 🎉"
    lines = [f"• {(r['error'] or '?')[:120]}" for r in rows]
    return "⚠️ <b>Errors 24h</b>\n" + "\n".join(lines)


def _report_revenue() -> str:
    day = time.time() - 86400
    month = time.time() - 30 * 86400
    with db.connect() as c:
        r24 = c.execute(
            "SELECT COALESCE(SUM(amount), 0) s FROM transactions"
            " WHERE status='succeeded' AND created_at > ?",
            (day,)).fetchone()["s"]
        r30 = c.execute(
            "SELECT COALESCE(SUM(amount), 0) s FROM transactions"
            " WHERE status='succeeded' AND created_at > ?",
            (month,)).fetchone()["s"]
    return f"💰 <b>Revenue</b>\n24h: {r24:.2f}\n30d: {r30:.2f}"


# --- Telegram channel posting (reference: bot/channel.py) -------------------


def post_to_channel(text: str, api_call=None) -> bool:
    """Post HTML to the configured channel (settings.user_bot_channel_id)
    via the user bot token.  Returns False when unconfigured."""
    from .config import settings

    chat = (settings.user_bot_channel_id or "").strip()
    if not chat or not bot_token():
        return False
    api = api_call or _http_api
    try:
        api("sendMessage", {"chat_id": chat, "text": text[:4000],
                            "parse_mode": "HTML",
                            "disable_web_page_preview": True})
        return True
    except Exception as e:  # noqa: BLE001
        logger.warning("channel post failed: %s", e)
        return False


def post_channel_weekly_stats(api_call=None) -> bool:
    """One channel post with a usage summary (cron, weekly — reference:
    bot/engagement.py:91-106)."""
    month = time.time() - 30 * 86400
    with db.connect() as c:
        u = c.execute("SELECT COUNT(*) n FROM users").fetchone()["n"]
        m = c.execute("SELECT COUNT(*) n FROM mastering_records"
                      " WHERE created_at > ?", (month,)).fetchone()["n"]
    from .config import settings

    base = (settings.public_base_url or "").rstrip("/")
    return post_to_channel(
        f"📊 Magic Master: {u} users, {m} masterings this month. {base}",
        api_call=api_call)


# --- engagement drip campaigns (bot/engagement.py:21-106) ------------------

ENGAGEMENT_STAGES = (
    (1 * 86400, "👋 Did you know? /analyze gives you a free LUFS report."),
    (3 * 86400, "🎚 Try a genre preset: /master then pick club for -9 LUFS."),
    (7 * 86400, "💡 Link your web account with /link to sync your history."),
)


def run_engagement_tick(bot: Bot) -> int:
    """One cron tick: send the next stage message to due chats."""
    now = time.time()
    sent = 0
    with db.connect() as c:
        rows = c.execute("SELECT * FROM telegram_engagement").fetchall()
    for r in rows:
        stage = int(r["stage"])
        if stage >= len(ENGAGEMENT_STAGES):
            continue
        delay, text = ENGAGEMENT_STAGES[stage]
        if now - r["created_at"] >= delay and (
                not r["last_sent_at"] or now - r["last_sent_at"] > 20 * 3600):
            bot.send_text(int(r["telegram_id"]), text)
            with db.connect() as c:
                c.execute("UPDATE telegram_engagement SET stage=?,"
                          " last_sent_at=? WHERE id=?",
                          (stage + 1, now, r["id"]))
            sent += 1
    return sent
