"""Admin panel API under /api/admin (reference: backend/app/admin.py —
stats, user management, transactions, news, campaigns, audit log, runtime
settings, LLM test, prompt templates, reports, CSV exports, DB backup).

The port's copy of ``amw_tpu/runtime/admin_routes.py``.
"""

from __future__ import annotations

import csv
import io
import json
import time

from aiohttp import web

from .. import __version__
from . import ai, db, deps, jobs, mailer, settings_store, users
from .auth import hash_password
from .config import settings


def _err(status, detail):
    cls = {400: web.HTTPBadRequest, 401: web.HTTPUnauthorized,
           403: web.HTTPForbidden, 404: web.HTTPNotFound}.get(
        status, web.HTTPBadRequest)
    return cls(text=json.dumps({"detail": detail}),
               content_type="application/json")


def _require_admin(request) -> dict:
    user = deps.get_current_user_optional(request)
    if not user:
        raise _err(401, "Not authorized")
    if not user.get("is_admin"):
        raise _err(403, "Admin access required")
    return user


def audit(admin: dict, action: str, target: str = "", details: str = "") -> None:
    with db.connect() as c:
        c.execute(
            "INSERT INTO audit_log (admin_id, action, target, details,"
            " created_at) VALUES (?,?,?,?,?)",
            (int(admin["sub"]), action, target, details[:1000], time.time()))


def ensure_initial_admin() -> None:
    """Create the initial admin from env (reference main.py:226-271)."""
    import os

    email = (os.environ.get("MAGIC_MASTER_ADMIN_EMAIL")
             or os.environ.get("AMW_ADMIN_EMAIL"))
    password = (os.environ.get("MAGIC_MASTER_ADMIN_PASSWORD")
                or os.environ.get("AMW_ADMIN_PASSWORD"))
    if not email or not password:
        return
    u = users.get_user_by_email(email)
    if u is None:
        u = users.create_user(email, hash_password(password), tier="studio")
    users.update_user(int(u["id"]), is_admin=1)


async def _body(request) -> dict:
    try:
        return await request.json()
    except Exception:  # noqa: BLE001
        return {}


# --- stats -----------------------------------------------------------------


async def h_stats(request):
    _require_admin(request)
    now = time.time()
    day = now - 86400
    with db.connect() as c:
        n_users = c.execute("SELECT COUNT(*) n FROM users").fetchone()["n"]
        n_users_day = c.execute(
            "SELECT COUNT(*) n FROM users WHERE created_at > ?", (day,)
        ).fetchone()["n"]
        n_masterings = c.execute(
            "SELECT COUNT(*) n FROM mastering_records").fetchone()["n"]
        n_masterings_day = c.execute(
            "SELECT COUNT(*) n FROM mastering_records WHERE created_at > ?",
            (day,)).fetchone()["n"]
        revenue = c.execute(
            "SELECT COALESCE(SUM(amount),0) s FROM transactions"
            " WHERE status='succeeded'").fetchone()["s"]
        by_tier = {r["tier"]: r["n"] for r in c.execute(
            "SELECT tier, COUNT(*) n FROM users GROUP BY tier")}
        errors_day = c.execute(
            "SELECT COUNT(*) n FROM mastering_jobs WHERE status='error' AND"
            " created_at > ?", (day,)).fetchone()["n"]
    c_jobs = jobs.counts()
    return web.json_response({
        "users_total": n_users, "users_24h": n_users_day,
        "masterings_total": n_masterings, "masterings_24h": n_masterings_day,
        "revenue_total": revenue, "users_by_tier": by_tier,
        "job_errors_24h": errors_day, **c_jobs, "version": __version__,
    })


# --- users -----------------------------------------------------------------

_USER_FIELDS = ("id", "email", "display_name", "tier", "tokens", "is_admin",
                "is_blocked", "subscription_until", "subscription_status",
                "created_at", "last_login_at", "referral_code")


def _user_public(u: dict) -> dict:
    return {k: u.get(k) for k in _USER_FIELDS}


async def h_users_list(request):
    _require_admin(request)
    q = request.query.get("q", "").strip().lower()
    limit = min(int(request.query.get("limit", 100)), 500)
    offset = int(request.query.get("offset", 0))
    with db.connect() as c:
        if q:
            rows = c.execute(
                "SELECT * FROM users WHERE email LIKE ? ORDER BY id DESC"
                " LIMIT ? OFFSET ?", (f"%{q}%", limit, offset)).fetchall()
        else:
            rows = c.execute(
                "SELECT * FROM users ORDER BY id DESC LIMIT ? OFFSET ?",
                (limit, offset)).fetchall()
        total = c.execute("SELECT COUNT(*) n FROM users").fetchone()["n"]
    return web.json_response({
        "items": [_user_public(dict(r)) for r in rows], "total": total})


async def h_user_get(request):
    _require_admin(request)
    u = users.get_user_by_id(int(request.match_info["user_id"]))
    if not u:
        raise _err(404, "User not found")
    out = _user_public(u)
    out["stats"] = users.user_stats(int(u["id"]))
    return web.json_response(out)


async def h_user_patch(request):
    admin = _require_admin(request)
    uid = int(request.match_info["user_id"])
    if not users.get_user_by_id(uid):
        raise _err(404, "User not found")
    body = await _body(request)
    allowed = {}
    for k in ("tier", "tokens", "is_admin", "is_blocked", "display_name"):
        if k in body:
            allowed[k] = body[k]
    if "password" in body and body["password"]:
        allowed["password_hash"] = hash_password(str(body["password"]))
    if allowed:
        users.update_user(uid, **allowed)
        audit(admin, "user_patch", str(uid), json.dumps(
            {k: v for k, v in allowed.items() if k != "password_hash"}))
    return web.json_response(_user_public(users.get_user_by_id(uid)))


async def h_user_delete(request):
    admin = _require_admin(request)
    uid = int(request.match_info["user_id"])
    with db.connect() as c:
        cur = c.execute("DELETE FROM users WHERE id=?", (uid,))
        if cur.rowcount == 0:
            raise _err(404, "User not found")
    audit(admin, "user_delete", str(uid))
    return web.json_response({"message": "deleted"})


async def h_users_bulk(request):
    admin = _require_admin(request)
    body = await _body(request)
    ids = [int(i) for i in body.get("user_ids", [])]
    action = body.get("action")
    if not ids or action not in ("block", "unblock", "set_tier", "add_tokens"):
        raise _err(400, "user_ids and a valid action required")
    for uid in ids:
        if action == "block":
            users.update_user(uid, is_blocked=1)
        elif action == "unblock":
            users.update_user(uid, is_blocked=0)
        elif action == "set_tier":
            users.update_user(uid, tier=str(body.get("tier", "free")))
        elif action == "add_tokens":
            users.add_tokens(uid, int(body.get("tokens", 0)))
    audit(admin, f"bulk_{action}", ",".join(map(str, ids)))
    return web.json_response({"message": "ok", "count": len(ids)})


async def h_user_subscription(request):
    admin = _require_admin(request)
    uid = int(request.match_info["user_id"])
    body = await _body(request)
    tier = str(body.get("tier", "pro"))
    days = int(body.get("days", 30))
    until = time.time() + days * 86400
    users.update_user(uid, tier=tier, subscription_until=until,
                      subscription_status="active")
    audit(admin, "subscription_set", str(uid), f"{tier}/{days}d")
    return web.json_response({"tier": tier, "subscription_until": until})


# --- transactions ----------------------------------------------------------


async def h_transactions(request):
    _require_admin(request)
    limit = min(int(request.query.get("limit", 100)), 500)
    with db.connect() as c:
        rows = c.execute(
            "SELECT * FROM transactions ORDER BY id DESC LIMIT ?",
            (limit,)).fetchall()
    return web.json_response({"items": [dict(r) for r in rows]})


async def h_transaction_create(request):
    admin = _require_admin(request)
    body = await _body(request)
    with db.connect() as c:
        cur = c.execute(
            "INSERT INTO transactions (user_id, amount, currency, status,"
            " provider, provider_id, plan, created_at) VALUES (?,?,?,?,?,?,?,?)",
            (body.get("user_id"), float(body.get("amount", 0)),
             body.get("currency", "RUB"), body.get("status", "succeeded"),
             body.get("provider", "manual"), body.get("provider_id"),
             body.get("plan"), time.time()))
        tid = cur.lastrowid
    audit(admin, "transaction_create", str(tid))
    return web.json_response({"id": tid})


# --- news ------------------------------------------------------------------


async def h_news_list(request):
    _require_admin(request)
    with db.connect() as c:
        rows = c.execute(
            "SELECT * FROM news_posts ORDER BY id DESC LIMIT 200").fetchall()
    return web.json_response({"items": [dict(r) for r in rows]})


async def h_news_create(request):
    admin = _require_admin(request)
    body = await _body(request)
    if not body.get("title"):
        raise _err(400, "title required")
    with db.connect() as c:
        cur = c.execute(
            "INSERT INTO news_posts (title, body, published, created_at)"
            " VALUES (?,?,?,?)",
            (body["title"], body.get("body", ""),
             1 if body.get("published", True) else 0, time.time()))
        pid = cur.lastrowid
    audit(admin, "news_create", str(pid))
    return web.json_response({"id": pid})


async def h_news_update(request):
    admin = _require_admin(request)
    pid = int(request.match_info["post_id"])
    body = await _body(request)
    with db.connect() as c:
        cur = c.execute(
            "UPDATE news_posts SET title=COALESCE(?,title),"
            " body=COALESCE(?,body), published=COALESCE(?,published)"
            " WHERE id=?",
            (body.get("title"), body.get("body"),
             None if "published" not in body else int(bool(body["published"])),
             pid))
        if cur.rowcount == 0:
            raise _err(404, "Post not found")
    audit(admin, "news_update", str(pid))
    return web.json_response({"message": "updated"})


async def h_news_delete(request):
    admin = _require_admin(request)
    pid = int(request.match_info["post_id"])
    with db.connect() as c:
        cur = c.execute("DELETE FROM news_posts WHERE id=?", (pid,))
        if cur.rowcount == 0:
            raise _err(404, "Post not found")
    audit(admin, "news_delete", str(pid))
    return web.json_response({"message": "deleted"})


# --- campaigns -------------------------------------------------------------


async def h_campaigns(request):
    _require_admin(request)
    with db.connect() as c:
        rows = c.execute(
            "SELECT * FROM email_campaigns ORDER BY id DESC").fetchall()
    return web.json_response({"items": [dict(r) for r in rows]})


async def h_campaign_create(request):
    admin = _require_admin(request)
    body = await _body(request)
    if not body.get("subject"):
        raise _err(400, "subject required")
    with db.connect() as c:
        cur = c.execute(
            "INSERT INTO email_campaigns (subject, body, status, created_at)"
            " VALUES (?,?,?,?)",
            (body["subject"], body.get("body", ""), "draft", time.time()))
        cid = cur.lastrowid
    audit(admin, "campaign_create", str(cid))
    return web.json_response({"id": cid})


async def h_campaign_send(request):
    admin = _require_admin(request)
    cid = int(request.match_info["campaign_id"])
    with db.connect() as c:
        camp = c.execute("SELECT * FROM email_campaigns WHERE id=?",
                         (cid,)).fetchone()
        if camp is None:
            raise _err(404, "Campaign not found")
        emails = [r["email"] for r in c.execute(
            "SELECT email FROM users WHERE is_blocked=0")]
    sent = 0
    for e in emails:
        if mailer.send_email(e, camp["subject"], camp["body"]):
            sent += 1
    with db.connect() as c:
        c.execute("UPDATE email_campaigns SET status='sent', sent_count=?"
                  " WHERE id=?", (sent, cid))
    audit(admin, "campaign_send", str(cid), f"sent={sent}/{len(emails)}")
    return web.json_response({"sent": sent, "recipients": len(emails)})


async def h_campaign_stats(request):
    """Per-campaign drill-down (round-5 item 5): the campaign row plus the
    current audience size and delivery rate, so the admin stats view is a
    panel rather than a raw row dump."""
    _require_admin(request)
    cid = int(request.match_info["campaign_id"])
    with db.connect() as c:
        camp = c.execute("SELECT * FROM email_campaigns WHERE id=?",
                         (cid,)).fetchone()
        if camp is None:
            raise _err(404, "Campaign not found")
        audience = c.execute(
            "SELECT COUNT(*) FROM users WHERE email IS NOT NULL"
            " AND is_blocked=0").fetchone()[0]
    out = dict(camp)
    out["audience_total"] = audience
    sent = int(out.get("sent_count") or 0)
    out["delivery_pct"] = (round(100.0 * sent / audience, 1)
                           if audience else 0.0)
    return web.json_response(out)


# --- audit / settings / prompts -------------------------------------------


async def h_audit(request):
    _require_admin(request)
    limit = min(int(request.query.get("limit", 100)), 1000)
    with db.connect() as c:
        rows = c.execute(
            "SELECT * FROM audit_log ORDER BY id DESC LIMIT ?",
            (limit,)).fetchall()
    return web.json_response({"items": [dict(r) for r in rows]})


_EDITABLE_SETTINGS = (
    "default_target_lufs", "jobs_done_ttl_seconds", "free_weekly_limit",
    "max_upload_mb_wav", "max_upload_mb_mp3", "max_upload_mb_flac",
    "tier_upload_mb_free", "tier_upload_mb_pro", "tier_upload_mb_studio",
    "feature_ai_enabled", "feature_batch_enabled", "registration_enabled",
    "maintenance_mode", "lufs_tool_rate_per_hour", "ai_api_key",
    "ai_api_base", "ai_model", "llm_guard_forbidden", "llm_guard_regex",
    "ai_prompt_recommend", "engine_exact_mode",
    "vocal_isolation_enabled", "require_email_verify",
    "yookassa_shop_id", "yookassa_webhook_ip_whitelist",
)


async def h_settings_get(request):
    _require_admin(request)
    overrides = db.settings_all()
    out = {}
    for key in _EDITABLE_SETTINGS:
        out[key] = {
            "value": overrides.get(key, getattr(settings, key, None)),
            "overridden": key in overrides,
            "default": getattr(settings, key, None),
        }
    return web.json_response(out)


async def h_settings_patch(request):
    admin = _require_admin(request)
    body = await _body(request)
    changed = []
    for k, v in body.items():
        if k not in _EDITABLE_SETTINGS:
            continue
        if v is None:
            with db.connect() as c:
                c.execute("DELETE FROM system_settings WHERE key=?", (k,))
        else:
            settings_store.set_setting(k, v)
        changed.append(k)
    audit(admin, "settings_patch", ",".join(changed))
    return web.json_response({"updated": changed})


async def h_llm_test(request):
    _require_admin(request)
    reply = ai.llm_chat([{"role": "user", "content": "ping"}], max_tokens=10)
    return web.json_response({
        "configured": ai._llm_config() is not None,
        "ok": reply is not None,
        "reply": reply,
    })


async def h_prompts(request):
    _require_admin(request)
    with db.connect() as c:
        rows = c.execute(
            "SELECT * FROM prompt_templates ORDER BY name, version DESC"
        ).fetchall()
    return web.json_response({"items": [dict(r) for r in rows]})


async def h_prompt_create(request):
    admin = _require_admin(request)
    body = await _body(request)
    name = body.get("name")
    template = body.get("template")
    if not name or not template:
        raise _err(400, "name and template required")
    with db.connect() as c:
        prev = c.execute(
            "SELECT MAX(version) v FROM prompt_templates WHERE name=?",
            (name,)).fetchone()["v"] or 0
        c.execute("UPDATE prompt_templates SET active=0 WHERE name=?", (name,))
        cur = c.execute(
            "INSERT INTO prompt_templates (name, version, template, active,"
            " created_at) VALUES (?,?,?,1,?)",
            (name, prev + 1, template, time.time()))
    settings_store.set_setting(f"ai_prompt_{name}", template)
    audit(admin, "prompt_create", name, f"v{prev + 1}")
    return web.json_response({"name": name, "version": prev + 1, "id": cur.lastrowid})


async def h_prompt_history(request):
    _require_admin(request)
    slug = request.match_info["slug"]
    with db.connect() as c:
        rows = c.execute(
            "SELECT * FROM prompt_templates WHERE name=? ORDER BY version DESC",
            (slug,)).fetchall()
    return web.json_response({"items": [dict(r) for r in rows]})


async def h_prompt_version(request):
    _require_admin(request)
    slug = request.match_info["slug"]
    vid = int(request.match_info["version_id"])
    with db.connect() as c:
        r = c.execute("SELECT * FROM prompt_templates WHERE name=? AND"
                      " version=?", (slug, vid)).fetchone()
    if r is None:
        raise _err(404, "Version not found")
    return web.json_response(dict(r))


async def h_prompt_activate(request):
    admin = _require_admin(request)
    slug = request.match_info["slug"]
    body = await _body(request)
    vid = int(body.get("version", 0))
    with db.connect() as c:
        r = c.execute("SELECT * FROM prompt_templates WHERE name=? AND"
                      " version=?", (slug, vid)).fetchone()
        if r is None:
            raise _err(404, "Version not found")
        c.execute("UPDATE prompt_templates SET active=0 WHERE name=?", (slug,))
        c.execute("UPDATE prompt_templates SET active=1 WHERE id=?",
                  (r["id"],))
    settings_store.set_setting(f"ai_prompt_{slug}", r["template"])
    audit(admin, "prompt_activate", slug, f"v{vid}")
    return web.json_response({"name": slug, "version": vid})


async def h_prompt_reset(request):
    admin = _require_admin(request)
    slug = request.match_info["slug"]
    with db.connect() as c:
        c.execute("UPDATE prompt_templates SET active=0 WHERE name=?", (slug,))
        c.execute("DELETE FROM system_settings WHERE key=?",
                  (f"ai_prompt_{slug}",))
    audit(admin, "prompt_reset", slug)
    return web.json_response({"name": slug, "message": "reset to default"})


# --- reports / exports / backup -------------------------------------------

_REPORTS = {
    "daily_masterings": (
        "SELECT date(created_at, 'unixepoch') d, COUNT(*) n FROM"
        " mastering_records GROUP BY d ORDER BY d DESC LIMIT 30"),
    "styles_breakdown": (
        "SELECT style, COUNT(*) n FROM mastering_records GROUP BY style"),
    "new_users_daily": (
        "SELECT date(created_at, 'unixepoch') d, COUNT(*) n FROM users"
        " GROUP BY d ORDER BY d DESC LIMIT 30"),
    "job_errors": (
        "SELECT date(created_at, 'unixepoch') d, COUNT(*) n FROM"
        " mastering_jobs WHERE status='error' GROUP BY d ORDER BY d DESC"
        " LIMIT 30"),
}


async def h_reports_list(request):
    _require_admin(request)
    return web.json_response({"reports": sorted(_REPORTS)})


async def h_report_get(request):
    _require_admin(request)
    rid = request.match_info["report_id"]
    sql = _REPORTS.get(rid)
    if not sql:
        raise _err(404, "Unknown report")
    with db.connect() as c:
        rows = [dict(r) for r in c.execute(sql).fetchall()]
    return web.json_response({"report_id": rid, "rows": rows})


async def h_report_summarize(request):
    _require_admin(request)
    rid = request.match_info["report_id"]
    sql = _REPORTS.get(rid)
    if not sql:
        raise _err(404, "Unknown report")
    with db.connect() as c:
        rows = [dict(r) for r in c.execute(sql).fetchall()]
    text = ai.llm_chat(
        [{"role": "system", "content": "Summarize this report in 2 sentences."},
         {"role": "user", "content": json.dumps(rows)[:4000]}], max_tokens=150)
    if not text:
        total = sum(r.get("n", 0) for r in rows)
        text = f"{rid}: {len(rows)} rows, total count {total}."
    return web.json_response({"report_id": rid, "summary": text})


async def h_report_csv(request):
    """Raw CSV of one report's rows — the admin UI 'export' affordance
    (reference: reports_service raw export)."""
    _require_admin(request)
    rid = request.match_info["report_id"]
    sql = _REPORTS.get(rid)
    if not sql:
        raise _err(404, "Unknown report")
    with db.connect() as c:
        rows = [dict(r) for r in c.execute(sql).fetchall()]
    header = list(rows[0].keys()) if rows else ["empty"]
    return _csv_response(header, [tuple(r.get(h) for h in header)
                                  for r in rows], f"report_{rid}.csv")


async def h_referrals(request):
    """Referral program oversight (round-5 item 5): totals, reward
    conversion, and the top inviters with emails — the admin-side view of
    the public /api/referral endpoints (reference: referral rows surfaced
    in admin.html)."""
    _require_admin(request)
    limit = min(int(request.query.get("limit", 25)), 200)
    with db.connect() as c:
        total = c.execute("SELECT COUNT(*) FROM referrals").fetchone()[0]
        rewarded = c.execute(
            "SELECT COUNT(*) FROM referrals WHERE rewarded=1").fetchone()[0]
        top = c.execute(
            "SELECT r.inviter_id, u.email, COUNT(*) AS invited,"
            " SUM(r.rewarded) AS rewarded FROM referrals r"
            " LEFT JOIN users u ON u.id = r.inviter_id"
            " GROUP BY r.inviter_id ORDER BY invited DESC LIMIT ?",
            (limit,)).fetchall()
        recent = c.execute(
            "SELECT r.id, r.inviter_id, ui.email AS inviter_email,"
            " r.invitee_id, ue.email AS invitee_email, r.rewarded,"
            " r.created_at FROM referrals r"
            " LEFT JOIN users ui ON ui.id = r.inviter_id"
            " LEFT JOIN users ue ON ue.id = r.invitee_id"
            " ORDER BY r.id DESC LIMIT ?", (limit,)).fetchall()
    return web.json_response({
        "total": total, "rewarded": rewarded,
        "conversion_pct": round(100.0 * rewarded / total, 1) if total else 0.0,
        "top_inviters": [dict(r) for r in top],
        "recent": [dict(r) for r in recent],
    })


def _csv_response(header, rows, filename):
    buf = io.StringIO()
    w = csv.writer(buf)
    w.writerow(header)
    for r in rows:
        w.writerow(r)
    return web.Response(text=buf.getvalue(), content_type="text/csv",
                        headers={"Content-Disposition":
                                 f'attachment; filename="{filename}"'})


async def h_users_csv(request):
    _require_admin(request)
    with db.connect() as c:
        rows = c.execute("SELECT id, email, tier, tokens, is_admin,"
                         " is_blocked, created_at FROM users").fetchall()
    return _csv_response(
        ["id", "email", "tier", "tokens", "is_admin", "is_blocked",
         "created_at"], [tuple(r) for r in rows], "users.csv")


async def h_transactions_csv(request):
    _require_admin(request)
    with db.connect() as c:
        rows = c.execute("SELECT id, user_id, amount, currency, status,"
                         " provider, plan, created_at FROM transactions"
                         ).fetchall()
    return _csv_response(
        ["id", "user_id", "amount", "currency", "status", "provider",
         "plan", "created_at"], [tuple(r) for r in rows], "transactions.csv")


async def h_backup_db(request):
    _require_admin(request)
    import sqlite3 as s3

    src = s3.connect(db.db_path())
    buf = io.BytesIO()
    for line in src.iterdump():
        buf.write((line + "\n").encode())
    src.close()
    return web.Response(body=buf.getvalue(),
                        content_type="application/sql",
                        headers={"Content-Disposition":
                                 'attachment; filename="backup.sql"'})


async def h_test_email(request):
    admin = _require_admin(request)
    body = await _body(request)
    to = body.get("to") or admin.get("email")
    ok = mailer.send_email(to, "Magic Master test", "Test email from admin.")
    return web.json_response({"sent": ok, "to": to})


async def h_test_telegram(request):
    _require_admin(request)
    from . import notifier

    ok = notifier.notify_admin("Test notification from admin panel")
    return web.json_response({"sent": ok})


def register_routes(app: web.Application) -> None:
    r = app.router
    p = "/api/admin"
    r.add_get(f"{p}/stats", h_stats)
    r.add_get(f"{p}/users", h_users_list)
    r.add_get(f"{p}/users/export.csv", h_users_csv)
    r.add_get(f"{p}/users/{{user_id}}", h_user_get)
    r.add_patch(f"{p}/users/{{user_id}}", h_user_patch)
    r.add_delete(f"{p}/users/{{user_id}}", h_user_delete)
    r.add_post(f"{p}/users/bulk-action", h_users_bulk)
    r.add_post(f"{p}/users/{{user_id}}/subscription", h_user_subscription)
    r.add_get(f"{p}/transactions", h_transactions)
    r.add_post(f"{p}/transactions", h_transaction_create)
    r.add_get(f"{p}/transactions/export.csv", h_transactions_csv)
    r.add_get(f"{p}/news", h_news_list)
    r.add_post(f"{p}/news", h_news_create)
    r.add_put(f"{p}/news/{{post_id}}", h_news_update)
    r.add_delete(f"{p}/news/{{post_id}}", h_news_delete)
    r.add_get(f"{p}/campaigns", h_campaigns)
    r.add_post(f"{p}/campaigns", h_campaign_create)
    r.add_post(f"{p}/campaigns/{{campaign_id}}/send", h_campaign_send)
    r.add_get(f"{p}/campaigns/{{campaign_id}}/stats", h_campaign_stats)
    r.add_get(f"{p}/audit", h_audit)
    r.add_get(f"{p}/settings", h_settings_get)
    r.add_patch(f"{p}/settings", h_settings_patch)
    r.add_post(f"{p}/llm/test", h_llm_test)
    r.add_get(f"{p}/prompts", h_prompts)
    r.add_post(f"{p}/prompts", h_prompt_create)
    r.add_get(f"{p}/prompts/{{slug}}/history", h_prompt_history)
    r.add_get(f"{p}/prompts/{{slug}}/version/{{version_id}}", h_prompt_version)
    r.add_post(f"{p}/prompts/{{slug}}/activate", h_prompt_activate)
    r.add_post(f"{p}/prompts/{{slug}}/reset", h_prompt_reset)
    r.add_get(f"{p}/reports/list", h_reports_list)
    r.add_get(f"{p}/reports/export_raw.csv", h_transactions_csv)
    r.add_get(f"{p}/reports/{{report_id}}/export.csv", h_report_csv)
    r.add_get(f"{p}/reports/{{report_id}}", h_report_get)
    r.add_post(f"{p}/reports/{{report_id}}/summarize", h_report_summarize)
    r.add_get(f"{p}/referrals", h_referrals)
    r.add_get(f"{p}/backup/db", h_backup_db)
    r.add_post(f"{p}/notifications/test-email", h_test_email)
    r.add_post(f"{p}/notifications/test-telegram", h_test_telegram)
