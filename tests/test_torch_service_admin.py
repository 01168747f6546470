"""The port's admin panel (``amw_tpu_torch.runtime.admin_routes``), its
initial admin and its payments (``runtime/payments.py``) against the JAX
package's, side by side on the CPU: the flows of
tests/test_admin_payments.py, every admin route as an anonymous client,
a plain user and the admin, and both services started under the repo's
production configuration (``deploy/env.production.example``).

The pair of apps and the comparison are tests/test_torch_service_auth.py's
(``BY_NATURE`` names the fields that differ by nature); CSV bodies are
compared without their timestamp columns, the database backups by their
schema (the rows hold timestamps and salted password hashes).
"""

import dataclasses
import importlib
import re
from pathlib import Path

import pytest
from aiohttp import web

from amw_tpu.runtime import bot as jbot
from amw_tpu.runtime import config as jconfig
from amw_tpu.runtime import settings_store as jstore
from amw_tpu.runtime import users as jusers
from amw_tpu.runtime.auth import verify_password as jverify
from amw_tpu.runtime.service import create_app as jax_create_app
from amw_tpu_torch.runtime import bot as tbot
from amw_tpu_torch.runtime import config as tconfig
from amw_tpu_torch.runtime import settings_store as tstore
from amw_tpu_torch.runtime import users as tusers
from amw_tpu_torch.runtime.auth import verify_password as tverify
from amw_tpu_torch.runtime.service import create_app as port_create_app
from test_torch_service_auth import (ADMIN, apps, csv_rows,  # noqa: F401
                                     engines, run_pair)

ROOT = Path(__file__).resolve().parent.parent
USER = ("u@example.com", "userpass1")


def _routes(app) -> set:
    return {(r.method, r.resource.canonical) for r in app.router.routes()
            if r.resource is not None and r.method != "HEAD"}


def _admin_routes() -> list:
    app = web.Application()
    importlib.import_module("amw_tpu.runtime.admin_routes").register_routes(
        app)
    return sorted(_routes(app))


# path parameters and JSON bodies of the admin routes for the admin's call
# (user 2 is the plain user; the admin is user 1)
PARAMS = {"user_id": "2", "post_id": "1", "campaign_id": "1",
          "slug": "recommend", "version_id": "1",
          "report_id": "styles_breakdown"}
BODIES = {
    ("PATCH", "/api/admin/users/{user_id}"): {"tier": "studio", "tokens": 7},
    ("POST", "/api/admin/users/bulk-action"): {"user_ids": [2],
                                               "action": "add_tokens",
                                               "tokens": 3},
    ("POST", "/api/admin/users/{user_id}/subscription"): {"tier": "pro",
                                                          "days": 30},
    ("POST", "/api/admin/transactions"): {"user_id": 2, "amount": 5},
    ("POST", "/api/admin/news"): {"title": "t", "body": "b"},
    ("PUT", "/api/admin/news/{post_id}"): {"title": "x"},
    ("POST", "/api/admin/campaigns"): {"subject": "s", "body": "b"},
    ("PATCH", "/api/admin/settings"): {"free_weekly_limit": 3,
                                       "not_editable": 1},
    ("POST", "/api/admin/prompts"): {"name": "recommend", "template": "t"},
    ("POST", "/api/admin/prompts/{slug}/activate"): {"version": 1},
    ("POST", "/api/admin/notifications/test-email"): {"to": "x@e.com"},
}


async def _with_user_and_admin(p):
    await p.register("u", *USER)
    assert (await p.login("a", *ADMIN)).status == 200


@pytest.mark.parametrize("route", _admin_routes(),
                         ids=lambda r: f"{r[0]} {r[1]}")
def test_admin_route_alike(apps, route):
    """Each admin route: 401 anonymous, 403 for a plain user, and the
    admin's answer alike in both (a fresh database each)."""
    method, canonical = route
    path = canonical.format(**PARAMS)

    async def fn(p):
        await _with_user_and_admin(p)
        assert (await p.req(method, path)).status == 401
        assert (await p.req(method, path, as_="u")).status == 403
        body = BODIES.get(route)
        if path.endswith(".csv"):
            r = await p.req(method, path, as_="a", same=False)
            assert r.status == 200 and csv_rows(r.j) == csv_rows(r.t)
        elif path.endswith("/backup/db"):
            r = await p.req(method, path, as_="a", same=False)
            schema = [[ln for ln in b.splitlines() if ln.startswith("CREATE")]
                      for b in (r.j, r.t)]
            assert r.j.startswith("BEGIN TRANSACTION")
            assert schema[0] == schema[1] and schema[0]
        else:
            r = await p.req(method, path, as_="a", json_body=body)
            assert r.status in (200, 404), (path, r.j)

    run_pair(apps, fn)


def test_admin_rbac_and_stats(apps):
    async def fn(p):
        await _with_user_and_admin(p)
        r = await p.req("GET", "/api/admin/stats", as_="a")
        assert r.t["users_total"] == 2 and "users_by_tier" in r.t
        assert r.t["version"] == "0.1.0"

    run_pair(apps, fn)


def test_admin_user_management(apps):
    async def fn(p):
        await p.login("a", *ADMIN)
        await p.register("v", "victim@example.com", USER[1])
        found = await p.req("GET", "/api/admin/users?q=victim", as_="a")
        uid = found.t["items"][0]["id"]
        patched = await p.req("PATCH", f"/api/admin/users/{uid}", as_="a",
                              json_body={"tier": "studio", "tokens": 42})
        assert patched.t["tier"] == "studio" and patched.t["tokens"] == 42
        one = await p.req("GET", f"/api/admin/users/{uid}", as_="a")
        assert one.t["stats"] is not None
        assert (await p.req("POST", f"/api/admin/users/{uid}/subscription",
                            as_="a", json_body={"tier": "pro", "days": 30})
                ).status == 200
        blocked = await p.req("POST", "/api/admin/users/bulk-action",
                              as_="a", json_body={"user_ids": [uid],
                                                  "action": "block"})
        assert blocked.t == {"message": "ok", "count": 1}
        bad = await p.req("POST", "/api/admin/users/bulk-action", as_="a",
                          json_body={"user_ids": [uid], "action": "nuke"})
        assert bad.status == 400
        assert (await p.req("POST", "/api/auth/login", json_body={
            "email": "victim@example.com", "password": USER[1]})
                ).status == 403
        audit = await p.req("GET", "/api/admin/audit", as_="a")
        actions = [i["action"] for i in audit.t["items"]]
        assert "user_patch" in actions and "bulk_block" in actions
        text = await p.req("GET", "/api/admin/users/export.csv", as_="a",
                           same=False)
        assert "victim@example.com" in text.t
        assert csv_rows(text.j) == csv_rows(text.t)
        assert (await p.req("DELETE", f"/api/admin/users/{uid}",
                            as_="a")).status == 200
        assert (await p.req("GET", f"/api/admin/users/{uid}",
                            as_="a")).status == 404

    run_pair(apps, fn)


def test_admin_settings_news_reports(apps):
    async def fn(p):
        await p.login("a", *ADMIN)
        r = await p.req("PATCH", "/api/admin/settings", as_="a",
                        json_body={"free_weekly_limit": 5})
        assert r.t["updated"] == ["free_weekly_limit"]
        r = await p.req("GET", "/api/admin/settings", as_="a")
        assert r.t["free_weekly_limit"]["overridden"] is True
        assert str(r.t["free_weekly_limit"]["value"]) == "5"
        made = await p.req("POST", "/api/admin/news", as_="a",
                           json_body={"title": "Hello", "body": "World"})
        pid = made.t["id"]
        assert (await p.req("PUT", f"/api/admin/news/{pid}", as_="a",
                            json_body={"published": False})).status == 200
        public = await p.req("GET", "/api/news")
        assert all(i["id"] != pid for i in public.t["items"])
        assert (await p.req("PUT", f"/api/admin/news/{pid}", as_="a",
                            json_body={"published": True})).status == 200
        public = await p.req("GET", "/api/news")
        assert any(i["id"] == pid for i in public.t["items"])
        assert (await p.req("DELETE", f"/api/admin/news/{pid}",
                            as_="a")).status == 200
        reports = await p.req("GET", "/api/admin/reports/list", as_="a")
        assert "styles_breakdown" in reports.t["reports"]
        for rid in reports.t["reports"]:
            r = await p.req("GET", f"/api/admin/reports/{rid}", as_="a")
            assert "rows" in r.t
            r = await p.req("POST", f"/api/admin/reports/{rid}/summarize",
                            as_="a")
            assert r.t["summary"]
        assert (await p.req("GET", "/api/admin/reports/nope", as_="a")
                ).status == 404
        r = await p.req("POST", "/api/admin/llm/test", as_="a")
        assert r.t == {"configured": False, "ok": False, "reply": None}

    run_pair(apps, fn)


def test_settings_patch_reaches_both(apps):
    """Runtime settings patched in the admin panel reach what reads them:
    ``vocal_isolation_enabled`` gates the vocal routes (the engine reads
    the same store), the AI switch its routes."""
    async def fn(p):
        await p.login("a", *ADMIN)
        ext = await p.req("GET", "/api/extensions")
        assert ext.t["vocal_isolation"] is False
        await p.req("PATCH", "/api/admin/settings", as_="a", json_body={
            "vocal_isolation_enabled": True, "feature_ai_enabled": False,
            "engine_exact_mode": False})
        ext = await p.req("GET", "/api/extensions")
        assert ext.t["vocal_isolation"] is True
        for store in (jstore, tstore):
            assert store.get_setting_bool("vocal_isolation_enabled") is True
            assert store.get_setting_bool("engine_exact_mode", True) is False
        r = await p.req("POST", "/api/ai/nl-config", json_body={"text": "x"})
        assert r.status == 503
        r = await p.req("GET", "/api/admin/settings", as_="a")
        assert r.t["engine_exact_mode"]["overridden"] is True
        await p.req("PATCH", "/api/admin/settings", as_="a", json_body={
            "vocal_isolation_enabled": None, "feature_ai_enabled": None,
            "engine_exact_mode": None})
        r = await p.req("GET", "/api/admin/settings", as_="a")
        assert not any(v["overridden"] for v in r.t.values())

    run_pair(apps, fn)


def test_prompt_versioning(apps):
    async def fn(p):
        await p.login("a", *ADMIN)
        for text in ("v1 text", "v2 text"):
            r = await p.req("POST", "/api/admin/prompts", as_="a",
                            json_body={"name": "recommend",
                                       "template": text})
        assert r.t["version"] == 2
        hist = await p.req("GET", "/api/admin/prompts/recommend/history",
                           as_="a")
        assert len(hist.t["items"]) == 2 and hist.t["items"][0]["active"]
        one = await p.req("GET", "/api/admin/prompts/recommend/version/1",
                          as_="a")
        assert one.t["template"] == "v1 text"
        assert (await p.req("POST", "/api/admin/prompts/recommend/activate",
                            as_="a", json_body={"version": 1})
                ).status == 200
        for store in (jstore, tstore):
            assert store.get_setting_str("ai_prompt_recommend") == "v1 text"
        assert (await p.req("POST", "/api/admin/prompts/recommend/reset",
                            as_="a")).status == 200
        listed = await p.req("GET", "/api/admin/prompts", as_="a")
        assert not any(i["active"] for i in listed.t["items"])

    run_pair(apps, fn)


def test_admin_referrals_campaigns_transactions(apps):
    async def fn(p):
        await p.login("a", *ADMIN)
        await p.register("i", "inviter@example.com")
        link = await p.req("GET", "/api/referral/my-link", as_="i")
        codes = (link.j["code"], link.t["code"])
        for side, client in enumerate(p.clients):
            r = await client.post("/api/auth/register", json={
                "email": "invitee@example.com", "password": "inviteepw1",
                "ref": codes[side]})
            assert r.status == 200
        refs = await p.req("GET", "/api/admin/referrals", as_="a")
        assert refs.t["total"] == 1
        assert refs.t["top_inviters"][0]["email"] == "inviter@example.com"
        assert refs.t["recent"][0]["invitee_email"] == "invitee@example.com"

        made = await p.req("POST", "/api/admin/campaigns", as_="a",
                           json_body={"subject": "s", "body": "b"})
        cid = made.t["id"]
        sent = await p.req("POST", f"/api/admin/campaigns/{cid}/send",
                           as_="a")
        assert sent.t == {"sent": 0, "recipients": 3}  # no SMTP configured
        stats = await p.req("GET", f"/api/admin/campaigns/{cid}/stats",
                            as_="a")
        assert stats.t["audience_total"] == 3 and stats.t["status"] == "sent"

        tx = await p.req("POST", "/api/admin/transactions", as_="a",
                         json_body={"user_id": 2, "amount": 12.5})
        listed = await p.req("GET", "/api/admin/transactions", as_="a")
        assert listed.t["items"][0]["id"] == tx.t["id"]
        stats = await p.req("GET", "/api/admin/stats", as_="a")
        assert stats.t["revenue_total"] == 12.5
        for path in ("/api/admin/transactions/export.csv",
                     "/api/admin/reports/export_raw.csv",
                     "/api/admin/reports/new_users_daily/export.csv"):
            r = await p.req("GET", path, as_="a", same=False)
            assert csv_rows(r.j) == csv_rows(r.t)
        mail = await p.req("POST", "/api/admin/notifications/test-email",
                           as_="a", json_body={})
        assert mail.t == {"sent": False, "to": ADMIN[0]}
        tg = await p.req("POST", "/api/admin/notifications/test-telegram",
                         as_="a")
        assert tg.t == {"sent": False}

    run_pair(apps, fn)


def test_payments_demo_flow(apps):
    async def fn(p):
        await p.register("u", "payer@example.com", USER[1])
        plans = await p.req("GET", "/api/payments/plans")
        assert "pro_month" in plans.t["plans"]
        assert (await p.req("POST", "/api/payments/create", json_body={
            "plan": "pro_month"})).status == 401
        r = await p.req("POST", "/api/payments/create", as_="u",
                        json_body={"plan": "studio_month"})
        assert r.t["demo"] is True and r.t["status"] == "succeeded"
        prof = await p.req("GET", "/api/auth/profile", as_="u")
        assert prof.t["tier"] == "studio" and prof.t["tokens"] >= 200
        assert (await p.req("POST", "/api/payments/create", as_="u",
                            json_body={"plan": "bogus"})).status == 400
        # a provider configured: a pending payment the webhook completes
        for store in (jstore, tstore):
            store.set_setting("yookassa_shop_id", "shop-1")
        r = await p.req("POST", "/api/payments/create", as_="u",
                        json_body={"plan": "tokens_10"})
        assert r.t["status"] == "pending" and r.t["demo"] is False

    run_pair(apps, fn)


def test_payments_webhook(apps):
    async def fn(p):
        await p.register("u", "hook@example.com", USER[1])
        await p.login("a", *ADMIN)
        found = await p.req("GET", "/api/admin/users?q=hook", as_="a")
        uid = found.t["items"][0]["id"]
        event = {"event": "payment.succeeded",
                 "object": {"id": "pay-1",
                            "metadata": {"user_id": uid,
                                         "plan": "pro_month"},
                            "amount": {"value": "1000.00",
                                       "currency": "RUB"}}}
        assert (await p.req("POST", "/api/payments/webhook",
                            json_body=event)).t["status"] == "ok"
        # redelivery: not credited twice
        assert (await p.req("POST", "/api/payments/webhook",
                            json_body=event)).t["status"] == "ok"
        prof = await p.req("GET", "/api/auth/profile", as_="u")
        assert prof.t["tier"] == "pro" and prof.t["tokens"] == 50
        ignored = await p.req("POST", "/api/payments/webhook",
                              json_body={"event": "payment.canceled"})
        assert ignored.t["status"] == "ignored"
        # the HMAC secret, then the IP whitelist
        for store in (jstore, tstore):
            store.set_setting("yookassa_webhook_secret", "s3cr3t")
        assert (await p.req("POST", "/api/payments/webhook",
                            json_body={"event": "x"})).status == 403
        assert (await p.req("POST", "/api/payments/webhook?secret=s3cr3t",
                            json_body={"event": "x"})).status == 200
        hdr = {"X-Webhook-Secret": "s3cr3t"}
        assert (await p.req("POST", "/api/payments/webhook",
                            json_body={"event": "x"}, headers=(hdr, hdr))
                ).status == 200
        for store in (jstore, tstore):
            store.set_setting("yookassa_webhook_ip_whitelist", "1.2.3.4")
        assert (await p.req("POST", "/api/payments/webhook?secret=s3cr3t",
                            json_body={"event": "x"})).status == 403

    run_pair(apps, fn)


def _production_env() -> dict:
    """``deploy/env.production.example`` parsed, with tokens for both bots
    added (the user bot answers on ``TELEGRAM_BOT_TOKEN`` in both
    packages, the notify bot on the same setting)."""
    env = {}
    for line in (ROOT / "deploy" / "env.production.example").read_text(
            ).splitlines():
        line = line.strip()
        if line and not line.startswith("#") and "=" in line:
            k, v = line.split("=", 1)
            env[k.strip()] = v.strip()
    env["AMW_TELEGRAM_BOT_TOKEN"] = "123:abc"
    env["AMW_USER_BOT_TOKEN"] = "456:def"
    return env


def test_production_configuration_starts_both(engines, tmp_path,
                                              monkeypatch):
    """Both services start under every setting of the production example
    (bot tokens added): the same initial admin, the same (method, route)
    set, both bots made, the port's user bot on the app's engine."""
    from amw_tpu.runtime import db as jdb
    from amw_tpu_torch.runtime import db as tdb

    env = _production_env()
    assert env["AMW_ADMIN_EMAIL"] and env["AMW_ADMIN_PASSWORD"]
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    for mod in (jconfig, tconfig):
        fresh = mod.Settings()  # the environment read as a deployment's
        for f in dataclasses.fields(fresh):
            monkeypatch.setattr(mod.settings, f.name,
                                getattr(fresh, f.name))
    assert tconfig.settings.feature_ai_enabled is True
    assert tconfig.settings.registration_enabled is True
    jdb.set_db_path(str(tmp_path / "jax.sqlite3"))
    tdb.set_db_path(str(tmp_path / "port.sqlite3"))
    jeng, teng = engines
    japp, tapp = jax_create_app(jeng), port_create_app(teng)
    assert _routes(japp) == _routes(tapp)
    admins = []
    for users, verify in ((jusers, jverify), (tusers, tverify)):
        u = users.get_user_by_email(env["AMW_ADMIN_EMAIL"])
        assert u["is_admin"] == 1 and u["tier"] == "studio"
        assert verify(env["AMW_ADMIN_PASSWORD"], u["password_hash"])
        admins.append({k: u[k] for k in ("id", "email", "tier", "is_admin",
                                         "tokens", "is_blocked")})
    assert admins[0] == admins[1]
    for app, mod in ((japp, jbot), (tapp, tbot)):
        assert isinstance(app["bot"], mod.Bot)
        assert isinstance(app["notify_bot"], mod.NotifyBot)
    assert tapp["bot"].engine is teng
    # a second start finds the admin there and makes no other
    jax_create_app(jeng), port_create_app(teng)
    for db in (jdb, tdb):
        with db.connect() as c:
            assert c.execute("SELECT COUNT(*) n FROM users").fetchone()[
                "n"] == 1


def test_initial_admin_needs_both_settings(engines, tmp_path, monkeypatch):
    """An admin email without a password creates no admin, in both; an
    existing user named by the email is made admin with its password kept."""
    from amw_tpu.runtime import db as jdb
    from amw_tpu.runtime.auth import hash_password as jhash
    from amw_tpu_torch.runtime import admin_routes as tadmin
    from amw_tpu_torch.runtime import db as tdb
    from amw_tpu_torch.runtime.auth import hash_password as thash
    from amw_tpu.runtime import admin_routes as jadmin

    jdb.set_db_path(str(tmp_path / "jax.sqlite3"))
    tdb.set_db_path(str(tmp_path / "port.sqlite3"))
    monkeypatch.delenv("AMW_ADMIN_PASSWORD", raising=False)
    monkeypatch.delenv("MAGIC_MASTER_ADMIN_PASSWORD", raising=False)
    monkeypatch.setenv("MAGIC_MASTER_ADMIN_EMAIL", "boss@example.com")
    for users, admin, hash_ in ((jusers, jadmin, jhash),
                                (tusers, tadmin, thash)):
        users.ensure_schema()
        admin.ensure_initial_admin()
        assert users.get_user_by_email("boss@example.com") is None
        users.create_user("boss@example.com", hash_("own-pass"))
    monkeypatch.setenv("MAGIC_MASTER_ADMIN_PASSWORD", "other")
    for users, admin, verify in ((jusers, jadmin, jverify),
                                 (tusers, tadmin, tverify)):
        admin.ensure_initial_admin()
        u = users.get_user_by_email("boss@example.com")
        assert u["is_admin"] == 1
        assert verify("own-pass", u["password_hash"])


def test_settings_fields_match_jax():
    """The port's ``Settings`` has the JAX package's fields that some
    module of the port reads, with the same defaults; the others are named
    in its docstring, and every field it keeps is read."""
    left_out = {
        # XLA's persistent compilation cache: no counterpart.
        "compilation_cache_dir",
        # Read by no code of either package.
        "ai_limit_free", "ai_limit_pro", "ai_limit_studio",
        "ai_prompt_report", "ai_prompt_nl_config", "ai_prompt_chat",
        "cors_origins", "yookassa_secret_key", "yookassa_return_url",
        "user_bot_token", "user_bot_webhook_secret",
        "alert_monitoring_enabled", "alert_throttle_minutes",
        "demucs_model", "max_upload_mb", "allowed_extensions", "temp_dir",
        # Read from the environment by the module that uses them.
        "mastering_trace", "mastering_trace_lufs_stages",
        "admin_email", "admin_password",
    }
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.Settings)}
    tf = {f.name: f.default for f in dataclasses.fields(tconfig.Settings)}
    assert set(jf) - set(tf) == left_out
    assert set(tf) <= set(jf)
    assert all(tf[k] == jf[k] for k in tf)
    assert all(f"``{name}``" in tconfig.__doc__ for name in left_out)
    pkg = Path(tconfig.__file__).parents[1]
    code = "\n".join(p.read_text() for p in pkg.rglob("*.py")
                     if p.name != "config.py")
    unread = [k for k in tf
              if not re.search(rf"(settings\.|[\"']){k}\b", code)]
    assert unread == []
