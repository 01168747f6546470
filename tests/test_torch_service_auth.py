"""The port's account routes (``amw_tpu_torch.runtime.auth_routes``) against
the JAX package's, side by side on the CPU: the flows of
tests/test_auth.py sent to both apps through ``aiohttp.test_utils.
TestClient``, each app on its own temporary database (a fresh pair of
databases a test), the port's on ``MasteringEngine(device="cpu")``, the
JAX package's on its engine without the micro-batcher (as
tests/test_torch_service.py serves them).

Every request goes to both apps; the statuses and content types must be
equal, and so must the JSON bodies but for the fields that differ by
nature, named in ``BY_NATURE``: signed tokens, random keys and codes,
timestamps, the payment id (a uuid) and the backend's name.  Each side
authenticates with its own token.  This module also holds the pair's
machinery that tests/test_torch_service_admin.py and
tests/test_torch_service_ai.py use.
"""

import asyncio
import csv
import io
import json
import smtplib

import aiohttp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from amw_tpu.runtime import ai as jai
from amw_tpu.runtime import config as jconfig
from amw_tpu.runtime import db as jdb
from amw_tpu.runtime import deps as jdeps
from amw_tpu.runtime.engine import MasteringEngine as JaxEngine
from amw_tpu.runtime.service import create_app as jax_create_app
from amw_tpu_torch.runtime import ai as tai
from amw_tpu_torch.runtime import config as tconfig
from amw_tpu_torch.runtime import db as tdb
from amw_tpu_torch.runtime import deps as tdeps
from amw_tpu_torch.runtime.engine import MasteringEngine
from amw_tpu_torch.runtime.service import create_app as port_create_app
from amw_tpu_torch.scripts import gen_demo_assets as tdemo
from amw_tpu_torch.utils import wav

# Fields whose values differ between the two apps by nature.
BY_NATURE = {
    "access_token",   # a JWT: its expiry is the signing second
    "debug_token",    # random single-use verification / reset tokens
    "key", "prefix",  # a new API key and its prefix (random)
    "code", "link", "referral_code",  # referral and Telegram link codes
    "payment_id",     # a uuid
    "created_at", "last_login_at", "last_used_at", "subscription_until",
    "subscription_expires_at",  # timestamps
    "backend",        # /api/extensions: "jax-tpu" / "torch-<device>"
}
SETTINGS = (jconfig.settings, tconfig.settings)
ADMIN = ("admin@example.com", "adminpass1")


def rendered_demo_dir(path):
    """``path`` made a demo directory that holds the mastered clip, so
    that a port app served with ``gen_demo_assets.DEMO_DIR`` there starts
    no demo render (tests/test_torch_demo_assets.py tests the render)."""
    path.mkdir(exist_ok=True)
    (path / "edm_mastered.wav").write_bytes(b"")
    return path


def scrub(obj):
    """``obj`` with the values of ``BY_NATURE`` fields blanked."""
    if isinstance(obj, dict):
        return {k: ("<by nature>" if k in BY_NATURE else scrub(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [scrub(v) for v in obj]
    return obj


def form(fields: dict) -> aiohttp.FormData:
    """A multipart form: an upload is (name, bytes)."""
    f = aiohttp.FormData()
    for k, v in fields.items():
        if isinstance(v, tuple):
            f.add_field(k, v[1], filename=v[0], content_type="audio/wav")
        else:
            f.add_field(k, str(v))
    return f


def set_both(monkeypatch, **values):
    """Set settings fields in both packages for the test."""
    for s in SETTINGS:
        for k, v in values.items():
            monkeypatch.setattr(s, k, v)


class Reply:
    """Both apps' answers to one request: the status, and the bodies
    (``j`` the JAX app's, ``t`` the port's; JSON parsed, else text)."""

    def __init__(self, status, j, t):
        self.status, self.j, self.t = status, j, t


class Pair:
    """Two served apps; :meth:`req` sends one request to both and holds
    their answers equal.  ``tokens[i]`` is side ``i``'s bearer token by
    name (0 the JAX app, 1 the port)."""

    def __init__(self, jc, tc):
        self.clients = (jc, tc)
        self.tokens = ({}, {})

    async def req(self, method, path, *, as_=None, json_body=None,
                  fields=None, headers=(None, None), same=True) -> Reply:
        got = []
        for side, client in enumerate(self.clients):
            h = dict(headers[side] or {})
            if as_ is not None:
                h["Authorization"] = f"Bearer {self.tokens[side][as_]}"
            kw = {}
            if json_body is not None:
                kw["json"] = json_body
            if fields is not None:
                kw["data"] = form(fields)
            r = await client.request(method, path, headers=h, **kw)
            raw = await r.read()
            ctype = r.headers.get("Content-Type", "")
            body = (json.loads(raw) if ctype.startswith("application/json")
                    else raw.decode("utf-8", "replace"))
            got.append((r.status, ctype.split(";")[0], body))
        (sj, cj, bj), (st, ct, bt) = got
        assert (sj, cj) == (st, ct), (method, path, got)
        if same:
            if isinstance(bj, str):
                assert bj == bt, (method, path)
            else:
                assert scrub(bj) == scrub(bt), (method, path, bj, bt)
        return Reply(sj, bj, bt)

    async def register(self, name, email, password="secret123", **extra):
        r = await self.req("POST", "/api/auth/register", json_body={
            "email": email, "password": password, **extra})
        assert r.status == 200, r.j
        if "access_token" in r.j:
            self.tokens[0][name] = r.j["access_token"]
            self.tokens[1][name] = r.t["access_token"]
        return r

    async def login(self, name, email, password="secret123"):
        r = await self.req("POST", "/api/auth/login",
                           json_body={"email": email, "password": password})
        if r.status == 200:
            self.tokens[0][name] = r.j["access_token"]
            self.tokens[1][name] = r.t["access_token"]
        return r


@pytest.fixture(scope="module")
def engines():
    jeng = JaxEngine(micro_batch=False)
    teng = MasteringEngine(device="cpu")
    yield jeng, teng
    teng.close()


@pytest.fixture()
def apps(engines, tmp_path, monkeypatch):
    """Factory of both apps on a fresh pair of databases, the initial admin
    configured (tests/test_admin_payments.py) and the anonymous weekly
    limit off (tests/test_ai.py)."""
    jdb.set_db_path(str(tmp_path / "jax.sqlite3"))
    tdb.set_db_path(str(tmp_path / "port.sqlite3"))
    monkeypatch.setenv("AMW_ADMIN_EMAIL", ADMIN[0])
    monkeypatch.setenv("AMW_ADMIN_PASSWORD", ADMIN[1])
    monkeypatch.delenv("AMW_HTDEMUCS_CKPT", raising=False)
    monkeypatch.setattr(tdemo, "DEMO_DIR", rendered_demo_dir(
        tmp_path / "demos"))
    set_both(monkeypatch, mastering_debug_skip_limits=True)
    jeng, teng = engines

    def make():
        for mod in (jdeps, tdeps):
            mod.reset_rate_limits()
        for mod in (jai, tai):
            mod.reset_ai_usage()
        return jax_create_app(jeng), port_create_app(teng)

    return make


def run_pair(apps, fn):
    """Run ``fn(pair)`` with both apps served."""
    async def inner():
        japp, tapp = apps()
        async with TestClient(TestServer(japp)) as jc, \
                TestClient(TestServer(tapp)) as tc:
            return await fn(Pair(jc, tc))

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(inner())
    finally:
        loop.close()


def csv_rows(text: str, drop=("created_at",)) -> list:
    """A CSV body's rows without the columns named in ``drop``."""
    rows = list(csv.reader(io.StringIO(text)))
    keep = [i for i, h in enumerate(rows[0]) if h not in drop]
    return [[r[i] for i in keep] for r in rows]


# ---------------------------------------------------------------------------


def test_register_login_me_profile(apps, monkeypatch):
    set_both(monkeypatch, debug=True)

    async def fn(p):
        reg = await p.register("u", "user@example.com")
        assert reg.j["tier"] == "pro" and reg.t["access_token"]
        dup = await p.req("POST", "/api/auth/register", json_body={
            "email": "user@example.com", "password": "secret123"})
        assert dup.status == 400
        assert (await p.login("u", "user@example.com")).status == 200
        me = await p.req("GET", "/api/auth/me", as_="u")
        assert me.t["email"] == "user@example.com"
        prof = await p.req("GET", "/api/auth/profile", as_="u")
        assert prof.t["tier"] == "pro" and "stats" in prof.t
        bad = await p.req("POST", "/api/auth/login", json_body={
            "email": "user@example.com", "password": "wrong"})
        assert bad.status == 401
        assert (await p.req("GET", "/api/auth/me")).status == 401
        assert (await p.req("POST", "/api/auth/logout")).status == 200
        short = await p.req("POST", "/api/auth/register", json_body={
            "email": "nope", "password": "1"})
        assert short.status == 400

    run_pair(apps, fn)


def test_change_password(apps):
    async def fn(p):
        await p.register("u", "pw@example.com")
        wrong = await p.req("POST", "/api/auth/change-password", as_="u",
                            json_body={"old_password": "bad",
                                       "new_password": "newpass99"})
        assert wrong.status == 400
        short = await p.req("POST", "/api/auth/change-password", as_="u",
                            json_body={"old_password": "secret123",
                                       "new_password": "x"})
        assert short.status == 400
        ok = await p.req("POST", "/api/auth/change-password", as_="u",
                         json_body={"old_password": "secret123",
                                    "new_password": "newpass99"})
        assert ok.status == 200
        assert (await p.login("u", "pw@example.com", "newpass99")).status \
            == 200

    run_pair(apps, fn)


def test_password_reset_single_use(apps, monkeypatch):
    set_both(monkeypatch, debug=True)

    async def fn(p):
        await p.register("u", "reset@example.com")
        r = await p.req("POST", "/api/auth/forgot-password",
                        json_body={"email": "reset@example.com"})
        tokens = (r.j["debug_token"], r.t["debug_token"])
        assert all(tokens)
        for use in ("newpass99", "again1234"):  # the second use fails
            got = []
            for side, client in enumerate(p.clients):
                rr = await client.post("/api/auth/reset-password", json={
                    "token": tokens[side], "new_password": use})
                got.append((rr.status, await rr.json()))
            assert got[0] == got[1]
            assert got[0][0] == (200 if use == "newpass99" else 400)
        assert (await p.login("u", "reset@example.com", "newpass99")).status \
            == 200
        unknown = await p.req("POST", "/api/auth/forgot-password",
                              json_body={"email": "nobody@example.com"})
        assert "debug_token" not in unknown.j

    run_pair(apps, fn)


def test_auth_brute_force_limit(apps):
    async def fn(p):
        for i in range(tconfig.settings.auth_rate_per_minute):
            r = await p.req("POST", "/api/auth/login",
                            json_body={"email": f"x{i}@e.com",
                                       "password": "n"})
            assert r.status == 401
        r = await p.req("POST", "/api/auth/login",
                        json_body={"email": "x@e.com", "password": "n"})
        assert r.status == 429

    run_pair(apps, fn)


def test_api_keys_and_presets(apps):
    async def fn(p):
        await p.register("u", "keys@example.com")
        made = await p.req("POST", "/api/auth/api-keys", as_="u",
                           json_body={"name": "ci"})
        assert made.status == 201
        keys = (made.j["key"], made.t["key"])
        by_key = tuple({"X-API-Key": k} for k in keys)
        me = await p.req("GET", "/api/auth/me", headers=by_key)
        assert me.status == 200 and me.t["email"] == "keys@example.com"
        listed = await p.req("GET", "/api/auth/api-keys", as_="u")
        assert len(listed.t["items"]) == 1
        gone = await p.req("DELETE", f"/api/auth/api-keys/{made.t['id']}",
                           as_="u")
        assert gone.status == 200
        assert (await p.req("GET", "/api/auth/me",
                            headers=by_key)).status == 401
        missing = await p.req("DELETE", "/api/auth/api-keys/999", as_="u")
        assert missing.status == 404

        cfg = {"modules": [{"id": "dc_offset", "enabled": True}]}
        bad = await p.req("POST", "/api/auth/presets", as_="u",
                          json_body={"name": "", "config": cfg})
        assert bad.status == 400
        made = await p.req("POST", "/api/auth/presets", as_="u",
                           json_body={"name": "mine", "config": cfg})
        pid = made.t["id"]
        got = await p.req("GET", f"/api/auth/presets/{pid}", as_="u")
        assert got.t["config"] == cfg
        listed = await p.req("GET", "/api/auth/presets", as_="u")
        assert [i["name"] for i in listed.t["items"]] == ["mine"]
        assert (await p.req("DELETE", f"/api/auth/presets/{pid}",
                            as_="u")).status == 200
        assert (await p.req("GET", f"/api/auth/presets/{pid}",
                            as_="u")).status == 404

    run_pair(apps, fn)


def test_history_and_csv(apps):
    async def fn(p):
        await p.register("u", "hist@example.com")
        rec = await p.req("POST", "/api/auth/record", as_="u", json_body={
            "filename": "a.wav", "style": "edm", "target_lufs": -9.0,
            "before_lufs": -18.2, "after_lufs": -9.1, "out_format": "wav"})
        assert rec.status == 200
        hist = await p.req("GET", "/api/auth/history", as_="u")
        items = hist.t["items"]
        assert len(items) == 1 and items[0]["style"] == "edm"
        text = await p.req("GET", "/api/auth/history/export.csv", as_="u",
                           same=False)
        assert text.t.startswith("id,") and "a.wav" in text.t
        assert csv_rows(text.j) == csv_rows(text.t)
        assert (await p.req("DELETE", f"/api/auth/history/{items[0]['id']}",
                            as_="u")).status == 200
        assert (await p.req("DELETE", "/api/auth/history/999",
                            as_="u")).status == 404
        assert (await p.req("GET", "/api/auth/history")).status == 401

    run_pair(apps, fn)


def test_free_weekly_limit(apps, monkeypatch):
    """The anonymous weekly limit on ``/api/v2/master``: the first upload is
    taken, the second refused, in both."""
    set_both(monkeypatch, mastering_debug_skip_limits=False)
    t = np.arange(8000) / 8000
    x = (0.4 * np.sin(2 * np.pi * 440 * t)).astype(np.float32)
    blob = wav.write_wav_int16((np.stack([x, x]) * 32767).astype(np.int16),
                               8000)

    async def fn(p):
        first = await p.req("POST", "/api/v2/master",
                            fields={"file": ("t.wav", blob)}, same=False)
        assert first.status == 200 and set(first.j) == set(first.t)
        second = await p.req("POST", "/api/v2/master",
                             fields={"file": ("t.wav", blob)})
        assert second.status == 429
        lim = await p.req("GET", "/api/limits")
        assert lim.t["used"] == 1 and lim.t["remaining"] == 0
        # let both jobs finish on this test's databases
        for client, job in zip(p.clients, (first.j, first.t)):
            for _ in range(600):
                r = await client.get(f"/api/master/status/{job['job_id']}")
                if (await r.json())["status"] in ("done", "error"):
                    break
                await asyncio.sleep(0.1)
            assert (await r.json())["status"] == "done"

    run_pair(apps, fn)


def test_email_verification_flow(apps, monkeypatch):
    set_both(monkeypatch, debug=True, require_email_verify=True)

    async def fn(p):
        reg = await p.register("v", "verify@example.com")
        assert reg.j["requires_verification"] is True
        tokens = (reg.j["debug_token"], reg.t["debug_token"])
        blocked = await p.req("POST", "/api/auth/login", json_body={
            "email": "verify@example.com", "password": "secret123"})
        assert blocked.status == 403
        bad = await p.req("GET", "/api/auth/verify-email?token=nope")
        assert bad.status == 400
        resent = await p.req("POST", "/api/auth/resend-verification",
                             json_body={"email": "verify@example.com"})
        assert resent.j["debug_token"]
        got = []
        for side, client in enumerate(p.clients):
            r = await client.get(
                f"/api/auth/verify-email?token={tokens[side]}")
            got.append((r.status, await r.json()))
        assert got[0] == got[1] and got[0][0] == 200
        assert (await p.login("v", "verify@example.com")).status == 200
        again = await p.req("POST", "/api/auth/resend-verification",
                            json_body={"email": "verify@example.com"})
        assert "debug_token" not in again.t and "message" in again.t

    run_pair(apps, fn)


def test_registration_disabled(apps, monkeypatch):
    """``AMW_REGISTRATION_ENABLED=false`` reaches both services' register
    route (the settings field the port now has), and the settings store's
    override does too."""
    set_both(monkeypatch, registration_enabled=False)

    async def fn(p):
        r = await p.req("POST", "/api/auth/register", json_body={
            "email": "late@example.com", "password": "secret123"})
        assert r.status == 503
        set_both(monkeypatch, registration_enabled=True)
        await p.login("a", *ADMIN)
        patched = await p.req("PATCH", "/api/admin/settings", as_="a",
                              json_body={"registration_enabled": False})
        assert patched.t["updated"] == ["registration_enabled"]
        r = await p.req("POST", "/api/auth/register", json_body={
            "email": "late@example.com", "password": "secret123"})
        assert r.status == 503

    run_pair(apps, fn)


def test_telegram_link_code_links_the_bot(apps, monkeypatch):
    """``/api/auth/telegram-link-code`` makes a code (``bot.create_link_code``)
    that each package's bot takes in ``/link``."""
    from amw_tpu.runtime import bot as jbot
    from amw_tpu.runtime import users as jusers
    from amw_tpu_torch.runtime import bot as tbot
    from amw_tpu_torch.runtime import users as tusers

    async def fn(p):
        await p.register("u", "tg@example.com")
        assert (await p.req("POST", "/api/auth/telegram-link-code")
                ).status == 401
        r = await p.req("POST", "/api/auth/telegram-link-code", as_="u")
        assert r.t["expires_in_sec"] == 3600 and len(r.t["code"]) == 6
        for code, bot_mod, users in ((r.j["code"], jbot, jusers),
                                     (r.t["code"], tbot, tusers)):
            sent = []
            bot = bot_mod.Bot(api_call=lambda m, pl: sent.append(pl))
            await bot.handle_update({"message": {"chat": {"id": 77},
                                                 "text": f"/link {code}"}})
            assert sent[-1]["text"] == "✅ Account linked."
            assert users.get_user_by_email("tg@example.com")[
                "telegram_id"] == 77

    run_pair(apps, fn)


class FakeSMTP:
    """``smtplib.SMTP`` recording what each session does."""

    log: list = []

    def __init__(self, host, port, timeout=None):
        self.calls = [("connect", host, port, timeout)]

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        FakeSMTP.log.append(self.calls)

    def starttls(self):
        self.calls.append(("starttls",))

    def login(self, user, password):
        self.calls.append(("login", user, password))

    def send_message(self, msg):
        self.calls.append(("send", msg["From"], msg["To"], msg["Subject"],
                           msg.get_content()))


def test_mailer_sends_alike(monkeypatch):
    """Both mailers over a fake ``smtplib.SMTP``: the same sessions, each
    message's sender, recipient, subject and body; without an SMTP host
    neither sends."""
    from amw_tpu.runtime import mailer as jmail
    from amw_tpu_torch.runtime import mailer as tmail

    monkeypatch.setattr(smtplib, "SMTP", FakeSMTP)
    for env in ("MAGIC_MASTER_SMTP_HOST", "AMW_SMTP_HOST"):
        monkeypatch.delenv(env, raising=False)
    set_both(monkeypatch, smtp_host="")
    assert jmail.send_email("a@b.c", "s", "b") is False
    assert tmail.send_email("a@b.c", "s", "b") is False
    set_both(monkeypatch, smtp_host="smtp.example.com", smtp_port=2525,
             smtp_user="mailer", smtp_password="pw",
             smtp_from="noreply@example.com")
    logs = []
    for mod in (jmail, tmail):
        FakeSMTP.log = []
        assert mod.send_welcome_email("u@example.com", "u@example.com")
        assert mod.send_email_verification("u@example.com", "http://x/v")
        assert mod.send_password_reset("u@example.com", "http://x/r")
        logs.append(FakeSMTP.log)
    assert logs[0] == logs[1] and len(logs[1]) == 3
    assert logs[1][0][0] == ("connect", "smtp.example.com", 2525, 20)
