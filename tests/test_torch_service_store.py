"""The port's service state (``amw_tpu_torch.runtime``: ``db``,
``settings_store``, ``auth``, ``users``, ``deps``, ``jobs``) against the
JAX package's, each package on its own temporary database: the same
schema, the same answers to the same calls, tokens and password hashes
that cross from one package to the other, and the job semaphores.
"""

import asyncio
import time
from unittest import mock

import pytest
from aiohttp.test_utils import make_mocked_request

from amw_tpu.runtime import auth as jauth
from amw_tpu.runtime import config as jconfig
from amw_tpu.runtime import db as jdb
from amw_tpu.runtime import deps as jdeps
from amw_tpu.runtime import jobs as jjobs
from amw_tpu.runtime import settings_store as jstore
from amw_tpu.runtime import users as jusers
from amw_tpu_torch.runtime import auth as tauth
from amw_tpu_torch.runtime import config as tconfig
from amw_tpu_torch.runtime import db as tdb
from amw_tpu_torch.runtime import deps as tdeps
from amw_tpu_torch.runtime import jobs as tjobs
from amw_tpu_torch.runtime import settings_store as tstore
from amw_tpu_torch.runtime import users as tusers

JAX = {"db": jdb, "store": jstore, "auth": jauth, "users": jusers,
       "deps": jdeps, "jobs": jjobs, "settings": jconfig.settings}
PORT = {"db": tdb, "store": tstore, "auth": tauth, "users": tusers,
        "deps": tdeps, "jobs": tjobs, "settings": tconfig.settings}
PKGS = (JAX, PORT)
# per-row values that differ by when and how a row was made
VOLATILE = {"id", "created_at", "last_used_at", "referral_code", "key_hash",
            "prefix", "password_hash", "subscription_until"}


@pytest.fixture
def fresh(tmp_path):
    """Both packages on fresh databases, empty job stores and counters."""
    for i, p in enumerate(PKGS):
        p["db"].set_db_path(str(tmp_path / f"{i}.sqlite3"))
        p["users"].ensure_schema()
        p["deps"].reset_rate_limits()
    with mock.patch.dict(jjobs._jobs, clear=True), \
            mock.patch.dict(tjobs._jobs, clear=True):
        yield


def _strip(row):
    return None if row is None else {k: v for k, v in row.items()
                                     if k not in VOLATILE}


def test_schema_matches_jax(fresh):
    def schema(p):
        with p["db"].connect() as c:
            return [tuple(r) for r in c.execute(
                "SELECT type, name, tbl_name, sql FROM sqlite_master"
                " ORDER BY name")]

    assert schema(PORT) == schema(JAX)
    assert len(schema(PORT)) > 16


def test_db_path_state_is_the_ports_own(tmp_path):
    jdb.set_db_path(str(tmp_path / "j.sqlite3"))
    tdb.set_db_path(str(tmp_path / "t.sqlite3"))
    tdb.setting_set("k", "port")
    assert jdb.setting_get("k") is None and tdb.setting_get("k") == "port"
    assert jdb.db_path() != tdb.db_path()


@pytest.mark.parametrize("key,value,kind", [
    ("maintenance_mode", "true", "bool"), ("maintenance_mode", "off", "bool"),
    ("vocal_isolation_enabled", "yes", "bool"),
    ("feature_batch_enabled", None, "bool"),
    ("jobs_done_ttl_seconds", "12.7", "int"),
    ("free_weekly_limit", "oops", "int"),
    ("default_target_lufs", "-9.5", "float"),
    ("jwt_secret", None, "str"), ("ai_model", "m", "str"),
])
def test_settings_overrides_match_jax(fresh, key, value, kind):
    default = {"bool": True, "int": 0, "float": 0.0, "str": None}[kind]
    got = []
    for p in PKGS:
        if value is not None:
            p["store"].set_setting(key, value)
        got.append(getattr(p["store"], f"get_setting_{kind}")(key, default))
    assert got[1] == got[0]


@pytest.mark.parametrize("tier", ["free", "pro", "studio", "unknown"])
@pytest.mark.parametrize("name", ["a.wav", "a.MP3", "a.flac", "a.ogg", ""])
def test_upload_limits_match_jax(fresh, tier, name):
    for p in PKGS:
        p["store"].set_setting("tier_upload_mb_pro", "250")
    assert (tstore.get_max_upload_mb(name, tier)
            == jstore.get_max_upload_mb(name, tier))


def test_tokens_cross_between_packages(fresh, monkeypatch):
    for p in PKGS:
        monkeypatch.setattr(p["settings"], "jwt_secret", "shared")
    for make, read in ((jauth, tauth), (tauth, jauth)):
        tok = make.create_token("7", tier="pro", is_admin=False)
        assert read.decode_token(tok) == make.decode_token(tok)
        assert read.decode_token(tok)["sub"] == "7"
        assert read.decode_token(tok + "x") is None
        stored = make.hash_password("pw")
        assert read.verify_password("pw", stored)
        assert not read.verify_password("nope", stored)
    expired = jauth.create_token("7", expires_minutes=-1)
    assert tauth.decode_token(expired) is None
    key, prefix, key_hash = tauth.new_api_key()
    assert jauth.api_key_hash(key) == tauth.api_key_hash(key) == key_hash
    monkeypatch.setattr(tconfig.settings, "jwt_secret", "other")
    assert tauth.decode_token(jauth.create_token("7")) is None


def test_users_match_jax(fresh):
    out = []
    for p in PKGS:
        u = p["users"]
        a = u.create_user("A@x.io ", p["auth"].hash_password("pw"))
        b = u.create_user("b@x.io", "h", tier="free", referred_by=a["id"])
        u.update_user(b["id"], tokens=4, is_blocked=1)
        u.add_tokens(b["id"], 3)
        kid = u.create_api_key(a["id"], p["auth"].api_key_hash("k1"), "k1",
                               "ci")
        u.save_preset(a["id"], "loud", '{"t": -9}')
        p["db"].record_mastering(a["id"], "t.wav", "edm", -9.0, -20.0, -9.1,
                                 "wav")
        out.append({
            "a": _strip(u.get_user_by_email("a@x.io")),
            "b": _strip(u.get_user_by_id(b["id"])),
            "by_code": _strip(u.get_user_by_referral_code(
                a["referral_code"].lower())),
            "by_key": _strip(u.find_user_by_api_key_hash(
                p["auth"].api_key_hash("k1"))),
            "keys": [_strip(k) for k in u.list_api_keys(a["id"])],
            "presets": [_strip(r) for r in u.list_presets(a["id"])],
            "history": [_strip(r) for r in u.list_history(a["id"])],
            "stats": u.user_stats(a["id"])["masterings_total"],
            "revoke": (u.revoke_api_key(a["id"], kid),
                       u.find_user_by_api_key_hash(
                           p["auth"].api_key_hash("k1"))),
        })
    assert out[1] == out[0]
    assert out[0]["a"]["email"] == "a@x.io" and out[0]["b"]["tokens"] == 7


def _request(headers=None, peer="127.0.0.1"):
    transport = mock.Mock()
    transport.get_extra_info.side_effect = (
        lambda k, d=None: (peer, 5555) if k == "peername" else d)
    return make_mocked_request("GET", "/api/x", headers=headers or {},
                               transport=transport)


@pytest.mark.parametrize("peer,headers", [
    ("127.0.0.1", {"X-Real-IP": "9.9.9.9"}),
    ("10.0.0.5", {"X-Forwarded-For": "1.1.1.1, 2.2.2.2"}),
    ("8.8.8.8", {"X-Real-IP": "9.9.9.9"}),
    ("172.20.0.1", {}),
])
def test_client_ip_matches_jax(peer, headers):
    req = _request(headers, peer)
    assert tdeps.client_ip(req) == jdeps.client_ip(req)


def test_current_user_matches_jax(fresh, monkeypatch):
    got = []
    for p in PKGS:
        monkeypatch.setattr(p["settings"], "jwt_secret", "s")
        u = p["users"]
        pro = u.create_user("p@x.io", "h", tier="pro")
        u.update_user(pro["id"], subscription_until=time.time() - 10)
        studio = u.create_user("s@x.io", "h", tier="studio")
        u.create_api_key(studio["id"], p["auth"].api_key_hash("key-s"),
                         "key-s", "n")
        blocked = u.create_user("x@x.io", "h")
        u.update_user(blocked["id"], is_blocked=1)
        tok = {i: p["auth"].create_token(str(i))
               for i in (pro["id"], blocked["id"])}
        dep = p["deps"]
        rows = []
        for headers in ({}, {"Authorization": f"Bearer {tok[pro['id']]}"},
                        {"Authorization": f"Bearer {tok[blocked['id']]}"},
                        {"X-API-Key": "key-s"}, {"X-API-Key": "wrong"},
                        {"Authorization": "Bearer junk"}):
            user = dep.get_current_user_optional(_request(headers))
            if user is not None:
                user = {k: v for k, v in user.items() if k != "exp"}
            rows.append((user, dep.is_priority_user(user)))
        rows.append(_strip(u.get_user_by_id(pro["id"])))  # downgraded
        got.append(rows)
    assert got[1] == got[0]
    assert got[0][1][0]["tier"] == "free" and got[0][3][1] is True


def test_rate_limits_match_jax(fresh, monkeypatch):
    for p in PKGS:
        monkeypatch.setattr(p["settings"], "rate_limit_per_minute", 3)
        monkeypatch.setattr(p["settings"], "auth_rate_per_minute", 2)
        p["store"].set_setting("free_weekly_limit", "2")
    got = []
    for p in PKGS:
        d = p["deps"]
        seq = [d.check_global_rate_limit("1.2.3.4") for _ in range(4)]
        seq += [d.check_global_rate_limit("5.6.7.8")]
        seq += [d.check_auth_rate_limit("1.2.3.4") for _ in range(3)]
        weekly = []
        for _ in range(3):
            weekly.append(d.check_free_weekly_limit("1.2.3.4"))
            d.record_free_usage("1.2.3.4")
        d.reset_rate_limits()
        weekly.append(d.check_free_weekly_limit("1.2.3.4"))
        got.append((seq, weekly, d.check_global_rate_limit("1.2.3.4")))
    assert got[1] == got[0]
    assert got[0][0] == [True] * 3 + [False, True, True, True, False]
    assert [w["allowed"] for w in got[0][1]] == [True, True, False, True]


def _make_jobs(p, now):
    j = p["jobs"]
    for i in range(5):
        j.new_job(f"job{i}", target_lufs=-14.0, style="edm", data=b"x" * 8,
                  filename=f"t{i}.wav", out_format="WAV", notify_user_id=i)
        j.all_jobs()[f"job{i}"]["created_at"] = now - 100 + i
    j.update_job("job0", status="done", progress=100, result_bytes=b"r")
    j.all_jobs()["job0"]["done_at"] = now - 7200  # past the TTL
    j.update_job("job1", status="error", error="boom")
    j.update_job("job2", progress=40, message="half")
    j.update_job("nope", status="done")


def test_jobs_store_matches_jax(fresh, monkeypatch):
    now = time.time()
    got = []
    for p in PKGS:
        monkeypatch.setattr(p["settings"], "jobs_max_entries", 3)
        _make_jobs(p, now)
        j = p["jobs"]
        before = j.counts()
        job2 = {k: v for k, v in j.get_job("job2").items()
                if k not in ("created_at", "done_at")}
        j.prune_jobs()
        mirror = sorted((r["job_id"], r["status"], r["progress"], r["error"],
                         r["user_id"], r["meta_json"].count('"style"'))
                        for r in p["db"].job_load_recent())
        got.append((before, job2, sorted(j.all_jobs()), j.counts(), mirror,
                    j.restore_from_db(),
                    sorted((r["job_id"], r["status"], r["error"])
                           for r in p["db"].job_load_recent())))
    assert got[1] == got[0]
    before, job2, kept, after, mirror, restored, rows = got[0]
    assert before == {"jobs_running": 3, "jobs_total": 5}
    assert kept == ["job2", "job3", "job4"] and restored == 3
    assert job2["out_format"] == "wav" and job2["message"] == "half"
    assert ("job3", "error", "Service was restarted") in rows


@pytest.mark.parametrize("normal,priority", [(1, 2), (8, 3), (0, 0)])
def test_one_semaphore_a_loop_of_the_configured_size(monkeypatch, normal,
                                                     priority):
    for p in PKGS:
        monkeypatch.setattr(p["settings"], "semaphore_normal", normal)
        monkeypatch.setattr(p["settings"], "semaphore_priority", priority)
        monkeypatch.setattr(p["jobs"], "_sems", {})

    async def pick(j):
        a, b = j.select_semaphore(False), j.select_semaphore(False)
        c = j.select_semaphore(True)
        assert a is b and a is not c
        return a, c

    got = {}
    # two loops alive at once (the cache is keyed by the loop's id)
    loops = [asyncio.new_event_loop() for _ in range(2)]
    try:
        for name, p in (("jax", JAX), ("port", PORT)):
            sems = [loop.run_until_complete(pick(p["jobs"]))
                    for loop in loops]
            assert sems[0][0] is not sems[1][0]  # one a loop
            got[name] = [(s._value, t._value) for s, t in sems]
    finally:
        for loop in loops:
            loop.close()
    assert got["port"] == got["jax"] == [(max(1, normal),
                                          max(1, priority))] * 2
