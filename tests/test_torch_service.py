"""The port's HTTP service (``amw_tpu_torch.runtime.service``) against the
JAX package's (``amw_tpu.runtime.service``), side by side on the CPU: the
same requests to both apps through ``aiohttp.test_utils.TestClient``, each
app on its own temporary database.

The port's app runs on ``MasteringEngine(device="cpu")`` (micro-batcher
on, as served); the JAX app on its engine without the micro-batcher (over
the suite's 8 virtual CPU devices it would shard its batches).  Uploads: 2 s
at 8 kHz (as tests/test_service.py) and a 2 s clip at 44.1 kHz.

Bars: a dithered 16-bit WAV within 2.5/32768 of JAX's (the TPDF draws
differ; tests/test_torch_engine.py), a float32 WAV within -90 dBFS, the
same length and header, the branding bytes identical; loudness in a job's
status within 0.01 LU (both sides round to 0.01, so two roundings may
differ by one step); the analysis responses as tests/test_torch_analyze.py
holds them (same keys and ``None`` pattern, numbers within 0.01), but
spectrum bars more than 100 dB under the loudest bar, which the float32
FFTs' round-off sets (the 8 kHz sine leaves nothing else there; the
packages differ there by up to 3 dB), are held to lie under that floor in
both; JSON of the other GET endpoints equal but the engine's name, uptime
and ids.
"""

import asyncio
import json
import struct
import tempfile
from pathlib import Path

import aiohttp
import numpy as np
import pytest
from aiohttp.test_utils import TestClient, TestServer

from amw_tpu.runtime import ai as jai
from amw_tpu.runtime import config as jconfig
from amw_tpu.runtime import db as jdb
from amw_tpu.runtime import deps as jdeps
from amw_tpu.runtime import settings_store as jstore
from amw_tpu.runtime.engine import MasteringEngine as JaxEngine
from amw_tpu.runtime.service import create_app as jax_create_app
from amw_tpu_torch.runtime import ai as tai
from amw_tpu_torch.runtime import config as tconfig
from amw_tpu_torch.runtime import db as tdb
from amw_tpu_torch.runtime import deps as tdeps
from amw_tpu_torch.runtime import settings_store as tstore
from amw_tpu_torch.runtime.engine import MasteringEngine
from amw_tpu_torch.runtime.service import create_app as port_create_app
from amw_tpu_torch.scripts import gen_demo_assets as tdemo
from amw_tpu_torch.utils import wav
from test_torch_service_auth import rendered_demo_dir

SR = 8000
SR_CLIP = 44100
LU = 0.01
FLOAT32_FLOOR_DB = 100.0
WAV16_LSB = 2.5
BAR_DBFS = -90.0


def _wav_bytes(dur=2.0, freq=440.0, amp=0.4, sr=SR):
    """tests/test_service.py's upload: a sine, right channel at 0.8."""
    t = np.arange(int(sr * dur)) / sr
    x = (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    q = (np.clip(np.stack([x, 0.8 * x]), -1, 1) * 32767).astype(np.int16)
    return wav.write_wav_int16(q, sr)


def _clip_bytes(dur=2.0, seed=0):
    """A 44.1 kHz clip: two partials and noise under a slow envelope."""
    g = np.random.default_rng(seed)
    n = int(SR_CLIP * dur)
    t = np.arange(n) / SR_CLIP
    x = (0.3 * np.sin(2 * np.pi * 110 * t) + 0.1 * np.sin(2 * np.pi * 2900 * t)
         + 0.04 * g.standard_normal(n))
    x *= 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 0.7 * t))
    q = np.round(np.clip(np.stack([x, 0.85 * x]), -1, 1) * 32767)
    return wav.write_wav_int16(q.astype(np.int16), SR_CLIP)


@pytest.fixture(scope="module")
def apps():
    """Factories of both apps, each package on its own temporary
    database, the anonymous weekly limit off (tests/test_service.py)."""
    tmp_j = tempfile.NamedTemporaryFile(suffix=".sqlite3")
    tmp_t = tempfile.NamedTemporaryFile(suffix=".sqlite3")
    jdb.set_db_path(tmp_j.name)
    tdb.set_db_path(tmp_t.name)
    with pytest.MonkeyPatch.context() as mp, \
            tempfile.TemporaryDirectory() as demos:
        mp.delenv("AMW_HTDEMUCS_CKPT", raising=False)
        mp.setattr(tdemo, "DEMO_DIR", rendered_demo_dir(Path(demos)))
        for s in (jconfig.settings, tconfig.settings):
            mp.setattr(s, "mastering_debug_skip_limits", True)
        jeng = JaxEngine(micro_batch=False)
        teng = MasteringEngine(device="cpu")

        def make():
            for mod in (jdeps, tdeps):
                mod.reset_rate_limits()
            for mod in (jai, tai):
                mod.reset_ai_usage()
            return jax_create_app(jeng), port_create_app(teng)

        yield make
        teng.close()
    tmp_j.close()
    tmp_t.close()


def both(apps, fn):
    """Run ``fn(jax_client, port_client)`` with both apps served."""
    async def inner():
        japp, tapp = apps()
        async with TestClient(TestServer(japp)) as jc, \
                TestClient(TestServer(tapp)) as tc:
            return await fn(jc, tc)

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(inner())
    finally:
        loop.close()


def _form(fields):
    """A multipart form: an upload is (name, bytes), a list of them sends
    each under the same field name."""
    form = aiohttp.FormData()
    for k, v in fields.items():
        for item in (v if isinstance(v, list) else [v]):
            if isinstance(item, tuple):
                form.add_field(k, item[1], filename=item[0],
                               content_type="audio/wav")
            else:
                form.add_field(k, str(item))
    return form


async def _post_both(jc, tc, path, fields):
    rj = await jc.post(path, data=_form(fields))
    rt = await tc.post(path, data=_form(fields))
    return rj, rt


def assert_same_json(got, want, path=""):
    """Same keys and ``None`` pattern, numbers within ``LU``, the rest
    equal (tests/test_torch_analyze.py's rule)."""
    if isinstance(want, bool) or want is None or isinstance(want, str):
        assert got == want, (path, got, want)
    elif isinstance(want, (int, float)):
        assert isinstance(got, (int, float)) and not isinstance(got, bool)
        assert abs(got - want) <= LU + 1e-9, (path, got, want)
    elif isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            if k.startswith("spectrum_bars"):
                assert_same_bars(got[k], want[k], f"{path}.{k}")
            else:
                assert_same_json(got[k], want[k], f"{path}.{k}")
    else:
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_json(g, w, f"{path}[{i}]")


def assert_same_bars(got, want, path):
    assert len(got) == len(want), path
    floor = max(want) - FLOAT32_FLOOR_DB
    for i, (g, w) in enumerate(zip(got, want)):
        if w < floor:
            assert g < floor, (path, i, g, w)
        else:
            assert abs(g - w) <= LU + 1e-9, (path, i, g, w)


def _data_span(blob):
    """(offset, size) of a WAV's data chunk."""
    pos = 12
    while pos + 8 <= len(blob):
        tag, size = blob[pos:pos + 4], struct.unpack_from("<I", blob, pos + 4)[0]
        if tag == b"data":
            return pos + 8, size
        pos += 8 + size + (size & 1)
    raise AssertionError("no data chunk")


def assert_same_wav(got: bytes, want: bytes, branded: bool = True):
    """The same header, length and branding bytes; samples within the bar
    of their format (16-bit: 2.5 LSB; float32: -90 dBFS)."""
    assert len(got) == len(want)
    off, size = _data_span(want)
    assert got[:off] == want[:off]
    assert got[off + size:] == want[off + size:]
    # the branding chunk of a mastering job's result
    assert want[off + size:].startswith(b"LIST") == branded
    a, _ = wav.read_wav(got)
    b, _ = wav.read_wav(want)
    assert a.shape == b.shape
    bits = struct.unpack_from("<H", want, 34)[0]
    err = float(np.max(np.abs(a.astype(np.float64) - b)))
    if bits == 16:
        assert err * 32768 <= WAV16_LSB, err * 32768
    else:
        assert 20 * np.log10(max(err, 1e-30)) <= BAR_DBFS


async def _wait_done(client, job_id):
    for _ in range(600):
        st = await (await client.get(f"/api/master/status/{job_id}")).json()
        if st["status"] in ("done", "error"):
            return st
        await asyncio.sleep(0.2)
    raise AssertionError(f"job {job_id} did not finish")


async def _sse(client, job_id):
    r = await client.get(f"/api/master/progress/{job_id}")
    assert r.status == 200
    assert r.headers["Content-Type"] == "text/event-stream"
    events = []
    async for line in r.content:
        line = line.decode().strip()
        if line.startswith("data: "):
            events.append(json.loads(line[6:]))
            if events[-1]["status"] in ("done", "error"):
                break
    return events


def assert_same_status(got, want):
    assert_same_json({k: v for k, v in got.items() if k != "message"},
                     {k: v for k, v in want.items() if k != "message"})


# ───────────────────────────── GET endpoints ──────────────────────────────

GETS = ["/api", "/api/health", "/api/metrics", "/api/version", "/api/presets",
        "/api/styles", "/api/v2/chain/default?style=edm&target_lufs=-9",
        "/api/v2/chain/default?target_lufs=oops", "/api/locale"]
# the keys that may differ: the engine's name, uptime, the serving mesh
# (the JAX app's spans the suite's 8 virtual devices, the port serves on
# one) and the last batch (the JAX app's engine runs without the
# micro-batcher)
VARYING = {"engine", "uptime_sec", "mesh_devices", "last_batch"}


@pytest.mark.parametrize("path", GETS)
def test_get_endpoints_match_jax(apps, path):
    async def fn(jc, tc):
        headers = {"Accept-Language": "ru-RU"}
        rj = await jc.get(path, headers=headers)
        rt = await tc.get(path, headers=headers)
        assert rt.status == rj.status == 200
        want, got = await rj.json(), await rt.json()
        assert sorted(got) == sorted(want)
        for k in VARYING & set(want):
            want.pop(k), got.pop(k)
        assert got == want

    both(apps, fn)


def test_version_names_the_port(apps):
    async def fn(jc, tc):
        got = await (await tc.get("/api/version")).json()
        want = await (await jc.get("/api/version")).json()
        assert got["engine"] == "amw_tpu_torch" and want["engine"] == "amw_tpu"
        metrics = await (await tc.get("/api/metrics")).json()
        assert metrics["mesh_devices"] == 1

    both(apps, fn)


# ───────────────────────────── job cycles ─────────────────────────────────


@pytest.mark.parametrize("route,fields", [
    ("/api/v2/master", {"preset": "spotify", "out_format": "wav"}),
    ("/api/v2/master", {"style": "edm", "clip": True,
                        "rumble_enabled": "true", "parallel_mix": "0.25",
                        "out_format": "wav"}),
    ("/api/master", {"target_lufs": "-16", "clip": True}),
], ids=["v2", "v2_pro_clip", "v1_clip"])
def test_job_cycle_matches_jax(apps, route, fields):
    """Upload, the SSE stream to its end, status, result, preview; the
    result is gone after its download in both."""
    fields = dict(fields)
    data = _clip_bytes() if fields.pop("clip", False) else _wav_bytes()

    async def fn(jc, tc):
        rj, rt = await _post_both(jc, tc, route,
                                  {**fields, "file": ("t.wav", data)})
        assert rj.status == rt.status == 200, await rt.text()
        pj, pt = await rj.json(), await rt.json()
        assert {k: v for k, v in pt.items() if k != "job_id"} == {
            k: v for k, v in pj.items() if k != "job_id"}
        ej, et = await asyncio.gather(_sse(jc, pj["job_id"]),
                                      _sse(tc, pt["job_id"]))
        assert ej[-1]["status"] == et[-1]["status"] == "done", et[-1]
        assert_same_status(et[-1], ej[-1])
        for events in (ej, et):
            pct = [e["progress"] for e in events]
            assert pct == sorted(pct) and pct[-1] == 100
        sj = await (await jc.get(f"/api/master/status/{pj['job_id']}")).json()
        st = await (await tc.get(f"/api/master/status/{pt['job_id']}")).json()
        assert_same_status(st, sj)
        prev = []
        for c, jid in ((jc, pj["job_id"]), (tc, pt["job_id"])):
            r = await c.get(f"/api/master/preview/{jid}?src=original")
            assert r.content_type == "audio/wav" and await r.read() == data
            r = await c.get(f"/api/master/preview/{jid}")
            prev.append((r.status, r.content_type))
        assert prev[0] == prev[1] == (200, "audio/wav")
        res = []
        for c, jid in ((jc, pj["job_id"]), (tc, pt["job_id"])):
            r = await c.get(f"/api/master/result/{jid}")
            assert r.status == 200
            res.append((r.headers["Content-Disposition"], await r.read()))
            assert (await c.get(f"/api/master/status/{jid}")).status == 404
        assert res[1][0] == res[0][0]
        assert_same_wav(res[1][1], res[0][1])

    both(apps, fn)


def test_batch_matches_jax(apps):
    files = [("a.wav", _wav_bytes()), ("b.wav", _wav_bytes(freq=330))]

    async def fn(jc, tc):
        rj, rt = await _post_both(jc, tc, "/api/v2/batch",
                                  {"files": files, "preset": "apple"})
        assert rj.status == rt.status == 200, await rt.text()
        ij, it = (await rj.json())["job_ids"], (await rt.json())["job_ids"]
        assert len(ij) == len(it) == 2
        for a, b in zip(ij, it):
            sj, st = await asyncio.gather(_wait_done(jc, a),
                                          _wait_done(tc, b))
            assert st["status"] == "done", st
            assert_same_status(st, sj)
            blob_j = await (await jc.get(f"/api/master/result/{a}")).read()
            blob_t = await (await tc.get(f"/api/master/result/{b}")).read()
            assert_same_wav(blob_t, blob_j)

    both(apps, fn)


def test_master_auto_matches_jax(apps):
    async def fn(jc, tc):
        rj, rt = await _post_both(jc, tc, "/api/v2/master/auto",
                                  {"file": ("t.wav", _wav_bytes())})
        assert rj.status == rt.status == 200, await rt.text()
        pj, pt = await rj.json(), await rt.json()
        for k in ("status", "version", "style", "target_lufs", "reason"):
            assert pt[k] == pj[k], k
        sj, st = await asyncio.gather(_wait_done(jc, pj["job_id"]),
                                      _wait_done(tc, pt["job_id"]))
        assert st["status"] == "done", st
        assert_same_status(st, sj)

    both(apps, fn)


# ───────────────────────────── rejections ─────────────────────────────────

NOT_AUDIO = b"not audio at all, definitely"
REJECTS = {
    "wrong_magic": ("/api/v2/master", {"file": ("t.wav", NOT_AUDIO)}),
    "extension": ("/api/v2/master", {"file": ("t.ogg", _wav_bytes())}),
    "empty": ("/api/master", {"file": ("t.wav", b"")}),
    "config_json": ("/api/v2/master", {"file": ("t.wav", _wav_bytes()),
                                       "config": "{oops"}),
    "vocal_disabled": ("/api/v2/master", {"file": ("t.wav", _wav_bytes()),
                                          "apply_vocal_isolation": "true"}),
    "batch_empty": ("/api/v2/batch", {"preset": "apple",
                                       "note": ("a.txt", b"no files")}),
    "batch_magic": ("/api/v2/batch", {"files": [("a.wav", NOT_AUDIO)]}),
    "analyze_magic": ("/api/v2/analyze", {"file": ("t.wav", NOT_AUDIO)}),
    "measure_extension": ("/api/measure", {"file": ("t.txt", NOT_AUDIO)}),
    "lufs_extension": ("/api/tools/lufs-analyze",
                       {"file": ("t.ogg", NOT_AUDIO)}),
    "lufs_magic": ("/api/tools/lufs-analyze", {"file": ("t.wav", NOT_AUDIO)}),
    "upscale_rate": ("/api/v2/upscale", {"file": ("t.wav", _wav_bytes()),
                                         "target_sr": "44100"}),
    "upscale_down": ("/api/v2/upscale",
                     {"file": ("t.wav", _wav_bytes(sr=96000, dur=0.5)),
                      "target_sr": "48000"}),
    "reference_missing": ("/api/v2/reference-match",
                          {"file": ("t.wav", _wav_bytes())}),
    "reference_format": ("/api/v2/reference-match",
                         {"file": ("t.wav", _wav_bytes()),
                          "reference": ("r.wav", _wav_bytes(freq=220)),
                          "out_format": "ogg"}),
    "auto_format": ("/api/v2/master/auto", {"file": ("t.wav", _wav_bytes()),
                                            "out_format": "ogg"}),
    "isolate_disabled": ("/api/v2/isolate-vocal",
                         {"file": ("t.wav", _wav_bytes())}),
}


@pytest.mark.parametrize("case", sorted(REJECTS))
def test_rejected_request_matches_jax(apps, case):
    path, fields = REJECTS[case]

    async def fn(jc, tc):
        rj, rt = await _post_both(jc, tc, path, fields)
        assert rj.status >= 400
        assert rt.status == rj.status
        assert await rt.json() == await rj.json()

    both(apps, fn)


@pytest.mark.parametrize("path", ["status", "progress", "result", "preview",
                                  "share"])
def test_unknown_job_matches_jax(apps, path):
    async def fn(jc, tc):
        rj = await jc.get(f"/api/master/{path}/nonexistent")
        rt = await tc.get(f"/api/master/{path}/nonexistent")
        assert rt.status == rj.status
        assert await rt.read() == await rj.read()

    both(apps, fn)


def test_upload_limit_and_batch_size_match_jax(apps, monkeypatch):
    """The settings store's tier cap (``tier_upload_mb_free`` = 0 in both
    databases) and ``batch_max_files``."""
    for s in (jconfig.settings, tconfig.settings):
        monkeypatch.setattr(s, "batch_max_files", 1)

    async def fn(jc, tc):
        rj, rt = await _post_both(jc, tc, "/api/v2/batch", {
            "files": [("a.wav", _wav_bytes()), ("b.wav", _wav_bytes())]})
        assert rj.status == rt.status == 400
        assert await rt.json() == await rj.json()
        for store in (jstore, tstore):
            store.set_setting("tier_upload_mb_free", "0")
        try:
            rj, rt = await _post_both(jc, tc, "/api/v2/master",
                                      {"file": ("t.wav", _wav_bytes())})
            assert rj.status == rt.status == 400
            assert await rt.json() == await rj.json() == {
                "detail": "File larger than 0 MB."}
        finally:
            for store in (jstore, tstore):
                store.set_setting("tier_upload_mb_free", None)

    both(apps, fn)


# ───────────────────────────── tools ──────────────────────────────────────


@pytest.mark.parametrize("path,fields", [
    ("/api/v2/analyze", {"extended": "true"}),
    ("/api/v2/analyze", {}),
    ("/api/tools/lufs-analyze", {}),
    ("/api/measure", {}),
], ids=["analyze_extended", "analyze", "lufs_tool", "measure"])
@pytest.mark.parametrize("clip", [False, True], ids=["8k", "44k"])
def test_analysis_endpoints_match_jax(apps, path, fields, clip):
    data = _clip_bytes(seed=3) if clip else _wav_bytes()

    async def fn(jc, tc):
        rj, rt = await _post_both(jc, tc, path,
                                  {**fields, "file": ("t.wav", data)})
        assert rj.status == rt.status == 200, await rt.text()
        assert_same_json(await rt.json(), await rj.json())

    both(apps, fn)


def test_reference_match_and_upscale_match_jax(apps):
    async def fn(jc, tc):
        # clips that carry signal in every band: the match's gain is the
        # ratio of the two tracks' envelopes, and where both hold only
        # round-off (tests/test_service.py's pure sines at 8 kHz) the
        # packages' float32 floors differ (0.0021 on a 0.007 peak)
        rj, rt = await _post_both(jc, tc, "/api/v2/reference-match", {
            "file": ("src.wav", _clip_bytes(seed=1)),
            "reference": ("ref.wav", _clip_bytes(seed=2)),
            "strength": "0.8"})
        assert rj.status == rt.status == 200, await rt.text()
        assert (rt.headers["Content-Disposition"]
                == rj.headers["Content-Disposition"])
        assert_same_wav(await rt.read(), await rj.read(), branded=False)
        rj, rt = await _post_both(jc, tc, "/api/v2/upscale", {
            "file": ("t.wav", _wav_bytes()), "target_sr": "48000"})
        assert rj.status == rt.status == 200, await rt.text()
        assert (rt.headers["Content-Disposition"]
                == rj.headers["Content-Disposition"])
        got, want = await rt.read(), await rj.read()
        assert got[:44] == want[:44] and len(got) == len(want)
        a, sr = wav.read_wav(got)
        b, _ = wav.read_wav(want)
        assert sr == 48000
        assert float(np.max(np.abs(a - b))) * 32768 <= WAV16_LSB

    both(apps, fn)


def test_vocal_isolation_override_matches_jax(apps):
    """Off by default (503 in both); on through each package's settings
    store, the separator's float32 WAV within -90 dBFS of JAX's."""
    async def fn(jc, tc):
        fields = {"file": ("t.wav", _clip_bytes(seed=5))}
        rj, rt = await _post_both(jc, tc, "/api/v2/isolate-vocal", fields)
        assert rj.status == rt.status == 503
        for store in (jstore, tstore):
            store.set_setting("vocal_isolation_enabled", "true")
        try:
            rj, rt = await _post_both(jc, tc, "/api/v2/isolate-vocal",
                                      fields)
            assert rj.status == rt.status == 200, await rt.text()
            got, want = await rt.read(), await rj.read()
            assert got[:44] == want[:44] and len(got) == len(want)
            a, _ = wav.read_wav(got)
            b, _ = wav.read_wav(want)
            assert 20 * np.log10(max(float(np.max(np.abs(a - b))),
                                     1e-30)) <= BAR_DBFS
        finally:
            for store in (jstore, tstore):
                store.set_setting("vocal_isolation_enabled", "false")
        rj, rt = await _post_both(jc, tc, "/api/v2/isolate-vocal", fields)
        assert rj.status == rt.status == 503

    both(apps, fn)


# ───────────────────────────── gates, frontend ────────────────────────────


def test_maintenance_and_rate_limit_match_jax(apps, monkeypatch):
    async def fn(jc, tc):
        for store in (jstore, tstore):
            store.set_setting("maintenance_mode", "true")
        try:
            for path in ("/api/presets", "/api/health"):
                rj, rt = await jc.get(path), await tc.get(path)
                assert rt.status == rj.status
                if rj.status != 200:
                    assert await rt.json() == await rj.json()
            assert rj.status == 200 and (await jc.get("/api/presets")).status == 503
        finally:
            for store in (jstore, tstore):
                store.set_setting("maintenance_mode", "false")
        for s in (jconfig.settings, tconfig.settings):
            monkeypatch.setattr(s, "rate_limit_per_minute", 3)
        for mod in (jdeps, tdeps):
            mod.reset_rate_limits()
        got = []
        for c in (jc, tc):
            rs = [await c.get("/api/presets") for _ in range(4)]
            got.append([r.status for r in rs] + [await rs[-1].json()])
        assert got[1] == got[0]
        assert got[0][:4] == [200, 200, 200, 429]
        rj, rt = await jc.get("/"), await tc.get("/")  # not under /api
        assert rj.status == rt.status == 200

    both(apps, fn)


@pytest.mark.parametrize("path", ["/", "/app.js", "/landing", "/pricing.html",
                                  "/manifest.json", "/robots.txt",
                                  "/sitemap.xml", "/icons/icon-192.png",
                                  "/og-image.png", "/analytics/clarity.js"])
def test_frontend_matches_jax(apps, path):
    """The static frontend: the same body once each app's own origin is
    written as one token."""
    async def fn(jc, tc):
        rj, rt = await jc.get(path), await tc.get(path)
        assert rj.status == rt.status == 200
        assert rt.content_type == rj.content_type
        bj, bt = await rj.read(), await rt.read()
        oj = str(jc.make_url("")).rstrip("/").encode()
        ot = str(tc.make_url("")).rstrip("/").encode()
        assert bt.replace(ot, b"{{ORIGIN}}") == bj.replace(oj, b"{{ORIGIN}}")
        if path == "/":
            assert b"Magic" in bt and b"app.js" in bt

    both(apps, fn)


def test_bot_webhooks_match_jax(apps, monkeypatch):
    """No bot token: the webhooks answer as the JAX service does, the
    notify webhook's secret check included."""
    async def fn(jc, tc):
        for path in ("/bot/webhook", "/bot/notify/webhook"):
            rj = await jc.post(path, json={})
            rt = await tc.post(path, json={})
            assert rt.status == rj.status and rj.status in (404, 503)
            assert await rt.json() == await rj.json()
        for s in (jconfig.settings, tconfig.settings):
            monkeypatch.setattr(s, "telegram_bot_webhook_secret", "s3cr3t")
        hdr = {"X-Telegram-Bot-Api-Secret-Token": "wrong"}
        rj = await jc.post("/bot/notify/webhook", json={}, headers=hdr)
        rt = await tc.post("/bot/notify/webhook", json={}, headers=hdr)
        assert rj.status == rt.status == 403

    both(apps, fn)


def test_routes_cover_the_jax_services_own(apps):
    """The port serves exactly the (method, route) pairs the JAX service
    serves, its routers' included."""
    japp, tapp = apps()

    def routes(app):
        return {(r.method, r.resource.canonical) for r in app.router.routes()
                if r.resource is not None}

    jroutes, troutes = routes(japp), routes(tapp)
    assert jroutes == troutes, (sorted(jroutes - troutes),
                                sorted(troutes - jroutes))


def test_isolate_vocal_runs_the_network_from_the_database(apps):
    """``/api/v2/isolate-vocal`` with ``htdemucs_checkpoint = bundled`` set
    in each package's database: both services separate with the network
    (each on its own copy of the bundled checkpoint); the float32 WAVs
    within -90 dBFS."""
    from amw_tpu_torch.models import vocal as tvo

    async def fn(jc, tc):
        fields = {"file": ("t.wav", _clip_bytes(seed=7))}
        for store in (jstore, tstore):
            store.set_setting("vocal_isolation_enabled", "true")
        try:
            rt = await tc.post("/api/v2/isolate-vocal", data=_form(fields))
            dsp, _ = wav.read_wav(await rt.read())
            for store in (jstore, tstore):
                store.set_setting("htdemucs_checkpoint", "bundled")
            rj, rt = await _post_both(jc, tc, "/api/v2/isolate-vocal",
                                      fields)
            assert rj.status == rt.status == 200, await rt.text()
            got, want = await rt.read(), await rj.read()
        finally:
            for store in (jstore, tstore):
                store.set_setting("vocal_isolation_enabled", "false")
                store.set_setting("htdemucs_checkpoint", None)
        assert got[:44] == want[:44] and len(got) == len(want)
        a, _ = wav.read_wav(got)
        b, _ = wav.read_wav(want)
        assert 20 * np.log10(max(float(np.max(np.abs(a - b))),
                                 1e-30)) <= BAR_DBFS
        assert float(np.max(np.abs(a - dsp))) > 0.01  # not the DSP path
        assert any(k[0] == tvo.BUNDLED for k in tvo._ht_cache)

    both(apps, fn)
