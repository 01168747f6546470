"""The port's serving mesh on the CPU: the flows of
tests/test_service_mesh.py on ``MasteringEngine(device="cpu", mesh=...)``
over 8 ``cpu`` positions (the JAX suite's 8 virtual devices), through the
port's HTTP app where that file goes through the JAX app, and the
long-upload (sequence-parallel) response against the JAX engine's on its
8-device CPU mesh.  Also the engine's rule for building a mesh by itself.

Bars: a dithered 16-bit WAV within 3/32768 of the other engine's (the TPDF
draws differ), loudness within 0.01 LU (1e-3 between the port's own
engines, as tests/test_service_mesh.py)."""

import asyncio
import contextlib
import json
import tempfile
from pathlib import Path
from unittest import mock

import aiohttp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from amw_tpu.runtime import config as jconfig
from amw_tpu.runtime.engine import MasteringEngine as JaxEngine
from amw_tpu_torch.parallel import mesh as tmesh
from amw_tpu_torch.runtime import config as tconfig
from amw_tpu_torch.runtime import db as tdb
from amw_tpu_torch.runtime import deps as tdeps
from amw_tpu_torch.runtime import engine as tengine
from amw_tpu_torch.runtime import jobs as tjobs
from amw_tpu_torch.runtime.engine import MasteringEngine
from amw_tpu_torch.runtime.service import create_app
from amw_tpu_torch.scripts import gen_demo_assets as tdemo
from amw_tpu_torch.utils import wav
from test_torch_service_auth import rendered_demo_dir

SR = 8000
N_POS = 8
LSB3 = 3.0 / 32768.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU paths here are many small ops: one intra-op thread
    keeps them from spinning against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _wav_bytes(dur=2.0, freq=440.0, amp=0.4, sr=SR):
    t = np.arange(int(sr * dur)) / sr
    x = (amp * np.sin(2 * np.pi * freq * t)).astype(np.float32)
    q = (np.clip(np.stack([x, 0.8 * x]), -1, 1) * 32767).astype(np.int16)
    return wav.write_wav_int16(q, sr)


@pytest.fixture(scope="module")
def mesh_engine():
    """The port's engine over 8 positions on the CPU, micro-batcher on;
    the anonymous limits off; the sp settings restored afterwards."""
    with pytest.MonkeyPatch.context() as mp:
        for s in (tconfig.settings, jconfig.settings):
            mp.setattr(s, "mastering_debug_skip_limits", True)
            mp.setattr(s, "engine_sp_threshold_sec", 600.0)
            mp.setattr(s, "engine_sp_quantize_sec", 30.0)
        mp.delenv("AMW_HTDEMUCS_CKPT", raising=False)
        eng = MasteringEngine(bucket=True, device="cpu",
                              mesh=tmesh.make_mesh(N_POS,
                                                   devices=["cpu"] * N_POS))
        assert eng.mesh.devices.size == N_POS
        yield eng
        eng.close()


@pytest.fixture(scope="module")
def app_factory(mesh_engine):
    with tempfile.NamedTemporaryFile(suffix=".sqlite3") as tmp, \
            tempfile.TemporaryDirectory() as demos, \
            mock.patch.dict(tjobs._jobs), \
            pytest.MonkeyPatch.context() as mp:
        tdb.set_db_path(tmp.name)
        mp.setattr(tdemo, "DEMO_DIR", rendered_demo_dir(Path(demos)))

        def make(engine=mesh_engine):
            tdeps.reset_rate_limits()
            return create_app(engine)

        yield make


def _client_test(make, fn):
    async def inner():
        async with TestClient(TestServer(make())) as client:
            return await fn(client)

    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(inner())
    finally:
        loop.close()


def _form(fields):
    form = aiohttp.FormData()
    for k, v in fields.items():
        if k == "files":
            for blob in v:
                form.add_field("files", blob, filename="test.wav",
                               content_type="audio/wav")
        elif k == "file":
            form.add_field("file", v, filename="test.wav",
                           content_type="audio/wav")
        else:
            form.add_field(k, str(v))
    return form


async def _wait_done(client, jid, tries=480):
    for _ in range(tries):
        st = await (await client.get(f"/api/master/status/{jid}")).json()
        if st["status"] in ("done", "error"):
            return st
        await asyncio.sleep(0.25)
    raise AssertionError("job timed out")


@contextlib.contextmanager
def _settings(**values):
    """Both packages' settings set to ``values`` inside the block."""
    with pytest.MonkeyPatch.context() as mp:
        for s in (tconfig.settings, jconfig.settings):
            for k, v in values.items():
                mp.setattr(s, k, v)
        yield


def test_batch_burst_runs_over_every_position(app_factory, mesh_engine):
    """A burst of uploads through the port's service runs as micro-batch
    steps split over all 8 positions."""
    mesh_engine.last_batch_info = None

    async def fn(client):
        blobs = [_wav_bytes(freq=f) for f in (220, 330, 440, 550)]
        r = await client.post("/api/v2/batch",
                              data=_form({"files": blobs,
                                          "preset": "spotify"}))
        assert r.status == 200, await r.text()
        ids = (await r.json())["job_ids"]
        assert len(ids) == 4
        for jid in ids:
            st = await _wait_done(client, jid)
            assert st["status"] == "done", st
            blob = await (await client.get(
                f"/api/master/result/{jid}")).read()
            audio, _ = wav.read_wav(blob)
            assert np.all(np.isfinite(audio))

    _client_test(app_factory, fn)
    info = mesh_engine.last_batch_info
    assert info is not None, "micro-batcher never ran"
    assert info["batch_compiled"] % N_POS == 0, info
    assert info["devices"] == N_POS, info


def test_mesh_batch_results_match_single_device_engine(mesh_engine):
    """Per-track results of the mesh's step equal the engine without a
    mesh and without the batcher (modulo the TPDF dither)."""
    data = _wav_bytes(freq=261.6)
    got = mesh_engine.master_v2_bytes(data, "t.wav", target_lufs=-14.0)
    solo = MasteringEngine(bucket=True, micro_batch=False, device="cpu")
    assert solo.mesh is None
    want = solo.master_v2_bytes(data, "t.wav", target_lufs=-14.0)
    a, sra = wav.read_wav(got["bytes"])
    b, srb = wav.read_wav(want["bytes"])
    assert sra == srb and a.shape == b.shape
    assert np.max(np.abs(a.astype(np.float64) - b)) <= LSB3
    assert abs(got["after_lufs"] - want["after_lufs"]) < 1e-3


def test_long_upload_served_sequence_parallel(app_factory, mesh_engine):
    """An upload past the sp threshold is served time-sharded through the
    service, with the full v2 response."""
    with _settings(engine_sp_threshold_sec=4.0):
        async def fn(client):
            r = await client.post("/api/v2/master", data=_form(
                {"file": _wav_bytes(dur=6.0), "preset": "spotify"}))
            assert r.status == 200, await r.text()
            jid = (await r.json())["job_id"]
            st = await _wait_done(client, jid)
            assert st["status"] == "done", st
            assert st["after_lufs"] == pytest.approx(-14.0, abs=0.5)
            blob = await (await client.get(
                f"/api/master/result/{jid}")).read()
            audio, sr = wav.read_wav(blob)
            assert sr == SR and audio.shape[-1] == 6 * SR
            assert np.all(np.isfinite(audio))

        _client_test(app_factory, fn)
        assert any(k[0] == "sp" for k in mesh_engine._sp_cache)


@pytest.fixture(scope="module")
def jax_engine():
    """The JAX engine on its 8-device CPU mesh, no micro-batcher."""
    with _settings(mastering_debug_skip_limits=True):
        eng = JaxEngine(bucket=True, micro_batch=False)
        assert eng.mesh is not None and eng.mesh.devices.size == N_POS
        yield eng


@pytest.mark.parametrize("grid", [30.0, 0.0], ids=["quantized", "exact"])
def test_long_upload_matches_jax_engine(mesh_engine, jax_engine, grid):
    """The sequence-parallel response of the port over 8 positions against
    the JAX engine's over its 8 devices, on the same upload."""
    data = _wav_bytes(dur=6.5, freq=330.0)
    with _settings(engine_sp_threshold_sec=4.0,
                   engine_sp_quantize_sec=grid):
        got = mesh_engine.master_v2_bytes(data, "t.wav", target_lufs=-14.0)
        want = jax_engine.master_v2_bytes(data, "t.wav", target_lufs=-14.0)
    assert any(k[1][1] == (int(grid * SR) if grid else int(6.5 * SR))
               for k in jax_engine._sp_cache)
    a, _ = wav.read_wav(got["bytes"])
    b, _ = wav.read_wav(want["bytes"])
    assert a.shape == b.shape == (2, int(6.5 * SR))
    assert np.max(np.abs(a.astype(np.float64) - b)) <= LSB3
    for k in ("before_lufs", "after_lufs"):
        assert abs(got[k] - want[k]) < 0.01, k


def test_sp_length_quantization_shares_one_graph(mesh_engine):
    """Distinct long-upload lengths snap to the ``engine_sp_quantize_sec``
    grid and share one sp graph; outputs keep their lengths, and the
    loudness matches the exact-length graph's."""
    with _settings(engine_sp_threshold_sec=4.0, engine_sp_quantize_sec=30.0):
        r1 = mesh_engine.master_v2_bytes(_wav_bytes(dur=5.5), "a.wav",
                                         target_lufs=-14.0)
        keys_mid = set(mesh_engine._sp_cache)
        r2 = mesh_engine.master_v2_bytes(_wav_bytes(dur=6.25), "b.wav",
                                         target_lufs=-14.0)
        a1, _ = wav.read_wav(r1["bytes"])
        a2, _ = wav.read_wav(r2["bytes"])
        assert a1.shape[-1] == int(5.5 * SR)
        assert a2.shape[-1] == int(6.25 * SR)
        assert set(mesh_engine._sp_cache) == keys_mid
        assert any(k[0] == "sp" and k[1][1] == int(30.0 * SR)
                   for k in keys_mid)
    with _settings(engine_sp_threshold_sec=4.0, engine_sp_quantize_sec=0.0):
        r_exact = mesh_engine.master_v2_bytes(_wav_bytes(dur=5.5), "a.wav",
                                              target_lufs=-14.0)
    assert abs(r1["after_lufs"] - r_exact["after_lufs"]) < 0.02
    a_exact, _ = wav.read_wav(r_exact["bytes"])
    d = np.abs(a1.astype(np.float64) - a_exact)
    assert np.max(d[:, : int(0.95 * d.shape[-1])]) < 0.005
    assert np.max(d) < 0.35


def test_long_upload_sp_rejected_config_falls_back(app_factory,
                                                   mesh_engine, caplog):
    """A config the time-shard builder rejects (a reverb IR wider than the
    halo) is served by the single-device graph, with a logged warning."""
    cfg = {"modules": [
        {"id": "dc_offset", "enabled": True},
        {"id": "reverb", "enabled": True, "reverb_type": "cathedral",
         "decay_sec": 4.0, "amount": 0.2},
        {"id": "normalize_lufs", "enabled": True, "target_lufs": -14.0},
    ]}
    n_sp_before = len(mesh_engine._sp_cache)
    with _settings(engine_sp_threshold_sec=4.0), \
            caplog.at_level("WARNING", logger="amw_tpu_torch.engine"):
        async def fn(client):
            r = await client.post("/api/v2/master", data=_form(
                {"file": _wav_bytes(dur=6.0), "preset": "spotify",
                 "config": json.dumps(cfg)}))
            assert r.status == 200, await r.text()
            jid = (await r.json())["job_id"]
            st = await _wait_done(client, jid)
            assert st["status"] == "done", st
            blob = await (await client.get(
                f"/api/master/result/{jid}")).read()
            audio, _ = wav.read_wav(blob)
            assert audio.shape[-1] == 6 * SR and np.all(np.isfinite(audio))

        _client_test(app_factory, fn)
    assert len(mesh_engine._sp_cache) == n_sp_before
    assert "sp path rejected config" in caplog.text


def test_sp_failure_other_than_a_rejection_propagates(mesh_engine,
                                                      monkeypatch):
    """Only the builder's rejection falls back: an error while the sp
    graph runs fails the job."""
    with _settings(engine_sp_threshold_sec=4.0, engine_sp_quantize_sec=0.0):
        def broken(*a, **k):
            raise RuntimeError("device failure")

        monkeypatch.setattr("amw_tpu_torch.parallel.timeshard._run_variant",
                            broken)
        with pytest.raises(RuntimeError, match="device failure"):
            mesh_engine.master_v2_bytes(_wav_bytes(dur=7.0), "t.wav",
                                        target_lufs=-12.0)


def test_metrics_report_the_mesh(app_factory):
    async def fn(client):
        return await (await client.get("/api/metrics")).json()

    assert _client_test(app_factory, fn)["mesh_devices"] == N_POS
    solo = MasteringEngine(micro_batch=False, device="cpu")
    assert _client_test(lambda: app_factory(solo), fn)["mesh_devices"] == 1


def test_engine_mesh_rule(monkeypatch):
    """No mesh on the CPU, nor with one GPU, nor with ``engine_mesh`` off;
    a mesh of the local GPUs where there are more, with no process group
    joined (checked with CUDA faked: building the engine touches no
    device)."""
    assert MasteringEngine(micro_batch=False, device="cpu").mesh is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert MasteringEngine(micro_batch=False).mesh is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert MasteringEngine(micro_batch=False,
                           device="cpu").mesh is None
    joined = []
    monkeypatch.setattr(tmesh, "init_distributed",
                        lambda *a: joined.append(a) or True)
    eng = MasteringEngine(micro_batch=False)
    assert [str(d) for d in eng.mesh.devices.flat] == ["cuda:0", "cuda:1"]
    assert eng._batch_size_for(3) == 4 and eng._batch_size_for(1) == 2
    assert joined == []
    with _settings(engine_mesh=False):
        assert MasteringEngine(micro_batch=False).mesh is None
    assert tengine.MasteringEngine(micro_batch=False,
                                   mesh=tmesh.make_mesh(
                                       2, devices=["cpu"] * 2),
                                   device="cpu").mesh.devices.size == 2
