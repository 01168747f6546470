"""The port's HTTP service on the card against its CPU path: the job layer
(``jobs.new_job`` and the v2 job runner under the job semaphores, what a
handler does after parsing) on a batch of three jobs, then the app itself
over ``aiohttp.test_utils.TestClient`` (a v2 job through its full cycle,
the extended analysis).

GPU only (``cuda`` marker; every test skips without a card).  The file
imports no JAX, so it runs on a machine with the card and no JAX package:

    python -m pytest --noconftest -q tests/test_torch_service_cuda.py

Bars: dithered 16-bit output within 2.5/32768 of the CPU engine's (each
side draws its own dither), the loudness in a job's status within 0.01 LU
(both round to 0.01, so two roundings may differ by one step), the
analysis response's numbers within 0.01.
"""

import asyncio
import json

import aiohttp
import numpy as np
import pytest
import torch
from aiohttp.test_utils import TestClient, TestServer

from amw_tpu_torch.runtime import config, db, jobs, service
from amw_tpu_torch.runtime.engine import MasteringEngine
from amw_tpu_torch.scripts import gen_demo_assets
from amw_tpu_torch.utils import wav

SR = 44100
LU = 0.01
WAV16_BAR = 2.5 / 32768


@pytest.fixture
def engines(tmp_path, monkeypatch):
    """A card engine and a CPU engine, the port on a temporary database,
    the anonymous weekly limit off, the demo clips there (so that a served
    app renders none)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    db.set_db_path(str(tmp_path / "t.sqlite3"))
    (tmp_path / "edm_mastered.wav").write_bytes(b"")
    monkeypatch.setattr(gen_demo_assets, "DEMO_DIR", tmp_path)
    monkeypatch.setattr(config.settings, "mastering_debug_skip_limits", True)
    gpu, cpu = MasteringEngine(), MasteringEngine(device="cpu")
    yield gpu, cpu
    gpu.close()
    cpu.close()


def upload(dur, seed):
    g = np.random.default_rng(seed)
    n = int(SR * dur)
    t = np.arange(n) / SR
    x = (0.28 * np.sin(2 * np.pi * 110 * t) + 0.12 * np.sin(
        2 * np.pi * 997 * t) + 0.05 * g.standard_normal(n))
    q = np.round(np.clip(np.stack([x, 0.85 * x]), -0.99, 0.99) * 32767)
    return wav.write_wav_int16(q.astype(np.int16), SR)


def _close_wav(got: bytes, want: bytes):
    assert len(got) == len(want) and got[:44] == want[:44]
    a, _ = wav.read_wav(got)
    b, _ = wav.read_wav(want)
    assert float(np.max(np.abs(a - b))) <= WAV16_BAR


@pytest.mark.cuda
def test_job_layer_cuda_matches_cpu(engines, monkeypatch):
    """Three jobs at once under a semaphore of three: one micro-batch on
    the card (a 1 s batch window, as chip_smoke.py's checked bursts: the
    default 50 ms may close before the third upload is decoded)."""
    monkeypatch.setattr(config.settings, "semaphore_normal", 3)
    monkeypatch.setattr(jobs, "_sems", {})
    monkeypatch.setattr(engines[0]._batcher, "window", 1.0)
    data = [upload(d, seed=i) for i, d in enumerate((4.0, 3.5, 4.0))]

    async def run(engine):
        app = {"engine": engine}
        ids = []
        for i, blob in enumerate(data):
            jid = f"{engine.device.type}-{i}"
            jobs.new_job(jid, target_lufs=-14.0, style="standard", data=blob,
                         filename="t.wav", out_format="wav")
            ids.append(jid)
        await asyncio.gather(*[service._run_job_v2(app, jid, dict(
            target_lufs=-14.0, out_format="wav", style="standard",
            chain_config=None, dither_type=None, auto_blank_sec=None,
            bitrate=None, pro={}, is_priority=False)) for jid in ids])
        return [jobs.all_jobs().pop(jid) for jid in ids]

    gpu, cpu = engines
    got = asyncio.run(run(gpu))
    assert gpu.last_batch_info["batch"] == 3
    want = asyncio.run(run(cpu))
    for g, w in zip(got, want):
        assert g["status"] == w["status"] == "done", g["error"]
        _close_wav(g["result_bytes"], w["result_bytes"])
        for k in ("before_lufs", "after_lufs"):
            assert abs(g[k] - w[k]) <= LU, k


async def _cycle(client, data):
    form = aiohttp.FormData()
    form.add_field("file", data, filename="t.wav", content_type="audio/wav")
    form.add_field("preset", "spotify")
    r = await client.post("/api/v2/master", data=form)
    assert r.status == 200, await r.text()
    job_id = (await r.json())["job_id"]
    r = await client.get(f"/api/master/progress/{job_id}")
    last = None
    async for line in r.content:
        line = line.decode().strip()
        if line.startswith("data: "):
            last = json.loads(line[6:])
            if last["status"] in ("done", "error"):
                break
    assert last["status"] == "done", last
    blob = await (await client.get(f"/api/master/result/{job_id}")).read()
    form = aiohttp.FormData()
    form.add_field("file", data, filename="t.wav", content_type="audio/wav")
    form.add_field("extended", "true")
    r = await client.post("/api/v2/analyze", data=form)
    assert r.status == 200, await r.text()
    return last, blob, await r.json()


def _same_json(got, want):
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _same_json(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same_json(g, w)
    elif isinstance(want, float) and not isinstance(want, bool):
        assert abs(got - want) <= LU + 1e-9
    else:
        assert got == want


@pytest.mark.cuda
def test_app_cuda_matches_cpu(engines):
    data = upload(6.0, seed=7)

    async def run(engine):
        async with TestClient(TestServer(service.create_app(engine))) as c:
            return await _cycle(c, data)

    gpu, cpu = engines
    sg, bg, ag = asyncio.run(run(gpu))
    sc, bc, ac = asyncio.run(run(cpu))
    _close_wav(bg, bc)
    for k in ("before_lufs", "after_lufs"):
        assert abs(sg[k] - sc[k]) <= LU + 1e-9, k
    _same_json(ag, ac)
