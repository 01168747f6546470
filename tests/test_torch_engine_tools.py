"""The port's serving engine against the JAX package's on the CPU: the
other entry points (``master_v1_bytes``, ``reference_match_bytes``,
``upscale_bytes``, ``models.vocal.isolate_vocal_bytes``), and the port's
own engine behaviour (micro-batching, stage progress, warmup, the graph
LRU).

Bars: float32 WAV output within -90 dBFS of JAX's, the v1 loudness
before and after within 0.01 LU; the dithered 16-bit WAV of the upscale
tool within 2.5/32768 (the dither draws differ); the micro-batched engine
equal to the unbatched one within the same bars (a batch of 4 rounds a
few of PyTorch's CPU reductions in another order: ~3e-7 apart).
"""

import threading

import numpy as np
import pytest
import torch

from amw_tpu.models import vocal as jvocal
from amw_tpu.runtime.engine import MasteringEngine as JaxEngine
from amw_tpu.utils import wav as jwav
from amw_tpu_torch.models import vocal as tvocal
from amw_tpu_torch.runtime import config as tconfig
from amw_tpu_torch.runtime.engine import MasteringEngine
from amw_tpu_torch.utils import wav as twav

SR = 22050
BAR_DBFS = -90.0
METER_LU = 0.01
WAV16_BAR = 2.5 / 32768


def track(dur, seed=0, sr=SR, f0=220.0):
    g = np.random.default_rng(seed)
    n = int(sr * dur)
    t = np.arange(n) / sr
    x = (0.3 * np.sin(2 * np.pi * f0 * t)
         + 0.1 * np.sin(2 * np.pi * 3100 * t)
         + 0.05 * g.standard_normal(n)).astype(np.float32)
    return np.clip(np.stack([x, 0.7 * x + 0.02 * g.standard_normal(n)]),
                   -1, 1).astype(np.float32)


def upload(x, sr=SR):
    return twav.write_wav_float32(x, sr)


def _db(a, b):
    return 20 * np.log10(max(float(np.max(np.abs(a - b))), 1e-30))


@pytest.fixture(scope="module")
def engines():
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("AMW_HTDEMUCS_CKPT", raising=False)
        port = MasteringEngine(micro_batch=False, device="cpu")
        yield JaxEngine(micro_batch=False), port
        port.close()


@pytest.mark.parametrize("style", ["standard", "edm"])
def test_v1_wav32f_matches_jax(engines, style):
    jax_eng, port = engines
    data = upload(track(2.5, seed=1))
    kw = dict(target_lufs=-14.0, out_format="wav32f", style=style)
    want = jax_eng.master_v1_bytes(data, "t.wav", **kw)
    got = port.master_v1_bytes(data, "t.wav", **kw)
    a, _ = twav.read_wav(got["bytes"])
    b, _ = jwav.read_wav(want["bytes"])
    assert a.shape == b.shape
    assert _db(a, b) <= BAR_DBFS
    for k in ("before_lufs", "after_lufs"):
        assert abs(got[k] - want[k]) <= METER_LU, k


@pytest.mark.parametrize("ref_sr", [SR, 44100])
def test_reference_match_matches_jax(engines, ref_sr):
    """The source against a reference at its own rate and at 44.1 kHz
    (resampled to the source's rate on the host first)."""
    jax_eng, port = engines
    src = upload(track(2.5, seed=2))
    ref = upload(track(3.0, seed=3, sr=ref_sr, f0=900.0), ref_sr)
    kw = dict(strength=0.8, out_format="wav32f")
    want = jax_eng.reference_match_bytes(src, "s.wav", ref, "r.wav", **kw)
    got = port.reference_match_bytes(src, "s.wav", ref, "r.wav", **kw)
    a, sr = twav.read_wav(got["bytes"])
    b, _ = jwav.read_wav(want["bytes"])
    assert sr == got["sr"] == want["sr"] == SR and a.shape == b.shape
    assert _db(a, b) <= BAR_DBFS


def test_upscale_matches_jax(engines):
    jax_eng, port = engines
    data = upload(track(2.5, seed=4))
    want = jax_eng.upscale_bytes(data, "t.wav", target_sr=48000)
    got = port.upscale_bytes(data, "t.wav", target_sr=48000)
    a, sr = twav.read_wav(got["bytes"])
    b, _ = jwav.read_wav(want["bytes"])
    assert sr == got["sr"] == 48000 and a.shape == b.shape
    assert a.shape[-1] == round(2.5 * SR * 48000 / SR)
    assert float(np.max(np.abs(a - b))) <= WAV16_BAR
    with pytest.raises(ValueError, match="must exceed"):
        port.upscale_bytes(data, "t.wav", target_sr=SR)


@pytest.mark.parametrize("channels", [1, 2])
def test_isolate_vocal_bytes_matches_jax(channels, monkeypatch):
    monkeypatch.delenv("AMW_HTDEMUCS_CKPT", raising=False)
    data = upload(track(2.5, seed=5)[:channels])
    a, sr = twav.read_wav(tvocal.isolate_vocal_bytes(data, "t.wav",
                                                     device="cpu"))
    b, _ = jwav.read_wav(jvocal.isolate_vocal_bytes(data, "t.wav"))
    assert sr == SR and a.shape == b.shape == (channels, int(2.5 * SR))
    assert _db(a, b) <= BAR_DBFS


def test_micro_batched_engine_equals_unbatched(engines, monkeypatch):
    """Three concurrent requests padded to different valid lengths in one
    bucket (15 s) run as one batch of 3, compiled 4 (item 0 repeated);
    request i gets track i back, equal to the unbatched engine's."""
    _, plain = engines
    monkeypatch.setattr(tconfig.settings, "engine_batch_window_ms", 400.0)
    batched = MasteringEngine(micro_batch=True, device="cpu")
    durs = (3.5, 4.0, 5.25)
    blobs = [upload(track(d, seed=10 + i)) for i, d in enumerate(durs)]
    kw = dict(target_lufs=-14.0, out_format="wav32f")
    try:
        got = [None] * 3
        barrier = threading.Barrier(3)

        def work(i):
            barrier.wait()
            got[i] = batched.master_v2_bytes(blobs[i], "t.wav", **kw)

        threads = [threading.Thread(target=work, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
            assert not th.is_alive(), "batched request timed out"
        assert batched.last_batch_info == {"batch": 3, "batch_compiled": 4,
                                           "devices": 1}
    finally:
        batched.close()
    for i, d in enumerate(durs):
        want = plain.master_v2_bytes(blobs[i], "t.wav", **kw)
        a, _ = twav.read_wav(got[i]["bytes"])
        b, _ = twav.read_wav(want["bytes"])
        assert a.shape == (2, int(d * SR))
        assert _db(a, b) <= BAR_DBFS, i
        for k in ("before_lufs", "after_lufs"):
            assert abs(got[i][k] - want[k]) <= METER_LU, (i, k)


@pytest.mark.parametrize("job", ["v2", "v1"])
def test_engine_emits_stage_progress(engines, job):
    """Stage ticks (on the CPU emitted as the host passes each stage): at
    least 8 distinct real stage labels, percentages monotonic, as the JAX
    package's tests/test_progress.py asks of its engine."""
    _, port = engines
    data = upload(track(2.0, seed=6))
    events = []
    report = lambda pct, msg: events.append((pct, msg))  # noqa: E731
    if job == "v2":
        res = port.master_v2_bytes(
            data, "t.wav", target_lufs=-14.0,
            pro={"deesser_enabled": True, "parallel_mix": 0.2},
            progress=report)
    else:
        res = port.master_v1_bytes(data, "t.wav", target_lufs=-14.0,
                                   style="edm", progress=report)
    assert res["bytes"][:4] == b"RIFF"
    labels = {m for _, m in events if m.startswith("Mastering: ")}
    assert len(labels) >= 8, labels
    pcts = [p for p, _ in events]
    assert pcts == sorted(pcts)
    assert any("chain:" in m or "deesser" in m or "dynamics" in m
               for m in labels)


@pytest.mark.parametrize("job", ["v2", "v1"])
def test_jobs_with_and_without_progress_share_one_graph(job):
    """A graph ticks only when a job hands it a token, so a request with a
    progress callback reuses the graph of one without (the JAX engine
    compiles a second graph for it) and gets the same output."""
    eng = MasteringEngine(micro_batch=False, device="cpu")
    data = upload(track(2.0, seed=7))
    run = eng.master_v2_bytes if job == "v2" else eng.master_v1_bytes
    kw = dict(target_lufs=-14.0, out_format="wav32f",
              **({"pro": {"deesser_enabled": True, "parallel_mix": 0.2}}
                 if job == "v2" else {"style": "edm"}))
    events = []
    plain = run(data, "t.wav", **kw)
    ticked = run(data, "t.wav", **kw,
                 progress=lambda pct, msg: events.append(msg))
    assert [k[0] for k in eng._cache] == [job]
    assert len({m for m in events if m.startswith("Mastering: ")}) >= 8
    assert ticked["bytes"] == plain["bytes"]
    eng.close()


@pytest.mark.parametrize("micro_batch", [True, False],
                         ids=["batched", "plain"])
def test_warmup_builds_and_runs_default_graph(micro_batch):
    eng = MasteringEngine(micro_batch=micro_batch, device="cpu")
    try:
        eng.warmup(buckets_sec=(1.0,), sr=SR)
        ((kind, spec, _),) = eng._cache
        assert (kind, spec.sr, spec.n, spec.channels) == ("v2", SR, SR, 2)
        if micro_batch:
            assert eng.last_batch_info == {"batch": 1, "batch_compiled": 1,
                                           "devices": 1}
    finally:
        eng.close()


def test_engine_graph_cache_lru():
    """The graph cache evicts least-recently-used entries past the cap, and
    an evicted graph's params are freed."""
    eng = MasteringEngine(bucket=False, micro_batch=False, device="cpu")
    eng._cache_cap = 3
    for i in range(6):
        eng._get_graph("t", ("spec", i), "k", lambda i=i: ("built", i))
    assert len(eng._cache) == 3
    assert [k[1][1] for k in eng._cache] == [3, 4, 5]
    # a hit refreshes recency
    eng._get_graph("t", ("spec", 3), "k", lambda: ("rebuilt", 3))
    eng._get_graph("t", ("spec", 6), "k", lambda: ("built", 6))
    assert ("t", ("spec", 3), "k") in eng._cache
    assert ("t", ("spec", 4), "k") not in eng._cache

    import weakref

    params = torch.zeros(4)
    ref = weakref.ref(params)
    eng._get_graph("t", ("spec", 7), "k", lambda: (params, None))
    del params
    for i in range(8, 11):
        eng._get_graph("t", ("spec", i), "k", lambda i=i: ("built", i))
    assert ref() is None


def test_profile_dir_writes_a_trace(engines, tmp_path, monkeypatch):
    """With ``AMW_PROFILE_DIR`` set, each job writes a torch.profiler
    Chrome trace under ``<dir>/<job>/`` (where the JAX engine writes an
    xprof trace)."""
    _, port = engines
    monkeypatch.setenv("AMW_PROFILE_DIR", str(tmp_path))
    port.master_v2_bytes(upload(track(2.0, seed=7)), "t.wav",
                         target_lufs=-14.0)
    traces = list((tmp_path / "master_v2").glob("*.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0
