"""The last public functions of ``amw_tpu`` that the port took on, each
against its JAX counterpart on the CPU.

The same numpy inputs (from a seed) go through ``amw_tpu`` (its XLA path
on the CPU) and through ``amw_tpu_torch`` with ``device="cpu"``.  Bars:
atol 1e-5 for the high-frequency trim (f32 FFTs of different libraries;
the port fed the JAX params through ``params_from_jax``), the lookahead
maximizer and the |x| envelope (both packages equal to the exact
recurrence to eps = 1e-8); exact equality for the trailing-silence index,
the PCM encoders (value for value, byte for byte) and the runner's rows
against the port's single-track chain; 1e-3 for the runner's rows against
the JAX package's numpy oracle (``chain_process``), as
tests/test_batcher.py holds the JAX runner.
"""

import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amw_tpu import constants as jconst
from amw_tpu import native as jnative
from amw_tpu.models.chain import default_chain_config as jdefault_config
from amw_tpu.ops import basic as jbasic
from amw_tpu.ops import eq as jeq
from amw_tpu.ops import scan as jscan
from amw_tpu.refimpl import quantize16
from amw_tpu.refimpl.chain import chain_process
from amw_tpu.runtime import config as jconfig
from amw_tpu.spec import GraphSpec as JSpec
from amw_tpu_torch import GraphSpec
from amw_tpu_torch import constants as tconst
from amw_tpu_torch import native as tnative
from amw_tpu_torch.convert import params_from_jax
from amw_tpu_torch.models.chain import compile_chain, default_chain_config
from amw_tpu_torch.ops import basic as tbasic
from amw_tpu_torch.ops import eq as teq
from amw_tpu_torch.ops import scan as tscan
from amw_tpu_torch.runtime import config as tconfig
from amw_tpu_torch.runtime.batcher import BatchedChainRunner

SR = 44100
ATOL = 1e-5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread keeps them from spinning against
    the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _music(shape, seed, scale=0.4):
    """Seeded test material ``[..., n]``: a low partial, a 6.1 kHz partial
    (above the trim's crossover) and noise."""
    g = np.random.default_rng(seed)
    t = np.arange(shape[-1]) / SR
    x = (0.6 * np.sin(2 * np.pi * 110 * t) + 0.3 * np.sin(2 * np.pi * 6100 * t)
         + 0.3 * g.standard_normal(shape))
    return (scale * x).astype(np.float32)


def test_constants_match_jax():
    for name in ("HIGH_FREQ_TRIM_CROSSOVER_HZ", "HIGH_FREQ_TRIM_GAIN",
                 "DEFAULT_CHAIN_CROSSOVERS_HZ"):
        assert getattr(tconst, name) == getattr(jconst, name), name
    crossovers = [m for m in default_chain_config()["modules"]
                  if m["id"] == "dynamics"][0]["crossovers_hz"]
    assert tuple(crossovers) == tconst.DEFAULT_CHAIN_CROSSOVERS_HZ


def _flat(p):
    if isinstance(p, (list, tuple)):
        for q in p:
            yield from _flat(q)
    else:
        yield np.asarray(p)


def test_high_freq_trim_matches_jax():
    """1 s stereo at 44.1 kHz (exact mode: a fast pass with exact edges),
    one track and a batch of two, the port fed the JAX params."""
    x = _music((2, 2, SR), seed=1, scale=1.0).clip(-1.2, 1.2)
    jp, jf = jeq.build_high_freq_trim(JSpec(sr=SR, n=SR))
    tp, tf = teq.build_high_freq_trim(GraphSpec(sr=SR, n=SR), device="cpu")
    a, b = list(_flat(tp)), list(_flat(jp))
    assert len(a) == len(b)
    for u, v in zip(a, b):
        np.testing.assert_allclose(u, v, rtol=1e-6, atol=1e-7)
    jpd, tpd = jax.device_put(jp), params_from_jax(jp, device="cpu")
    want = np.asarray(jax.jit(jax.vmap(lambda v: jf(v, jpd)))(jnp.asarray(x)))
    got = tf(torch.from_numpy(x), tpd).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(tf(torch.from_numpy(x[0]), tpd).numpy(),
                               want[0], atol=ATOL)
    assert float(np.abs(got).max()) <= 1.0


def test_high_freq_trim_identity_and_device():
    spec = GraphSpec(sr=SR, n=SR)
    tp, tf = teq.build_high_freq_trim(spec, high_gain=1.0005, device="cpu")
    jp, _ = jeq.build_high_freq_trim(JSpec(sr=SR, n=SR), high_gain=1.0005)
    x = torch.from_numpy(_music((2, SR), seed=2))
    assert tp == jp == [] and tf(x, tp) is x


def test_high_freq_trim_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        teq.build_high_freq_trim(GraphSpec(sr=SR, n=SR))


@pytest.mark.parametrize("n,lookahead_ms", [
    (SR, 6.0),   # the 6 ms delay and 2 ms crossfade
    (200, 6.0),  # shorter than the delay: the plain maximizer
    (SR, 0.0),   # no delay: the plain maximizer
    (SR, 1.0),   # a delay shorter than the 2 ms crossfade
])
def test_maximizer_lookahead_matches_jax(n, lookahead_ms):
    x = _music((3, 2, n), seed=3, scale=1.4)
    want = np.asarray(jbasic.maximizer_lookahead(jnp.asarray(x), SR,
                                                 lookahead_ms))
    got = tbasic.maximizer_lookahead(torch.from_numpy(x), SR,
                                     lookahead_ms).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("n,ballistics,short", [
    (30000, (0.005, 0.1), True),       # the per-row route in both packages
    (120000, (0.0005, 0.005), False),  # chunked in both
])
def test_envelope_follower_xsr_matches_jax(n, ballistics, short):
    x = _music((2, 2, n), seed=4)
    att, rel = tscan.ar_coefs(SR, *ballistics)
    assert tscan.short_route(n, tscan.warmup_len(att, rel)) == short
    want = np.asarray(jscan.envelope_follower_xsr(jnp.asarray(x), SR,
                                                  *ballistics))
    got = tscan.envelope_follower_xsr(torch.from_numpy(x), SR,
                                      *ballistics).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


@pytest.mark.parametrize("knob", ["min_chunk", "unroll"])
def test_envelope_follower_xsr_has_no_xla_knobs(knob):
    x = torch.from_numpy(_music((2, 1000), seed=5))
    with pytest.raises(TypeError, match=knob):
        tscan.envelope_follower_xsr(x, SR, 0.005, 0.1, **{knob: 4})


def _blank_cases():
    """(name, signal [C, n]) at 44.1 kHz, 2 s."""
    n = 2 * SR
    loud = _music((2, n), seed=6)
    tail = loud.copy()
    tail[:, SR // 2:] *= 1e-4  # -60 dBFS is 1e-3: silent after 0.5 s
    short_tail = loud.copy()
    short_tail[:, n - 1000:] = 0.0  # silence shorter than 0.5 s
    one_channel = tail.copy()
    one_channel[1, SR] = 0.01  # the other channel's last loud sample
    return {"silent_tail": tail, "no_tail": loud, "short_tail": short_tail,
            "all_silence": np.zeros((2, n), np.float32),
            "one_channel": one_channel}


@pytest.mark.parametrize("mono", [False, True], ids=["CN", "N"])
@pytest.mark.parametrize("case", sorted(_blank_cases()))
def test_auto_blank_end_index_matches_jax(case, mono):
    x = _blank_cases()[case]
    if mono:
        x = x[1]
    for kw in ({}, {"threshold_dbfs": -40.0, "min_silence_sec": 0.1}):
        want = int(jbasic.auto_blank_end_index(jnp.asarray(x), SR, **kw))
        got = tbasic.auto_blank_end_index(torch.from_numpy(x), SR, **kw)
        assert got.ndim == 0 and not got.is_floating_point()
        assert got.device == torch.device("cpu")
        assert int(got) == want, (case, kw)
    if case == "silent_tail":
        assert want < x.shape[-1]


def _pcm_input(seed):
    g = np.random.default_rng(seed)
    x = (0.8 * g.standard_normal((2, 5000))).astype(np.float32)
    x[0, :4] = [1.5, -1.5, np.nan, np.inf]  # clipped and scrubbed samples
    return x


def test_pcm16_encode_dithered_matches_jax():
    assert tnative.available(), "g++ could not build native/pcm.cpp"
    g = np.random.default_rng(7)
    x = _pcm_input(7)
    noise = g.random(x.shape, dtype=np.float32) - 0.5
    got = tnative.pcm16_encode_dithered(x, noise)
    assert got.dtype == np.int16 and got.shape == x.shape
    assert np.array_equal(got, jnative.pcm16_encode_dithered(x, noise))
    assert np.array_equal(got, quantize16(x, noise.astype(np.float64)))


def test_pcm24_encode_matches_jax():
    assert tnative.available(), "g++ could not build native/pcm.cpp"
    x = _pcm_input(8)
    x[0, 2] = 0.25  # a NaN has no defined 24-bit value in either package
    got = tnative.pcm24_encode(x)
    assert isinstance(got, bytes) and len(got) == 3 * x.size
    assert got == jnative.pcm24_encode(x)
    back = tnative.pcm24_decode(got, 2)
    assert np.max(np.abs(back - np.clip(x, -1, 1))) < 1.5 / (1 << 23)


def test_reload_settings_reads_the_environment(monkeypatch):
    # keep both modules' settings objects for the tests after this one
    monkeypatch.setattr(tconfig, "settings", tconfig.settings)
    monkeypatch.setattr(jconfig, "settings", jconfig.settings)
    before = tconfig.settings
    monkeypatch.setenv("AMW_ENGINE_MAX_MICRO_BATCH", "3")
    monkeypatch.setenv("MAGIC_MASTER_ENGINE_BATCH_WINDOW_MS", "12.5")
    got, want = tconfig.reload_settings(), jconfig.reload_settings()
    assert got is tconfig.settings and got is not before
    assert got.engine_max_micro_batch == want.engine_max_micro_batch == 3
    assert got.engine_batch_window_ms == want.engine_batch_window_ms == 12.5


# ---- BatchedChainRunner (tests/test_batcher.py's runner test) ---------------

CHAIN_SR = 8000


def _chain_tracks():
    g = np.random.default_rng(5)
    n = 2 * CHAIN_SR
    t = np.arange(n) / CHAIN_SR
    base = 0.3 * np.sin(2 * np.pi * 150 * t)
    tracks = []
    for _ in range(3):
        x = (base + 0.02 * g.standard_normal(n)).astype(np.float32)
        tracks.append(np.clip(np.stack([x, 0.8 * x]), -1, 1))
    return GraphSpec(sr=CHAIN_SR, n=n, channels=2), tracks


def _run_threads(runner, spec, cfg_json, tracks):
    """Each track mastered on its own thread; every thread must join."""
    results = [None] * len(tracks)

    def work(i):
        results[i] = runner.master(spec, cfg_json, tracks[i])

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(tracks))]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive(), "batched master thread timed out"
    return results


def _spy_batches(runner) -> list:
    """The sizes of the batches the runner's batcher forms."""
    sizes, run = [], runner.batcher._run_batch

    def spy(key, xb, *aux):
        sizes.append(xb.shape[0])
        return run(key, xb, *aux)

    runner.batcher._run_batch = spy
    return sizes


def test_batched_chain_runner_matches_chain_and_oracle():
    spec, tracks = _chain_tracks()
    config = default_chain_config(-14.0, "standard")
    assert config == jdefault_config(-14.0, "standard")
    cfg_json = json.dumps(config, sort_keys=True, default=str)
    runner = BatchedChainRunner(window_ms=60.0, max_batch=4, device="cpu")
    try:
        sizes = _spy_batches(runner)
        results = _run_threads(runner, spec, cfg_json, tracks)
    finally:
        runner.close()
    assert sum(sizes) == 3 and max(sizes) <= 4
    single = compile_chain(spec, config, device="cpu")
    for i, x in enumerate(tracks):
        assert results[i].shape == x.shape and results[i].dtype == np.float32
        assert np.array_equal(results[i], single(x)), i
        err = np.max(np.abs(results[i].astype(np.float64)
                            - chain_process(x, CHAIN_SR, config)))
        assert err < 1e-3, (i, err)


def test_batched_chain_runner_coalesces_one_batch():
    """Three tracks under a cap of three and a long window run as one
    batch of three, at that size (no padding), each row the single-track
    chain's output."""
    spec, tracks = _chain_tracks()
    config = default_chain_config(-10.0, "edm")
    cfg_json = json.dumps(config, sort_keys=True, default=str)
    runner = BatchedChainRunner(window_ms=30_000.0, max_batch=3,
                                device="cpu")
    try:
        sizes = _spy_batches(runner)
        results = _run_threads(runner, spec, cfg_json, tracks)
    finally:
        runner.close()
    assert sizes == [3]
    single = compile_chain(spec, config, device="cpu")
    for i, x in enumerate(tracks):
        assert np.array_equal(results[i], single(x)), i


def test_batched_chain_runner_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedChainRunner()
