"""The port's analysis suite (``amw_tpu_torch.models.analyze`` and the
meters it runs) against the JAX package's on the CPU.

Bars: 0.01 LU / dB on the meters (loudness, timeline, LRA, true peak,
spectrum bars), 1e-4 on the correlation, equality for the vectorscope
points and the response dicts' keys and ``None`` pattern, 1e-5 on the
K-weighted signal.  The graphs run on the XLA / ``torch.fft`` route (the
5 s bucket); the staged route (15 s bucket, both packages forced onto it,
the Pallas kernels in interpret mode), fused and split, is held in
tests/test_torch_analyze_staged.py.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amw_tpu.models import analyze as janalyze
from amw_tpu.ops import design as jdesign
from amw_tpu.ops import meters as jm
from amw_tpu_torch.convert import params_from_jax
from amw_tpu_torch.ops import meters as tm

tanalyze = importlib.import_module("amw_tpu_torch.models.analyze")

SR = 44100
LU = 0.01


def sig(n, seed=0, channels=2):
    """A tone under a fast envelope plus noise (loudness moves along the
    timeline), right channel scaled."""
    g = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.03 * g.standard_normal(n)
    env = 0.4 + 0.6 * np.abs(np.sin(2 * np.pi * 0.9 * t))
    x = np.clip(np.stack([x * env, 0.82 * x * env + 0.01 * g.standard_normal(
        n)]), -1, 1).astype(np.float32)
    return x[:channels]


def _t(a):
    return torch.from_numpy(np.array(a))


def _kweight(n):
    nfft = jdesign.next_fft_size(n + jm.k_weight_settle(SR))
    return nfft, jm.k_weight_response(SR, nfft)


def test_k_weight_filter_matches_jax():
    x = sig(3 * SR, 1)
    nfft, Hk = _kweight(x.shape[-1])
    want = jm.k_weight_filter(jnp.asarray(x), jnp.asarray(Hk), nfft)
    got = tm.k_weight_filter(_t(x), _t(Hk), nfft)
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < 1e-5


@pytest.mark.parametrize("n", [int(0.3 * SR), int(3.31 * SR), 5 * SR])
def test_timeline_and_segment_starts_match_jax(n):
    x = sig(n, 2)
    nfft, Hk = _kweight(n)
    for block, pts in ((0.4, 300), (3.0, 200)):
        np.testing.assert_array_equal(tm.segment_starts(n, SR, block, pts),
                                      jm.segment_starts(n, SR, block, pts))
        want = np.asarray(jm.timeline_lufs(jnp.asarray(x), jnp.asarray(Hk),
                                           nfft, SR, block, pts))
        got = tm.timeline_lufs(_t(x), _t(Hk), nfft, SR, block, pts).numpy()
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) <= LU


@pytest.mark.parametrize("n_valid", [int(0.2 * SR), int(3.31 * SR), 498330,
                                     220499, 5 * SR])
def test_masked_timeline_and_lra_match_jax(n_valid):
    """Segment stepping from the valid length (float32, as XLA compiles
    the jitted JAX graph), the validity mask, and the LRA over it."""
    n_pad = janalyze._bucket_for(SR, n_valid)
    x = np.pad(sig(n_valid, 3), ((0, 0), (0, n_pad - n_valid)))
    nfft, Hk = _kweight(n_pad)
    yk = jm.k_weight_filter(jnp.asarray(x), jnp.asarray(Hk), nfft)
    for block, pts in ((0.4, 300), (3.0, 200)):
        wl, wv = jax.jit(lambda x, nv, yk: jm.timeline_lufs_masked(
            x, None, nfft, SR, nv, block, pts, yk=yk))(
                jnp.asarray(x), jnp.int32(n_valid), yk)
        gl, gv = tm.timeline_lufs_masked(_t(x), None, nfft, SR, n_valid,
                                         block, pts, yk=_t(yk))
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        assert np.max(np.abs(gl.numpy() - np.asarray(wl))) <= LU
        want = float(jm.loudness_range_lu(jnp.where(wv, wl, -1e9)))
        got = float(tm.loudness_range_lu(torch.where(gv, gl, -1e9)))
        assert abs(got - want) <= LU


def test_lra_edge_cases_match_jax():
    g = np.random.default_rng(4)
    for tl in (np.full(20, -1e9, np.float32),
               np.array([-20.0] + [-1e9] * 9, np.float32),
               np.array([-20.0, -25.0] + [-80.0] * 8, np.float32),
               (-30 + 10 * g.standard_normal(200)).astype(np.float32)):
        want = float(jm.loudness_range_lu(jnp.asarray(tl)))
        got = float(tm.loudness_range_lu(_t(tl)))
        assert abs(got - want) <= LU


@pytest.mark.parametrize("channels", [1, 2])
def test_true_peak_matches_jax(channels):
    x = sig(int(1.3 * SR), 5, channels)
    x[0, 1000] = 0.97  # an inter-sample overshoot
    x[0, 1001] = -0.97
    want = np.asarray(jm.oversample4(jnp.asarray(x)))
    got = tm.oversample4(_t(x)).numpy()
    assert got.shape == want.shape == (channels, 4 * x.shape[-1])
    assert np.max(np.abs(got - want)) < 1e-5
    assert abs(float(tm.true_peak_dbfs(_t(x)))
               - float(jm.true_peak_dbfs(jnp.asarray(x)))) <= LU


def test_correlation_spectrum_vectorscope_match_jax():
    n = int(2.7 * SR)
    x = sig(n, 6)
    n_pad = 5 * SR
    xp = np.pad(x, ((0, 0), (0, n_pad - n)))
    assert abs(float(tm.stereo_correlation(_t(x)))
               - float(jm.stereo_correlation(jnp.asarray(x)))) <= 1e-4
    assert abs(float(tm.stereo_correlation(_t(xp), n))
               - float(jm.stereo_correlation(jnp.asarray(xp), n))) <= 1e-4
    for got, want in (
            (tm.spectrum_bars(_t(x), SR), jm.spectrum_bars(jnp.asarray(x), SR)),
            (tm.spectrum_bars_masked(_t(xp), SR, n),
             jm.spectrum_bars_masked(jnp.asarray(xp), SR, jnp.int32(n)))):
        assert got.shape == (64,)
        assert np.max(np.abs(got.numpy() - np.asarray(want))) <= LU
    np.testing.assert_array_equal(
        tm.vectorscope_points(_t(x)).numpy(),
        np.asarray(jm.vectorscope_points(jnp.asarray(x))))
    gp, gv = tm.vectorscope_points_masked(_t(xp), n)
    wp, wv = jm.vectorscope_points_masked(jnp.asarray(xp), jnp.int32(n))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))


def assert_same_dict(got, want, path=""):
    """Same keys, same ``None`` pattern, values within the meters' bar (the
    dicts hold values rounded to 0.01, so two roundings may differ by one
    step), booleans and strings equal."""
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_same_dict(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same_dict(g, w, f"{path}[{i}]")
    elif isinstance(want, float):
        assert abs(got - want) <= LU + 1e-9, (path, got, want)
    else:
        assert got == want, path


def graph_pair(x, n_valid, extended, true_peak):
    """Both analysis graphs' raw outputs on ``x`` [C, n_pad]; the port's
    graph also run on the JAX graph's ``Hk`` pair through
    ``params_from_jax``, with the same result."""
    C, n_pad = x.shape
    jfn, jHk = janalyze._analysis_graph(SR, n_pad, C, extended, true_peak)
    want = {k: np.asarray(v)
            for k, v in jfn(x, jHk, np.int32(n_valid)).items()}
    tfn, tHk = tanalyze._analysis_graph(SR, n_pad, C, extended, true_peak,
                                        device=torch.device("cpu"))
    got = {k: v.numpy() for k, v in tfn(_t(x), tHk, n_valid).items()}
    again = tfn(_t(x), params_from_jax(jHk, device="cpu"), n_valid)
    for k, v in again.items():
        np.testing.assert_array_equal(v.numpy(), got[k], err_msg=k)
    return got, want


def assert_graph_outputs(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if want[k].dtype == bool or k == "vectorscope":
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        else:
            tol = 1e-4 if k == "correlation" else LU
            assert np.max(np.abs(got[k] - want[k])) <= tol, k


@pytest.mark.parametrize("channels", [2, 1])
@pytest.mark.parametrize("seconds", [5.0, 3.31], ids=["exact", "padded"])
def test_analysis_graph_and_dicts_match_jax(channels, seconds):
    """The 5 s bucket (XLA / torch.fft route): the graph's outputs, then
    both response dicts."""
    n = int(seconds * SR)
    x = sig(n, 7, channels)
    n_pad = tanalyze._bucket_for(SR, n)
    assert n_pad == janalyze._bucket_for(SR, n) == 5 * SR
    xp = np.pad(x, ((0, 0), (0, n_pad - n)))
    got, want = graph_pair(xp, n, True, True)
    assert_graph_outputs(got, want)
    assert_same_dict(tanalyze.analyze(x, SR, extended=True, device="cpu"),
                     janalyze.analyze(x, SR, extended=True))
    assert_same_dict(tanalyze.analyze(x, SR, device="cpu"),
                     janalyze.analyze(x, SR))
    assert_same_dict(tanalyze.lufs_analyze_tool(x, SR, "flac", device="cpu"),
                     janalyze.lufs_analyze_tool(x, SR, "flac"))


def test_short_and_silent_tracks_match_jax():
    """Below the 400 ms gating block (no loudness: ``None``), and
    silence (gated: -70 LUFS in the tool, no platform preview)."""
    for x in (sig(int(0.3 * SR), 8), np.zeros((2, 2 * SR), np.float32)):
        assert_same_dict(tanalyze.analyze(x, SR, extended=True, device="cpu"),
                         janalyze.analyze(x, SR, extended=True))
        assert_same_dict(tanalyze.lufs_analyze_tool(x, SR, device="cpu"),
                         janalyze.lufs_analyze_tool(x, SR))


def test_buckets_and_default_device(monkeypatch):
    assert tanalyze.ANALYSIS_BUCKETS_SEC == janalyze.ANALYSIS_BUCKETS_SEC
    assert tanalyze.STREAMING_PLATFORMS == janalyze.STREAMING_PLATFORMS
    for n in (1, 5 * SR, 5 * SR + 1, 600 * SR, 600 * SR + 1):
        assert tanalyze._bucket_for(SR, n) == janalyze._bucket_for(SR, n)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    x = sig(SR, 9)
    from amw_tpu_torch.models import analyze, lufs_analyze_tool

    with pytest.raises(RuntimeError, match="CUDA"):
        analyze(x, SR)
    with pytest.raises(RuntimeError, match="CUDA"):
        lufs_analyze_tool(x, SR)
