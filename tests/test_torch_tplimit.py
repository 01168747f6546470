"""The port's true-peak limiter (``amw_tpu_torch/ops/tplimit.py``) against
the JAX package's on the CPU, and its guarantee.

The adversarial signals of tests/test_tplimit.py (an inter-sample-peak
sine, impulsive bursts, a peak in the first lookahead window, loud noise)
and a mastering-test track, each through both packages.  Bars: the repo's
parity bars (BASELINE.md), max sample error <= -90 dBFS and integrated
loudness within 0.1 LU; the guarantee, measured with scipy's
``resample_poly``: output true peak <= ceiling + 0.05 dB; bit-exact
passthrough under the ceiling; a batch ``[B, C, N]`` never couples its
tracks; a bucket-padded batch equals the exact-length result.
"""

import jax
import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

from amw_tpu import refimpl
from amw_tpu.ops import tplimit as jtp
from amw_tpu.ops import validctx as jvc
from amw_tpu.spec import GraphSpec as JSpec
from amw_tpu_torch import GraphSpec
from amw_tpu_torch.ops import tplimit as ttp
from amw_tpu_torch.ops import validctx as tvc

SR = 44100
N = 2 * SR
CEIL = -1.5
BAR_DBFS = -90.0
BAR_LU = 0.1
TP_SLACK_DB = 0.05


def tp_db(sig):
    return 20 * np.log10(np.abs(resample_poly(sig, 4, 1, axis=-1)).max())


def db(err):
    return 20 * np.log10(max(err, 1e-30))


def _sine(n=N, amp=0.95):
    t = np.arange(n)
    s = (amp * np.sin(2 * np.pi * 0.25 * t + np.pi / 4)).astype(np.float32)
    return np.stack([s, s])


def _bursts(n=N):
    g = np.random.default_rng(0)
    z = np.zeros(n, np.float32)
    idx = g.integers(100, n - 100, 50)
    z[idx], z[idx + 1] = 0.99, -0.99
    return np.stack([z, z])


def _first_window(n=N):
    w = np.zeros(n, np.float32)
    w[5:9] = [0.9, -0.9, 0.9, -0.9]
    return np.stack([w, w])


def _noise(n=N):
    g = np.random.default_rng(1)
    return np.clip(0.8 * g.standard_normal((2, n)), -1, 1).astype(np.float32)


def _track(n=N, seed=3):
    """The mastering test material (bench.make_track): peaks near 0.99."""
    g = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = (0.28 * np.sin(2 * np.pi * 110 * t)
         + 0.12 * np.sin(2 * np.pi * 997 * t)
         + 0.06 * np.sin(2 * np.pi * 6100 * t)
         + 0.05 * g.standard_normal(n))
    env = 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 0.25 * t))
    x = x * env / np.max(np.abs(x * env)) * 0.99
    return np.clip(np.stack([x, 0.85 * x]), -0.99, 0.99).astype(np.float32)


SIGNALS = {"intersample_sine": _sine, "bursts": _bursts,
           "first_window": _first_window, "loud_noise": _noise,
           "track": _track}


def _port(n=N, ceiling=CEIL):
    return ttp.build_true_peak_limiter(GraphSpec(sr=SR, n=n, channels=2),
                                       ceiling, device="cpu")[1]


def _jax(n=N, ceiling=CEIL):
    return jtp.build_true_peak_limiter(JSpec(sr=SR, n=n, channels=2),
                                       ceiling)[1]


def _lu_delta(a, b):
    la = refimpl.integrated_lufs(a, SR)
    lb = refimpl.integrated_lufs(b, SR)
    if not (np.isfinite(la) and np.isfinite(lb)):
        return 0.0 if la == lb else np.inf
    return abs(la - lb)


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_matches_jax(name):
    x = SIGNALS[name]()
    assert tp_db(x) > CEIL  # over the ceiling going in
    want = np.asarray(jax.jit(lambda v: _jax()(v, []))(x))
    got = _port()(torch.from_numpy(x), []).numpy()
    assert db(float(np.max(np.abs(got - want)))) <= BAR_DBFS
    assert _lu_delta(got, want) <= BAR_LU


@pytest.mark.parametrize("name", sorted(SIGNALS))
def test_true_peak_under_ceiling(name):
    got = _port()(torch.from_numpy(SIGNALS[name]()), []).numpy()
    assert tp_db(got) <= CEIL + TP_SLACK_DB


def test_passthrough_bit_exact_under_ceiling():
    t = np.arange(N)
    q = (0.3 * np.sin(2 * np.pi * 440 * t / SR)).astype(np.float32)
    q = np.stack([q, 0.8 * q])
    assert np.array_equal(_port()(torch.from_numpy(q), []).numpy(), q)


def test_batch_never_couples_tracks():
    """One loud and one quiet track in a [B, C, N] batch: each equals its
    own run.  The envelope is the maximum over the channels only (the JAX
    function reduces over every leading axis of one vmapped track)."""
    t = np.arange(N)
    quiet = (0.3 * np.sin(2 * np.pi * 440 * t / SR)).astype(np.float32)
    xb = np.stack([_sine(), np.stack([quiet, 0.8 * quiet])])
    fn = _port()
    got = fn(torch.from_numpy(xb), []).numpy()
    for b in range(2):
        alone = fn(torch.from_numpy(xb[b]), []).numpy()
        assert db(float(np.max(np.abs(got[b] - alone)))) <= BAR_DBFS
    assert np.array_equal(got[1], xb[1])  # the quiet track passes through


def test_padded_batch_matches_exact_length():
    """A track ending while limiting is active, padded into a longer
    bucket beside a full-length track: with ``n_valid`` installed the
    padded graph reproduces the exact-length tail gains (padding gains of
    1 must not dilute the edge smoothing), keeps the ceiling, matches the
    JAX package's padded graph under ``vmap``, and leaves the tail zero."""
    nv = N - 1771
    xb = np.stack([_track(N, 4), _sine(N)])
    xb[1, :, nv:] = 0.0
    nvs = np.array([N, nv], np.int32)
    with tvc.valid_length(torch.from_numpy(nvs)):
        got = _port()(torch.from_numpy(xb), []).numpy()

    def one(x, nvi):
        with jvc.valid_length(nvi):
            return _jax()(x, [])

    want = np.asarray(jax.jit(jax.vmap(one))(xb, nvs))
    exact = _port(nv)(torch.from_numpy(np.ascontiguousarray(
        xb[1, :, :nv])), []).numpy()
    assert db(float(np.max(np.abs(got[1, :, :nv] - exact)))) <= BAR_DBFS
    assert np.all(got[1, :, nv:] == 0.0)
    for b, n_b in enumerate(nvs):
        assert db(float(np.max(np.abs(got[b] - want[b])))) <= BAR_DBFS
        assert tp_db(got[b, :, :n_b]) <= CEIL + TP_SLACK_DB


def test_chain_module_and_pro_flag():
    """Wired as a chain module (``true_peak_limiter``, its own ceiling) and
    as the v2 job's ``true_peak_enabled`` stage, as in the JAX package."""
    from amw_tpu.models import chain as jchain
    from amw_tpu_torch.models import chain as tchain

    sr, n = 22050, 22050 * 2
    x = _sine(n, 0.9)
    spec = GraphSpec(sr=sr, n=n, channels=2)
    config = {"modules": [
        {"id": "dc_offset", "enabled": True, "amount": 1.0},
        {"id": "true_peak_limiter", "enabled": True, "ceiling_db": -2.0,
         "amount": 1.0}]}
    cc = tchain.compile_chain(spec, config, device="cpu")
    jc = jchain.compile_chain(JSpec(sr=sr, n=n, channels=2), config)
    assert cc.module_ids == jc.module_ids == ["dc_offset",
                                              "true_peak_limiter"]
    y = cc(x)
    assert tp_db(y) <= -2.0 + TP_SLACK_DB
    assert db(float(np.max(np.abs(y - np.asarray(jc(x)))))) <= BAR_DBFS
