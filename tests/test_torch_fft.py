"""The port's staged FFT (``amw_tpu_torch.ops.fft_staged``) against the JAX
package's Pallas FFT (``amw_tpu.ops.fft_pallas``, interpret mode) and numpy.

Bars (the JAX suite's own, tests/test_fft_pallas.py): relative 3e-6 of the
largest magnitude for a stage's output (forward spectra and the other
linear stages), absolute 2e-5 for round trips of unit-variance signals,
relative 1e-5 for the reduce with its band maps.  The plain versions run
f32 complex matmuls, the JAX interpret mode f32 dots at HIGHEST: both are
f32-accurate DFTs that differ in summation order only.

The CUDA kernels are held against their plain versions in
tests/test_torch_fft_cuda.py (GPU only).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amw_tpu.ops import basic as jbasic
from amw_tpu.ops import fft_pallas as jfp
from amw_tpu_torch.ops import fft_staged as tfs
from amw_tpu_torch.ops.bands import BandMap

SIZES = [1 << 19, 1 << 22]  # C2 = 1 (direct C stage) and C2 = 2
CPU = torch.device("cpu")
REL_STAGE = 3e-6
ABS_RT = 2e-5
REL_REDUCE = 1e-5
# one band per branch of compress_soft_knee: bypass (ratio 1), soft knee,
# upward boost (ratio < 1), hard knee (knee < 0.5 dB)
BANDS = [(-7.2, 1.0, 6.0, 12.0, -7.2, 1.5), (-18.5, 2.2, 6.0, 12.0, -18.5, 1.8),
         (-17.0, 0.6, 6.0, 12.0, -17.0, 1.65), (-15.0, 1.35, 0.2, 12.0, -15.0, 1.2)]


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-30))


def _planes(shape, seed, scale=1.0):
    g = np.random.default_rng(seed)
    return [(scale * g.standard_normal(shape)).astype(np.float32)
            for _ in range(2)]


def _resps(nfft, K, seed):
    g = np.random.default_rng(seed)
    H = [g.random(nfft // 2 + 1) + 0.25 for _ in range(K)]
    return H, np.stack([tfs.permute_full_response(h, nfft) for h in H])


def _jax_map(thr, ratio, knee, boost, lim, gain):
    return lambda y: jbasic.limiter(
        jbasic.compress_soft_knee(y, thr, ratio, knee, boost), lim) * gain


def _t(a):
    return torch.from_numpy(np.array(a))


def _tables(nfft):
    return tfs._device_tables(nfft, CPU)


def test_plan_ok_and_enabled():
    for nfft in [1 << k for k in range(16, 27)] + [3 << 20, 5 << 19]:
        assert tfs.plan_ok(nfft) == jfp.plan_ok(nfft), nfft
        assert not tfs.enabled(nfft, "cpu")
        assert tfs.enabled(nfft, torch.device("cuda")) == jfp.plan_ok(nfft)


@pytest.mark.parametrize("C", [32, 64, 128, 256, 512, 1024])
def test_host_tables_match_jax(C):
    nfft = 128 * 128 * C
    for inverse in (False, True):
        for a, b in zip(tfs._ctab(nfft, inverse)[:2],
                        jfp._ctab(nfft, inverse)[:2]):
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(tfs._ctab(nfft, inverse)[2],
                                      jfp._ctab(nfft, inverse)[2])
        for a, b in zip(tfs._tables(nfft, inverse), jfp._tables(nfft, inverse)):
            np.testing.assert_array_equal(a[0], b[0])
            np.testing.assert_array_equal(a[1], b[1])
    np.testing.assert_array_equal(tfs._perm(nfft), jfp._perm(nfft))
    for a, b in zip(tfs.plan_params(nfft), jfp.plan_params(nfft)):
        np.testing.assert_array_equal(a, np.asarray(b))
    H = np.random.default_rng(C).random(nfft // 2 + 1) * np.exp(0.3j)
    np.testing.assert_array_equal(tfs.permute_full_response(H, nfft),
                                  jfp.permute_full_response(H, nfft))
    # the 2^24 tables hold 256 MB; keep the worker's memory small
    for mod in (tfs, jfp):
        mod._tables.cache_clear()
        mod._perm.cache_clear()
    tfs.plan_params.cache_clear()
    jfp.plan_params.cache_clear()


@pytest.mark.parametrize("nfft", SIZES)
@pytest.mark.parametrize("mode", ["complex", "real_in", "real_out"])
def test_stage_a_matches_jax(nfft, mode):
    n = nfft - 3000 if mode != "real_out" else nfft
    xr, xi = _planes((2, n), 1)
    inverse = mode == "real_out"
    kw = {"real_in": mode == "real_in", "real_out": inverse}
    jx = (jnp.asarray(np.pad(xr, ((0, 0), (0, nfft - n)))),
          None if mode == "real_in" else
          jnp.asarray(np.pad(xi, ((0, 0), (0, nfft - n)))))
    want = jfp._stage_a(*jx, nfft, inverse, jfp.plan_params(nfft),
                        interpret=True, **kw)
    got = tfs._stage_a(_t(xr), None if mode == "real_in" else _t(xi), nfft,
                       inverse, _tables(nfft), **kw)
    assert _rel(got[0], want[0]) < REL_STAGE
    if inverse:
        assert got[1] is None
    else:
        assert _rel(got[1], want[1]) < REL_STAGE


@pytest.mark.parametrize("nfft", SIZES)
@pytest.mark.parametrize("K", [2, 4])
def test_bccb_multi_matches_jax(nfft, K):
    xr, xi = _planes((2, nfft), 2)
    _, resps = _resps(nfft, K, 3)
    wr, wi = jfp._stage_bccb_multi(jnp.asarray(xr), jnp.asarray(xi),
                                   jnp.asarray(resps), nfft,
                                   jfp.plan_params(nfft), interpret=True)
    gr, gi = tfs._stage_bccb_multi(_t(xr), _t(xi), _t(resps), nfft,
                                   _tables(nfft))
    assert gr.shape == (K * 2, nfft)
    assert _rel(gr, wr) < REL_STAGE
    assert _rel(gi, wi) < REL_STAGE


@pytest.mark.parametrize("nfft", SIZES)
def test_inv_join_matches_jax(nfft):
    K, R2 = 2, 2
    yr, yi = _planes((K * R2, nfft), 4)
    want = jfp._stage_a_inv_join(jnp.asarray(yr), jnp.asarray(yi), K, nfft,
                                 jfp.plan_params(nfft), interpret=True)
    got = tfs._stage_a_inv_join(_t(yr), _t(yi), K, nfft, _tables(nfft))
    assert got.shape == (K, 2 * R2, nfft)
    assert _rel(got, want) < REL_STAGE


@pytest.mark.parametrize("nfft", SIZES)
def test_reduce_packed_matches_jax(nfft):
    """The soft-knee band maps of the multiband dynamics on spectra of a
    signal at mastering levels, one band per compressor branch."""
    K, R2 = 4, 1
    x = 0.3 * np.random.default_rng(5).standard_normal((2, nfft - 4000))
    _, resps = _resps(nfft, K, 6)
    tabs = jfp.plan_params(nfft)
    xp = jnp.asarray(np.pad(x, ((0, 0), (0, 4000))).astype(np.float32))
    Xr, Xi = jfp._stage_a(xp[:1], xp[1:], nfft, False, tabs, interpret=True)
    Yr, Yi = jfp._stage_bccb_multi(Xr, Xi, jnp.asarray(resps), nfft, tabs,
                                   interpret=True)
    want = jfp._reduce_stage_a_packed(Yr, Yi, K, R2, nfft,
                                      [_jax_map(*b) for b in BANDS], tabs,
                                      interpret=True)
    got = tfs._reduce_stage_a_packed(_t(np.asarray(Yr)), _t(np.asarray(Yi)),
                                     K, R2, nfft, [BandMap(*b) for b in BANDS],
                                     _tables(nfft))
    assert got.shape == (2 * R2, nfft)
    assert _rel(got, want) < REL_REDUCE


@pytest.mark.parametrize("nfft", SIZES)
def test_bc_cb_matches_jax(nfft):
    xr, xi = _planes((2, nfft), 30)
    _, resps = _resps(nfft, 1, 31)
    wr, wi = jfp._stage_bc_cb(jnp.asarray(xr), jnp.asarray(xi), nfft,
                              jfp.plan_params(nfft), jnp.asarray(resps[0]),
                              interpret=True)
    gr, gi = tfs._stage_bc_cb(_t(xr), _t(xi), _t(resps[0]), nfft,
                              _tables(nfft))
    assert gr.shape == (2, nfft)
    assert _rel(gr, wr) < REL_STAGE
    assert _rel(gi, wi) < REL_STAGE


def test_reduce_unpacked_matches_jax():
    """The unpacked reduce (odd row counts) with one band map per
    compressor branch."""
    nfft, K, R = 1 << 19, 4, 1
    yr, yi = _planes((K * R, nfft), 32, 0.3)
    maps = [_jax_map(*b) for b in BANDS]
    want = jfp._reduce_stage_a(jnp.asarray(yr), jnp.asarray(yi), K, R, nfft,
                               maps, jfp.plan_params(nfft), interpret=True)
    got = tfs._reduce_stage_a(_t(yr), _t(yi), K, R, nfft,
                              [BandMap(*b) for b in BANDS], _tables(nfft))
    assert got.shape == (R, nfft)
    assert _rel(got, want) < REL_REDUCE


@pytest.mark.parametrize("rows", [1, 2, 3])
def test_apply_response_matches_jax(rows):
    """Packed (even rows) and unpacked (odd rows), default and cut
    output length."""
    nfft = 1 << 19
    n = nfft - 7000
    x = (0.3 * np.random.default_rng(33).standard_normal((rows, 1, n))
         ).astype(np.float32)
    _, resps = _resps(nfft, 1, 34)
    for n_out in (None, n):
        want = jfp.apply_response(jnp.asarray(x), jnp.asarray(resps[0]), nfft,
                                  n_out=n_out, interpret=True)
        got = tfs.apply_response(_t(x), _t(resps[0]), nfft, n_out=n_out)
        assert got.shape == (rows, 1, nfft if n_out is None else n)
        assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < ABS_RT


@pytest.mark.parametrize("rows", [1, 2, 3])
def test_public_functions_match_jax(rows):
    """Packed (even rows) and unpacked (odd rows) routes at the 2^19 plan,
    leading axes kept."""
    nfft = 1 << 19
    n = nfft - 5000
    x = (0.3 * np.random.default_rng(7).standard_normal((rows, 1, n))).astype(
        np.float32)
    _, resps = _resps(nfft, 4, 8)
    want = jfp.roundtrip_multi(jnp.asarray(x), jnp.asarray(resps[:2]), nfft,
                               n, interpret=True)
    got = tfs.roundtrip_multi(_t(x), _t(resps[:2]), nfft, n)
    assert got.shape == (2, rows, 1, n)
    assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < ABS_RT
    want = jfp.roundtrip_multi_reduce(jnp.asarray(x), jnp.asarray(resps),
                                      nfft, n, [_jax_map(*b) for b in BANDS],
                                      interpret=True)
    got = tfs.roundtrip_multi_reduce(_t(x), _t(resps), nfft, n,
                                     [BandMap(*b) for b in BANDS])
    assert got.shape == (rows, 1, n)
    assert _rel(got, want) < REL_REDUCE


def test_plain_versions_match_numpy_at_slice_plan():
    """The 180 s slice's plan, nfft = 2^23 (C = 512, C2 = 4), against
    numpy alone: stage A's forward, the packed round trip over K = 2
    responses and the reduce over K = 4 bands."""
    nfft = 1 << 23
    S = nfft // 128
    n = 7_938_000
    x = (0.3 * np.random.default_rng(9).standard_normal((2, n))).astype(
        np.float32)
    tabs = _tables(nfft)

    Xr, Xi = tfs._stage_a(_t(x[:1]), _t(x[1:]), nfft, False, tabs)
    z = np.pad(x[0] + 1j * x[1], (0, nfft - n)).reshape(128, S)
    t1 = np.exp(-2j * np.pi * np.arange(128)[:, None] * np.arange(S) / nfft)
    want = (np.fft.fft(z, axis=0) * t1).ravel()
    assert _rel(Xr[0], want.real) < REL_STAGE
    assert _rel(Xi[0], want.imag) < REL_STAGE
    del z, t1, want

    H, resps = _resps(nfft, 4, 10)
    X = np.fft.rfft(x, n=nfft, axis=-1)
    ys = tfs.roundtrip_multi(_t(x), _t(resps[:2]), nfft, n, tables=tabs)
    for k in range(2):
        want = np.fft.irfft(X * H[k], n=nfft, axis=-1)[:, :n]
        assert float(np.max(np.abs(ys[k].numpy() - want))) < ABS_RT, k
    del ys
    maps = [BandMap(*b) for b in BANDS]
    got = tfs.roundtrip_multi_reduce(_t(x), _t(resps), nfft, n, maps,
                                     tables=tabs)
    want = sum(maps[k](_t(np.fft.irfft(X * H[k], n=nfft, axis=-1)[:, :n]
                          .astype(np.float32))) for k in range(4))
    assert _rel(got, want) < REL_REDUCE


def test_band_table_follows_soft_knee_branches():
    rows = [BandMap(*b).table_row() for b in BANDS]
    assert [r[0] for r in rows] == [0, 3, 1, 2]
    assert all(len(r) == 8 for r in rows)
    tab = tfs.band_table([BandMap(*b) for b in BANDS], "cpu")
    assert tab.shape == (4, 8) and tab.dtype == torch.float32
    with pytest.raises(TypeError, match="BandMap"):
        tfs.band_table([lambda y: y], "cpu")
