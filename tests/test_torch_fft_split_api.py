"""The port's split public API of the staged FFT (``fft_permuted``,
``ifft_permuted``, ``fwd_real``, ``inv_multi``, ``inv_multi_reduce``,
``apply_response(real_impulse=False)``) and its split route
(``AMW_FFT_FUSED_RT=0``) against the JAX package's, the Pallas kernels in
interpret mode, at the 2^19 plan.

Bars (the JAX suite's, tests/test_fft_pallas.py): relative 3e-6 for a
forward spectrum, absolute 2e-5 for round trips of unit-variance signals,
relative 1e-5 with band maps.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from amw_tpu.ops import fft_pallas as jfp
from amw_tpu_torch.ops import fft_staged as tfs
from amw_tpu_torch.ops.bands import BandMap

from test_torch_fft import (ABS_RT, BANDS, REL_REDUCE, REL_STAGE, _jax_map,
                            _planes, _rel, _resps, _t)

NFFT = 1 << 19


def _abs(got, want):
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want))))


def _signal(shape, seed):
    return (0.3 * np.random.default_rng(seed).standard_normal(shape)).astype(
        np.float32)


def test_fft_permuted_and_inverse_match_jax():
    xr, xi = _planes((2, NFFT - 3000), 50)
    pad = ((0, 0), (0, 3000))
    wr, wi = jfp.fft_permuted(jnp.asarray(np.pad(xr, pad)),
                              jnp.asarray(np.pad(xi, pad)), NFFT,
                              interpret=True)
    gr, gi = tfs.fft_permuted(_t(xr), _t(xi), NFFT)
    assert gr.shape == (2, NFFT)
    assert _rel(gr, wr) < REL_STAGE and _rel(gi, wi) < REL_STAGE
    want = jfp.ifft_permuted(wr, wi, NFFT, interpret=True)
    got = tfs.ifft_permuted(gr, gi, NFFT)
    for g, w, x in zip(got, want, (xr, xi)):
        assert _abs(g, w) < ABS_RT
        assert _abs(g[:, :NFFT - 3000], x) < ABS_RT  # the inverse
        assert _abs(g[:, NFFT - 3000:], 0.0) < ABS_RT


@pytest.mark.parametrize("lead", [(1, 1), (3,)])
def test_fwd_real_and_inverses_match_jax(lead):
    n = NFFT - 5000
    x = _signal(lead + (n,), 51)
    _, resps = _resps(NFFT, 4, 52)
    wr, wi, wlead = jfp.fwd_real(jnp.asarray(x), NFFT, interpret=True)
    gr, gi, glead = tfs.fwd_real(_t(x), NFFT)
    assert tuple(glead) == tuple(wlead) == lead
    assert _rel(gr, wr) < REL_STAGE and _rel(gi, wi) < REL_STAGE

    want = jfp.inv_multi(wr, wi, jnp.asarray(resps[:2]), NFFT, wlead, n,
                         interpret=True)
    got = tfs.inv_multi(gr, gi, _t(resps[:2]), NFFT, glead, n)
    assert got.shape == (2,) + lead + (n,)
    assert _abs(got, want) < ABS_RT

    want = jfp.inv_multi_reduce(wr, wi, jnp.asarray(resps), NFFT, wlead, n,
                                [_jax_map(*b) for b in BANDS],
                                interpret=True)
    got = tfs.inv_multi_reduce(gr, gi, _t(resps), NFFT, glead, n,
                               [BandMap(*b) for b in BANDS])
    assert got.shape == lead + (n,)
    assert _rel(got, want) < REL_REDUCE


@pytest.mark.parametrize("rows", [2, 3])
def test_apply_response_unpacked_for_complex_impulses(rows):
    """``real_impulse=False`` takes the unpacked route for every row count,
    so a response whose impulse is complex (a phase rotator) keeps the
    rows apart."""
    n = NFFT - 7000
    x = _signal((rows, n), 53)
    H = np.exp(1j * np.linspace(0.0, 3.0, NFFT // 2 + 1))
    full = np.exp(1j * np.linspace(0.0, 6.0, NFFT))  # not conj-symmetric
    full[: NFFT // 2 + 1] = H
    fp = full[tfs._perm(NFFT)]
    resp = np.stack([fp.real, fp.imag]).astype(np.float32)
    want = jfp.apply_response(jnp.asarray(x), jnp.asarray(resp), NFFT,
                              n_out=n, interpret=True, real_impulse=False)
    got = tfs.apply_response(_t(x), _t(resp), NFFT, n_out=n,
                             real_impulse=False)
    assert got.shape == (rows, n)
    assert _abs(got, want) < ABS_RT
    # each row alone (one row is always unpacked): no cross-talk
    alone = tfs.apply_response(_t(x[:1]), _t(resp), NFFT, n_out=n)
    assert _abs(got[:1], alone) < ABS_RT


@pytest.fixture
def split_route(monkeypatch):
    """``AMW_FFT_FUSED_RT=0`` for both packages; the port's fused round
    trips refuse to run, so a pass shows it took the split stages."""
    monkeypatch.setenv("AMW_FFT_FUSED_RT", "0")
    assert not tfs.fused_rt() and not jfp._fused_rt()

    def refuse(*a, **k):
        raise AssertionError("fused round trip on the split route")

    monkeypatch.setattr(tfs, "_stage_bc_cb", refuse)
    monkeypatch.setattr(tfs, "_stage_bccb_multi", refuse)


def test_fused_rt_reads_the_variable_at_call_time(monkeypatch):
    monkeypatch.delenv("AMW_FFT_FUSED_RT", raising=False)
    assert tfs.fused_rt() == jfp._fused_rt() is True
    for value, fused in (("0", False), ("1", True), ("yes", False)):
        monkeypatch.setenv("AMW_FFT_FUSED_RT", value)
        assert tfs.fused_rt() == jfp._fused_rt() is fused


@pytest.mark.parametrize("rows", [1, 2])
def test_split_apply_response_matches_jax(split_route, rows):
    n = NFFT - 4000
    x = _signal((rows, 1, n), 54)
    _, resps = _resps(NFFT, 1, 55)
    want = jfp.apply_response(jnp.asarray(x), jnp.asarray(resps[0]), NFFT,
                              n_out=n, interpret=True)
    got = tfs.apply_response(_t(x), _t(resps[0]), NFFT, n_out=n)
    assert got.shape == (rows, 1, n)
    assert _abs(got, want) < ABS_RT


@pytest.mark.parametrize("rows", [2, 3])
def test_split_roundtrips_match_jax(split_route, rows):
    n = NFFT - 6000
    x = _signal((rows, n), 56)
    _, resps = _resps(NFFT, 4, 57)
    want = jfp.roundtrip_multi(jnp.asarray(x), jnp.asarray(resps[:2]), NFFT,
                               n, interpret=True)
    got = tfs.roundtrip_multi(_t(x), _t(resps[:2]), NFFT, n)
    assert got.shape == (2, rows, n)
    assert _abs(got, want) < ABS_RT
    want = jfp.roundtrip_multi_reduce(jnp.asarray(x), jnp.asarray(resps),
                                      NFFT, n, [_jax_map(*b) for b in BANDS],
                                      interpret=True)
    got = tfs.roundtrip_multi_reduce(_t(x), _t(resps), NFFT, n,
                                     [BandMap(*b) for b in BANDS])
    assert got.shape == (rows, n)
    assert _rel(got, want) < REL_REDUCE
