"""The split stages of the port's staged FFT (kernels 6, 7 and 10:
``_stage_bc``, ``_stage_cb``, ``_stage_cb_multi``) against the JAX
package's Pallas kernels in interpret mode.

Bar: relative 3e-6 of the largest magnitude for a stage's output (the JAX
suite's own, tests/test_fft_pallas.py).  Two rows at 2^19 (C = 32, a
direct C-point stage) and one row at 2^22 (C = 256, the composite stage
with C2 = 2, whose permuted storage order the stages must match exactly).
The public split API and the split route are in
tests/test_torch_fft_split_api.py; the CUDA kernels against these plain
versions in tests/test_torch_fft_cuda.py.
"""

import jax.numpy as jnp
import pytest
import torch

from amw_tpu.ops import fft_pallas as jfp
from amw_tpu_torch.ops import fft_staged as tfs

from test_torch_fft import REL_STAGE, _planes, _rel, _resps, _t, _tables

CASES = [(1 << 19, 2), (1 << 22, 1)]  # (nfft, rows)


@pytest.mark.parametrize("nfft,rows", CASES)
def test_stage_bc_matches_jax(nfft, rows):
    xr, xi = _planes((rows, nfft), 40)
    wr, wi = jfp._stage_bc(jnp.asarray(xr), jnp.asarray(xi), nfft,
                           jfp.plan_params(nfft), interpret=True)
    gr, gi = tfs._stage_bc(_t(xr), _t(xi), nfft, _tables(nfft))
    assert gr.shape == (rows, nfft)
    assert _rel(gr, wr) < REL_STAGE
    assert _rel(gi, wi) < REL_STAGE


@pytest.mark.parametrize("nfft,rows", CASES)
@pytest.mark.parametrize("with_resp", [True, False])
def test_stage_cb_matches_jax(nfft, rows, with_resp):
    xr, xi = _planes((rows, nfft), 41)
    resp = _resps(nfft, 1, 42)[1][0] if with_resp else None
    wr, wi = jfp._stage_cb(jnp.asarray(xr), jnp.asarray(xi), nfft,
                           jfp.plan_params(nfft),
                           resp=None if resp is None else jnp.asarray(resp),
                           interpret=True)
    gr, gi = tfs._stage_cb(_t(xr), _t(xi), None if resp is None else _t(resp),
                           nfft, _tables(nfft))
    assert gr.shape == (rows, nfft)
    assert _rel(gr, wr) < REL_STAGE
    assert _rel(gi, wi) < REL_STAGE


@pytest.mark.parametrize("nfft,rows", CASES)
@pytest.mark.parametrize("K", [2, 4])
def test_stage_cb_multi_matches_jax(nfft, rows, K):
    xr, xi = _planes((rows, nfft), 43)
    _, resps = _resps(nfft, K, 44)
    wr, wi = jfp._stage_cb_multi(jnp.asarray(xr), jnp.asarray(xi),
                                 jnp.asarray(resps), nfft,
                                 jfp.plan_params(nfft), interpret=True)
    gr, gi = tfs._stage_cb_multi(_t(xr), _t(xi), _t(resps), nfft,
                                 _tables(nfft))
    assert gr.shape == (K * rows, nfft)
    assert _rel(gr, wr) < REL_STAGE
    assert _rel(gi, wi) < REL_STAGE


def test_fused_plain_versions_are_the_split_composition():
    """``bccb_multi_plain`` is ``cb_multi_plain ∘ bc_plain`` and the
    one-response and no-response forms are its K = 1 cases, bit for bit;
    ``cb_plain`` without a response inverts ``bc_plain``."""
    nfft = 1 << 19
    tabs = _tables(nfft)
    xr, xi = (_t(p) for p in _planes((2, nfft), 45))
    resps = _t(_resps(nfft, 2, 46)[1])
    Sr, Si = tfs.bc_plain(xr, xi, nfft, tabs)
    for got, want in ((tfs.bccb_multi_plain(xr, xi, resps, nfft, tabs),
                       tfs.cb_multi_plain(Sr, Si, resps, nfft, tabs)),
                      (tfs.bc_cb_plain(xr, xi, resps[0], nfft, tabs),
                       tfs.cb_plain(Sr, Si, resps[0], nfft, tabs)),
                      (tfs.cb_plain(Sr, Si, resps[0], nfft, tabs),
                       tfs.cb_multi_plain(Sr, Si, resps[:1], nfft, tabs))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # forward then inverse, unscaled: nfft / A times the input
    yr, yi = tfs.cb_plain(Sr, Si, None, nfft, tabs)
    scale = tfs.A / nfft
    assert _rel(yr * scale, xr) < REL_STAGE
    assert _rel(yi * scale, xi) < REL_STAGE
