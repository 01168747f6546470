"""The chain-config options ported in slice 4 against the JAX package on
the CPU: the envelope band compressor (``dynamics.compressor =
"envelope"``) and the linear-phase target curve (``target_curve.phase_mode
= "linear_phase"``, with and without ``eq_ms``), as modules and in the
chain's build; inside a short v2 job in
tests/test_torch_chain_options_job.py.

Bars (the repo's, BASELINE.md): max sample error <= -90 dBFS, integrated
loudness within 0.1 LU, the job's before/after loudness within 0.01 LU.
"""

import pytest

from amw_tpu.models import chain as jchain
from amw_tpu.ops import bands as jbands
from amw_tpu.ops import eq as jeq
from amw_tpu.ops import fused as jfused
from amw_tpu.spec import GraphSpec as JSpec
from amw_tpu_torch import GraphSpec
from amw_tpu_torch.models import chain as tchain
from amw_tpu_torch.ops import bands as tbands
from amw_tpu_torch.ops import eq as teq
from amw_tpu_torch.ops import fused as tfused

from test_torch_chain_options_job import options_config
from test_torch_modules import (N, NVS, SR, _batch, _jax, _max_err, _op_pair,
                                _torch)

BAR = 10 ** (-90.0 / 20.0)


@pytest.mark.parametrize("fused", [False, True], ids=["alone", "fused"])
def test_envelope_compressor_matches_jax(fused):
    """The four bands, an envelope follower on each (every default band
    ratio is >= 1), limiter and gain; alone and fused behind the target
    curve (the chain's ``target_curve+dynamics`` peephole)."""
    x = _batch(20, nvs=NVS)
    js, ts = JSpec(sr=SR, n=N), GraphSpec(sr=SR, n=N)
    if fused:
        jb = jfused.build_target_then_dynamics(js, compressor="envelope")
        tb = tfused.build_target_then_dynamics(ts, device="cpu",
                                               compressor="envelope")
    else:
        jb = jbands.build_dynamics(js, compressor="envelope")
        tb = tbands.build_dynamics(ts, compressor="envelope", device="cpu")
    jf, tf = _op_pair(jb, tb)
    for nvs in (None, NVS):
        assert _max_err(_torch(tf, x, nvs), _jax(jf, x, nvs), nvs) <= BAR


def test_envelope_compressor_band_ratios():
    """A band ratio below 1 takes the soft-knee upward branch, the others
    the envelope detector."""
    x = _batch(21)
    ratios = [1.0, 0.7, 2.5, 1.2]
    jf, tf = _op_pair(
        jbands.build_multiband_dynamics(JSpec(sr=SR, n=N), band_ratios=ratios,
                                        compressor="envelope"),
        tbands.build_multiband_dynamics(GraphSpec(sr=SR, n=N),
                                        band_ratios=ratios,
                                        compressor="envelope", device="cpu"))
    assert _max_err(_torch(tf, x), _jax(jf, x)) <= BAR


@pytest.mark.parametrize("eq_ms", [False, True])
def test_linear_phase_target_curve_matches_jax(eq_ms):
    x = _batch(22, nvs=NVS)
    jb = jeq.build_target_curve(JSpec(sr=SR, n=N), "linear_phase", eq_ms)
    tb = teq.build_target_curve(GraphSpec(sr=SR, n=N), "linear_phase",
                                eq_ms, device="cpu")
    assert len(tb[0]) == 1 and tb[0][0].shape == (4096,)
    jf, tf = _op_pair(jb, tb)
    for nvs in (None, NVS):
        assert _max_err(_torch(tf, x, nvs), _jax(jf, x, nvs), nvs) <= BAR


def test_chain_records_the_options_as_jax():
    spec = GraphSpec(sr=SR, n=N, channels=2)
    for phase_mode in ("linear_phase", "minimum"):
        cfg = options_config(phase_mode)
        ids, _, _, byp = tchain.build_chain_ops(spec, cfg, device="cpu")
        jids, _, _, jbyp = jchain.build_chain_ops(
            JSpec(sr=SR, n=N, channels=2), cfg)
        assert ids == jids and byp == jbyp == []
