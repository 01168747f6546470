"""The port's reverb (``amw_tpu_torch/ops/reverb.py``) against the JAX
package's on the CPU.

The host-built wet impulse response must equal the JAX package's exactly
(one numpy/scipy computation); the convolution on ``torch.fft`` against
XLA's FFT at the repo's parity bars (BASELINE.md): max sample error <= -90
dBFS, integrated loudness within 0.1 LU.  Every preset, mono, stereo and
the M/S mix, exact-length and bucket-padded.
"""

import jax
import numpy as np
import pytest
import torch

from amw_tpu import refimpl
from amw_tpu.constants import REVERB_PRESETS as J_PRESETS
from amw_tpu.models import chain as jchain
from amw_tpu.ops import reverb as jrv
from amw_tpu.ops import validctx as jvc
from amw_tpu.spec import GraphSpec as JSpec
from amw_tpu_torch import GraphSpec
from amw_tpu_torch.constants import REVERB_PRESETS
from amw_tpu_torch.convert import params_from_jax
from amw_tpu_torch.models import chain as tchain
from amw_tpu_torch.ops import reverb as trv
from amw_tpu_torch.ops import validctx as tvc

SR = 44100
N = 40_007  # ragged: neither FFT size rule lands on it
BAR_DBFS = -90.0
BAR_LU = 0.1
MIXES = {"mono": (1, {}), "stereo": (2, {}),
         "ms": (2, {"mix_mid": 0.12, "mix_side": 0.2})}


def db(err):
    return 20 * np.log10(max(err, 1e-30))


def _batch(channels, n=N, seeds=(0,)):
    out = []
    for s in seeds:
        g = np.random.default_rng(s)
        t = np.arange(n) / SR
        x = (0.3 * np.sin(2 * np.pi * 220 * t) * (t < 0.2)
             + 0.1 * g.standard_normal(n) * np.exp(-3 * t))
        out.append(np.stack([x, 0.7 * x + 0.05 * g.standard_normal(n)])
                   [:channels])
    return np.clip(np.stack(out), -0.99, 0.99).astype(np.float32)


def test_presets_match_jax():
    assert REVERB_PRESETS == J_PRESETS


@pytest.mark.parametrize("preset", sorted(REVERB_PRESETS))
def test_wet_ir_equals_jax(preset):
    for n, decay in ((N, 0.0), (SR * 3, 1.7), (500, 2.2)):
        want = jrv.wet_ir(SR, n, preset, decay)
        got = trv.wet_ir(SR, n, preset, decay)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def _pair(preset, channels, kw, n=N):
    jp, jf = jrv.build_reverb(JSpec(sr=SR, n=n, channels=channels), preset,
                              **kw)
    tp, tf = trv.build_reverb(GraphSpec(sr=SR, n=n, channels=channels),
                              preset, device="cpu", **kw)
    assert len(tp) == len(jp) == 1 and np.array_equal(tp[0], jp[0])
    return jf, jp, tf, params_from_jax(jp, device="cpu")


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("preset", sorted(REVERB_PRESETS))
def test_build_reverb_matches_jax(preset, mix):
    channels, kw = MIXES[mix]
    jf, jp, tf, tp = _pair(preset, channels, kw)
    x = _batch(channels)[0]
    want = np.asarray(jax.jit(lambda v: jf(v, jp))(x))
    got = tf(torch.from_numpy(x), tp).numpy()
    assert got.shape == x.shape
    assert db(float(np.max(np.abs(got - want)))) <= BAR_DBFS
    assert abs(refimpl.integrated_lufs(got, SR)
               - refimpl.integrated_lufs(want, SR)) <= BAR_LU


@pytest.mark.parametrize("mix", ["stereo", "ms"])
def test_padded_batch_matches_exact_length(mix):
    """The wet ring-out past each track's valid end is masked before the
    peak normalisation, so a padded track equals its exact-length run; the
    batch also matches the JAX package's padded graph under ``vmap``."""
    channels, kw = MIXES[mix]
    nvs = np.array([N, 31_013], np.int32)
    xb = _batch(channels, seeds=(1, 2))
    xb[1, :, nvs[1]:] = 0.0
    jf, jp, tf, tp = _pair("hall", channels, kw)
    with tvc.valid_length(torch.from_numpy(nvs)):
        got = tvc.mask_tail(tf(torch.from_numpy(xb), tp)).numpy()

    def one(x, nvi):
        with jvc.valid_length(nvi):
            return jvc.mask_tail(jf(x, jp))

    want = np.asarray(jax.jit(jax.vmap(one))(xb, nvs))
    _, _, tf_e, tp_e = _pair("hall", channels, kw, n=int(nvs[1]))
    exact = tf_e(torch.from_numpy(np.ascontiguousarray(
        xb[1, :, :nvs[1]])), tp_e).numpy()
    assert db(float(np.max(np.abs(got[1, :, :nvs[1]] - exact)))) <= BAR_DBFS
    assert np.all(got[1, :, nvs[1]:] == 0.0)
    assert db(float(np.max(np.abs(got - want)))) <= BAR_DBFS


def test_chain_module_builds_as_in_jax():
    """The chain's ``reverb`` module builds under its own id, unbypassed,
    with the default config's fields, and runs as the JAX package's."""
    module = {"id": "reverb", "enabled": True, "reverb_type": "room",
              "decay_sec": 0.8, "mix": 0.2, "mix_mid": None,
              "mix_side": 0.3}
    spec, jspec = GraphSpec(sr=SR, n=N, channels=2), JSpec(sr=SR, n=N,
                                                           channels=2)
    cc = tchain.compile_chain(spec, {"modules": [module]}, device="cpu")
    jc = jchain.compile_chain(jspec, {"modules": [module]})
    assert cc.module_ids == jc.module_ids == ["reverb"]
    assert cc.bypassed == jc.bypassed == []
    x = _batch(2, seeds=(5,))[0]
    assert db(float(np.max(np.abs(cc(x) - np.asarray(jc(x)))))) <= BAR_DBFS
