"""The port's dither and 16-bit quantization (``amw_tpu_torch/ops/
dither.py``) against the JAX package's on the CPU.

The draws come from a ``torch.Generator`` where the JAX package uses its
counter-based PRNG, so the noise itself is held statistically (as
tests/test_coverage_extra.py holds the JAX package's against the
reference); the deterministic parts are held exactly: the noise shaping
fed the JAX package's own white noise (``2·jax.random.uniform - 1``) within
1e-5 LSB, and ``quantize16`` given the same noise bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from amw_tpu import refimpl
from amw_tpu.ops import dither as jdi
from amw_tpu_torch.ops import dither as tdi

SHAPING_ATOL_LSB = 1e-5
SR = 44100


def _gen(seed):
    return torch.Generator(device="cpu").manual_seed(seed)


@pytest.mark.parametrize("n", [1 << 16, 50_021])
@pytest.mark.parametrize("kind", ["ns_e", "ns_itu"])
def test_shaping_of_jax_white_noise_matches(kind, n):
    key = jax.random.PRNGKey(n)
    want = np.asarray(jdi.dither_noise(key, (2, n), kind))
    white = np.asarray(2.0 * jax.random.uniform(key, (2, n)) - 1.0)
    got = tdi.shape_noise(torch.tensor(white), kind).numpy()
    assert got.shape == want.shape
    assert float(np.max(np.abs(got - want))) <= SHAPING_ATOL_LSB


def test_quantize16_equals_jax():
    """Same input and noise: the same int16 samples, including NaN and
    infinities, full scale and ties rounded half to even."""
    g = np.random.default_rng(0)
    x = np.concatenate([
        g.uniform(-1.2, 1.2, 20_000),
        [np.nan, np.inf, -np.inf, 1.0, -1.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    noise = np.concatenate([
        g.uniform(-1.0, 1.0, 20_000),
        [0.3, 0.0, 0.0, 0.9, -0.9, 0.5, 1.5, -0.5, -2.5, np.nan]])
    x = x.astype(np.float32)[None]
    noise = noise.astype(np.float32)[None]
    want = np.asarray(jdi.quantize16(x, noise))
    got = tdi.quantize16(torch.from_numpy(x), torch.from_numpy(noise))
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0, -5:-1].tolist() == [0, 2, 0, -2]  # half to even


def test_tpdf_statistics():
    noise = tdi.dither_noise(_gen(1), (4, 50_000), "tpdf", device="cpu")
    assert noise.shape == (4, 50_000) and noise.dtype == torch.float32
    a = noise.double()
    assert float(a.abs().max()) < 1.0
    assert abs(float(a.mean())) < 0.01
    # triangular on (-1, 1): variance 1/6
    assert abs(float(a.var()) - 1.0 / 6.0) <= 0.02 / 6.0


@pytest.mark.parametrize("kind,n", [("ns_e", 3), ("ns_itu", 7)])
def test_short_signals_fall_back_to_tpdf(kind, n):
    """Below 4 (``ns_e``) or 8 (``ns_itu``) samples both fall back to
    TPDF, as in the JAX package: the same draws as ``tpdf``."""
    got = tdi.dither_noise(_gen(5), (2, n), kind, device="cpu")
    want = tdi.dither_noise(_gen(5), (2, n), "tpdf", device="cpu")
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind", ["ns_e", "ns_itu"])
def test_noise_shaped_dither_is_highpassed(kind):
    """The checks of tests/test_coverage_extra.py on the port's noise:
    near-DC suppressed, the top octave carrying the noise, and the
    reference filter's spectral tilt."""
    n = 1 << 16
    noise = tdi.dither_noise(_gen(7), (2, n), kind, device="cpu").numpy()
    spec = np.abs(np.fft.rfft(noise, axis=-1)) ** 2
    freqs = np.fft.rfftfreq(n, 1 / SR)
    lo = spec[:, (freqs > 0) & (freqs < 30.0)].mean()
    hi = spec[:, freqs > 15000.0].mean()
    assert hi > 3 * lo, (lo, hi)
    rng = np.random.default_rng(0)
    ref = (refimpl.dither_ns_e((2, n), rng) if kind == "ns_e"
           else refimpl.dither_ns_itu((2, n), rng))
    rspec = np.abs(np.fft.rfft(ref, axis=-1)) ** 2
    r_ratio = (rspec[:, freqs > 15000.0].mean()
               / rspec[:, (freqs > 0) & (freqs < 30.0)].mean())
    assert 0.3 < (hi / lo) / r_ratio < 3.0


def test_unknown_dither_type_raises():
    with pytest.raises(ValueError):
        tdi.dither_noise(_gen(0), (2, 100), "blue", device="cpu")
