"""The port's spectral ops (``amw_tpu_torch/ops/spectral.py``: STFT/iSTFT,
the STFT Wiener denoiser, the spectral envelope, Savitzky-Golay smoothing,
the reference match) and ``validctx.masked_quantile_last`` against the JAX
package's on the CPU, on the same seeded numpy inputs, and the v2 job and
v1 chain with those stages against ``amw_tpu``'s.

Tolerances, stated at each test: the transforms and the quantiles agree to
float32 rounding (pocketfft on both sides, different summation orders);
audio to the repo's parity bars (BASELINE.md): max sample error
<= -90 dBFS, integrated loudness within 0.1 LU, the graph's own meters
within 0.01 LU; padded tails exactly zero; a bucket-padded track equal to
its exact-length run within -90 dBFS, as tests/test_valid_masking.py holds
the JAX package.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amw_tpu import refimpl
from amw_tpu.models import v2_job as jv2
from amw_tpu.models.pipeline_v1 import build_v1_pipeline as jax_v1
from amw_tpu.ops import spectral as js
from amw_tpu.ops import validctx as jvc
from amw_tpu.spec import GraphSpec as JSpec
from amw_tpu_torch import GraphSpec
from amw_tpu_torch.constants import DENOISE_PRESETS
from amw_tpu_torch.convert import params_from_jax
from amw_tpu_torch.models import build_v1_pipeline
from amw_tpu_torch.models import v2_job as tv2
from amw_tpu_torch.ops import spectral as ts
from amw_tpu_torch.ops import validctx as tvc

SR = 44100
BAR_DBFS = -90.0
BAR_LU = 0.1
BAR_METER_LU = 0.01
CPU = "cpu"
# the two presets of the denoiser the tests run: noise percentiles 25, 10
PRESETS = ("vocal", "aggressive")


def _db(err):
    return 20 * np.log10(max(float(err), 1e-30))


def track(n, seed, channels=2):
    g = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = (0.28 * np.sin(2 * np.pi * 110 * t)
         + 0.12 * np.sin(2 * np.pi * 997 * t)
         + 0.06 * np.sin(2 * np.pi * 6100 * t)
         + 0.05 * g.standard_normal(n))
    env = 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 0.25 * t))
    x = np.stack([x * env, 0.85 * x * env])[:channels]
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def padded_batch(n, nvs, seed):
    x = np.stack([track(n, seed + i) for i in range(len(nvs))])
    for i, nv in enumerate(nvs):
        x[i, :, nv:] = 0.0
    return x


def run_valid(fn, x, nvs, *args):
    """``fn`` on the port's batch under the valid-length context."""
    with tvc.valid_length(torch.tensor(nvs)):
        return fn(torch.from_numpy(x), *args)


def jax_vmapped(fn, x, nvs, *args):
    """The JAX op under ``vmap`` with a per-track valid length."""
    def one(xt, nv, *a):
        with jvc.valid_length(nv):
            return fn(xt, *a)
    return np.asarray(jax.vmap(one, in_axes=(0, 0) + (None,) * len(args))(
        jnp.asarray(x), jnp.asarray(nvs, jnp.int32), *args))


# ---------------------------------------------------------------------------
# STFT / iSTFT


@pytest.mark.parametrize("channels", [1, 2], ids=["mono", "stereo"])
@pytest.mark.parametrize("n", [5000, SR + 37, 3 * 512 * 7])
def test_stft_istft_match_jax(n, channels):
    """Frames within 1e-6 of JAX's (their magnitudes stay under ~0.3); the
    round trip within 1e-6 of JAX's and of the input."""
    x = (0.3 * np.random.default_rng(n).standard_normal(
        (channels, n))).astype(np.float32)
    zj = np.asarray(js.stft(jnp.asarray(x)))
    zt = ts.stft(torch.from_numpy(x)).numpy()
    assert zt.shape == zj.shape
    assert np.abs(zt - zj).max() <= 1e-6
    rj = np.asarray(js.istft(jnp.asarray(zj), n))
    rt = ts.istft(torch.from_numpy(zj.copy()), n).numpy()
    assert rt.shape == x.shape
    assert np.abs(rt - rj).max() <= 1e-6
    assert np.abs(rt - x).max() <= 1e-6


def test_istft_frames_valid_on_padded_batch():
    """``n_frames_valid`` per track: JAX's (under vmap) within 1e-6, and
    each padded track's valid output its exact-length round trip's."""
    n, nvs = 3 * SR, [3 * SR, int(1.7 * SR) + 5]
    x = padded_batch(n, nvs, 11)
    tv = [(nv + 511) // 512 + 1 for nv in nvs]
    z = ts.stft(torch.from_numpy(x))
    frame = torch.arange(z.shape[-2])[:, None]
    z = z * (frame < torch.tensor(tv)[:, None, None, None])
    got = ts.istft(z, n, n_frames_valid=torch.tensor(tv)).numpy()
    want = np.asarray(jax.vmap(lambda zz, t: js.istft(zz, n, n_frames_valid=t))(
        jnp.asarray(z.numpy()), jnp.asarray(tv, jnp.int32)))
    assert np.abs(got - want).max() <= 1e-6
    for b, nv in enumerate(nvs):
        exact = ts.istft(ts.stft(torch.from_numpy(x[b, :, :nv])), nv).numpy()
        assert np.abs(got[b, :, :nv] - exact).max() <= 1e-6


# ---------------------------------------------------------------------------
# quantiles


# the quantiles' interpolation a * (1 - w) + b * w: XLA may contract it
# into a fused multiply-add, so the two agree to one float32 rounding
QUANTILE_RTOL = 2.4e-7


@pytest.mark.parametrize("q", [10.0, 15.0, 25.0, 50.0])
def test_masked_quantile_last_matches_jax(q):
    """JAX's within QUANTILE_RTOL: the same sort, positions and float32
    weights."""
    g = np.random.default_rng(int(q))
    a = g.random((3, 2, 5, 40)).astype(np.float32)
    count = np.array([40, 17, 1])
    t = np.arange(40)
    masked = np.where(t < count[:, None, None, None], a, np.inf).astype(
        np.float32)
    want = np.asarray(jax.vmap(jvc.masked_quantile_last, in_axes=(0, None, 0))(
        jnp.asarray(masked), q, jnp.asarray(count, jnp.int32)))
    got = tvc.masked_quantile_last(torch.from_numpy(masked), q,
                                   torch.from_numpy(count))
    np.testing.assert_allclose(got.numpy(), want, rtol=QUANTILE_RTOL, atol=0)
    pre = tvc.quantile_last_sorted(torch.sort(torch.from_numpy(masked),
                                              dim=-1).values, q,
                                   torch.from_numpy(count))
    np.testing.assert_array_equal(pre.numpy(), got.numpy())


@pytest.mark.parametrize("t", [39, 40])
def test_percentile_and_median_match_jnp(t):
    """The denoiser's unmasked branch: ``jnp.percentile`` (within
    QUANTILE_RTOL) and ``jnp.median`` (its even-count mean, exactly) from
    one sort."""
    a = np.random.default_rng(t).random((2, 7, t)).astype(np.float32)
    s = torch.sort(torch.from_numpy(a), dim=-1).values
    for q in (10.0, 15.0, 25.0):
        np.testing.assert_allclose(
            ts._percentile_sorted(s, q).numpy(),
            np.asarray(jnp.percentile(jnp.asarray(a), q, axis=-1,
                                      keepdims=True)),
            rtol=QUANTILE_RTOL, atol=0)
    np.testing.assert_array_equal(
        ts._percentile_sorted(s, 50.0, "midpoint").numpy(),
        np.asarray(jnp.median(jnp.asarray(a), axis=-1, keepdims=True)))


# ---------------------------------------------------------------------------
# the denoiser


@pytest.mark.parametrize("preset", PRESETS)
def test_denoise_exact_length_matches_jax(preset):
    """One stereo track at its own length: <= -90 dBFS."""
    strength, pct = DENOISE_PRESETS[preset]
    n = 2 * SR + 123
    x = track(n, 3)
    _, jf = js.build_spectral_denoise(JSpec(sr=SR, n=n, channels=2),
                                      strength, pct)
    _, tf = ts.build_spectral_denoise(GraphSpec(sr=SR, n=n, channels=2),
                                      strength, pct, device=CPU)
    want = np.asarray(jf(jnp.asarray(x), []))
    got = tf(torch.from_numpy(x)[None], [])[0].numpy()
    assert _db(np.abs(got - want).max()) <= BAR_DBFS


@pytest.mark.parametrize("preset", PRESETS)
def test_denoise_padded_batch_matches_jax_and_exact(preset):
    """A bucket-padded [B, C, N] batch with ``n_valid``: JAX's under vmap
    and each track's exact-length run within -90 dBFS."""
    strength, pct = DENOISE_PRESETS[preset]
    n, nvs = 3 * SR, [3 * SR, 2 * SR + 777]
    x = padded_batch(n, nvs, 5)
    _, jf = js.build_spectral_denoise(JSpec(sr=SR, n=n, channels=2),
                                      strength, pct)
    _, tf = ts.build_spectral_denoise(GraphSpec(sr=SR, n=n, channels=2),
                                      strength, pct, device=CPU)
    got = tvc.mask_tail(run_valid(tf, x, nvs, []),
                        torch.tensor(nvs)).numpy()
    want = jax_vmapped(lambda xt, p: jvc.mask_tail(jf(xt, p)), x, nvs, [])
    assert _db(np.abs(got - want).max()) <= BAR_DBFS
    for b, nv in enumerate(nvs):
        _, fe = ts.build_spectral_denoise(
            GraphSpec(sr=SR, n=nv, channels=2), strength, pct, device=CPU)
        exact = fe(torch.from_numpy(x[b:b + 1, :, :nv]), [])[0].numpy()
        assert _db(np.abs(got[b, :, :nv] - exact).max()) <= BAR_DBFS
        assert np.all(got[b, :, nv:] == 0.0)


def test_denoise_below_one_percent_is_identity():
    _, fn = ts.build_spectral_denoise(GraphSpec(sr=SR, n=SR), 0.005,
                                      device=CPU)
    x = torch.from_numpy(track(SR, 1))
    assert fn(x, []) is x


# ---------------------------------------------------------------------------
# envelope, smoothing, reference match


@pytest.mark.parametrize("masked", [False, True], ids=["exact", "padded"])
def test_spectral_envelope_matches_jax(masked):
    """Relative 1e-5 of the largest bin (float32 power sums)."""
    n = 3 * SR
    if masked:
        nvs = [n, SR + 4321]
        x = padded_batch(n, nvs, 8)
        got = run_valid(ts.spectral_envelope, x, nvs).numpy()
        want = jax_vmapped(js.spectral_envelope, x, nvs)
    else:
        x = track(n, 8)
        got = ts.spectral_envelope(torch.from_numpy(x)).numpy()
        want = np.asarray(js.spectral_envelope(jnp.asarray(x)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_spectral_envelope_of_a_short_clip_is_flat():
    x = torch.from_numpy(track(4000, 2))
    np.testing.assert_array_equal(ts.spectral_envelope(x).numpy(),
                                  np.ones(4097, np.float32))


def test_savgol_smooth_matches_jax_and_scipy():
    """JAX's within 1e-6 relative, scipy's 'interp' filter within 1e-5."""
    from scipy.signal import savgol_filter

    r = (1.0 + 0.3 * np.random.default_rng(4).standard_normal(
        (2, 4097))).astype(np.float32)
    got = ts.savgol_smooth(torch.from_numpy(r)).numpy()
    want = np.stack([np.asarray(js.savgol_smooth(jnp.asarray(row)))
                     for row in r])
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()
    ref = savgol_filter(r.astype(np.float64), 51, 3, mode="interp", axis=-1)
    assert np.abs(got - ref).max() <= 1e-5


def _ref_env():
    return (np.abs(np.random.default_rng(7).standard_normal(4097))
            + 0.5).astype(np.float32)


@pytest.mark.parametrize("masked", [False, True], ids=["exact", "padded"])
def test_reference_match_matches_jax(masked):
    """<= -90 dBFS against JAX's; the padded batch's tracks also against
    their exact-length runs."""
    n = 3 * SR
    env = _ref_env()
    jp, jf = js.build_reference_match(JSpec(sr=SR, n=n, channels=2), env,
                                      strength=0.8)
    tp, tf = ts.build_reference_match(GraphSpec(sr=SR, n=n, channels=2),
                                      env, strength=0.8, device=CPU)
    pt = params_from_jax(tp, device=CPU)
    if not masked:
        x = track(n, 6)
        want = np.asarray(jf(jnp.asarray(x), jax.device_put(jp)))
        got = tf(torch.from_numpy(x)[None], pt)[0].numpy()
        assert _db(np.abs(got - want).max()) <= BAR_DBFS
        return
    nvs = [n, 2 * SR + 99]
    x = padded_batch(n, nvs, 6)
    got = tvc.mask_tail(run_valid(tf, x, nvs, pt), torch.tensor(nvs)).numpy()
    want = jax_vmapped(lambda xt, p: jvc.mask_tail(jf(xt, p)), x, nvs,
                       jax.device_put(jp))
    assert _db(np.abs(got - want).max()) <= BAR_DBFS
    for b, nv in enumerate(nvs):
        pe, fe = ts.build_reference_match(GraphSpec(sr=SR, n=nv, channels=2),
                                          env, strength=0.8, device=CPU)
        exact = fe(torch.from_numpy(x[b:b + 1, :, :nv]),
                   params_from_jax(pe, device=CPU))[0].numpy()
        assert _db(np.abs(got[b, :, :nv] - exact).max()) <= BAR_DBFS


# ---------------------------------------------------------------------------
# the v2 job and the v1 chain with the spectral stages


PRO = {"rumble_enabled": True, "rumble_cutoff": 60.0,
       "denoise_preset": "medium", "deesser_enabled": True}


def _assert_audio(got, want, nvs):
    for g, w, nv in zip(got, want, nvs):
        assert _db(np.abs(g[:, :nv] - w[:, :nv]).max()) <= BAR_DBFS
        assert np.all(g[:, nv:] == 0.0)
        d_lu = abs(refimpl.integrated_lufs(g[:, :nv], SR)
                   - refimpl.integrated_lufs(w[:, :nv], SR))
        assert d_lu <= BAR_LU


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "padded"])
def test_v2_job_with_denoise_matches_jax(padded):
    n = 2 * SR
    nvs = [n, int(1.4 * SR)] if padded else [n]
    jp, jfn, jnames = jv2.build_v2_job_graph(JSpec(sr=SR, n=n, channels=2),
                                             None, PRO, -14.0, "standard")
    _, tfn, tnames = tv2.build_v2_job_graph(GraphSpec(sr=SR, n=n, channels=2),
                                            None, PRO, -14.0, "standard",
                                            device=CPU)
    assert tnames == jnames and "spectral_denoise" in tnames
    pt = params_from_jax(jp, device=CPU)
    x = padded_batch(n, nvs, 21)
    want = jax.jit(jax.vmap(jfn, in_axes=(0, None, 0)))(
        x, jax.device_put(jp), np.asarray(nvs, np.int32))
    got = tfn(torch.from_numpy(x), pt, torch.tensor(nvs))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    _assert_audio(got["out"], want["out"], nvs)
    for k in ("before_lufs", "after_lufs"):
        assert np.max(np.abs(got[k] - want[k])) <= BAR_METER_LU, k


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "padded"])
def test_v1_chain_with_denoise_and_reference_matches_jax(padded):
    """``podcast`` has style EQ bands, so the normalize/final fusion runs
    without its style EQ (``style=None``) ahead of the reference match."""
    n = 2 * SR
    nvs = [n, int(1.3 * SR)] if padded else [n]
    kw = dict(style="podcast", target_lufs=-16.0, denoise_strength=0.5,
              reference_env=ts.spectral_envelope(torch.from_numpy(
                  track(3 * SR, 99))).numpy(), reference_strength=0.8)
    jp, jfn, jnames = jax_v1(JSpec(sr=SR, n=n, channels=2), **kw)
    _, tfn, tnames = build_v1_pipeline(GraphSpec(sr=SR, n=n, channels=2),
                                       device=CPU, **kw)
    assert tnames == jnames
    assert tnames[1] == "spectral_denoise"
    assert tnames.index("reference_match") + 1 == tnames.index("style_eq")
    pt = params_from_jax(jp, device=CPU)
    x = padded_batch(n, nvs, 31)
    want = np.asarray(jax.jit(jax.vmap(jfn, in_axes=(0, None, 0)))(
        x, jax.device_put(jp), np.asarray(nvs, np.int32)))
    got = tfn(torch.from_numpy(x), pt, torch.tensor(nvs)).numpy()
    assert got.shape == x.shape
    _assert_audio(got, want, nvs)
