"""The v2 job's modules (the pro stages, the v2 chain's fusion, the exciter
and imager) and the envelope kernels' plain versions against the JAX
package on the CPU.

The same numpy inputs (from a seed) go through ``amw_tpu`` and
``amw_tpu_torch``; the JAX functions run per track under ``jax.vmap`` with
a per-track ``n_valid``, the port's on the explicit batch axis
``[B, C, N]``.  Bars: atol 1e-5 for the ops (f32 FFTs of different
libraries, envelopes equal to the exact recurrence to eps = 1e-8 on both
sides), and 1e-5 for the envelope kernels' plain versions against the
Pallas kernels run in interpret mode on unit-scale input.
"""

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amw_tpu.ops import basic as jbasic
from amw_tpu.ops import dynamics as jdyn
from amw_tpu.ops import eq as jeq
from amw_tpu.ops import exciter as jexc
from amw_tpu.ops import fused as jfused
from amw_tpu.ops import scan as jscan
from amw_tpu.ops import stereo as jstereo
from amw_tpu.ops import validctx as jvc
from amw_tpu.spec import GraphSpec as JSpec
from amw_tpu_torch import GraphSpec
from amw_tpu_torch import constants as tconst
from amw_tpu_torch.convert import params_from_jax
from amw_tpu_torch.ops import basic as tbasic
from amw_tpu_torch.ops import design as tdesign
from amw_tpu_torch.ops import dynamics as tdyn
from amw_tpu_torch.ops import eq as teq
from amw_tpu_torch.ops import exciter as texc
from amw_tpu_torch.ops import fused as tfused
from amw_tpu_torch.ops import scan as tscan
from amw_tpu_torch.ops import stereo as tstereo
from amw_tpu_torch.ops import validctx as tvc

SR = 44100
N = SR // 2  # 0.5 s: every hybrid split applies, the envelopes stay short
NVS = [N, 19000, 15011]
ATOL = 1e-5
ENV_ATOL = 1e-5


def _batch(seed, n=N, nvs=None):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    B = len(nvs) if nvs else 2
    x = np.stack([
        np.stack([(0.3 * np.sin(2 * np.pi * (110 + 40 * b) * t)
                   + 0.15 * np.sin(2 * np.pi * 6100 * t)
                   + 0.08 * rng.standard_normal(n))
                  * (0.4 + 0.6 * (np.sin(2 * np.pi * 3 * t) > 0))
                  for _ in range(2)])
        for b in range(B)]).astype(np.float32)
    if nvs:
        for b, nv in enumerate(nvs):
            x[b, :, nv:] = 0.0
    return x


def _flat(p):
    if isinstance(p, (list, tuple)):
        for q in p:
            yield from _flat(q)
    else:
        yield np.asarray(p)


def _pair(jbuilt, tbuilt):
    """(jax fn, torch fn): the port's fed the JAX params after checking that
    its own agree."""
    jp, jf = jbuilt[0], jbuilt[1]
    tp, tf = tbuilt[0], tbuilt[1]
    a, b = list(_flat(tp)), list(_flat(jp))
    assert len(a) == len(b)
    for u, v in zip(a, b):
        np.testing.assert_allclose(u, v, rtol=1e-6, atol=1e-7)
    tpd = params_from_jax(jp, device="cpu")
    jpd = jax.device_put(jp)
    return (lambda x: jf(x, jpd)), (lambda x: tf(x, tpd))


def _err(jf, tf, x, nvs=None):
    """Max |port - jax| over each track's valid part."""
    if nvs is None:
        want = np.asarray(jax.jit(jax.vmap(jf))(jnp.asarray(x)))
        got = tf(torch.from_numpy(x)).numpy()
        return float(np.max(np.abs(got - want)))

    def one(xi, nvi):
        with jvc.valid_length(nvi):
            return jf(xi)

    want = np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(x),
                                             jnp.asarray(nvs, jnp.int32)))
    with tvc.valid_length(torch.tensor(nvs, dtype=torch.int32)):
        got = tf(torch.from_numpy(x)).numpy()
    return max(float(np.max(np.abs(got[b, ..., :nv] - want[b, ..., :nv])))
               for b, nv in enumerate(nvs))


JS, TS = JSpec(sr=SR, n=N), GraphSpec(sr=SR, n=N)
CPU = dict(device="cpu")

MODULES = {
    "rumble": lambda: (jeq.build_rumble_filter(JS, 60.0),
                       teq.build_rumble_filter(TS, 60.0, **CPU)),
    "deesser": lambda: (jdyn.build_deesser(JS),
                        tdyn.build_deesser(TS, **CPU)),
    "dynamic_eq": lambda: (jdyn.build_dynamic_eq(JS),
                           tdyn.build_dynamic_eq(TS, **CPU)),
    "transient_designer": lambda: (
        jdyn.build_transient_designer(JS, 1.3, 0.85),
        tdyn.build_transient_designer(TS, 1.3, 0.85)),
    "maximizer_transient_aware": lambda: (
        jdyn.build_maximizer_transient_aware(JS, 0.5),
        tdyn.build_maximizer_transient_aware(TS, 0.5)),
    "target_then_dynamics": lambda: (
        jfused.build_target_then_dynamics(
            JS, crossovers_hz=[214.0, 2230.0, 10000.0]),
        tfused.build_target_then_dynamics(
            TS, crossovers_hz=[214.0, 2230.0, 10000.0], **CPU)),
    "final_balance_then_style": lambda: (
        jeq.build_final_balance_then_style(JS, "edm"),
        teq.build_final_balance_then_style(TS, "edm", **CPU)),
    "exciter": lambda: (jexc.build_harmonic_exciter(JS, 0.6),
                        texc.build_harmonic_exciter(TS, 0.6, **CPU)),
    "imager": lambda: (jstereo.build_stereo_imager(JS, width=1.25),
                       tstereo.build_stereo_imager(TS, width=1.25, **CPU)),
    "imager_bands_stereoize": lambda: (
        jstereo.build_stereo_imager(JS, 1.1, 12.0, 0.2, [0.8, 1.0, 1.2, 1.4]),
        tstereo.build_stereo_imager(TS, 1.1, 12.0, 0.2, [0.8, 1.0, 1.2, 1.4],
                                    **CPU)),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_module_matches_jax(name):
    jf, tf = _pair(*MODULES[name]())
    x = _batch(sorted(MODULES).index(name), nvs=NVS)
    err = max(_err(jf, tf, x), _err(jf, tf, x, NVS))
    assert err <= ATOL, f"{name}: max error {err}"


def test_pointwise_ops_match_jax():
    x = _batch(20, nvs=NVS) * 2.5
    errs = []
    for mix in (0.25, 0.005):
        errs.append(_err(lambda v: jbasic.parallel_compression(v, mix=mix),
                         lambda v: tbasic.parallel_compression(v, mix=mix),
                         x))
    for mode in ("warm", "tape", "tube", "transistor", "digital", "other"):
        errs.append(_err(lambda v: jbasic.exciter_saturate(v, mode, 2.5),
                         lambda v: tbasic.exciter_saturate(v, mode, 2.5), x))
    xd = x + np.array([[0.04], [-0.03]], np.float32)
    for b, nv in enumerate(NVS):
        xd[b, :, nv:] = 0.0
    for nvs in (None, NVS):
        errs.append(_err(jbasic.remove_dc_offset, tbasic.remove_dc_offset, xd,
                         nvs))
    assert max(errs) <= ATOL
    bad = x.copy()
    bad[1, 0, 3] = np.nan
    fin, peak = tbasic.validate_stats(torch.from_numpy(bad))
    jfin, jpeak = jax.vmap(jbasic.validate_stats)(jnp.asarray(bad))
    assert fin.tolist() == np.asarray(jfin).tolist() == [True, False, True]
    np.testing.assert_array_equal(peak.numpy(), np.asarray(jpeak))


def test_constants_and_bell_design_match_jax():
    from amw_tpu import constants as jc
    from amw_tpu.ops import design as jdesign

    for name in ("DENOISE_PRESETS", "DYNAMIC_EQ_MASTERING_BANDS"):
        assert getattr(tconst, name) == getattr(jc, name), name
    for w0, bw in ((0.005, 1.0), (0.3, 1.4), (0.55, 0.8)):
        for a, b in zip(tdesign.iirpeak_ba(w0, bw), jdesign.iirpeak_ba(w0, bw)):
            np.testing.assert_array_equal(a, b)


def test_oversampled_exciter_raises():
    """The exciter at ``oversample`` 2 raised while the resampler was not
    ported; it now builds and matches the JAX package on a padded batch
    (more cases in tests/test_torch_resample.py).  The port is fed the
    JAX params, whose resampler slots hold Bluestein tables it ignores."""
    jp, jfn = jexc.build_harmonic_exciter(JS, 0.6, oversample=2)
    tfn = texc.build_harmonic_exciter(TS, 0.6, oversample=2, **CPU)[1]
    jpd, tpd = jax.device_put(jp), params_from_jax(jp, **CPU)
    x = _batch(11, nvs=NVS)
    err = _err(lambda v: jfn(v, jpd), lambda v: tfn(v, tpd), x, NVS)
    assert err <= ATOL


# ---------------------------------------------------------------------------
# the envelope kernels' plain versions against the Pallas kernels, interpret


def _interpret():
    from jax.experimental import pallas as pl

    return mock.patch.object(pl, "pallas_call",
                             functools.partial(pl.pallas_call,
                                               interpret=True))


def test_env_rows_plain_matches_env_pallas():
    """Kernel 3's function: one sequence per row, env[0] = v[0]."""
    rng = np.random.default_rng(21)
    wm = np.abs(rng.standard_normal((128, 2048))).astype(np.float32)
    att, rel = jscan.ar_coefs(SR, 0.005, 0.1)
    with _interpret():
        want = np.asarray(jscan._env_pallas(jnp.asarray(wm), att, rel))
    got = tscan.env_rows_plain(torch.from_numpy(wm), att, rel).numpy()
    np.testing.assert_allclose(got, want, atol=ENV_ATOL)
    assert np.array_equal(got[:, 0], wm[:, 0])


def test_env_scan_plain_matches_win_scan_pallas():
    """Kernel 2''s function: the chunked envelope (warm-up + body views) at
    the JAX geometry, envelope mode (no gain map, no mask)."""
    rows, n = 2, 8192
    rng = np.random.default_rng(22)
    v = np.abs(0.5 * rng.standard_normal((rows, n))).astype(np.float32)
    att, rel = jscan.ar_coefs(SR, 0.0005, 0.002)
    W, C = 2048, 2048  # multiples of the Pallas time block, W > warm-up
    assert W >= jscan.warmup_len(att, rel)
    K = n // C
    P, A = jscan._win_views(jnp.asarray(v), W, C, K)
    M = rows * K
    with _interpret():
        want = np.asarray(jscan._win_scan_pallas(
            jnp.pad(P, ((0, 128 - M), (0, 0))),
            jnp.pad(A, ((0, 128 - M), (0, 0))), attack=att, release=rel,
            groups=1))[:M].reshape(rows, n)
    got = tscan.env_scan_plain(torch.from_numpy(v), W, C, K, att, rel).numpy()
    np.testing.assert_allclose(got, want, atol=ENV_ATOL)


@pytest.mark.parametrize("n,ballistics", [
    (30000, (0.005, 0.1)),     # short route in both packages
    (120000, (0.0005, 0.005)),  # chunked in both, different geometries
])
def test_envelope_follower_matches_jax(n, ballistics):
    rng = np.random.default_rng(23)
    v = np.abs(0.3 * rng.standard_normal((3, n))).astype(np.float32)
    att, rel = jscan.ar_coefs(SR, *ballistics)
    short = tscan.short_route(n, tscan.warmup_len(att, rel))
    assert short == (n <= max(2 * jscan.warmup_len(att, rel), 2 * 16384))
    want = np.asarray(jscan.envelope_follower(jnp.asarray(v), att, rel))
    got = tscan.envelope_follower(torch.from_numpy(v), att, rel).numpy()
    np.testing.assert_allclose(got, want, atol=ENV_ATOL)
