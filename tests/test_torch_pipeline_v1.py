"""The port's v1 ``standard`` chain against the JAX package's on the CPU.

Bars (the repo's parity bars, BASELINE.md): max sample error <= -90 dBFS
and integrated loudness within 0.1 LU, for an exact-length clip and for a
bucket-padded batch with per-track valid lengths.  The chain runs on both
FFT routes: ``torch.fft`` against XLA's FFT, and the staged FFT (forced on
the CPU, plain versions of its kernels) against the JAX package's Pallas
FFT (forced, interpret mode).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from amw_tpu import refimpl
from amw_tpu.models.pipeline_v1 import build_v1_pipeline as jax_build
from amw_tpu.spec import GraphSpec as JSpec
from amw_tpu_torch import GraphSpec
from amw_tpu_torch.convert import params_from_jax
from amw_tpu_torch.models import build_v1_pipeline
from amw_tpu.ops import fft_pallas as jfp
from amw_tpu_torch.ops import design, fft_staged, fused

SR = 44100
BAR_DBFS = -90.0
BAR_LU = 0.1


def _track(dur, seed):
    g = np.random.default_rng(seed)
    n = int(SR * dur)
    t = np.arange(n) / SR
    x = (0.28 * np.sin(2 * np.pi * 110 * t)
         + 0.12 * np.sin(2 * np.pi * 997 * t)
         + 0.06 * np.sin(2 * np.pi * 6100 * t)
         + 0.05 * g.standard_normal(n))
    env = 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 0.25 * t))
    return np.clip(np.stack([x * env, 0.85 * x * env]), -0.99,
                   0.99).astype(np.float32)


def _flat(p):
    if isinstance(p, (list, tuple)):
        for q in p:
            yield from _flat(q)
    else:
        yield np.asarray(p)


@pytest.fixture(scope="module")
def chain_3s():
    n = 3 * SR
    jp, jfn, jnames = jax_build(JSpec(sr=SR, n=n, channels=2))
    tp, tfn, tnames = build_v1_pipeline(GraphSpec(sr=SR, n=n, channels=2),
                                        device="cpu")
    return jp, jfn, jnames, tp, tfn, tnames


def _db(err):
    return 20 * np.log10(max(err, 1e-30))


def test_params_and_stages_match_jax(chain_3s):
    jp, _, jnames, tp, _, tnames = chain_3s
    assert tnames == jnames
    a, b = list(_flat(tp)), list(_flat(params_from_jax(jp, device="cpu")))
    assert len(a) == len(b) == len(list(_flat(jp)))
    for u, v in zip(a, b):
        assert u.shape == v.shape and u.dtype == v.dtype
        np.testing.assert_allclose(u, v, rtol=1e-6, atol=1e-7)


def test_exact_length_clip_matches_jax(chain_3s):
    jp, jfn, _, _, tfn, _ = chain_3s
    x = _track(3.0, 1)
    want = np.asarray(jfn(x, jax.device_put(jp)))
    got = tfn(torch.from_numpy(x), params_from_jax(jp, device="cpu")).numpy()
    assert got.shape == x.shape
    assert _db(float(np.max(np.abs(got - want)))) <= BAR_DBFS
    d_lu = abs(refimpl.integrated_lufs(got, SR)
               - refimpl.integrated_lufs(want, SR))
    assert d_lu <= BAR_LU


def test_bucket_padded_batch_matches_jax(chain_3s):
    jp, jfn, _, _, tfn, _ = chain_3s
    n = 3 * SR
    nvs = [n, int(2.3 * SR)]
    xb = np.stack([_track(3.0, 2), _track(3.0, 3)])
    xb[1, :, nvs[1]:] = 0.0
    want = np.asarray(jax.jit(jax.vmap(jfn, in_axes=(0, None, 0)))(
        xb, jax.device_put(jp), np.asarray(nvs, np.int32)))
    got = tfn(torch.from_numpy(xb), params_from_jax(jp, device="cpu"),
              torch.tensor(nvs)).numpy()
    assert got.shape == xb.shape
    for b, nv in enumerate(nvs):
        err = float(np.max(np.abs(got[b] - want[b])))
        assert _db(err) <= BAR_DBFS, (b, err)
        assert np.all(got[b, :, nv:] == 0.0)
        d_lu = abs(refimpl.integrated_lufs(got[b, :, :nv], SR)
                   - refimpl.integrated_lufs(want[b, :, :nv], SR))
        assert d_lu <= BAR_LU, (b, d_lu)


def test_short_clip_unfused_path_matches_jax():
    """Below ~0.6 s the fusions do not apply: target curve, unfused
    de-esser and normalize LUFS run as separate two-pass stages."""
    n = int(0.5 * SR)
    jp, jfn, jnames = jax_build(JSpec(sr=SR, n=n, channels=2))
    _, tfn, tnames = build_v1_pipeline(GraphSpec(sr=SR, n=n, channels=2),
                                       device="cpu")
    assert tnames == jnames and "deesser" in tnames
    x = _track(0.5, 4)
    want = np.asarray(jfn(x, jax.device_put(jp)))
    got = tfn(torch.from_numpy(x), params_from_jax(jp, device="cpu")).numpy()
    assert _db(float(np.max(np.abs(got - want)))) <= BAR_DBFS


@pytest.mark.parametrize("kw", [
    {"denoise_strength": 0.5},
    {"reference_env": np.ones(4097, np.float32)},
    {"compressor": "envelope"},
])
def test_unported_stage_raises(kw):
    """The v1 stages that raised while unported (the envelope compressor,
    the spectral denoiser, the reference match) are ported: each pipeline
    builds and matches the JAX package's."""
    spec = GraphSpec(sr=SR, n=SR, channels=2)
    jp, jfn, jnames = jax_build(JSpec(sr=SR, n=SR, channels=2), **kw)
    _, tfn, tnames = build_v1_pipeline(spec, device="cpu", **kw)
    assert tnames == jnames
    x = _track(1.0, 10)
    want = np.asarray(jfn(x, jax.device_put(jp)))
    got = tfn(torch.from_numpy(x), params_from_jax(jp, device="cpu")).numpy()
    assert _db(float(np.max(np.abs(got - want)))) <= BAR_DBFS


@pytest.mark.parametrize("kw", [
    {"transient_attack": 1.5},
    {"style": "edm", "target_lufs": -9.0},  # exciter, imager, parallel
])
def test_optional_stage_matches_jax(kw):
    n = int(1.5 * SR)
    jp, jfn, jnames = jax_build(JSpec(sr=SR, n=n, channels=2), **kw)
    _, tfn, tnames = build_v1_pipeline(GraphSpec(sr=SR, n=n, channels=2),
                                       device="cpu", **kw)
    assert tnames == jnames
    x = _track(1.5, 9)
    want = np.asarray(jfn(x, jax.device_put(jp)))
    got = tfn(torch.from_numpy(x), params_from_jax(jp, device="cpu")).numpy()
    assert _db(float(np.max(np.abs(got - want)))) <= BAR_DBFS
    assert abs(refimpl.integrated_lufs(got, SR)
               - refimpl.integrated_lufs(want, SR)) <= BAR_LU


def test_fft_guard_refuses_pallas_plans_on_cuda():
    """On CUDA the three fused sites and every fast zero-phase pass take the
    TPU plan on the staged FFT (2^21 at 30 s, where the CPU rule gives
    3·2^19): ``make_zp`` and ``make_zp_from_power`` carry the permuted
    response and the plan tables, as the JAX package's Pallas route does;
    exact two-pass passes keep ``torch.fft``.  The builders compute
    host-side params only, so no GPU is needed."""
    cuda = torch.device("cuda")
    spec5 = GraphSpec(sr=SR, n=5 * SR, channels=2)
    p5 = fused.build_target_then_deesser(spec5, device=cuda)[0]
    assert p5[0].shape == (2, 2 ** 17 + 1)  # torch.fft route, rFFT bins
    assert fused.build_normalize_then_final(spec5, -14.0, "standard",
                                            device=cuda) is not None
    for dur, plan in ((5.8, 2 ** 19), (30.0, 2 ** 21)):
        spec = GraphSpec(sr=SR, n=int(dur * SR), channels=2)
        p = fused.build_target_then_deesser(spec, device=cuda)[0]
        assert p[0].shape == (2, 2, plan)
        assert len(p[3]) == 8  # the staged FFT's plan tables
        # the CPU rule keeps the JAX package's CPU plan
        assert fused.build_target_then_deesser(spec, device="cpu") is not None
    spec30 = GraphSpec(sr=SR, n=30 * SR, channels=2)
    from amw_tpu_torch.ops import bands, zphase
    p_dyn = bands.build_dynamics(spec30, device=cuda)[0]
    assert p_dyn[0].shape == (4, 2, 2 ** 21)
    p_nf = fused.build_normalize_then_final(spec30, -14.0, "standard",
                                            device=cuda)[0]
    assert p_nf[0].shape == (2, 2, 2 ** 21)
    assert p_nf[0].shape[-1] == fft_staged.site_plan(spec30.n, cuda)[0]
    assert fft_staged.site_plan(spec30.n, "cpu") == (3 * 2 ** 19, False)
    ba = design.butter_ba_norm(2, 0.01, "high")
    zp = zphase.make_zp(dataclasses.replace(spec30, exact=False), [ba],
                        device=cuda)
    assert zp.staged and zp.nfft == 2 ** 21
    assert zp.params[0].shape == (2, 2 ** 21) and len(zp.params[1]) == 8
    hz = zphase.make_zp(spec30, [ba], device=cuda)  # hybrid: fast + edges
    assert hz.fast.staged and not hz.small.staged
    assert not zphase.make_zp(spec30, [ba], device="cpu").fast.staged
    zp = zphase.make_zp_from_power(spec30, np.ones(2 ** 20 + 1), 2 ** 21, 6,
                                   100, device=cuda)
    assert zp.staged and zp.params[0].shape == (2, 2 ** 21)
    exact = zphase.make_zp(dataclasses.replace(spec30, hybrid=False), [ba],
                           device=cuda)
    assert exact.exact and not exact.staged and exact.nfft == 2 ** 21
    assert design.tpu_fft_plan(1_500_000) == 2 ** 21
    assert design.next_fft_size(1_500_000) == 3 * 2 ** 19


def test_v1_chain_builds_for_cuda_at_30s(monkeypatch):
    """The whole chain's host-side build for CUDA at 30 s raises nothing:
    every full-length FFT is one of the three fused sites on the staged
    plan.  (The device upload is skipped: no GPU here.)"""
    from amw_tpu_torch.models import pipeline_v1

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(pipeline_v1, "to_device", lambda p, dev: p)
    params, _, names = build_v1_pipeline(
        GraphSpec(sr=SR, n=30 * SR, channels=2), device="cuda")
    plans = [p[0].shape for p in params if len(p) and np.ndim(p[0]) == 3]
    assert plans == [(2, 2, 2 ** 21), (4, 2, 2 ** 21), (2, 2, 2 ** 21)]
    assert "target_eq+deesser" in names


# ---------------------------------------------------------------------------
# the staged FFT route: a 500 000-sample clip, where all three fused sites
# plan 2^19 (C = 32) on both routes

N_STAGED = 500_000


@pytest.fixture(scope="module")
def staged_chain():
    """Both chains built and run with the staged route forced: the JAX
    package's Pallas FFT in interpret mode, the port's plain versions of
    its kernels.  Records every size the port hands to torch.fft."""
    spec_args = dict(sr=SR, n=N_STAGED, channels=2)
    nvs = [N_STAGED, 411_000]
    x1 = _track(N_STAGED / SR, 5)
    xb = np.stack([_track(N_STAGED / SR, 6), _track(N_STAGED / SR, 7)])
    xb[1, :, nvs[1]:] = 0.0
    sizes = []

    def recording(fn):
        def wrapped(x, n=None, *a, **k):
            sizes.append(x.shape[-1] if n is None else n)
            return fn(x, n, *a, **k)
        return wrapped

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfp, "enabled", jfp.plan_ok)
        for name in ("roundtrip_multi", "roundtrip_multi_reduce"):
            mp.setattr(jfp, name, functools.partial(getattr(jfp, name),
                                                    interpret=True))
        mp.setattr(fft_staged, "enabled",
                   lambda nfft, device: fft_staged.plan_ok(nfft))
        mp.setattr(torch.fft, "rfft", recording(torch.fft.rfft))
        mp.setattr(torch.fft, "irfft", recording(torch.fft.irfft))
        jp, jfn, jnames = jax_build(JSpec(**spec_args))
        tp, tfn, tnames = build_v1_pipeline(GraphSpec(**spec_args),
                                            device="cpu")
        want1 = np.asarray(jfn(x1, jax.device_put(jp)))
        wantb = np.asarray(jax.jit(jax.vmap(jfn, in_axes=(0, None, 0)))(
            xb, jax.device_put(jp), np.asarray(nvs, np.int32)))
        pj = params_from_jax(jp, device="cpu")
        got1 = tfn(torch.from_numpy(x1), pj).numpy()
        gotb = tfn(torch.from_numpy(xb), pj, torch.tensor(nvs)).numpy()
    return dict(jp=jp, jnames=jnames, tp=tp, tnames=tnames, nvs=nvs,
                x1=x1, want1=want1, got1=got1, xb=xb, wantb=wantb,
                gotb=gotb, sizes=sizes)


def test_staged_params_and_stages_match_jax(staged_chain):
    c = staged_chain
    assert c["tnames"] == c["jnames"]
    fused_sites = [p for p in c["tp"] if len(p) and np.ndim(p[0]) == 3]
    assert [tuple(p[0].shape) for p in fused_sites] == [
        (2, 2, 2 ** 19), (4, 2, 2 ** 19), (2, 2, 2 ** 19)]
    a = list(_flat(c["tp"]))
    b = list(_flat(params_from_jax(c["jp"], device="cpu")))
    assert len(a) == len(b) == len(list(_flat(c["jp"])))
    for u, v in zip(a, b):
        assert u.shape == v.shape and u.dtype == v.dtype
        np.testing.assert_allclose(u, v, rtol=1e-6, atol=1e-7)


def test_staged_exact_length_clip_matches_jax(staged_chain):
    c = staged_chain
    got, want = c["got1"], c["want1"]
    assert got.shape == c["x1"].shape
    assert _db(float(np.max(np.abs(got - want)))) <= BAR_DBFS
    d_lu = abs(refimpl.integrated_lufs(got, SR)
               - refimpl.integrated_lufs(want, SR))
    assert d_lu <= BAR_LU


def test_staged_padded_batch_matches_jax(staged_chain):
    c = staged_chain
    got, want = c["gotb"], c["wantb"]
    assert got.shape == c["xb"].shape
    for b, nv in enumerate(c["nvs"]):
        err = float(np.max(np.abs(got[b] - want[b])))
        assert _db(err) <= BAR_DBFS, (b, err)
        assert np.all(got[b, :, nv:] == 0.0)
        d_lu = abs(refimpl.integrated_lufs(got[b, :, :nv], SR)
                   - refimpl.integrated_lufs(want[b, :, :nv], SR))
        assert d_lu <= BAR_LU, (b, d_lu)


def test_staged_route_sends_no_plan_ok_size_to_torch_fft(staged_chain):
    """With the staged route taken, torch.fft sees only the edge windows'
    small plans: no size that the staged FFT takes."""
    sizes = staged_chain["sizes"]
    assert sizes and max(sizes) < 2 ** 19
    assert not any(fft_staged.plan_ok(s) for s in sizes)
