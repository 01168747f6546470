"""The port's v2 mastering job (default ``standard`` chain + the pro set)
against the JAX package's on the CPU, on the XLA-FFT / ``torch.fft`` route,
and the chain's build semantics.

Bars (the repo's parity bars, BASELINE.md): max sample error <= -90 dBFS
and integrated loudness within 0.1 LU; the graph's own before/after
loudness within 0.01 LU; padded tails exactly zero.  The staged-FFT route
is held in tests/test_torch_v2_staged.py.
"""

import jax
import numpy as np
import pytest
import torch

from amw_tpu import refimpl
from amw_tpu.models import chain as jchain
from amw_tpu.models import v2_job as jv2
from amw_tpu.spec import GraphSpec as JSpec
from amw_tpu_torch import GraphSpec
from amw_tpu_torch.convert import params_from_jax
from amw_tpu_torch.models import chain as tchain
from amw_tpu_torch.models import v2_job as tv2
from amw_tpu_torch.ops import fft_staged, meters

SR = 44100
BAR_DBFS = -90.0
BAR_LU = 0.1
BAR_METER_LU = 0.01
PRO = {"rumble_enabled": True, "rumble_cutoff": 60.0,
       "deesser_enabled": True, "transient_attack": 1.3,
       "transient_sustain": 0.85, "parallel_mix": 0.25,
       "dynamic_eq_enabled": True}
N = 2 * SR
NVS = [N, int(1.6 * SR)]


def track(n, seed):
    g = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = (0.28 * np.sin(2 * np.pi * 110 * t)
         + 0.12 * np.sin(2 * np.pi * 997 * t)
         + 0.06 * np.sin(2 * np.pi * 6100 * t)
         + 0.05 * g.standard_normal(n))
    env = 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 0.25 * t))
    return np.clip(np.stack([x * env, 0.85 * x * env]), -0.99,
                   0.99).astype(np.float32)


def flat(p):
    if isinstance(p, (list, tuple)):
        for q in p:
            yield from flat(q)
    else:
        yield np.asarray(p)


def db(err):
    return 20 * np.log10(max(err, 1e-30))


def run_pair(n, nvs, seed):
    """Both jobs at bucket length ``n``: the exact-length clip (``nvs`` None)
    or a padded batch (the JAX graph under ``vmap``), after checking that
    the two builds' stage names and params agree.  Returns (want, got,
    x)."""
    jp, jfn, jnames = jv2.build_v2_job_graph(JSpec(sr=SR, n=n, channels=2),
                                             None, PRO, -14.0, "standard")
    tp, tfn, tnames = tv2.build_v2_job_graph(GraphSpec(sr=SR, n=n,
                                                       channels=2),
                                             None, PRO, -14.0, "standard",
                                             device="cpu")
    assert tnames == jnames
    a, b = list(flat(tp)), list(flat(jp))
    assert len(a) == len(b)
    for u, v in zip(a, b):
        assert u.shape == v.shape and u.dtype == v.dtype
        np.testing.assert_allclose(u, v, rtol=1e-6, atol=1e-7)
    pt = params_from_jax(jp, device="cpu")
    if nvs is None:
        x = track(n, seed)
        want = jfn(x, jax.device_put(jp))
        got = tfn(torch.from_numpy(x), pt)
    else:
        x = np.stack([track(n, seed + i) for i in range(len(nvs))])
        for i, nv in enumerate(nvs):
            x[i, :, nv:] = 0.0
        want = jax.jit(jax.vmap(jfn, in_axes=(0, None, 0)))(
            x, jax.device_put(jp), np.asarray(nvs, np.int32))
        got = tfn(torch.from_numpy(x), pt, torch.tensor(nvs))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    return want, got, x


def assert_parity(want, got, x, nvs):
    assert got["out"].shape == x.shape
    outs = [(got["out"], want["out"], x.shape[-1])] if nvs is None else [
        (got["out"][b], want["out"][b], nv) for b, nv in enumerate(nvs)]
    for g, w, nv in outs:
        assert db(float(np.max(np.abs(g - w)))) <= BAR_DBFS
        assert np.all(g[:, nv:] == 0.0)
        d_lu = abs(refimpl.integrated_lufs(g[:, :nv], SR)
                   - refimpl.integrated_lufs(w[:, :nv], SR))
        assert d_lu <= BAR_LU
    for k in ("before_lufs", "after_lufs"):
        assert got[k].shape == want[k].shape
        assert np.max(np.abs(got[k] - want[k])) <= BAR_METER_LU, k
    np.testing.assert_array_equal(got["finite"], want["finite"])
    assert np.max(np.abs(got["peak"] - want["peak"])) <= 1e-5


def test_exact_length_clip_matches_jax():
    want, got, x = run_pair(N, None, 1)
    assert got["before_lufs"].shape == ()
    assert_parity(want, got, x, None)


def test_bucket_padded_batch_matches_jax():
    want, got, x = run_pair(N, NVS, 2)
    assert got["after_lufs"].shape == (2,)
    assert_parity(want, got, x, NVS)


# ---------------------------------------------------------------------------
# build semantics


def test_default_config_and_denoise_resolution_match_jax():
    for style in ("standard", "edm", "podcast"):
        assert (tchain.default_chain_config(-12.0, style)
                == jchain.default_chain_config(-12.0, style))
    for pro in ({}, {"denoise_preset": "Medium"}, {"denoise_strength": 0.3},
                {"denoise_strength": 0.3, "denoise_noise_percentile": 9.0},
                {"denoise_preset": "nope", "denoise_strength": 0}):
        assert tv2.resolve_denoise(pro) == jv2.resolve_denoise(pro)


@pytest.mark.parametrize("module", [
    {"id": "reverb", "enabled": True},
    {"id": "true_peak_limiter", "enabled": True},
    {"id": "target_curve", "phase_mode": "linear_phase"},
    {"id": "exciter", "exciter_db": 0.6, "oversample": 2},
    {"id": "dynamics", "compressor": "envelope"},
], ids=["reverb", "true_peak", "linear_phase", "exciter_os2",
        "envelope_compressor"])
def test_unported_module_raises_not_bypassed(module):
    """The modules the port once lacked (each raised and named its
    ``amw_tpu`` module, and the chain never recorded it as bypassed) are
    ported: each builds under its own id, as in the JAX package, and is
    not bypassed either, alone and inside the default config."""
    spec = GraphSpec(sr=SR, n=SR, channels=2)
    cfg = tchain.default_chain_config()
    cfg["modules"].insert(3, module)
    ids, _, _, byp = tchain.build_chain_ops(spec, {"modules": [module]},
                                            device="cpu")
    jids, _, _, jbyp = jchain.build_chain_ops(
        JSpec(sr=SR, n=SR, channels=2), {"modules": [module]})
    assert ids == jids == [module["id"]] and byp == jbyp == []
    names = tv2.build_v2_job_graph(spec, cfg, device="cpu")[2]
    assert names == jv2.build_v2_job_graph(JSpec(sr=SR, n=SR, channels=2),
                                           cfg)[2]
    assert f"chain:{module['id']}" in names


def test_real_build_failure_is_bypassed_as_in_jax():
    """A module whose build fails for its input (loudness of a track shorter
    than the 400 ms gating block) is bypassed, as in the JAX package."""
    cfg = {"modules": [{"id": "dc_offset"}, {"id": "normalize_lufs"},
                       {"id": "style_eq", "style": "edm"}]}
    n = int(0.3 * SR)
    ids, _, _, byp = tchain.build_chain_ops(GraphSpec(sr=SR, n=n), cfg,
                                            device="cpu")
    jids, _, _, jbyp = jchain.build_chain_ops(JSpec(sr=SR, n=n), cfg)
    assert ids == jids == ["dc_offset", "style_eq"]
    assert [m for m, _ in byp] == [m for m, _ in jbyp] == ["normalize_lufs"]


@pytest.mark.parametrize("pro", [
    {"denoise_strength": 0.5}, {"denoise_preset": "vocal"},
    {"true_peak_enabled": True}, {"apply_vocal_isolation": True}])
def test_unported_pro_stage_raises(pro):
    """The pro stages the port once lacked build where the JAX package puts
    them, under its stage names: the spectral denoiser first
    (tests/test_torch_spectral.py holds its output), the true-peak limiter
    after the dynamic EQ (tests/test_torch_v2_finish.py).  Vocal isolation
    is no stage of the graph: the JAX engine runs the separator before it
    (amw_tpu/runtime/engine.py), so the port's graph raises and names the
    engine (tests/test_torch_not_ported.py)."""
    spec = GraphSpec(sr=SR, n=SR)
    if pro.get("apply_vocal_isolation"):
        with pytest.raises(NotImplementedError, match="engine.py"):
            tv2.build_v2_job_graph(spec, None, pro, device="cpu")
        return
    names = tv2.build_v2_job_graph(spec, None, pro, device="cpu")[2]
    assert names == jv2.build_v2_job_graph(JSpec(sr=SR, n=SR), None, pro)[2]
    if pro.get("true_peak_enabled"):
        assert names[-2:] == ["true_peak_limiter", "output_fade_in"]
    else:
        assert names[0] == "spectral_denoise"


def test_compile_chain_matches_jax():
    """The compiled default chain with an amount blend, cached."""
    cfg = tchain.default_chain_config(style="edm")
    cfg["modules"][0]["amount"] = 0.5  # dc at 50 %: no dc+peak fusion
    spec, jspec = GraphSpec(sr=SR, n=SR), JSpec(sr=SR, n=SR)
    cc = tchain.compile_chain(spec, cfg, device="cpu")
    assert tchain.compile_chain(spec, cfg, device="cpu") is cc
    jc = jchain.compile_chain(jspec, cfg)
    assert cc.module_ids == jc.module_ids
    assert cc.module_ids[:2] == ["dc_offset", "peak_guard"]
    x = track(SR, 5) + np.float32(0.02)
    err = float(np.max(np.abs(cc(x) - jc(x))))
    assert db(err) <= BAR_DBFS


def test_meters_build_for_cuda_at_180s():
    """The loudness meters plan the TPU size on CUDA and run torch.fft there
    (the JAX package runs them on XLA's FFT on a TPU): nothing refuses a
    plan the staged FFT takes.  Host-side params only, no GPU needed."""
    spec = GraphSpec(sr=SR, n=180 * SR, channels=2)
    cuda = torch.device("cuda")
    params, _ = meters.build_normalize_lufs(spec, -14.0, device=cuda)
    nfft = fft_staged.site_plan(spec.n + meters.k_weight_settle(SR), cuda)[0]
    assert nfft == 1 << 23
    assert params[0].shape == (2, (1 << 22) + 1)
    assert fft_staged.site_plan(1_500_000, cuda) == (1 << 21, True)
    assert fft_staged.site_plan(1_500_000, "cpu") == (3 << 19, False)


def test_v2_job_builds_for_cuda_at_30s(monkeypatch):
    """The whole job's host-side build for CUDA at 30 s: every fast
    zero-phase pass carries the staged params (permuted response + plan
    tables), as the JAX package's Pallas route does on a TPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(tv2, "to_device", lambda p, dev: p)
    params, _, names = tv2.build_v2_job_graph(
        GraphSpec(sr=SR, n=30 * SR, channels=2), None, PRO, device="cuda")
    staged = [p for p in flat(params) if p.shape == (2, 1 << 21)]
    # rumble 1 + de-esser 1 + dynamic EQ 8 fast passes, and the two fused
    # sites' stacked responses [K, 2, nfft]
    assert len(staged) == 10
    assert [p.shape[0] for p in flat(params)
            if p.ndim == 3 and p.shape[1:] == (2, 1 << 21)] == [4, 2]
    assert names[0] == "rumble_filter" and names[-2] == "dynamic_eq"
    assert params[-1][0].shape == (2, (1 << 20) + 1)  # Hk, torch.fft route
