"""The full v2 mastering job (counterpart of ``amw_tpu/models/v2_job.py``):
PRE pro-modules → chain → POST pro-modules → fade-in, with the
before/after loudness and the validation stats of every track.

Mirrors ``_run_mastering_job_v2`` (routers/mastering.py:443-637): PRE =
[rumble_filter] [spectral_denoise] [de-esser]; POST = [transient_designer]
[parallel_compression] [dynamic_eq] [true_peak_limiter]; then the 6 ms
output fade-in.  Vocal isolation is not a stage of the graph: the engine
(``amw_tpu_torch/runtime/engine.py``, as ``amw_tpu/runtime/engine.py``)
runs the separator on the decoded track before the graph and drops
``apply_vocal_isolation`` from the pro dict, so asking the graph for it
raises ``NotImplementedError`` telling the caller to go through the
engine.  Given a job's token (``prog_tok``), the graph reports each
finished stage to ``runtime/progress.py``, as the JAX graph's host
callbacks do; the JAX builder's ``stage_ticks`` switch, which compiles
those callbacks in, has no counterpart: one graph serves jobs with and
without a token.
"""

from __future__ import annotations

import torch

from .. import resolve_device
from ..constants import DENOISE_PRESETS
from ..convert import to_device
from ..ops import basic, fft_staged, meters, validctx
from ..ops.dynamics import (build_deesser, build_dynamic_eq,
                            build_transient_designer)
from ..ops.eq import build_rumble_filter
from ..ops.spectral import build_spectral_denoise
from ..ops.tplimit import build_true_peak_limiter
from ..runtime import progress
from ..spec import GraphSpec
from .chain import as_batch, build_chain_ops, default_chain_config


def resolve_denoise(pro: dict) -> tuple[float, float]:
    """(strength, noise_percentile) per the reference's preset-else-strength
    resolution (mastering.py:503-513)."""
    preset = (pro.get("denoise_preset") or "").strip().lower()
    if preset in DENOISE_PRESETS:
        return DENOISE_PRESETS[preset]
    strength = float(pro.get("denoise_strength", 0) or 0)
    if strength > 0:
        return strength, float(pro.get("denoise_noise_percentile", 15.0))
    return 0.0, 15.0


def build_v2_job_graph(spec: GraphSpec, chain_config: dict | None,
                       pro: dict | None = None, target_lufs: float = -14.0,
                       style: str = "standard", *, device=None):
    """Returns ``(params, fn, stage_names)``.  ``params`` is the JAX
    package's nesting (stage params, then ``[[Hk]]``) as tensors on
    ``device`` (default ``cuda``); ``fn(x, params, n_valid=None,
    prog_tok=None)`` masters ``x`` [C, N] or a bucket-padded batch
    [B, C, N] (``n_valid`` [B]) and returns ``dict(out, before_lufs,
    after_lufs, peak, finite)``: the output like ``x`` and, per track, the
    loudness before and after, the peak and whether every sample is finite
    ([B], or scalars for one [C, N] track).  With ``prog_tok`` (a token of
    ``progress.register``) each finished stage is reported to
    ``runtime.progress.stage_done``."""
    dev = resolve_device(device)
    pro = pro or {}
    if pro.get("apply_vocal_isolation"):
        raise NotImplementedError(
            "apply_vocal_isolation is not a stage of the v2 graph: the "
            "engine separates the vocals before the graph and drops the "
            "flag, as amw_tpu/runtime/engine.py does; go through "
            "amw_tpu_torch.runtime.engine.MasteringEngine.master_v2_bytes")
    stages = []

    def add(name, built):
        stages.append((name, list(built[0]), built[1]))

    if pro.get("rumble_enabled"):
        add("rumble_filter", build_rumble_filter(
            spec, float(pro.get("rumble_cutoff", 80.0)), device=dev))
    strength, noise_pct = resolve_denoise(pro)
    if strength > 0.01:
        add("spectral_denoise", build_spectral_denoise(
            spec, strength, noise_pct, device=dev))
    if pro.get("deesser_enabled"):
        add("deesser", build_deesser(
            spec, threshold_db=float(pro.get("deesser_threshold", -6.0)),
            freq_hi=float(pro.get("deesser_freq_hi", 9000.0)), device=dev))

    config = chain_config or default_chain_config(target_lufs=target_lufs,
                                                  style=style)
    ids, chain_params, chain_fns, _ = build_chain_ops(
        spec, config, target_lufs=target_lufs, style=style, device=dev)
    for mid, p, f in zip(ids, chain_params, chain_fns):
        stages.append((f"chain:{mid}", p, f))
    # chain.process final clip/NaN scrub (chain.py:93-94)
    add("chain_finalize", ([], lambda x, p: basic.finalize_clip(x)))

    ta = pro.get("transient_attack")
    ts = pro.get("transient_sustain", 1.0)
    if ta is not None and (abs(float(ta) - 1.0) > 0.02
                           or abs(float(ts) - 1.0) > 0.02):
        add("transient_designer",
            build_transient_designer(spec, float(ta), float(ts)))
    pmix = pro.get("parallel_mix", 0)
    if pmix is not None and float(pmix) > 0:
        add("parallel_compression",
            ([], lambda x, p, _m=float(pmix):
             basic.parallel_compression(x, mix=_m)))
    if pro.get("dynamic_eq_enabled"):
        add("dynamic_eq", build_dynamic_eq(spec, device=dev))
    if pro.get("true_peak_enabled"):
        # the last gain stage before the fade, so nothing after it can
        # raise the true peak again
        add("true_peak_limiter", build_true_peak_limiter(
            spec, ceiling_db=float(pro.get("true_peak_ceiling_db", -1.5)),
            device=dev))
    add("output_fade_in",
        ([], lambda x, p: basic.output_edge_fade_in(x, spec.sr, 6.0)))

    # the in-graph loudness meter (before / after)
    settle = meters.k_weight_settle(spec.sr)
    nfft = fft_staged.site_plan(spec.n + settle, dev)[0]
    Hk = meters.k_weight_response(spec.sr, nfft)
    try:
        plan = meters.plan_blocks(spec.sr, spec.n)
    except ValueError:
        plan = None

    names = [s[0] for s in stages]
    params = to_device([s[1] for s in stages] + [[Hk]], dev)
    fns = [s[2] for s in stages]

    def loudness(x, Hk_d, nv):
        if plan is None:
            return torch.full((x.shape[0],), -1e9, dtype=torch.float32,
                              device=x.device)
        return meters.integrated_lufs(x, Hk_d, nfft, plan, n_valid=nv)

    def fn(x, params, n_valid=None, prog_tok=None):
        xb, nv, single = as_batch(x, n_valid)
        Hk_d = params[-1][0]
        before = loudness(xb, Hk_d, nv)
        y = xb
        with validctx.valid_length(nv):
            for i, (f, p) in enumerate(zip(fns, params[:-1])):
                # keep the bucket padding silent between stages
                y = validctx.mask_tail(f(y, p))
                if prog_tok is not None:
                    progress.stage_done(prog_tok, i, y.device)
        after = loudness(y, Hk_d, nv)
        finite, peak = basic.validate_stats(y)
        res = {"out": y, "before_lufs": before, "after_lufs": after,
               "peak": peak, "finite": finite}
        if single:
            res = {k: v[0] for k, v in res.items()}
        return res

    return params, fn, names
