"""The fixed v1 mastering pipeline (counterpart of
``amw_tpu/models/pipeline_v1.py``).

Mirrors ``run_mastering_pipeline`` (backend/app/pipeline.py:1800-1909):
dc → peak guard → [denoise] → target curve → de-esser → dynamics (4-band
+ maximizer + brickwall) → [parallel compression] → normalize LUFS →
final spectral balance → [reference match] → style EQ → [transient
designer] → [exciter] → [imager] → peak guard → fade-in → clip/scrub.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..constants import STYLE_CONFIGS
from ..convert import to_device
from ..ops import basic, meters, validctx
from ..ops.bands import build_dynamics
from ..ops.dynamics import build_deesser, build_transient_designer
from ..ops.eq import (build_final_spectral_balance, build_style_eq,
                      build_target_curve)
from ..ops.exciter import build_harmonic_exciter
from ..ops.fused import build_normalize_then_final, build_target_then_deesser
from ..ops.spectral import build_reference_match, build_spectral_denoise
from ..ops.stereo import build_stereo_imager
from ..runtime import progress
from ..spec import GraphSpec
from .chain import as_batch


def build_v1_pipeline(
    spec: GraphSpec,
    target_lufs: float = -14.0,
    style: str = "standard",
    denoise_strength: float = 0.0,
    transient_attack: float = 1.0,
    transient_sustain: float = 1.0,
    reference_env: np.ndarray | None = None,
    reference_strength: float = 0.8,
    compressor: str = "soft_knee",
    *,
    device=None,
):
    """Returns ``(params, fn, names)``.  ``params`` is the JAX package's
    nested parameter list as tensors on ``device`` (default ``cuda``);
    ``fn(x, params, n_valid=None, prog_tok=None)`` masters ``x`` [C, N] or
    a batch [B, C, N] (``n_valid``: [B] valid lengths of bucket-padded
    tracks).  With ``prog_tok`` each finished stage is reported to
    ``runtime.progress.stage_done`` (``models/v2_job.py``)."""
    dev = resolve_device(device)
    cfg = STYLE_CONFIGS.get(style, STYLE_CONFIGS["standard"])
    exciter_db = cfg.get("exciter_db", 0.0)
    imager_width = cfg.get("imager_width", 1.0)
    parallel_mix = cfg.get("parallel_mix", 0.0)

    stages = []  # (name, params, fn)

    def add(name, built):
        stages.append((name, built[0], built[1]))

    add("dc_offset+peak_guard_in",
        ([], lambda x, p: basic.remove_dc_then_peak_guard(x, 0.5)))
    if denoise_strength > 0.01:
        add("spectral_denoise",
            build_spectral_denoise(spec, denoise_strength, device=dev))
    fused_td = build_target_then_deesser(spec, device=dev)
    if fused_td is not None:
        add("target_eq+deesser", fused_td)
    else:
        add("target_eq", build_target_curve(spec, device=dev))
        add("deesser", build_deesser(spec, device=dev))
    add("dynamics", build_dynamics(spec, compressor=compressor, device=dev))
    if parallel_mix > 0.01:
        add("parallel_compress",
            ([], lambda x, p: basic.parallel_compression(x, mix=parallel_mix)))
    # normalize → final balance (→ style EQ) share one forward FFT; with a
    # reference match between them and the style EQ, only the first two
    fused_nf = build_normalize_then_final(
        spec, target_lufs, style if reference_env is None else None,
        device=dev)
    if fused_nf is not None:
        p_nf, f_nf, nf_id = fused_nf
        add(nf_id, (p_nf, f_nf))
    else:
        add("normalize_lufs",
            meters.build_normalize_lufs(spec, target_lufs, device=dev))
        add("final_spectral_balance",
            build_final_spectral_balance(spec, device=dev))
    if reference_env is not None:
        add("reference_match",
            build_reference_match(spec, reference_env,
                                  strength=reference_strength, device=dev))
    if fused_nf is None or "style_eq" not in fused_nf[2]:
        add("style_eq", build_style_eq(spec, style, device=dev))
    if (abs(transient_attack - 1.0) > 0.02
            or abs(transient_sustain - 1.0) > 0.02):
        add("transient_designer", build_transient_designer(
            spec, transient_attack, transient_sustain))
    if exciter_db > 0.05:
        add("harmonic_exciter",
            build_harmonic_exciter(spec, exciter_db, device=dev))
    if abs(imager_width - 1.0) > 0.01 and spec.channels == 2:
        add("stereo_imager",
            build_stereo_imager(spec, width=imager_width, device=dev))
    add("peak_guard_out",
        ([], lambda x, p: basic.remove_intersample_peaks(x, 0.5)))
    add("output_fade_in",
        ([], lambda x, p: basic.output_edge_fade_in(x, spec.sr, 6.0)))

    names = [s[0] for s in stages]
    params = to_device([list(s[1]) for s in stages], dev)
    fns = [s[2] for s in stages]

    def fn(x, params, n_valid=None, prog_tok=None):
        xb, nv, single = as_batch(x, n_valid)
        with validctx.valid_length(nv):
            for i, (f, p) in enumerate(zip(fns, params)):
                # Keep bucket padding silent between stages.
                xb = validctx.mask_tail(f(xb, p))
                if prog_tok is not None:
                    progress.stage_done(prog_tok, i, xb.device)
        out = basic.finalize_clip(xb)
        return out[0] if single else out

    return params, fn, names


def master_v1(x: np.ndarray, sr: int, *, device=None, **kw) -> np.ndarray:
    """Convenience host entry: master one [C, N] (or [N]) track."""
    dev = resolve_device(device)
    x2 = np.atleast_2d(np.asarray(x, np.float32))
    spec = GraphSpec(sr=sr, n=x2.shape[-1], channels=x2.shape[0])
    params, fn, _ = build_v1_pipeline(spec, device=dev, **kw)
    with torch.no_grad():
        out = fn(torch.as_tensor(x2, device=dev), params).cpu().numpy()
    return out if np.ndim(x) == 2 else out[0]
