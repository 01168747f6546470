"""Whole configurations through the reference: the fixed v1 pipeline of
``POST /api/master`` and the v2 job of ``POST /api/v2/master`` (the PRO
panel's PRE stages, the config-driven chain, the POST stages, the output
fade), each on one track ``[C, N]`` at its own length.

:func:`master` takes a configuration file's dict and returns what the
program's graph returns for the same track: the output and, for the v2
job, the loudness before and after, the peak and whether every sample is
finite.  With ``q`` (:mod:`.precision`) every stage's output and the
meters are rounded as the control asks.
"""

from __future__ import annotations

import numpy as np

from . import dsp
from .constants import STYLE_CONFIGS


def _same(a):
    return a


def default_chain_config(target_lufs=-14.0, style="standard"):
    """The default v2 chain (chain.py:101-125 of the reference service,
    with its 2230 Hz crossover where the v1 pipeline splits at 3500 Hz).
    The exciter and the imager are on only for styles that set them,
    which have no reference here (:func:`_chain_module` refuses them)."""
    cfg = STYLE_CONFIGS.get(style, STYLE_CONFIGS["standard"])
    exciter_db = cfg.get("exciter_db", 0.0)
    width = cfg.get("imager_width", 1.0)
    cross = [214.0, 2230.0, 10000.0]
    return [
        ("dc_offset", {}),
        ("peak_guard", {"headroom_db": 0.5}),
        ("target_curve", {}),
        ("dynamics", {"knee_db": 6.0, "crossovers_hz": cross}),
        ("normalize_lufs", {"target_lufs": target_lufs}),
        ("final_spectral_balance", {}),
        ("style_eq", {"style": style}),
        ("exciter", {"enabled": abs(exciter_db) >= 0.05,
                     "exciter_db": exciter_db}),
        ("imager", {"enabled": abs(width - 1.0) >= 0.01, "width": width}),
        ("peak_guard", {"headroom_db": 0.5}),
    ]


def _chain_module(mid, cfg, sr, q):
    if mid == "dc_offset":
        return dsp.remove_dc_offset
    if mid == "peak_guard":
        return lambda x: dsp.remove_intersample_peaks(x, cfg["headroom_db"])
    if mid == "target_curve":
        return lambda x: dsp.target_curve(x, sr)
    if mid == "dynamics":
        return lambda x: dsp.dynamics(x, sr, knee_db=cfg["knee_db"],
                                      crossovers_hz=cfg["crossovers_hz"])
    if mid == "normalize_lufs":
        return lambda x: dsp.normalize_lufs(x, sr, cfg["target_lufs"], q)
    if mid == "final_spectral_balance":
        return lambda x: dsp.final_spectral_balance(x, sr)
    if mid == "style_eq":
        return lambda x: dsp.style_eq(x, sr, cfg["style"])
    raise ValueError(f"no reference for chain module {mid!r}")


def v2_stages(config, sr):
    """The v2 job's stages in order, as ``(name, fn(x, q))``
    (mastering.py:443-637 of the reference service)."""
    pro = config.get("pro", {})
    target = float(config["target_lufs"])
    style = config["style"]
    st = []
    if pro.get("rumble_enabled"):
        cut = float(pro.get("rumble_cutoff", 80.0))
        st.append(("rumble_filter", lambda x, q: dsp.rumble_filter(x, sr, cut)))
    if float(pro.get("denoise_strength", 0) or 0) > 0 or pro.get(
            "denoise_preset"):
        raise ValueError("the spectral denoiser has no reference here")
    if pro.get("deesser_enabled"):
        th = float(pro.get("deesser_threshold", -6.0))
        hi = float(pro.get("deesser_freq_hi", 9000.0))
        st.append(("deesser", lambda x, q: dsp.deesser(
            x, sr, threshold_db=th, freq_hi=hi)))
    for mid, cfg in default_chain_config(target, style):
        if not cfg.get("enabled", True):
            continue
        st.append((f"chain:{mid}",
                   lambda x, q, _m=mid, _c=cfg: _chain_module(_m, _c, sr, q)(x)))
    st.append(("chain_finalize", lambda x, q: dsp.finalize_clip(x)))
    ta = pro.get("transient_attack")
    ts = pro.get("transient_sustain", 1.0)
    if ta is not None and (abs(float(ta) - 1.0) > 0.02
                           or abs(float(ts) - 1.0) > 0.02):
        st.append(("transient_designer", lambda x, q: dsp.transient_designer(
            x, sr, float(ta), float(ts))))
    pmix = pro.get("parallel_mix", 0)
    if pmix is not None and float(pmix) > 0:
        st.append(("parallel_compression",
                   lambda x, q: dsp.parallel_compression(x, float(pmix))))
    if pro.get("dynamic_eq_enabled"):
        st.append(("dynamic_eq", lambda x, q: dsp.dynamic_eq(x, sr)))
    if pro.get("true_peak_enabled"):
        raise ValueError("the true-peak limiter has no reference here")
    st.append(("output_fade_in",
               lambda x, q: dsp.output_edge_fade_in(x, sr, 6.0)))
    return st


def v1_stages(config, sr):
    """The fixed v1 pipeline (pipeline.py:1800-1909)."""
    cfg = STYLE_CONFIGS.get(config["style"], STYLE_CONFIGS["standard"])
    target = float(config["target_lufs"])
    style = config["style"]
    st = [("dc_offset", lambda x, q: dsp.remove_dc_offset(x)),
          ("peak_guard_in", lambda x, q: dsp.remove_intersample_peaks(x, 0.5)),
          ("target_curve", lambda x, q: dsp.target_curve(x, sr)),
          ("deesser", lambda x, q: dsp.deesser(x, sr)),
          ("dynamics", lambda x, q: dsp.dynamics(x, sr))]
    if cfg.get("parallel_mix", 0.0) > 0.01:
        st.append(("parallel_compression", lambda x, q: dsp.parallel_compression(
            x, cfg["parallel_mix"])))
    st += [("normalize_lufs", lambda x, q: dsp.normalize_lufs(x, sr, target, q)),
           ("final_spectral_balance",
            lambda x, q: dsp.final_spectral_balance(x, sr)),
           ("style_eq", lambda x, q: dsp.style_eq(x, sr, style))]
    if (cfg.get("exciter_db", 0.0) > 0.05
            or abs(cfg.get("imager_width", 1.0) - 1.0) > 0.01):
        raise ValueError(f"the style {style!r} runs the exciter or the "
                         "imager, which have no reference here")
    st += [("peak_guard_out", lambda x, q: dsp.remove_intersample_peaks(x, 0.5)),
           ("output_fade_in", lambda x, q: dsp.output_edge_fade_in(x, sr, 6.0)),
           ("finalize", lambda x, q: dsp.finalize_clip(x))]
    return st


GRAPHS = {"v2_job": v2_stages, "v1_pipeline": v1_stages}


def master(config: dict, x: np.ndarray, q=None) -> dict:
    """One track ``x`` [C, N] (its valid samples only) through the
    configuration ``config`` (a configuration file's dict).  Returns
    ``out`` and, where the graph reports them, ``before_lufs``,
    ``after_lufs``, ``peak`` and ``finite``."""
    q = q or _same
    sr = int(config["sr"])
    stages = GRAPHS[config["graph"]](config, sr)
    a = q(np.asarray(x, np.float64))
    res = {}
    reports = config["graph"] == "v2_job"
    if reports:
        res["before_lufs"] = dsp.integrated_lufs(a, sr, q)
    for _, fn in stages:
        a = q(fn(a, q))
    res["out"] = a
    if reports:
        res["after_lufs"] = dsp.integrated_lufs(a, sr, q)
        res["peak"] = float(q(np.max(np.abs(a))))
        res["finite"] = bool(np.isfinite(a).all())
    return res
