"""Analysis suite: the measurement graphs behind /api/v2/analyze and
/api/tools/lufs-analyze (counterpart of ``amw_tpu/models/analyze.py``;
reference: routers/mastering.py:1198-1303, routers/tools.py:44-152).

One graph computes every meter in a single pass over the track, with the
K-weighted signal computed once and shared by the integrated, short-term
(LRA) and timeline meters; the host wrapper shapes the JSON-ready dict
(rounding, None semantics, platform tables) exactly like the reference
endpoints.  Tracks are zero-padded to a length bucket and every meter is
valid-length masked, so one graph serves any upload up to its bucket.

The K-weighting plan is ``fft_staged.site_plan(n + settle, device)``, the
JAX package's ``design.next_fft_size`` on each backend: on the card the
staged FFT's kernels from the 15 s bucket (2^20) up to 300 s (2^24), cuFFT
at the 5 s bucket (2^18) and above 300 s; on the CPU ``torch.fft``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .. import resolve_device
from ..ops import design, fft_staged, meters

STREAMING_PLATFORMS = {
    "Spotify": -14.0,
    "YouTube": -14.0,
    "Apple Music": -16.0,
    "Tidal": -14.0,
    "Amazon Music": -14.0,
    "Broadcast (EBU R128)": -23.0,
}


ANALYSIS_BUCKETS_SEC = (5, 15, 30, 60, 90, 120, 150, 180, 240, 300, 420, 600)


def _bucket_for(sr: int, n: int) -> int:
    for s in ANALYSIS_BUCKETS_SEC:
        bn = int(round(s * sr))
        if bn >= n:
            return bn
    return n


@functools.lru_cache(maxsize=32)
def _analysis_graph(sr: int, n: int, channels: int, extended: bool,
                    true_peak: bool, *, device: torch.device):
    """``(fn, Hk)`` for a BUCKETED length ``n``: ``fn(x, Hk, n_valid)``
    maps a track ``x`` [channels, n] on ``device`` and its valid length
    (an int) to a dict of tensors; ``Hk`` is the K-weighting on
    ``device``: ``(permuted response [2, nfft], plan tables)`` on the
    staged FFT, else ``(packed response [2, nbins], None)``."""
    settle = meters.k_weight_settle(sr)
    nfft, staged = fft_staged.site_plan(n + settle, device)
    can_gate = n >= int(0.4 * sr) + 1
    plan = meters.plan_blocks(sr, n) if can_gate else None

    if staged:
        Hk_c = design.cascade_response(design.k_weighting_ba(sr), nfft)
        Hk = (torch.from_numpy(fft_staged.permute_full_response(Hk_c, nfft))
              .to(device), fft_staged._device_tables(nfft, device))
    else:
        Hk = (torch.from_numpy(meters.k_weight_response(sr, nfft)).to(device),
              None)

    def fn(x, Hk_dev, n_valid: int):
        out = {}
        out["peak"] = (x.abs().max() if n > 0
                       else torch.zeros((), device=x.device))
        resp, tabs = Hk_dev
        yk = (meters.k_weight_filter(x, resp, nfft, staged_tables=tabs)
              if (can_gate or true_peak or extended) else None)
        if can_gate:
            nv = torch.full((1,), n_valid, dtype=torch.int32,
                            device=x.device)
            out["lufs"] = meters.integrated_lufs(x[None], resp, nfft, plan,
                                                 n_valid=nv, yk=yk[None])[0]
        if channels == 2:
            out["correlation"] = meters.stereo_correlation(x, n_valid)
        if true_peak:
            out["true_peak_db"] = meters.true_peak_dbfs(x)
            tl3, tl3_valid = meters.timeline_lufs_masked(
                x, resp, nfft, sr, n_valid, block_sec=3.0, max_points=200,
                yk=yk)
            out["lra"] = meters.loudness_range_lu(
                torch.where(tl3_valid, tl3, torch.full_like(tl3, -1e9)))
        if extended:
            if n >= 4096:
                out["spectrum"] = meters.spectrum_bars_masked(x, sr, n_valid)
                if channels == 2:
                    mid = (x[0] + x[1]) * 0.5
                    side = (x[0] - x[1]) * 0.5
                    out["spectrum_mid"] = meters.spectrum_bars_masked(
                        mid[None], sr, n_valid)
                    out["spectrum_side"] = meters.spectrum_bars_masked(
                        side[None], sr, n_valid)
            out["timeline"], out["timeline_valid"] = \
                meters.timeline_lufs_masked(x, resp, nfft, sr, n_valid, yk=yk)
            if channels == 2:
                out["vectorscope"], out["vectorscope_valid"] = \
                    meters.vectorscope_points_masked(x, n_valid)
        return out

    return fn, Hk


def _run_graph(x: np.ndarray, sr: int, extended: bool, true_peak: bool,
               device):
    """Pad ``x`` to its bucket, run the graph on ``device``, fetch the
    results: ``(results as numpy, channels, n)``."""
    dev = resolve_device(device)
    x = np.atleast_2d(np.asarray(x, np.float32))
    C, n = x.shape
    n_pad = _bucket_for(sr, n)
    fn, Hk = _analysis_graph(sr, n_pad, C, extended, true_peak, device=dev)
    xp = torch.from_numpy(np.pad(x, ((0, 0), (0, n_pad - n)))).to(dev)
    with torch.no_grad():
        r = {k: v.cpu().numpy() for k, v in fn(xp, Hk, n).items()}
    return r, C, n


def _round(v, d=2):
    return round(float(v), d)


def analyze(x: np.ndarray, sr: int, extended: bool = False, *,
            device="cuda") -> dict:
    """The /api/v2/analyze response dict for a [C, N] track, measured on
    ``device``."""
    r, C, n = _run_graph(x, sr, extended, False, device)

    lufs = float(r["lufs"]) if "lufs" in r else float("nan")
    if lufs < -1e8:
        lufs = float("nan")
    peak_dbfs = 20 * math.log10(max(float(r["peak"]), 1e-12))
    out = {
        "version": "v2",
        "lufs": _round(lufs) if not math.isnan(lufs) else None,
        "peak_dbfs": _round(peak_dbfs),
        "duration_sec": _round(n / sr, 3),
        "sample_rate": int(sr),
        "channels": int(C),
    }
    if "correlation" in r:
        corr = float(r["correlation"])
        out["stereo_correlation"] = round(corr, 4)

    if not math.isnan(lufs):
        preview = {}
        for platform, target in STREAMING_PLATFORMS.items():
            penalty = round(max(0.0, lufs - target), 2)
            gain_applied = round(min(0.0, target - lufs), 2)
            status = ("loud" if penalty > 6.0
                      else ("ok" if penalty > 1.0 else "optimal"))
            preview[platform] = {
                "target_lufs": target,
                "penalty_db": penalty,
                "gain_applied_db": gain_applied,
                "status": status,
            }
        out["streaming_preview"] = preview

    if extended:
        if "spectrum" in r:
            out["spectrum_bars"] = [_round(v) for v in r["spectrum"]]
        if "spectrum_mid" in r:
            out["spectrum_bars_mid"] = [_round(v) for v in r["spectrum_mid"]]
            out["spectrum_bars_side"] = [_round(v)
                                         for v in r["spectrum_side"]]
        if "timeline" in r:
            tv = r.get("timeline_valid")
            count = int(tv.sum()) if tv is not None else len(r["timeline"])
            tl = [(_round(v) if v > -1e8 else None)
                  for v in r["timeline"][:count]]
            out["lufs_timeline"] = tl
            duration = n / sr
            if duration <= 0.4 or n < int(sr * 0.4):
                step_sec = 0.0
            else:
                n_points = min(300, max(1, int((duration - 0.4) / 0.1) + 1))
                step_sec = (duration - 0.4) / max(n_points - 1, 1)
            out["timeline_step_sec"] = round(float(step_sec), 4)
        if "vectorscope" in r:
            vv = r.get("vectorscope_valid")
            cnt = int(vv.sum()) if vv is not None else len(r["vectorscope"])
            out["vectorscope_points"] = [
                [round(float(a), 5), round(float(b), 5)]
                for a, b in r["vectorscope"][:cnt]
            ]
    return out


def lufs_analyze_tool(x: np.ndarray, sr: int, fmt: str = "wav", *,
                      device="cuda") -> dict:
    """The /api/tools/lufs-analyze response (tools.py:83-152), measured on
    ``device``."""
    r, C, n = _run_graph(x, sr, True, True, device)

    integrated = float(r["lufs"]) if "lufs" in r else float("nan")
    if math.isnan(integrated) or integrated < -1e8:
        integrated = -70.0
    tp = float(r["true_peak_db"]) if n else -120.0
    lra = float(r["lra"])
    tl = np.asarray(r["timeline"])
    tv = np.asarray(r.get("timeline_valid", np.ones(len(tl), bool)))
    valid = tl[tv & (tl > -1e8)]
    st_max = float(valid.max()) if valid.size else None

    recs = []
    if integrated < -16:
        recs.append(
            f"Track is relatively quiet ({integrated:.1f} LUFS). Spotify "
            "commonly targets about -14 LUFS.")
    elif integrated > -8:
        recs.append(
            f"Track is very loud ({integrated:.1f} LUFS). Platforms may turn "
            "it down on playback.")
    if tp > -0.5:
        recs.append(
            f"Peak level is high ({tp:.1f} dBFS). Keep headroom to -1 dBTP "
            "when mastering.")
    if not recs:
        recs.append("Loudness is in a reasonable range for many scenarios.")
    recs.append("Fix balance and limiting in one click with mastering.")

    return {
        "integrated_lufs": _round(integrated),
        "true_peak_dbfs": _round(tp),
        "loudness_range_lu": _round(lra),
        "short_term_max_lufs": _round(st_max) if st_max is not None else None,
        "sample_rate": int(sr),
        "channels": int(C),
        "duration_sec": _round(n / sr),
        "bit_depth": None,
        "format": fmt.upper(),
        "spotify_ready": -16.5 <= integrated <= -11.5,
        "apple_ready": -18.5 <= integrated <= -13.5,
        "youtube_ready": -16.5 <= integrated <= -11.5,
        "podcast_ready": -18.5 <= integrated <= -13.5,
        "recommendations": recs,
    }
