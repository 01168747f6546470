"""Elementwise / reduction DSP ops of the v1 chain and the v2 job.

Counterpart of ``amw_tpu/ops/basic.py``.  Audio is ``[..., N]`` with time
on the last axis.  The JAX functions run on one track ``[C, N]`` (batched
by ``vmap``); the ones here whose reductions are global over a track take
an explicit batch axis, ``[B, C, N]``, and reduce over ``(C, N)`` per
track, never across tracks.

Reference citations: backend/app/pipeline.py — ``remove_dc_offset`` :134,
``remove_intersample_peaks`` :141, ``apply_output_edge_fade_in`` :152,
``_apply_limiter_numpy`` :276, ``_compress_soft_knee`` :282,
``apply_maximizer`` :484, ``apply_maximizer_lookahead`` :548,
``apply_parallel_compression`` :1771, ``_exciter_saturate`` :1179,
finalize clip :1904, the trailing-silence trim :902,
``validate_mastered_not_silent`` :939.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..constants import MAXIMIZER_MARGIN_DB, MAXIMIZER_THRESHOLD_DB
from . import validctx


def db_to_lin(db):
    return 10.0 ** (db / 20.0)


def _track_max(x: torch.Tensor) -> torch.Tensor:
    """Max over every axis but the leading (track) one, keepdims."""
    return x.reshape(x.shape[0], -1).amax(dim=1).reshape(
        (x.shape[0],) + (1,) * (x.ndim - 1))


def remove_dc_offset(x: torch.Tensor) -> torch.Tensor:
    """Per-channel mean subtraction over ``[B, C, N]``.  Under a padded
    bucket the mean is over each track's valid samples: the stage loop
    keeps the padding at zero, so the sum covers only the valid region and
    is divided by ``n_valid``."""
    nv = validctx.n_valid()
    if nv is None:
        return x - x.mean(dim=-1, keepdim=True)
    denom = validctx.per_track(nv.clamp(min=1), x).to(x.dtype)
    return x - x.sum(dim=-1, keepdim=True) / denom


def remove_intersample_peaks(x: torch.Tensor,
                             headroom_db: float = 0.5) -> torch.Tensor:
    """Peak-normalize each track ``[B, C, N]`` down to -headroom_db if above
    it, then hard clip.  The peak is over the track's channels and time."""
    x = torch.nan_to_num(x, nan=0.0, posinf=1.0, neginf=-1.0)
    peak = _track_max(x.abs())
    limit = db_to_lin(-headroom_db)
    scale = torch.where(peak > limit, limit / peak.clamp(min=1e-12),
                        torch.ones_like(peak))
    return (x * scale).clamp(-1.0, 1.0)


def remove_dc_then_peak_guard(x: torch.Tensor,
                              headroom_db: float = 0.5) -> torch.Tensor:
    """Fused ``remove_dc_offset`` → ``remove_intersample_peaks`` over
    ``[B, C, N]``: one reduce pass (per-channel mean/max/min) and one
    elementwise pass, with ``max|x - m| = max(max(x) - m, m - min(x))``.

    Reference non-finite semantics are kept exactly (amw_tpu basic.py:
    95-118): a non-finite value poisons its channel's mean; the channel
    then maps to all-zero (mean NaN), or ∓1 at every sample that is not
    itself the poisoning ±inf and 0 at those (mean ±inf), and those ±1
    values join the track's peak.  Under a padded bucket the reduces
    anchor at ``n_valid``."""
    nv = validctx.n_valid()
    n = x.shape[-1]
    if nv is None:
        mean = x.mean(dim=-1, keepdim=True)
        x_max = x.amax(dim=-1, keepdim=True)
        x_min = x.amin(dim=-1, keepdim=True)
    else:
        valid = torch.arange(n, device=x.device) < validctx.per_track(nv, x)
        denom = validctx.per_track(nv.clamp(min=1), x).to(x.dtype)
        mean = x.sum(dim=-1, keepdim=True) / denom
        inf = torch.tensor(float("inf"), dtype=x.dtype, device=x.device)
        x_max = torch.where(valid, x, -inf).amax(dim=-1, keepdim=True)
        x_min = torch.where(valid, x, inf).amin(dim=-1, keepdim=True)
    inf = float("inf")
    one = torch.ones((), dtype=x.dtype, device=x.device)
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    ch_ok = torch.isfinite(mean)
    mean_pinf = mean == inf
    mean_ninf = mean == -inf
    # Post-nan_to_num per-channel peak: finite channels: max|x - mean|;
    # mean=+inf: 1 iff any sample isn't itself +inf; mean=-inf:
    # symmetric; mean=NaN: the channel is all zeros.
    ch_peak = torch.where(
        ch_ok, torch.maximum(x_max - mean, mean - x_min),
        torch.where(mean_pinf, torch.where(x_min < inf, one, zero),
                    torch.where(mean_ninf,
                                torch.where(x_max > -inf, one, zero), zero)))
    peak = _track_max(ch_peak)
    limit = db_to_lin(-headroom_db)
    scale = torch.where(peak > limit, limit / peak.clamp(min=1e-12),
                        torch.ones_like(peak))
    # Pre-scale values exactly as nan_to_num(x - mean) would produce them.
    z = torch.where(
        ch_ok, x - mean,
        torch.where(mean_pinf,
                    torch.where(torch.isnan(x) | (x == inf), zero, -one),
                    torch.where(mean_ninf,
                                torch.where(torch.isnan(x) | (x == -inf),
                                            zero, one),
                                zero)))
    return (z * scale).clamp(-1.0, 1.0)


def output_edge_fade_in(x: torch.Tensor, sr: int,
                        fade_ms: float = 6.0) -> torch.Tensor:
    """Linear fade-in over ~6 ms at track start (anti-click)."""
    n = x.shape[-1]
    if fade_ms <= 0 or sr <= 0 or n == 0:
        return x
    n_fade = int(round(sr * (fade_ms / 1000.0)))
    n_fade = max(2, min(n_fade, int(sr * 0.1)))
    n_fade = min(n_fade, n)
    ramp = torch.linspace(0.0, 1.0, n_fade, dtype=x.dtype, device=x.device)
    ramp = torch.cat([ramp, torch.ones(n - n_fade, dtype=x.dtype,
                                       device=x.device)])
    return x * ramp


def limiter(x: torch.Tensor, threshold_db: float = -1.0) -> torch.Tensor:
    lim = db_to_lin(threshold_db)
    return x.clamp(-lim, lim)


def compress_soft_knee(x: torch.Tensor, threshold_db: float = -18.0,
                       ratio: float = 2.5, knee_db: float = 6.0,
                       max_upward_boost_db: float = 12.0) -> torch.Tensor:
    """Static (memoryless) soft-knee compressor/expander (pipeline.py:
    282-330): ratio > 1 compresses with a linear-domain soft knee, ratio < 1
    is a bounded upward boost, ratio == 1 bypasses."""
    if ratio <= 0.0 or ratio == 1.0:
        return x
    thresh = db_to_lin(threshold_db)
    abs_x = x.abs()
    sign = torch.sign(x)

    if ratio < 1.0:
        eps = 1e-12
        level_db = torch.where(abs_x > eps,
                               20.0 * torch.log10(abs_x.clamp(min=eps)),
                               torch.full_like(abs_x, -100.0))
        boost_db = (threshold_db - level_db) * (1.0 - ratio)
        boost_db = boost_db.clamp(0.0, max(0.1, float(max_upward_boost_db)))
        out_abs = (abs_x * db_to_lin(boost_db)).clamp(0.0, 1.0)
        return sign * out_abs

    knee_db = max(0.0, float(knee_db))
    if knee_db < 0.5:
        excess = (abs_x - thresh).clamp(min=0.0)
        out_abs = torch.minimum(abs_x, thresh + excess / ratio)
        return sign * out_abs
    lower = thresh * db_to_lin(-knee_db)
    upper = thresh * db_to_lin(knee_db)
    knee_slope = (thresh + (upper - thresh) / ratio - lower) / (upper - lower)
    out_abs = torch.where(
        abs_x <= lower, abs_x,
        torch.where(abs_x >= upper, thresh + (abs_x - thresh) / ratio,
                    lower + (abs_x - lower) * knee_slope))
    out_abs = out_abs.clamp(min=0.0)
    return sign * out_abs


def maximizer(x: torch.Tensor) -> torch.Tensor:
    """Soft-knee maximizer: threshold -2.5 dB, ceiling -0.3 dB."""
    ceiling = db_to_lin(MAXIMIZER_MARGIN_DB)
    thresh = db_to_lin(MAXIMIZER_THRESHOLD_DB)
    abs_x = x.abs()
    sign = torch.sign(x)
    out_abs = torch.where(
        abs_x <= thresh, abs_x,
        thresh + (abs_x - thresh) * (ceiling - thresh) / (1.0 - thresh))
    return sign * out_abs.clamp(max=ceiling)


def maximizer_lookahead(x: torch.Tensor, sr: int,
                        lookahead_ms: float = 6.0) -> torch.Tensor:
    """6 ms-lookahead maximizer with a 2 ms crossfade splice at the boundary
    (pipeline.py:548-573).  ``x``: [..., N]."""
    n = x.shape[-1]
    delay_n = int(sr * (lookahead_ms / 1000.0))
    if delay_n <= 0 or delay_n >= n:
        return maximizer(x)
    delayed = F.pad(x[..., :-delay_n], (delay_n, 0))
    limited = maximizer(delayed)
    out = torch.cat([x[..., :delay_n], limited[..., delay_n:]], dim=-1)
    cf = min(delay_n, max(2, int(sr * 0.002)))
    # Crossfade region indices delay_n-cf .. delay_n-1 with weight a=(i+1)/cf.
    t = torch.arange(n, device=x.device)
    a = ((t - (delay_n - cf) + 1) / float(cf)).clamp(0.0, 1.0).to(x.dtype)
    in_region = (t >= delay_n - cf) & (t < delay_n)
    return torch.where(in_region, (1.0 - a) * x + a * limited, out)


def parallel_compression(x: torch.Tensor, mix: float = 0.3,
                         ratio: float = 8.0,
                         threshold_db: float = -20.0) -> torch.Tensor:
    """New York compression: blend of hard-compressed signal with the dry."""
    mix = float(min(max(mix, 0.0), 1.0))
    if mix < 0.01:
        return x
    compressed = compress_soft_knee(x, threshold_db=threshold_db, ratio=ratio,
                                    knee_db=6.0, max_upward_boost_db=0.0)
    return (x * (1.0 - mix) + compressed * mix).clamp(-1.0, 1.0)


def exciter_saturate(x: torch.Tensor, mode: str,
                     k: float = 2.0) -> torch.Tensor:
    """Waveshaper curves (pipeline.py:1179-1197)."""
    x = x.clamp(-1.0, 1.0)
    if mode == "transistor":
        return x - (x ** 3) / 3.0
    if mode == "tape":
        return torch.tanh(k * x) / (k + 1e-8)
    if mode == "tube":
        return x + 0.3 * (x ** 2)
    if mode == "warm":
        return 0.5 * (torch.tanh(k * x) / (k + 1e-8) + x + 0.3 * (x ** 2))
    if mode == "digital":
        return torch.where(x.abs() <= 1.0, x,
                           torch.sign(x) * (2.0 - x.abs()))
    return torch.tanh(k * x) / (k + 1e-8)


def finalize_clip(x: torch.Tensor) -> torch.Tensor:
    """End-of-chain scrub: clip to [-1, 1] and replace NaN/Inf."""
    x = x.clamp(-1.0, 1.0)
    return torch.nan_to_num(x, nan=0.0, posinf=1.0, neginf=-1.0)


def auto_blank_end_index(x: torch.Tensor, sr: int,
                         threshold_dbfs: float = -60.0,
                         min_silence_sec: float = 0.5) -> torch.Tensor:
    """Index to trim trailing silence at, a 0-d int64 tensor on ``x``'s
    device (the host does the slice, since the output length is
    data-dependent).  Mirrors pipeline.py:902-917: keep through the last
    sample above threshold plus ``min_silence_sec``.  ``x``: [N] or
    [C, N], the peak taken over every leading axis."""
    n = x.shape[-1]
    peak = x.abs().reshape(-1, n).amax(dim=0)
    above = peak > db_to_lin(threshold_dbfs)
    last = n - 1 - torch.argmax(above.flip(0).to(torch.uint8))
    idx = torch.clamp(last + 1 + int(sr * min_silence_sec), max=n)
    return torch.where(above.any(), idx, torch.full_like(idx, n))


def validate_stats(x: torch.Tensor):
    """Device-side stats backing ``validate_mastered_not_silent``
    (pipeline.py:939-962), per track of ``[B, ...]``: (all finite [B],
    peak [B])."""
    flat = x.reshape(x.shape[0], -1)
    return torch.isfinite(flat).all(dim=1), flat.abs().amax(dim=1)
