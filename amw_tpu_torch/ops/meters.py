"""Measurement ops: BS.1770 loudness, true peak, correlation, spectrum.

Counterpart of ``amw_tpu/ops/meters.py``: K-weighting as a
frequency-domain causal filter, 400 ms / 75 %-overlap block energies, and
two-stage (-70 LUFS absolute, -10 LU relative) gating.  Block framing
reproduces pyloudnorm's indexing (``numBlocks = round((T - 0.4)/0.1) + 1``,
block ``j`` covering ``[int(0.1*j*sr), int((0.1*j + 0.4)*sr))``, energies
divided by ``0.4*sr``).

The JAX functions take one track ``[C, N]`` and are batched by ``vmap``.
Here the loudness core (:func:`integrated_lufs` and what it calls) is per
track over any leading batch axes: signals are ``[..., C, N]`` with
channels on axis -2, block energies ``[..., C, J]``, and a loudness or gain
has the leading shape ``[...]``.  The analysis meters (timeline, LRA,
spectrum bars, vectorscope, true peak, correlation: the graph of
``models/analyze.py``) take one track ``[C, N]`` and a scalar ``n_valid``
(a Python int: the host computes every index the JAX graph computes from
its traced count, in the same float32 arithmetic).

The K-weighting runs on ``torch.fft`` (cuFFT), or, where the caller's FFT
plan is one the staged FFT takes on the card (``fft_staged.site_plan``),
through ``fft_staged.apply_response`` with the permuted response, as the
JAX package runs it on its Pallas FFT (:func:`k_weight_filter`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import numpy as np
import torch

from . import design, fft_staged, validctx
from .fdfilter import lfilter_fd

# Per-channel weights for up to 5 channels (L, R, C, Ls, Rs).
_CHANNEL_GAINS = (1.0, 1.0, 1.0, 1.41, 1.41)
_ABS_GATE_LUFS = -70.0


@functools.lru_cache(maxsize=None)
def k_weight_response(sr: float, nfft: int) -> np.ndarray:
    """Causal K-weighting cascade response on the rFFT grid, packed as
    float32 [2, nbins] real/imag."""
    from .zphase import pack_complex

    return pack_complex(design.cascade_response(design.k_weighting_ba(sr),
                                                nfft))


@functools.lru_cache(maxsize=None)
def k_weight_settle(sr: float) -> int:
    return design.settle_len(*design.k_weighting_ba(sr))


@dataclass(frozen=True)
class BlockPlan:
    """Static framing metadata for gated loudness over an N-sample signal."""

    sr: int
    n: int
    n_blocks: int
    uniform: bool
    hop: int
    sub_per_block: int
    n_sub: int
    l_idx: tuple
    u_idx: tuple
    div: float


def plan_blocks(sr: int, n: int, block_sec: float = 0.4,
                step_ratio: float = 0.25) -> BlockPlan:
    T = n / sr
    step = block_sec * step_ratio
    n_blocks = int(round((T - block_sec) / step)) + 1
    if n_blocks < 1:
        raise ValueError("Audio must be longer than the 400 ms gating block")
    j = np.arange(n_blocks)
    l_idx = (block_sec * (j * step_ratio) * sr).astype(np.int64)
    u_idx = (block_sec * (j * step_ratio + 1) * sr).astype(np.int64)
    hop = int(round(step * sr))
    L = int(round(block_sec * sr))
    uniform = bool(np.all(l_idx == j * hop) and np.all(u_idx == j * hop + L)
                   and L == 4 * hop)
    n_sub = (n_blocks - 1) + 4 if uniform else 0
    return BlockPlan(
        sr=sr, n=n, n_blocks=n_blocks, uniform=uniform, hop=hop,
        sub_per_block=4, n_sub=n_sub,
        l_idx=tuple(int(v) for v in l_idx), u_idx=tuple(int(v) for v in u_idx),
        div=block_sec * sr)


def block_energies(y: torch.Tensor, plan: BlockPlan) -> torch.Tensor:
    """Mean-square energy per gating block.  ``y``: [..., C, N] K-weighted
    audio (N may exceed ``plan.n``: the tail past it is ignored).
    Returns [..., C, n_blocks]."""
    y2 = y[..., :plan.n].square()
    if plan.uniform:
        need = plan.n_sub * plan.hop
        pad = max(0, need - y2.shape[-1])
        y2p = torch.nn.functional.pad(y2, (0, pad))[..., :need]
        sub = y2p.reshape(y2p.shape[:-1] + (plan.n_sub, plan.hop)).sum(-1)
        J = plan.n_blocks
        z = (sub[..., 0:J] + sub[..., 1:J + 1] + sub[..., 2:J + 2]
             + sub[..., 3:J + 3])
        return z / plan.div
    l_np = np.asarray(plan.l_idx)
    u_np = np.asarray(plan.u_idx)
    maxlen = int(np.max(u_np - l_np))
    idx = l_np[:, None] + np.arange(maxlen)[None, :]
    mask = (idx < u_np[:, None]) & (idx < plan.n)
    idx = np.minimum(idx, plan.n - 1)
    dev = y.device
    gathered = (y2[..., torch.as_tensor(idx, device=dev)]
                * torch.as_tensor(mask, dtype=y2.dtype, device=dev))
    return gathered.sum(-1) / plan.div


def gated_loudness(z: torch.Tensor, rel_gate_lu: float = 10.0,
                   block_mask: torch.Tensor | None = None) -> torch.Tensor:
    """Two-stage gated integrated loudness from block energies ``z``
    [..., C, J].  ``block_mask``: optional [..., J] bool marking blocks that
    exist for each track's valid length.  Returns [...] (LUFS); -1e9 when
    everything is gated."""
    C = z.shape[-2]
    g = torch.as_tensor(_CHANNEL_GAINS[:C] if C <= 5 else (1.0,) * C,
                        dtype=z.dtype, device=z.device)
    zsum = (g[:, None] * z).sum(-2)  # [..., J]
    l_j = -0.691 + 10.0 * torch.log10(zsum.clamp(min=1e-30))

    m1 = l_j > _ABS_GATE_LUFS
    if block_mask is not None:
        m1 = m1 & block_mask
    cnt1 = m1.sum(-1).clamp(min=1)
    z_avg1 = (z * m1[..., None, :]).sum(-1) / cnt1[..., None]  # [..., C]
    gamma_r = -0.691 + 10.0 * torch.log10(
        (g * z_avg1).sum(-1).clamp(min=1e-30)) - rel_gate_lu

    m2 = m1 & (l_j > gamma_r[..., None])
    cnt2 = m2.sum(-1).clamp(min=1)
    z_avg2 = (z * m2[..., None, :]).sum(-1) / cnt2[..., None]
    lufs = -0.691 + 10.0 * torch.log10((g * z_avg2).sum(-1).clamp(min=1e-30))
    return torch.where(m2.any(-1), lufs, torch.full_like(lufs, -1e9))


def valid_block_mask(plan: BlockPlan, nv: torch.Tensor) -> torch.Tensor:
    """[B, n_blocks] bool: the blocks pyloudnorm frames for each track's
    valid length ``nv`` [B] (float32 arithmetic, as the JAX graph)."""
    n_blocks_v = torch.round((nv.to(torch.float32) / plan.sr - 0.4) / 0.1) + 1
    return (torch.arange(plan.n_blocks, device=nv.device)[None, :]
            < n_blocks_v[:, None])


def k_weight_filter(x: torch.Tensor, Hk: torch.Tensor, nfft: int,
                    staged_tables=None):
    """K-weighted signal (causal, zero state).  ``Hk``: packed [2, nbins]
    planes, or, when ``staged_tables`` (the plan tables) is given, the
    permuted full response [2, nfft] for the staged FFT."""
    if staged_tables is not None:
        return fft_staged.apply_response(x, Hk, nfft, tables=staged_tables,
                                         n_out=x.shape[-1])
    return lfilter_fd(x, torch.complex(Hk[0], Hk[1]), nfft)


def integrated_lufs(x: torch.Tensor, Hk: torch.Tensor, nfft: int,
                    plan: BlockPlan, n_valid: torch.Tensor | None = None,
                    yk: torch.Tensor | None = None) -> torch.Tensor:
    """Integrated loudness of ``x`` [B, C, N] per track ([B]).  With
    ``n_valid`` [B], ``x`` may be zero-padded: blocks beyond each track's
    valid block count are masked out."""
    y = yk if yk is not None else k_weight_filter(x, Hk, nfft)
    mask = None
    if n_valid is not None:
        # Causal K-weighting ringout past the valid end must read as zero in
        # any truncated-tail gating block.
        y = validctx.mask_tail(y, n_valid)
        mask = valid_block_mask(plan, n_valid)
    return gated_loudness(block_energies(y, plan), block_mask=mask)


def normalize_lufs_gain(lufs: torch.Tensor, target_lufs,
                        max_gain_db: float = 20.0) -> torch.Tensor:
    """Linear gain to reach ``target_lufs``, clamped to ±20 dB; unity when
    the measurement is invalid (pipeline.py:644-655 exception path)."""
    delta = (target_lufs - lufs).clamp(-max_gain_db, max_gain_db)
    gain = 10.0 ** (delta / 20.0)
    return torch.where(lufs > -5e8, gain, torch.ones_like(gain))


def build_normalize_lufs(spec, target_lufs: float = -14.0, *, device):
    """Op builder: measure integrated loudness per track and apply the
    clamped normalization gain (pipeline.py:644-655).  ``x``: [B, C, N]."""
    settle = k_weight_settle(spec.sr)
    nfft = fft_staged.site_plan(spec.n + settle, device)[0]
    plan = plan_blocks(spec.sr, spec.n)
    params = [k_weight_response(spec.sr, nfft), np.float32(target_lufs)]

    def fn(x, params):
        lufs = integrated_lufs(x, params[0], nfft, plan,
                               n_valid=validctx.n_valid())
        return x * validctx.per_track(normalize_lufs_gain(lufs, params[1]), x)

    return params, fn


# ---------------------------------------------------------------------------
# Short-term loudness / timeline / LRA (one track [C, N])


def segment_starts(n: int, sr: int, block_sec: float,
                   max_points: int) -> np.ndarray:
    """Segment start indices replicating compute_lufs_timeline's stepping
    (pipeline.py:667-697)."""
    duration = n / sr
    block_samples = int(sr * block_sec)
    if duration <= block_sec or n < block_samples:
        return np.zeros((0,), np.int64)
    n_points = min(max_points, max(1, int((duration - block_sec)
                                          / (block_sec * 0.25)) + 1))
    step_sec = (duration - block_sec) / max(n_points - 1, 1)
    step_samples = int(sr * step_sec)
    starts = []
    pos = 0
    while pos + block_samples <= n and len(starts) < max_points:
        starts.append(pos)
        pos += step_samples
        if step_samples <= 0:
            break
    return np.asarray(starts, np.int64)


def _segment_loudness(y: torch.Tensor, step: int, count: int,
                      block_samples: int) -> torch.Tensor:
    """Ungated loudness of the ``count`` segments ``[k·step, k·step +
    block_samples)`` of the K-weighted ``y`` [C, N] → [count].  Each
    segment's mean square is a float32 sum over a window of ``y²`` read
    through a strided view (no [C, count, block] copy, unlike the JAX
    graph's gather); segments that do not fit in ``N`` read as silence
    (every caller masks them)."""
    n = y.shape[-1]
    fit = (n - block_samples) // step + 1 if n >= block_samples else 0
    m = min(count, fit)
    z = y.square().unfold(-1, block_samples, step)[:, :m].sum(-1)
    z = torch.nn.functional.pad(z, (0, count - m)) / float(block_samples)
    C = y.shape[0]
    g = torch.as_tensor(_CHANNEL_GAINS[:C] if C <= 5 else (1.0,) * C,
                        dtype=z.dtype, device=z.device)
    zsum = (g[:, None] * z).sum(0)
    return -0.691 + 10.0 * torch.log10(zsum.clamp(min=1e-30))


def timeline_lufs(x: torch.Tensor, Hk: torch.Tensor, nfft: int, sr: int,
                  block_sec: float = 0.4, max_points: int = 300,
                  yk: torch.Tensor | None = None,
                  staged_tables=None) -> torch.Tensor:
    """Per-segment loudness (single-block integrated ≈ K-weighted power
    with absolute gate) of ``x`` [C, N] → [n_points] LUFS (-1e9 where
    gated)."""
    n = x.shape[-1]
    starts = segment_starts(n, sr, block_sec, max_points)
    y = yk if yk is not None else k_weight_filter(x, Hk, nfft, staged_tables)
    if starts.size == 0:
        # Track shorter than one block: one integrated measurement region.
        z = y.square().sum(-1, keepdim=True) / max(n, 1)
        return gated_loudness(z)[None]
    step = int(starts[1] - starts[0]) if starts.size > 1 else 1
    l_seg = _segment_loudness(y, step, starts.size, int(sr * block_sec))
    return torch.where(l_seg > _ABS_GATE_LUFS, l_seg,
                       torch.full_like(l_seg, -1e9))


def _masked_step(n_valid: int, sr: int, block_sec: float,
                 max_points: int) -> int:
    """The JAX graph's segment step for a traced ``n_valid`` (segment k
    starts at k·step), evaluated on the host in the float32 arithmetic XLA
    compiles it to: a division by a constant becomes a product with the
    float32 reciprocal, and ``n / sr - block_sec`` one fused multiply-add
    (a step one sample shorter than true division gives shifts every
    later segment)."""
    f32, f64 = np.float32, np.float64
    span = f32(f64(f32(n_valid)) * f64(f32(1.0) / f32(sr))
               + f64(f32(-block_sec)))
    per_point = f32(1.0) / f32(block_sec * 0.25)
    n_points = int(np.clip(int(np.floor(f32(span * per_point))) + 1, 1,
                           max_points))
    step_sec = f32(span / f32(max(n_points - 1, 1)))
    return max(int(np.int32(f32(f32(sr) * step_sec))), 1)


def timeline_lufs_masked(x: torch.Tensor, Hk: torch.Tensor, nfft: int,
                         sr: int, n_valid: int, block_sec: float = 0.4,
                         max_points: int = 300,
                         yk: torch.Tensor | None = None,
                         staged_tables=None):
    """Valid-length-masked timeline of a bucket-padded ``x`` [C, N]:
    ``(l_seg [max_points], valid [max_points])``, the loudness of each
    segment (-1e9 where gated) and whether it exists for the valid track
    length.  The stepping is compute_lufs_timeline's with the valid
    duration."""
    y = yk if yk is not None else k_weight_filter(x, Hk, nfft, staged_tables)
    block_samples = int(sr * block_sec)
    step = _masked_step(n_valid, sr, block_sec, max_points)
    starts = np.arange(max_points) * step
    valid = torch.as_tensor(starts + block_samples <= n_valid,
                            device=x.device)
    l_seg = _segment_loudness(y, step, max_points, block_samples)
    l_seg = torch.where((l_seg > _ABS_GATE_LUFS) & valid, l_seg,
                        torch.full_like(l_seg, -1e9))
    return l_seg, valid


def loudness_range_lu(timeline: torch.Tensor) -> torch.Tensor:
    """LRA estimate: p95 - p10 of the valid 3 s short-term values
    (routers/tools.py:56-65), interpolated as ``jnp`` on the sorted valid
    prefix."""
    valid = timeline > -70.0
    cnt = valid.sum()
    s = torch.sort(torch.where(valid, timeline,
                               torch.full_like(timeline, float("inf"))))[0]
    m = (cnt - 1).clamp(min=0).to(torch.float32)

    def pick(q):
        pos = q / 100.0 * m
        lo = torch.floor(pos).long()
        hi = torch.ceil(pos).long()
        frac = pos - lo
        return s[lo] * (1 - frac) + s[hi] * frac

    lra = (pick(95.0) - pick(10.0)).clamp(min=0.0)
    return torch.where(cnt >= 2, lra, torch.zeros_like(lra))


# ---------------------------------------------------------------------------
# True peak (4x oversampled)


@functools.lru_cache(maxsize=None)
def _resample_poly_taps(up: int, down: int) -> np.ndarray:
    """FIR taps replicating scipy.signal.resample_poly's default design
    (kaiser beta=5.0, half length 10*max_rate), scaled by ``up``."""
    from scipy.signal import firwin

    max_rate = max(up, down)
    half_len = 10 * max_rate
    h = firwin(2 * half_len + 1, 1.0 / max_rate, window=("kaiser", 5.0))
    return (h * up).astype(np.float64)


def oversample4(x: torch.Tensor) -> torch.Tensor:
    """4x oversampling matching ``scipy.signal.resample_poly(x, 4, 1)``
    (routers/tools.py:44-53): zero-stuff, then FFT-convolve with the taps
    on ``torch.fft`` at the JAX package's size rule for the backend
    (``fft_staged.site_plan``: 2^25 at a 180 s bucket)."""
    n = x.shape[-1]
    taps = _resample_poly_taps(4, 1)
    half = (len(taps) - 1) // 2
    up = x.new_zeros(x.shape[:-1] + (n, 4))
    up[..., 0] = x
    up = up.reshape(x.shape[:-1] + (4 * n,))
    nfft = fft_staged.site_plan(4 * n + len(taps), x.device)[0]
    h = torch.as_tensor(taps, dtype=x.dtype, device=x.device)
    y = torch.fft.irfft(torch.fft.rfft(up, n=nfft, dim=-1)
                        * torch.fft.rfft(h, n=nfft), n=nfft, dim=-1)
    return y[..., half:half + 4 * n]


def true_peak_dbfs(x: torch.Tensor) -> torch.Tensor:
    peak = oversample4(x).abs().max()
    return 20.0 * torch.log10(peak.clamp(min=1e-12))


# ---------------------------------------------------------------------------
# Stereo correlation / vectorscope / spectrum bars (one track [C, N])


def stereo_correlation(x: torch.Tensor, n_valid=None) -> torch.Tensor:
    """Pearson correlation of L/R (pipeline.py:766-791).  ``x``: [2, N].
    Zero padding beyond ``n_valid`` leaves every sum unchanged, so masking
    reduces to using the valid count in the formula."""
    left = x[0].to(torch.float32)
    right = x[1].to(torch.float32)
    n = float(left.shape[0] if n_valid is None else n_valid)
    sum_l = left.sum()
    sum_r = right.sum()
    sum_lr = (left * right).sum()
    sum_l2 = (left * left).sum()
    sum_r2 = (right * right).sum()
    num = n * sum_lr - sum_l * sum_r
    den = (torch.sqrt((n * sum_l2 - sum_l ** 2).clamp(min=0.0))
           * torch.sqrt((n * sum_r2 - sum_r ** 2).clamp(min=0.0)))
    r = (num / den.clamp(min=1e-20)).clamp(-1.0, 1.0)
    # Degenerate cases resolved host-side (reference returns None / 0.0).
    return torch.where(den < 1e-20, torch.zeros_like(r), r)


@functools.lru_cache(maxsize=None)
def _bar_bins(sr: int, n_fft: int, n_bars: int, min_hz: float,
              max_hz: float) -> tuple:
    """Per bar the rFFT bin range ``[k0, k1]`` (pipeline.py:700-739), as
    an index matrix [n_bars, width] and its mask (empty bars: no bin)."""
    nyq = sr / 2.0
    n_bins = n_fft // 2 + 1
    k0s, k1s = [], []
    for b in range(n_bars):
        f_lo = min_hz * (max_hz / min_hz) ** (b / max(n_bars - 1, 1))
        f_hi = min_hz * (max_hz / min_hz) ** ((b + 1) / max(n_bars - 1, 1))
        k0s.append(max(0, int((f_lo / nyq) * (n_fft // 2))))
        k1s.append(min(n_bins - 1, int(np.ceil((f_hi / nyq) * (n_fft // 2)))))
    k0 = np.asarray(k0s)[:, None]
    k1 = np.asarray(k1s)[:, None]
    width = max(1, int(np.max(np.asarray(k1s) - np.asarray(k0s))) + 1)
    idx = k0 + np.arange(width)[None, :]
    return np.minimum(idx, n_bins - 1), idx <= k1


def _bars_from_frame(frame: torch.Tensor, sr: int, n_fft: int,
                     n_bars: int = 64, min_hz: float = 20.0,
                     max_hz: float = 20000.0) -> torch.Tensor:
    window = torch.as_tensor(np.hanning(n_fft), dtype=frame.dtype,
                             device=frame.device)
    mag = torch.fft.rfft(frame * window).abs() * (2.0 / n_fft)
    idx, mask = _bar_bins(sr, n_fft, n_bars, min_hz, max_hz)
    vals = mag[torch.as_tensor(idx, device=mag.device)]
    peak = torch.where(torch.as_tensor(mask, device=mag.device), vals,
                       torch.full_like(vals, 1e-12)).amax(-1)
    return 20.0 * torch.log10(peak.clamp(min=1e-12))


def spectrum_bars(x: torch.Tensor, sr: int, n_fft: int = 4096,
                  n_bars: int = 64, min_hz: float = 20.0,
                  max_hz: float = 20000.0) -> torch.Tensor:
    """64 log-spaced dB bars from one Hann-windowed frame at the track
    midpoint (pipeline.py:700-739).  ``x``: [C, N] (mono-averaged)."""
    mono = x.mean(0) if x.ndim > 1 else x
    n = mono.shape[-1]
    # jax.lax.dynamic_slice clamps the start so that the frame fits
    start = min(max(0, n // 2 - n_fft // 2), max(n - n_fft, 0))
    return _bars_from_frame(mono[start:start + n_fft], sr, n_fft, n_bars,
                            min_hz, max_hz)


def spectrum_bars_masked(x: torch.Tensor, sr: int, n_valid: int,
                         n_fft: int = 4096, **kw) -> torch.Tensor:
    """Spectrum bars with the analysis frame centered at the *valid*
    midpoint of a bucket-padded track."""
    mono = x.mean(0) if x.ndim > 1 else x
    n_pad = mono.shape[-1]
    start = min(max(n_valid // 2 - n_fft // 2, 0), max(n_pad - n_fft, 0))
    return _bars_from_frame(mono[start:start + n_fft], sr, n_fft, **kw)


def vectorscope_points(x: torch.Tensor, max_points: int = 1000):
    """Decimated L/R Lissajous points [P, 2] (pipeline.py:742-763)."""
    n = x.shape[-1]
    step = max(1, n // max_points)
    idx = torch.arange(0, n, step, device=x.device)[:max_points]
    return torch.stack([x[0][idx], x[1][idx]], dim=-1).clamp(-1.0, 1.0)


def vectorscope_points_masked(x: torch.Tensor, n_valid: int,
                              max_points: int = 1000):
    """(points [P, 2], valid [P]) decimated over the valid region only."""
    n_pad = x.shape[-1]
    step = max(n_valid // max_points, 1)
    idx = torch.arange(max_points, device=x.device) * step
    valid = idx < n_valid
    idx = idx.clamp(max=n_pad - 1)
    pts = torch.stack([x[0][idx], x[1][idx]], dim=-1)
    return pts.clamp(-1.0, 1.0), valid
