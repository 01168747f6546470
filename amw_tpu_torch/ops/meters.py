"""BS.1770 integrated loudness and the LUFS normalization gain.

Counterpart of the loudness core of ``amw_tpu/ops/meters.py``:
K-weighting as a frequency-domain causal filter, 400 ms / 75 %-overlap
block energies, and two-stage (-70 LUFS absolute, -10 LU relative) gating.
Block framing reproduces pyloudnorm's indexing (``numBlocks = round((T -
0.4)/0.1) + 1``, block ``j`` covering ``[int(0.1*j*sr), int((0.1*j +
0.4)*sr))``, energies divided by ``0.4*sr``).

The JAX functions take one track ``[C, N]`` and are batched by ``vmap``;
here loudness is per track over any leading batch axes: signals are
``[..., C, N]`` with channels on axis -2, block energies ``[..., C, J]``,
and a loudness or gain has the leading shape ``[...]``.
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


def k_weight_filter(x: torch.Tensor, Hk: torch.Tensor, nfft: int):
    """K-weighted signal (causal, zero state); ``Hk`` packed [2, nbins]."""
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
