"""Attack/release envelope followers and the de-esser gain tail.

Counterpart of ``amw_tpu/ops/scan.py``.  The recurrence is

    env[t] = c_t * env[t-1] + (1 - c_t) * v[t],
    c_t    = attack_coef  if v[t] > env[t-1] else release_coef,

a contraction with factor ``max(attack, release) < 1``, so the time axis
splits into chunks that each run a warm-up of ``W`` samples (the tail of
the previous chunk) before their own ``C`` samples and then equal the
exact recurrence to ``eps``.  Chunk 0's warm-up is ``v[0]``, the
recurrence's fixed point, which reproduces ``env[0] = v[0]``.

:func:`env_gain` (the de-esser's envelope → gain) runs the CUDA kernel
``csrc/env_gain.cu`` on a GPU tensor and its plain PyTorch version
(:func:`env_gain_plain`) on a CPU tensor.  :func:`envelope_follower` is the
plain chunked envelope for CPU tensors; on a CUDA tensor it raises until its
kernels are ported (ROADMAP.md, 'TPU kernels to port': the envelope mode of
``_win_scan_pallas`` and ``_env_pallas``).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F


def ar_coefs(sr: float, attack_sec: float, release_sec: float):
    """One-pole coefficients as in the reference (pipeline.py:515-516)."""
    attack = float(np.exp(-1.0 / max(1e-6, sr * attack_sec)))
    release = float(np.exp(-1.0 / max(1e-6, sr * release_sec)))
    return attack, release


def warmup_len(attack_coef: float, release_coef: float,
               eps: float = 1e-8) -> int:
    rho = max(attack_coef, release_coef)
    if rho <= 0.0:
        return 1
    rho = min(rho, 1.0 - 1e-9)
    return max(1, int(math.ceil(math.log(eps) / math.log(rho))))


# Chunk geometry of the GPU kernel: about this many independent chunk
# sequences (one thread each) per call, chunk lengths in multiples of 256.
_TARGET_SEQS = 4096
_CHUNK_ALIGN = 256


def chunk_geometry(rows: int, n: int, w0: int) -> tuple[int, int, int]:
    """``(W, C, K)``: warm-up length, chunk length and chunk count for
    ``rows`` sequences of ``n`` samples with warm-up ``w0``.

    A thread's serial depth is ``W + C``; W is fixed by the ballistics, so
    chunks are cut short enough to give ~_TARGET_SEQS sequences.  When the
    depth would not drop below ``n``, one chunk with no warm-up runs the
    exact recurrence."""
    k_target = max(1, -(-_TARGET_SEQS // max(rows, 1)))
    C = -(-max(-(-n // k_target), 1) // _CHUNK_ALIGN) * _CHUNK_ALIGN
    if w0 + C >= n:
        return 0, max(n, 1), 1
    return w0, C, -(-n // C)


def _win_views(v2: torch.Tensor, W: int, C: int, K: int, t0: int,
               tb: int) -> torch.Tensor:
    """Steps ``[t0, t0 + tb)`` of the joined warm-up/body views of
    ``v2`` [rows, n], time-major: ``[tb, rows * K]``.

    Step ``t`` of chunk ``kk`` reads global position ``kk*C - W + t``:
    the JAX package's warm-up view ``P`` [M, W] for ``t < W`` and its body
    view ``A`` [M, C] after (``amw_tpu`` scan.py ``_win_views``), built a
    block of steps at a time.  Positions below 0 read ``v2[:, 0]`` (the
    fixed point), positions from ``n`` on read 0 (the body's right pad)."""
    rows, n = v2.shape
    pos = (torch.arange(K, device=v2.device)[None, :] * C - W + t0
           + torch.arange(tb, device=v2.device)[:, None])  # [tb, K]
    vp = F.pad(v2, (0, 1))  # index n reads the zero pad
    idx = pos.clamp(min=0, max=n)
    slab = vp[:, idx]  # [rows, tb, K]
    return slab.permute(1, 0, 2).reshape(tb, rows * K)


def _gain_map(env, thresh, ratio, floor):
    red = torch.where(env > thresh, thresh + (env - thresh) / ratio, env)
    g = torch.where(env > 1e-10, red / (env + 1e-12), torch.ones_like(env))
    return g.clamp(floor, 1.0)


def _env_chunks(v2: torch.Tensor, W: int, C: int, K: int, attack: float,
                release: float) -> torch.Tensor:
    """The chunked recurrence over ``v2`` [rows, n] (nonnegative): each
    chunk's body envelope, ``[rows * K, C]``.  The state starts at each
    chunk's first warm-up value, as in the kernels."""
    tb = 512
    e = None
    body = []
    for t0 in range(0, W + C, tb):
        blk = _win_views(v2, W, C, K, t0, min(tb, W + C - t0))
        if e is None:
            e = blk[0].clone()
        for t, v in enumerate(blk, start=t0):
            coef = torch.where(v > e, attack, release)
            e = coef * e + (1.0 - coef) * v
            if t >= W:
                body.append(e)
    return torch.stack(body, dim=1)


def env_gain_plain(x2: torch.Tensor, nv_rows: torch.Tensor, W: int, C: int,
                   K: int, attack: float, release: float, thresh: float,
                   ratio: float, floor: float) -> torch.Tensor:
    """Plain PyTorch version of the envelope-gain kernel: the same chunked
    recurrence over ``|x2|`` [rows, n], the gain map, and zeros outside
    ``[0, nv_rows[row])``.  Returns [rows, n]."""
    rows, n = x2.shape
    g = _gain_map(_env_chunks(x2.abs(), W, C, K, attack, release),
                  thresh, ratio, floor)
    gidx = (torch.arange(K, device=x2.device).repeat(rows)[:, None] * C
            + torch.arange(C, device=x2.device))
    nv_rep = nv_rows.repeat_interleave(K)[:, None]
    g = torch.where(gidx < nv_rep, g, torch.zeros((), device=g.device))
    return g.reshape(rows, K * C)[:, :n]


def env_gain_cuda(x2: torch.Tensor, nv_rows: torch.Tensor, W: int, C: int,
                  K: int, attack: float, release: float, thresh: float,
                  ratio: float, floor: float) -> torch.Tensor:
    """Launch the envelope-gain kernel (replaces ``amw_tpu/ops/scan.py``
    ``_win_scan_pallas`` in gain mode) on ``x2`` f32 [rows, n] with
    ``nv_rows`` int32 [rows], both contiguous on one CUDA device."""
    from . import _cuda

    if not x2.is_cuda or x2.dtype != torch.float32 or x2.ndim != 2:
        raise ValueError("env_gain_cuda: need a CUDA float32 [rows, n] tensor")
    rows, n = x2.shape
    if (nv_rows.dtype != torch.int32 or nv_rows.shape != (rows,)
            or nv_rows.device != x2.device):
        raise ValueError("env_gain_cuda: n_valid must be int32 [rows] on the "
                         "same device")
    if not (x2.is_contiguous() and nv_rows.is_contiguous()):
        raise ValueError("env_gain_cuda: inputs must be contiguous")
    if K * C < n or (K - 1) * C >= n or rows * K >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"env_gain_cuda: bad geometry W={W} C={C} K={K} "
                         f"for n={n}")
    out = torch.empty_like(x2)
    _cuda.launch("amw_env_gain", x2, nv_rows, out, rows, n, W, C, K,
                 attack, release, thresh, ratio, floor)
    env_gain_cuda.launches += 1
    return out


env_gain_cuda.launches = 0


def env_gain(x2, nv_rows, W, C, K, attack, release, thresh, ratio, floor):
    """De-esser envelope → pre-box gain over ``x2`` [rows, n]: the CUDA
    kernel on a GPU tensor, :func:`env_gain_plain` on a CPU tensor."""
    args = (x2, nv_rows, W, C, K, float(attack), float(release),
            float(thresh), float(ratio), float(floor))
    if x2.is_cuda:
        return env_gain_cuda(*args)
    if x2.device.type != "cpu":
        raise ValueError(f"env_gain: no kernel for {x2.device}")
    return env_gain_plain(*args)


def envelope_follower(v: torch.Tensor, attack_coef: float,
                      release_coef: float, *, eps: float = 1e-8):
    """Attack/release envelope of a nonnegative ``v`` ([..., N]), chunked
    like :func:`env_gain` (plain PyTorch, CPU tensors only; equal to the
    reference's sequential follower to ``eps``, chunk 0 exactly).  The JAX
    package runs Pallas kernels here, which have no Hopper port yet, so a
    CUDA tensor raises ``NotImplementedError``."""
    if v.is_cuda:
        raise NotImplementedError(
            "envelope_follower on CUDA: the JAX package's envelope kernels "
            "(amw_tpu/ops/scan.py _win_scan_pallas in envelope mode, "
            "_env_pallas) have no Hopper port yet (ROADMAP.md, 'TPU kernels "
            "to port', kernels 3 and 2'; 'Modules to port', item 4)")
    if v.device.type != "cpu":
        raise ValueError(f"envelope_follower: no kernel for {v.device}")
    n = v.shape[-1]
    if n == 0:
        return v
    lead = v.shape[:-1]
    v2 = v.reshape(-1, n)
    rows = v2.shape[0]
    W, C, K = chunk_geometry(rows, n, warmup_len(attack_coef, release_coef,
                                                 eps))
    env = _env_chunks(v2, W, C, K, attack_coef, release_coef)
    return env.reshape(rows, K * C)[:, :n].reshape(lead + (n,))


def deesser_gain_combine(y3: torch.Tensor, sc: torch.Tensor, attack: float,
                         release: float, thresh: float, ratio: float, k: int,
                         *, floor: float = 0.35, nv=None,
                         eps: float = 1e-8) -> torch.Tensor:
    """``y3 - sc + sc * gain`` with the de-esser's smoothed gain curve:
    envelope → gain (:func:`env_gain`), then the k-wide box
    (:func:`~amw_tpu_torch.ops.fdfilter.box_smooth_same`) and a clip.

    ``y3``, ``sc``: [B, ..., N]; ``nv``: [B] valid lengths (None = whole
    track), per track through the gain's zeroed tail."""
    from .fdfilter import box_smooth_same

    n = y3.shape[-1]
    lead = sc.shape[:-1]
    rows = int(np.prod(lead)) if lead else 1
    if nv is None:
        nv_rows = torch.full((rows,), n, dtype=torch.int32, device=sc.device)
    else:
        nv_lead = nv.to(torch.int32).reshape(
            nv.shape + (1,) * (len(lead) - nv.ndim)).expand(lead)
        nv_rows = nv_lead.reshape(rows).contiguous()
    W, C, K = chunk_geometry(rows, n, warmup_len(attack, release, eps))
    gain = env_gain(sc.reshape(rows, n).contiguous(), nv_rows, W, C, K,
                    attack, release, thresh, ratio, floor)
    gain = box_smooth_same(gain, k).clamp(floor, 1.0)
    return y3 - sc + sc * gain.reshape(lead + (n,))
