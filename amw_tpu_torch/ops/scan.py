"""Attack/release envelope followers and the de-esser gain tail.

Counterpart of ``amw_tpu/ops/scan.py``.  The recurrence is

    env[t] = c_t * env[t-1] + (1 - c_t) * v[t]
           = v[t] + c_t * (env[t-1] - v[t]),
    c_t    = attack_coef  if v[t] > env[t-1] else release_coef,

a contraction with factor ``max(attack, release) < 1``, so the time axis
splits into chunks that each run a warm-up of ``W`` samples (the tail of
the previous chunk) before their own ``C`` samples and then equal the
exact recurrence to ``eps``.  Chunk 0's warm-up is ``v[0]``, the
recurrence's fixed point, which reproduces ``env[0] = v[0]``.

Three CUDA kernels, each beside its plain PyTorch version, which runs only
for a tensor on the CPU:

- :func:`env_gain` (the de-esser's envelope → gain): ``csrc/env_gain.cu``
  / :func:`env_gain_plain` (replaces ``_win_scan_pallas`` in gain mode);
- :func:`envelope_follower`, the route the JAX package takes for long
  signals: the chunked envelope ``csrc/env_scan.cu`` ``amw_env_scan`` /
  :func:`env_scan_plain` (replaces ``_win_scan_pallas`` in envelope mode);
- its route for short signals (``n <= max(2·W, 2·min_chunk)``, the JAX
  package's ``_env_blocks``): the exact recurrence along each row,
  ``amw_env_rows`` / :func:`env_rows_plain` (replaces ``_env_pallas``).

All three are one staged walk (``csrc/env_staged.cuh``, a template over
what the walk reads and stores) over one recurrence core
(``csrc/env_core.cuh``), on the card at :func:`scan_geometry`'s chunks;
the per-row route is that walk at ``(W, C, K) = (0, n, 1)``.
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


# chunk_geometry's default: about this many independent chunk sequences
# per call, chunk lengths in multiples of 256 (the geometry of the envelope
# kernels' first design, one thread a chunk; the card now takes
# scan_geometry's).
_TARGET_SEQS = 4096
_CHUNK_ALIGN = 256
# The plain loop on the CPU pays per step and per sequence: fewer, longer
# chunks there.
_CPU_TARGET_SEQS = 256
# The JAX package's envelope_follower default: signals up to twice this
# (or twice the warm-up) take the one-sequence-per-row route.
MIN_CHUNK = 16384


def chunk_geometry(rows: int, n: int, w0: int,
                   target: int = _TARGET_SEQS) -> tuple[int, int, int]:
    """``(W, C, K)``: warm-up length, chunk length and chunk count for
    ``rows`` sequences of ``n`` samples with warm-up ``w0``.

    A chunk's serial depth is ``W + C``; W is fixed by the ballistics, so
    chunks are cut short enough to give ~``target`` sequences.  When the
    depth would not drop below ``n``, one chunk with no warm-up runs the
    exact recurrence."""
    k_target = max(1, -(-target // max(rows, 1)))
    C = -(-max(-(-n // k_target), 1) // _CHUNK_ALIGN) * _CHUNK_ALIGN
    if w0 + C >= n:
        return 0, max(n, 1), 1
    return w0, C, -(-n // C)


# The envelope kernels' staged walk (csrc/env_staged.cuh): chunks a block
# (its scanning warp), steps a staged tile (:func:`scan_geometry` cuts
# chunks in multiples of it) and blocks resident on one SM (its 51 KB of
# shared memory against an H100 SM's 227 KB).
SCAN_CHUNKS_PER_BLOCK = 32
SCAN_TILE = 128
SCAN_BLOCKS_PER_SM = 4
# Its geometry model: tau, one dependent step of the recurrence (14.19
# clock64 cycles of one warp at the 1980 MHz maximum SM clock of an H100
# 80GB HBM3: chip_smoke.py's env_step phase), and the card's HBM rate.
STEP_NS = 7.17
HBM_BYTES_PER_S = 3.35e12


def scan_geometry(rows: int, n: int, w0: int,
                  sms: int) -> tuple[int, int, int]:
    """``(W, C, K)`` for the chunked envelope kernel on a card with ``sms``
    SMs: ``rows`` sequences of ``n`` samples with warm-up ``w0``.

    C is the multiple of :data:`SCAN_TILE` that minimises the model

        time(C) = max(waves · (w0 + C) · tau,
                      per_sm · 32 · 4 B · (w0 + 2·C) / (3.35 TB/s / sms)),

    K = ceil(n / C), tau = :data:`STEP_NS`: the serial depth of one chunk
    against the bytes of the busiest SM.  A block of
    :data:`SCAN_CHUNKS_PER_BLOCK` chunks reads each chunk's warm-up and
    body window (from device memory: the overlapping windows of a long
    signal do not stay in the 50 MB L2) and writes its body; ``per_sm`` is
    the most blocks an SM gets, ceil(blocks / sms), since blocks on one SM
    share that SM's part of the card's HBM rate and the kernel waits for
    the busiest SM; ``waves`` is how many times the blocks fill the
    card at :data:`SCAN_BLOCKS_PER_SM` a SM.  A smaller C cuts the depth
    and adds warm-up bytes.  Only the C that give every SM a full block
    compete (the smallest C when none does).  When the depth would not
    drop below ``n``, one chunk with no warm-up runs the exact
    recurrence."""
    C = SCAN_TILE * np.arange(1, -(-n // SCAN_TILE) + 1, dtype=np.int64)
    K = -(-n // C)
    blocks = -(-rows * K // SCAN_CHUNKS_PER_BLOCK)
    waves = -(-blocks // (sms * SCAN_BLOCKS_PER_SM))
    per_sm = -(-blocks // sms)
    depth_s = waves * (w0 + C) * STEP_NS * 1e-9
    bytes_s = (per_sm * SCAN_CHUNKS_PER_BLOCK * 4.0 * (w0 + 2 * C)
               / (HBM_BYTES_PER_S / sms))
    t = np.maximum(depth_s, bytes_s)
    full = rows * K >= sms * SCAN_CHUNKS_PER_BLOCK
    C = int(C[np.argmin(np.where(full, t, np.inf))]) if full.any() \
        else SCAN_TILE
    if w0 + C >= n:
        return 0, n, 1
    return w0, C, -(-n // C)


def sm_count(device: torch.device) -> int:
    """The SM count of CUDA ``device``."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def _win_views(vp: torch.Tensor, W: int, C: int, K: int, t0: int,
               tb: int) -> torch.Tensor:
    """Steps ``[t0, t0 + tb)`` of the joined warm-up/body views of a
    signal [rows, n], time-major: ``[tb, rows * K]``.  ``vp`` is the
    signal with one zero appended to each row ([rows, n + 1]).

    Step ``t`` of chunk ``kk`` reads global position ``kk*C - W + t``:
    the JAX package's warm-up view ``P`` [M, W] for ``t < W`` and its body
    view ``A`` [M, C] after (``amw_tpu`` scan.py ``_win_views``), built a
    block of steps at a time.  Positions below 0 read ``vp[:, 0]`` (the
    fixed point), positions from ``n`` on read 0 (the body's right pad)."""
    rows, n = vp.shape[0], vp.shape[1] - 1
    pos = (torch.arange(K, device=vp.device)[None, :] * C - W + t0
           + torch.arange(tb, device=vp.device)[:, None])  # [tb, K]
    slab = vp[:, pos.clamp(min=0, max=n)]  # [rows, tb, K]
    return slab.permute(1, 0, 2).reshape(tb, rows * K)


def _gain_map(env, thresh, ratio, floor):
    red = torch.where(env > thresh, thresh + (env - thresh) / ratio, env)
    g = torch.where(env > 1e-10, red / (env + 1e-12), torch.ones_like(env))
    return g.clamp(floor, 1.0)


def _env_chunks(v2: torch.Tensor, W: int, C: int, K: int, attack: float,
                release: float) -> torch.Tensor:
    """The chunked recurrence over ``v2`` [rows, n] (nonnegative): each
    chunk's body envelope, ``[rows * K, C]``.  The state starts at each
    chunk's first warm-up value, as in the kernels, and each step is the
    kernels' ``e = v + c·(e - v)``, in place (the loop runs one step per
    Python iteration)."""
    tb = 512
    dev = v2.device
    M = v2.shape[0] * K
    a = torch.tensor(attack, dtype=v2.dtype, device=dev)
    r = torch.tensor(release, dtype=v2.dtype, device=dev)
    e = torch.empty(M, dtype=v2.dtype, device=dev)
    up = torch.empty(M, dtype=torch.bool, device=dev)
    c = torch.empty_like(e)
    d = torch.empty_like(e)
    body = torch.empty((C, M), dtype=v2.dtype, device=dev)  # time-major
    vp = F.pad(v2, (0, 1))  # index n reads the zero pad
    for t0 in range(0, W + C, tb):
        blk = _win_views(vp, W, C, K, t0, min(tb, W + C - t0))
        if t0 == 0:
            e.copy_(blk[0])
        for t in range(blk.shape[0]):
            v = blk[t]
            torch.gt(v, e, out=up)
            torch.where(up, a, r, out=c)
            torch.sub(e, v, out=d)
            # body steps write their row of the output and carry it on
            e = torch.addcmul(v, c, d, out=body[t0 + t - W]
                              if t0 + t >= W else e)
    return body.t()


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


def env_scan_plain(v2: torch.Tensor, W: int, C: int, K: int, attack: float,
                   release: float) -> torch.Tensor:
    """Plain PyTorch version of the chunked envelope kernel: the chunked
    recurrence over ``v2`` [rows, n] (nonnegative).  Returns [rows, n]."""
    rows, n = v2.shape
    env = _env_chunks(v2, W, C, K, attack, release)
    return env.reshape(rows, K * C)[:, :n]


def env_rows_plain(v2: torch.Tensor, attack: float,
                   release: float) -> torch.Tensor:
    """Plain PyTorch version of the one-sequence-per-row envelope kernel:
    the exact recurrence along each row of ``v2`` [rows, n], env[0] =
    v[0].  Returns [rows, n]."""
    return _env_chunks(v2, 0, v2.shape[1], 1, attack, release)


def _env_input(name: str, v2: torch.Tensor):
    if not v2.is_cuda or v2.dtype != torch.float32 or v2.ndim != 2:
        raise ValueError(f"{name}: need a CUDA float32 [rows, n] tensor")
    if not v2.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")
    rows, n = v2.shape
    if rows >= 2 ** 31 or n >= 2 ** 31:
        raise ValueError(f"{name}: shape {tuple(v2.shape)} too large")
    return rows, n


def env_scan_cuda(v2: torch.Tensor, W: int, C: int, K: int, attack: float,
                  release: float) -> torch.Tensor:
    """Launch the chunked envelope kernel (replaces ``amw_tpu/ops/scan.py``
    ``_win_scan_pallas`` in envelope mode) on ``v2`` f32 [rows, n]
    (nonnegative, contiguous, on a CUDA device)."""
    from . import _cuda

    rows, n = _env_input("env_scan_cuda", v2)
    if K * C < n or (K - 1) * C >= n or rows * K >= 2 ** 31 or W < 0:
        raise ValueError(f"env_scan_cuda: bad geometry W={W} C={C} K={K} "
                         f"for n={n}")
    out = torch.empty_like(v2)
    _cuda.launch("amw_env_scan", v2, out, rows, n, W, C, K, attack, release)
    env_scan_cuda.launches += 1
    return out


env_scan_cuda.launches = 0


def env_step_cycles(steps: int, attack: float, release: float,
                    device: torch.device) -> int:
    """clock64 cycles that one warp of ``device`` takes for ``steps`` (a
    multiple of 8) dependent steps of the recurrence on register values:
    the latency of the chunked kernels' chain, tau, without their memory
    traffic.  Synchronises."""
    from . import _cuda

    cycles = torch.zeros(1, dtype=torch.int64, device=device)
    sink = torch.empty(32, dtype=torch.float32, device=device)
    _cuda.launch("amw_env_step_clock", cycles, sink, steps, attack, release)
    return int(cycles.item())


def env_rows_cuda(v2: torch.Tensor, attack: float,
                  release: float) -> torch.Tensor:
    """Launch the one-sequence-per-row envelope kernel (replaces
    ``amw_tpu/ops/scan.py`` ``_env_pallas``) on ``v2`` f32 [rows, n]
    (nonnegative, contiguous, on a CUDA device)."""
    from . import _cuda

    rows, n = _env_input("env_rows_cuda", v2)
    out = torch.empty_like(v2)
    _cuda.launch("amw_env_rows", v2, out, rows, n, attack, release)
    env_rows_cuda.launches += 1
    return out


env_rows_cuda.launches = 0


def short_route(n: int, w0: int) -> bool:
    """Does the JAX package's ``envelope_follower`` take its short route
    (one sequence per row, ``_env_blocks``) for ``n`` samples and warm-up
    ``w0``?"""
    return n <= max(2 * w0, 2 * MIN_CHUNK)


def envelope_follower(v: torch.Tensor, attack_coef: float,
                      release_coef: float, *, eps: float = 1e-8):
    """Attack/release envelope of a nonnegative ``v`` ([..., N]); equal to
    the reference's sequential follower to ``eps`` (chunk 0 exactly).

    The route is the JAX package's: short signals (:func:`short_route`) run
    the exact recurrence along each row (:func:`env_rows_cuda`), longer
    ones the chunked recurrence (:func:`env_scan_cuda` at
    :func:`scan_geometry`'s chunks for the card's SM count).  A CUDA tensor
    launches the kernel; a CPU tensor takes its plain version (at
    :func:`chunk_geometry`'s fewer, longer chunks)."""
    n = v.shape[-1]
    if n == 0:
        return v
    on_cpu = not v.is_cuda
    if on_cpu and v.device.type != "cpu":
        raise ValueError(f"envelope_follower: no kernel for {v.device}")
    lead = v.shape[:-1]
    v2 = v.reshape(-1, n)
    rows = v2.shape[0]
    a, r = float(attack_coef), float(release_coef)
    w0 = warmup_len(a, r, eps)
    if short_route(n, w0):
        env = (env_rows_plain(v2, a, r) if on_cpu
               else env_rows_cuda(v2.contiguous(), a, r))
    elif on_cpu:
        env = env_scan_plain(v2, *chunk_geometry(rows, n, w0,
                                                 _CPU_TARGET_SEQS), a, r)
    else:
        env = env_scan_cuda(v2.contiguous(),
                            *scan_geometry(rows, n, w0, sm_count(v2.device)),
                            a, r)
    return env.reshape(lead + (n,))


def envelope_follower_xsr(x: torch.Tensor, sr: float, attack_sec: float,
                          release_sec: float, **kw) -> torch.Tensor:
    """Reference ``_envelope_follower`` (pipeline.py:510-518): the
    envelope of ``|x|`` ([..., N]) through :func:`envelope_follower`, so
    a CUDA tensor launches its kernel (the chunked one, or the per-row one
    on the short route).  ``kw`` goes on to it: ``eps`` only.  The JAX
    follower's ``min_chunk`` and ``unroll`` are knobs of its XLA route,
    which has no counterpart here; passing one raises ``TypeError``."""
    att, rel = ar_coefs(sr, attack_sec, release_sec)
    return envelope_follower(x.abs(), att, rel, **kw)


def deesser_gain_combine(y3: torch.Tensor, sc: torch.Tensor, attack: float,
                         release: float, thresh: float, ratio: float, k: int,
                         *, floor: float = 0.35, nv=None,
                         eps: float = 1e-8) -> torch.Tensor:
    """``y3 - sc + sc * gain`` with the de-esser's smoothed gain curve:
    envelope → gain (:func:`env_gain`: on the card at :func:`scan_geometry`'s
    chunks, on the CPU at :func:`chunk_geometry`'s), then the k-wide box
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
    w0 = warmup_len(attack, release, eps)
    W, C, K = (scan_geometry(rows, n, w0, sm_count(sc.device)) if sc.is_cuda
               else chunk_geometry(rows, n, w0, _CPU_TARGET_SEQS))
    gain = env_gain(sc.reshape(rows, n).contiguous(), nv_rows, W, C, K,
                    attack, release, thresh, ratio, floor)
    gain = box_smooth_same(gain, k).clamp(floor, 1.0)
    return y3 - sc + sc * gain.reshape(lead + (n,))
