"""4x-oversampled true-peak limiter (counterpart of
``amw_tpu/ops/tplimit.py``).

One FFT-oversampled gain computation, then log2-doubling sliding windows:
no per-sample recurrence and no cumulative sum (whose float32
accumulation error at track lengths would swamp the gain).

1. ``up = meters.oversample4(x)``: the true-peak meter's interpolation
   (cuFFT at ``fft_staged.site_plan``'s size, 2^25 for a 180 s bucket), so
   the limiter and the meter agree on what a true peak is.
2. the gain each oversampled position needs, ``min(1, c / |up|)``, against
   the ceiling less a 0.15 dB margin, the loudest channel of each track
   deciding, then decimated 4 -> 1 by the minimum of each group.
3. a symmetric sliding minimum over +-lookahead (log2 shifted minima),
   then a centred power-of-two box average narrower than that window, so
   every averaged gain still respects each peak inside the window.
4. the gain applied at the base rate, and a final clip at the ceiling.

The batch is explicit: a signal is ``[..., C, N]`` and the envelope is
the maximum over the channel axis only (the JAX function, batched by
``vmap``, reduces over every leading axis of one track ``[C, N]``), so a
loud track never limits another.  Every step is a plain torch operation;
no kernel of its own.
"""

from __future__ import annotations

import torch

from ..spec import GraphSpec
from . import validctx
from .meters import oversample4

_MARGIN_DB = 0.15


def _sliding_min_forward(g: torch.Tensor, w: int) -> torch.Tensor:
    """m[t] = min(g[t : t+w]) with the right edge clamped, by log2
    doubling."""
    m = g
    span = 1
    while span < w:
        step = min(span, w - span)
        shifted = torch.cat(
            [m[..., step:], m[..., -1:].expand(m.shape[:-1] + (step,))],
            dim=-1)
        m = torch.minimum(m, shifted)
        span += step
    return m


def _sliding_min_sym(g: torch.Tensor, w: int) -> torch.Tensor:
    """m[t] = min(g[t-w : t+w+1]): a forward pass, then a mirrored one."""
    mf = _sliding_min_forward(g, w + 1)
    return _sliding_min_forward(mf.flip(-1), w + 1).flip(-1)


def _box_same_pow2(g: torch.Tensor, B: int) -> torch.Tensor:
    """Centred width-``B`` (a power of two) moving average with the edges
    replicated: log2(B) shifted adds, float32-stable at any length."""
    half = B // 2
    n = g.shape[-1]
    s = torch.cat([g[..., :1].expand(g.shape[:-1] + (half,)), g,
                   g[..., -1:].expand(g.shape[:-1] + (B - half,))], dim=-1)
    k = 1
    while k < B:
        s = s[..., :-k] + s[..., k:]
        k *= 2
    return s[..., :n] / B


def build_true_peak_limiter(spec: GraphSpec, ceiling_db: float = -1.5,
                            lookahead_ms: float = 1.5, *, device):
    """``(params, fn)``: ``fn(x [..., C, N], params)`` -> limited, like
    ``x``.  A chain module's signature (``models/chain.MODULE_BUILDERS``)
    and the v2 job's ``true_peak_limiter`` stage.

    The smoothed gain is edge-sensitive: in a bucket-padded batch the
    gains over the zero padding are 1, and averaging them into the box
    near the valid end would raise the gain above the exact-length
    graph's.  So where ``n_valid`` is installed (``validctx``) each
    track's gains from its valid end on are pinned to its last valid gain
    before the smoothing, reproducing the exact-length edge.  ``device``:
    the builders' common argument; the limiter has no params to place.
    """
    c_lin = float(10.0 ** ((ceiling_db - _MARGIN_DB) / 20.0))
    limit_sample = float(10.0 ** (ceiling_db / 20.0))
    # the sliding minimum's base-rate half window; the box is the largest
    # power of two not above it (the guarantee needs box <= min window)
    w = max(16, int(round(spec.sr * lookahead_ms / 1000.0)))
    B = 1 << (w.bit_length() - 1)

    def fn(x, params):
        up = oversample4(x)
        env = up.abs().amax(dim=-2)  # [..., 4N]: over the channels only
        # a true division (a float over a tensor multiplies by the
        # reciprocal in PyTorch)
        g = torch.clamp(env.new_tensor(c_lin) / torch.clamp(env, min=1e-9),
                        max=1.0)
        gb = g.reshape(g.shape[:-1] + (spec.n, 4)).amin(dim=-1)  # [..., N]
        nv = validctx.n_valid()
        if nv is not None:
            last = validctx.gather_last(gb, nv)
            t = torch.arange(spec.n, device=gb.device)
            gb = torch.where(t < validctx.per_track(nv, gb), gb, last)
        gb = _box_same_pow2(_sliding_min_sym(gb, w), B)
        return torch.clamp(x * gb.unsqueeze(-2), -limit_sample, limit_sample)

    return [], fn
