"""Valid-length context for bucket-padded batches.

Counterpart of ``amw_tpu/ops/validctx.py``.  A track of ``n`` samples is
zero-padded to the bucket length ``spec.n``; its true length travels as
``n_valid``.  In the JAX package that is a traced scalar per track (the
batch comes from ``vmap``); here the batch axis is explicit, so ``n_valid``
is an int tensor ``[B]`` aligned with the LEADING axis of every tensor the
helpers below receive (``[B, ...rest, N]``), and every dynamic slice or
update takes one start index per track.

The pipeline installs ``n_valid`` with :func:`valid_length`; the
edge-sensitive ops (zero-phase splices, odd extensions, loudness gating,
peak and DC reductions) consult it.  With no context every helper
degenerates to the static (bucket-length-is-track-length) behavior.

Invariant maintained by the stage loop: each stage's input is zero beyond
``n_valid`` (:func:`mask_tail` runs between stages).
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

_N_VALID: contextvars.ContextVar = contextvars.ContextVar(
    "amw_torch_n_valid", default=None)


@contextlib.contextmanager
def valid_length(n_valid):
    """Install ``n_valid`` ([B] int tensor, or ``None`` for static
    semantics) for the duration of a graph call."""
    tok = _N_VALID.set(n_valid)
    try:
        yield
    finally:
        _N_VALID.reset(tok)


@contextlib.contextmanager
def cleared():
    """Temporarily clear the context — used around ops applied to extracted
    edge windows (whose static ends coincide with the track ends) and
    around fast interior passes (whose outer samples get spliced over)."""
    tok = _N_VALID.set(None)
    try:
        yield
    finally:
        _N_VALID.reset(tok)


def n_valid():
    return _N_VALID.get()


def per_track(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """``v`` [B] reshaped to broadcast against ``x`` [B, ..., N]."""
    return v.reshape(v.shape + (1,) * (x.ndim - v.ndim))


def _clamped_start(start: torch.Tensor, size: int, w: int) -> torch.Tensor:
    # jax.lax.dynamic_slice / dynamic_update_slice clamp the start so the
    # window stays inside the array; per track here.
    return start.clamp(0, max(size - w, 0))


def take(x: torch.Tensor, start: torch.Tensor, w: int) -> torch.Tensor:
    """``x[b, ..., start[b]:start[b] + w]`` for every track ``b``."""
    s = _clamped_start(start, x.shape[-1], w)
    idx = per_track(s, x) + torch.arange(w, device=x.device)
    return torch.gather(x, -1, idx.expand(x.shape[:-1] + (w,)))


def put(buf: torch.Tensor, vals: torch.Tensor,
        start: torch.Tensor) -> torch.Tensor:
    """Copy of ``buf`` with ``vals`` [..., w] written at ``start[b]`` on
    the last axis of every track ``b``."""
    w = vals.shape[-1]
    s = per_track(_clamped_start(start, buf.shape[-1], w), buf)
    t = torch.arange(buf.shape[-1], device=buf.device)
    rel = t - s
    inside = (rel >= 0) & (rel < w)
    idx = rel.clamp(0, w - 1).expand(buf.shape)
    src = torch.gather(vals.expand(buf.shape[:-1] + (w,)), -1, idx)
    return torch.where(inside, src, buf)


def mask_tail(x: torch.Tensor, nv=None) -> torch.Tensor:
    """Zero positions >= n_valid (no-op without a context)."""
    nv = n_valid() if nv is None else nv
    if nv is None:
        return x
    t = torch.arange(x.shape[-1], device=x.device)
    return torch.where(t < per_track(nv, x), x, torch.zeros((), dtype=x.dtype,
                                                           device=x.device))


def right_window(x: torch.Tensor, w: int, nv=None) -> torch.Tensor:
    """The ``w`` samples ending at the valid end (static ``x[..., -w:]``
    without a context)."""
    nv = n_valid() if nv is None else nv
    if nv is None:
        return x[..., -w:]
    return take(x, (nv - w).clamp(min=0), w)


def splice(fast: torch.Tensor, yl: torch.Tensor, yr: torch.Tensor, n: int,
           L: int, nv=None, off: int = 0) -> torch.Tensor:
    """Edge-window splice anchored at the valid end.

    ``fast``: interior result (may be longer than ``n``, with a leading
    odd extension of ``off`` samples); ``yl``/``yr``: exact left/right
    window results (only their outer ``L`` samples are used)."""
    nv = n_valid() if nv is None else nv
    if nv is None:
        return torch.cat(
            [yl[..., :L], fast[..., off + L:off + n - L], yr[..., -L:]],
            dim=-1)
    out = torch.cat([yl[..., :L], fast[..., off + L:off + n]], dim=-1)
    out = put(out, yr[..., -L:], (nv - L).clamp(min=L))
    return mask_tail(out, nv)


def gather_last(x: torch.Tensor, nv: torch.Tensor) -> torch.Tensor:
    """``x[b, ..., nv[b]-1:nv[b]]`` for every track (keepdims)."""
    return take(x, (nv - 1).clamp(min=0), 1)


def masked_quantile_last(a: torch.Tensor, q: float,
                         count: torch.Tensor) -> torch.Tensor:
    """Linear-interpolated ``q``-th percentile over the last axis when only
    the first ``count[b]`` slots of track ``b`` are real (invalid entries
    pushed to +inf, so they sort last); keeps the last axis (size 1).
    ``count``: [B], aligned with ``a``'s leading axis."""
    return quantile_last_sorted(torch.sort(a, dim=-1).values, q, count)


def quantile_last_sorted(s: torch.Tensor, q: float,
                         count: torch.Tensor) -> torch.Tensor:
    """:func:`masked_quantile_last` of ``s``, sorted along its last axis
    already (one sort serves several percentiles): ``jnp.percentile``'s
    float32 interpolation at ``q / 100 * (count - 1)``."""
    m = (count - 1).clamp(min=0).to(torch.float32)
    pos = per_track(torch.tensor(q, dtype=torch.float32) / 100.0 * m, s)
    lo = pos.floor()
    hi = pos.ceil()
    frac = pos - lo
    shape = s.shape[:-1] + (1,)
    v_lo = torch.gather(s, -1, lo.long().expand(shape))
    v_hi = torch.gather(s, -1, hi.long().expand(shape))
    return v_lo * (1.0 - frac) + v_hi * frac
