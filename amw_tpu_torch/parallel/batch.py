"""Batch mastering: the chain over [B, C, N], optionally over a mesh of
positions (counterpart of ``amw_tpu/parallel/batch.py``).

Length bucketing: tracks are padded with zeros up to a bucket length so
that one graph serves a range of durations; each track's true length
travels as its ``n_valid`` (``ops/validctx.py``), so loudness gating,
filter edges and fades anchor at the real track end.  The serving engine
picks the bucket and pads (``runtime/engine.MasteringEngine._spec_for``,
``_pad``).

Where the JAX builders ``vmap`` the chain and shard the batch axis over a
mesh, the port's graphs already take ``[B, C, N]``: with a mesh
(``parallel/mesh.py``) each position of its first axis runs the chain on
its slice of the batch with the params on its device, and the slices are
joined in order.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.chain import compile_chain
from ..spec import GraphSpec
from .mesh import axis_devices, device_type, replicate, shard_batch

# The long tail (> 600 s) covers DJ-set uploads (reference: 800 MB WAV ≈
# 75 min of 16-bit stereo, config.py:26-33): ~1.4× spaced so padding waste
# stays ≤ 40 % while distinct long uploads share one bucket.  The serving
# engine caps how far up the ladder it buckets via
# ``engine_max_bucket_sec``.
DEFAULT_BUCKETS_SEC = tuple(float(s) for s in
                            (15, 30, 60, 90, 120, 150, 180, 240, 300, 420,
                             600, 900, 1260, 1800, 2520, 3600))



def pad_to_bucket(x: np.ndarray, sr: int, buckets_sec=DEFAULT_BUCKETS_SEC):
    """Pad [C, N] to the smallest bucket >= N.  Returns (padded, n_valid)."""
    n = x.shape[-1]
    for s in buckets_sec:
        bn = int(round(s * sr))
        if bn >= n:
            pad = bn - n
            return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)]), n
    return x, n


# Minimum per-track valid length (seconds) accepted with bucket padding:
# the valid-end edge windows (ops.validctx / ops.fdfilter.odd_ext_valid)
# clamp their indices, so a valid region that does not dominate the largest
# filter settle/edge window would silently get wrong edge semantics instead
# of an error.  The serving engine runs sub-3 s tracks at exact length
# (MasteringEngine.MIN_BUCKET_SEC); this public entry enforces a 1 s floor.
MIN_VALID_SEC = 1.0


def _check_nvb(nvb, spec: GraphSpec) -> np.ndarray:
    nvb = np.asarray(nvb, np.int32)
    min_valid = min(spec.n, int(MIN_VALID_SEC * spec.sr))
    if nvb.size and int(nvb.min()) < min_valid:
        raise ValueError(
            f"per-track valid length {int(nvb.min())} is below the minimum "
            f"{min_valid} samples ({MIN_VALID_SEC:.0f} s at {spec.sr} Hz) for "
            f"bucket-padded graphs; run short tracks at exact length "
            f"instead (see parallel.batch.MIN_VALID_SEC)")
    if nvb.size and int(nvb.max()) > spec.n:
        raise ValueError(
            f"per-track valid length {int(nvb.max())} exceeds the bucket "
            f"length {spec.n}")
    return nvb


def make_batch_fn(spec: GraphSpec, config: dict | None = None, *,
                  mesh=None, device=None, **chain_kw):
    """Returns ``(step, params)``: ``step(xb, params[, nvb])`` computes the
    chain over ``xb`` [B, C, N] (tensor or numpy) with optional per-track
    valid lengths ``nvb`` [B] (validated on the host against
    :data:`MIN_VALID_SEC`), and returns a tensor [B, C, N].

    Without ``mesh`` the chain runs on ``device`` (default ``cuda``).  With
    ``mesh``, ``nvb`` is required: the batch splits evenly over the
    positions of the mesh's first axis, each runs the chain on its slice
    with the params on its device (``params``: one copy per distinct
    device, by device), and the output is joined in order on the first
    position's device."""
    if mesh is None:
        chain = compile_chain(spec, config, device=device, **chain_kw)

        def step(xb, params, nvb=None):
            x = torch.as_tensor(xb, dtype=torch.float32, device=chain.device)
            nv = None if nvb is None else torch.as_tensor(
                _check_nvb(nvb, spec), device=chain.device)
            with torch.inference_mode():
                return chain.fn(x, params, nv)

        return step, chain.params

    device_type(mesh)  # one type: the chain is planned for it
    chain = compile_chain(spec, config, device=mesh.distinct_devices()[0],
                          **chain_kw)
    devs = axis_devices(mesh)

    def step(xb, params, nvb):
        nvb = _check_nvb(nvb, spec)
        xs = shard_batch(xb, mesh)
        nvs = shard_batch(nvb, mesh)
        with torch.inference_mode():
            outs = [chain.fn(x, params[d], nv)
                    for x, nv, d in zip(xs, nvs, devs)]
            return torch.cat([o.to(devs[0]) for o in outs])

    return step, replicate(chain.params, mesh)


def batch_master(xb: np.ndarray, sr: int, config: dict | None = None, *,
                 mesh=None, nvb: np.ndarray | None = None, device=None,
                 **chain_kw) -> np.ndarray:
    """Master a batch [B, C, N] in one step, on ``device`` (default
    ``cuda``) or over ``mesh``.  ``nvb`` [B]: valid length per
    (bucket-padded) track."""
    xb = np.ascontiguousarray(xb, np.float32)
    spec = GraphSpec(sr=sr, n=xb.shape[-1], channels=xb.shape[1])
    fn, params = make_batch_fn(spec, config, mesh=mesh, device=device,
                               **chain_kw)
    if nvb is None:
        if mesh is None:
            return fn(xb, params).cpu().numpy()
        nvb = np.full(xb.shape[0], xb.shape[-1])
    return fn(xb, params, np.asarray(nvb, np.int32)).cpu().numpy()
