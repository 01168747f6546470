"""The check that the process printing a result holds none of the JAX
stack: ``jax``, ``jaxlib``, ``flax`` or the JAX package ``amw_tpu``,
compared by whole top-level names (``amw_tpu_torch`` is the port)."""

from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "amw_tpu"})


def forbidden_loaded(modules) -> list:
    """The forbidden top-level names among ``modules``' keys."""
    return sorted({m.split(".", 1)[0] for m in modules} & FORBIDDEN)
