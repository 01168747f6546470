"""Batching, meshes of positions, and time sharding (counterpart of
``amw_tpu/parallel``): ``batch.py``, ``mesh.py``, ``timeshard.py``."""

from .batch import batch_master, make_batch_fn, pad_to_bucket  # noqa: F401
from .mesh import make_mesh, shard_batch  # noqa: F401
