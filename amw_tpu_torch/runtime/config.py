"""Settings of the serving engine (the engine's part of
``amw_tpu/runtime/config.py``).

The same field names and defaults as the JAX package's, read from the
environment with the reference's ``MAGIC_MASTER_`` prefix or the ``AMW_``
alias.  Only the fields the engine reads are here; the service's come with
it (``engine_warmup_buckets`` among them: the service reads it, not the
engine).  One difference: the JAX engine asks ``settings_store`` for
``vocal_isolation_enabled`` (a database override first, this setting as
the default); the port reads this setting alone until ``settings_store``
is ported.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields


def _env(name: str, default):
    for prefix in ("MAGIC_MASTER_", "AMW_"):
        v = os.environ.get(prefix + name.upper())
        if v is None:
            continue
        if isinstance(default, bool):
            return v.strip().lower() in ("1", "true", "yes", "on", "y")
        if isinstance(default, int):
            try:
                return int(v)
            except ValueError:
                return default
        if isinstance(default, float):
            try:
                return float(v)
            except ValueError:
                return default
        return v
    return default


@dataclass
class Settings:
    vocal_isolation_enabled: bool = False

    engine_exact_mode: bool = True
    # Coalesce concurrent same-graph jobs into one batch (see
    # runtime/batcher.py).  Single jobs pay only the batch window (50 ms)
    # over solo latency.
    engine_micro_batch: bool = True
    engine_batch_window_ms: float = 50.0
    engine_max_micro_batch: int = 8
    # Highest bucket of the length ladder the engine pads up to
    # (parallel/batch.DEFAULT_BUCKETS_SEC); longer uploads run at exact
    # length.
    engine_max_bucket_sec: float = 2520.0

    def __post_init__(self):
        for f in fields(self):
            object.__setattr__(self, f.name, _env(f.name, getattr(self, f.name)))


settings = Settings()
