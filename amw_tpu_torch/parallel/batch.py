"""Length buckets of the serving engine (from ``amw_tpu/parallel/batch.py``).

Tracks are padded with zeros up to a bucket length so that one graph
serves a range of durations; each track's true length travels as its
``n_valid`` (``ops/validctx.py``), so loudness gating, filter edges and
fades anchor at the real track end.  The engine picks the bucket and pads
(``runtime/engine.MasteringEngine._spec_for``, ``_pad``).  The JAX
module's ``pad_to_bucket`` and its vmapped, mesh-sharded batch builders
are not ported (``amw_tpu/parallel/batch.py``); the port's graphs take an
explicit batch axis instead.
"""

from __future__ import annotations

# The long tail (> 600 s) covers DJ-set uploads (reference: 800 MB WAV ≈
# 75 min of 16-bit stereo, config.py:26-33): ~1.4× spaced so padding waste
# stays ≤ 40 % while distinct long uploads share one bucket.  The serving
# engine caps how far up the ladder it buckets via
# ``engine_max_bucket_sec``.
DEFAULT_BUCKETS_SEC = tuple(float(s) for s in
                            (15, 30, 60, 90, 120, 150, 180, 240, 300, 420,
                             600, 900, 1260, 1800, 2520, 3600))

