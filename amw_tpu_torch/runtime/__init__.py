"""The serving runtime (counterpart of the engine's part of
``amw_tpu/runtime``): ``engine.MasteringEngine`` and the micro-batcher,
stage progress and settings under it."""
