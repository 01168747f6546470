"""Batching helpers (counterpart of ``amw_tpu/parallel``); see
``parallel/batch.py``."""
