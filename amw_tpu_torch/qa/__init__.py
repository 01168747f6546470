"""Offline QA harnesses (counterpart of ``amw_tpu/qa``): regression by
windows; not part of the hot path."""
