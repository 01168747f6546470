"""Host I/O helpers (counterparts of ``amw_tpu/utils``): the WAV codec and
the engine's audio load and export."""
