"""Realtime factor: the valid audio seconds of every batch completed in
the window (padding not counted) over the window's seconds."""

UNIT = "audio_s/s"


def read(run):
    return run.window.rate()
