"""Share card renderer: 1200x630 PNG with waveform + job metrics
(reference: backend/app/services/share_card.py, Pillow-based; this one is
pure numpy + the in-tree PNG writer).

The port's copy of ``amw_tpu/runtime/share_card.py``: the same PNG bytes
for the same job dict.
"""

from __future__ import annotations

import numpy as np

from ..utils import wav
from ..utils.png import draw_text, encode_png

W, H = 1200, 630
BG = np.array([18, 20, 34], np.uint8)
ACCENT = np.array([122, 92, 255], np.uint8)
WAVE = np.array([96, 200, 255], np.uint8)
TEXT = np.array([235, 238, 245], np.uint8)
DIM = np.array([140, 148, 170], np.uint8)


def render_share_png(job: dict) -> bytes | None:
    """PNG bytes for a completed job dict (filename, style, before/after
    LUFS, result_bytes as WAV when available for the waveform)."""
    img = np.empty((H, W, 3), np.uint8)
    img[:] = BG
    # Accent bar
    img[0:8, :] = ACCENT

    draw_text(img, 60, 50, "MAGIC MASTER", TEXT, 6)
    draw_text(img, 60, 110, "TPU MASTERING", DIM, 3)

    fname = (job.get("filename") or "track")[:34]
    draw_text(img, 60, 170, fname, TEXT, 3)
    style = str(job.get("style") or "standard")
    draw_text(img, 60, 215, f"STYLE: {style}", DIM, 3)

    before = job.get("before_lufs")
    after = job.get("after_lufs")
    if before is not None and after is not None:
        draw_text(img, 60, 260,
                  f"{float(before):+.1f} LUFS  ->  {float(after):+.1f} LUFS",
                  ACCENT, 4)

    # Waveform from the result (if WAV) or a stylized placeholder.
    env = None
    blob = job.get("result_bytes")
    if blob and bytes(blob[:4]) == b"RIFF":
        try:
            audio, _sr = wav.read_wav(blob)
            mono = np.abs(audio).max(axis=0)
            cols = np.array_split(mono, 1080)
            env = np.array([c.max() if len(c) else 0.0 for c in cols])
        except Exception:  # noqa: BLE001
            env = None
    if env is None:
        t = np.linspace(0, 24, 1080)
        env = 0.5 + 0.45 * np.abs(np.sin(t) * np.sin(t * 2.7))
    env = np.clip(env / max(float(env.max()), 1e-6), 0.02, 1.0)
    y_mid = 450
    for i, e in enumerate(env):
        half = int(e * 110)
        x = 60 + i
        if x >= W - 60:
            break
        img[y_mid - half:y_mid + half + 1, x] = WAVE

    draw_text(img, 60, 580, "MASTERED ON TPU / MAGICMASTER", DIM, 2)
    return encode_png(img)
