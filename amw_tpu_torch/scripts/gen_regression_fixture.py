#!/usr/bin/env python
"""Render the deterministic regression fixture of the stage-by-stage
harness (``qa/mastering_regression.py``).

    python -m amw_tpu_torch.scripts.gen_regression_fixture

A ~165 s stereo 44.1 kHz program covering the harness's three default
metric windows: a quiet tonal intro, a loud dense mid-section with
percussive hits, and a bright late section with deliberate HF content,
the material most likely to expose HF blowup or discontinuity
regressions in the chain.  :func:`render` is pure numpy from ``SEED``
(the JAX package's ``scripts/gen_regression_fixture.py``, of which this
is the port's copy, renders the same array bit for bit); :func:`main`
writes it, rounded to int16 without dither, to
``tests/fixtures/mastering_regression/regression.wav`` under the working
directory, where ``regression_wav_path`` finds it when run from the
repository's root.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

OUT = Path("tests/fixtures/mastering_regression") / "regression.wav"

SR = 44100
DUR = 165.0
SEED = 20260817


def render() -> np.ndarray:
    g = np.random.default_rng(SEED)
    n = int(DUR * SR)
    t = np.arange(n) / SR
    x = np.zeros(n)

    # Sustained chord bed with slow detune movement (whole track).
    for f0, amp in ((110.0, 0.10), (165.0, 0.07), (220.1, 0.06),
                    (330.4, 0.04)):
        x += amp * np.sin(2 * np.pi * (f0 + 0.2 * np.sin(2 * np.pi * 0.05 * t))
                          * t + g.uniform(0, 6))

    # Melody: stepwise sine with vibrato, present everywhere but quiet in
    # the intro.
    steps = g.integers(0, 8, size=int(DUR / 0.5) + 1)
    scale = 440.0 * 2 ** (np.array([0, 2, 3, 5, 7, 8, 10, 12]) / 12.0)
    f_mel = scale[steps][np.minimum((t / 0.5).astype(int), len(steps) - 1)]
    mel = 0.12 * np.sin(2 * np.pi * np.cumsum(f_mel) / SR
                        + 0.1 * np.sin(2 * np.pi * 5.0 * t))
    x += mel

    # Percussive hits every 0.5 s from t=60 s (the loud mid/late sections).
    hit = (g.standard_normal(2000) * np.exp(-np.arange(2000) / 250.0))
    for p in np.arange(60.0, DUR - 0.1, 0.5):
        i = int(p * SR)
        x[i:i + 2000] += 0.35 * hit * g.uniform(0.6, 1.0)

    # Bright late section: filtered noise shimmer + 9-11 kHz arps.
    late = t >= 140.0
    shimmer = g.standard_normal(n) * 0.035
    # crude high-pass via first difference (HF-weighted noise)
    shimmer = np.diff(shimmer, prepend=0.0)
    x += np.where(late, shimmer, 0.0)
    x += np.where(late, 0.05 * np.sin(2 * np.pi * 9800.0 * t), 0.0)

    # Section loudness envelope: quiet intro, ramp at 30-60 s, loud after.
    env = np.interp(t, [0, 10, 30, 60, 140, DUR], [0.25, 0.3, 0.5, 1.0, 1.0, 0.9])
    x *= env

    # Stereo: slight delay + gain tilt on the right channel.
    d = 12
    right = np.concatenate([np.zeros(d), x[:-d]]) * 0.92 + 0.08 * x
    out = np.stack([x, right])
    peak = np.abs(out).max()
    return (out / peak * 0.70).astype(np.float32)


def to_int16(audio: np.ndarray) -> np.ndarray:
    """The WAV's samples: rounded, no dither (deterministic)."""
    return np.round(np.clip(audio, -1, 1) * 32767.0).astype(np.int16)


def main(argv=None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(
        argv)
    from amw_tpu_torch.utils import wav

    OUT.parent.mkdir(parents=True, exist_ok=True)
    audio = render()
    OUT.write_bytes(wav.write_wav_int16(to_int16(audio), SR))
    print(f"wrote {OUT} ({audio.shape[-1] / SR:.0f}s stereo {SR} Hz)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
