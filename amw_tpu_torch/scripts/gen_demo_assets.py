#!/usr/bin/env python
"""Render the landing page's A/B demo clips with the port's mastering chain.

    python -m amw_tpu_torch.scripts.gen_demo_assets [--device cuda|cpu]
                                                     [--out DIR]

Two short deterministic clips (an EDM loop and a ballad, synthesized from
``SEED``) are rendered quiet and unmastered, then mastered with the v2
default chain (``models/chain.compile_chain`` at ``target_lufs=-14``,
``standard``) on ``device`` (``cuda`` unless given), and written as 16-bit
WAVs to ``frontend/demos/{edm,ballad}_{original,mastered}.wav``.  The
synthesis, the clip preparation and the int16 rounding are those of the
JAX package's ``scripts/gen_demo_assets.py``, of which this is the port's
copy; nothing is dithered, so a device's render is reproducible.  The
service renders the clips in a thread on its engine's device at start
where they are missing (``runtime/service.py``).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

SR = 44100
DUR = 8.0
SEED = 7
TARGET_LUFS = -14.0
STYLE = "standard"
DEMO_DIR = Path(__file__).resolve().parent.parent.parent / "frontend" / "demos"


def _edm(g, t, n):
    x = np.zeros(n)
    # four-on-floor kick: 150->45 Hz pitch-sweep thump every 0.5 s
    kick_t = np.arange(int(0.25 * SR)) / SR
    kick = np.sin(2 * np.pi * (45 + 105 * np.exp(-kick_t * 28)) * kick_t)
    kick *= np.exp(-kick_t * 9)
    for p in np.arange(0, DUR - 0.3, 0.5):
        i = int(p * SR)
        x[i:i + len(kick)] += 0.8 * kick
    # offbeat hats
    hat = g.standard_normal(3000) * np.exp(-np.arange(3000) / 280.0)
    hat = np.diff(hat, prepend=0)  # HF-weight
    for p in np.arange(0.25, DUR - 0.2, 0.5):
        i = int(p * SR)
        x[i:i + len(hat)] += 0.25 * hat
    # saw bass (8 harmonics), sidechain-ducked against the kick
    f_b = 55.0
    bass = sum(np.sin(2 * np.pi * f_b * k * t) / k for k in range(1, 9))
    duck = 1.0 - 0.75 * np.exp(-np.mod(t, 0.5) * 14)
    x += 0.28 * bass * duck
    # chord stabs every bar
    for p in np.arange(0.25, DUR - 0.6, 2.0):
        i = int(p * SR)
        st = np.arange(int(0.4 * SR)) / SR
        stab = sum(np.sin(2 * np.pi * f * st) for f in (440, 554, 659))
        x[i:i + len(st)] += 0.14 * stab * np.exp(-st * 6)
    return x


def _ballad(g, t, n):
    x = np.zeros(n)
    # arpeggiated piano-ish plucks
    notes = [220.0, 277.2, 329.6, 440.0, 329.6, 277.2]
    for j, p in enumerate(np.arange(0, DUR - 0.4, 0.4)):
        f = notes[j % len(notes)]
        i = int(p * SR)
        st = np.arange(int(0.9 * SR)) / SR
        pluck = sum(np.sin(2 * np.pi * f * k * st) * (0.6 ** (k - 1))
                    for k in (1, 2, 3))
        seg = 0.18 * pluck * np.exp(-st * 3.2)
        x[i:i + len(st)][:n - i] += seg[:n - i]
    # vocal-like formant melody
    f0 = 230 + 40 * np.sin(2 * np.pi * 0.22 * t)
    phase = 2 * np.pi * np.cumsum(f0 + f0 * 0.012
                                  * np.sin(2 * np.pi * 5.2 * t)) / SR
    v = sum(w * np.sin(k * phase)
            for k, w in ((1, 1.0), (2, 0.55), (3, 0.4), (4, 0.22)))
    syll = np.clip(np.sin(2 * np.pi * 1.6 * t + 1.2), 0, 1) ** 0.6
    x += 0.16 * v * syll
    # soft pad
    x += 0.05 * (np.sin(2 * np.pi * 110 * t) + np.sin(2 * np.pi * 164.8 * t))
    return x


def _stereoize(x, g, depth=0.1):
    d = 14
    right = np.concatenate([np.zeros(d), x[:-d]])
    return np.stack([x * (1 + depth / 2), right * (1 - depth / 2)])


CLIPS = (("edm", _edm), ("ballad", _ballad))


def prepare(x: np.ndarray) -> np.ndarray:
    """A deliberately quiet, unmastered render (~-23 LUFS ballpark):
    peak-normalized to 0.35, DC removed, float32."""
    x = np.clip(x / max(np.abs(x).max(), 1e-9) * 0.35, -1, 1)
    return (x - x.mean(axis=-1, keepdims=True)).astype(np.float32)


def source_clips() -> list:
    """[(name, [2, N] float32)]: both clips before mastering, synthesized in
    turn from one generator seeded with ``SEED``."""
    g = np.random.default_rng(SEED)
    n = int(DUR * SR)
    t = np.arange(n) / SR
    return [(name, prepare(_stereoize(synth(g, t, n), g)))
            for name, synth in CLIPS]


def master(x: np.ndarray, device="cuda") -> np.ndarray:
    """``x`` [2, N] through the default chain at -14 LUFS, ``standard``."""
    from amw_tpu_torch.models.chain import compile_chain
    from amw_tpu_torch.spec import GraphSpec

    spec = GraphSpec(sr=SR, n=x.shape[-1], channels=x.shape[0])
    chain = compile_chain(spec, None, target_lufs=TARGET_LUFS, style=STYLE,
                          device=device)
    return chain(x)


def to_int16(x: np.ndarray) -> np.ndarray:
    return np.round(np.clip(x, -1, 1) * 32767.0).astype(np.int16)


def render(out_dir=None, device="cuda") -> dict:
    """Render both clips on ``device`` and write the four WAVs to
    ``out_dir`` (``frontend/demos`` unless given).  Returns
    ``{name: (original, mastered)}``, float32 [2, N] each."""
    from amw_tpu_torch.utils import wav

    out_dir = Path(out_dir) if out_dir is not None else DEMO_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    out = {}
    for name, x in source_clips():
        mastered = master(x, device)
        for tag, buf in (("original", x), ("mastered", mastered)):
            (out_dir / f"{name}_{tag}.wav").write_bytes(
                wav.write_wav_int16(to_int16(buf), SR))
        out[name] = (x, mastered)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None,
                    help="output directory (default: frontend/demos)")
    args = ap.parse_args(argv)
    for name, (x, mastered) in render(args.out, args.device).items():
        print(f"wrote {name}: peak orig {np.abs(x).max():.3f} -> "
              f"mastered {np.abs(mastered).max():.3f}")


if __name__ == "__main__":
    main()
