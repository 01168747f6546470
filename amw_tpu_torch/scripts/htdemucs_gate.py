"""The separation gate of an htdemucs checkpoint, for ``chip_smoke.py``,
the tests and a trained checkpoint: on fresh synthetic four-stem
mixtures, the network's vocals must beat the mixture taken as the vocals
estimate by a wide margin.  The bars, from the JAX package's test of its
trained checkpoint (tests/test_htdemucs_parity.py:233-281), are SNR > 8
dB and > the mixture's + 8 dB at rng seed 987654 (neither the training
nor the evaluation seed) over 4 segments.

    python -m amw_tpu_torch.scripts.htdemucs_gate [CKPT.npz]
        [--device cuda|cpu] [--dtype f32|bf16]

prints both SNRs and the verdict as JSON (the bundled checkpoint without a
path; the inference dtype of the device unless ``--dtype``) and exits 1
where the gate fails.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

GATE_SEED = 987654
GATE_SEGMENTS = 4
GATE_MIN_DB = 8.0      # the vocals SNR
GATE_OVER_MIX_DB = 8.0  # its margin over the mixture's


def synth_batch(rng, batch, n, sr):
    """Four synthetic stems [batch, 4, 2, n] with distinct, learnable
    spectral signatures (a copy of the training corpus of
    scripts/train_htdemucs_tiny.py): vocals (harmonic stack with vibrato
    + formant AM, center-panned), drums (decaying noise bursts), bass (low
    sine), other (mid-band pad)."""
    t = np.arange(n) / sr
    stems = np.zeros((batch, 4, 2, n), np.float32)
    for b in range(batch):
        # drums: 4-8 noise hits with exponential decay
        d = np.zeros(n)
        for _ in range(rng.integers(4, 9)):
            p = rng.integers(0, n - 400)
            d[p:p + 400] += (rng.standard_normal(400)
                             * np.exp(-np.arange(400) / 60.0)
                             * rng.uniform(0.3, 0.8))
        stems[b, 0] = np.stack([d, d * rng.uniform(0.8, 1.0)])
        # bass: low sine with slow envelope
        f_b = rng.uniform(40, 120)
        bass = (np.sin(2 * np.pi * f_b * t + rng.uniform(0, 6))
                * rng.uniform(0.2, 0.5)
                * (0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.3, 2) * t)))
        stems[b, 1] = np.stack([bass, bass])
        # other: mid-band 3-note pad
        pad = np.zeros(n)
        for _ in range(3):
            f_o = rng.uniform(250, 900)
            pad += np.sin(2 * np.pi * f_o * t + rng.uniform(0, 6))
        pad *= rng.uniform(0.06, 0.15)
        pan = rng.uniform(0.4, 1.0)
        stems[b, 2] = np.stack([pad * pan, pad * (1.4 - pan)])
        # vocals: f0 with vibrato, 5 harmonics with formant-ish weights,
        # syllabic AM; strongly center-panned
        f0 = rng.uniform(150, 380)
        vib = f0 * 0.01 * np.sin(2 * np.pi * 5.5 * t)
        phase = 2 * np.pi * np.cumsum(f0 + vib) / sr
        v = np.zeros(n)
        for h, w in enumerate((1.0, 0.6, 0.45, 0.3, 0.2), start=1):
            v += w * np.sin(h * phase + rng.uniform(0, 6))
        syll = np.clip(np.sin(2 * np.pi * rng.uniform(2, 4) * t
                              + rng.uniform(0, 6)), 0, 1) ** 0.5
        v *= syll * rng.uniform(0.15, 0.35)
        stems[b, 3] = np.stack([v, v * rng.uniform(0.95, 1.0)])
    return np.clip(stems, -1, 1)


def vocals_snr(model, seed: int = GATE_SEED,
               segments: int = GATE_SEGMENTS) -> tuple[float, float]:
    """(network, mixture) vocals SNR in dB of ``model`` (an
    ``htdemucs.HTDemucs`` on its device, in its dtype) on ``segments``
    fresh mixtures of one segment each, drawn from ``seed``."""
    from ..models import htdemucs

    cfg = model.cfg
    stems = synth_batch(np.random.default_rng(seed), segments,
                        cfg.segment_samples, cfg.samplerate)
    mix = stems.sum(axis=1).astype(np.float32)
    pred = htdemucs.forward(model, mix).cpu().numpy()
    voc_true = stems[:, cfg.sources.index("vocals")]

    def snr(est):
        return float(10 * np.log10(np.sum(voc_true ** 2)
                                   / max(np.sum((est - voc_true) ** 2),
                                         1e-12)))

    return snr(pred[:, cfg.sources.index("vocals")]), snr(mix)


def passes(s_model: float, s_mix: float) -> bool:
    return s_model > GATE_MIN_DB and s_model > s_mix + GATE_OVER_MIX_DB


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", nargs="?", default=None,
                    help="checkpoint (.npz); default: the bundled one")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--dtype", default=None, choices=["f32", "bf16"])
    args = ap.parse_args(argv)
    import torch

    from .. import resolve_device
    from ..models import htdemucs, vocal

    dev = resolve_device(args.device)
    path = vocal.BUNDLED if args.path is None else args.path
    cfg, state = htdemucs.load_params(path)
    dtype = ({"f32": torch.float32, "bf16": torch.bfloat16}[args.dtype]
             if args.dtype else htdemucs.inference_dtype(dev))
    model = htdemucs.inference_model(cfg, state, device=dev, dtype=dtype)
    s_model, s_mix = vocals_snr(model)
    ok = passes(s_model, s_mix)
    print(json.dumps({"path": path, "dtype": str(dtype).split(".")[-1],
                      "vocals_snr_db": s_model, "mixture_snr_db": s_mix,
                      "passes": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
