#!/usr/bin/env python
"""Quick audio smoke test of the port's chains.

    python -m amw_tpu_torch.scripts.run_audio_test [--device cuda|cpu]

Generates an 8 s stereo test tone, masters it through the v1 chain
(``models/pipeline_v1.master_v1``) and through the default v2 chain
(``models/chain.compile_chain`` at -14 LUFS) on ``device`` (``cuda``
unless given; raises without a GPU), checks that both land within
±2.5 LU of -14 LUFS (``qa/gates.py``), and writes both as dithered
16-bit WAVs, ``test_output_v1.wav`` and ``test_output_v2.wav``, into the
working directory, as the JAX package's ``scripts/run_audio_test.py``
does.  Prints PASS (exit 0) or FAIL (exit 1).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from amw_tpu_torch import resolve_device

SR = 44100
DUR = 8
TARGET_LUFS = -14.0
LU_TOL = 2.5


def test_tone(sr=SR):
    t = np.arange(DUR * sr) / sr
    x = (0.3 * np.sin(2 * np.pi * 220 * t)
         + 0.1 * np.sin(2 * np.pi * 2000 * t)).astype(np.float32)
    return np.stack([x, 0.85 * x])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from amw_tpu_torch.models import compile_chain
    from amw_tpu_torch.models.pipeline_v1 import master_v1
    from amw_tpu_torch.qa import gates
    from amw_tpu_torch.spec import GraphSpec
    from amw_tpu_torch.utils.audio_io import export_audio

    sr = SR
    mix = test_tone(sr)
    ok = True

    out1 = master_v1(mix, sr, target_lufs=TARGET_LUFS, device=dev)
    l1 = gates.integrated_lufs(out1, sr, device=dev)
    print(f"v1: {l1:.2f} LUFS, "
          f"TP {gates.true_peak_dbfs(out1, sr, device=dev):.2f} dBTP")
    ok &= abs(l1 - TARGET_LUFS) < LU_TOL

    spec = GraphSpec(sr=sr, n=mix.shape[-1], channels=2)
    chain = compile_chain(spec, target_lufs=TARGET_LUFS, device=dev)
    with torch.no_grad():
        y2 = chain.fn(torch.from_numpy(mix).to(dev), chain.params)
    out2 = y2.cpu().numpy()
    l2 = gates.integrated_lufs(out2, sr, device=dev)
    print(f"v2: {l2:.2f} LUFS, "
          f"TP {gates.true_peak_dbfs(out2, sr, device=dev):.2f} dBTP")
    ok &= abs(l2 - TARGET_LUFS) < LU_TOL

    for name, y in (("test_output_v1.wav", torch.from_numpy(out1).to(dev)),
                    ("test_output_v2.wav", y2)):
        with open(name, "wb") as f:
            f.write(export_audio(y, sr, "wav"))
    print("wrote test_output_v1.wav / test_output_v2.wav")
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
