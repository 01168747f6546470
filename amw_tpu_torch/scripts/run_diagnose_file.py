#!/usr/bin/env python
"""Diagnose one audio file with the port's default chain.

    python -m amw_tpu_torch.scripts.run_diagnose_file file.wav
        [--device cuda|cpu]

Decodes the WAV, prints its integrated loudness, true peak
(``qa/gates.py``) and sample peak, then runs the v2 default chain stage
by stage on ``device`` (``cuda`` unless given; raises without a GPU;
``qa/mastering_regression.metrics_after_each_stage``) and prints each
stage's metrics (HF RMS above 8 kHz, largest first difference) in three
windows of the track: the first 10 s, 45-55 % of it, and the last 6 s.
The lines are those of the JAX package's
``scripts/run_diagnose_file.py``.  Exit code 2 without a file.
"""

from __future__ import annotations

import argparse

import numpy as np

from amw_tpu_torch import resolve_device


def windows(dur: float) -> tuple:
    return (("intro", 0.0, min(10.0, dur)),
            ("mid", dur * 0.45, min(dur * 0.55, dur)),
            ("late", max(dur - 6.0, 0.0), dur))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("file", nargs="?")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.file is None:
        print("usage: run_diagnose_file.py file.wav")
        return 2
    dev = resolve_device(args.device)

    from amw_tpu_torch.qa import gates
    from amw_tpu_torch.qa.mastering_regression import metrics_after_each_stage
    from amw_tpu_torch.utils import wav

    with open(args.file, "rb") as f:
        audio, sr = wav.read_wav(f.read())
    dur = audio.shape[-1] / sr
    print(f"{args.file}: {audio.shape[0]}ch {dur:.1f}s @ {sr} Hz")
    print(f"  integrated: {gates.integrated_lufs(audio, sr, device=dev):.2f}"
          " LUFS")
    print(f"  true peak : {gates.true_peak_dbfs(audio, sr, device=dev):.2f}"
          " dBTP")
    peak = float(np.max(np.abs(audio)))
    print(f"  peak      : {20 * np.log10(max(peak, 1e-12)):.2f} dBFS")
    print("\nstage-by-stage window metrics (default chain):")
    for row in metrics_after_each_stage(audio, sr, windows(dur), device=dev):
        cells = "  ".join(
            f"{k}: hf={m['hf_rms']:.4f} d={m['max_abs_diff']:.3f}"
            for k, m in row["windows"].items())
        print(f"  {row['stage']:24s} {cells}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
