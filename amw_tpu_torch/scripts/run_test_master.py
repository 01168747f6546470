#!/usr/bin/env python
"""Master a WAV file from the command line with the port's v1 chain.

    python -m amw_tpu_torch.scripts.run_test_master in.wav out.wav
        [--preset spotify] [--style standard] [--target -14]
        [--dither tpdf|ns_e|ns_itu] [--device cuda|cpu]

Decodes ``in.wav`` (``utils/wav.read_wav``), masters it through
``models/pipeline_v1.master_v1`` on ``device`` (``cuda`` unless given;
raises without a GPU) at the preset's loudness or ``--target``, and
writes a dithered 16-bit WAV (``utils/audio_io.export_audio``, the dither
drawn on the device).  Prints the input's and the output's meters
(``qa/gates.py``) and the wall and realtime factor of the master, in the
format of the JAX package's ``scripts/run_test_master.py``.
"""

from __future__ import annotations

import argparse
import time

import torch

from amw_tpu_torch import resolve_device
from amw_tpu_torch.constants import PRESET_LUFS


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("--preset", default=None, choices=sorted(PRESET_LUFS))
    ap.add_argument("--style", default="standard")
    ap.add_argument("--target", type=float, default=-14.0)
    ap.add_argument("--dither", default="tpdf",
                    choices=["tpdf", "ns_e", "ns_itu"])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    from amw_tpu_torch.models.pipeline_v1 import master_v1
    from amw_tpu_torch.qa import gates
    from amw_tpu_torch.utils import wav
    from amw_tpu_torch.utils.audio_io import export_audio

    target = PRESET_LUFS[args.preset] if args.preset else args.target
    with open(args.infile, "rb") as f:
        audio, sr = wav.read_wav(f.read())
    print(f"in : {audio.shape[0]}ch {audio.shape[1]} samples @ {sr} Hz, "
          f"{gates.integrated_lufs(audio, sr, device=dev):.2f} LUFS")
    t0 = time.perf_counter()
    out = master_v1(audio, sr, target_lufs=target, style=args.style,
                    device=dev)
    dt = time.perf_counter() - t0
    dur = audio.shape[-1] / sr
    print(f"mastered in {dt:.2f}s ({dur / dt:.1f}x realtime), "
          f"{gates.integrated_lufs(out, sr, device=dev):.2f} LUFS, "
          f"TP {gates.true_peak_dbfs(out, sr, device=dev):.2f} dBTP")
    blob = export_audio(torch.from_numpy(out).to(dev), sr, "wav",
                        dither_type=args.dither)
    with open(args.outfile, "wb") as f:
        f.write(blob)
    print(f"wrote {args.outfile}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
