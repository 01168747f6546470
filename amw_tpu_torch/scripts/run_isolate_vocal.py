#!/usr/bin/env python
"""Isolate the vocals of an audio file with the port's separators.

    python -m amw_tpu_torch.scripts.run_isolate_vocal in.wav out.wav
        [--model center_extract|htdemucs] [--weights CKPT.npz]
        [--device cuda|cpu]

``center_extract`` (the default) is the STFT centre-extraction
separator; ``htdemucs`` the neural separator on the configured
checkpoint, or on ``--weights`` (the port's ``.npz`` format, or
``bundled``), which is pinned for the run through ``AMW_HTDEMUCS_CKPT``
as the JAX package's ``scripts/run_isolate_vocal.py`` pins its orbax
directory.  Both go through the serving path,
``models/vocal.isolate_vocal_bytes``, on ``device`` (``cuda`` unless
given; raises without a GPU): decode,
resample to the model's rate and back, the DSP separator where no
checkpoint loads.  An orbax directory raises ``ValueError`` naming
``scripts/convert_htdemucs_port.py``.  Writes the vocals as a float32
WAV.
"""

from __future__ import annotations

import argparse
import os

from amw_tpu_torch import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("infile")
    ap.add_argument("outfile")
    ap.add_argument("--model", default="center_extract")
    ap.add_argument("--weights", default=None,
                    help="htdemucs checkpoint (.npz, or 'bundled')")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    with open(args.infile, "rb") as f:
        data = f.read()
    from amw_tpu_torch.models.vocal import isolate_vocal_bytes

    # set for this run only: an in-process caller gets its environment back
    saved = os.environ.get("AMW_HTDEMUCS_CKPT")
    try:
        if args.model == "htdemucs" and args.weights:
            os.environ["AMW_HTDEMUCS_CKPT"] = args.weights
        out = isolate_vocal_bytes(data, args.infile, model=args.model,
                                  device=dev)
    finally:
        if saved is None:
            os.environ.pop("AMW_HTDEMUCS_CKPT", None)
        else:
            os.environ["AMW_HTDEMUCS_CKPT"] = saved
    with open(args.outfile, "wb") as f:
        f.write(out)
    print(f"wrote {args.outfile}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
