#!/usr/bin/env python
"""Self-diagnosis gates of the port's v1 chain.

    python -m amw_tpu_torch.scripts.run_self_diagnosis [--device cuda|cpu]

Masters a synthetic 12 s stereo track (:func:`make_track`) once per
platform preset (``PRESET_LUFS``) through ``models/pipeline_v1.master_v1``
at ``standard`` on ``device`` (``cuda`` unless given; raises without a
GPU) and checks the acceptance gates of the JAX package's
``scripts/run_self_diagnosis.py``: output loudness within ±1 LU of the
target, true peak ≤ -1.5 dBTP with 1 dB of tolerance, every sample
finite.  The meters are the port's (``qa/gates.py``), on the same
device.  Prints one line a preset in the JAX script's format; exit code
0 when every gate passes, 1 otherwise.
"""

from __future__ import annotations

import argparse

import numpy as np

from amw_tpu_torch import resolve_device
from amw_tpu_torch.constants import PRESET_LUFS

SR = 44100
DUR = 12.0
STYLE = "standard"
LU_TOL = 1.0
TP_LIMIT_DB = -1.5 + 1.0


def make_track(sr=SR, dur=DUR):
    g = np.random.default_rng(0)
    t = np.arange(int(sr * dur)) / sr
    x = (0.3 * np.sin(2 * np.pi * 220 * t)
         + 0.1 * np.sin(2 * np.pi * 2000 * t)
         + 0.04 * g.standard_normal(len(t)))
    env = 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 0.5 * t))
    return np.clip(np.stack([x * env, 0.85 * x * env]), -0.99,
                   0.99).astype(np.float32)


def diagnose(preset: str, x: np.ndarray, sr: int, device) -> dict:
    """One preset's master of ``x`` and its gates."""
    from amw_tpu_torch.models.pipeline_v1 import master_v1
    from amw_tpu_torch.qa import gates

    target = PRESET_LUFS[preset]
    out = master_v1(x, sr, target_lufs=target, style=STYLE, device=device)
    lufs = gates.integrated_lufs(out, sr, device=device)
    tp = gates.true_peak_dbfs(out, sr, device=device)
    finite = bool(np.all(np.isfinite(out)))
    ok = abs(lufs - target) <= LU_TOL and tp <= TP_LIMIT_DB and finite
    return {"preset": preset, "target": target, "lufs": lufs, "tp": tp,
            "finite": finite, "ok": ok, "out": out}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    x = make_track(SR)
    failures = []
    for preset in PRESET_LUFS:
        r = diagnose(preset, x, SR, dev)
        print(f"{preset:10s} target {r['target']:6.1f}  out {r['lufs']:6.2f} "
              f"LUFS  TP {r['tp']:6.2f} dBTP  finite={r['finite']}  "
              f"{'OK' if r['ok'] else 'FAIL'}")
        if not r["ok"]:
            failures.append(preset)
    if failures:
        print(f"FAILED: {failures}")
        return 1
    print("All self-diagnosis gates passed.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
