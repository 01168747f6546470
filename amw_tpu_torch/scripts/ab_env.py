"""Time the envelope kernels of the ``amw_tpu_torch`` package found in the
current directory on one GPU:

- kernel 2 ``env_gain_cuda`` (the de-esser's 4 ms / 85 ms envelope →
  gain) at the 180 s batch's [16, 7 938 000], two tracks padded (150 s,
  97.5 s), at ``chunk_geometry``'s chunks and at the card geometry of the
  ``scan_geometry`` beside this script (read from this file's package, so
  a parent checkout is timed at the same chunks); the same two geometries
  at the other shapes the v1 and v2 runs give it: the 5 s batch's
  [16, 220 500], the 2 s clip's [2, 88 200], one 180 s mono track's
  [1, 7 938 000] and one stereo track's [2, 7 938 000];
- kernel 3 ``env_rows_cuda`` (one sequence a row) at the 2 s clip's own
  [2, 88 200] and at [16, 88 200];
- the control, kernel 2′ ``env_scan_cuda`` (the chunked envelope) with the
  transient designer's slow (5 ms / 100 ms) follower at that card
  geometry.

    cd <checkout> && python <this file>

It compares two checkouts on one card: run it in the parent's and the
change's checkout in turns (parent, change, change, parent) within one
machine; it times the package of the directory it runs in, so one copy
of the script serves both (``cd <parent> && python <change>/amw_tpu_torch/
scripts/ab_env.py``).  Prints one JSON line: the checkout, the card's
name and power limit (``nvidia-smi``), each call's geometry and CUDA-event
median over 50 launches after 20 warm-up launches, on the same seeded
inputs in every checkout.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from amw_tpu_torch.ops import _cuda  # noqa: E402
from amw_tpu_torch.ops import scan  # noqa: E402
from amw_tpu_torch.scripts.ab_bccb import median_ms  # noqa: E402

SR = 44100
ROWS, N = 16, 7_938_000
CLIP_N = 88_200


def _card_geometry():
    """``scan_geometry`` of the package beside this file."""
    path = Path(__file__).resolve().parents[1] / "ops" / "scan.py"
    spec = importlib.util.spec_from_file_location("_ab_env_scan", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.scan_geometry


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ab_env: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    _cuda.build()
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card_geometry = _card_geometry()
    g = torch.Generator(device="cpu").manual_seed(0)
    out = {"checkout": os.getcwd(), "nvidia_smi": smi, "sms": sms}
    att, rel = scan.ar_coefs(SR, 0.004, 0.085)
    w0 = scan.warmup_len(att, rel)
    sc = (0.3 * torch.randn(ROWS, N, generator=g)).to(dev)
    nv = torch.tensor([N] * (ROWS - 4) + [int(150 * SR)] * 2
                      + [int(97.5 * SR)] * 2, dtype=torch.int32, device=dev)
    for geo, (W, C, K) in (("chunk", scan.chunk_geometry(ROWS, N, w0)),
                           ("card", card_geometry(ROWS, N, w0, sms))):
        out[f"env_gain_{geo}_WCK"] = [W, C, K]
        out[f"env_gain_{geo}_ms"] = median_ms(lambda: scan.env_gain_cuda(
            sc, nv, W, C, K, att, rel, 10 ** (-6.0 / 20), 3.0, 0.35))
    for rows, n in ((16, 220_500), (2, CLIP_N), (1, N), (2, N)):
        x = sc[:rows, :n].contiguous()
        nvr = torch.full((rows,), n, dtype=torch.int32, device=dev)
        for geo, (W, C, K) in (("chunk", scan.chunk_geometry(rows, n, w0)),
                               ("card", card_geometry(rows, n, w0, sms))):
            key = f"env_gain_{rows}x{n}_{geo}"
            out[f"{key}_WCK"] = [W, C, K]
            out[f"{key}_ms"] = median_ms(lambda: scan.env_gain_cuda(
                x, nvr, W, C, K, att, rel, 10 ** (-6.0 / 20), 3.0, 0.35))
    del sc, x
    att, rel = scan.ar_coefs(SR, 0.005, 0.1)
    vc = (0.3 * torch.randn(ROWS, CLIP_N, generator=g)).abs().to(dev)
    for rows in (2, ROWS):
        vr = vc[:rows].contiguous()
        out[f"env_rows_{rows}_ms"] = median_ms(
            lambda: scan.env_rows_cuda(vr, att, rel))
    v = (0.3 * torch.randn(ROWS, N, generator=g)).abs().to(dev)
    W, C, K = card_geometry(ROWS, N, scan.warmup_len(att, rel), sms)
    out["env_scan_slow_card_WCK"] = [W, C, K]
    out["env_scan_slow_card_ms"] = median_ms(
        lambda: scan.env_scan_cuda(v, W, C, K, att, rel))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
