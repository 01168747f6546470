"""Time the staged FFT's fused B/C kernels (8 ``bc_cb_cuda`` and 9
``bccb_multi_cuda`` at K = 2 and 4) of the ``amw_tpu_torch`` package found
in the current directory, at the 180 s batch's shapes (the packed stage-A
output of 16 rows of 7 938 000 samples, nfft = 2^23), on one GPU.

    cd <checkout> && python <this file>

It compares two checkouts on one card: run it in the parent's and the
change's checkout in turns (parent, change, change, parent) within one
machine.  Prints one JSON line: the checkout, the card's name and power
limit (``nvidia-smi``), and each kernel's CUDA-event median over 50
launches after 5 warm-up launches, on the same seeded inputs in every
checkout.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from amw_tpu_torch.ops import _cuda  # noqa: E402
from amw_tpu_torch.ops import fft_staged as fs  # noqa: E402

NFFT = 1 << 23
ROWS, N = 16, 7_938_000


def median_ms(fn, reps: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ab_bccb: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    _cuda.build()
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    tabs = fs._device_tables(NFFT, dev)
    x = (0.3 * torch.randn(ROWS, N, generator=g)).to(dev)
    H = 0.25 + torch.rand(4, NFFT // 2 + 1, generator=g, dtype=torch.float64)
    resps = torch.from_numpy(np.stack([fs.permute_full_response(h.numpy(),
                                                                NFFT)
                                       for h in H])).to(dev)
    Xr, Xi = fs.stage_a_cuda(x[:ROWS // 2], x[ROWS // 2:], NFFT, False, tabs)
    out = {"checkout": os.getcwd(), "nvidia_smi": smi,
           "bc_cb_ms": median_ms(lambda: fs.bc_cb_cuda(Xr, Xi, resps[0], NFFT,
                                                       tabs))}
    for K in (2, 4):
        out[f"bccb_multi_k{K}_ms"] = median_ms(
            lambda K=K: fs.bccb_multi_cuda(Xr, Xi, resps[:K], NFFT, tabs))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
