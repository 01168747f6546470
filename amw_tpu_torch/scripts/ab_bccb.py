"""Time the staged FFT's B/C kernels of the ``amw_tpu_torch`` package found
in the current directory, at the 180 s batch's shapes (the packed stage-A
output of 16 rows of 7 938 000 samples, nfft = 2^23, C = 512), on one GPU:
the fused round trips, 8 ``bc_cb_cuda`` (also on one unpacked row) and 9
``bccb_multi_cuda`` at K = 2 and 4, and the split stages, 6 ``bc_cuda``,
7 ``cb_cuda`` (one response, none, and one response on one unpacked row)
and 10 ``cb_multi_cuda`` at K = 2 and 4.

    cd <checkout> && python <this file>

It compares two checkouts on one card: run it in the parent's and the
change's checkout in turns (parent, change, change, parent) within one
machine; it times the package of the directory it runs in, so one copy
of the script serves both (``cd <parent> && python <change>/amw_tpu_torch/
scripts/ab_bccb.py``).  Prints one JSON line: the checkout, the card's
name and power limit (``nvidia-smi``), each call's CUDA-event median
over 50 launches after 20 warm-up launches, and, from one torch.profiler
run of 10 calls (ms a launch), the device time of its C pass alone
(``cstage_multi_kernel``, ``cstage_fwd_kernel`` or ``cstage_inv_kernel``)
and, for 8 and 9, of each B pass alone (``breg_fwd_kernel`` and
``breg_inv_kernel``, or the ``col_dft128_kernel`` instances of a
checkout that runs those), beside the passes' byte bounds, on the same
seeded inputs in every checkout.
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


def median_ms(fn, reps: int = 50, warmup: int = 20) -> float:
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


def profile_ms(fn, reps: int = 10) -> dict:
    """``{kernel name: (device us, launches)}`` of the CUDA kernels over
    ``reps`` calls of ``fn`` after one warm-up (torch.profiler, CUPTI)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        us = evt.self_cuda_time_total if us is None else us
        if evt.count and us:
            out[evt.key] = (us, evt.count)
    return out


def pass_ms(table: dict, *names: str) -> float:
    """Device ms a launch of the kernels whose name holds any of ``names``
    (one pass of a multi-pass wrapper, timed alone).  The mean is over the
    launches the profiler recorded, which may miss one; raises when it
    recorded none."""
    hits = [v for key, v in table.items() if any(n in key for n in names)]
    count = sum(c for _, c in hits)
    if not count:
        raise RuntimeError(f"the profiler recorded no launch of {names}")
    return sum(us for us, _ in hits) / 1e3 / count


def kernel_ms(fn, name: str, reps: int = 10) -> float:
    """Device ms a launch of the kernels whose name holds ``name`` over
    ``reps`` calls of ``fn`` (:func:`profile_ms`, :func:`pass_ms`)."""
    return pass_ms(profile_ms(fn, reps), name)


# The B passes of kernels 8 and 9 by kernel name: the register pass
# (fft_breg.cuh), or fft128.cuh's col_dft128_kernel (demangled or mangled)
B_FWD = ("breg_fwd_kernel", "col_dft128_kernel<false",
         "col_dft128_kernelILb0")
B_INV = ("breg_inv_kernel", "col_dft128_kernel<true",
         "col_dft128_kernelILb1")


def passes_ms(fn, cpass: str, reps: int = 10) -> dict:
    """A round trip's C pass and B passes alone, ms a launch, from one
    profiler run."""
    table = profile_ms(fn, reps)
    return {"cpass_ms": pass_ms(table, cpass),
            "bfwd_ms": pass_ms(table, *B_FWD),
            "binv_ms": pass_ms(table, *B_INV)}


def bpass_bounds_ms(R: int, nfft: int, K: int) -> dict:
    """Each B pass reads and writes its planes once: 4 planes of R rows
    forward, 4 K inverse, at 3.35 TB/s."""
    one = 4 * R * nfft * 4 / 3.35e12 * 1e3
    return {"bfwd_bound_ms": one, "binv_bound_ms": K * one}


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
    out = {"checkout": os.getcwd(), "nvidia_smi": smi}
    fused, split = "cstage_multi_kernel", "cstage_inv_kernel"
    # the fused round trips: (rows, K, call); 8 also on one unpacked row
    Ar, Ai = fs.stage_a_cuda(x[:1], None, NFFT, False, tabs, real_in=True)
    rts = {"bc_cb": (ROWS // 2, 1, lambda: fs.bc_cb_cuda(Xr, Xi, resps[0],
                                                          NFFT, tabs)),
           "bc_cb_unpacked": (1, 1, lambda: fs.bc_cb_cuda(Ar, Ai, resps[0],
                                                           NFFT, tabs))}
    for K in (2, 4):
        rts[f"bccb_multi_k{K}"] = (
            ROWS // 2, K,
            lambda K=K: fs.bccb_multi_cuda(Xr, Xi, resps[:K], NFFT, tabs))
    for name, (R, K, fn) in rts.items():
        out[f"{name}_ms"] = median_ms(fn)
        out.update({f"{name}_{k}": v
                    for k, v in passes_ms(fn, fused).items()})
        out.update({f"{name}_{k}": v
                    for k, v in bpass_bounds_ms(R, NFFT, K).items()})
    Sr, Si = fs.bc_cuda(Xr, Xi, NFFT, tabs)
    Ur, Ui = fs.bc_cuda(Ar, Ai, NFFT, tabs)
    calls = {"bc": ("cstage_fwd_kernel",
                    lambda: fs.bc_cuda(Xr, Xi, NFFT, tabs))}
    calls["cb"] = (split, lambda: fs.cb_cuda(Sr, Si, resps[0], NFFT, tabs))
    calls["cb_none"] = (split, lambda: fs.cb_cuda(Sr, Si, None, NFFT, tabs))
    calls["cb_unpacked"] = (
        split, lambda: fs.cb_cuda(Ur, Ui, resps[0], NFFT, tabs))
    for K in (2, 4):
        calls[f"cb_multi_k{K}"] = (
            split,
            lambda K=K: fs.cb_multi_cuda(Sr, Si, resps[:K], NFFT, tabs))
    for name, (cpass, fn) in calls.items():
        out[f"{name}_ms"] = median_ms(fn)
        out[f"{name}_cpass_ms"] = kernel_ms(fn, cpass)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
