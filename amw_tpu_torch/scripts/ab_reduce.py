"""Time the staged FFT's reduce kernels of the ``amw_tpu_torch`` package
found in the current directory, at the 180 s batch's shapes, on one GPU:

- kernel 11 ``reduce_packed_cuda``: the K = 4 band spectra of 8 packed
  rows (16 rows of 7 938 000 samples through stage A and kernel 9),
  nfft = 2^23, the v1 chain's band maps;
- kernel 12 ``reduce_cuda``: the K = 4 band spectra of one mono row;
- the controls, kernel 4 ``stage_a_cuda`` (the packed forward stage A of
  the 16 rows) and kernel 5 ``inv_join_cuda`` (K = 2).

    cd <checkout> && python <this file> [--variants]

It compares two checkouts on one card: run it in the parent's and the
change's checkout in turns (parent, change, change, parent) within one
machine; it times the package of the directory it runs in, so one copy
of the script serves both (``cd <parent> && python <change>/amw_tpu_torch/
scripts/ab_reduce.py``).  Prints one JSON line: the checkout, the card's
name and power limit (``nvidia-smi``), each call's CUDA-event median over
50 launches after 20 warm-up launches, and kernels 11 and 12's largest
error relative to their plain versions' largest magnitude, on the same
seeded inputs in every checkout.  ``--variants`` also builds
``reduce_variants.cu`` beside this script and times its variants of
kernel 11 on the same inputs (loads only; loads and transform; the whole
kernel; without the prefetch; at one block an SM; the map's sign by
copysignf), each with the blocks an SM the occupancy API gives it and
its largest difference from the package kernel's output (the loads and
transform variants compute other sums).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.getcwd())

import numpy as np  # noqa: E402
import torch  # noqa: E402

from amw_tpu_torch.constants import MULTIBAND_CONFIG  # noqa: E402
from amw_tpu_torch.ops import _cuda  # noqa: E402
from amw_tpu_torch.ops import fft_staged as fs  # noqa: E402
from amw_tpu_torch.ops.bands import BandMap  # noqa: E402
from amw_tpu_torch.scripts.ab_bccb import median_ms  # noqa: E402

NFFT = 1 << 23
ROWS, N = 16, 7_938_000
K = 4
VARIANTS = {0: "loads", 1: "transform", 2: "whole", 3: "no_prefetch",
            4: "one_block_an_sm", 5: "copysign"}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    err = float((got.double() - want.double()).abs().max())
    return err / max(float(want.abs().max()), 1e-30)


def build_variants() -> ctypes.CDLL:
    src = Path(__file__).resolve().parent / "reduce_variants.cu"
    _cuda.BUILD.mkdir(parents=True, exist_ok=True)
    lib = _cuda.BUILD / "reduce_variants.so"
    subprocess.run([_cuda.nvcc_path(), *_cuda.ARCH_FLAGS, "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                    "-o", str(lib), str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.var_reduce.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                               + [ctypes.c_int] * 3
                               + [ctypes.c_float, ctypes.c_void_p,
                                  ctypes.c_void_p])
    dll.var_reduce.restype = ctypes.c_int
    return dll


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ab_reduce: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    _cuda.build()
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    tabs = fs._device_tables(NFFT, dev)
    x = (0.3 * torch.randn(ROWS, N, generator=g)).to(dev)
    H = 0.25 + torch.rand(K, NFFT // 2 + 1, generator=g, dtype=torch.float64)
    resps = torch.from_numpy(np.stack([fs.permute_full_response(h.numpy(),
                                                                NFFT)
                                       for h in H])).to(dev)
    maps = [BandMap(comp_db, ratio, 6.0, 12.0, lim_db, gain)
            for lim_db, ratio, comp_db, gain in MULTIBAND_CONFIG]
    table = fs.band_table(maps, dev)
    R2 = ROWS // 2
    Xr, Xi = fs.stage_a_cuda(x[:R2], x[R2:], NFFT, False, tabs)
    Yr, Yi = fs.bccb_multi_cuda(Xr, Xi, resps, NFFT, tabs)
    Mr, Mi = fs.bccb_multi_cuda(*fs.stage_a_cuda(x[:1], None, NFFT, False,
                                                 tabs, real_in=True),
                                resps, NFFT, tabs)
    Jr, Ji = fs.bccb_multi_cuda(Xr, Xi, resps[:2], NFFT, tabs)
    out = {"checkout": os.getcwd(), "nvidia_smi": smi}
    a11 = (Yr, Yi, K, R2, NFFT)
    a12 = (Mr, Mi, K, 1, NFFT)
    out["reduce_packed_rel_err"] = rel_err(
        fs.reduce_packed_cuda(*a11, table, tabs),
        fs.reduce_packed_plain(*a11, maps, tabs))
    out["reduce_rel_err"] = rel_err(fs.reduce_cuda(*a12, table, tabs),
                                    fs.reduce_plain(*a12, maps, tabs))
    calls = {
        "reduce_packed": lambda: fs.reduce_packed_cuda(*a11, table, tabs),
        "reduce": lambda: fs.reduce_cuda(*a12, table, tabs),
        "stage_a": lambda: fs.stage_a_cuda(x[:R2], x[R2:], NFFT, False,
                                           tabs),
        "inv_join": lambda: fs.inv_join_cuda(Jr, Ji, 2, NFFT, tabs),
    }
    for name, fn in calls.items():
        out[f"{name}_ms"] = median_ms(fn)
    if "--variants" in sys.argv[1:]:
        dll = build_variants()
        t1r, t1i = fs._tabs(tabs, True)[:2]
        got = torch.empty((2 * R2, NFFT), dtype=torch.float32, device=dev)
        want = fs.reduce_packed_cuda(*a11, table, tabs)
        per_sm = ctypes.c_int(0)
        stream = torch.cuda.current_stream().cuda_stream
        for v, label in VARIANTS.items():
            def fn(v=v):
                err = dll.var_reduce(v, Yr.data_ptr(), Yi.data_ptr(),
                                     t1r.data_ptr(), t1i.data_ptr(),
                                     table.data_ptr(), got.data_ptr(), R2, K,
                                     NFFT // fs.A, 1.0 / NFFT, stream,
                                     ctypes.byref(per_sm))
                if err:
                    raise RuntimeError(f"variant {v}: CUDA error {err}")
            fn()
            torch.cuda.synchronize()
            out[f"variant_{label}"] = {
                "ms": median_ms(fn), "blocks_an_sm": per_sm.value,
                "rel_diff_to_package": rel_err(got, want)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
