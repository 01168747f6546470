"""Time the design variants of the chunked envelope kernel
(``scripts/env_scan_variants.cu``) against the package's kernel (kernel 2′,
``scan.env_scan_cuda``) at the 180 s batch's shapes (16 rows of 7 938 000
samples) on one GPU: every variant at the card geometry
(``scan.scan_geometry``) and at ``scan.chunk_geometry``'s, and variants 4
(the package's design) and 5 (its scan alone, no loads or stores) over a
sweep of chunk lengths C, for the transient designer's slow (5 ms / 100
ms) and fast (0.5 ms / 5 ms) followers.

    cd <checkout> && python amw_tpu_torch/scripts/tune_env_scan.py

Builds the variants with nvcc into ``amw_tpu_torch/_build/``.  Prints the
card's name and power limit, then one JSON line per follower and C: the
geometry, the package kernel's CUDA-event median (of 50 after 20 warm-up
launches) and each variant's, with whether its output equals the package
kernel's (variant 5 writes none).
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from amw_tpu_torch.ops import _cuda, scan  # noqa: E402
from amw_tpu_torch.scripts.ab_bccb import median_ms  # noqa: E402

ROWS, N = 16, 7_938_000
VARIANTS = range(7)
SWEEP_VARIANTS = (4, 5)
SWEEPS = {(0.005, 0.1): (20480, 16384, 13568, 10240, 8192),
          (0.0005, 0.005): (16384, 8192, 4096)}


def build_variants() -> ctypes.CDLL:
    src = Path(__file__).resolve().parent / "env_scan_variants.cu"
    _cuda.BUILD.mkdir(parents=True, exist_ok=True)
    lib = _cuda.BUILD / "env_scan_variants.so"
    subprocess.run([_cuda.nvcc_path(), *_cuda.ARCH_FLAGS, "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib),
                    str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.var_scan.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
                             + [ctypes.c_int] * 5 + [ctypes.c_float] * 2)
    dll.var_scan.restype = ctypes.c_int
    return dll


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("tune_env_scan: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip(),
          flush=True)
    _cuda.build()
    dll = build_variants()
    dev = torch.device("cuda")
    sms = scan.sm_count(dev)
    g = torch.Generator(device="cpu").manual_seed(2)
    v = (0.3 * torch.randn(ROWS, N, generator=g)).abs().to(dev)
    out = torch.empty_like(v)

    def variant(k, geo, att, rel):
        def launch():
            err = dll.var_scan(k, v.data_ptr(), out.data_ptr(), ROWS, N, *geo,
                               att, rel)
            if err:
                raise RuntimeError(f"variant {k}: CUDA error {err}")
        return launch

    for ballistics, sweep in SWEEPS.items():
        att, rel = scan.ar_coefs(44100, *ballistics)
        w0 = scan.warmup_len(att, rel)
        geos = [("card", scan.scan_geometry(ROWS, N, w0, sms)),
                ("chunk", scan.chunk_geometry(ROWS, N, w0))]
        geos += [("sweep", (w0, C, -(-N // C))) for C in sweep]
        for label, geo in geos:
            ref = scan.env_scan_cuda(v, *geo, att, rel)
            res = {"ballistics_s": ballistics, "geometry": label,
                   "W_C_K": list(geo), "package_ms": median_ms(
                       lambda: scan.env_scan_cuda(v, *geo, att, rel))}
            for k in VARIANTS if label != "sweep" else SWEEP_VARIANTS:
                fn = variant(k, geo, att, rel)
                out.zero_()
                fn()
                torch.cuda.synchronize()
                res[f"v{k}"] = {"ms": median_ms(fn),
                                "equal": bool(torch.equal(out, ref))}
            print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
