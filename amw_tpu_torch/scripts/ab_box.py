"""Time the box smoother (kernel 1, ``fdfilter.box_smooth_cuda``, the
de-esser's gain smoother at k = 67) of the ``amw_tpu_torch`` package found
in the current directory, on one GPU, at both batches' shapes: the
8 × 180 s batch's [16, 7 938 000] and the 8 × 5 s batch's [16, 220 500]
(the inputs of ``chip_smoke.deesser_kernel_inputs``); the control, kernel
2 (``scan.env_gain_cuda``, the de-esser's envelope → gain) at the 180 s
batch's card geometry.

    cd <checkout> && python <this file> [--variants]

It compares two checkouts on one card: run it in the parent's and the
change's checkout in turns (parent, change, change, parent) within one
machine; it times the package of the directory it runs in, so one copy
of the script serves both (``cd <parent> && python <change>/amw_tpu_torch/
scripts/ab_box.py``).  Prints one JSON line: the checkout, the card's name
and power limit (``nvidia-smi``), each call's CUDA-event median over 50
launches after 20 warm-up launches, and the box's largest absolute error
against ``box_smooth_plain`` at each shape, on the same seeded inputs in
every checkout.  ``--variants`` also builds ``box_variants.cu`` beside
this script and times its variants at the 180 s shape (loads and stores
only; staging only; the whole kernel; strips of 16 and 64; the generic
path; the design it replaced), each with the blocks an SM the occupancy
API gives it and its largest difference from ``box_smooth_plain`` (the
first two compute no average).
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from amw_tpu_torch.ops import _cuda  # noqa: E402
from amw_tpu_torch.ops import fdfilter, scan  # noqa: E402
from amw_tpu_torch.scripts.ab_bccb import median_ms  # noqa: E402

K = 67
VARIANTS = {0: "loads_stores", 1: "staging", 2: "whole", 3: "strip_16",
            4: "strip_64", 5: "generic", 6: "before"}


def _smoke():
    """The current directory's ``chip_smoke.py`` (the checkout timed)."""
    path = Path(os.getcwd()) / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_ab_box_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variants() -> ctypes.CDLL:
    src = Path(__file__).resolve().parent / "box_variants.cu"
    _cuda.BUILD.mkdir(parents=True, exist_ok=True)
    lib = _cuda.BUILD / "box_variants.so"
    subprocess.run([_cuda.nvcc_path(), *_cuda.ARCH_FLAGS, "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                    "-o", str(lib), str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.var_box.argtypes = ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p])
    dll.var_box.restype = ctypes.c_int
    return dll


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max())


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ab_box: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    _cuda.build()
    cs = _smoke()
    dev = torch.device("cuda")
    g = torch.Generator(device="cpu").manual_seed(0)
    out = {"checkout": os.getcwd(), "nvidia_smi": smi}
    inputs = {}
    for label, (dur, valid) in (("5s", cs.SHORT), ("180s", cs.LONG)):
        x, geoms = cs.deesser_kernel_inputs(dev, g, dur, valid)
        inputs[label] = (x, geoms)
        out[f"box_{label}_max_abs_err"] = max_err(
            fdfilter.box_smooth_cuda(x, K), fdfilter.box_smooth_plain(x, K))
        out[f"box_{label}_ms"] = median_ms(
            lambda x=x: fdfilter.box_smooth_cuda(x, K))
    x, geoms = inputs["180s"]
    card = geoms["card"]
    out["env_gain_180s_ms"] = median_ms(lambda: scan.env_gain_cuda(*card))
    if "--variants" in sys.argv[1:]:
        dll = build_variants()
        want = fdfilter.box_smooth_plain(x, K)
        got = torch.empty_like(x)
        rows, n = x.shape
        per_sm = ctypes.c_int(0)
        stream = torch.cuda.current_stream().cuda_stream
        for v, label in VARIANTS.items():
            def fn(v=v):
                err = dll.var_box(v, x.data_ptr(), got.data_ptr(), rows, n,
                                  stream, ctypes.byref(per_sm))
                if err:
                    raise RuntimeError(f"variant {v}: CUDA error {err}")
            fn()
            torch.cuda.synchronize()
            out[f"variant_{label}"] = {
                "ms": median_ms(fn), "blocks_an_sm": per_sm.value,
                "max_abs_diff_to_plain": max_err(got, want)}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
