"""Time the staged FFT's B/C kernels of the ``amw_tpu_torch`` package found
in the current directory, at the 180 s batch's shapes (the packed stage-A
output of 16 rows of 7 938 000 samples, nfft = 2^23, C = 512), on one GPU:
the fused round trips, 8 ``bc_cb_cuda`` (also on one unpacked row) and 9
``bccb_multi_cuda`` at K = 2 and 4, and the split stages, 6 ``bc_cuda``,
7 ``cb_cuda`` (one response, none, and one response on one unpacked row)
and 10 ``cb_multi_cuda`` at K = 2 and 4.

    cd <checkout> && python <this file> [--variants]

It compares two checkouts on one card: run it in the parent's and the
change's checkout in turns (parent, change, change, parent) within one
machine; it times the package of the directory it runs in, so one copy
of the script serves both (``cd <parent> && python <change>/amw_tpu_torch/
scripts/ab_bccb.py``).  Prints one JSON line: the checkout, the card's
name and power limit (``nvidia-smi``), each call's CUDA-event median
over 50 launches after 20 warm-up launches, and, from one torch.profiler
run of 10 calls (ms a launch), each pass of the call alone, where the
checkout runs it: the C pass (``cstage_multi_kernel``,
``cstage_fwd_kernel`` or ``cstage_inv_kernel``), the forward and inverse
B passes (``breg_fwd_kernel`` and ``breg_inv_kernel``, or the
``col_dft128_kernel`` instances of a checkout that runs those) and kernel
6's one pass (``bc_onepass_kernel``), beside the passes' byte bounds, on
the same seeded inputs in every checkout.  ``--variants`` also builds
``bc_variants.cu`` beside this script (kernel 6's two-pass yardstick, the
one pass at the package's cluster size, at half and twice it, and four
probes of the one pass with a part changed) and times each variant, with
its kernels alone, the clusters the occupancy API lets run at once, and
whether its output equals ``bc_cuda``'s bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

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


# A split stage's passes by kernel name: kernel 6's one pass, or the C and
# B passes of a two-pass design
SPLIT_PASSES = {"onepass_ms": ("bc_onepass_kernel", "bc_probe_kernel",
                               "bc_pipe_kernel"),
                "cpass_ms": ("cstage_fwd_kernel", "cstage_inv_kernel"),
                "bfwd_ms": B_FWD, "binv_ms": B_INV}


def split_passes_ms(fn, reps: int = 10) -> dict:
    """Each pass a split stage runs, ms a launch, from one profiler run;
    the passes this checkout does not run are left out."""
    table = profile_ms(fn, reps)
    return {key: pass_ms(table, *names) for key, names in SPLIT_PASSES.items()
            if any(n in k for k in table for n in names)}


def bpass_bounds_ms(R: int, nfft: int, K: int) -> dict:
    """Each B pass reads and writes its planes once: 4 planes of R rows
    forward, 4 K inverse, at 3.35 TB/s."""
    one = 4 * R * nfft * 4 / 3.35e12 * 1e3
    return {"bfwd_bound_ms": one, "binv_bound_ms": K * one}


BC_VARIANTS = {0: "two_pass", 1: "one_pass", 2: "half_q", 3: "twice_q",
               4: "local_push", 5: "b_only", 6: "c_only",
               7: "no_cluster_wait", 8: "serial_loads", 9: "b_only_serial",
               10: "pipelined"}


@functools.cache
def build_bc_variants() -> ctypes.CDLL:
    """``bc_variants.cu`` (beside this file) built into the package's
    ``_build/`` with the package's nvcc flags, once a process."""
    src = Path(__file__).resolve().parent / "bc_variants.cu"
    _cuda.BUILD.mkdir(parents=True, exist_ok=True)
    lib = _cuda.BUILD / "bc_variants.so"
    subprocess.run([_cuda.nvcc_path(), *_cuda.ARCH_FLAGS, "-std=c++17",
                    "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                    "-o", str(lib), str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    dll.var_bc.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                           + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p])
    dll.var_bc.restype = ctypes.c_int
    return dll


def var_bc(dll, variant: int, xr, xi, nfft: int, tables, out=None):
    """Kernel 6's variant ``variant`` on the planes ``xr``, ``xi`` [R, nfft]
    (CUDA) into ``out`` (new planes where None): ``(out_r, out_i,
    clusters that fit at once)``."""
    t2r, t2i = fs._tabs(tables, False)[2:4]
    out_r, out_i = out if out is not None else (torch.empty_like(xr),
                                                torch.empty_like(xr))
    fit = ctypes.c_int(0)
    err = dll.var_bc(variant, xr.data_ptr(), xi.data_ptr(), t2r.data_ptr(),
                     t2i.data_ptr(), out_r.data_ptr(), out_i.data_ptr(),
                     xr.shape[0], nfft // (fs.A * fs.B),
                     torch.cuda.current_stream().cuda_stream,
                     ctypes.byref(fit))
    if err:
        raise RuntimeError(f"bc variant {variant}: CUDA error {err}")
    return out_r, out_i, fit.value


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
    fused = "cstage_multi_kernel"
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
    calls = {"bc": lambda: fs.bc_cuda(Xr, Xi, NFFT, tabs),
             "cb": lambda: fs.cb_cuda(Sr, Si, resps[0], NFFT, tabs),
             "cb_none": lambda: fs.cb_cuda(Sr, Si, None, NFFT, tabs),
             "cb_unpacked": lambda: fs.cb_cuda(Ur, Ui, resps[0], NFFT, tabs)}
    for K in (2, 4):
        calls[f"cb_multi_k{K}"] = (
            lambda K=K: fs.cb_multi_cuda(Sr, Si, resps[:K], NFFT, tabs))
    for name, fn in calls.items():
        out[f"{name}_ms"] = median_ms(fn)
        out.update({f"{name}_{k}": v for k, v in split_passes_ms(fn).items()})
    out["bc_bound_ms"] = (4 * (ROWS // 2) * NFFT * 4 + 2 * NFFT // fs.A * 4) \
        / 3.35e12 * 1e3
    print(json.dumps(out), flush=True)
    if "--variants" in sys.argv[1:]:
        dll = build_bc_variants()
        planes = (torch.empty_like(Xr), torch.empty_like(Xr))
        for v, label in BC_VARIANTS.items():
            def fn(v=v):
                return var_bc(dll, v, Xr, Xi, NFFT, tabs, planes)
            for p in planes:
                p.fill_(float("nan"))
            fit = fn()[2]
            torch.cuda.synchronize()
            print(json.dumps({
                "bc_variant": label, "ms": median_ms(fn), "fit": fit,
                "equal_to_bc_cuda": bool(torch.equal(planes[0], Sr)
                                         and torch.equal(planes[1], Si)),
                **split_passes_ms(fn)}), flush=True)


if __name__ == "__main__":
    main()
