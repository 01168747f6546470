"""The yardstick of the port's CUDA kernels: the card's peaks, and the
bytes and operations each launch needs, worked out from its arguments.

Frozen from the smoke run's arithmetic (``chip_smoke.bound_ms`` and the
counts of its ``kernel_entry`` calls): the least time of a launch is the
larger of its bytes, each input read once and each output written once,
at the HBM's 3.35 TB/s, and its float32 operations at 67 TFLOP/s (an H100
SXM's data-sheet peaks, dense, outside the tensor cores).
"""

from __future__ import annotations

import math
import re
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
A = 128  # the staged FFT's first factor (a 128-point column DFT)
LOG_A = 7
F32 = 4


def bound_s(nbytes: float, flops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS)


def _numel(*ts) -> int:
    return sum(int(t.numel()) for t in ts)


def _lg(nfft: int) -> int:
    """log2 of the B·C DFT length of a staged plan of ``nfft``."""
    return int(round(math.log2(nfft // A)))


def _box(x, y, R, n, k):
    return 2 * R * n * F32, R * n * (k + 1)


def _env_gain(x, nv, out, rows, n, *rest):
    return (2 * rows * n + rows) * F32, rows * n * 12


def _env_scan(v, out, rows, n, *rest):
    return 2 * rows * n * F32, rows * n * 5


def _stage_a(xr, xi, t1r, t1i, out_r, out_i, R, stride, n, S, inverse,
             real_in, real_out, scale):
    nfft = A * S
    nbytes = (R * n * (1 if real_in else 2) + R * nfft * (1 if real_out
                                                         else 2)
              + _numel(t1r, t1i)) * F32
    return nbytes, R * nfft * (5 * LOG_A + 6)


def _inv_join(yr, yi, t1r, t1i, out, rows, r2, S, scale):
    nfft = A * S
    return ((4 * rows * nfft + _numel(t1r, t1i)) * F32,
            rows * nfft * (5 * LOG_A + 6 + 2))


def _bccb(xr, xi, resps, t2a, t2b, t2c, t2d, zr, zi, out_r, out_i, R, C, K):
    nfft = int(xr.shape[-1])
    lg = _lg(nfft)
    return ((2 * R * nfft + 2 * K * nfft + 2 * K * R * nfft) * F32,
            R * nfft * (5 * lg + 6 + K * (6 + 5 * lg + 6)))


def _bc_cb(xr, xi, resp, t2a, t2b, t2c, t2d, zr, zi, out_r, out_i, R, C):
    nfft = int(xr.shape[-1])
    lg = _lg(nfft)
    return ((4 * R * nfft + 2 * nfft) * F32,
            R * nfft * (5 * lg + 6 + 6 + 5 * lg + 6))


def _bc(xr, xi, t2a, t2b, out_r, out_i, R, C):
    nfft = int(xr.shape[-1])
    return ((4 * R * nfft + _numel(t2a, t2b)) * F32,
            R * nfft * (5 * _lg(nfft) + 6))


def _cb(Xr, Xi, resp, t2a, t2b, out_r, out_i, R, C, has_resp):
    nfft = int(Xr.shape[-1])
    return (((4 * R + (2 if has_resp else 0)) * nfft + _numel(t2a, t2b))
            * F32, R * nfft * (6 + 5 * _lg(nfft) + 6))


def _cb_multi(Xr, Xi, resps, t2a, t2b, out_r, out_i, R, C, K):
    nfft = int(Xr.shape[-1])
    return ((2 * R * nfft + 2 * K * nfft + 2 * K * R * nfft
             + _numel(t2a, t2b)) * F32,
            K * R * nfft * (6 + 5 * _lg(nfft) + 6))


def _reduce_packed(yr, yi, t1r, t1i, bands, out, R2, K, S, scale):
    nfft = A * S
    return ((2 * K * R2 * nfft + 2 * nfft + 2 * R2 * nfft) * F32,
            K * R2 * nfft * (5 * LOG_A + 6 + 2 + 2 * 12))


def _reduce(yr, yi, t1r, t1i, bands, out, R, K, S, scale):
    nfft = A * S
    return ((2 * K * R * nfft + 2 * nfft + R * nfft) * F32,
            K * R * nfft * (5 * LOG_A + 6 + 2 + 12))


# bytes and operations of a launch, by the C entry point it calls
WORK = {
    "amw_box_smooth": _box,
    "amw_env_gain": _env_gain,
    "amw_env_scan": _env_scan,
    "amw_env_rows": _env_scan,
    "amw_fft_stage_a": _stage_a,
    "amw_fft_inv_join": _inv_join,
    "amw_fft_bccb": _bccb,
    "amw_fft_bc_cb": _bc_cb,
    "amw_fft_bc": _bc,
    "amw_fft_cb": _cb,
    "amw_fft_cb_multi": _cb_multi,
    "amw_fft_reduce_packed": _reduce_packed,
    "amw_fft_reduce": _reduce,
}


class LaunchRecorder:
    """While entered, every launch of a port kernel (through
    ``amw_tpu_torch.ops._cuda.launch``) is recorded as ``(entry, bytes,
    flops)``; entry points without a yardstick record ``None`` work."""

    def __init__(self):
        self.records: list = []
        self._mod = None
        self._orig = None

    def _launch(self, name, *args):
        work = WORK.get(name)
        self.records.append((name,) + (work(*args) if work else (None, None)))
        return self._orig(name, *args)

    def __enter__(self):
        from amw_tpu_torch.ops import _cuda

        self._mod, self._orig = _cuda, _cuda.launch
        _cuda.launch = self._launch
        return self

    def __exit__(self, *exc):
        self._mod.launch = self._orig
        return False

    def bound_s(self) -> float | None:
        """The least time of every recorded launch, summed; ``None`` when
        a launch had no yardstick or none was recorded."""
        if not self.records or any(b is None for _, b, _ in self.records):
            return None
        return sum(bound_s(b, f) for _, b, f in self.records)


_GLOBAL = re.compile(
    r"__global__\s+void\s+(?:__launch_bounds__\s*\([^)]*\)\s*)?(\w+)\s*\(")


def kernel_names(csrc: Path) -> frozenset:
    """The ``__global__`` functions of the port's CUDA sources."""
    names = set()
    for path in sorted(csrc.glob("*.cu")) + sorted(csrc.glob("*.cuh")):
        names.update(_GLOBAL.findall(path.read_text()))
    return frozenset(names)
