"""Build and bind the CUDA kernels of ``amw_tpu_torch/csrc``.

Each ``csrc/*.cu`` file is compiled on first use by its own ``nvcc``
process (all started together) into a shared library with a plain C
interface, under ``amw_tpu_torch/_build/`` (named by the hash of the source
and of the shared ``csrc/*.cuh`` headers, so an edited source rebuilds),
and loaded with ``ctypes``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

Every C entry point takes its pointers, then its integer and float
arguments, then the CUDA stream, launches on that stream without
synchronising, and returns ``cudaGetLastError()``; :func:`launch` raises
when that is not 0.  Nothing here runs at import: the CPU tests import
every module on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# C signatures: argument kinds in order ('p' pointer, 'i' int, 'f' float);
# the stream is appended by launch().
_ENTRIES = {
    "amw_box_smooth": ("box_smooth", "ppiii"),
    "amw_env_gain": ("env_gain", "pppiiiiifffff"),
    "amw_env_scan": ("env_scan", "ppiiiiiff"),
    "amw_env_rows": ("env_scan", "ppiiff"),
    "amw_env_step_clock": ("env_scan", "ppiff"),
    "amw_fft_stage_a": ("fft_stage_a", "ppppppiiiiiiif"),
    "amw_fft_inv_join": ("fft_stage_a", "pppppiiif"),
    "amw_fft_bccb": ("fft_bccb", "pppppppppppiii"),
    "amw_fft_bc_cb": ("fft_bccb", "pppppppppppii"),
    "amw_fft_bc": ("fft_split", "ppppppii"),
    "amw_fft_cb": ("fft_split", "pppppppiii"),
    "amw_fft_cb_multi": ("fft_split", "pppppppiii"),
    "amw_fft_reduce_packed": ("fft_reduce", "ppppppiiif"),
    "amw_fft_reduce": ("fft_reduce", "ppppppiiif"),
}
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}


# The loaded libraries by source stem, filled once per process by build().
_LIBS: dict[str, ctypes.CDLL] = {}
# build() runs once even when the engine's threads launch at the same time
_BUILD_LOCK = threading.Lock()


def nvcc_path() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cands = [shutil.which("nvcc")]
    if CUDA_HOME:
        cands.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(src: Path) -> Path:
    # the shared headers are part of every source's key
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(ARCH_FLAGS).encode()).hexdigest()
    return BUILD / f"{src.stem}-{digest[:16]}.so"


def build(verbose: bool = False) -> float:
    """Compile every missing library in parallel and load all of them.
    Returns the seconds spent (0 when everything was loaded already)."""
    with _BUILD_LOCK:
        return _build_locked(verbose)


def _build_locked(verbose: bool) -> float:
    if _LIBS:
        return 0.0
    t0 = time.perf_counter()
    BUILD.mkdir(parents=True, exist_ok=True)
    sources = sorted({stem for stem, _ in _ENTRIES.values()})
    procs = []
    for stem in sources:
        src = CSRC / f"{stem}.cu"
        out = _target(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
               str(src)]
        procs.append((stem, tmp, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for stem, tmp, out, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{stem}.cu:\n{log}")
            continue
        if verbose:
            print(f"[nvcc {stem}.cu]\n{log.strip()}", flush=True)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    libs = {}
    for stem in sources:
        libs[stem] = ctypes.CDLL(str(_target(CSRC / f"{stem}.cu")))
    for name, (stem, kinds) in _ENTRIES.items():
        fn = getattr(libs[stem], name)
        fn.argtypes = [_CTYPES[c] for c in kinds] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    _LIBS.update(libs)
    return time.perf_counter() - t0


def launch(name: str, *args) -> None:
    """Call C entry ``name`` on the current stream of the first tensor
    argument's device; tensors pass as ``data_ptr()``.  Raises on a
    non-zero ``cudaError_t``."""
    if not _LIBS:
        build()
    stem, kinds = _ENTRIES[name]
    fn = getattr(_LIBS[stem], name)
    if len(args) != len(kinds):
        raise TypeError(f"{name}: expected {len(kinds)} arguments")
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    conv = []
    for kind, a in zip(kinds, args):
        if kind == "p":
            if not (isinstance(a, torch.Tensor) and a.device == dev):
                raise ValueError(f"{name}: tensor arguments must share {dev}")
            conv.append(ctypes.c_void_p(a.data_ptr()))
        elif kind == "i":
            conv.append(ctypes.c_int(int(a)))
        else:
            conv.append(ctypes.c_float(float(a)))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*conv, ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err} at launch")
