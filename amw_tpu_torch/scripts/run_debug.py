#!/usr/bin/env python
"""Full component checklist of the port (the 8-section operator
diagnostic of the JAX package's ``scripts/run_debug.py``).

    python -m amw_tpu_torch.scripts.run_debug [--device cuda|cpu]

Exercises the meters, every DSP op, the chain runtime, the v1 pipeline,
I/O, persistence and the analysis graph on ``device`` (``cuda`` unless
given; raises without a GPU) and prints a ``[PASS]``/``[FAIL]`` line a
check, with the JAX script's check names but the first (``torch
devices``: the device's name, count and compute capability).  Where the
JAX script holds its TPU graphs to the numpy oracle, the port holds the
device's ops and v1 output to the port's own plain path on the CPU, at
the JAX script's tolerances; each op check prints its error.  The meters
are ``qa/gates.py``'s; the persistence check runs on a temporary
database (``runtime/db.set_db_path``).  Exit code 0 only when every
check passes.
"""

from __future__ import annotations

import argparse
import tempfile
import traceback

import numpy as np
import torch

from amw_tpu_torch import resolve_device

SR = 44100
OP_TOL = 1e-4
DYNAMIC_EQ_TOL = 3e-4
V1_TOL = 2e-3
CHAIN_LU_TOL = 2.5


class Checklist:
    """Runs checks, printing and recording each result; a check's
    function may return a detail string printed beside its PASS."""

    def __init__(self):
        self.results = []

    def run(self, name, fn):
        try:
            detail = fn()
        except Exception as e:  # noqa: BLE001 — a FAIL line, and exit 1
            self.results.append((name, False, str(e)))
            print(f"  [FAIL] {name}: {e}")
            traceback.print_exc(limit=1)
            return
        self.results.append((name, True, detail or ""))
        print(f"  [PASS] {name}" + (f" ({detail})" if detail else ""))

    def failures(self):
        return [r for r in self.results if not r[1]]


def require(cond, what) -> None:
    """A check's condition; raises where it does not hold (an ``assert``
    would vanish under ``python -O`` and pass every check)."""
    if not cond:
        raise AssertionError(what)


def _mix(sr=SR, dur=2.0):
    g = np.random.default_rng(0)
    t = np.arange(int(sr * dur)) / sr
    x = (0.3 * np.sin(2 * np.pi * 220 * t)
         + 0.03 * g.standard_normal(len(t)))
    return np.clip(np.stack([x, 0.8 * x]), -1, 1).astype(np.float32)


def _environment(dev: torch.device) -> str:
    if dev.type == "cuda":
        count = torch.cuda.device_count()
        require(count >= 1, "no CUDA device")
        cap = torch.cuda.get_device_capability(dev)
        return (f"{torch.cuda.get_device_name(dev)} x{count}, compute "
                f"capability {cap[0]}.{cap[1]}, torch {torch.__version__}, "
                f"CUDA {torch.version.cuda}")
    return f"{dev.type}, torch {torch.__version__}"


def _run_op(build, mix: np.ndarray, sr: int, dev: torch.device):
    from amw_tpu_torch.convert import to_device
    from amw_tpu_torch.spec import GraphSpec

    spec = GraphSpec(sr=sr, n=mix.shape[-1], channels=mix.shape[0])
    params, fn = build(spec, dev)
    with torch.no_grad():
        y = fn(torch.from_numpy(mix).to(dev)[None], to_device(params, dev))
    return y[0].cpu().numpy()


def op_error(build, mix: np.ndarray, sr: int, dev: torch.device) -> float:
    """Largest difference of the op ``build(spec, device)`` makes on
    ``dev`` from the same op made on the CPU (its plain path)."""
    got = _run_op(build, mix, sr, dev)
    want = _run_op(build, mix, sr, torch.device("cpu"))
    return float(np.max(np.abs(got.astype(np.float64) - want)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    sr = SR
    mix = _mix(sr)
    cl = Checklist()

    print("1) environment")
    cl.run("torch devices", lambda: _environment(dev))

    from amw_tpu_torch.qa import gates

    print("2) meters")

    def meters_check():
        lufs = gates.integrated_lufs(mix, sr, device=dev)
        require(-60 < lufs < 0, lufs)
        out = gates.normalize_lufs(mix, sr, -14.0, device=dev)
        got = gates.integrated_lufs(out, sr, device=dev)
        require(abs(got + 14.0) < 0.2, got)
        tp = gates.true_peak_dbfs(mix, sr, device=dev)
        require(tp < 3.0, tp)

    cl.run("BS.1770 integrated + normalize + true peak", meters_check)

    print("3) DSP ops (device graph vs the port's CPU path)")
    from amw_tpu_torch.ops.bands import build_dynamics
    from amw_tpu_torch.ops.dynamics import build_deesser, build_dynamic_eq
    from amw_tpu_torch.ops.eq import (build_final_spectral_balance,
                                      build_rumble_filter, build_style_eq,
                                      build_target_curve)

    def op_check(name, build, tol=OP_TOL):
        def run():
            err = op_error(build, mix, sr, dev)
            require(err < tol, f"err {err}")
            return f"err {err:.3g}"
        cl.run(name, run)

    op_check("target_curve", lambda sp, d: build_target_curve(sp, device=d))
    op_check("dynamics", lambda sp, d: build_dynamics(sp, device=d))
    op_check("deesser", lambda sp, d: build_deesser(sp, device=d))
    op_check("style_eq(edm)",
             lambda sp, d: build_style_eq(sp, "edm", device=d))
    op_check("final_spectral_balance",
             lambda sp, d: build_final_spectral_balance(sp, device=d))
    op_check("rumble_filter", lambda sp, d: build_rumble_filter(sp, device=d))
    op_check("dynamic_eq", lambda sp, d: build_dynamic_eq(sp, device=d),
             DYNAMIC_EQ_TOL)

    print("4) chain runtime")

    def chain_check():
        from amw_tpu_torch.models import compile_chain
        from amw_tpu_torch.spec import GraphSpec

        spec = GraphSpec(sr=sr, n=mix.shape[-1], channels=2)
        chain = compile_chain(spec, target_lufs=-14.0, device=dev)
        with torch.no_grad():
            out = chain.fn(torch.from_numpy(mix).to(dev), chain.params)
        lufs = gates.integrated_lufs(out.cpu().numpy(), sr, device=dev)
        require(abs(lufs + 14.0) < CHAIN_LU_TOL, lufs)

    cl.run("default chain LUFS within ±2.5 of target", chain_check)

    print("5) v1 pipeline")

    def v1_check():
        from amw_tpu_torch.models.pipeline_v1 import master_v1

        got = master_v1(mix, sr, device=dev)
        want = master_v1(mix, sr, device="cpu")
        err = float(np.max(np.abs(got.astype(np.float64) - want)))
        require(err < V1_TOL, f"err {err}")
        return f"err {err:.3g}"

    cl.run("v1 pipeline parity vs oracle", v1_check)

    print("6) I/O + export")

    def io_check():
        from amw_tpu_torch.utils import wav
        from amw_tpu_torch.utils.audio_io import export_audio

        blob = export_audio(torch.from_numpy(mix).to(dev), sr, "wav")
        back, got_sr = wav.read_wav(blob)
        require(got_sr == sr and back.shape == mix.shape,
                (got_sr, back.shape))

    cl.run("WAV roundtrip + dithered export", io_check)

    print("7) persistence")

    def db_check():
        from amw_tpu_torch.runtime import db, settings_store

        tmp = tempfile.NamedTemporaryFile(suffix=".sqlite3")
        db.set_db_path(tmp.name)
        settings_store.set_setting("probe", "1")
        require(settings_store.get_setting_int("probe", 0) == 1,
                "probe not read back")

    cl.run("sqlite schema + settings store", db_check)

    print("8) analysis")

    def analysis_check():
        from amw_tpu_torch.models.analyze import analyze, lufs_analyze_tool

        out = analyze(mix, sr, extended=True, device=dev)
        require(len(out["spectrum_bars"]) == 64, len(out["spectrum_bars"]))
        tool = lufs_analyze_tool(mix, sr, device=dev)
        require("spotify_ready" in tool, sorted(tool))

    cl.run("analyze dict + lufs tool", analysis_check)

    fails = cl.failures()
    print(f"\n{len(cl.results) - len(fails)}/{len(cl.results)} checks passed")
    return 1 if fails else 0


if __name__ == "__main__":
    raise SystemExit(main())
