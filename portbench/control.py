"""The control of a cell's check: the reference in the program's place,
computed with every stage's output rounded to bfloat16 (the precision
below the configurations' float32), judged by the same comparison
against the float64 reference.  A sound check reads the control as not
correct.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]

prints one JSON line per seed with the compared numbers (the readings
that set a limit's upper end).  The inputs and the checked tracks are a
run's of the same seed: the pool is made on the card, as in a run.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import sys
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from portbench import check, generator, manifest
from portbench.entries.graph_batch import pick
from portbench.reference import chains
from portbench.reference.precision import bfloat16


def inputs(cell, seed: int, device) -> list:
    """The checked tracks' inputs and valid lengths of a run of ``seed``."""
    import torch

    sr = int(cell.config["sr"])
    x, nv = generator.make_pool(cell.traffic, sr, int(cell.config["channels"]),
                                seed, torch.device(device))
    j, tracks = pick(cell.traffic, nv, seed)
    got = [(x[j, b, :, :int(nv[j, b])].cpu().double().numpy(), int(nv[j, b]))
           for b in tracks]
    del x
    return got


def as_sample(ref: dict, x: np.ndarray, nv: int, n_bucket: int) -> dict:
    """A reference result in the shape of a program's checked track."""
    out = np.zeros((ref["out"].shape[0], n_bucket))
    out[:, :nv] = ref["out"]
    s = {"input": x, "out": out, "n_valid": nv}
    for k in ("before_lufs", "after_lufs", "peak", "finite"):
        if k in ref:
            s[k] = ref[k]
    return s


def readings(cell, seeds, device="cuda", workers: int = 8) -> list:
    """Per seed, the control's compared numbers and whether the check
    reads it as correct."""
    n_bucket = int(round(float(cell.traffic["bucket_s"])
                         * int(cell.config["sr"])))
    jobs = [(s, x, nv) for s in seeds for x, nv in inputs(cell, s, device)]
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=min(workers, 2 * len(jobs)),
                             mp_context=ctx) as ex:
        exact = [ex.submit(chains.master, cell.config, x) for _, x, _ in jobs]
        low = [ex.submit(chains.master, cell.config, x, bfloat16)
               for _, x, _ in jobs]
        exact = [f.result() for f in exact]
        low = [f.result() for f in low]
    out = []
    for seed in seeds:
        idx = [i for i, (s, _, _) in enumerate(jobs) if s == seed]
        samples = [as_sample(low[i], jobs[i][1], jobs[i][2], n_bucket)
                   for i in idx]
        rows = check.judge(check.numbers(samples, [exact[i] for i in idx]),
                           cell.check["limits"])
        out.append({"seed": seed, "correct": all(r[3] for r in rows),
                    "numbers": {n: v for n, v, _, _ in rows}})
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = manifest.cell(args.workload)
    for r in readings(cell, args.seeds, args.device):
        print(json.dumps({"workload": args.workload, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
