"""How ``correct`` is decided: the checked tracks of a run against the
plain reference (``portbench/reference``), each number beside its limit
from the cell's file (``workloads/<cell>.json``).

The numbers:

- ``out_err``: the largest gap between a checked track's output and the
  reference's, over its valid samples (full scale is 1);
- ``tail_max``: the largest magnitude past a track's valid end, where the
  bucket's padding has to stay silent (limit 0);
- for graphs that report them, ``lufs_err`` (the largest gap of the
  loudness before and after, LU), ``peak_err`` (of the peak) and
  ``nonfinite`` (checked tracks whose finite flag is false; limit 0).

The reference runs on the host, one process per checked track.
"""

from __future__ import annotations

import math
import multiprocessing
from concurrent.futures import ProcessPoolExecutor

import numpy as np

from portbench.reference import chains

ORDER = ("out_err", "tail_max", "lufs_err", "peak_err", "nonfinite")


def references(config: dict, inputs: list) -> list:
    """``chains.master`` of every input, in parallel processes."""
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=len(inputs), mp_context=ctx) as ex:
        futs = [ex.submit(chains.master, config, x) for x in inputs]
        return [f.result() for f in futs]


def numbers(samples: list, refs: list) -> dict:
    """The compared numbers of checked tracks against their references;
    a gap that is not a number stays one (``np.max`` keeps a NaN)."""
    vals: dict = {}

    def add(name, v):
        vals.setdefault(name, []).append(v)

    for s, r in zip(samples, refs):
        nv = s["n_valid"]
        got = s["out"]
        add("out_err", np.max(np.abs(got[:, :nv] - r["out"])))
        add("tail_max", np.max(np.abs(got[:, nv:])) if got.shape[-1] > nv
            else 0.0)
        if "after_lufs" in r:
            add("lufs_err", np.max([abs(s["before_lufs"] - r["before_lufs"]),
                                    abs(s["after_lufs"] - r["after_lufs"])]))
            add("peak_err", abs(s["peak"] - r["peak"]))
            add("nonfinite", float(not s["finite"]))
    return {k: (float(np.sum(v)) if k == "nonfinite" else float(np.max(v)))
            for k, v in vals.items()}


def judge(nums: dict, limits: dict) -> list:
    """``[(name, value, limit, ok)]`` in a fixed order; a number that is
    not finite fails."""
    rows = []
    for name in ORDER:
        if name not in nums:
            continue
        v, lim = nums[name], float(limits[name])
        ok = math.isfinite(v) and v <= lim
        rows.append((name, v, lim, ok))
    return rows


def run(cell, samples: list) -> list:
    refs = references(cell.config, [s["input"] for s in samples])
    return judge(numbers(samples, refs), cell.check["limits"])
