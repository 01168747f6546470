"""Sets of runs of one cell, and the spread of each metric, as a bound is
set from them: each run a new process, the same seeds in every set.

    python3 -m portbench.sets --workload <cell> --seeds <n> [<n> ...] \\
        [--sets 2] [--seconds 10] [--trace 0] [--out DIR]

Prints one line per run (its metrics, its check and whether it was
correct) and then, per metric, each set's median and spread: the
distance between the first and the third quartile
(``statistics.quantiles(values, n=4)``) as a share of the median.  With
``--out`` each run's standard output and error are kept there.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def spread(values: list) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def one_run(workload, seed, seconds, trace, out: Path | None) -> dict:
    t = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", workload,
         "--seed", str(seed), "--seconds", str(seconds), "--trace",
         str(trace)], capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t
    if out is not None:
        base = f"{workload}.{seed}.{trace}"
        (out / f"{base}.out").write_text(p.stdout)
        (out / f"{base}.err").write_text(p.stderr)
    rec = {"workload": workload, "seed": seed, "trace": trace,
           "rc": p.returncode, "wall_s": wall}
    try:
        res = json.loads(p.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        rec["stderr"] = p.stderr[-2000:]
        return rec
    rec.update(correct=res["correct"],
               metrics={k: v["value"] for k, v in res["metrics"].items()},
               check={k: v["value"] for k, v in res["check"].items()},
               device=res["device"])
    return rec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench.sets")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--sets", type=int, default=2)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--out", type=Path)
    args = p.parse_args(argv)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    runs = []
    for k in range(args.sets):
        for seed in args.seeds:
            rec = one_run(args.workload, seed, args.seconds, args.trace,
                          args.out)
            rec["set"] = k
            runs.append(rec)
            print(json.dumps(rec), flush=True)
    names = sorted({m for r in runs for m in r.get("metrics", {})})
    summary = {"workload": args.workload, "runs": len(runs),
               "correct": sum(bool(r.get("correct")) for r in runs)}
    for m in names:
        per_set = []
        for k in range(args.sets):
            vals = [r["metrics"][m] for r in runs
                    if r["set"] == k and m in r.get("metrics", {})]
            if len(vals) >= 2:
                per_set.append({"median": statistics.median(vals),
                                "spread": spread(vals), "values": vals})
        summary[m] = per_set
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
