"""Run one cell of the benchmark once and print its result line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up builds (first run in a checkout) or loads the port's kernels,
makes the cell's inputs on the card from the seed, builds the cell's
graph and warms it; then a closed loop runs for ``--seconds``
(``--trace 0``: the end-to-end metrics) or, under the profiler, for the
traffic's ``trace_s`` (``--trace 1``: the per-layer metrics).  Once the
window has closed the checked outputs go to the host, the program's
state is freed and the reference judges them (``check.py``).  The last
line of standard output is the result; the numbers compared, each beside
its limit, are the last lines of standard error and the result's last
key.  Without a card, or with fewer than the cell asks for, the run fails
and prints no result.
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402


@dataclass
class Measured:
    """What the end-to-end readers read (``end_to_end/<metric>.py``)."""

    setup_s: float
    window: object


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def require_card(chips: int) -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("portbench: torch.cuda.is_available() is False; "
                         "the benchmark runs only on the card")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"portbench: the cell asks for {chips} cards, "
                         f"{torch.cuda.device_count()} present")


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             t0: float = T0):
    """One run of ``cell``: ``(result dict, [(name, value, limit, ok)])``."""
    import torch

    from portbench import check, manifest, window
    from portbench import trace as tracing

    entry = manifest.load_module(cell.root, "entries",
                                 cell.traffic["entry"]).Entry(
        cell, seed, device)
    entry.warmup()
    setup_s = time.perf_counter() - t0
    on_card = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips}
    metrics, extra = {}, {}
    if trace:
        import amw_tpu_torch

        csrc = Path(amw_tpu_torch.__file__).resolve().parent / "csrc"
        tr = tracing.traced(entry.step, float(cell.traffic["trace_s"]), csrc)
        for m in cell.per_layer:
            v = manifest.load_module(cell.root, "metrics", m["name"]).read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        extra["breakdown"] = tracing.breakdown(tr)
    else:
        run = Measured(setup_s=setup_s,
                       window=window.closed_loop(entry.step, seconds))
        for m in cell.end_to_end:
            v = manifest.load_module(cell.root, "end_to_end",
                                     m["name"]).read(run)
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(0)
                                if on_card else 0)
    samples = entry.samples()
    attempted, failed = entry.attempted, entry.failed
    entry.close()
    del entry
    gc.collect()
    rows = check.run(cell, samples)
    result = {"correct": all(ok for *_, ok in rows), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev, **extra,
              "check": {n: {"value": v, "limit": lim} for n, v, lim, _ in rows}}
    return result, rows


def main(argv=None) -> int:
    args = parse_args(argv)
    from portbench import guard, manifest

    cell = manifest.cell(args.workload)
    require_card(cell.chips)
    result, rows = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = guard.forbidden_loaded(sys.modules)
    if bad:
        print(f"portbench: the process holds {', '.join(bad)}; no result",
              file=sys.stderr)
        return 3
    for name, v, lim, ok in rows:
        print(f"check {name} {v!r} limit {lim!r} {'ok' if ok else 'FAIL'}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
