"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix.  The harness reads, under ``portbench/`` of the checkout:

- ``configs/<config>.json``: the deployment as it is run (the file that
  ``BENCHMARK.json``'s ``configs`` entry names);
- ``traffic/<traffic>.json``: the generator's parameters and the entry
  kind that drives the program (``entries/<entry>.py``);
- ``workloads/<cell>.json``: the cell's correctness limits;
- ``end_to_end/<metric>.py``, ``metrics/<metric>.py``: one reader per
  end-to-end and per per-layer metric.

Adding a cell, a configuration, a metric or an entry kind adds files and
``BENCHMARK.json`` entries; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NAME_RE = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT_RE = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@dataclass
class Cell:
    """One cell with everything its files say."""

    name: str
    chips: int
    config: dict
    traffic: dict
    check: dict
    end_to_end: list = field(default_factory=list)  # BENCHMARK.json entries
    per_layer: list = field(default_factory=list)
    root: Path = ROOT


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"portbench: {path} is missing")
    return json.loads(path.read_text())


def reports(metric: dict, cell: str, e2e_of_cell: set) -> bool:
    """Whether ``cell`` reports ``metric``: the cells its ``workloads``
    lists, else every cell (an end-to-end metric) or every cell that
    reports the end-to-end metric it moves (a per-layer metric)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if "moves" in metric:
        return metric["moves"] in e2e_of_cell
    return True


def cell(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` under ``root``, with its
    configuration, traffic and check files loaded."""
    bench = bench if bench is not None else load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"portbench: no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    pkg = Path(root) / "portbench"
    config = _json(Path(root) / configs[w["config"]]["file"])
    traffic = _json(pkg / "traffic" / f"{w['traffic']}.json")
    check = _json(pkg / "workloads" / f"{name}.json")
    e2e = [m for m in bench["end_to_end"] if reports(m, name, set())]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic, check=check, end_to_end=e2e,
                per_layer=per_layer, root=Path(root))


def load_module(root: Path, kind: str, name: str):
    """``portbench/<kind>/<name>.py`` under ``root``, imported from its
    path (a metric's file name holds dots)."""
    path = Path(root) / "portbench" / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"portbench: {path} is missing")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def problems(bench: dict, root: Path = ROOT) -> list:
    """What in ``bench`` breaks the harness's rules: names and units,
    files found by name, and each per-layer metric's ``moves`` reported
    wherever the metric is."""
    out = []
    metrics = bench["end_to_end"] + bench["per_layer"]
    for kind in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = set()
        for e in bench[kind]:
            if not NAME_RE.match(e["name"]):
                out.append(f"{kind}: bad name {e['name']!r}")
            if e["name"] in seen:
                out.append(f"{kind}: {e['name']} twice")
            seen.add(e["name"])
    for m in metrics:
        if not UNIT_RE.match(m["unit"]):
            out.append(f"{m['name']}: bad unit {m['unit']!r}")
    cells = [w["name"] for w in bench["workloads"]]
    for w in bench["workloads"]:
        for key in ("config", "traffic"):
            if not NAME_RE.match(w[key]):
                out.append(f"{w['name']}: bad {key} {w[key]!r}")
        try:
            c = cell(w["name"], root, bench)
        except (FileNotFoundError, KeyError) as exc:
            out.append(str(exc))
            continue
        if not (Path(root) / "portbench" / "entries"
                / f"{c.traffic['entry']}.py").is_file():
            out.append(f"{w['name']}: no entry {c.traffic['entry']!r}")
        e2e = {m["name"] for m in c.end_to_end}
        if "setup_s" not in e2e or len(e2e) < 2 or not c.per_layer:
            out.append(f"{w['name']}: needs setup_s, another end-to-end "
                       "metric and a per-layer metric")
        for m in c.per_layer:
            if m["moves"] not in e2e:
                out.append(f"{m['name']} in {w['name']}: moves "
                           f"{m['moves']}, which the cell does not report")
    for kind, dirname in (("end_to_end", "end_to_end"),
                          ("per_layer", "metrics")):
        for m in bench[kind]:
            if not (Path(root) / "portbench" / dirname
                    / f"{m['name']}.py").is_file():
                out.append(f"{m['name']}: no reader")
    for m in metrics:
        for c in m.get("workloads", []):
            if c not in cells:
                out.append(f"{m['name']}: no cell {c}")
    return out
