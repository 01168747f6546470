"""BENCHMARK.json against the harness's rules, and the files each cell
finds by name."""

import json

import pytest

from portbench import manifest

BENCH = manifest.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}


def test_benchmark_keys_and_limits():
    assert set(BENCH) == TOP
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(isinstance(w, str) for w in BENCH["command"])
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
    for e in BENCH["configs"] + BENCH["workloads"]:
        for key in ("why", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


@pytest.mark.parametrize("name", [m["name"] for m in METRICS] + CELLS
                         + [c["name"] for c in BENCH["configs"]])
def test_names_use_allowed_characters(name):
    assert manifest.NAME_RE.match(name)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_units_use_allowed_characters(metric):
    assert manifest.UNIT_RE.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")


def test_no_problems():
    assert manifest.problems(BENCH) == []


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = manifest.cell(name)
    assert cell.config["name"] == next(
        w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "rtf"}
    e2e = {m["name"] for m in cell.end_to_end}
    for m in cell.per_layer:
        assert m["moves"] in e2e
        manifest.load_module(manifest.ROOT, "metrics", m["name"])
    for m in cell.end_to_end:
        manifest.load_module(manifest.ROOT, "end_to_end", m["name"])
    manifest.load_module(manifest.ROOT, "entries", cell.traffic["entry"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_metric_reader_states_its_manifest_entry(metric):
    mod = manifest.load_module(manifest.ROOT, "metrics", metric["name"])
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (
        metric["layer"], metric["unit"], metric["moves"])


def test_a_moved_metric_missing_from_a_cell_is_a_problem():
    bench = json.loads(json.dumps(BENCH))
    bench["per_layer"][0]["moves"] = "served_rtf"
    assert any("moves served_rtf" in p for p in manifest.problems(bench))


def test_a_missing_file_is_a_problem(tmp_path):
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"][0]["traffic"] = "no_such_mix"
    assert any("no_such_mix" in p for p in manifest.problems(bench))
