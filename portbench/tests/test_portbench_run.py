"""Whole runs of the harness on the CPU at a tiny size (the look for a
card skipped): a sound run is correct; a run with the timed path broken
underneath, and the control in the program's place, are not; a cell
added as files only runs; without a card a run fails and prints no
result.  The card test runs one short cell on the card."""

import json
import subprocess
import sys
import time

import pytest
import torch

from portbench import control, manifest, run

SEED = 2 ** 31 + 1234567


def run_tiny(root, name, trace=False):
    cell = manifest.cell(name, root)
    return run.run_cell(cell, SEED, 0.5, trace, device="cpu",
                        t0=time.perf_counter())[0]


def plant(monkeypatch, fault):
    """Break the timed path underneath: every graph the port's builders
    return runs through ``fault``."""
    from amw_tpu_torch.models import pipeline_v1, v2_job

    for mod, name in ((v2_job, "build_v2_job_graph"),
                      (pipeline_v1, "build_v1_pipeline")):
        build = getattr(mod, name)

        def broken(*a, _build=build, **k):
            params, fn, *rest = _build(*a, **k)
            return (params, fault(fn), *rest)

        monkeypatch.setattr(mod, name, broken)


def half_batch(fn):
    """Half of the batch left out: those tracks come back as sent, their
    stats the mean of the mastered half's."""
    def f(x, params, nv):
        h = x.shape[0] // 2
        res = fn(x[:h], params, nv[:h])
        if not isinstance(res, dict):
            return torch.cat([res, x[h:]])
        out = {"out": torch.cat([res["out"], x[h:]])}
        for k in ("before_lufs", "after_lufs", "peak"):
            out[k] = torch.cat([res[k], res[k].mean().expand(x.shape[0] - h)])
        out["finite"] = torch.cat([res["finite"], res["finite"][:1].expand(
            x.shape[0] - h)])
        return out
    return f


def scaled_output(fn):
    """Every output 0.05 dB louder where the graph produces it."""
    def f(x, params, nv):
        res = fn(x, params, nv)
        if isinstance(res, dict):
            return {**res, "out": res["out"] * 1.00577}
        return res * 1.00577
    return f


def shifted_loudness(fn):
    """The reported loudness after mastering 0.01 LU off."""
    def f(x, params, nv):
        res = fn(x, params, nv)
        return {**res, "after_lufs": res["after_lufs"] + 0.01}
    return f


def test_sound_run_is_correct(tiny_root):
    res = run_tiny(tiny_root, "v1_standard.batch8")
    assert res["correct"] and list(res["check"])[-1] == "tail_max"
    assert set(res["metrics"]) == {"rtf", "setup_s"}
    assert res["attempted"] >= 2 and res["failed"] == 0
    assert list(res)[-1] == "check"


@pytest.mark.parametrize("name, fault", [
    ("v1_standard.batch8", half_batch),
    ("v1_standard.batch8", scaled_output),
    ("v2_pro_standard.batch8", half_batch),
    ("v2_pro_standard.batch8", shifted_loudness),
], ids=["v1-half-batch", "v1-altered-output", "v2-half-batch",
        "v2-altered-loudness"])
def test_broken_timed_path_is_not_correct(tiny_root, monkeypatch, name,
                                          fault):
    plant(monkeypatch, fault)
    res = run_tiny(tiny_root, name)
    assert res["correct"] is False


@pytest.mark.parametrize("name", ["v1_standard.batch8",
                                  "v2_pro_standard.batch8"])
def test_control_is_not_correct(tiny_root, name):
    cell = manifest.cell(name, tiny_root)
    got = control.readings(cell, [SEED, SEED + 1], device="cpu", workers=4)
    assert [r["correct"] for r in got] == [False, False]
    assert all(r["numbers"]["out_err"] > cell.check["limits"]["out_err"]
               for r in got)


DUMMY_METRIC = '''"""Steps in the traced window."""

LAYER = "entry and chain"
UNIT = "steps"
MOVES = "rtf"


def read(trace):
    return float(trace.steps)
'''

DUMMY_ENTRY = '''"""A new entry kind: the graph loop under another name."""

from portbench.entries.graph_batch import Entry  # noqa: F401
'''


def test_a_cell_added_as_files_runs(tiny_root, tmp_path):
    """A configuration, a traffic mix, a cell, a per-layer metric and an
    entry kind added as new files and BENCHMARK.json entries: no file
    that is there changes."""
    import shutil

    root = tmp_path / "root"
    shutil.copytree(tiny_root, root)
    before = {p: p.read_bytes() for p in (root / "portbench").rglob("*")
              if p.is_file()}
    pkg = root / "portbench"
    cfg = json.loads((pkg / "configs/v1_standard.json").read_text())
    (pkg / "configs/v1_dummy.json").write_text(
        json.dumps({**cfg, "name": "v1_dummy"}))
    tr = json.loads((pkg / "traffic/tiny.json").read_text())
    (pkg / "traffic/tiny_dummy.json").write_text(
        json.dumps({**tr, "entry": "dummy_batch"}))
    (pkg / "workloads/v1_dummy.tiny_dummy.json").write_text(
        (pkg / "workloads/v1_standard.batch8.json").read_text())
    (pkg / "metrics/dummy.steps.py").write_text(DUMMY_METRIC)
    (pkg / "entries/dummy_batch.py").write_text(DUMMY_ENTRY)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "v1_dummy", "source": "a test",
                             "file": "portbench/configs/v1_dummy.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "v1_dummy.tiny_dummy",
                               "config": "v1_dummy", "traffic": "tiny_dummy",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy.steps", "unit": "steps",
                               "better": "higher", "source": "device_trace",
                               "layer": "entry and chain", "moves": "rtf",
                               "workloads": ["v1_dummy.tiny_dummy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert manifest.problems(bench, root) == []
    assert all(p.read_bytes() == b for p, b in before.items())
    res = run_tiny(root, "v1_dummy.tiny_dummy")
    assert res["correct"] and set(res["metrics"]) == {"rtf", "setup_s"}
    res = run_tiny(root, "v1_dummy.tiny_dummy", trace=True)
    assert res["correct"] and res["metrics"]["dummy.steps"]["value"] >= 1.0


def test_no_card_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        run.main(["--workload", "v1_standard.batch8", "--seed", "1",
                  "--seconds", "1", "--trace", "0"])
    assert exc.value.code not in (0, None)
    assert capsys.readouterr().out == ""


def test_no_card_no_result_from_the_command():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, "-m", "portbench.run", "--workload",
                        "v1_standard.batch8", "--seed", str(SEED),
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120,
                       cwd=str(manifest.ROOT))
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_one_short_run_on_the_card(card, capsys):
    assert run.main(["--workload", "v1_standard.batch8", "--seed",
                     str(SEED), "--seconds", "2", "--trace", "0"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line)["correct"] is True
