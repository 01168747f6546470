"""The port's operator checklist (``amw_tpu_torch/scripts/run_debug.py``)
against the JAX package's ``scripts/run_debug.py`` on the CPU: both run
with every check passing, in the same eight sections with the same check
names (but the first, which names the torch device where the JAX script
names JAX's), and the port's op checks print their errors.

The JAX script's run takes most of a minute here, so its sections and
names are read from its source, and each run is held to that list: the
port's here, the JAX script's in ``tests/test_torch_scripts_debug_jax.py``.
"""

import ast
import re

import pytest

from amw_tpu_torch.scripts import run_debug
from test_torch_scripts import ROOT, one_torch_thread, run_port, workdir

# the fixtures, imported for this module's tests
__all__ = ["one_torch_thread", "workdir"]

FIRST_CHECK = {"jax devices": "torch devices"}


def jax_checklist() -> list:
    """``[(section number, [check names])]`` from the JAX script's source:
    its ``print("N) ...")`` headers, ``@check(...)`` decorators and
    ``op_check(...)`` calls, in order."""
    tree = ast.parse((ROOT / "scripts" / "run_debug.py").read_text())
    events = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call) or not node.args:
            continue
        arg = node.args[0]
        if not (isinstance(arg, ast.Constant) and isinstance(arg.value, str)):
            continue
        name = getattr(node.func, "id", None)
        if name == "print" and re.match(r"\d\) ", arg.value):
            events.append((node.lineno, "section", arg.value.split(")")[0]))
        elif name in ("check", "op_check"):
            events.append((node.lineno, "check", arg.value))
    out = []
    for _, kind, value in sorted(events):
        if kind == "section":
            out.append((value, []))
        else:
            out[-1][1].append(value)
    return out


def printed_checklist(out: str) -> tuple[list, list]:
    """(``[(section, [check names])]``, failures) of a run's output."""
    sections, fails = [], []
    for line in out.splitlines():
        m = re.match(r"(\d)\) ", line)
        if m:
            sections.append((m.group(1), []))
            continue
        m = re.match(r"  \[(PASS|FAIL)\] (.+?)(?: \([^()]*\))?$", line)
        if m:
            name = m.group(2).split(": ")[0] if m.group(1) == "FAIL" \
                else m.group(2)
            sections[-1][1].append(name)
            if m.group(1) == "FAIL":
                fails.append(line)
    return sections, fails


def test_jax_source_checklist_is_eight_sections():
    got = jax_checklist()
    assert [s for s, _ in got] == [str(k) for k in range(1, 9)]
    assert sum(len(c) for _, c in got) == 14


def test_port_checklist_passes_with_the_jax_names(workdir, capsys):
    rc, out = run_port(run_debug.main, ["--device", "cpu"], capsys)
    sections, fails = printed_checklist(out)
    assert fails == [] and rc == 0
    want = [(s, [FIRST_CHECK.get(c, c) for c in checks])
            for s, checks in jax_checklist()]
    assert sections == want
    assert out.splitlines()[-1] == "14/14 checks passed"
    # every op check and the v1 check print their error (0 here: the CPU
    # path against itself)
    errs = re.findall(r"\[PASS\] (.+?) \(err ([^)]*)\)", out)
    assert [n for n, _ in errs] == [
        "target_curve", "dynamics", "deesser", "style_eq(edm)",
        "final_spectral_balance", "rumble_filter", "dynamic_eq",
        "v1 pipeline parity vs oracle"]
    assert all(float(e) == 0.0 for _, e in errs)


def test_port_checklist_fails_on_a_failed_check(workdir, monkeypatch,
                                               capsys):
    """A FAIL line and exit code 1 where one op disagrees with the CPU
    path; the other checks still run."""
    calls = []

    def bad(build, mix, sr, dev):
        calls.append(build)
        return 1.0 if len(calls) == 2 else 0.0

    monkeypatch.setattr(run_debug, "op_error", bad)
    rc, out = run_port(run_debug.main, ["--device", "cpu"], capsys)
    sections, fails = printed_checklist(out)
    assert rc == 1 and len(calls) == 7
    assert fails == ["  [FAIL] dynamics: err 1.0"]
    assert out.splitlines()[-1] == "13/14 checks passed"
    assert [s for s, _ in sections] == [str(k) for k in range(1, 9)]


def test_port_checklist_crash_is_not_exit_0(workdir, monkeypatch):
    """An error outside a check propagates (no exit 0 on a crash)."""
    monkeypatch.setattr(run_debug, "_mix", lambda sr: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        run_debug.main(["--device", "cpu"])
