"""The JAX package's operator checklist (``scripts/run_debug.py``) on the
CPU: every check passes, in the sections and under the names that
``tests/test_torch_scripts_debug.py`` reads from its source and holds the
port's ``run_debug`` to.  Its own file: the JAX script's run takes most
of a minute here.
"""

from test_torch_scripts import jax_script, one_torch_thread, run_jax, workdir
from test_torch_scripts_debug import jax_checklist, printed_checklist

# the fixtures, imported for this module's tests
__all__ = ["one_torch_thread", "workdir"]


def test_jax_checklist_passes(workdir, monkeypatch, capsys):
    js = jax_script("run_debug")
    rc, out = run_jax(js, [], monkeypatch, capsys)
    sections, fails = printed_checklist(out)
    assert fails == [] and rc == 0
    assert sections == jax_checklist()
    assert out.splitlines()[-1] == "14/14 checks passed"
