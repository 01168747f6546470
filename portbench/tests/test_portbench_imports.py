"""Nothing the benchmark runs imports the JAX stack, and the reference
imports nothing of the program: top-level module names compared whole
(``amw_tpu_torch`` begins with ``amw_tpu`` and is the port)."""

import ast
from pathlib import Path

import pytest

from portbench import guard

PKG = Path(__file__).resolve().parents[1]
FILES = sorted(PKG.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".", 1)[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".", 1)[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_stack(path):
    assert not top_level_imports(path) & guard.FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_numpy_and_scipy_only(path):
    imported = top_level_imports(path)
    assert "amw_tpu_torch" not in imported and "torch" not in imported
    assert imported <= {"__future__", "math", "numpy", "scipy"}


def test_top_level_names_compared_whole():
    mods = {"amw_tpu_torch": 0, "amw_tpu_torch.ops": 0, "numpy": 0}
    assert guard.forbidden_loaded(mods) == []
    assert guard.forbidden_loaded({**mods, "amw_tpu.ops.fdfilter": 0,
                                   "jaxlib.xla_client": 0}) == [
        "amw_tpu", "jaxlib"]
    assert guard.forbidden_loaded({"jax_like": 0, "flaxen": 0}) == []


def test_the_ast_walk_sees_every_form(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom amw_tpu.ops import x\n"
                 "from . import y\nimport amw_tpu_torch\n")
    assert top_level_imports(f) == {"jax", "amw_tpu", "amw_tpu_torch"}
