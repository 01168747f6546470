"""The port held to ``amw_tpu`` name by name, with ``ast`` only (neither
package is imported).

For each module of ``amw_tpu``, every public top-level ``def``, ``class``
and assigned name, and every public method of a class that both modules
have, must exist in the port's module of the same path (two files were
renamed: ``RENAMED``).  The one exception is ``LEFT_OUT``, keyed by
(module, name), with ``"*"`` for a whole module: its value is the reason,
and every ``amw_tpu_torch.…`` dotted path in it must resolve in the
port's source.  An entry whose name no longer exists in ``amw_tpu``, or
which the port now has, fails, so that the table stays exact.
"""

import ast
import re
from functools import cache
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "amw_tpu"
PORT = ROOT / "amw_tpu_torch"

RENAMED = {"models/htdemucs_jax.py": "models/htdemucs.py",
           "ops/fft_pallas.py": "ops/fft_staged.py"}

_HT = "amw_tpu_torch.models.htdemucs"
_HT_CONV = (f"the layers' torch convolutions ({_HT}.HEncLayer, "
            f"{_HT}.HDecLayer, {_HT}.DConv)")
_NATIVE_BUILD = ("a path of the JAX package's build layout; the port builds "
                 "into its own directory (amw_tpu_torch.native.build.BUILD, "
                 "amw_tpu_torch.native.build.target)")

LEFT_OUT = {
    ("ops/fdfilter.py", "fft_native_ok"): (
        "XLA-TPU's native FFT size set; cuFFT takes every length, and "
        "amw_tpu_torch.ops.fdfilter.resample_fft ignores the plan"),
    ("ops/fft_pallas.py", "plan_ok"): "amw_tpu_torch.ops.design.plan_ok",
    ("parallel/mesh.py", "replicated"): (
        "a NamedSharding; amw_tpu_torch.parallel.mesh.replicate"),
    ("models/htdemucs_jax.py", "conv1d"): _HT_CONV,
    ("models/htdemucs_jax.py", "conv2d"): _HT_CONV,
    ("models/htdemucs_jax.py", "conv_transpose1d"): _HT_CONV,
    ("models/htdemucs_jax.py", "conv_transpose2d"): _HT_CONV,
    ("models/htdemucs_jax.py", "group_norm1"): f"{_HT}._group_norm1",
    ("models/htdemucs_jax.py", "group_norm_tokens"):
        f"{_HT}._group_norm_tokens",
    ("models/htdemucs_jax.py", "layer_norm"): f"{_HT}._layer_norm",
    ("models/htdemucs_jax.py", "mha"): f"{_HT}._mha",
    ("models/htdemucs_jax.py", "torch_stft"): f"{_HT}._stft",
    ("models/htdemucs_jax.py", "torch_istft"): f"{_HT}._istft",
    ("models/htdemucs_jax.py", "inference_params"): (
        f"the weights cast once at load: {_HT}.inference_model"),
    ("models/htdemucs_jax.py", "params_from_torch_state"): (
        f"the network takes a torch state dict as it is "
        f"({_HT}.inference_model); the JAX package's dict: "
        f"amw_tpu_torch.convert.htdemucs_from_jax"),
    ("native/build.py", "SRC"): _NATIVE_BUILD,
    ("native/build.py", "OUT"): _NATIVE_BUILD,
    ("native/build.py", "SRC_FLAC"): _NATIVE_BUILD,
    ("native/build.py", "OUT_FLAC"): _NATIVE_BUILD,
    ("native/build.py", "SRC_LAVC"): _NATIVE_BUILD,
    ("native/build.py", "OUT_LAVC"): _NATIVE_BUILD,
    ("refimpl/__init__.py", "*"): (
        "the JAX package's numpy oracle, which the tests hold both "
        "packages to"),
    ("refimpl/chain.py", "*"): "the JAX package's numpy oracle",
    ("refimpl/pipeline.py", "*"): "the JAX package's numpy oracle",
    ("runtime/compile_cache.py", "*"): (
        "XLA's persistent compilation cache; the port compiles no graph"),
    ("models/htdemucs_torch.py", "*"): (
        "the JAX package's PyTorch oracle of htdemucs; the port's network "
        "is amw_tpu_torch.models.htdemucs.HTDemucs"),
}

JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


@cache
def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _defs(tree: ast.Module) -> dict:
    """Top-level names of a module (``def``, ``class`` and assignment
    targets; a name it imports does not count), each with its node."""
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out[node.name] = node
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                for name in ast.walk(t):
                    if isinstance(name, ast.Name):
                        out[name.id] = node
    return out


def _public(names) -> list:
    return sorted(n for n in names if not n.startswith("_"))


def _methods(cls: ast.ClassDef) -> set:
    return {n.name for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _port_path(module: str) -> Path:
    return PORT / RENAMED.get(module, module)


def _missing(module: str) -> list:
    """The public names of ``amw_tpu/<module>`` that the port's module
    lacks: top-level names, and ``Class.method`` for the classes both
    have."""
    port = _port_path(module)
    jnames = _defs(_tree(JAX / module))
    if not port.exists():
        return ["*"]
    pnames = _defs(_tree(port))
    out = [n for n in _public(jnames) if n not in pnames]
    for name in _public(jnames):
        jnode, pnode = jnames[name], pnames.get(name)
        if isinstance(jnode, ast.ClassDef) and isinstance(pnode,
                                                          ast.ClassDef):
            out += [f"{name}.{m}" for m in _public(_methods(jnode))
                    if m not in _methods(pnode)]
    return out


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_names_ported(module):
    missing = [n for n in _missing(module) if (module, n) not in LEFT_OUT]
    assert not missing, (
        f"amw_tpu/{module}: no counterpart in "
        f"{_port_path(module).relative_to(ROOT)} for {missing}; port them "
        f"or add each to LEFT_OUT with its reason")


def _resolves(dotted: str) -> bool:
    """Does ``amw_tpu_torch.a.b.name[.attr]`` name a module, a top-level
    name of a module or an attribute of a class in the port's source?"""
    parts = dotted.split(".")[1:]
    for i in range(len(parts), -1, -1):  # the longest module prefix first
        base = PORT.joinpath(*parts[:i])
        path = base.with_suffix(".py")
        if not path.exists():
            path = base / "__init__.py"
        if not path.exists():
            continue
        rest = parts[i:]
        if not rest:
            return True
        node = _defs(_tree(path)).get(rest[0])
        if node is None or len(rest) == 1:
            return node is not None
        return (isinstance(node, ast.ClassDef) and len(rest) == 2
                and rest[1] in _defs(ast.Module(body=node.body,
                                                type_ignores=[])))
    return False


@pytest.mark.parametrize("entry", sorted(LEFT_OUT), ids="::".join)
def test_left_out_entry(entry):
    module, name = entry
    reason = LEFT_OUT[entry]
    assert (JAX / module).exists(), f"amw_tpu/{module} is gone"
    if name == "*":
        assert not _port_path(module).exists(), (
            f"{module} now has a counterpart: take it out of LEFT_OUT")
    else:
        top = name.split(".")[0]
        assert top in _defs(_tree(JAX / module)), (
            f"amw_tpu/{module} no longer has {name}: take it out of LEFT_OUT")
        assert name in _missing(module), (
            f"the port now has {module}'s {name}: take it out of LEFT_OUT")
    paths = re.findall(r"amw_tpu_torch(?:\.\w+)+", reason)
    assert paths or " " in reason, f"{entry}: give a reason or a path"
    for dotted in paths:
        assert _resolves(dotted), f"{entry}: {dotted} is not in the port"


def test_resolver_rejects_unknown_paths():
    assert _resolves("amw_tpu_torch.ops.scan.envelope_follower_xsr")
    assert _resolves("amw_tpu_torch.runtime.batcher.BatchedChainRunner"
                     ".master")
    assert not _resolves("amw_tpu_torch.ops.scan.no_such_function")
    assert not _resolves("amw_tpu_torch.no_such_module.name")
