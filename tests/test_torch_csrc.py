"""The CUDA sources of ``amw_tpu_torch/csrc`` against their users, read as
text: nothing here compiles them (the CPU machines have no ``nvcc``).

- every quoted ``#include`` of a source names a file of ``csrc/``;
- every ``_cuda.launch("<name>", ...)`` of the package names an entry of
  ``_cuda._ENTRIES``, and that entry an ``extern "C"`` function of the
  ``csrc/<stem>.cu`` it is bound to;
- each entry's argument kinds (pointer, int, float; the stream last) are
  the C function's parameters, and every ``extern "C"`` function of a
  source has an entry.
"""

import re
from pathlib import Path

import pytest

from amw_tpu_torch.ops import _cuda

PKG = Path(_cuda.__file__).resolve().parent.parent
CSRC = PKG / "csrc"
SOURCES = sorted(p.name for p in CSRC.iterdir()
                 if p.suffix in (".cu", ".cuh"))
EXTERN_C = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')


def _launch_names() -> list[str]:
    pat = re.compile(r'_cuda\.launch\(\s*"(\w+)"')
    return sorted({m for py in PKG.rglob("*.py")
                   for m in pat.findall(py.read_text())})


def _c_entries(stem: str) -> dict[str, str]:
    """extern "C" functions of csrc/<stem>.cu: name -> argument kinds."""
    out = {}
    for name, params in EXTERN_C.findall((CSRC / f"{stem}.cu").read_text()):
        kinds = []
        for p in (p.strip() for p in params.split(",")):
            if "*" in p:
                kinds.append("p")
            elif p.split()[0] == "int":
                kinds.append("i")
            elif p.split()[0] == "float":
                kinds.append("f")
            else:
                raise AssertionError(f"{stem}.cu {name}: parameter {p!r}")
        out[name] = "".join(kinds)
    return out


def test_sources_found():
    assert any(s.endswith(".cu") for s in SOURCES)
    assert len(_launch_names()) == len(_cuda._ENTRIES)


@pytest.mark.parametrize("source", SOURCES)
def test_quoted_includes_name_csrc_files(source):
    text = (CSRC / source).read_text()
    for inc in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M):
        assert (CSRC / inc).is_file(), f"{source} includes missing {inc}"


@pytest.mark.parametrize("name", _launch_names())
def test_launch_names_an_extern_c_function(name):
    assert name in _cuda._ENTRIES, f"launch({name!r}) has no entry"
    stem = _cuda._ENTRIES[name][0]
    assert name in _c_entries(stem), f"no extern \"C\" {name} in {stem}.cu"


@pytest.mark.parametrize("name", sorted(_cuda._ENTRIES))
def test_entry_kinds_match_c_parameters(name):
    stem, kinds = _cuda._ENTRIES[name]
    # the C function takes the stream last (void*), which launch() appends
    assert _c_entries(stem)[name] == kinds + "p"


@pytest.mark.parametrize("source", [s for s in SOURCES if s.endswith(".cu")])
def test_every_extern_c_function_is_bound(source):
    stem = source[:-3]
    for name in _c_entries(stem):
        assert _cuda._ENTRIES.get(name, (None,))[0] == stem, (
            f"{source}: extern \"C\" {name} is not bound to {stem}")
