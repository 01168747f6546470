"""What the port raises where a graph leaves a job to the engine, and for
an htdemucs checkpoint in the JAX package's format (orbax), which it
cannot read; and that the docstrings naming the JAX package's modules
left out name files that exist.

Every such ``NotImplementedError`` names the JAX package's module file
(``amw_tpu/...py``) instead of a queue number of ROADMAP.md, so a
renumbering of the queue cannot leave it pointing at the wrong item; a
raise for a module not ported would point at ROADMAP.md (none is left),
one for a job the engine does points at the port's entry point.  Each
raise is triggered here at a tiny size on the CPU, and every module file
and entry point it names must exist.
"""

import importlib
import os
import re
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

from amw_tpu_torch import GraphSpec
from amw_tpu_torch.models import build_v2_job_graph
from amw_tpu_torch.models.vocal import isolate_vocal, warmup_htdemucs

ROOT = Path(__file__).resolve().parent.parent
SR = 44100
SPEC = GraphSpec(sr=SR, n=SR)


def _v2(pro):
    return lambda: build_v2_job_graph(SPEC, None, pro, device="cpu")


ENGINE_V2 = "amw_tpu_torch.runtime.engine.MasteringEngine.master_v2_bytes"
# case -> (trigger, amw_tpu module files named, what the message points at)
CASES = {
    "v2_vocal_isolation": (_v2({"apply_vocal_isolation": True}),
                           ["amw_tpu/runtime/engine.py"], ENGINE_V2),
}


def _resolve(dotted: str):
    """The object a dotted path names (module, then attributes)."""
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(parts[:i]))
        except ModuleNotFoundError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(dotted)


@pytest.mark.parametrize("case", sorted(CASES))
def test_not_ported_message_names_an_existing_module(case):
    build, modules, pointer = CASES[case]
    with pytest.raises(NotImplementedError, match=re.escape(pointer)) as info:
        build()
    named = re.findall(r"amw_tpu/[\w/]+\.py", str(info.value))
    assert named == modules
    for path in named:
        assert (ROOT / path).is_file(), path
    if pointer != "ROADMAP.md":
        assert callable(_resolve(pointer)), pointer


ORBAX_CKPT = ROOT / "amw_tpu" / "models" / "checkpoints" / "htdemucs_tiny"


@pytest.mark.parametrize("call", [
    lambda: isolate_vocal(np.zeros((2, 4096), np.float32), SR,
                          device="cpu"),
    lambda: warmup_htdemucs((180.0,), device="cpu")],
    ids=["isolate_vocal", "warmup_htdemucs"])
def test_orbax_checkpoint_names_the_converter(call):
    """An orbax directory configured as the htdemucs checkpoint: the JAX
    package would run the network on it, so the port raises (it does not
    fall back to the DSP separator), naming the script that converts it."""
    with mock.patch.dict(os.environ, {"AMW_HTDEMUCS_CKPT": str(ORBAX_CKPT)}):
        with pytest.raises(ValueError, match=re.escape(
                "scripts/convert_htdemucs_port.py")) as info:
            call()
    assert str(ORBAX_CKPT) in str(info.value)
    assert (ROOT / "scripts" / "convert_htdemucs_port.py").is_file()


def test_v2_job_docstring_names_an_existing_runtime_module():
    """The v2 job's note on its missing progress ticks names the module."""
    from amw_tpu_torch.models import v2_job

    named = re.findall(r"amw_tpu/[\w/]+\.py", v2_job.__doc__)
    assert named and all((ROOT / p).is_file() for p in named)


def test_engine_docstring_names_the_unported_mesh_module():
    """The engine's docstring names the JAX package's sequence-parallel
    module, the counterpart of the port's ``parallel/timeshard.py`` that
    its ``_master_v2_sp`` runs."""
    from amw_tpu_torch.runtime import engine

    named = re.findall(r"amw_tpu/[\w/]+\.py", engine.__doc__)
    assert "amw_tpu/parallel/timeshard.py" in named
    assert all((ROOT / p).is_file() for p in named)


def test_service_docstring_names_existing_modules():
    """The service's docstring names the JAX package's service it ports and
    the port's demo renderer, and lists no module as left out: the routers,
    the bots and the demo render are ported."""
    from amw_tpu_torch.runtime import service

    named = re.findall(r"amw_tpu/[\w/]+\.py", service.__doc__)
    assert named == ["amw_tpu/runtime/service.py"]
    ported = re.findall(r"amw_tpu_torch/[\w/]+\.py", service.__doc__)
    assert ported == ["amw_tpu_torch/scripts/gen_demo_assets.py"]
    assert all((ROOT / p).is_file() for p in named + ported)
    assert "not ported" not in service.__doc__.lower()
