"""What the port raises for an ``amw_tpu`` module it does not have yet.

Every such ``NotImplementedError`` names the JAX package's module file to
port (``amw_tpu/...py``) instead of a queue number of ROADMAP.md, so a
renumbering of the queue cannot leave it pointing at the wrong item.  Each
raise is triggered here at a tiny size on the CPU, and every module file it
names must exist.
"""

import os
import re
from pathlib import Path
from unittest import mock

import numpy as np
import pytest

from amw_tpu_torch import GraphSpec
from amw_tpu_torch.models import build_v2_job_graph
from amw_tpu_torch.models.vocal import isolate_vocal

ROOT = Path(__file__).resolve().parent.parent
SR = 44100
SPEC = GraphSpec(sr=SR, n=SR)


def _v2(pro):
    return lambda: build_v2_job_graph(SPEC, None, pro, device="cpu")


def _isolate_with_checkpoint():
    """``isolate_vocal`` where an htdemucs checkpoint is configured: the
    JAX package would run the network there, which the port lacks."""
    with mock.patch.dict(os.environ, {"AMW_HTDEMUCS_CKPT": str(ROOT)}):
        isolate_vocal(np.zeros((2, 4096), np.float32), SR, device="cpu")


CASES = {
    "v2_vocal_isolation": (_v2({"apply_vocal_isolation": True}),
                           ["amw_tpu/runtime/engine.py"]),
    "vocal_htdemucs_checkpoint": (_isolate_with_checkpoint,
                                  ["amw_tpu/models/htdemucs_jax.py"]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_not_ported_message_names_an_existing_module(case):
    build, modules = CASES[case]
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as info:
        build()
    named = re.findall(r"amw_tpu/[\w/]+\.py", str(info.value))
    assert named == modules
    for path in named:
        assert (ROOT / path).is_file(), path


def test_v2_job_docstring_names_an_existing_runtime_module():
    """The v2 job's note on its missing progress ticks names the module."""
    from amw_tpu_torch.models import v2_job

    named = re.findall(r"amw_tpu/[\w/]+\.py", v2_job.__doc__)
    assert named and all((ROOT / p).is_file() for p in named)
