"""What the port raises for an ``amw_tpu`` module it does not have yet.

Every such ``NotImplementedError`` names the JAX package's module file to
port (``amw_tpu/...py``) instead of a queue number of ROADMAP.md, so a
renumbering of the queue cannot leave it pointing at the wrong item.  Each
raise is triggered here at a tiny size on the CPU, and every module file it
names must exist.
"""

import re
from pathlib import Path

import pytest

from amw_tpu_torch import GraphSpec
from amw_tpu_torch.models import build_v2_job_graph
from amw_tpu_torch.models.chain import build_chain_ops
from amw_tpu_torch.ops.exciter import build_harmonic_exciter

ROOT = Path(__file__).resolve().parent.parent
SR = 44100
SPEC = GraphSpec(sr=SR, n=SR)


def _v2(pro):
    return lambda: build_v2_job_graph(SPEC, None, pro, device="cpu")


def _chain(module_id):
    return lambda: build_chain_ops(SPEC, {"modules": [{"id": module_id}]},
                                   device="cpu")


CASES = {
    "v2_true_peak": (_v2({"true_peak_enabled": True}),
                     ["amw_tpu/ops/tplimit.py"]),
    "v2_vocal_isolation": (_v2({"apply_vocal_isolation": True}),
                           ["amw_tpu/models/vocal.py",
                            "amw_tpu/models/htdemucs_jax.py"]),
    "chain_reverb": (_chain("reverb"), ["amw_tpu/ops/reverb.py"]),
    "chain_true_peak_limiter": (_chain("true_peak_limiter"),
                                ["amw_tpu/ops/tplimit.py"]),
    "exciter_oversampled": (
        lambda: build_harmonic_exciter(SPEC, 0.6, oversample=2,
                                       device="cpu"),
        ["amw_tpu/ops/fdfilter.py"]),
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
