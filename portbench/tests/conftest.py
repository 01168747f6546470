"""Fixtures of the benchmark's own tests (CPU; the card tests are marked
``cuda`` and skip without one)."""

import json
import shutil
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
TINY = {"batch": 2, "pool": 2, "bucket_s": 3.0, "valid_s": [2.0, 3.0],
        "trace_s": 0.1}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def make_tiny_root(dst: Path) -> Path:
    """A checkout-like root whose cells are the benchmark's at CPU size:
    the same configurations and files, batches of 2 tracks at a 3 s
    bucket (traffic ``tiny``)."""
    pkg = dst / "portbench"
    pkg.mkdir(parents=True)
    for d in ("configs", "traffic", "workloads", "metrics", "entries",
              "end_to_end"):
        shutil.copytree(ROOT / "portbench" / d, pkg / d)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    tr = json.loads((ROOT / "portbench/traffic/batch8.json").read_text())
    (pkg / "traffic/tiny.json").write_text(json.dumps({**tr, **TINY}))
    for w in bench["workloads"]:
        w["traffic"] = "tiny"
    (dst / "BENCHMARK.json").write_text(json.dumps(bench))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))
