"""The port's mesh-sharded htdemucs separation
(``amw_tpu_torch/models/htdemucs.separate_mesh``) against its own
``separate`` and the JAX package's ``separate_mesh`` on the CPU (the cases
of tests/test_htdemucs_mesh.py): the tiny config with the same seeded
weights in both packages, positions on ``cpu``.  Bar: ≤ −90 dBFS; the
window groups are the same computations in either route, only the order
of the overlap-add sums differs."""

import numpy as np
import pytest
import torch

from amw_tpu.models import htdemucs_jax as hj
from amw_tpu.models import vocal as jvo
from amw_tpu.parallel import mesh as jmesh
from amw_tpu_torch.convert import htdemucs_from_jax
from amw_tpu_torch.models import htdemucs as ht
from amw_tpu_torch.models import vocal as tvo
from amw_tpu_torch.parallel import mesh as tmesh

BAR_DBFS = -90.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU paths here are many small ops: one intra-op thread
    keeps them from spinning against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def dbfs(a, b):
    return 20 * np.log10(max(float(np.max(np.abs(
        np.asarray(a, np.float64) - b))), 1e-30))


@pytest.fixture(scope="module")
def tiny():
    cfg = hj.tiny_config()
    params = hj.init_params(cfg, seed=3)
    model = htdemucs_from_jax(params, ht.tiny_config(), device="cpu",
                              dtype=torch.float32)
    return cfg, params, model


@pytest.fixture(scope="module")
def track():
    g = np.random.default_rng(11)
    n = 27000  # ~3.4 s at the tiny 8 kHz rate: several window groups
    x = (0.3 * g.standard_normal((2, n))).astype(np.float32)
    return np.round(x * 32768.0).clip(-32767, 32767).astype(np.float32) \
        / np.float32(32768.0)


@pytest.fixture(scope="module")
def single(tiny, track):
    return ht.separate(tiny[2], track, stems=("vocals",))


def _cpu_mesh(n):
    return tmesh.make_mesh(n, devices=["cpu"] * n)


@pytest.mark.parametrize("ndev", [2, 4])
def test_mesh_matches_single_device_and_jax(tiny, track, single, ndev):
    cfg, params, model = tiny
    got = ht.separate_mesh(model, track, _cpu_mesh(ndev),
                           stems=("vocals",))
    assert got.shape == single.shape
    assert dbfs(got, single) <= BAR_DBFS
    want = hj.separate_mesh(params, track, jmesh.make_mesh(ndev), cfg,
                            stems=("vocals",))
    assert dbfs(got, want) <= BAR_DBFS


def test_mesh_2d_shards_dp_axis_only(tiny, track, single):
    """On a 2-D dp × sp mesh the window groups split over dp only."""
    mesh = tmesh.make_mesh2d(4, 2, devices=["cpu"] * 8)
    got = ht.separate_mesh(tiny[2], track, mesh, axis="dp",
                           stems=("vocals",))
    assert dbfs(got, single) <= BAR_DBFS


def test_mesh_all_stems_short_track(tiny):
    """A track shorter than one segment, all four stems: fewer groups than
    positions (the extra positions run none)."""
    cfg, params, model = tiny
    g = np.random.default_rng(5)
    x = (0.2 * g.standard_normal((2, cfg.segment_samples // 2))
         ).astype(np.float32)
    want = ht.separate(model, x)
    got = ht.separate_mesh(model, x, _cpu_mesh(8))
    assert got.shape == want.shape == (4, 2, x.shape[-1])
    assert dbfs(got, want) <= BAR_DBFS
    assert dbfs(got, hj.separate_mesh(params, x, jmesh.make_mesh(8),
                                      cfg)) <= BAR_DBFS


def test_mesh_models_one_copy_per_device(tiny, track, single):
    """A state dict is built once per distinct device; a model is taken
    as it is on its own device; device_out keeps the stems there."""
    _, params, model = tiny
    mesh = _cpu_mesh(4)
    models = ht.mesh_models(model, mesh)
    assert list(models) == [torch.device("cpu")]
    assert models[torch.device("cpu")] is model
    state = {k: torch.from_numpy(np.asarray(v, np.float32))
             for k, v in params.items()}
    built = ht.mesh_models(state, mesh, ht.tiny_config())
    out = ht.separate_mesh(built, track, mesh, stems=("vocals",),
                           device_out=True)
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    assert dbfs(out.numpy(), single) <= BAR_DBFS
    with pytest.raises(ValueError, match="no model"):
        ht.mesh_models({torch.device("meta"): model}, mesh)


def test_isolate_vocal_with_mesh(monkeypatch):
    """``isolate_vocal(mesh=)`` on the bundled checkpoint goes through
    ``separate_mesh`` (one copy of the network a mesh) and equals the
    call without a mesh, and the JAX package's over its 8 devices."""
    monkeypatch.setenv("AMW_HTDEMUCS_CKPT", "bundled")
    sr = 44100
    g = np.random.default_rng(6)
    n = 3 * sr
    t = np.arange(n) / sr
    x = np.clip(np.stack([0.3 * np.sin(2 * np.pi * 220 * t),
                          0.25 * np.sin(2 * np.pi * 330 * t)])
                + 0.05 * g.standard_normal((2, n)), -0.99, 0.99
                ).astype(np.float32)
    mesh = _cpu_mesh(2)
    calls = []
    real = ht.separate_mesh
    monkeypatch.setattr(ht, "separate_mesh",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = tvo.isolate_vocal(x, sr, device="cpu", mesh=mesh)
    assert calls == [1]
    first = dict(tvo._mesh_params_cache)
    tvo.isolate_vocal(x, sr, device="cpu", mesh=mesh)
    assert tvo._mesh_params_cache == first  # the mesh's copy is kept
    want = tvo.isolate_vocal(x, sr, device="cpu")
    assert got.shape == x.shape and dbfs(got, want) <= BAR_DBFS
    j = np.asarray(jvo.isolate_vocal(x, sr, mesh=jmesh.make_mesh(8)))
    assert dbfs(got, j) <= BAR_DBFS
