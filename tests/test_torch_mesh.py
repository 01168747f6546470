"""The port's meshes of positions and data-parallel batch mastering
(``amw_tpu_torch/parallel/mesh.py``, ``parallel/batch.py``) against
``amw_tpu.parallel`` on the CPU (the cases of tests/test_parallel.py)."""

import numpy as np
import pytest
import torch

from amw_tpu.parallel import batch as jbatch
from amw_tpu.parallel import mesh as jmesh
from amw_tpu_torch import GraphSpec
from amw_tpu_torch.models.chain import compile_chain
from amw_tpu_torch.parallel import batch as tbatch
from amw_tpu_torch.parallel import mesh as tmesh

SR = 8000  # small rate keeps the CPU tests fast


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU paths here are many small ops: one intra-op thread
    keeps them from spinning against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tracks(b, n, seed=0):
    g = np.random.default_rng(seed)
    t = np.arange(n) / SR
    base = 0.3 * np.sin(2 * np.pi * 110 * t)
    out = []
    for _ in range(b):
        x = (base + 0.05 * g.standard_normal(n)).astype(np.float32)
        out.append(np.stack([x, 0.8 * x]))
    return np.clip(np.stack(out), -1, 1)


def _cpu(n):
    return ["cpu"] * n


def _db(got, want):
    err = np.max(np.abs(got.astype(np.float64) - want))
    return 20 * np.log10(max(err, 1e-12))


class _Dev:
    """Stand-in device carrying only process_index."""

    def __init__(self, pid, i):
        self.process_index = pid
        self.id = pid * 100 + i


@pytest.mark.parametrize("case", ["sp4_over_4_hosts", "whole_host_rows",
                                  "host_straddling_sp"])
def test_pod_layout_matches_jax(case):
    hosts, per, sp = {"sp4_over_4_hosts": (4, 8, 4),
                      "whole_host_rows": (2, 8, None),
                      "host_straddling_sp": (2, 4, 8)}[case]
    devs = [_Dev(p, i) for p in range(hosts) for i in range(per)]
    if case == "host_straddling_sp":
        with pytest.raises(ValueError):
            jmesh.pod_layout(devs, sp=sp)
        with pytest.raises(ValueError):
            tmesh.pod_layout(devs, sp=sp)
        return
    want = jmesh.pod_layout(devs, sp=sp)
    got = tmesh.pod_layout(devs, sp=sp)
    assert got.shape == want.shape
    assert [[d.id for d in r] for r in got] == [[d.id for d in r]
                                                for r in want]
    for row in got:
        assert len({d.process_index for d in row}) == 1


def test_init_distributed_noop_without_config():
    assert tmesh.init_distributed() is False
    assert jmesh.init_distributed() is False


def test_meshes_of_positions():
    """Positions may repeat a device; shapes and axes as in JAX's meshes;
    a single-host pod mesh is ``make_mesh2d(n // sp, sp)``."""
    m = tmesh.make_mesh(4, devices=_cpu(8))
    assert m.shape == {"dp": 4} and m.devices.size == 4
    assert m.distinct_devices() == [torch.device("cpu")]
    m2 = tmesh.make_mesh2d(2, 4, devices=_cpu(8))
    assert m2.shape == dict(jmesh.make_mesh2d(2, 4).shape)
    pod = tmesh.make_pod_mesh(sp=4, devices=_cpu(8))
    assert pod.devices.shape == (2, 4) == jmesh.make_pod_mesh(sp=4).devices.shape
    with pytest.raises(ValueError, match="need 8"):
        tmesh.make_mesh2d(2, 4, devices=_cpu(4))
    with pytest.raises(ValueError, match="device type"):
        tmesh.device_type(tmesh.Mesh([torch.device("cpu"),
                                      torch.device("meta")], ("dp",)))


def test_mesh_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tmesh.make_mesh(), lambda: tmesh.make_mesh2d(1, 2),
                 lambda: tmesh.make_mesh(devices=["cuda:0"]),
                 lambda: tmesh.make_pod_mesh()):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_shard_and_replicate():
    m = tmesh.make_mesh(4, devices=_cpu(4))
    xb = torch.arange(8.0).reshape(8, 1)
    parts = tmesh.shard_batch(xb, m)
    assert [p.flatten().tolist() for p in parts] == [[0, 1], [2, 3], [4, 5],
                                                     [6, 7]]
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.shard_batch(xb[:6], m)
    p = [torch.zeros(3)]
    rep = tmesh.replicate(p, m)
    assert list(rep) == [torch.device("cpu")]
    assert rep[torch.device("cpu")][0] is p[0]  # no copy on its own device


def test_pad_to_bucket_matches_jax():
    for n in (100_000, 15 * 44100, 4000 * 44100):
        x = np.ones((2, n), np.float32)
        (pg, ng), (pw, nw) = (tbatch.pad_to_bucket(x, 44100),
                              jbatch.pad_to_bucket(x, 44100))
        assert ng == nw == n and pg.shape == pw.shape
        assert np.array_equal(pg, pw)


@pytest.mark.parametrize("nvb,match", [([SR // 2], "below the minimum"),
                                       ([3 * SR + 1], "exceeds the bucket")])
def test_check_nvb_errors_match_jax(nvb, match):
    from amw_tpu.spec import GraphSpec as JSpec

    with pytest.raises(ValueError, match=match):
        jbatch._check_nvb(nvb, JSpec(sr=SR, n=3 * SR))
    with pytest.raises(ValueError, match=match):
        tbatch._check_nvb(nvb, GraphSpec(sr=SR, n=3 * SR))
    ok = tbatch._check_nvb([SR, 3 * SR], GraphSpec(sr=SR, n=3 * SR))
    assert ok.dtype == np.int32 and ok.tolist() == [SR, 3 * SR]


@pytest.fixture(scope="module")
def mixed_batch():
    bucket = 3 * SR
    lengths = [bucket, int(2.6 * SR) + 17, int(2.83 * SR) + 1, bucket - 1]
    xb = np.zeros((4, 2, bucket), np.float32)
    for i, nv in enumerate(lengths):
        seg = _tracks(1, nv, seed=i)[0]
        xb[i, :, :nv] = np.clip(seg + 0.02 * (i + 1), -1, 1)
    return xb, lengths


def test_batch_master_mesh_matches_per_track_and_jax(mixed_batch):
    """Bucket-padded batch with per-track n_valid over 4 CPU positions:
    each track (sliced to its length) equals the port's exact-length
    chain and the JAX package's batch over its 8-device CPU mesh, and its
    padding stays zero."""
    xb, lengths = mixed_batch
    nvb = np.asarray(lengths)
    got = tbatch.batch_master(xb, SR, mesh=tmesh.make_mesh(4,
                                                           devices=_cpu(4)),
                              nvb=nvb)
    want = np.asarray(jbatch.batch_master(xb, SR, mesh=jmesh.make_mesh(4),
                                          nvb=nvb))
    for i, nv in enumerate(lengths):
        chain = compile_chain(GraphSpec(sr=SR, n=nv, channels=2),
                              device="cpu")
        assert _db(got[i, :, :nv], chain(xb[i, :, :nv])) < -90.0, i
        assert _db(got[i, :, :nv], want[i, :, :nv]) < -90.0, i
        if nv < xb.shape[-1]:
            assert np.abs(got[i, :, nv:]).max() == 0.0


def test_batch_master_mesh_equals_one_device(mixed_batch):
    """The positions run the one-device batch's per-track math."""
    xb, lengths = mixed_batch
    nvb = np.asarray(lengths)
    mesh_out = tbatch.batch_master(xb, SR, mesh=tmesh.make_mesh(
        2, devices=_cpu(2)), nvb=nvb)
    one = tbatch.batch_master(xb, SR, nvb=nvb, device="cpu")
    assert _db(mesh_out, one) < -120.0


def test_batch_master_on_eight_device_jax_mesh():
    """The unpadded batch: the port on 4 positions against the JAX
    package's ``batch_master`` over 8 CPU devices (8 tracks)."""
    xb = _tracks(8, 2 * SR)
    got = tbatch.batch_master(xb, SR, mesh=tmesh.make_mesh(4,
                                                           devices=_cpu(4)))
    want = np.asarray(jbatch.batch_master(xb, SR, mesh=jmesh.make_mesh(8)))
    assert got.shape == want.shape
    assert _db(got, want) < -90.0


def test_make_batch_fn_without_mesh_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tbatch.make_batch_fn(GraphSpec(sr=SR, n=2 * SR))
