"""The port's pod mesh across processes (``amw_tpu_torch/parallel/mesh.py``
``make_pod_mesh`` in a ``torch.distributed`` group, and
``parallel/timeshard.sp_batch_master`` over it) and the engine's join of
the group from its coordinator settings, on the CPU.

Two ranks run as subprocesses of this file (``python
tests/test_torch_pod_mesh.py worker RANK PORT DIR``), each with one
intra-op thread and two ``cpu`` positions, joined over gloo on a free
127.0.0.1 port; each has its own timeout and is killed at it, which fails
the tests.  Each rank builds ``make_pod_mesh(sp=2)`` (the (2, 2) grid,
row r on rank r), is refused ``sp=4`` (a row would straddle the ranks)
and a batch of 3 (dp is 2), then masters the 8 s track pair of
tests/test_torch_timeshard.py with and without the stats, and its first
track through ``sp_master``.  The parent holds each rank's results to
the single-process port over ``make_mesh2d(2, 2)`` (bit for bit) and
the batch to ``amw_tpu``'s ``sp_batch_master`` over its 2 × 2 mesh
(≤ −90 dBFS).  Each rank also joins its group a second time (kept) and
asks for a group of another size (refused).
"""

import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
SR = 44100
HALO = 32768
RANKS = 2
RANK_TIMEOUT_S = 180.0
STATS = ("before_lufs", "after_lufs", "peak", "finite")


def _track() -> np.ndarray:
    """tests/test_torch_timeshard.py's 8 s stereo track."""
    g = np.random.default_rng(3)
    n = 8 * SR
    t = np.arange(n) / SR
    x = (0.25 * np.sin(2 * np.pi * 220 * t)
         + 0.1 * np.sin(2 * np.pi * 1500 * t)
         + 0.03 * g.standard_normal(n))
    env = 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 0.3 * t))
    x = np.clip(np.stack([x * env, 0.85 * x * env]), -0.99, 0.99)
    x = x.astype(np.float32)
    return x - x.mean(axis=-1, keepdims=True)


def _pair() -> np.ndarray:
    """The track pair of tests/test_torch_timeshard.py's 2-D mesh case."""
    x = _track()
    return np.stack([x, np.roll(x, 1000, axis=-1) * 0.8])


def _master(xb, mesh):
    """The batch through ``sp_batch_master``, and through the graph with
    ``stats=True``: (out [B, C, N], stats by name)."""
    from amw_tpu_torch.parallel import timeshard as tts

    out = tts.sp_batch_master(xb, SR, mesh, target_lufs=-14.0, halo=HALO)
    n = xb.shape[-1]
    fn, params, n_pad = tts.build_sp_master(SR, n, xb.shape[1], mesh,
                                            batch=True, stats=True,
                                            halo=HALO)
    res = fn(np.pad(xb, ((0, 0), (0, 0), (0, n_pad - n))), params)
    stats = {k: res[k].cpu().numpy() for k in STATS}
    stats["stats_out"] = res["out"].cpu().numpy()[..., :n]
    return out, stats, fn, n_pad


def _one(xb, mesh):
    """The batch's first track through ``sp_master`` (the first dp row)."""
    from amw_tpu_torch.parallel import timeshard as tts

    return tts.sp_master(xb[0], SR, mesh, target_lufs=-14.0, halo=HALO)


def _worker(rank: int, port: int, out_dir: Path) -> None:
    torch.set_num_threads(1)
    from amw_tpu_torch.parallel import mesh as tmesh
    from amw_tpu_torch.parallel import timeshard as tts

    tmesh.init_distributed(f"127.0.0.1:{port}", RANKS, rank)
    report = {"rejoin": tmesh.init_distributed(f"127.0.0.1:{port}", RANKS,
                                               rank)}
    try:
        tmesh.init_distributed(f"127.0.0.1:{port}", RANKS + 1, rank)
        report["other_group"] = None
    except RuntimeError as e:
        report["other_group"] = str(e)
    try:
        tmesh.make_pod_mesh(sp=4, devices=["cpu"] * 2)
        report["sp4"] = None
    except ValueError as e:
        report["sp4"] = str(e)
    mesh = tmesh.make_pod_mesh(sp=2, devices=["cpu"] * 2)
    report["shape"] = mesh.shape
    report["process_index"] = mesh.process_index.tolist()
    report["devices"] = [[None if d is None else str(d) for d in row]
                         for row in mesh.devices]
    xb = _pair()
    try:
        tts.sp_batch_master(np.concatenate([xb, xb[:1]]), SR, mesh,
                            target_lufs=-14.0, halo=HALO)
        report["batch3"] = None
    except ValueError as e:
        report["batch3"] = str(e)
    out, stats, fn, n_pad = _master(xb, mesh)
    report["exchange"] = fn.last_exchange
    report["n_pad"] = n_pad
    one = _one(xb, mesh)
    np.savez(out_dir / f"rank{rank}.npz", out=out, one=one, **stats)
    (out_dir / f"rank{rank}.json").write_text(json.dumps(report))
    import torch.distributed as dist

    dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    """Both ranks' results, the single-process port's and JAX's, the
    references computed while the ranks run."""
    out_dir = tmp_path_factory.mktemp("pod")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT), os.environ.get("PYTHONPATH", "")]), OMP_NUM_THREADS="1")
    port = _free_port()
    procs = []
    for rank in range(RANKS):
        log = open(out_dir / f"rank{rank}.log", "w")
        procs.append((subprocess.Popen(
            [sys.executable, __file__, "worker", str(rank), str(port),
             str(out_dir)], cwd=ROOT, env=env, stdout=log,
            stderr=subprocess.STDOUT), log, time.monotonic()))
    try:
        n_threads = torch.get_num_threads()
        torch.set_num_threads(1)
        try:
            from amw_tpu.parallel import mesh as jmesh
            from amw_tpu.parallel import timeshard as jts
            from amw_tpu_torch.parallel import mesh as tmesh

            xb = _pair()
            mesh = tmesh.make_mesh2d(2, 2, devices=["cpu"] * 4)
            single, single_stats, _, _ = _master(xb, mesh)
            single_one = _one(xb, mesh)
            jax_out = np.asarray(jts.sp_batch_master(
                xb, SR, jmesh.make_mesh2d(2, 2), target_lufs=-14.0,
                halo=HALO))
        finally:
            torch.set_num_threads(n_threads)
        failed = []
        for rank, (p, _, t0) in enumerate(procs):
            left = max(RANK_TIMEOUT_S - (time.monotonic() - t0), 0.0)
            try:
                rc = p.wait(timeout=left)
            except subprocess.TimeoutExpired:
                rc = f"killed after {RANK_TIMEOUT_S} s"
            if rc != 0:
                failed.append((rank, rc))
    finally:
        for p, log, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    if failed:
        logs = "\n".join((out_dir / f"rank{r}.log").read_text()[-3000:]
                         for r, _ in failed)
        pytest.fail(f"ranks failed: {failed}\n{logs}")
    ranks = [(json.loads((out_dir / f"rank{r}.json").read_text()),
              dict(np.load(out_dir / f"rank{r}.npz")))
             for r in range(RANKS)]
    return {"ranks": ranks, "single": single, "single_stats": single_stats,
            "single_one": single_one, "jax": jax_out, "x": xb}


def test_pod_layout_puts_row_r_on_rank_r(pod):
    for rank, (rep, _) in enumerate(pod["ranks"]):
        assert rep["shape"] == {"dp": 2, "sp": 2}
        assert rep["process_index"] == [[0, 0], [1, 1]]
        assert rep["devices"] == [["cpu", "cpu"] if r == rank
                                  else [None, None] for r in range(2)]


def test_pod_batch_equals_the_single_process_port(pod):
    """Every rank returns the whole batch, bit for bit the single-process
    port's over the same grid, with and without the stats."""
    for rank, (rep, res) in enumerate(pod["ranks"]):
        assert res["out"].shape == pod["x"].shape
        assert np.array_equal(res["out"], pod["single"]), rank
        for k, want in pod["single_stats"].items():
            assert np.array_equal(res[k], want), (rank, k)
        # each of the 2 rows broadcast once: [1, 2, n_pad] outputs and
        # [4, 1] stats, float32
        ex = rep["exchange"]
        assert ex["bytes"] == 2 * 4 * (2 * rep["n_pad"] + 4)
        assert ex["ms"] > 0


def test_pod_sp_master_returns_the_first_row_on_every_rank(pod):
    """``sp_master`` on a pod mesh: rank 0 masters the track on the first
    dp row, and every rank returns it, bit for bit one process's."""
    for rank, (_, res) in enumerate(pod["ranks"]):
        assert np.array_equal(res["one"], pod["single_one"]), rank


def test_init_distributed_rejoins_and_refuses_another_group(pod):
    """A second join of the same group (a second engine in the process)
    keeps it; a join asking for another size raises."""
    for rep, _ in pod["ranks"]:
        assert rep["rejoin"] is True
        assert "world size 3" in rep["other_group"]


def test_pod_batch_matches_jax(pod):
    for rank, (_, res) in enumerate(pod["ranks"]):
        for i in range(2):
            err = float(np.max(np.abs(res["out"][i].astype(np.float64)
                                      - pod["jax"][i])))
            assert 20 * np.log10(max(err, 1e-12)) < -90.0, (rank, i)


def test_pod_refuses_a_straddling_row_on_every_rank(pod):
    for rep, _ in pod["ranks"]:
        assert rep["sp4"] is not None and "straddle" in rep["sp4"]


def test_pod_refuses_an_indivisible_batch_on_every_rank(pod):
    for rep, _ in pod["ranks"]:
        assert rep["batch3"] == "batch 3 not divisible by dp axis 2"


def _settings(monkeypatch, **values):
    from amw_tpu_torch.runtime import engine as tengine

    for k, v in values.items():
        monkeypatch.setattr(tengine.settings, k, v)


@pytest.mark.parametrize("coordinator,n,pid,args", [
    ("10.0.0.1:1234", 4, 2, ("10.0.0.1:1234", 4, 2)),
    ("auto", 0, -1, ("auto", None, None)),
    ("", 4, 2, None)], ids=["host_port", "auto", "unset"])
def test_engine_joins_the_pod_from_its_settings(monkeypatch, coordinator, n,
                                                pid, args):
    """``MasteringEngine`` joins with the JAX engine's arguments where
    ``engine_coordinator`` is set (0 processes and process id -1 read as
    unset), and joins nothing where it is not."""
    from amw_tpu_torch.parallel import mesh as tmesh
    from amw_tpu_torch.runtime.engine import MasteringEngine

    joined = []
    monkeypatch.setattr(tmesh, "init_distributed",
                        lambda *a: joined.append(a) or True)
    _settings(monkeypatch, engine_coordinator=coordinator,
              engine_num_processes=n, engine_process_id=pid)
    MasteringEngine(micro_batch=False, device="cpu")
    assert joined == ([args] if args else [])


def test_engine_raises_where_the_join_fails(monkeypatch):
    from amw_tpu_torch.parallel import mesh as tmesh
    from amw_tpu_torch.runtime.engine import MasteringEngine

    def refuse(*a):
        raise RuntimeError("rendezvous refused")

    monkeypatch.setattr(tmesh, "init_distributed", refuse)
    _settings(monkeypatch, engine_coordinator="127.0.0.1:1")
    with pytest.raises(RuntimeError, match="rendezvous refused"):
        MasteringEngine(micro_batch=False, device="cpu")


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    _worker(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
