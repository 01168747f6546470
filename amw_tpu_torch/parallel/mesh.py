"""Meshes of positions, and the helpers that place work on them
(counterpart of ``amw_tpu/parallel/mesh.py``).

The JAX package serves across the devices of one process: a
``jax.sharding.Mesh`` over the local devices, batches sharded over its
``dp`` axis and long tracks over its ``sp`` axis under ``shard_map``.  The
port keeps that model.  A :class:`Mesh` is an array of positions, each
holding the ``torch.device`` it runs on; the sharded paths
(``parallel/batch.py``, ``parallel/timeshard.py``,
``models/htdemucs.separate_mesh``) loop over the positions in one process,
move halos between neighbours by tensor copies and reduce over the
positions' tensors where the JAX code calls ``psum``/``pmax``.

A position is not a device identity: several positions may sit on one
device (four on ``cuda:0``, or all on ``cpu`` in the tests), and the
sharded path runs unchanged.  Params are placed once per distinct device
(:func:`replicate`).

A pod mesh spans the processes of a ``torch.distributed`` group
(:func:`init_distributed`, then :func:`make_pod_mesh` on every rank, as
every process of the JAX program builds the same mesh).  Each position
carries its process index (``Mesh.process_index``, the rank that owns
it); a rank holds a ``torch.device`` only at its own positions (``None``
at the others'), and :meth:`Mesh.distinct_devices` and :func:`replicate`
cover only those.  Every sp row lies within one process and dp spans
processes (:func:`pod_layout`), so the halos and reductions of the time
shard stay inside a process, and the only traffic between processes is
the job's: ``timeshard.sp_batch_master`` masters each rank's own rows and
gathers every row's output in row order, so that every rank returns the
whole batch.

That exchange runs on host tensors over gloo, and :func:`init_distributed`
joins a gloo group on every device type.  The pod moves only job I/O
between processes, and never a device collective, so NCCL would bring
nothing but its constraint of one device a rank: NCCL refuses two ranks
on one GPU, as a pod of positions on one card has (``chip_smoke.py``'s
``pod`` phase runs two ranks on ``cuda:0``).

The serving engine joins the group from its coordinator settings
(``runtime/engine.py``), and its serving mesh stays over the process's
own GPUs, as the JAX engine's (``local_only=True``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..convert import to_device


class Mesh:
    """A grid of positions: ``devices``, a numpy object array of
    ``torch.device`` (repeats allowed), with one name per axis.  In a pod
    mesh ``process_index`` gives each position's rank, and ``devices``
    holds ``None`` at the positions of other ranks; by default every
    position is this process's."""

    def __init__(self, devices, axis_names, process_index=None):
        arr = np.array(devices, dtype=object)
        devs = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            devs[idx] = None if arr[idx] is None else torch.device(arr[idx])
        self.axis_names = tuple(axis_names)
        if devs.ndim != len(self.axis_names):
            raise ValueError(f"{devs.ndim}-D devices for axes "
                             f"{self.axis_names}")
        self.devices = devs
        if process_index is None:
            process_index = np.full(devs.shape, _rank(), dtype=np.int64)
        self.process_index = np.asarray(process_index, dtype=np.int64)
        if self.process_index.shape != devs.shape:
            raise ValueError(f"process_index {self.process_index.shape} "
                             f"for positions {devs.shape}")

    @property
    def shape(self) -> dict:
        """Positions along each axis, by name (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def spans_processes(self) -> bool:
        """Whether positions belong to more than one process."""
        return len(np.unique(self.process_index)) > 1

    def distinct_devices(self) -> list:
        """The devices this process's positions sit on, each once, in
        position order."""
        seen: list = []
        for d in self.devices.flat:
            if d is not None and d not in seen:
                seen.append(d)
        return seen

    def __repr__(self):
        procs = (f", processes {sorted(set(self.process_index.flat))}"
                 if self.spans_processes else "")
        return f"Mesh({self.shape}, {self.distinct_devices()}{procs})"


def _rank() -> int:
    """This process's rank in the ``torch.distributed`` group, 0 outside
    one."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _group_size() -> int:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def _local_devices() -> list:
    """``cuda:0 .. k-1`` (``torch.cuda.device_count()``); raises without a
    GPU (``resolve_device``)."""
    resolve_device("cuda")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def _resolved(devices) -> list:
    out = [torch.device(d) for d in devices]
    for d in out:
        resolve_device(d)
    return out


def make_mesh(n_devices: int | None = None, axis: str = "dp",
              local_only: bool = False, *, devices=None) -> Mesh:
    """1-D mesh over ``devices`` (default: this process's GPUs), the first
    ``n_devices`` of them where given.  In one process every GPU is local,
    so ``local_only`` (the serving engine's layout in the JAX package)
    selects the same devices."""
    devs = _resolved(devices) if devices is not None else _local_devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs, (axis,))


def make_mesh2d(dp: int, sp: int, axes: tuple[str, str] = ("dp", "sp"), *,
                devices=None) -> Mesh:
    """2-D mesh for batched long-track mastering: the outer ``dp`` axis
    carries the batch (one track per row), the inner ``sp`` axis
    time-shards each track."""
    devs = _resolved(devices) if devices is not None else _local_devices()
    devs = devs[: dp * sp]
    if len(devs) < dp * sp:
        raise ValueError(f"need {dp * sp} devices, have {len(devs)}")
    return Mesh([devs[r * sp:(r + 1) * sp] for r in range(dp)], axes)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> bool:
    """Join a ``torch.distributed`` process group over gloo (the module
    docstring says why gloo on every device type).  With no coordinator
    and no process count configured (the single-host case, and most
    tests) this is a no-op returning False.  ``coordinator``: ``host:port``
    of process 0, or ``"auto"`` for the launcher's environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``).  Where
    this process already is in a group of that size and rank, it stays
    there; a group that differs, or a failed join, raises."""
    if coordinator is None and num_processes is None:
        return False
    import torch.distributed as dist

    if dist.is_initialized():
        want = {"world size": num_processes, "rank": process_id}
        have = {"world size": dist.get_world_size(), "rank": dist.get_rank()}
        for k, v in want.items():
            if v is not None and int(v) != have[k]:
                raise RuntimeError(f"already in a torch.distributed group "
                                   f"of {have}, asked for {k} {v}")
        return True
    kw = {"backend": "gloo"}
    if coordinator and coordinator != "auto":
        kw["init_method"] = f"tcp://{coordinator}"
    else:
        kw["init_method"] = "env://"
    if num_processes is not None:
        kw["world_size"] = int(num_processes)
    if process_id is not None:
        kw["rank"] = int(process_id)
    dist.init_process_group(**kw)
    return True


def pod_layout(devices, sp: int | None = None) -> np.ndarray:
    """Arrange a (possibly multi-host) device list into a (dp, sp) grid.

    Rule (docs/SCALING.md): **sp must stay on one host, dp may span
    hosts** — the halo exchange and gating reductions of the time-shard
    path stay within one host, while data-parallel rows never
    communicate.  So devices are grouped by ``process_index`` and each sp
    row is drawn from a single process; dp is the cross-host axis.

    ``sp=None`` picks the per-host device count (a whole host per row).
    Pure layout (takes any objects with ``process_index``; a
    ``torch.device`` counts as process 0)."""
    devices = list(devices)
    by_proc: dict[int, list] = {}
    for d in devices:
        by_proc.setdefault(int(getattr(d, "process_index", 0)), []).append(d)
    counts = {len(v) for v in by_proc.values()}
    if len(counts) != 1:
        raise ValueError(f"uneven devices per process: "
                         f"{ {k: len(v) for k, v in by_proc.items()} }")
    per_host = counts.pop()
    if sp is None:
        sp = per_host
    if per_host % sp:
        raise ValueError(f"sp={sp} does not divide the per-host device "
                         f"count {per_host}; an sp row would straddle hosts "
                         f"and put halo exchange between hosts")
    rows = []
    for pid in sorted(by_proc):
        host = by_proc[pid]
        for i in range(0, per_host, sp):
            rows.append(host[i:i + sp])
    grid = np.empty((len(rows), sp), dtype=object)
    for r, row in enumerate(rows):
        grid[r, :] = row
    return grid


class _Position:
    """A position of a pod before it is placed: its rank and device."""

    def __init__(self, process_index: int, device: str):
        self.process_index = process_index
        self.device = device


def make_pod_mesh(sp: int | None = None,
                  axes: tuple[str, str] = ("dp", "sp"), *,
                  devices=None) -> Mesh:
    """(dp, sp) mesh over every process's positions, each sp row within
    one process (:func:`pod_layout`); on one process
    ``make_mesh2d(n_local // sp, sp)``.  ``devices``: this process's
    positions (default: its GPUs).

    Inside a ``torch.distributed`` group of more than one process every
    rank calls it, as every process of the JAX program builds the mesh:
    the ranks' positions are gathered (one ``all_gather_object`` over the
    group, which must have a CPU backend such as :func:`init_distributed`'s
    gloo), then each rank lays out the same grid, holding devices only at
    its own positions.  A layout that :func:`pod_layout` refuses raises
    the same ``ValueError`` on every rank, after the gather."""
    devs = _resolved(devices) if devices is not None else _local_devices()
    if _group_size() == 1:
        return Mesh(pod_layout(devs, sp), axes)
    import torch.distributed as dist

    if "gloo" not in str(dist.get_backend()):
        raise ValueError(f"a pod mesh exchanges host tensors: the group's "
                         f"backend {dist.get_backend()!r} has no gloo "
                         f"(init_distributed joins one)")
    names: list = [None] * dist.get_world_size()
    dist.all_gather_object(names, [str(d) for d in devs])
    grid = pod_layout([_Position(p, d) for p, ds in enumerate(names)
                       for d in ds], sp)
    rank = dist.get_rank()
    return Mesh([[q.device if q.process_index == rank else None for q in row]
                 for row in grid], axes,
                process_index=[[q.process_index for q in row]
                               for row in grid])


def device_type(mesh: Mesh) -> str:
    """The one device type of this process's positions (graphs are planned
    per type: ``fft_staged.site_plan``); ``ValueError`` where they mix."""
    types = {d.type for d in mesh.distinct_devices()}
    if len(types) != 1:
        raise ValueError(f"mesh positions on more than one device type: "
                         f"{sorted(types)}")
    return types.pop()


def require_one_process(mesh: Mesh, what: str) -> None:
    """``ValueError`` for a path that runs every position in this process
    (``what``) on a mesh that spans processes."""
    if mesh.spans_processes:
        raise ValueError(f"{what} runs every position in one process; "
                         f"this mesh spans processes "
                         f"{sorted(set(mesh.process_index.flat))} (use "
                         f"timeshard.sp_batch_master on a pod mesh)")


def axis_devices(mesh: Mesh, axis: str | None = None) -> list:
    """The devices of the positions along ``axis`` (default the first),
    at index 0 of every other axis: where a batch sharded over that axis
    runs (the JAX package's ``P(axis)``, replicated over the others)."""
    require_one_process(mesh, "a batch over the positions of one axis")
    axis = mesh.axis_names[0] if axis is None else axis
    k = mesh.axis_names.index(axis)
    idx = [0] * mesh.devices.ndim
    out = []
    for i in range(mesh.devices.shape[k]):
        idx[k] = i
        out.append(mesh.devices[tuple(idx)])
    return out


def shard_batch(x, mesh: Mesh, axis: str | None = None) -> list:
    """A ``[B, ...]`` batch (tensor or numpy) split evenly over the
    positions of ``axis`` (default the first), each slice on its
    position's device.  ``B`` must divide by the axis' size."""
    devs = axis_devices(mesh, axis)
    B = x.shape[0]
    if B % len(devs):
        raise ValueError(f"batch {B} not divisible by the mesh axis of "
                         f"{len(devs)} positions")
    step = B // len(devs)
    out = []
    for i, d in enumerate(devs):
        part = x[i * step:(i + 1) * step]
        if not isinstance(part, torch.Tensor):
            part = torch.from_numpy(np.ascontiguousarray(part))
        out.append(part.to(d))
    return out


def replicate(params, mesh: Mesh) -> dict:
    """``params`` on every device of the mesh, one copy per distinct
    device (``convert.to_device``), by device."""
    return {d: to_device(params, d) for d in mesh.distinct_devices()}
