"""Meshes of positions, and the helpers that place work on them
(counterpart of ``amw_tpu/parallel/mesh.py``).

The JAX package serves across the devices of one process: a
``jax.sharding.Mesh`` over the local devices, batches sharded over its
``dp`` axis and long tracks over its ``sp`` axis under ``shard_map``.  The
port keeps that single-process model.  A :class:`Mesh` is an array of
positions, each holding the ``torch.device`` it runs on; the sharded paths
(``parallel/batch.py``, ``parallel/timeshard.py``,
``models/htdemucs.separate_mesh``) loop over the positions in one process,
move halos between neighbours by tensor copies and reduce over the
positions' tensors where the JAX code calls ``psum``/``pmax``.

A position is not a device identity: several positions may sit on one
device (four on ``cuda:0``, or all on ``cpu`` in the tests), and the
sharded path runs unchanged.  Params are placed once per distinct device
(:func:`replicate`).

``torch.distributed`` has one place only, :func:`init_distributed`, a
helper for a pod mesh across processes (not ported, see
:func:`make_pod_mesh`) that no serving code calls: CUDA devices show
without a process group, and the serving mesh stays over the process's
own devices, as the JAX engine's (``local_only=True``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..convert import to_device


class Mesh:
    """A grid of positions: ``devices``, a numpy object array of
    ``torch.device`` (repeats allowed), with one name per axis."""

    def __init__(self, devices, axis_names):
        arr = np.array(devices, dtype=object)
        devs = np.empty(arr.shape, dtype=object)
        for idx in np.ndindex(arr.shape):
            devs[idx] = torch.device(arr[idx])
        self.axis_names = tuple(axis_names)
        if devs.ndim != len(self.axis_names):
            raise ValueError(f"{devs.ndim}-D devices for axes "
                             f"{self.axis_names}")
        self.devices = devs

    @property
    def shape(self) -> dict:
        """Positions along each axis, by name (``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.devices.shape))

    def distinct_devices(self) -> list:
        """The devices the positions sit on, each once, in position order."""
        seen: list = []
        for d in self.devices.flat:
            if d not in seen:
                seen.append(d)
        return seen

    def __repr__(self):
        return f"Mesh({self.shape}, {self.distinct_devices()})"


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
    """Join a ``torch.distributed`` process group (NCCL where CUDA is
    available, else gloo).  With no coordinator and no process count
    configured (the single-host case, and all tests) this is a no-op
    returning False.  ``coordinator``: ``host:port`` of process 0, or
    ``"auto"`` for the launcher's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``)."""
    if coordinator is None and num_processes is None:
        return False
    import torch.distributed as dist

    kw = {"backend": "nccl" if torch.cuda.is_available() else "gloo"}
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


def make_pod_mesh(sp: int | None = None,
                  axes: tuple[str, str] = ("dp", "sp"), *,
                  devices=None) -> Mesh:
    """(dp, sp) mesh over this process's devices, which on one host is
    ``make_mesh2d(n_local // sp, sp)``.  A pod mesh across the processes of
    a ``torch.distributed`` group needs every rank to run the same
    program, which the port's single-process mesh does not do: it raises
    ``NotImplementedError`` there."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        raise NotImplementedError(
            "a pod mesh across the processes of a torch.distributed group "
            "is not ported (amw_tpu/parallel/mesh.py, make_pod_mesh; see "
            "ROADMAP.md): the port's meshes are over one process's devices")
    devs = _resolved(devices) if devices is not None else _local_devices()
    return Mesh(pod_layout(devs, sp), axes)


def device_type(mesh: Mesh) -> str:
    """The one device type of the mesh's positions (graphs are planned per
    type: ``fft_staged.site_plan``); ``ValueError`` where they mix."""
    types = {d.type for d in mesh.devices.flat}
    if len(types) != 1:
        raise ValueError(f"mesh positions on more than one device type: "
                         f"{sorted(types)}")
    return types.pop()


def axis_devices(mesh: Mesh, axis: str | None = None) -> list:
    """The devices of the positions along ``axis`` (default the first),
    at index 0 of every other axis: where a batch sharded over that axis
    runs (the JAX package's ``P(axis)``, replicated over the others)."""
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
