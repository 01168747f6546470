"""The traced run: whole steps under ``torch.profiler`` for a fixed time,
and what the per-layer readers read from it.

Two steps run under the profiler before the window opens, so that its
start-up lands outside.  The window is a ``record_function`` span
around the steps that follow, until the traffic's ``trace_s`` seconds
have passed; busy time is
the union of the device's operations (kernels, copies, sets) inside it,
both from one trace.  The port's kernels are told apart by name (the
``__global__`` functions of ``amw_tpu_torch/csrc``), cuFFT's by its
names, and everything else is PyTorch's.  The launches of the port's
kernels are recorded with their arguments (:class:`roofline.LaunchRecorder`).
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

from . import roofline

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CUFFT = re.compile(r"fft|radix", re.IGNORECASE)
NOT_PORT = ("at::", "c10::", "cub::", "thrust::", "cutlass::")
WARM_STEPS = 2


@dataclass
class Trace:
    """What a traced window holds, for the metric readers."""

    steps: int
    window_s: float
    device_ops: list = field(default_factory=list)  # (name, start, dur) s
    kernel_kind: dict = field(default_factory=dict)  # name -> port/cufft/torch
    host_ops: list = field(default_factory=list)    # (name, start, dur) s
    launches: list = field(default_factory=list)    # (entry, bytes, flops)
    bound_s: float | None = None

    def kernels(self, kind=None) -> list:
        return [o for o in self.device_ops if o[0] in self.kernel_kind
                and (kind is None or self.kernel_kind[o[0]] == kind)]

    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device."""
        spans = sorted((s, s + d) for _, s, d in self.device_ops)
        busy, end = 0.0, float("-inf")
        for a, b in spans:
            if b <= end:
                continue
            busy += b - max(a, end)
            end = b
        return busy

    def idle_gaps(self) -> list:
        """``(start, seconds)`` of every interval inside the window in
        which nothing ran on the device, longest first."""
        spans = sorted((s, s + d) for _, s, d in self.device_ops)
        gaps, end = [], 0.0
        for a, b in spans:
            if a > end:
                gaps.append((end, a - end))
            end = max(end, b)
        if self.window_s > end:
            gaps.append((end, self.window_s - end))
        return sorted(gaps, key=lambda g: -g[1])

    def host_at(self, t: float) -> str:
        """The innermost host operation running at ``t``."""
        best = None
        for name, s, d in self.host_ops:
            if s <= t <= s + d and (best is None or d < best[1]):
                best = (name, d)
        return best[0] if best else "python"


def kind_of(name: str, port_names: frozenset) -> str:
    """``port``, ``cufft`` or ``torch`` for a device kernel's name."""
    head = name[5:] if name.startswith("void ") else name
    head = head.replace("(anonymous namespace)::", "")
    head = re.split(r"[<(]", head, maxsplit=1)[0].strip()
    qual, _, ident = head.rpartition("::")
    if ident in port_names and not (qual + "::").startswith(NOT_PORT):
        return "port"
    if "at::" not in head and CUFFT.search(head):
        return "cufft"
    return "torch"


def parse(events: list, steps: int, port_names: frozenset) -> Trace:
    """A :class:`Trace` from a chrome trace's events (times in µs), the
    window being the ``portbench.window`` span."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") in ("user_annotation", "cpu_op")]
    if not win:
        raise RuntimeError("portbench: the trace holds no window span")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    tr = Trace(steps=steps, window_s=(w1 - w0) * 1e-6)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, d = float(e["ts"]), float(e["dur"])
        a, b = max(a, w0), min(a + d, w1)
        if b <= a:
            continue
        item = (e["name"], (a - w0) * 1e-6, (b - a) * 1e-6)
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            tr.device_ops.append(item)
            if cat == "kernel" and e["name"] not in tr.kernel_kind:
                tr.kernel_kind[e["name"]] = kind_of(e["name"], port_names)
        elif cat in ("cpu_op", "cuda_runtime", "cuda_driver",
                     "user_annotation", "python_function"):
            if e["name"] != WINDOW:
                tr.host_ops.append(item)
    return tr


def traced(step, seconds: float, csrc: Path) -> Trace:
    """Run ``step(i)`` under the profiler, :data:`WARM_STEPS` steps and then
    whole steps in the window until ``seconds`` have passed, and read the
    trace; ``Trace.steps`` counts the window's steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    on_card = torch.cuda.is_available()
    if on_card:
        acts.append(ProfilerActivity.CUDA)
    rec = roofline.LaunchRecorder()
    with profile(activities=acts) as prof:
        for i in range(WARM_STEPS):
            step(i)
        if on_card:
            torch.cuda.synchronize()
        with rec, record_function(WINDOW):
            n, t0 = 0, time.perf_counter()
            while True:
                step(WARM_STEPS + n)
                n += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            if on_card:
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    finally:
        os.unlink(path)
    tr = parse(events, n, roofline.kernel_names(csrc))
    tr.launches = rec.records
    tr.bound_s = rec.bound_s()
    return tr


def breakdown(tr: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    gaps by the host operation running at their start."""
    by_name: dict = {}
    for name, _, d in tr.device_ops:
        by_name[name] = by_name.get(name, 0.0) + d
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    gaps = [[tr.host_at(s), d] for s, d in tr.idle_gaps()[:top]]
    return {"device_ops": [[n[:160], s] for n, s in ops], "idle_gaps": gaps}
