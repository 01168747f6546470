"""Per-stage progress of the mastering graphs (counterpart of
``amw_tpu/runtime/progress.py``).

The reference reports ~17 stage updates per job from its Python stage loop
(backend/app/pipeline.py:1834-1907 → SSE at routers/mastering.py:1472).
The port's graphs are Python stage loops too, but on the card a stage's
ops are only enqueued when the host passes it.  Stage completion is
surfaced in one of two ways, as in the JAX package:

- **Device ticks**: a graph given a job's token calls
  :func:`stage_done` after each stage.  On the card that records a
  ``torch.cuda.Event`` on the current stream under the job's token, and one
  poller thread per job emits :func:`emit_stage_tick` when the event's
  ``query()`` turns true: the ticks report device completion, not host
  enqueue (the counterpart of ``jax.debug.callback``).  On the CPU a stage
  has finished when the host passes it, so the tick is emitted there.
- **Timed interpolation** (:class:`TimedTicker`): where one graph call
  serves several jobs (the micro-batcher), the engine maps elapsed time
  onto the stage list against an EMA of the graph's wall time.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

_registry: dict = {}
_reg_lock = threading.Lock()
_tokens = itertools.count(1)
# how long the poller sleeps between queries of a pending event
_POLL_SEC = 0.0005


def callbacks_supported() -> bool:
    """Device ticks work on every device the port runs on."""
    return True


def register(names, report) -> int:
    """Register a job's stage list + report callback; returns the token to
    pass into the graph."""
    tok = next(_tokens)
    with _reg_lock:
        _registry[tok] = {"names": list(names), "report": report, "last": -1,
                          "events": [], "poller": None, "stop": False,
                          "cond": threading.Condition()}
    return tok


def unregister(tok: int) -> None:
    """Drop the job: its poller first emits every tick whose event has
    completed, then stops.  Call after the graph's results reached the
    host, so that every stage's event has completed."""
    with _reg_lock:
        entry = _registry.get(tok)
    if entry is not None and entry["poller"] is not None:
        with entry["cond"]:
            entry["stop"] = True
            entry["cond"].notify_all()
        entry["poller"].join(timeout=5.0)
    with _reg_lock:
        _registry.pop(tok, None)


def emit_stage_tick(tok, idx) -> None:
    """Report stage ``idx`` of job ``tok`` as done (possibly out of order:
    progress is monotonic via ``last``)."""
    try:
        entry = _registry.get(int(tok))
        if entry is None:
            return
        i = int(idx)
        if i <= entry["last"]:
            return
        entry["last"] = i
        names = entry["names"]
        pct = 5 + int(90 * (i + 1) / max(len(names), 1))
        label = names[i] if i < len(names) else f"stage {i}"
        entry["report"](min(pct, 97), f"Mastering: {label}")
    except Exception:  # noqa: BLE001 — progress must never break a job
        pass


def stage_done(tok, idx: int, device: torch.device) -> None:
    """Called by a graph after stage ``idx`` of job ``tok`` on ``device``:
    on the CPU the tick is emitted now; on the card an event is recorded on
    the current stream and the job's poller emits the tick once it has
    completed."""
    if device.type != "cuda":
        emit_stage_tick(tok, idx)
        return
    with _reg_lock:
        entry = _registry.get(int(tok))
    if entry is None:
        return
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    with entry["cond"]:
        entry["events"].append((ev, int(idx)))
        if entry["poller"] is None:
            entry["poller"] = threading.Thread(
                target=_poll, args=(int(tok), entry), daemon=True)
            entry["poller"].start()
        entry["cond"].notify_all()


def _poll(tok: int, entry: dict) -> None:
    """Emit each recorded stage's tick, in order, once its event has
    completed; return when the job is unregistered and nothing completed
    is left."""
    while True:
        with entry["cond"]:
            while not entry["events"] and not entry["stop"]:
                entry["cond"].wait()
            if not entry["events"]:
                return
            ev, idx = entry["events"][0]
        if ev.query():
            with entry["cond"]:
                entry["events"].pop(0)
            emit_stage_tick(tok, idx)
        elif entry["stop"]:
            return  # unregistered before the device got there
        else:
            time.sleep(_POLL_SEC)


class TimedTicker:
    """Elapsed-time → stage-list interpolation where one graph call serves
    several jobs.  ``expected_sec`` comes from the engine's per-graph EMA;
    with no history the ticker stays quiet (the coarse 5/98% updates
    remain)."""

    def __init__(self, names, report, expected_sec: float | None,
                 interval: float = 0.15):
        self.names = list(names)
        self.report = report
        self.expected = expected_sec
        self.interval = interval
        self._stop = threading.Event()
        self._thread = None

    def __enter__(self):
        if self.expected and self.expected > 0.2 and self.names:
            self._thread = threading.Thread(target=self._run, daemon=True)
            self._t0 = time.monotonic()
            self._thread.start()
        return self

    def _run(self):
        last = -1
        while not self._stop.wait(self.interval):
            frac = min((time.monotonic() - self._t0) / self.expected, 0.97)
            i = min(int(frac * len(self.names)), len(self.names) - 1)
            # Emit every stage passed since the previous tick, not just the
            # current position: a starved ticker thread (loaded host) would
            # otherwise skip labels and SSE clients would see the stage list
            # jump s2 -> s7.
            for j in range(last + 1, i + 1):
                pct = 5 + int(90 * (j + 1) / len(self.names))
                self.report(min(pct, 97), f"Mastering: {self.names[j]} (est)")
            last = max(last, i)

    def __exit__(self, *exc):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)
        return False
