"""Micro-batching job scheduler (counterpart of
``amw_tpu/runtime/batcher.py``).

The reference runs each mastering job on its own worker thread
(asyncio.to_thread + semaphores, SURVEY §2.4).  On the card, concurrent
jobs that resolve to the SAME graph (same sample rate, length bucket,
channel count, chain config) run as ONE batched call, so device
throughput matches the batched numbers instead of the single-track
latency.

``Batcher`` collects submissions per graph key for up to ``window_ms`` (or
until ``max_batch`` is reached), stacks them, runs the owner's batch
function once, and resolves each submitter's future (a copy of the JAX
package's class; it runs the batch under ``torch.inference_mode()``,
which is per thread in PyTorch and does not carry over from the
submitter, and keeps no reference to a batch once its futures are set,
so that its device memory goes with its last reader).
``BatchedChainRunner`` is the batcher over v2 chain configs; the engine
batches its v2 graphs through ``Batcher`` itself.
"""

from __future__ import annotations

import json
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from ..models.chain import compile_chain


@dataclass
class _Pending:
    x: np.ndarray
    aux: object = None  # per-item metadata stacked alongside x (e.g. n_valid)
    future: Future = field(default_factory=Future)


class Batcher:
    """Generic same-graph micro-batcher.

    ``run_batch(key, xb)`` must be provided by the owner: it executes the
    batch [B, ...] for ``key`` and returns a list/array of per-item results.
    It runs on the batcher's thread, where ``last_stack_s`` holds the
    seconds spent stacking that batch.
    """

    def __init__(self, run_batch, *, window_ms: float = 50.0,
                 max_batch: int = 8):
        self._run_batch = run_batch
        self.window = window_ms / 1000.0
        self.max_batch = max_batch
        self._lock = threading.Condition()
        self._queues: dict = {}
        self._thread = None
        self._stop = False
        self.last_stack_s = 0.0

    def start(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()

    def stop(self):
        with self._lock:
            self._stop = True
            self._lock.notify_all()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None
        self._stop = False

    def submit(self, key, x: np.ndarray, aux=None,
               max_batch: int | None = None) -> Future:
        """``max_batch``: per-key cap (e.g. memory-derived from the item
        size) — the effective cap is the min over submissions for the key
        and the batcher-wide max."""
        item = _Pending(x=x, aux=aux)
        with self._lock:
            self._queues.setdefault(key, {"items": [], "first_ts": None,
                                          "cap": None})
            q = self._queues[key]
            if max_batch is not None:
                q["cap"] = (max_batch if q.get("cap") is None
                            else min(q["cap"], max_batch))
            q["items"].append(item)
            if q["first_ts"] is None:
                q["first_ts"] = time.monotonic()
            self._lock.notify_all()
        return item.future

    def _take_ready(self):
        now = time.monotonic()
        ready = []
        next_deadline = None
        for key, q in self._queues.items():
            if not q["items"]:
                continue
            deadline = q["first_ts"] + self.window
            cap = min(self.max_batch, q.get("cap") or self.max_batch)
            if len(q["items"]) >= cap or now >= deadline:
                ready.append((key, q["items"][:cap]))
                q["items"] = q["items"][cap:]
                if not q["items"]:
                    # cap is per-group, not a lifetime minimum: once the
                    # backlog drains, future submissions re-establish it
                    # (a transient low cap must not pin the key forever).
                    q["cap"] = None
                q["first_ts"] = time.monotonic() if q["items"] else None
            else:
                next_deadline = (deadline if next_deadline is None
                                 else min(next_deadline, deadline))
        return ready, next_deadline

    def _loop(self):
        while True:
            with self._lock:
                ready, deadline = self._take_ready()
                if not ready:
                    if self._stop:
                        return
                    timeout = (max(0.0, deadline - time.monotonic())
                               if deadline is not None else 0.5)
                    self._lock.wait(timeout=timeout)
                    continue
            for key, items in ready:
                self._run_group(key, items)
            # hold no result (device memory) past its batch
            del ready, items

    def _run_group(self, key, items):
        try:
            t0 = time.perf_counter()
            xb = np.stack([it.x for it in items])
            self.last_stack_s = time.perf_counter() - t0
            with torch.inference_mode():
                if any(it.aux is not None for it in items):
                    auxb = np.stack([it.aux for it in items])
                    outs = self._run_batch(key, xb, auxb)
                else:
                    outs = self._run_batch(key, xb)
            for it, out in zip(items, outs):
                it.future.set_result(out)
        except Exception as e:  # noqa: BLE001
            for it in items:
                if not it.future.done():
                    it.future.set_exception(e)


class BatchedChainRunner:
    """Batcher specialization for v2 chain graphs.

    ``key`` = (spec, canonical config JSON); a batch ``[B, C, N]`` runs
    once through the key's chain (``models.chain.compile_chain``, cached
    per key and device, shared with single-track callers).  The JAX
    package pads a batch to a power of two to bound its XLA compiles;
    the port compiles nothing per batch size, so a batch runs at its own
    size.  Each row is the single-track chain's output on that row (bit
    for bit on the CPU; on the card within float32 rounding)."""

    def __init__(self, *, window_ms: float = 50.0, max_batch: int = 8,
                 device=None):
        self.device = resolve_device(device)
        self.batcher = Batcher(self._run, window_ms=window_ms,
                               max_batch=max_batch)
        self.batcher.start()

    def _run(self, key, xb: np.ndarray):
        spec, config_json = key
        chain = compile_chain(spec, json.loads(config_json),
                              device=self.device)
        x = torch.as_tensor(np.asarray(xb, np.float32), device=self.device)
        y = chain.fn(x, chain.params)
        return list(y.cpu().numpy())

    def master(self, spec, config_json: str, x: np.ndarray,
               timeout: float = 600.0) -> np.ndarray:
        """Blocking per-call API (runs on a worker thread): submit and wait."""
        fut = self.batcher.submit((spec, config_json), x)
        return fut.result(timeout=timeout)

    def close(self):
        self.batcher.stop()
