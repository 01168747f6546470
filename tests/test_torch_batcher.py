"""The port's micro-batcher and stage progress
(``amw_tpu_torch/runtime/batcher.py``, ``progress.py``), on the CPU: the
JAX package's generic ``Batcher`` tests (tests/test_batcher.py) on the
port's class, a stress test of its queues, and the progress registry and
ticker as tests/test_progress.py checks the JAX package's.
"""

import re
import sys
import threading
import time

import numpy as np
import pytest
import torch

from amw_tpu_torch.runtime import progress as prog_mod
from amw_tpu_torch.runtime.batcher import Batcher


def _coalesce():
    calls = []

    def run_batch(key, xb):
        calls.append((key, xb.shape[0]))
        return [x * 2 for x in xb]

    b = Batcher(run_batch, window_ms=80.0, max_batch=4)
    b.start()
    try:
        futs = [b.submit("k", np.full((3,), i, np.float32)) for i in range(3)]
        outs = [f.result(timeout=5) for f in futs]
        for i, o in enumerate(outs):
            assert np.allclose(o, 2 * i)
        # all three coalesced into one batch call
        assert calls == [("k", 3)]
        # max_batch reached fires immediately (4 quick submissions)
        t0 = time.monotonic()
        futs = [b.submit("k2", np.zeros(3, np.float32)) for _ in range(4)]
        [f.result(timeout=5) for f in futs]
        assert time.monotonic() - t0 < 1.0
        assert ("k2", 4) in calls
    finally:
        b.stop()


def _errors():
    def run_batch(key, xb):
        raise RuntimeError("boom")

    b = Batcher(run_batch, window_ms=10.0)
    b.start()
    try:
        futs = [b.submit("k", np.zeros(2, np.float32)) for _ in range(3)]
        for fut in futs:  # every request of the failed batch gets the error
            with pytest.raises(RuntimeError, match="boom"):
                fut.result(timeout=5)
    finally:
        b.stop()


def _per_key_cap():
    """A memory-derived per-key max_batch caps group size below the global
    max (long buckets must not batch 8 tracks)."""
    seen = []

    def run(key, xb, aux=None):
        seen.append(xb.shape[0])
        return [x for x in xb]

    b = Batcher(run, window_ms=30.0, max_batch=8)
    b.start()
    try:
        futs = [b.submit("k", np.full((4,), i, np.float32), max_batch=2)
                for i in range(6)]
        for f in futs:
            f.result(timeout=10.0)
    finally:
        b.stop()
    assert seen and max(seen) <= 2, seen
    assert sum(seen) == 6


@pytest.mark.parametrize("case", ["coalesce", "errors", "per_key_cap"])
def test_batcher(case):
    {"coalesce": _coalesce, "errors": _errors,
     "per_key_cap": _per_key_cap}[case]()


def test_batcher_stress_keeps_every_item():
    """32 submitting threads, 3 keys, a short switch interval: every future
    gets its own item back (with its aux), and the batches add up to every
    submission."""
    sizes = []
    lock = threading.Lock()

    def run(key, xb, auxb):
        with lock:
            sizes.append(xb.shape[0])
        return [(x[0], a) for x, a in zip(xb, auxb)]

    b = Batcher(run, window_ms=2.0, max_batch=5)
    b.start()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    results = {}
    try:
        def work(t):
            for j in range(20):
                v = t * 100 + j
                fut = b.submit(f"k{v % 3}", np.full(2, v, np.float32),
                               aux=np.int32(-v))
                results[v] = fut.result(timeout=30)

        threads = [threading.Thread(target=work, args=(t,)) for t in range(32)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
            assert not th.is_alive()
    finally:
        sys.setswitchinterval(old)
        b.stop()
    assert len(results) == 640 and sum(sizes) == 640 and max(sizes) <= 5
    assert all(x == v and a == -v for v, (x, a) in results.items())


def test_callbacks_supported():
    assert prog_mod.callbacks_supported() is True


def test_registry_tick_ordering():
    events = []
    tok = prog_mod.register(["a", "b", "c"], lambda p, m: events.append((p, m)))
    prog_mod.emit_stage_tick(tok, 1)
    prog_mod.emit_stage_tick(tok, 0)  # out-of-order: must be ignored
    prog_mod.stage_done(tok, 2, torch.device("cpu"))  # emitted at once
    prog_mod.unregister(tok)
    prog_mod.emit_stage_tick(tok, 2)  # after unregister: no-op
    assert [m for _, m in events] == ["Mastering: b", "Mastering: c"]


def test_timed_ticker_interpolates():
    events = []
    names = [f"s{i}" for i in range(10)]
    with prog_mod.TimedTicker(names, lambda p, m: events.append((p, m)),
                              expected_sec=0.6, interval=0.05):
        # Gate on observed ticks, not elapsed wall time: under CI load the
        # ticker thread may fire late, but each tick emits every stage it
        # passed, so one late tick is enough to catch the labels up.
        deadline = time.monotonic() + 6.0
        while (len({m for _, m in events}) < 5
               and time.monotonic() < deadline):
            time.sleep(0.05)
    labels = {m for _, m in events}
    assert len(labels) >= 5
    assert all("(est)" in m for m in labels)
    idx = [int(re.search(r": s(\d+) ", m).group(1)) for _, m in events]
    assert idx == sorted(idx)
    assert idx == list(range(min(idx), max(idx) + 1))


class _FakeEvent:
    """Stands for ``torch.cuda.Event``: completes when the test says so."""
    made = []

    def __init__(self):
        self.done = threading.Event()
        _FakeEvent.made.append(self)

    def record(self, stream):
        pass

    def query(self):
        return self.done.is_set()


def test_device_ticks_wait_for_their_events(monkeypatch):
    """On the card a stage's tick is emitted by the job's poller once the
    event recorded after that stage has completed, in stage order; the
    CUDA calls are replaced by fakes here."""
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: None)
    _FakeEvent.made.clear()
    events = []
    tok = prog_mod.register(["a", "b", "c"], lambda p, m: events.append(m))
    cuda = torch.device("cuda")
    for i in range(3):
        prog_mod.stage_done(tok, i, cuda)
    time.sleep(0.05)
    assert events == []  # nothing completed yet
    _FakeEvent.made[0].done.set()
    deadline = time.monotonic() + 5.0
    while len(events) < 1 and time.monotonic() < deadline:
        time.sleep(0.005)
    _FakeEvent.made[2].done.set()  # c completes; b has not
    time.sleep(0.05)
    assert events == ["Mastering: a"]
    _FakeEvent.made[1].done.set()
    prog_mod.unregister(tok)  # drains what completed, stops the poller
    assert events == ["Mastering: a", "Mastering: b", "Mastering: c"]
