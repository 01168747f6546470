"""The port's serving engine on the card against its CPU path, on short
tracks: the v2 job (exact length and a 15 s bucket, the pro set), a burst
of three requests through the micro-batcher, the device-event stage ticks
in order, and the other entry points (v1, reference match, upscale, the
vocal separator's bytes).

GPU only (``cuda`` marker; every test skips without a card).  The file
imports no JAX, so it runs on a machine with the card and no JAX package:

    python -m pytest --noconftest -q tests/test_torch_engine_cuda.py

Bars: float32 WAV output within -90 dBFS of the CPU engine's and the
loudness before and after within 0.01 LU; dithered 16-bit output within
2.5/32768 (each side draws its own dither).
"""

import threading

import numpy as np
import pytest
import torch

from amw_tpu_torch.models import vocal
from amw_tpu_torch.runtime import progress
from amw_tpu_torch.runtime.engine import MasteringEngine
from amw_tpu_torch.utils import wav

SR = 44100
BAR_DBFS = -90.0
METER_LU = 0.01
WAV16_BAR = 2.5 / 32768
PRO = {"rumble_enabled": True, "deesser_enabled": True,
       "transient_attack": 1.3, "transient_sustain": 0.85,
       "parallel_mix": 0.25, "dynamic_eq_enabled": True}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def track(dur, seed=0, channels=2):
    g = np.random.default_rng(seed)
    n = int(SR * dur)
    t = np.arange(n) / SR
    x = (0.28 * np.sin(2 * np.pi * 110 * t)
         + 0.12 * np.sin(2 * np.pi * 997 * t)
         + 0.05 * g.standard_normal(n)).astype(np.float32)
    return np.clip(np.stack([x, 0.85 * x])[:channels], -0.99, 0.99)


def upload(x):
    return wav.write_wav_int16((x * 32767).astype(np.int16), SR)


def _db(a, b):
    return 20 * np.log10(max(float(np.max(np.abs(a - b))), 1e-30))


def _close(got, want, bar=BAR_DBFS, meters=True):
    a, sr = wav.read_wav(got["bytes"])
    b, _ = wav.read_wav(want["bytes"])
    assert sr == got["sr"] == want["sr"] and a.shape == b.shape
    if bar == WAV16_BAR:
        assert float(np.max(np.abs(a - b))) <= WAV16_BAR
    else:
        assert _db(a, b) <= bar
    if meters:
        for k in ("before_lufs", "after_lufs"):
            assert abs(got[k] - want[k]) <= METER_LU, k


@pytest.mark.cuda
@pytest.mark.parametrize("dur,pro", [(2.5, {}), (8.0, PRO)],
                         ids=["exact", "bucket_pro"])
def test_engine_v2_cuda_matches_cpu(cuda_device, dur, pro):
    data = upload(track(dur, seed=1))
    kw = dict(target_lufs=-14.0, out_format="wav32f", pro=pro)
    gpu = MasteringEngine(micro_batch=False)
    cpu = MasteringEngine(micro_batch=False, device="cpu")
    _close(gpu.master_v2_bytes(data, "t.wav", **kw),
           cpu.master_v2_bytes(data, "t.wav", **kw))
    # the dithered 16-bit export on the card
    kw["out_format"] = "wav"
    _close(gpu.master_v2_bytes(data, "t.wav", **kw),
           cpu.master_v2_bytes(data, "t.wav", **kw), bar=WAV16_BAR)


@pytest.mark.cuda
def test_engine_burst_of_three_batched(cuda_device):
    """Three concurrent requests in the 15 s bucket at different valid
    lengths: one batch of 3 (run as 4); request i gets track i back."""
    durs = (6.0, 8.0, 11.5)
    blobs = [upload(track(d, seed=10 + i)) for i, d in enumerate(durs)]
    kw = dict(target_lufs=-14.0, out_format="wav32f")
    eng = MasteringEngine(micro_batch=True)
    eng._batcher.window = 2.0  # the three decodes must land in one window
    got = [None] * 3
    barrier = threading.Barrier(3)

    def work(i):
        barrier.wait()
        got[i] = eng.master_v2_bytes(blobs[i], "t.wav", **kw)

    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(3)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
            assert not th.is_alive()
        assert eng.last_batch_info == {"batch": 3, "batch_compiled": 4,
                                       "devices": 1}
    finally:
        eng.close()
    cpu = MasteringEngine(micro_batch=False, device="cpu")
    for i, d in enumerate(durs):
        assert wav.read_wav(got[i]["bytes"])[0].shape == (2, int(d * SR))
        _close(got[i], cpu.master_v2_bytes(blobs[i], "t.wav", **kw))


@pytest.mark.cuda
def test_engine_device_ticks_in_order(cuda_device, monkeypatch):
    """Without the batcher, each stage's tick comes after the event
    recorded behind that stage has completed, in stage order."""
    marks = {}
    late = []
    stage_done, emit = progress.stage_done, progress.emit_stage_tick

    def recorded_stage_done(tok, idx, device):
        # recorded just before the stage's own event, at the same point of
        # the stream: it has completed once that one has
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        marks[(int(tok), int(idx))] = ev
        stage_done(tok, idx, device)

    def checked_emit(tok, idx):
        ev = marks.get((int(tok), int(idx)))
        if ev is None or not ev.query():
            late.append(int(idx))
        emit(tok, idx)

    monkeypatch.setattr(progress, "stage_done", recorded_stage_done)
    monkeypatch.setattr(progress, "emit_stage_tick", checked_emit)
    events = []
    eng = MasteringEngine(micro_batch=False)
    eng.master_v2_bytes(upload(track(8.0, seed=2)), "t.wav",
                        target_lufs=-14.0, pro=PRO,
                        progress=lambda p, m: events.append((p, m)))
    labels = [m for _, m in events if m.startswith("Mastering: ")]
    assert len(set(labels)) >= 8, labels
    assert [p for p, _ in events] == sorted(p for p, _ in events)
    assert not late, late
    assert len(marks) == len(labels)


@pytest.mark.cuda
def test_engine_tools_cuda_match_cpu(cuda_device, monkeypatch):
    monkeypatch.delenv("AMW_HTDEMUCS_CKPT", raising=False)
    gpu = MasteringEngine(micro_batch=False)
    cpu = MasteringEngine(micro_batch=False, device="cpu")
    data = upload(track(8.0, seed=3))
    kw = dict(target_lufs=-14.0, out_format="wav32f")
    _close(gpu.master_v1_bytes(data, "t.wav", **kw),
           cpu.master_v1_bytes(data, "t.wav", **kw))
    ref = upload(track(6.0, seed=4))
    kw = dict(strength=0.8, out_format="wav32f")
    _close(gpu.reference_match_bytes(data, "s.wav", ref, "r.wav", **kw),
           cpu.reference_match_bytes(data, "s.wav", ref, "r.wav", **kw),
           meters=False)
    _close(gpu.upscale_bytes(data, "t.wav", target_sr=48000),
           cpu.upscale_bytes(data, "t.wav", target_sr=48000),
           bar=WAV16_BAR, meters=False)
    a, _ = wav.read_wav(vocal.isolate_vocal_bytes(data, "t.wav"))
    b, _ = wav.read_wav(vocal.isolate_vocal_bytes(data, "t.wav",
                                                  device="cpu"))
    assert a.shape == b.shape and _db(a, b) <= BAR_DBFS
