#!/usr/bin/env python
"""Train the htdemucs separator on the card.

    python -m amw_tpu_torch.scripts.train_htdemucs out.npz [steps]
        [--channels 16] [--bottom 48] [--batch 16] [--lr 3e-4] [--seed 0]
        [--vocal-weight 1.0] [--init PATH] [--device cpu]
        [--profile-steps N]

The port's counterpart of the JAX package's
``scripts/train_htdemucs_tpu.py``: the same corpus, schedule, optimiser
and loss, on the port's own network (``models/htdemucs.py``), whose
autograd carries the gradients where the JAX trainer takes
``jax.value_and_grad`` of the forward that serves.

- **The corpus**: half the synthetic four-stem recipe of
  ``htdemucs_gate.synth_batch``, half the rich family below, then per-stem
  EQ tilts, exponential-tail noise reverbs, gain, polarity and channel
  jitter, a remix across the batch and stem dropout (``augmented_batch``,
  the JAX script's bit for bit; ``AMW_TRAIN_RICH_FRAC``,
  ``AMW_TRAIN_REVERB_P``, ``AMW_TRAIN_REMIX_P`` and ``AMW_TRAIN_DROP_P``
  read at each call).  A producer thread keeps a queue of 4 batches, so
  the host's synthesis overlaps the device's step.
- **The step**: f32 forward (TF32 off: ``htdemucs._full_f32``), the
  stem-weighted L1 (the vocals' weight normalised by the mean), backward,
  optax's Adam (:class:`Adam`, at its defaults) under optax's
  warmup-cosine schedule (:func:`warmup_cosine_decay`, evaluated at the
  update count, so the first update has lr 0).  Eager: no compile, no
  CUDA graph.
- **The probe**: the vocal SNR on 4 generator-independent segments
  (``gen_sep_eval.synth_batch_heldout`` at seed 31337) every 500 steps
  and at the last; the best step's weights are the ones kept, evaluated
  on both corpora and written as the port's ``.npz`` (``save_params``
  with the config): the file that ``models/vocal`` serves
  (``AMW_HTDEMUCS_CKPT`` or the ``htdemucs_checkpoint`` setting).

``--init`` warm-starts from the port's ``.npz`` or from the JAX trainer's
``.th`` container (its ``state``); the optimiser restarts.  Runs on
``cuda`` unless ``--device`` says otherwise, and raises without a GPU.
``--profile-steps N`` profiles steps 10 .. 10 + N (torch.profiler's
device events, on the card): the device's busy time and idle share,
kernels a step.  The peak memory is the run's above what the process
held at its start.
:func:`main` fills ``report``, where given, with what it measured.
"""

from __future__ import annotations

import argparse
import math
import os
import queue
import threading
import time

import numpy as np
import torch

from amw_tpu_torch import resolve_device
from amw_tpu_torch.models import htdemucs
from amw_tpu_torch.scripts import gen_sep_eval
from amw_tpu_torch.scripts.htdemucs_gate import synth_batch

PROBE_SEED = 31337
PROBE_EVERY = 500
SAME_SEED, SAME_BATCH = 987654, 16
HELD_SEED, HELD_BATCH = 424242, 8
QUEUE_DEPTH = 4
PROFILE_START = 10

# --- the augmented corpus (scripts/train_htdemucs_tpu.py:50-271) ------------


def _fft_tilt(x, sr, rng):
    """Random smooth EQ tilt/shelf (zero-phase, per stem)."""
    n = x.shape[-1]
    f = np.fft.rfftfreq(n, 1.0 / sr)
    tilt_db = rng.uniform(-6, 6)  # dB across the band
    H = 10.0 ** (tilt_db / 20.0 * (f / (f[-1] + 1e-9) - 0.5))
    if rng.random() < 0.3:  # occasional resonant bump/notch
        fc = rng.uniform(200, 0.4 * sr)
        g = rng.uniform(-8, 8)
        H *= 10.0 ** (g / 20.0 / (1.0 + ((f - fc) / (0.2 * fc)) ** 2))
    return np.fft.irfft(np.fft.rfft(x, axis=-1) * H, n=n, axis=-1)


def _noise_reverb(x, sr, rng):
    """Exponential-tail noise IR (different family from the eval room)."""
    n = x.shape[-1]
    L = int(sr * rng.uniform(0.05, 0.25))
    ir = rng.standard_normal(L) * np.exp(-np.arange(L) / (sr * rng.uniform(
        0.01, 0.06)))
    ir /= max(np.max(np.abs(np.cumsum(ir ** 2))) ** 0.5, 1e-9)
    wet = rng.uniform(0.05, 0.3)
    X = np.fft.rfft(x, n=n + L, axis=-1)
    Hr = np.fft.rfft(ir, n=n + L)
    y = np.fft.irfft(X * Hr, n=n + L, axis=-1)[..., :n]
    return x + wet * y


def _melody_f0(rng, n, sr, lo, hi, rate=(1.0, 4.0), porta=0.02):
    """Piecewise-note f0 contour with portamento, [n]."""
    n_notes = max(1, int(round(n / sr * rng.uniform(*rate))))
    notes = lo * (hi / lo) ** rng.random(n_notes)
    f0 = np.repeat(notes, n // n_notes + 1)[:n]
    k = max(3, int(porta * sr) | 1)
    return np.convolve(np.pad(f0, (k // 2, k // 2), mode="edge"),
                       np.ones(k) / k, mode="valid")[:n]


def _bp_fft(x, sr, f0, q):
    """Cheap zero-phase resonant bump (vectorized, last axis)."""
    n = x.shape[-1]
    f = np.fft.rfftfreq(n, 1.0 / sr)
    H = 1.0 / (1.0 + ((f - f0) / (f0 / q / 2 + 1e-9)) ** 2)
    return np.fft.irfft(np.fft.rfft(x, axis=-1) * H, n=n, axis=-1)


def _rich_vocal(rng, n, sr):
    """Wide vocal family: random-rolloff harmonic stack / saw-ish / pulse-ish
    source on a melody contour, random resonant bumps, syllabic or segment
    AM.  (Deliberately NOT the eval corpus's formant-vowel recipe.)"""
    f0 = _melody_f0(rng, n, sr, 120, 420)
    t = np.arange(n) / sr
    f0 = f0 * (1.0 + 0.01 * rng.uniform(0, 1)
               * np.sin(2 * np.pi * rng.uniform(4.5, 6.5) * t))
    phase = 2 * np.pi * np.cumsum(f0) / sr
    kind = rng.integers(0, 3)
    nh = int(rng.integers(4, 11))
    h = np.arange(1, nh + 1)
    if kind == 0:      # random rolloff stack
        w = rng.uniform(0.2, 1.0, nh) / h ** rng.uniform(0.3, 1.2)
    elif kind == 1:    # saw-ish
        w = 1.0 / h
    else:              # pulse-ish (odd harmonics)
        w = np.where(h % 2 == 1, 1.0 / h, 0.02)
    v = (np.sin(phase[None, :] * h[:, None]
                + rng.uniform(0, 6, (nh, 1))) * w[:, None]).sum(axis=0)
    for _ in range(int(rng.integers(1, 4))):   # random resonances
        v = 0.6 * v + _bp_fft(v, sr, rng.uniform(300, 3200),
                              rng.uniform(2, 6)) * rng.uniform(0.8, 2.0)
    if rng.random() < 0.7:  # syllabic AM
        am = np.clip(np.sin(2 * np.pi * rng.uniform(1.5, 4.5) * t
                            + rng.uniform(0, 6)), 0, 1) ** rng.uniform(0.4, 1)
        v *= am
    if rng.random() < 0.4:  # breath noise at onsets
        g = rng.standard_normal(n) * 0.05
        v += _bp_fft(g, sr, rng.uniform(1500, 3500), 1.5)
    v /= max(np.max(np.abs(v)), 1e-9)
    return v * rng.uniform(0.15, 0.4)


def _rich_drums(rng, n, sr):
    d = np.zeros(n)
    if rng.random() < 0.6:  # tempo grid
        beat = int(sr * 60.0 / rng.uniform(80, 160))
        kicks = list(range(0, n, beat))
        snares = list(range(beat, n, 2 * beat)) if rng.random() < 0.8 else []
        hats = list(range(beat // 2, n, beat)) if rng.random() < 0.7 else []
    else:                   # random hits
        kicks = list(rng.integers(0, max(n - 800, 1),
                                  rng.integers(2, 7)))
        snares = list(rng.integers(0, max(n - 800, 1),
                                   rng.integers(0, 5)))
        hats = []
    for p in kicks:         # pitch-swept sine kick OR noise thump
        L = min(int(rng.uniform(0.05, 0.12) * sr), n - p)
        if L < 8:
            continue
        tt = np.arange(L) / sr
        if rng.random() < 0.7:
            f = rng.uniform(90, 160) * np.exp(-tt / 0.045) + rng.uniform(
                35, 55)
            hit = np.sin(2 * np.pi * np.cumsum(f) / sr)
        else:
            hit = rng.standard_normal(L)
        d[p:p + L] += hit * np.exp(-tt / rng.uniform(0.02, 0.08)) \
            * rng.uniform(0.4, 0.8)
    for p in snares:
        L = min(int(0.08 * sr), n - p)
        if L < 8:
            continue
        sn = rng.standard_normal(L) * np.exp(
            -np.arange(L) / (rng.uniform(0.01, 0.03) * sr))
        d[p:p + L] += _bp_fft(sn, sr, rng.uniform(1200, 2500), 1.0) * 2.0
    for p in hats:
        L = min(int(0.02 * sr), n - p)
        if L < 8:
            continue
        h = rng.standard_normal(L) * np.exp(-np.arange(L) / (0.005 * sr))
        H = np.fft.rfft(h)
        f = np.fft.rfftfreq(L, 1.0 / sr)
        d[p:p + L] += np.fft.irfft(H * (f > rng.uniform(2000, 3200)),
                                   n=L) * 1.2
    return d


def _rich_bass(rng, n, sr):
    f0 = _melody_f0(rng, n, sr, 35, 110, rate=(0.8, 2.5))
    t = np.arange(n) / sr
    phase = 2 * np.pi * np.cumsum(f0) / sr
    kind = rng.integers(0, 3)
    if kind == 0:    # pure-ish sine + octave
        b = np.sin(phase) + rng.uniform(0, 0.4) * np.sin(2 * phase)
    elif kind == 1:  # phase-modulated (FM-ish)
        ratio = float(rng.choice([1.5, 2.0, 3.0]))
        idx = rng.uniform(0.5, 3.0) * np.exp(-(
            (t * rng.uniform(1.5, 4.0)) % 1.0) / 0.3)
        b = np.sin(phase + idx * np.sin(ratio * phase))
    else:            # lowpassed saw stack
        h = np.arange(1, 7)
        b = (np.sin(phase[None, :] * h[:, None]) / h[:, None]).sum(axis=0)
    env = 0.6 + 0.4 * np.sin(2 * np.pi * rng.uniform(0.3, 2.0) * t
                             + rng.uniform(0, 6))
    return b * env * rng.uniform(0.2, 0.5)


def _rich_other(rng, n, sr):
    kind = rng.integers(0, 3)
    t = np.arange(n) / sr
    if kind == 0:    # sine-pad chord
        freqs = 220.0 * 2 ** (rng.integers(-5, 13, 3) / 12.0)
        y = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 6))
                for f in freqs)
    elif kind == 1:  # damped inharmonic "pluck" stack (vectorized KS-ish)
        f0 = 220.0 * 2 ** (rng.integers(-5, 10) / 12.0)
        h = np.arange(1, 9)
        detune = 1.0 + 0.0004 * h ** 2
        tau = rng.uniform(0.2, 0.8) / h
        hit = max(1, int(sr * rng.uniform(0.4, 0.9)))
        y = np.zeros(n)
        for p in range(0, n, hit):
            tt = t[: n - p]
            y[p:] += (np.sin(2 * np.pi * f0 * h[:, None] * detune[:, None]
                             * tt[None, :])
                      * np.exp(-tt[None, :] / tau[:, None])).sum(axis=0)
    else:            # band-passed noise pad
        y = _bp_fft(rng.standard_normal(n), sr,
                    rng.uniform(400, 1200), rng.uniform(1.0, 3.0))
        y *= 0.5 + 0.5 * np.sin(2 * np.pi * rng.uniform(0.2, 1.0) * t)
    y /= max(np.max(np.abs(y)), 1e-9)
    return y * rng.uniform(0.06, 0.2)


def augmented_batch(rng, batch, n, sr):
    """Training distribution: half the legacy recipe (continuity with the
    round-4 corpus), half the rich family above — then per-stem tilt EQ,
    noise-IR reverb, gain/polarity/channel jitter.  Broad enough that the
    model must key on structural cues (center-panned harmonic + syllabic
    AM = vocals) rather than the generator's exact spectra; the
    gen_sep_eval corpus (formant vowels, Karplus-Strong, grid drums, comb
    room) stays entirely unseen."""
    rich_frac = float(os.environ.get("AMW_TRAIN_RICH_FRAC", "0.5"))
    reverb_p = float(os.environ.get("AMW_TRAIN_REVERB_P", "0.5"))
    stems = synth_batch(rng, batch, n, sr).astype(np.float64)
    for b in range(batch):
        if rng.random() < rich_frac:
            d = _rich_drums(rng, n, sr)
            stems[b, 0] = np.stack([d, d * rng.uniform(0.8, 1.0)])
            bass = _rich_bass(rng, n, sr)
            stems[b, 1] = np.stack([bass, bass])
            o = _rich_other(rng, n, sr)
            pan = rng.uniform(0.35, 1.0)
            stems[b, 2] = np.stack([o * pan, o * (1.4 - pan)])
            v = _rich_vocal(rng, n, sr)
            stems[b, 3] = np.stack([v, v * rng.uniform(0.92, 1.0)])
        for s in range(4):
            st = stems[b, s]
            if rng.random() < 0.7:
                st = _fft_tilt(st, sr, rng)
            if rng.random() < reverb_p:
                st = _noise_reverb(st, sr, rng)
            st *= rng.uniform(0.5, 1.4)
            if rng.random() < 0.25:
                st = -st
            if rng.random() < 0.25:
                st = st[::-1].copy()  # channel swap
            stems[b, s] = st
    # Remix augmentation (upstream Demucs trains with the same trick):
    # shuffle each stem independently across the batch so every mixture is
    # a NEW combination the generators never produced together — the model
    # can't key on cross-stem correlations of any one recipe.
    remix_p = float(os.environ.get("AMW_TRAIN_REMIX_P", "0.5"))
    if batch > 1 and rng.random() < remix_p:
        for s in range(4):
            stems[:, s] = stems[rng.permutation(batch), s]
    # Stem dropout: occasionally silence a stem (incl. vocals) so the model
    # learns "absent source -> emit silence" instead of hallucinating.
    drop_p = float(os.environ.get("AMW_TRAIN_DROP_P", "0.08"))
    for b in range(batch):
        for s in range(4):
            if rng.random() < drop_p:
                stems[b, s] = 0.0
    return np.clip(stems, -1, 1).astype(np.float32)


# --- the schedule, the loss and the step ------------------------------------


def warmup_steps(steps: int) -> int:
    """The JAX trainer's linear warm-up length for a run of ``steps``."""
    return min(max(steps // 20, 10), max(steps // 2, 1))


def warmup_cosine_decay(init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float):
    """``optax.warmup_cosine_decay_schedule`` (exponent 1) as a function of
    the update count, in optax's order of operations at float64: a linear
    ramp from ``init_value`` to ``peak_value`` over ``warmup_steps``, then
    a cosine from ``peak_value`` down to ``end_value`` at ``decay_steps``
    (warm-up included), flat after.  (optax evaluates it in float32 from
    its int32 count; that rounding moves its values by up to ~7e-6
    relative where the cosine nears its floor.)"""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if not cos_steps > 0:
        raise ValueError(f"the cosine needs positive steps, got {cos_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        cosine = 0.5 * (1 + math.cos(math.pi * c / cos_steps))
        return peak_value * ((1 - alpha) * cosine + alpha)

    return schedule


class Adam(torch.optim.Optimizer):
    """``optax.adam``'s update: the moments ``(1 - b) * g**k + b * m`` in
    the parameters' dtype, each bias correction ``1 - b**t`` rounded to
    float32 as optax takes it from its int32 count, ``m_hat / (sqrt(v_hat)
    + eps)`` scaled by the group's ``-lr``.  (At t = 2, ``1 - 0.999**2`` in
    float32 keeps about four digits; ``torch.optim.Adam``'s float64
    corrections part from optax's updates by ~1e-5 relative.)
    Multi-tensor (``torch._foreach_*``): a few launches a step."""

    def __init__(self, params, lr=1.0, betas=(0.9, 0.999), eps=1e-8):
        super().__init__(params, dict(lr=lr, betas=betas, eps=eps))

    @staticmethod
    def _correction(b: float, t: int) -> float:
        f32 = np.float32
        return float(f32(1) - f32(np.float64(f32(b)) ** t))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            b1, b2 = group["betas"]
            states = [self.state[p] for p in params]
            for st, p in zip(states, params):
                if not st:
                    st.update(t=0, mu=torch.zeros_like(p),
                              nu=torch.zeros_like(p))
                st["t"] += 1
            t = states[0]["t"]
            grads = [p.grad for p in params]
            mus = [st["mu"] for st in states]
            nus = [st["nu"] for st in states]
            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, grads, alpha=1 - b1)
            torch._foreach_mul_(nus, b2)
            torch._foreach_addcmul_(nus, grads, grads, value=1 - b2)
            den = torch._foreach_div(nus, self._correction(b2, t))
            torch._foreach_sqrt_(den)
            torch._foreach_add_(den, group["eps"])
            upd = torch._foreach_div(mus, self._correction(b1, t))
            torch._foreach_div_(upd, den)
            torch._foreach_add_(params, upd, alpha=-group["lr"])


def make_optimizer(params, lr_peak: float, steps: int):
    """(:class:`Adam` at optax's defaults: b1 0.9, b2 0.999, eps 1e-8;
    its lr-1 step scaled by :func:`warmup_cosine_decay` from 0 to
    ``lr_peak`` and down to 0.05 of it, through a ``LambdaLR`` that counts
    the updates)."""
    sched = warmup_cosine_decay(0.0, lr_peak, warmup_steps(steps), steps,
                                lr_peak * 0.05)
    opt = Adam(params, lr=1.0, betas=(0.9, 0.999), eps=1e-8)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, sched)


def stem_weights(vocal_weight: float) -> np.ndarray:
    """The L1 weight of each stem: the vocals' (source 3) relative weight,
    normalised by the mean so that the loss scale, and so the lr, stays
    comparable across settings."""
    w = np.ones(4, np.float32)
    w[3] = vocal_weight
    return w / w.mean()


def loss_and_grads(model, mix, target, w) -> torch.Tensor:
    """The stem-weighted L1 of ``model(mix)`` against ``target`` (``w``:
    [1, S, 1, 1]) and its gradients in the parameters' ``.grad``, at full
    f32; returns the loss, detached."""
    with htdemucs._full_f32(torch.float32):
        loss = torch.mean(torch.abs(model(mix) - target) * w)
        model.zero_grad(set_to_none=True)
        loss.backward()
    return loss.detach()


def train_step(model, opt, sched, mix, target, w) -> torch.Tensor:
    """One update: loss and gradients, Adam, the schedule's count."""
    loss = loss_and_grads(model, mix, target, w)
    opt.step()
    sched.step()
    return loss


def vocals_snr(model, stems: np.ndarray) -> tuple[float, float]:
    """(network, mixture) vocal SNR in dB of ``model`` on ``stems`` [B, 4,
    2, n], in the JAX trainer's numpy arithmetic."""
    mix = stems.sum(axis=1).astype(np.float32)
    pred = htdemucs.forward(model, mix).cpu().numpy()
    return (gen_sep_eval.snr_db(pred[:, 3], stems[:, 3]),
            gen_sep_eval.snr_db(mix, stems[:, 3]))


def load_init(path: str, want: dict) -> dict:
    """The arrays of ``want``'s names from a warm-start file: the port's
    ``.npz`` or the JAX trainer's ``.th`` container (its ``state``).
    Exits on a missing key or a shape mismatch."""
    if path.endswith(".npz"):
        state = htdemucs.load_params(path)[1]
    else:
        state = torch.load(path, map_location="cpu",
                           weights_only=True)["state"]
    state = {k: np.asarray(v) for k, v in state.items()}
    missing = set(want) - set(state)
    if missing:
        raise SystemExit(f"--init missing keys: {sorted(missing)[:5]}")
    for k, v in want.items():
        if tuple(state[k].shape) != tuple(v.shape):
            raise SystemExit(f"--init shape mismatch at {k}: "
                             f"{state[k].shape} vs {tuple(v.shape)}")
    return {k: state[k] for k in want}


def profile_summary(prof, steps: int, wall_s: float) -> dict:
    """Device busy ms, idle share and kernels a step of a torch.profiler
    run of ``steps`` steps over ``wall_s`` seconds."""
    busy_us, kernels, events = 0.0, 0, 0
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        busy_us += evt.self_cuda_time_total if dev_us is None else dev_us
        events += evt.count
        if not evt.key.lower().startswith(("memcpy", "memset")):
            kernels += evt.count
    wall_ms = wall_s * 1e3
    return {"steps": steps, "wall_ms_per_step": wall_ms / steps,
            "device_ms_per_step": busy_us / 1e3 / steps,
            "device_idle_share": (1.0 - busy_us / 1e3 / wall_ms
                                  if events else None),
            "kernels_per_step": kernels / steps,
            "device_events_per_step": events / steps}


class Producer:
    """The host corpus in a thread: ``steps`` augmented batches into a
    queue of ``QUEUE_DEPTH``, seeded from ``rng`` as the JAX trainer seeds
    it; the seconds each batch took."""

    def __init__(self, rng, steps: int, batch: int, n: int, sr: int):
        self.q: queue.Queue = queue.Queue(maxsize=QUEUE_DEPTH)
        self.batch_s: list = []
        self.stop = threading.Event()
        self.thread = threading.Thread(
            target=self._run, args=(rng, steps, batch, n, sr), daemon=True)
        self.thread.start()

    def _run(self, rng, steps, batch, n, sr):
        try:
            prng = np.random.default_rng(rng.integers(1 << 31))
            for _ in range(steps):
                if self.stop.is_set():
                    return
                t0 = time.perf_counter()
                item = augmented_batch(prng, batch, n, sr)
                self.batch_s.append(time.perf_counter() - t0)
                self.q.put(item)
        except Exception as e:  # handed to the consumer
            self.q.put(e)

    def get(self) -> np.ndarray:
        item = self.q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self) -> None:
        self.stop.set()
        while self.thread.is_alive():
            try:
                self.q.get(timeout=0.1)
            except queue.Empty:
                pass
        self.thread.join()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_path", nargs="?", default="htdemucs_tiny.npz")
    ap.add_argument("steps", nargs="?", type=int, default=3000)
    ap.add_argument("--channels", type=int, default=16)
    ap.add_argument("--bottom", type=int, default=48)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vocal-weight", type=float, default=1.0,
                    help="relative L1 weight of the vocals stem (serving "
                         "quality gates score vocal SNR)")
    ap.add_argument("--init", default=None,
                    help="warm-start from a saved .npz (the port's) or .th "
                         "(the JAX trainer's), same --channels/--bottom; "
                         "the optimiser restarts")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--profile-steps", type=int, default=0,
                    help="profile this many steps from step "
                         f"{PROFILE_START} (the card only)")
    return ap


def main(argv=None, report: dict | None = None) -> int:
    cli = build_parser().parse_args(argv)
    dev = resolve_device(cli.device)
    out_path, steps = cli.out_path, cli.steps
    channels, bottom, batch = cli.channels, cli.bottom, cli.batch
    report = {} if report is None else report
    on_card = dev.type == "cuda"

    cfg = htdemucs.tiny_config(channels=channels, bottom_channels=bottom)
    sr, n = cfg.samplerate, cfg.segment_samples
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    print(f"device={dev} ({name})", flush=True)
    print(f"cfg: channels={channels} bottom={bottom} steps={steps} "
          f"batch={batch}", flush=True)

    state = {k: v.numpy() for k, v in
             htdemucs.init_params(cfg, seed=cli.seed).items()}
    if cli.init:
        state = load_init(cli.init, state)
        print(f"warm-start from {cli.init}", flush=True)
    model = htdemucs.train_model(cfg, state, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"params: {n_params/1e6:.2f} M", flush=True)
    opt, sched = make_optimizer(model.parameters(), cli.lr, steps)
    w = torch.from_numpy(stem_weights(cli.vocal_weight)).reshape(
        1, 4, 1, 1).to(dev)

    rng = np.random.default_rng(cli.seed)
    probe = gen_sep_eval.synth_batch_heldout(
        np.random.default_rng(PROBE_SEED), 4, n, sr)
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
        mem0 = torch.cuda.memory_allocated(dev)
    t0, t0_host = time.time(), time.perf_counter()
    producer = Producer(rng, steps, batch, n, sr)
    losses, probes, logged = {}, [], {}
    waits, excluded = [], {}
    best_snr, best_state, best_step = -1e9, None, -1
    prof = profiled = None
    prof_at = (PROFILE_START, PROFILE_START + cli.profile_steps)
    try:
        for step in range(steps):
            if on_card and cli.profile_steps and step == prof_at[0]:
                from torch.profiler import ProfilerActivity, profile

                torch.cuda.synchronize(dev)
                # the device's events only: a step's ~18 000 host ops
                # would take the summary tens of seconds to aggregate
                prof = profile(activities=[ProfilerActivity.CUDA])
                prof.start()
                t_prof = time.perf_counter()
            t_get = time.perf_counter()
            stems = producer.get()
            waits.append(time.perf_counter() - t_get)
            mix = torch.from_numpy(stems.sum(axis=1)).to(dev)
            target = torch.from_numpy(stems).to(dev)
            loss = train_step(model, opt, sched, mix, target, w)
            if prof is not None and step == prof_at[1] - 1:
                torch.cuda.synchronize(dev)
                wall = time.perf_counter() - t_prof
                prof.stop()
                profiled, prof = (prof, wall), None
                excluded[step] = wall
            if step % 50 == 0 or step == steps - 1:
                lv = float(loss)
                losses[step] = lv
                logged[step] = time.perf_counter()
                dt = time.time() - t0
                print(f"step {step:5d}  l1 {lv:.5f}  {dt:.0f}s "
                      f"({dt/max(step,1)*1000:.0f} ms/step)", flush=True)
            if step % PROBE_EVERY == PROBE_EVERY - 1 or step == steps - 1:
                t_probe = time.perf_counter()
                s = vocals_snr(model, probe)[0]
                excluded[step + 0.5] = time.perf_counter() - t_probe
                probes.append((step, s))
                print(f"    probe gen-independent vocal SNR: {s:.2f} dB",
                      flush=True)
                if s > best_snr:
                    best_snr, best_step = s, step
                    best_state = {k: v.detach().cpu().clone()
                                  for k, v in model.state_dict().items()}
    finally:
        if prof is not None:
            prof.stop()
        producer.close()
    wall_s = time.time() - t0

    if best_state is not None:
        print(f"best probe {best_snr:.2f} dB at step {best_step} "
              f"(final step kept separately)", flush=True)
    else:
        best_state = {k: v.detach().cpu() for k, v in
                      model.state_dict().items()}

    # held-out eval on both corpora (same-generator + generator-independent)
    eval_model = htdemucs.inference_model(cfg, best_state, device=dev,
                                          dtype=torch.float32)
    s_same, b_same = vocals_snr(eval_model, synth_batch(
        np.random.default_rng(SAME_SEED), SAME_BATCH, n, sr))
    s_held, b_held = vocals_snr(eval_model, gen_sep_eval.synth_batch_heldout(
        np.random.default_rng(HELD_SEED), HELD_BATCH, n, sr))
    print(f"same-generator held-out: {s_same:.2f} dB (baseline {b_same:.2f})",
          flush=True)
    print(f"generator-INDEPENDENT:   {s_held:.2f} dB (baseline {b_held:.2f})",
          flush=True)

    # steady state: from the log at step 50 (0 in a short run) to the
    # last, less the probes and the profile between them; the host corpus
    # over the batches of those steps
    keys = sorted(logged)
    s0 = next((k for k in keys if k >= 50), keys[0]) if steps > 100 \
        else keys[0]
    s1 = keys[-1]
    steady_ms = None
    if s1 > s0:
        gone = sum(v for k, v in excluded.items() if s0 < k < s1)
        steady_ms = ((logged[s1] - logged[s0] - gone) / (s1 - s0)) * 1e3
    host_ms = 1e3 * float(np.mean(producer.batch_s[s0 + 1:s1 + 1]
                                  or producer.batch_s))
    wait_ms = 1e3 * float(np.mean(waits[s0 + 1:s1 + 1] or waits))
    audio_s = batch * cfg.segment
    timing = {"steady_ms_per_step": steady_ms, "host_batch_ms": host_ms,
              "queue_wait_ms_per_step": wait_ms,
              "steady_window": [s0, s1],
              "realtime_factor": (audio_s / (steady_ms / 1e3)
                                  if steady_ms else None),
              "realtime_factor_run": steps * audio_s / wall_s,
              "first_step_s": logged[keys[0]] - t0_host}
    if on_card:
        timing["peak_memory_gb"] = (torch.cuda.max_memory_allocated(dev)
                                    - mem0) / 1e9
    print("timing: " + "  ".join(
        f"{k} {v:.4g}" for k, v in timing.items()
        if isinstance(v, float)), flush=True)
    if profiled is not None:
        p = report["profile"] = profile_summary(profiled[0],
                                                cli.profile_steps,
                                                profiled[1])
        print(f"profile of steps {prof_at[0]}..{prof_at[1] - 1}: "
              f"{p['wall_ms_per_step']:.3f} ms a step, device busy "
              f"{p['device_ms_per_step']:.3f} ms, idle share "
              f"{p['device_idle_share']:.3f}, "
              f"{p['kernels_per_step']:.0f} kernels a step", flush=True)

    htdemucs.save_params(best_state, out_path, cfg)
    report.update(
        params=n_params, steps=steps, batch=batch, wall_s=wall_s,
        losses=losses, probes=probes, best_probe_snr_db=best_snr,
        best_step=best_step, same_vocal_snr_db=s_same,
        same_mixture_snr_db=b_same, heldout_vocal_snr_db=s_held,
        heldout_mixture_snr_db=b_held, out_path=out_path, **timing)
    print(f"saved {out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
