#!/usr/bin/env python
"""Generator-independent separation eval corpus, and the vocal SNRs of
an htdemucs checkpoint on it through the port's network.

    python -m amw_tpu_torch.scripts.gen_sep_eval [CKPT.npz]
        [--device cuda|cpu] [--dtype f32|bf16]

The tiny htdemucs checkpoint trains on additive sines and noise bursts;
evaluating on held-out draws of the same generator is overfit-friendly,
so this corpus uses a deliberately different synthesis recipe:

- **vocals**: sawtooth glottal source on a melody grid (piecewise notes
  with portamento) through per-vowel formant resonators, plus consonant
  noise bursts at syllable onsets;
- **drums**: tempo-grid kick (decaying 120→40 Hz sine sweep), snare
  (band-passed noise) and off-beat hats (short high-passed noise);
- **bass**: plucked FM synth following the melody's root notes;
- **other**: Karplus-Strong plucked chords (feedback comb);
- **room**: a small Schroeder-style reverb applied PER STEM (same room),
  so targets stay well defined while every stem carries reflections;
- **balance**: a different per-stem loudness distribution.

``realistic_mix`` renders a deterministic song-like piece (I–V–vi–IV
progression, kick on quarters / snare on 2 & 4 / hats on 8ths, bassline
on roots, vocal phrase).  The generators are pure numpy from their
seeds, the JAX package's ``scripts/gen_sep_eval.py``'s (of which this is
the port's copy) bit for bit.  :func:`eval_checkpoint` runs the port's
``models/htdemucs`` network on ``device`` (``cuda`` unless given; raises
without a GPU) in the inference dtype (``AMW_HTDEMUCS_DTYPE``, which
``--dtype`` sets: bf16 on the card, f32 on the CPU unless set) and
prints its four SNRs as JSON.  Without a path it evaluates the
configured checkpoint, ``bundled`` unless ``AMW_HTDEMUCS_CKPT`` says
otherwise.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from amw_tpu_torch import resolve_device

# --- tiny DSP helpers (numpy only, independent of amw_tpu.ops) --------------


def _biquad_bp(x, sr, f0, q):
    """Direct-form bandpass biquad (RBJ), applied along the last axis."""
    w0 = 2 * np.pi * f0 / sr
    alpha = np.sin(w0) / (2 * q)
    b = np.array([alpha, 0.0, -alpha])
    a = np.array([1 + alpha, -2 * np.cos(w0), 1 - alpha])
    b, a = b / a[0], a / a[0]
    y = np.zeros_like(x)
    x1 = x2 = y1 = y2 = 0.0
    for i in range(x.shape[-1]):
        y[..., i] = (b[0] * x[..., i] + b[1] * x1 + b[2] * x2
                     - a[1] * y1 - a[2] * y2)
        x2, x1 = x1, x[..., i]
        y2, y1 = y1, y[..., i]
    return y


def _biquad_bp_fft(x, sr, f0, q):
    """Zero-phase FFT version of the bandpass (fast; fine for synthesis)."""
    n = x.shape[-1]
    X = np.fft.rfft(x, axis=-1)
    f = np.fft.rfftfreq(n, 1.0 / sr)
    w0, bw = f0, f0 / q
    H = 1.0 / (1.0 + ((f - w0) / (bw / 2 + 1e-9)) ** 2)
    return np.fft.irfft(X * H, n=n, axis=-1)


def _reverb(x, sr, rng, wet=0.18):
    """Small-room Schroeder: 3 feedback combs + 1 allpass, per channel."""
    n = x.shape[-1]
    out = np.array(x, np.float64, copy=True)
    wetsig = np.zeros_like(out)
    for lag_ms, g in ((11.3, 0.62), (15.9, 0.55), (21.7, 0.48)):
        lag = max(1, int(sr * lag_ms / 1000.0))
        y = np.zeros_like(out)
        buf = np.array(out)
        # feedback comb via block doubling: y = sum_k g^k x[n - k*lag]
        gk = 1.0
        for k in range(1, 1 + int(np.ceil(3.0 / max(1e-9, -np.log10(g))))):
            gk *= g
            if k * lag >= n or gk < 1e-3:
                break
            y[..., k * lag:] += gk * buf[..., : n - k * lag]
        wetsig += y / 3.0
    # one allpass-ish diffusion pass
    lag = max(1, int(sr * 5.1 / 1000.0))
    wetsig[..., lag:] += 0.5 * wetsig[..., : n - lag]
    return (x + wet * wetsig).astype(np.float32)


def _pluck(n, sr, f0, rng, bright=0.996):
    """Karplus-Strong string: noise burst through a feedback comb."""
    period = max(2, int(round(sr / f0)))
    y = np.zeros(n)
    y[:period] = rng.uniform(-1, 1, period)
    for i in range(period, n):
        y[i] = bright * 0.5 * (y[i - period] + y[i - period + 1])
    return y


_NOTE_HZ = 220.0 * 2.0 ** (np.arange(-12, 13) / 12.0)  # A2..A4 grid


def _melody(rng, n_notes, lo=5, hi=19):
    idx = [int(rng.integers(lo, hi))]
    for _ in range(n_notes - 1):
        idx.append(int(np.clip(idx[-1] + rng.integers(-4, 5), lo, hi - 1)))
    return _NOTE_HZ[idx]


def _vocal(n, sr, rng):
    """Sawtooth glottal source + formant resonators + consonant bursts."""
    n_notes = max(2, int(round(n / sr * rng.uniform(1.5, 3.0))))
    notes = _melody(rng, n_notes, lo=8, hi=20)
    seg = n // n_notes
    f0 = np.repeat(notes, seg)[:n]
    f0 = np.convolve(np.pad(f0, (200, 200), mode="edge"),
                     np.ones(401) / 401, mode="same")[200:200 + n]  # portamento
    phase = 2 * np.pi * np.cumsum(f0) / sr
    saw = 2.0 * ((phase / (2 * np.pi)) % 1.0) - 1.0  # harmonic-rich source
    v = np.zeros(n)
    vowels = ((730, 1090), (270, 2290), (390, 1990), (520, 1190))
    for k in range(n_notes):
        s, e = k * seg, min((k + 1) * seg, n)
        if e - s < 32:
            continue
        f1, f2 = vowels[int(rng.integers(0, len(vowels)))]
        chunk = saw[s:e]
        v[s:e] = (_biquad_bp_fft(chunk, sr, f1 * 0.9, 4.0)
                  + 0.6 * _biquad_bp_fft(chunk, sr, min(f2, 0.45 * sr), 5.0))
        # consonant: short noise burst at onset
        cl = min(int(0.02 * sr), e - s)
        v[s:s + cl] += rng.standard_normal(cl) * 0.3 * np.exp(
            -np.arange(cl) / (0.004 * sr))
    env = np.clip(np.sin(np.pi * np.arange(n) / n) + 0.4, 0, 1)
    v *= env
    v /= max(np.max(np.abs(v)), 1e-9)
    return v * rng.uniform(0.2, 0.4)


def _drums(n, sr, rng, bpm=None):
    bpm = bpm or rng.uniform(90, 140)
    beat = int(sr * 60.0 / bpm)
    d = np.zeros(n)
    for p in range(0, n, beat):  # kick: decaying sine sweep 120 -> 40 Hz
        L = min(int(0.09 * sr), n - p)
        tt = np.arange(L) / sr
        f = 120.0 * np.exp(-tt / 0.04) + 40.0
        d[p:p + L] += (np.sin(2 * np.pi * np.cumsum(f) / sr)
                       * np.exp(-tt / 0.05) * rng.uniform(0.5, 0.8))
    for p in range(beat, n, 2 * beat):  # snare on 2 & 4
        L = min(int(0.07 * sr), n - p)
        sn = rng.standard_normal(L) * np.exp(-np.arange(L) / (0.02 * sr))
        d[p:p + L] += _biquad_bp_fft(sn, sr, 1800.0, 1.2) * 2.2
    for p in range(beat // 2, n, beat):  # hats on off-beats
        L = min(int(0.025 * sr), n - p)
        h = rng.standard_normal(L) * np.exp(-np.arange(L) / (0.006 * sr))
        H = np.fft.rfft(h)
        f = np.fft.rfftfreq(L, 1.0 / sr)
        d[p:p + L] += np.fft.irfft(H * (f > 2500), n=L) * 1.5
    return d


def _bass_fm(n, sr, rng, roots=None):
    n_notes = max(1, int(round(n / sr * rng.uniform(1.0, 2.0))))
    notes = (roots if roots is not None
             else _melody(rng, n_notes, lo=0, hi=8) / 2.0)
    seg = n // max(len(notes), 1)
    b = np.zeros(n)
    for k, f in enumerate(notes):
        s, e = k * seg, min((k + 1) * seg, n)
        L = e - s
        if L < 16:
            continue
        tt = np.arange(L) / sr
        ratio = float(rng.choice([2.0, 3.0]))
        idx_env = np.exp(-tt / 0.15) * rng.uniform(1.0, 3.0)
        carrier = 2 * np.pi * f * tt
        mod = np.sin(2 * np.pi * f * ratio * tt) * idx_env
        b[s:e] = np.sin(carrier + mod) * np.exp(-tt / 0.6)
    return b * rng.uniform(0.25, 0.45)


def _other_ks(n, sr, rng, chord=None):
    freqs = (chord if chord is not None
             else _NOTE_HZ[[int(rng.integers(5, 18)) for _ in range(3)]])
    y = np.zeros(n)
    hit = max(1, int(sr * rng.uniform(0.4, 0.9)))
    for p in range(0, n, hit):
        L = n - p
        for f in freqs:
            y[p:p + L] += _pluck(L, sr, float(f), rng)[:L]
    y /= max(np.max(np.abs(y)), 1e-9)
    return y * rng.uniform(0.08, 0.2)


def synth_batch_heldout(rng, batch, n, sr):
    """[batch, 4, 2, n] stems (drums, bass, other, vocals) — same contract
    as train_htdemucs_tiny.synth_batch, different synthesis recipe."""
    stems = np.zeros((batch, 4, 2, n), np.float32)
    for b in range(batch):
        d = _drums(n, sr, rng)
        stems[b, 0] = np.stack([d, d * rng.uniform(0.85, 1.0)])
        bass = _bass_fm(n, sr, rng)
        stems[b, 1] = np.stack([bass, bass])
        o = _other_ks(n, sr, rng)
        pan = rng.uniform(0.45, 1.0)
        stems[b, 2] = np.stack([o * pan, o * (1.45 - pan)])
        v = _vocal(n, sr, rng)
        stems[b, 3] = np.stack([v, v * rng.uniform(0.92, 1.0)])
        # same small room on every stem (targets stay well defined)
        for s in range(4):
            stems[b, s] = _reverb(stems[b, s], sr, rng,
                                  wet=rng.uniform(0.08, 0.22))
    return np.clip(stems, -1, 1)


def realistic_mix(n, sr, seed=20250820):
    """Deterministic song-like piece: I–V–vi–IV progression, kick/snare/hat
    grid, root bassline, vocal phrase.  Returns [4, 2, n] stems."""
    rng = np.random.default_rng(seed)
    bpm = 120.0
    bar = int(sr * 60.0 / bpm * 4)
    prog = [0, 7, 9, 5]  # semitone offsets of I V vi IV roots
    stems = np.zeros((4, 2, n), np.float32)
    d = _drums(n, sr, rng, bpm=bpm)
    stems[0] = np.stack([d, d * 0.92])
    roots, chords = [], []
    for k in range((n + bar - 1) // bar):
        root = 110.0 * 2 ** (prog[k % 4] / 12.0)
        roots.append(root / 2.0)
        chords.append([root, root * 2 ** (4 / 12), root * 2 ** (7 / 12)])
    bass = np.zeros(n)
    other = np.zeros(n)
    for k, (r, ch) in enumerate(zip(roots, chords)):
        s, e = k * bar, min((k + 1) * bar, n)
        if e - s < 64:
            continue
        bass[s:e] = _bass_fm(e - s, sr, rng, roots=[r])[: e - s]
        other[s:e] = _other_ks(e - s, sr, rng, chord=ch)[: e - s]
    stems[1] = np.stack([bass, bass])
    stems[2] = np.stack([other * 0.8, other * 0.65])
    v = _vocal(n, sr, rng)
    stems[3] = np.stack([v, v * 0.97])
    for s in range(4):
        stems[s] = _reverb(stems[s], sr, rng, wet=0.15)
    return np.clip(stems, -1, 1)


def snr_db(est, ref) -> float:
    return float(10 * np.log10(
        np.sum(ref ** 2) / max(np.sum((est - ref) ** 2), 1e-12)))


def eval_checkpoint(path=None, *, device=None, batch=8, seed=424242) -> dict:
    """Vocal SNR of a checkpoint in the port's format (``path``; the
    bundled ``htdemucs_tiny.npz`` where ``None``) on (a) ``batch``
    held-out draws from ``seed`` and (b) the deterministic realistic mix
    in 4 segments, through the network as ``models/vocal`` builds it for
    serving, on ``device`` in its inference dtype.  Returns a dict of dB
    numbers, beside each the mixture's own SNR."""
    import torch

    from amw_tpu_torch.models import htdemucs, vocal

    dev = resolve_device(device)
    path = vocal.BUNDLED if path is None else path
    if vocal._is_orbax(path):
        raise ValueError(
            f"htdemucs checkpoint {path} is an orbax directory of the JAX "
            f"package; convert it to the port's format with "
            f"{vocal.CONVERTER}")
    cfg, state = htdemucs.load_params(path)
    n, sr = cfg.segment_samples, cfg.samplerate
    model = htdemucs.inference_model(cfg, state, device=dev)

    def fwd(mix):
        y = htdemucs.forward(model, np.ascontiguousarray(mix, np.float32))
        return y.to(torch.float32).cpu().numpy()

    out = {}
    rng = np.random.default_rng(seed)
    stems = synth_batch_heldout(rng, batch, n, sr)
    mix = stems.sum(axis=1).astype(np.float32)
    pred = fwd(mix)
    out["heldout_vocal_snr_db"] = snr_db(pred[:, 3], stems[:, 3])
    out["heldout_mixture_snr_db"] = snr_db(mix, stems[:, 3])

    song = realistic_mix(4 * n, sr)
    segs = np.stack([song[:, :, i * n:(i + 1) * n] for i in range(4)])
    mix_s = segs.sum(axis=1).astype(np.float32)
    pred_s = fwd(mix_s)
    out["song_vocal_snr_db"] = snr_db(pred_s[:, 3], segs[:, 3])
    out["song_mixture_snr_db"] = snr_db(mix_s, segs[:, 3])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("path", nargs="?", default=None,
                    help="checkpoint (.npz); default: the configured one")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    ap.add_argument("--dtype", default=None, choices=["f32", "bf16"],
                    help="sets AMW_HTDEMUCS_DTYPE for this run")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # set for this run only: an in-process caller gets its environment back
    saved = {k: os.environ.get(k)
             for k in ("AMW_HTDEMUCS_DTYPE", "AMW_HTDEMUCS_CKPT")}
    try:
        if args.dtype is not None:
            os.environ["AMW_HTDEMUCS_DTYPE"] = args.dtype
        path = args.path
        if path is None:
            from amw_tpu_torch.models.vocal import htdemucs_checkpoint_path

            os.environ.setdefault("AMW_HTDEMUCS_CKPT", "bundled")
            path = htdemucs_checkpoint_path()
        result = eval_checkpoint(path, device=dev)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
