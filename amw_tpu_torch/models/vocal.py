"""Vocal isolation, the DSP separator (counterpart of the DSP path of
``amw_tpu/models/vocal.py``).

A two-stem centre extractor in the STFT domain (``ops/spectral.stft`` /
``istft``, on ``torch.fft``):

- mid/side: lead vocals are overwhelmingly panned to the centre;
- an inter-channel coherence mask: per STFT cell, the share of coherent
  (in-phase, equal-magnitude) energy gates the mid signal;
- a vocal-band prior (raised-cosine edges at 80-160 Hz and 9-14 kHz)
  suppresses bass and air that sit in the centre but are not vocals.

A mono track gets the band prior alone.  This is what the JAX package
runs when no htdemucs checkpoint is configured.  The neural separator is
not ported: with a checkpoint configured (``AMW_HTDEMUCS_CKPT``),
:func:`isolate_vocal` raises ``NotImplementedError`` instead of quietly
running the DSP separator where the JAX package would run the network.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import resolve_device
from ..convert import to_device
from ..ops.spectral import istft, stft
from ..spec import GraphSpec

NPERSEG = 2048


def _vocal_band_weight(sr: int, n_bins: int,
                       nperseg: int = NPERSEG) -> np.ndarray:
    freqs = np.arange(n_bins) * (sr / nperseg)
    w = np.ones(n_bins)
    lo0, lo1 = 80.0, 160.0  # raised-cosine high-pass edge
    hi0, hi1 = 9000.0, 14000.0  # raised-cosine low-pass edge
    w = np.where(freqs < lo0, 0.0, w)
    ramp = (freqs - lo0) / (lo1 - lo0)
    w = np.where((freqs >= lo0) & (freqs < lo1),
                 0.5 - 0.5 * np.cos(np.pi * np.clip(ramp, 0, 1)), w)
    ramp2 = (freqs - hi0) / (hi1 - hi0)
    w = np.where((freqs >= hi0) & (freqs < hi1),
                 0.5 + 0.5 * np.cos(np.pi * np.clip(ramp2, 0, 1)), w)
    w = np.where(freqs >= hi1, 0.0, w)
    return w.astype(np.float32)


def build_vocal_isolation(spec: GraphSpec, strength: float = 1.0, *,
                          device):
    """``(params, fn)``: ``params`` = ``[band weight]`` as tensors on
    ``device`` (``None``: ``cuda``); ``fn(x, params)`` takes a track
    ``[C, N]`` or a batch ``[B, C, N]`` (``N`` = ``spec.n``, C = 1 or 2)
    and returns the vocals like ``x`` (a stereo track gets the mid vocal on
    both channels).  Tracks of a batch do not mix."""
    dev = resolve_device(device)
    params = to_device([_vocal_band_weight(spec.sr, NPERSEG // 2 + 1)], dev)

    def fn(x, params):
        band_w = params[0]
        if x.shape[-2] == 1:
            # mono: the vocal-band prior alone (no spatial cue)
            return torch.clamp(istft(stft(x) * band_w, spec.n), -1.0, 1.0)
        L = stft(x[..., 0, :])
        R = stft(x[..., 1, :])
        mid = (L + R) * 0.5
        # coherence: 1 for identical channels, towards 0 for independent or
        # out-of-phase ones
        cross = L * torch.conj(R)
        denom = (L.abs() ** 2 + R.abs() ** 2) * 0.5 + 1e-12
        coh = torch.clamp(cross.real / denom, 0.0, 1.0)
        mask = (coh ** 2) * band_w * strength
        v = istft(mid * mask, spec.n)
        return torch.clamp(torch.stack([v, v], dim=-2), -1.0, 1.0)

    return params, fn


@functools.lru_cache(maxsize=8)
def _built(sr: int, n: int, channels: int, device: torch.device):
    return build_vocal_isolation(GraphSpec(sr=sr, n=n, channels=channels),
                                 device=device)


def is_available() -> bool:
    return True


def htdemucs_checkpoint_path() -> str | None:
    """The configured htdemucs checkpoint, ``AMW_HTDEMUCS_CKPT`` as given,
    or ``None``.  (The JAX package also reads the runtime settings store,
    which comes to the port with the runtime, and resolves the value to a
    directory it loads; the port loads nothing yet.)"""
    return os.environ.get("AMW_HTDEMUCS_CKPT") or None


def _htdemucs_not_ported():
    raise NotImplementedError(
        "the htdemucs vocal separator is not ported to amw_tpu_torch yet "
        "(ROADMAP.md, 'Modules to port': amw_tpu/models/htdemucs_jax.py);"
        " unset AMW_HTDEMUCS_CKPT to run the DSP separator")


def warmup_htdemucs(durations_sec) -> int:
    """The engine's warmup of the neural separator: nothing to warm without
    a configured checkpoint (returns 0, the number of buckets warmed, as
    the JAX package's); with one it raises ``NotImplementedError``, as
    :func:`isolate_vocal` does."""
    if htdemucs_checkpoint_path():
        _htdemucs_not_ported()
    return 0


def isolate_vocal(audio: np.ndarray, sr: int, model: str = "htdemucs", *,
                  device=None) -> np.ndarray:
    """Vocals of one track ``audio`` [C, N] (numpy), like it: the DSP
    separator on ``device`` (default ``cuda``).  ``model`` ``htdemucs`` or
    ``auto`` asks for the network where a checkpoint is configured, which
    the port does not have yet: that raises ``NotImplementedError``."""
    if model in ("htdemucs", "auto") and htdemucs_checkpoint_path():
        _htdemucs_not_ported()
    dev = resolve_device(device)
    params, fn = _built(sr, audio.shape[-1], audio.shape[0], dev)
    x = torch.as_tensor(np.ascontiguousarray(audio, np.float32), device=dev)
    with torch.no_grad():
        return fn(x, params).cpu().numpy()


def isolate_vocal_bytes(audio_bytes: bytes, filename: str,
                        model: str = "htdemucs", *, device=None) -> bytes:
    """Bytes-level contract of the reference's ``isolate_vocal``: decode
    (``utils/audio_io``), :func:`isolate_vocal` on ``device`` (default
    ``cuda``), a float32 WAV of the vocals."""
    from ..utils import wav
    from ..utils.audio_io import load_audio_from_bytes

    audio, sr = load_audio_from_bytes(audio_bytes, filename)
    vocals = isolate_vocal(audio, sr, model=model, device=device)
    return wav.write_wav_float32(vocals, sr)
