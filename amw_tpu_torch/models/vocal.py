"""Vocal isolation: the htdemucs network where a checkpoint is configured,
else the DSP separator (counterpart of ``amw_tpu/models/vocal.py``).

The neural path (:func:`separate_htdemucs`): ``models/htdemucs.py`` on
the weights of the configured checkpoint (:func:`htdemucs_checkpoint_path`:
``AMW_HTDEMUCS_CKPT``, then the ``htdemucs_checkpoint`` setting of the
runtime's settings store, i.e. its database row, then
``MAGIC_MASTER_HTDEMUCS_CHECKPOINT`` / ``AMW_HTDEMUCS_CHECKPOINT``;
``bundled`` is the port's converted tiny checkpoint), kept on the device
in one copy a (path, device, dtype).

The DSP separator, a two-stem centre extractor in the STFT domain
(``ops/spectral.stft`` / ``istft``, on ``torch.fft``):

- mid/side: lead vocals are overwhelmingly panned to the centre;
- an inter-channel coherence mask: per STFT cell, the share of coherent
  (in-phase, equal-magnitude) energy gates the mid signal;
- a vocal-band prior (raised-cosine edges at 80-160 Hz and 9-14 kHz)
  suppresses bass and air that sit in the centre but are not vocals.

A mono track gets the band prior alone.  It runs where no checkpoint is
configured, and where a configured one is missing or unreadable (with a
logged warning), as in the JAX package.
"""

from __future__ import annotations

import functools
import logging
import os
import threading
import zipfile

import numpy as np
import torch

from .. import resolve_device
from ..convert import to_device
from ..ops.spectral import istft, stft
from ..spec import GraphSpec
from . import htdemucs

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


_log = logging.getLogger(__name__)

BUNDLED = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "checkpoints", "htdemucs_tiny.npz")
CONVERTER = "scripts/convert_htdemucs_port.py"


def htdemucs_checkpoint_path() -> str | None:
    """The configured htdemucs checkpoint, or ``None``: ``AMW_HTDEMUCS_CKPT``,
    else the settings store's ``htdemucs_checkpoint`` (its database row,
    else ``Settings.htdemucs_checkpoint``, read from the environment when
    the settings were built), in the JAX package's order.  ``bundled`` is
    the port's own converted copy of the JAX package's trained tiny
    checkpoint (``checkpoints/htdemucs_tiny.npz``, written by
    ``scripts/convert_htdemucs_port.py``); any other value is expanded and
    made absolute."""
    path = os.environ.get("AMW_HTDEMUCS_CKPT")
    if not path:
        try:
            from ..runtime import settings_store

            path = settings_store.get_setting_str(
                "htdemucs_checkpoint", None) or None
        except Exception:  # noqa: BLE001 — models layer must work standalone
            path = None
    if not path:
        return None
    if path == "bundled":
        return BUNDLED
    return os.path.abspath(os.path.expanduser(path))


def _is_orbax(path: str) -> bool:
    return os.path.isdir(path) and any(
        os.path.exists(os.path.join(path, name))
        for name in ("_CHECKPOINT_METADATA", "manifest.ocdbt"))


_ht_lock = threading.Lock()
_ht_cache: dict = {}  # (path, device, dtype) -> (cfg, model)


def _htdemucs(device: torch.device):
    """``(cfg, model)`` for the configured checkpoint on ``device`` in the
    inference dtype, or ``None`` (no checkpoint, or one that is missing or
    unreadable: a logged warning, and the DSP separator runs, as in the
    JAX package).  Only successful loads are cached, keyed by (path,
    device, dtype), so a new ``htdemucs_checkpoint`` takes effect on the
    next request; a new path drops the other paths' weights.  Locked: the
    warmup thread and the first request would otherwise load the same
    weights twice.  An orbax directory (the JAX package's format) raises
    ``ValueError`` naming the converter; a device error raises."""
    path = htdemucs_checkpoint_path()
    if path is None:
        return None
    if _is_orbax(path):
        raise ValueError(
            f"htdemucs checkpoint {path} is an orbax directory of the JAX "
            f"package; convert it to the port's format with {CONVERTER}")
    key = (path, device, htdemucs.inference_dtype(device))
    with _ht_lock:
        if key in _ht_cache:
            return _ht_cache[key]
        try:
            cfg, state = htdemucs.load_params(path)
            model = htdemucs.inference_model(cfg, state, device=device,
                                             dtype=key[2])
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:
            _log.warning("htdemucs checkpoint %s does not load (%s); the "
                         "DSP separator runs", path, e)
            return None
        for k in [k for k in _ht_cache if k[0] != path]:
            del _ht_cache[k]
        _ht_cache[key] = (cfg, model)
        return _ht_cache[key]


def warmup_htdemucs(durations_sec, *, device=None) -> int:
    """The engine's warmup of the neural separator on ``device`` (default
    ``cuda``): loads the configured checkpoint's weights onto the device
    and runs one separation of silence (vocals only) for each distinct
    window-group bucket (``htdemucs.oa_plan``'s ``nb_b``) of
    ``durations_sec``, the call a request of that length makes, so that
    cuDNN and cuBLAS load their kernels for its shapes before the first
    request.  Returns the number of buckets, as the JAX package's; 0
    without a checkpoint."""
    dev = resolve_device(device)
    loaded = _htdemucs(dev)
    if loaded is None:
        return 0
    cfg, model = loaded
    seen: set = set()
    for dur in durations_sec:
        T = int(cfg.samplerate * float(dur))
        nb_b = htdemucs.oa_plan(cfg, T)[3]
        if nb_b in seen:
            continue
        seen.add(nb_b)
        htdemucs.separate(model, np.zeros((2, T), np.float32),
                          stems=("vocals",))
    return len(seen)


_mesh_lock = threading.Lock()
_mesh_params_cache: dict = {}


def _mesh_params(model, mesh) -> dict:
    """One copy of the network per distinct device of ``mesh``
    (``htdemucs.mesh_models``: the model itself on its own device), kept
    for the last mesh only, so that a serving mesh's requests do not copy
    the weights each time."""
    key = (id(model), tuple(mesh.distinct_devices()))
    with _mesh_lock:
        got = _mesh_params_cache.get(key)
        if got is None:
            got = htdemucs.mesh_models(model, mesh)
            _mesh_params_cache.clear()  # one live mesh copy is enough
            _mesh_params_cache[key] = (model, got)
            return got
        return got[1]


def separate_htdemucs(audio: np.ndarray, sr: int, *, device=None,
                      mesh=None) -> np.ndarray | None:
    """[C, N] -> vocals [C, N] through the htdemucs network on ``device``
    (default ``cuda``), or ``None`` where no weights load.  The model rate
    is reached and left on the host with ``scipy.signal.resample``, in
    float64, as the JAX package does; a mono track is separated as
    doubled stereo and gets the mean of the two vocal channels; the
    output is clipped to full scale.  With ``mesh`` (more than one
    position) the window groups split over its first axis
    (``htdemucs.separate_mesh``)."""
    dev = resolve_device(device)
    loaded = _htdemucs(dev)
    if loaded is None:
        return None
    cfg, model = loaded
    x = np.atleast_2d(np.ascontiguousarray(audio, np.float32))
    if x.shape[0] == 1:
        x = np.repeat(x, 2, axis=0)
    n = x.shape[-1]
    if sr != cfg.samplerate:
        import scipy.signal as sg

        n_model = int(round(n * cfg.samplerate / sr))
        x = np.stack([sg.resample(ch.astype(np.float64), n_model)
                      for ch in x]).astype(np.float32)
    if mesh is not None and mesh.devices.size > 1:
        vocals = htdemucs.separate_mesh(
            _mesh_params(model, mesh), x, mesh, axis=mesh.axis_names[0],
            stems=("vocals",))[0]
    else:
        vocals = htdemucs.separate(model, x, stems=("vocals",))[0]
    if sr != cfg.samplerate:
        import scipy.signal as sg

        vocals = np.stack(
            [sg.resample(np.asarray(ch, np.float64), n)
             for ch in vocals]).astype(np.float32)
    if audio.ndim == 2 and audio.shape[0] == 1:
        vocals = vocals.mean(axis=0, keepdims=True)
    return np.clip(vocals, -1.0, 1.0).astype(np.float32)


def isolate_vocal(audio: np.ndarray, sr: int, model: str = "htdemucs", *,
                  device=None, mesh=None) -> np.ndarray:
    """Vocals of one track ``audio`` [C, N] (numpy), like it, on ``device``
    (default ``cuda``): the htdemucs network for ``model`` ``htdemucs`` or
    ``auto`` where a checkpoint is configured and loads (over ``mesh``'s
    positions where given: :func:`separate_htdemucs`), else the DSP
    separator (the reference's model choice,
    services/vocal_isolation.py:23)."""
    dev = resolve_device(device)
    if model in ("htdemucs", "auto"):
        vocals = separate_htdemucs(audio, sr, device=dev, mesh=mesh)
        if vocals is not None:
            return vocals
    params, fn = _built(sr, audio.shape[-1], audio.shape[0], dev)
    x = torch.as_tensor(np.ascontiguousarray(audio, np.float32), device=dev)
    with torch.no_grad():
        return fn(x, params).cpu().numpy()


def isolate_vocal_bytes(audio_bytes: bytes, filename: str,
                        model: str = "htdemucs", *, device=None) -> bytes:
    """Bytes-level contract of the reference's ``isolate_vocal``: decode
    (``utils/audio_io``), :func:`isolate_vocal` on ``device`` (default
    ``cuda``; the network where a checkpoint is configured), a float32 WAV
    of the vocals."""
    from ..utils import wav
    from ..utils.audio_io import load_audio_from_bytes

    audio, sr = load_audio_from_bytes(audio_bytes, filename)
    vocals = isolate_vocal(audio, sr, model=model, device=device)
    return wav.write_wav_float32(vocals, sr)
