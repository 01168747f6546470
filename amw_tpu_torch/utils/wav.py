"""Pure-numpy WAV codec (PCM 16/24/32-bit and float32/float64), a copy of
``amw_tpu/utils/wav.py``.

Replaces the reference's libsndfile/soundfile dependency
(pipeline.py:802-827, 880-899) for the formats the service actually needs.
Reading returns channel-major float32 in [-1, 1] plus the sample rate; the
port's C++ fast path (``amw_tpu_torch/native``) takes the inner unpack
loops when it builds, but this numpy version is already vectorized (no
Python per-sample loops).
"""

from __future__ import annotations

import struct

import numpy as np

WAVE_FORMAT_PCM = 0x0001
WAVE_FORMAT_IEEE_FLOAT = 0x0003
WAVE_FORMAT_EXTENSIBLE = 0xFFFE


class WavError(ValueError):
    pass


def _native():
    """The C++ codec module when built, else None (numpy fallback)."""
    from .. import native

    return native if native.available() else None


def read_wav(data: bytes):
    """Parse a RIFF/WAVE blob -> (audio[C, N] float32, sr)."""
    buf = memoryview(data)
    if len(buf) < 12 or bytes(buf[0:4]) != b"RIFF" or bytes(buf[8:12]) != b"WAVE":
        raise WavError("not a RIFF/WAVE file")
    pos = 12
    fmt = None
    raw = None
    while pos + 8 <= len(buf):
        cid = bytes(buf[pos:pos + 4])
        size = struct.unpack_from("<I", buf, pos + 4)[0]
        body = buf[pos + 8: pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack_from("<HHIIHH", body, 0)
            if fmt[0] == WAVE_FORMAT_EXTENSIBLE and size >= 40:
                # SubFormat GUID starts at offset 24; first 2 bytes = real tag.
                real_tag = struct.unpack_from("<H", body, 24)[0]
                fmt = (real_tag,) + fmt[1:]
        elif cid == b"data":
            raw = bytes(body)
        pos += 8 + size + (size & 1)
    if fmt is None or raw is None:
        raise WavError("missing fmt/data chunk")
    tag, channels, sr, _brate, _align, bits = fmt[:6]
    if channels < 1 or channels > 8:
        raise WavError(f"unsupported channel count {channels}")

    native = _native()
    if native is not None and tag == WAVE_FORMAT_PCM and bits == 16:
        return native.pcm16_decode(raw, channels), int(sr)
    if native is not None and tag == WAVE_FORMAT_PCM and bits == 24:
        return native.pcm24_decode(raw, channels), int(sr)
    if native is not None and tag == WAVE_FORMAT_IEEE_FLOAT and bits == 32:
        return native.f32_decode(raw, channels), int(sr)

    if tag == WAVE_FORMAT_IEEE_FLOAT and bits == 32:
        x = np.frombuffer(raw, "<f4").astype(np.float32)
    elif tag == WAVE_FORMAT_IEEE_FLOAT and bits == 64:
        x = np.frombuffer(raw, "<f8").astype(np.float32)
    elif tag == WAVE_FORMAT_PCM and bits == 16:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif tag == WAVE_FORMAT_PCM and bits == 24:
        b = np.frombuffer(raw, np.uint8)
        b = b[: (len(b) // 3) * 3].reshape(-1, 3)
        vals = (b[:, 0].astype(np.uint32)
                | (b[:, 1].astype(np.uint32) << 8)
                | (b[:, 2].astype(np.uint32) << 16))
        vals = vals.astype(np.int32)
        vals = np.where(vals >= (1 << 23), vals - (1 << 24), vals)
        x = vals.astype(np.float32) / float(1 << 23)
    elif tag == WAVE_FORMAT_PCM and bits == 32:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / float(1 << 31)
    elif tag == WAVE_FORMAT_PCM and bits == 8:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise WavError(f"unsupported WAV format tag={tag} bits={bits}")

    n = len(x) // channels
    x = x[: n * channels].reshape(n, channels).T  # -> [C, N]
    return np.ascontiguousarray(x), int(sr)


def _header(n_bytes: int, sr: int, channels: int, bits: int, tag: int) -> bytes:
    block = channels * bits // 8
    return b"".join([
        b"RIFF", struct.pack("<I", 36 + n_bytes), b"WAVE",
        b"fmt ", struct.pack("<IHHIIHH", 16, tag, channels, sr,
                             sr * block, block, bits),
        b"data", struct.pack("<I", n_bytes),
    ])


def write_wav_int16(x_int16: np.ndarray, sr: int) -> bytes:
    """[C, N] int16 -> WAV bytes (PCM_16)."""
    inter = np.ascontiguousarray(x_int16.T).astype("<i2")
    raw = inter.tobytes()
    return _header(len(raw), sr, x_int16.shape[0], 16, WAVE_FORMAT_PCM) + raw


def write_wav_float32(x: np.ndarray, sr: int) -> bytes:
    inter = np.ascontiguousarray(np.asarray(x, np.float32).T).astype("<f4")
    raw = inter.tobytes()
    return _header(len(raw), sr, x.shape[0], 32, WAVE_FORMAT_IEEE_FLOAT) + raw


def write_wav_int24(x: np.ndarray, sr: int) -> bytes:
    """[C, N] float in [-1,1] -> 24-bit PCM WAV (the reference's FLAC-24
    export tier; FLAC itself requires an external encoder)."""
    v = np.clip(np.asarray(x, np.float64).T, -1.0, 1.0)
    vals = np.round(v * (1 << 23)).astype(np.int64)
    vals = np.clip(vals, -(1 << 23), (1 << 23) - 1).astype(np.int32).reshape(-1)
    u = vals.astype(np.uint32) & 0xFFFFFF
    b = np.empty((len(u), 3), np.uint8)
    b[:, 0] = u & 0xFF
    b[:, 1] = (u >> 8) & 0xFF
    b[:, 2] = (u >> 16) & 0xFF
    raw = b.tobytes()
    return _header(len(raw), sr, x.shape[0], 24, WAVE_FORMAT_PCM) + raw
