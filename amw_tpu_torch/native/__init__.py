"""ctypes bindings of the native host codecs (a copy of
``amw_tpu/native/__init__.py`` over this package's own sources).

``pcm.cpp`` (the WAV sample-format loops), ``flac.cpp`` (FLAC) and
``lavc.cpp`` (MP3/OPUS/AAC through FFmpeg's libraries) are built by
``native/build.py`` into ``amw_tpu_torch/_build/`` on first use and loaded
lazily.  Where a library cannot be built (no ``g++``, no FFmpeg headers)
its ``*_available()`` is False and the callers take the paths the JAX
package takes: the numpy WAV codec, the ffmpeg CLI, or the reference's
error.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from . import build as _build

_lock = threading.Lock()
_libs: dict = {}  # name -> loaded library, or None once it failed


def _load(name: str, make, bind):
    """Build (``make``), load and bind (``bind``) a library once per
    process; ``None`` when it cannot be built or loaded."""
    with _lock:
        if name in _libs:
            return _libs[name]
        lib = None
        path = make(verbose=False)
        if path is not None:
            try:
                lib = bind(ctypes.CDLL(str(path)))
            except OSError:
                lib = None
        _libs[name] = lib
        return lib


def _bind_pcm(lib):
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.pcm16_to_f32_planar.argtypes = [i16p, f32p, i64, i32]
    lib.pcm24_to_f32_planar.argtypes = [u8p, f32p, i64, i32]
    lib.f32_interleaved_to_planar.argtypes = [f32p, f32p, i64, i32]
    lib.f32_planar_dither_to_pcm16.argtypes = [f32p, f32p, i16p, i64, i32]
    lib.f32_planar_to_pcm24.argtypes = [f32p, u8p, i64, i32]
    lib.f32_peak.argtypes = [f32p, i64]
    lib.f32_peak.restype = ctypes.c_float
    return lib


def get_lib():
    return _load("pcm", _build.build, _bind_pcm)


def available() -> bool:
    return get_lib() is not None


def pcm16_decode(raw: bytes, channels: int) -> np.ndarray:
    lib = get_lib()
    src = np.frombuffer(raw, "<i2")
    frames = len(src) // channels
    src = np.ascontiguousarray(src[: frames * channels])
    out = np.empty((channels, frames), np.float32)
    lib.pcm16_to_f32_planar(src, out, frames, channels)
    return out


def pcm24_decode(raw: bytes, channels: int) -> np.ndarray:
    lib = get_lib()
    src = np.frombuffer(raw, np.uint8)
    frames = len(src) // (3 * channels)
    src = np.ascontiguousarray(src[: frames * channels * 3])
    out = np.empty((channels, frames), np.float32)
    lib.pcm24_to_f32_planar(src, out, frames, channels)
    return out


def f32_decode(raw: bytes, channels: int) -> np.ndarray:
    lib = get_lib()
    src = np.frombuffer(raw, "<f4")
    frames = len(src) // channels
    src = np.ascontiguousarray(src[: frames * channels])
    out = np.empty((channels, frames), np.float32)
    lib.f32_interleaved_to_planar(src, out, frames, channels)
    return out


def pcm16_encode_dithered(x: np.ndarray, noise: np.ndarray) -> np.ndarray:
    """``x`` [C, N] with the dither ``noise`` [C, N] (in LSBs) to int16
    [C, N] (pipeline.py:880-899): clip to [-1, 1] (NaN as 0), scale by
    32767, add the noise, round half to even, clip to int16."""
    lib = get_lib()
    x = np.ascontiguousarray(x, np.float32)
    noise = np.ascontiguousarray(noise, np.float32)
    C, n = x.shape
    out = np.empty(n * C, np.int16)
    lib.f32_planar_dither_to_pcm16(x, noise, out, n, C)
    return out.reshape(n, C).T


def pcm24_encode(x: np.ndarray) -> bytes:
    """``x`` [C, N] to interleaved little-endian 24-bit PCM bytes."""
    lib = get_lib()
    x = np.ascontiguousarray(x, np.float32)
    C, n = x.shape
    out = np.empty(n * C * 3, np.uint8)
    lib.f32_planar_to_pcm24(x, out, n, C)
    return out.tobytes()


# ---------- native FLAC codec (flac.cpp) ------------------------------------

def _bind_flac(lib):
    i64, i32 = ctypes.c_longlong, ctypes.c_int
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.flac_encode.argtypes = [i32p, i64, i32, i32, i32, u8p, i64]
    lib.flac_encode.restype = i64
    lib.flac_info.argtypes = [u8p, i64, ctypes.POINTER(i32),
                              ctypes.POINTER(i32), ctypes.POINTER(i32),
                              ctypes.POINTER(i64)]
    lib.flac_info.restype = i32
    lib.flac_decode.argtypes = [u8p, i64, i32p, i64]
    lib.flac_decode.restype = i64
    return lib


def get_flac_lib():
    return _load("flac", _build.build_flac, _bind_flac)


def flac_available() -> bool:
    return get_flac_lib() is not None


def flac_encode(samples: np.ndarray, sr: int, bits: int = 24) -> bytes:
    """Planar int32 [C, N] (values already scaled to ``bits``) -> FLAC."""
    lib = get_flac_lib()
    if lib is None:
        raise RuntimeError("native FLAC codec unavailable (no g++?)")
    x = np.ascontiguousarray(samples, np.int32)
    C, n = x.shape
    cap = int(n * C * (bits // 8) * 2 + (n // 4096 + 2) * 64 + 4096)
    out = np.empty(cap, np.uint8)
    wrote = lib.flac_encode(x, n, C, int(sr), int(bits), out, cap)
    if wrote < 0:
        raise RuntimeError("FLAC encode failed")
    return out[:wrote].tobytes()


def flac_info(data: bytes):
    """-> (channels, sample_rate, bits, total_samples) or None."""
    lib = get_flac_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    ch = ctypes.c_int()
    sr = ctypes.c_int()
    bits = ctypes.c_int()
    total = ctypes.c_longlong()
    if lib.flac_info(np.ascontiguousarray(buf), len(buf), ctypes.byref(ch),
                     ctypes.byref(sr), ctypes.byref(bits),
                     ctypes.byref(total)) != 0:
        return None
    return ch.value, sr.value, bits.value, total.value


def flac_decode(data: bytes):
    """FLAC bytes -> (planar int32 [C, N], sr, bits)."""
    lib = get_flac_lib()
    if lib is None:
        raise RuntimeError("native FLAC codec unavailable (no g++?)")
    info = flac_info(data)
    if info is None:
        raise ValueError("not a FLAC stream")
    C, sr, bits, total = info
    buf = np.ascontiguousarray(np.frombuffer(data, np.uint8))
    out = np.empty((C, max(total, 1)), np.int32)
    got = lib.flac_decode(buf, len(buf), out, out.shape[1])
    if got < 0:
        raise ValueError("FLAC decode failed (corrupt or unsupported)")
    return out[:, :got], sr, bits


# ---------- lossy codecs via FFmpeg libraries (lavc.cpp) --------------------
# In-process MP3/OPUS/AAC, replacing the reference's pydub -> ffmpeg-CLI
# subprocess (reference pipeline.py:819-827, 999-1052).

def _bind_lavc(lib):
    i64, i32 = ctypes.c_int64, ctypes.c_int
    u8p, f32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_float)
    lib.amw_lavc_ok.restype = i32
    lib.amw_lavc_decode.argtypes = [
        ctypes.c_char_p, i64, ctypes.POINTER(f32p), ctypes.POINTER(i64),
        ctypes.POINTER(i32), ctypes.POINTER(i32), ctypes.c_char_p, i32]
    lib.amw_lavc_decode.restype = i32
    lib.amw_lavc_encode.argtypes = [
        np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS"), i64, i32,
        i32, ctypes.c_char_p, i32, ctypes.POINTER(u8p), ctypes.POINTER(i64),
        ctypes.c_char_p, i32]
    lib.amw_lavc_encode.restype = i32
    lib.amw_lavc_free.argtypes = [ctypes.c_void_p]
    return lib if lib.amw_lavc_ok() == 1 else None


def get_lavc_lib():
    return _load("lavc", _build.build_lavc, _bind_lavc)


def lavc_available() -> bool:
    return get_lavc_lib() is not None


def lavc_decode(data: bytes):
    """Encoded bytes (mp3/opus/aac/ogg/...) -> ([C, N] float32, sr)."""
    lib = get_lavc_lib()
    if lib is None:
        raise RuntimeError("native lavc codec unavailable")
    pcm = ctypes.POINTER(ctypes.c_float)()
    frames = ctypes.c_int64()
    ch = ctypes.c_int()
    sr = ctypes.c_int()
    err = ctypes.create_string_buffer(512)
    rc = lib.amw_lavc_decode(data, len(data), ctypes.byref(pcm),
                             ctypes.byref(frames), ctypes.byref(ch),
                             ctypes.byref(sr), err, len(err))
    if rc != 0:
        raise ValueError(
            f"lavc decode failed: {err.value.decode(errors='replace')}")
    try:
        n, c = frames.value, ch.value
        flat = np.ctypeslib.as_array(pcm, shape=(n * c,))
        out = np.ascontiguousarray(flat.reshape(n, c).T, np.float32)
    finally:
        lib.amw_lavc_free(pcm)
    return out, sr.value


def lavc_encode(x: np.ndarray, sr: int, fmt: str,
                bitrate_kbps: int = 0) -> bytes:
    """[C, N] float32 -> encoded bytes.  fmt in {mp3, opus, aac}."""
    lib = get_lavc_lib()
    if lib is None:
        raise RuntimeError("native lavc codec unavailable")
    x = np.atleast_2d(np.asarray(x, np.float32))
    inter = np.ascontiguousarray(x.T.reshape(-1))
    C, n = x.shape
    out = ctypes.POINTER(ctypes.c_uint8)()
    out_size = ctypes.c_int64()
    err = ctypes.create_string_buffer(512)
    rc = lib.amw_lavc_encode(inter, n, C, int(sr), fmt.encode(),
                             int(bitrate_kbps), ctypes.byref(out),
                             ctypes.byref(out_size), err, len(err))
    if rc != 0:
        raise RuntimeError(
            f"lavc encode failed: {err.value.decode(errors='replace')}")
    try:
        blob = bytes(np.ctypeslib.as_array(out, shape=(out_size.value,)))
    finally:
        lib.amw_lavc_free(out)
    return blob
