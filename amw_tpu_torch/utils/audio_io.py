"""Audio load and export at the engine's I/O boundary (counterpart of
``amw_tpu/utils/audio_io.py``).

Mirrors the reference's format policy (pipeline.py:802-827, 965-1052):
WAV decodes with the numpy codec (``utils/wav.py``), FLAC with
``native/flac.cpp`` and MP3/OPUS/AAC with the FFmpeg-library shim
(``native/lavc.cpp``); the ffmpeg CLI is the fallback where the shim
cannot build, and the reference's explanatory error is raised where
neither exists.

Export takes a ``[C, N]`` tensor or array.  The dithered formats (``wav``,
and the 16-bit input of mp3/opus/aac) run on the tensor's device, in the
JAX package's order: clip, auto-blank (the last sample above -50 dBFS
found on the device), ``nan_to_num``, dither noise (``ops/dither.
dither_noise`` from a per-request ``torch.Generator`` seeded from OS
entropy, as the JAX package's ``np.random.default_rng()``), ``ops/dither.
quantize16``; then one int16 copy to the host and the WAV writer.
``wav24``, ``wav32f`` and ``flac`` are exported on the host, as in the JAX
package.
"""

from __future__ import annotations

import shutil
import subprocess
import time

import numpy as np
import torch

from ..ops import dither
from . import wav

HOST_FORMATS = ("wav24", "wav32f", "flac")


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


def lavc_available() -> bool:
    """In-process FFmpeg-library codec shim (native/lavc.cpp)."""
    from .. import native

    return native.lavc_available()


def lossy_codec_available() -> bool:
    """Can MP3/OPUS/AAC be encoded/decoded on this host?"""
    return lavc_available() or ffmpeg_available()


def _ffmpeg_error(fmt: str) -> RuntimeError:
    return RuntimeError(
        f"Format {fmt.upper()} requires ffmpeg, which is not installed on this "
        "server. Install it with: sudo apt-get install -y ffmpeg"
    )


def _run_ffmpeg(args: list[str], input_bytes: bytes) -> bytes:
    proc = subprocess.run(
        ["ffmpeg", "-v", "error", *args],
        input=input_bytes, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"ffmpeg failed: {proc.stderr.decode()[:500]}")
    return proc.stdout


def load_audio_from_bytes(data: bytes, fmt: str):
    """-> (audio[C, N] float32, sr).  Channel-major (reference is [N, C]).

    WAV and FLAC decode natively (numpy codec / native/flac.cpp) — the
    reference handles both without ffmpeg via libsndfile
    (pipeline.py:802-817); MP3/OPUS/AAC ride the ffmpeg boundary exactly
    as the reference's pydub path does (pipeline.py:819-827)."""
    ext = fmt.rsplit(".", 1)[-1].lower().lstrip(".")
    if ext == "wav":
        return wav.read_wav(data)
    if ext == "flac" or data[:4] == b"fLaC":
        from .. import native

        if native.flac_available():
            try:
                q, sr, bits = native.flac_decode(data)
                return (q.astype(np.float32)
                        / np.float32(2 ** (bits - 1))), sr
            except ValueError:
                if not lossy_codec_available():
                    raise
        # unsupported stream shape or no toolchain: lavc/ffmpeg below
    if lavc_available():
        from .. import native

        try:
            return native.lavc_decode(data)
        except ValueError:
            if not ffmpeg_available():
                raise
    if not ffmpeg_available():
        raise _ffmpeg_error(ext)
    out = _run_ffmpeg(
        ["-i", "pipe:0", "-f", "wav", "-acodec", "pcm_f32le", "pipe:1"], data
    )
    return wav.read_wav(out)


def auto_blank_end(x, sr: int, threshold_dbfs: float = -50.0,
                   min_silence_sec: float = 0.5):
    """Trim trailing silence (pipeline.py:902-917).  ``x``: an array, or a
    tensor whose last loud sample is found on its device (one scalar comes
    back to the host)."""
    size = x.size if isinstance(x, np.ndarray) else x.numel()
    if size == 0 or min_silence_sec <= 0:
        return x
    thr = 10 ** (threshold_dbfs / 20.0)
    if isinstance(x, np.ndarray):
        peak = np.max(np.abs(x), axis=0) if x.ndim > 1 else np.abs(x)
        above = np.nonzero(peak > thr)[0]
        if len(above) == 0:
            return x
        last = int(above[-1])
    else:
        peak = x.abs().amax(dim=0) if x.ndim > 1 else x.abs()
        pos = torch.arange(peak.shape[-1], device=x.device)
        last = int(torch.where(peak > thr, pos, -1).max())
        if last < 0:
            return x
    idx = min(x.shape[-1], last + 1 + int(sr * min_silence_sec))
    return x[..., :idx]


def _entropy_generator(device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.seed()  # OS entropy, as np.random.default_rng()
    return gen


def dithered_int16(x: torch.Tensor, dither_type: str = "tpdf",
                   generator: torch.Generator | None = None) -> torch.Tensor:
    """float [C, N] on its device -> dithered int16 [C, N] there.
    ``ns_e`` / ``ns_itu`` shape the noise (TPDF below 4 / 8 samples), any
    other type is TPDF, as in the JAX package."""
    x = torch.nan_to_num(x, nan=0.0, posinf=1.0, neginf=-1.0).clamp(-1.0, 1.0)
    kind = dither_type if dither_type in ("ns_e", "ns_itu") else "tpdf"
    gen = generator or _entropy_generator(x.device)
    noise = dither.dither_noise(gen, x.shape, kind, device=x.device)
    return dither.quantize16(x, noise)


def add_seconds(timings, name: str, t0: float, device=None) -> float:
    """Add the seconds since ``t0`` to ``timings[name]`` and return the
    time now; with ``device`` a card, after its queue drains, so that its
    work is counted where it ran.  Nothing when ``timings`` is None."""
    if timings is None:
        return t0
    if device is not None and device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()
    t1 = time.perf_counter()
    timings[name] = timings.get(name, 0.0) + (t1 - t0)
    return t1


def export_audio(
    samples,
    sr: int,
    out_format: str = "wav",
    dither_type: str = "tpdf",
    auto_blank_sec: float = 0.0,
    bitrate: int | None = None,
    generator: torch.Generator | None = None,
    timings: dict | None = None,
) -> bytes:
    """[C, N] tensor or array -> encoded bytes (pipeline.py:965-1052
    semantics).  ``generator``: the dither's draws (default: a new one
    from OS entropy on the tensor's device).  ``timings``: where given,
    the seconds of ``export`` (the device's part), ``d2h`` (the copy to
    the host) and ``encode`` are added to it."""
    t0 = time.perf_counter()
    if out_format in HOST_FORMATS:
        if isinstance(samples, torch.Tensor):
            samples = samples.cpu().numpy()
        t0 = add_seconds(timings, "d2h", t0)
        x = np.atleast_2d(np.asarray(samples, np.float32))
        x = np.clip(x, -1.0, 1.0)
        dev = None
    else:
        x = samples if isinstance(samples, torch.Tensor) else \
            torch.from_numpy(np.ascontiguousarray(samples, np.float32))
        x = x.to(torch.float32)
        x = x[None] if x.ndim == 1 else x
        x = x.clamp(-1.0, 1.0)
        dev = x.device
    if auto_blank_sec > 0:
        x = auto_blank_end(x, sr, threshold_dbfs=-50.0,
                           min_silence_sec=auto_blank_sec)

    if out_format in HOST_FORMATS:
        t0 = add_seconds(timings, "export", t0)
        if out_format == "wav24":
            out = wav.write_wav_int24(x, sr)
        elif out_format == "wav32f":
            out = wav.write_wav_float32(x, sr)
        else:
            # 24-bit FLAC like the reference's soundfile PCM_24 export
            # (pipeline.py:990) — native codec first, ffmpeg fallback.
            from .. import native

            if native.flac_available():
                q = np.clip(np.round(np.asarray(x, np.float64) * 8388607.0),
                            -8388608, 8388607).astype(np.int32)
                out = native.flac_encode(q, sr, bits=24)
            else:
                if not ffmpeg_available():
                    raise _ffmpeg_error(out_format)
                src = wav.write_wav_int24(x, sr)
                out = _run_ffmpeg(["-i", "pipe:0", "-f", "flac", "pipe:1"],
                                  src)
        add_seconds(timings, "encode", t0)
        return out

    if out_format != "wav" and not lossy_codec_available():
        raise _ffmpeg_error(out_format)
    q16 = dithered_int16(x, dither_type, generator)
    t0 = add_seconds(timings, "export", t0, dev)
    q16 = q16.cpu().numpy()  # the one device-to-host copy: int16
    t0 = add_seconds(timings, "d2h", t0)
    if out_format == "wav":
        out = wav.write_wav_int16(q16, sr)
    else:
        out = _encode_lossy(q16, sr, out_format, bitrate)
    add_seconds(timings, "encode", t0)
    return out


def _encode_lossy(q16: np.ndarray, sr: int, out_format: str,
                  bitrate: int | None) -> bytes:
    """The dithered 16-bit signal [C, N] -> mp3/opus/aac/other bytes:
    identical input to the CLI path, which pipes a 16-bit dithered WAV
    into ffmpeg (reference pipeline.py:999-1052 likewise encodes
    post-dither audio via pydub)."""
    if out_format == "mp3":
        br = bitrate if bitrate in (128, 192, 256, 320) else 320
    elif out_format == "opus":
        br = bitrate if bitrate in (128, 192) else 192
    else:
        br = 192
    if lavc_available() and out_format in ("mp3", "opus", "aac"):
        from .. import native

        xq = q16.astype(np.float32) / 32767.0
        return native.lavc_encode(xq, sr, out_format, br)
    wav_bytes = wav.write_wav_int16(q16, sr)
    if out_format == "mp3":
        return _run_ffmpeg(
            ["-i", "pipe:0", "-f", "mp3", "-b:a", f"{br}k", "pipe:1"], wav_bytes)
    if out_format == "opus":
        return _run_ffmpeg(
            ["-i", "pipe:0", "-f", "opus", "-c:a", "libopus", "-b:a", f"{br}k",
             "pipe:1"], wav_bytes)
    if out_format == "aac":
        return _run_ffmpeg(
            ["-i", "pipe:0", "-f", "ipod", "-c:a", "aac", "-b:a", "192k",
             "-movflags", "frag_keyframe+empty_moov", "pipe:1"], wav_bytes)
    return _run_ffmpeg(["-i", "pipe:0", "-f", out_format, "pipe:1"], wav_bytes)
