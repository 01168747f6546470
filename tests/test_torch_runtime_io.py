"""The port's host I/O (``amw_tpu_torch/utils``, ``native``) against the
JAX package's on the same seeded inputs, on the CPU, and the engine's
reference envelope against the JAX engine's host oracle.

Bars: the WAV writers, the host exports (``wav24``, ``wav32f``, ``flac``),
the decoders and ``auto_blank_end`` are equal byte for byte or value for
value.  The reference envelope (float32 torch ops, where the oracle sums
in float64) is held to 1e-5 of its largest bin.  The dithered 16-bit export draws its
noise from a ``torch.Generator`` where the JAX package uses numpy's, so it
is held within 2 LSB of the JAX package's output (TPDF noise lies in
(-1, 1) LSB on both sides), and its noise statistically on silence (the
bars of ``chip_smoke.py``'s export phase, on the rounded values).
"""

import struct

import numpy as np
import pytest
import torch

from amw_tpu import native as jnative
from amw_tpu.refimpl import pipeline as jref
from amw_tpu.utils import audio_io as jio
from amw_tpu.utils import wav as jwav
from amw_tpu_torch import native as tnative
from amw_tpu_torch.ops import dither
from amw_tpu_torch.utils import audio_io as tio
from amw_tpu_torch.utils import wav as twav

SR = 22050


def _signal(channels=2, n=20_000, seed=0, scale=0.9):
    g = np.random.default_rng(seed)
    x = scale * np.sin(2 * np.pi * 330 * np.arange(n) / SR)
    x = x + 0.1 * g.standard_normal((channels, n))
    return np.clip(x, -1.2, 1.2).astype(np.float32)


def _with_tail(x, tail=6000):
    """``x`` with its last ``tail`` samples at -70 dBFS (below auto-blank's
    -50 dBFS threshold)."""
    y = x.copy()
    y[:, -tail:] *= 10 ** (-70 / 20) / max(float(np.abs(y).max()), 1e-9)
    return y


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("writer", ["write_wav_int16", "write_wav_int24",
                                    "write_wav_float32"])
def test_wav_writers_byte_equal(writer, channels):
    x = _signal(channels)
    if writer == "write_wav_int16":
        x = (np.clip(x, -1, 1) * 32767).astype(np.int16)
    assert getattr(twav, writer)(x, SR) == getattr(jwav, writer)(x, SR)


def _blob(kind, x):
    """WAV bytes of ``x`` [C, N] in ``kind``, including the formats only
    the numpy reader decodes (PCM 8 and 32, float64)."""
    C = x.shape[0]
    if kind == "pcm16":
        return jwav.write_wav_int16((np.clip(x, -1, 1) * 32767).astype(
            np.int16), SR)
    if kind == "pcm24":
        return jwav.write_wav_int24(x, SR)
    if kind == "f32":
        return jwav.write_wav_float32(x, SR)
    inter = np.clip(x, -1, 1).T
    raw, bits, tag = {
        "f64": (inter.astype("<f8"), 64, jwav.WAVE_FORMAT_IEEE_FLOAT),
        "pcm32": ((inter * 2 ** 31 * 0.999).astype("<i4"), 32,
                  jwav.WAVE_FORMAT_PCM),
        "pcm8": ((inter * 127 + 128).astype(np.uint8), 8,
                 jwav.WAVE_FORMAT_PCM),
    }[kind]
    raw = raw.tobytes()
    return jwav._header(len(raw), SR, C, bits, tag) + raw


@pytest.mark.parametrize("native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("kind", ["pcm16", "pcm24", "f32", "f64", "pcm32",
                                  "pcm8"])
def test_read_wav_equal(kind, native, monkeypatch):
    blob = _blob(kind, _signal(2, seed=3))
    if native:
        assert tnative.available(), "g++ could not build native/pcm.cpp"
    else:
        monkeypatch.setattr(twav, "_native", lambda: None)
    got, sr = twav.read_wav(blob)
    want, sr_j = jwav.read_wav(blob)
    assert sr == sr_j == SR
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_read_wav_extensible_header():
    x = _signal(2, 4000)
    blob = jwav.write_wav_float32(x, SR)
    # WAVE_FORMAT_EXTENSIBLE with the float SubFormat (tag at offset 24)
    body = struct.pack("<HHIIHH", 0xFFFE, 2, SR, SR * 8, 8, 32) + \
        struct.pack("<HHI", 22, 32, 3) + struct.pack("<H", 3) + bytes(14)
    data = blob[blob.index(b"data"):]
    ext = (b"RIFF" + struct.pack("<I", 4 + 8 + len(body) + len(data))
           + b"WAVE" + b"fmt " + struct.pack("<I", len(body)) + body + data)
    np.testing.assert_array_equal(twav.read_wav(ext)[0],
                                  jwav.read_wav(ext)[0])
    with pytest.raises(twav.WavError):
        twav.read_wav(b"RIFF0000WAVX")


@pytest.mark.parametrize("channels", [1, 2])
def test_flac_round_trip_equal(channels):
    if not (tnative.flac_available() and jnative.flac_available()):
        pytest.skip("g++ cannot build the FLAC codec here")
    x = _signal(channels, 30_000, seed=4)
    q = np.clip(np.round(np.clip(x, -1, 1).astype(np.float64) * 8388607.0),
                -8388608, 8388607).astype(np.int32)
    blob = tnative.flac_encode(q, SR, bits=24)
    assert blob == jnative.flac_encode(q, SR, bits=24)
    got, sr, bits = tnative.flac_decode(blob)
    assert (sr, bits) == (SR, 24)
    np.testing.assert_array_equal(got, q)
    a, sr_t = tio.load_audio_from_bytes(blob, "t.flac")
    b, sr_j = jio.load_audio_from_bytes(blob, "t.flac")
    assert sr_t == sr_j
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("auto_blank", [0.0, 0.1])
@pytest.mark.parametrize("fmt", ["wav24", "wav32f", "flac"])
def test_host_exports_byte_equal(fmt, auto_blank):
    x = _with_tail(_signal(2, 30_000, seed=5))
    want = jio.export_audio(x, SR, fmt, auto_blank_sec=auto_blank)
    for given in (x, torch.from_numpy(x)):
        assert tio.export_audio(given, SR, fmt,
                                auto_blank_sec=auto_blank) == want


@pytest.mark.parametrize("auto_blank", [0.0, 0.1])
def test_dithered_wav_within_2_lsb(auto_blank):
    x = _with_tail(_signal(2, 30_000, seed=6, scale=0.5))
    want, _ = jio.load_audio_from_bytes(
        jio.export_audio(x, SR, "wav", auto_blank_sec=auto_blank), "t.wav")
    got, sr = tio.load_audio_from_bytes(
        tio.export_audio(torch.from_numpy(x), SR, "wav",
                         auto_blank_sec=auto_blank), "t.wav")
    assert sr == SR and got.shape == want.shape
    assert float(np.max(np.abs(got - want))) * 32768 <= 2.0


def test_dithered_wav_is_quantize16_of_its_noise():
    """With a seeded generator the export is ``quantize16`` of the clipped
    signal and ``dither_noise``'s draws, as written by the int16 writer."""
    x = _signal(2, 10_000, seed=7)
    gen = torch.Generator().manual_seed(11)
    blob = tio.export_audio(torch.from_numpy(x), SR, "wav", generator=gen)
    gen.manual_seed(11)
    noise = dither.dither_noise(gen, x.shape, "tpdf", device="cpu")
    q = dither.quantize16(torch.from_numpy(np.clip(x, -1, 1)), noise)
    assert blob == twav.write_wav_int16(q.numpy(), SR)


def test_tpdf_export_of_silence():
    """TPDF on a silent input: every sample rounds to -1, 0 or 1 LSB; mean
    within 0.01 LSB, and the variance of the rounded triangular noise
    (P(|n| > 1/2) = 1/4) within 2 % of 1/4."""
    blob = tio.export_audio(np.zeros((2, 100_000), np.float32), SR, "wav",
                            generator=torch.Generator().manual_seed(1))
    q = np.frombuffer(blob[44:], "<i2").astype(np.float64)
    assert set(np.unique(q).tolist()) <= {-1.0, 0.0, 1.0}
    assert abs(q.mean()) < 0.01
    assert abs(q.var() - 0.25) <= 0.02 * 0.25


@pytest.mark.parametrize("case", ["tail", "silent", "loud", "mono_1d",
                                  "short_window", "zero_window"])
def test_auto_blank_end_equal(case):
    x = _with_tail(_signal(2, 20_000, seed=8))
    kw = {"min_silence_sec": 0.1}
    if case == "silent":
        x = np.zeros_like(x)
    elif case == "loud":
        x = _signal(2, 20_000, seed=8)
    elif case == "mono_1d":
        x = x[0]
    elif case == "short_window":
        kw = {"min_silence_sec": 0.01}
    elif case == "zero_window":
        kw = {"min_silence_sec": 0.0}
    want = jio.auto_blank_end(x, SR, **kw)
    np.testing.assert_array_equal(tio.auto_blank_end(x, SR, **kw), want)
    got = tio.auto_blank_end(torch.from_numpy(x), SR, **kw)
    np.testing.assert_array_equal(got.numpy(), want)


def test_lossy_export_decodes_like_jax():
    """mp3 through the FFmpeg shim (or the CLI): the port decodes its own
    export to the input's shape, and both packages decode those bytes
    alike; without a lossy codec both raise the reference's error."""
    x = _signal(2, 44_100, seed=9, scale=0.5)
    if not tio.lossy_codec_available():
        for io in (tio, jio):
            with pytest.raises(RuntimeError, match="requires ffmpeg"):
                io.export_audio(x, 44100, "mp3")
        return
    blob = tio.export_audio(torch.from_numpy(x), 44100, "mp3", bitrate=192)
    got, sr = tio.load_audio_from_bytes(blob, "t.mp3")
    want, sr_j = jio.load_audio_from_bytes(blob, "t.mp3")
    assert sr == sr_j == 44100 and got.shape[0] == 2
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ref_sr", [SR, 44100, 16000])
def test_reference_envelope_matches_the_oracle(ref_sr):
    """``MasteringEngine._reference_envelope`` (the port's resampler and
    envelope ops) against what the JAX engine computes on the host
    (engine.py:659-667)."""
    from amw_tpu_torch.runtime.engine import MasteringEngine

    x = _signal(2, 50_000, seed=10)
    eng = MasteringEngine(micro_batch=False, device="cpu")
    for ref in (x, x[:, :4000]):
        want = ref
        if ref_sr != SR:
            want = jref.resample_fft(np.mean(ref, axis=0)[None], ref_sr, SR)
        want = jref.spectral_envelope(want, SR)
        got = eng._reference_envelope(ref, ref_sr, SR).numpy()
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))
