"""The port's DSP vocal separator (``amw_tpu_torch/models/vocal.py``)
against the JAX package's on the CPU.

The JAX builder (``build_vocal_isolation``) is the reference, not its
``isolate_vocal``, which reads the runtime settings store.  Bars: the
repo's parity bars (BASELINE.md), max sample error <= -90 dBFS and
integrated loudness within 0.1 LU, mono and stereo at ragged lengths; a
batch equals its tracks run alone.
"""

import numpy as np
import pytest
import torch

from amw_tpu import refimpl
from amw_tpu.models import vocal as jvo
from amw_tpu.spec import GraphSpec as JSpec
from amw_tpu_torch import GraphSpec
from amw_tpu_torch.models import vocal as tvo

SR = 44100
BAR_DBFS = -90.0
BAR_LU = 0.1
LENGTHS = [SR + 7, 30_011]


def db(err):
    return 20 * np.log10(max(err, 1e-30))


def _mix(n, seed=0):
    """A centred 'vocal' (a vibrato tone in the vocal band) over a wide
    pad and a centred bass: the separator keeps the first."""
    g = np.random.default_rng(seed)
    t = np.arange(n) / SR
    voc = 0.3 * np.sin(2 * np.pi * (440 + 6 * np.sin(2 * np.pi * 5 * t)) * t)
    bass = 0.3 * np.sin(2 * np.pi * 55 * t)
    pad = 0.1 * g.standard_normal((2, n))
    return np.clip(voc + bass + pad, -0.99, 0.99).astype(np.float32)


def _pair(n, channels, strength=1.0):
    jp, jf = jvo.build_vocal_isolation(JSpec(sr=SR, n=n, channels=channels),
                                       strength)
    tp, tf = tvo.build_vocal_isolation(GraphSpec(sr=SR, n=n,
                                                 channels=channels),
                                       strength, device="cpu")
    np.testing.assert_array_equal(tp[0].numpy(), jp[0])
    return (lambda x: np.asarray(jf(x, jp))), (
        lambda x: tf(torch.from_numpy(x), tp).numpy())


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("channels", [1, 2], ids=["mono", "stereo"])
def test_matches_jax(channels, n):
    x = _mix(n, seed=n)[:channels]
    jf, tf = _pair(n, channels, strength=0.8)
    want, got = jf(x), tf(x)
    assert got.shape == want.shape == x.shape
    assert db(float(np.max(np.abs(got - want)))) <= BAR_DBFS
    assert abs(refimpl.integrated_lufs(got, SR)
               - refimpl.integrated_lufs(want, SR)) <= BAR_LU


@pytest.mark.parametrize("channels", [1, 2], ids=["mono", "stereo"])
def test_batch_equals_tracks_alone(channels):
    n = LENGTHS[1]
    xb = np.stack([_mix(n, seed=s)[:channels] for s in (1, 2, 3)])
    xb[2] *= 0.1
    _, tf = _pair(n, channels)
    got = tf(xb)
    for b in range(3):
        assert db(float(np.max(np.abs(got[b] - tf(xb[b]))))) <= -120.0


def test_isolate_vocal_runs_the_dsp_separator(monkeypatch):
    """Without a checkpoint, ``isolate_vocal`` is the builder's graph on
    the track, as in the JAX package (whose settings store is empty here)."""
    monkeypatch.delenv("AMW_HTDEMUCS_CKPT", raising=False)
    assert tvo.htdemucs_checkpoint_path() is None and tvo.is_available()
    x = _mix(LENGTHS[1], seed=4)
    got = tvo.isolate_vocal(x, SR, device="cpu")
    want = np.asarray(jvo.isolate_vocal(x, SR, model="dsp"))
    assert got.dtype == np.float32
    assert db(float(np.max(np.abs(got - want)))) <= BAR_DBFS


def test_checkpoint_path_reads_the_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("AMW_HTDEMUCS_CKPT", str(tmp_path))
    assert tvo.htdemucs_checkpoint_path() == str(tmp_path)
    # a checkpoint asks for the network only through model htdemucs/auto
    x = _mix(4096, seed=5)
    got = tvo.isolate_vocal(x, SR, model="dsp", device="cpu")
    assert got.shape == x.shape
