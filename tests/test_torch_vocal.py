"""The port's vocal separator (``amw_tpu_torch/models/vocal.py``) against
the JAX package's on the CPU: the DSP separator and the htdemucs network
on the bundled checkpoint, and where both read the checkpoint setting.

For the DSP separator the JAX builder (``build_vocal_isolation``) is the
reference, not its ``isolate_vocal``, which reads the runtime settings
store.  Bars: the repo's parity bars (BASELINE.md), max sample error
<= -90 dBFS and integrated loudness within 0.1 LU, mono and stereo at
ragged lengths (the network at 3 s, 44.1 kHz); a batch equals its tracks
run alone.  The bundled checkpoint's separation gate is the JAX
package's (tests/test_htdemucs_parity.py:233-281): vocals SNR > 8 dB and
> the mixture's + 8 dB.
"""

import logging
import tempfile

import numpy as np
import pytest
import torch

from amw_tpu import refimpl
from amw_tpu.models import htdemucs_jax as hj
from amw_tpu.models import vocal as jvo
from amw_tpu.runtime import config as jconfig
from amw_tpu.runtime import db as jdb
from amw_tpu.runtime import settings_store as jstore
from amw_tpu.spec import GraphSpec as JSpec
from amw_tpu_torch import GraphSpec
from amw_tpu_torch.models import htdemucs as ht
from amw_tpu_torch.models import vocal as tvo
from amw_tpu_torch.runtime import config as tconfig
from amw_tpu_torch.runtime import db as tdb
from amw_tpu_torch.runtime import settings_store as tstore
from amw_tpu_torch.scripts import htdemucs_gate

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


# --- the neural separator ----------------------------------------------------


@pytest.fixture
def stores(monkeypatch):
    """Both packages' settings stores on empty temporary databases, with
    settings built from the environment as it stands (a test sets the
    environment first, then calls ``fresh``)."""
    with tempfile.TemporaryDirectory() as tmp:
        for mod, name in ((jdb, "jax"), (tdb, "port")):
            # put the former path back at teardown, without opening it
            monkeypatch.setattr(mod, "_db_path_cache", mod._db_path_cache)
            mod.set_db_path(f"{tmp}/{name}.sqlite3")

        def fresh():
            monkeypatch.setattr(jstore, "settings", jconfig.Settings())
            monkeypatch.setattr(tstore, "settings", tconfig.Settings())

        for name in ("AMW_HTDEMUCS_CKPT", "AMW_HTDEMUCS_CHECKPOINT",
                     "MAGIC_MASTER_HTDEMUCS_CHECKPOINT"):
            monkeypatch.delenv(name, raising=False)
        fresh()
        yield fresh


SOURCES = ["AMW_HTDEMUCS_CKPT", "MAGIC_MASTER_HTDEMUCS_CHECKPOINT",
           "AMW_HTDEMUCS_CHECKPOINT", "database"]


def _configure(source, value, monkeypatch, fresh):
    if source == "database":
        for store in (jstore, tstore):
            store.set_setting("htdemucs_checkpoint", value)
    else:
        monkeypatch.setenv(source, value)
        fresh()  # the settings read their environment when built


@pytest.mark.parametrize("source", SOURCES)
def test_checkpoint_sources_agree_with_jax(source, stores, monkeypatch,
                                           tmp_path):
    """Each of the reference's three sources configures the checkpoint
    in both packages alike; ``bundled`` names each package's own copy of
    the trained tiny checkpoint (the port's is converted)."""
    assert tvo.htdemucs_checkpoint_path() is None
    assert jvo.htdemucs_checkpoint_path() is None
    monkeypatch.chdir(tmp_path)
    _configure(source, "ckpt/weights.npz", monkeypatch, stores)
    want = str(tmp_path / "ckpt" / "weights.npz")
    assert tvo.htdemucs_checkpoint_path() == jvo.htdemucs_checkpoint_path() \
        == want
    _configure(source, "bundled", monkeypatch, stores)
    assert tvo.htdemucs_checkpoint_path() == tvo.BUNDLED
    assert jvo.htdemucs_checkpoint_path().endswith(
        "amw_tpu/models/checkpoints/htdemucs_tiny")


def test_checkpoint_sources_in_the_reference_order(stores, monkeypatch,
                                                   tmp_path):
    """``AMW_HTDEMUCS_CKPT`` first, then the database row, then the
    settings' environment, in both packages."""
    monkeypatch.setenv("AMW_HTDEMUCS_CHECKPOINT", str(tmp_path / "env"))
    stores()
    for store in (jstore, tstore):
        store.set_setting("htdemucs_checkpoint", str(tmp_path / "db"))
    monkeypatch.setenv("AMW_HTDEMUCS_CKPT", str(tmp_path / "ckpt"))
    for mod in (jvo, tvo):
        assert mod.htdemucs_checkpoint_path() == str(tmp_path / "ckpt")
    monkeypatch.delenv("AMW_HTDEMUCS_CKPT")
    for mod in (jvo, tvo):
        assert mod.htdemucs_checkpoint_path() == str(tmp_path / "db")
    for store in (jstore, tstore):
        store.set_setting("htdemucs_checkpoint", None)
    for mod in (jvo, tvo):
        assert mod.htdemucs_checkpoint_path() == str(tmp_path / "env")


def _song(n, seed=0):
    """A 'vocal' (vibrato tone with harmonics) over bass, a pad and noise."""
    g = np.random.default_rng(seed)
    t = np.arange(n) / SR
    f0 = 220 + 3 * np.sin(2 * np.pi * 5.5 * t)
    ph = 2 * np.pi * np.cumsum(f0) / SR
    voc = 0.2 * (np.sin(ph) + 0.5 * np.sin(2 * ph) + 0.3 * np.sin(3 * ph))
    bass = 0.25 * np.sin(2 * np.pi * 55 * t)
    pad = 0.05 * g.standard_normal((2, n))
    return np.clip(voc + bass + pad, -0.99, 0.99).astype(np.float32)


@pytest.mark.parametrize("channels", [2, 1], ids=["stereo", "mono"])
def test_isolate_vocal_bundled_matches_jax(channels, monkeypatch):
    """The network on the bundled checkpoint: a 3 s 44.1 kHz track through
    both packages' ``isolate_vocal`` (resampled to the model's 8 kHz and
    back on the host)."""
    monkeypatch.setenv("AMW_HTDEMUCS_CKPT", "bundled")
    x = _song(3 * SR, seed=6)[:channels]
    want = np.asarray(jvo.isolate_vocal(x, SR))
    got = tvo.isolate_vocal(x, SR, device="cpu")
    assert got.shape == want.shape == x.shape and got.dtype == np.float32
    assert db(float(np.max(np.abs(got - want)))) <= BAR_DBFS
    assert abs(refimpl.integrated_lufs(got, SR)
               - refimpl.integrated_lufs(want, SR)) <= BAR_LU
    dsp = tvo.isolate_vocal(x, SR, model="dsp", device="cpu")
    assert db(float(np.max(np.abs(got - dsp)))) > -40.0  # not the DSP path


def test_bundled_checkpoint_separates_on_the_cpu(monkeypatch):
    """The separation gate on the port's converted checkpoint, f32 on the
    CPU, loaded as the separator loads it."""
    monkeypatch.setenv("AMW_HTDEMUCS_CKPT", "bundled")
    cfg, model = tvo._htdemucs(torch.device("cpu"))
    assert next(model.parameters()).dtype == torch.float32
    s_model, s_mix = htdemucs_gate.vocals_snr(model)
    assert htdemucs_gate.passes(s_model, s_mix), (s_model, s_mix)


def test_weights_stay_loaded_per_path_and_dtype(monkeypatch, tmp_path):
    """One copy of the weights a (path, device, dtype); a new path drops
    the old one's."""
    monkeypatch.setenv("AMW_HTDEMUCS_CKPT", "bundled")
    monkeypatch.setattr(tvo, "_ht_cache", {})
    cpu = torch.device("cpu")
    first = tvo._htdemucs(cpu)
    assert tvo._htdemucs(cpu) is first
    monkeypatch.setenv("AMW_HTDEMUCS_DTYPE", "bf16")
    second = tvo._htdemucs(cpu)
    assert second is not first and len(tvo._ht_cache) == 2
    assert next(second[1].parameters()).dtype == torch.bfloat16
    cfg, state = ht.load_params(tvo.BUNDLED)
    other = str(tmp_path / "copy.npz")
    ht.save_params(state, other, cfg)
    monkeypatch.setenv("AMW_HTDEMUCS_CKPT", other)
    tvo._htdemucs(cpu)
    assert [k[0] for k in tvo._ht_cache] == [other]


@pytest.mark.parametrize("kind", ["missing", "corrupt", "wrong_tree"])
def test_unloadable_checkpoint_falls_back_to_dsp(kind, monkeypatch, tmp_path,
                                                 caplog):
    """A configured checkpoint that does not load: the DSP separator runs,
    with a logged warning, and nothing is cached (as ``_htdemucs`` in the
    JAX package)."""
    path = tmp_path / "weights.npz"
    if kind == "corrupt":
        path.write_bytes(b"not a zip archive")
    elif kind == "wrong_tree":
        cfg, state = ht.load_params(tvo.BUNDLED)
        state.pop("encoder.0.conv.weight")
        ht.save_params(state, str(path), cfg)
    monkeypatch.setenv("AMW_HTDEMUCS_CKPT", str(path))
    monkeypatch.setattr(tvo, "_ht_cache", {})
    x = _mix(LENGTHS[1], seed=8)
    with caplog.at_level(logging.WARNING, logger=tvo.__name__):
        got = tvo.isolate_vocal(x, SR, device="cpu")
        assert tvo.warmup_htdemucs((10.0,), device="cpu") == 0
    assert "does not load" in caplog.text and not tvo._ht_cache
    want = tvo.isolate_vocal(x, SR, model="dsp", device="cpu")
    np.testing.assert_array_equal(got, want)


def test_warmup_counts_buckets_as_jax(monkeypatch):
    """The engine's warmup returns the JAX package's number of window-group
    buckets (``oa_plan``'s ``nb_b``) for the same durations; 0 without a
    checkpoint in both."""
    monkeypatch.delenv("AMW_HTDEMUCS_CKPT", raising=False)
    assert tvo.warmup_htdemucs((1.0,), device="cpu") == 0
    assert jvo.warmup_htdemucs((1.0,)) == 0
    monkeypatch.setenv("AMW_HTDEMUCS_CKPT", "bundled")
    durations = (1.0, 2.0, 4.0, 7.0, 4.5)
    jcfg, _ = jvo._htdemucs()
    want = len({hj.oa_plan(jcfg, int(jcfg.samplerate * d))[3]
                for d in durations})
    assert want == 3
    assert tvo.warmup_htdemucs(durations, device="cpu") == want
