"""The port's serving engine (``amw_tpu_torch.runtime.engine``) against the
JAX package's (``amw_tpu.runtime.engine``) on the same upload bytes, on
the CPU: the v2 job (``master_v2_bytes``).

Both engines run without the micro-batcher (the JAX one, over the test
suite's 8 virtual CPU devices, would otherwise shard its batches).  The
tracks are 22 050 Hz and 2.5 s (exact length, under ``MIN_BUCKET_SEC``)
or 4 s (padded to the 15 s bucket), each engine made once for the file.

Bars: float32 WAV output within -90 dBFS of JAX's and the loudness before
and after within 0.01 LU; the dithered 16-bit WAV within 2.5/32768 (the
draws differ: TPDF noise in (-1, 1) LSB on each side).
"""

import tempfile

import numpy as np
import pytest

from amw_tpu.runtime import config as jconfig
from amw_tpu.runtime import db
from amw_tpu.runtime.engine import MasteringEngine as JaxEngine
from amw_tpu.runtime.engine import ValidationError as JaxValidationError
from amw_tpu.utils import wav as jwav
from amw_tpu_torch.runtime import config as tconfig
from amw_tpu_torch.runtime import db as tdb
from amw_tpu_torch.runtime import settings_store as tstore
from amw_tpu_torch.runtime.engine import MasteringEngine, ValidationError
from amw_tpu_torch.utils import wav as twav

SR = 22050
BAR_DBFS = -90.0
METER_LU = 0.01
WAV16_BAR = 2.5 / 32768
# the pro panel's stages but the denoiser and the vocal separator
PRO = {"rumble_enabled": True, "rumble_cutoff": 60.0,
       "deesser_enabled": True, "transient_attack": 1.3,
       "transient_sustain": 0.85, "parallel_mix": 0.25,
       "dynamic_eq_enabled": True}


def track(dur, seed=0, channels=2):
    g = np.random.default_rng(seed)
    n = int(SR * dur)
    t = np.arange(n) / SR
    x = (0.3 * np.sin(2 * np.pi * 220 * t)
         + 0.1 * np.sin(2 * np.pi * 3100 * t)
         + 0.05 * g.standard_normal(n)).astype(np.float32)
    return np.clip(np.stack([x, 0.8 * x])[:channels], -1, 1)


def upload(x):
    return twav.write_wav_int16((x * 32767).astype(np.int16), SR)


@pytest.fixture(scope="module")
def engines():
    tmp = tempfile.NamedTemporaryFile(suffix=".sqlite3")
    tmp_port = tempfile.NamedTemporaryFile(suffix=".sqlite3")
    db.set_db_path(tmp.name)  # the JAX engine's settings store
    tdb.set_db_path(tmp_port.name)  # the port's
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("AMW_HTDEMUCS_CKPT", raising=False)
        mp.setattr(jconfig.settings, "vocal_isolation_enabled", True)
        mp.setattr(tconfig.settings, "vocal_isolation_enabled", True)
        port = MasteringEngine(micro_batch=False, device="cpu")
        yield JaxEngine(micro_batch=False), port
        port.close()
    tmp.close()
    tmp_port.close()


def _both(engines, data, **kw):
    jax_eng, port = engines
    return (jax_eng.master_v2_bytes(data, "t.wav", **kw),
            port.master_v2_bytes(data, "t.wav", **kw))


def _db(a, b):
    return 20 * np.log10(max(float(np.max(np.abs(a - b))), 1e-30))


CASES = {
    "exact": (2.5, {}),
    "bucket_15s": (4.0, {}),
    "pro": (2.5, PRO),
    "vocal_isolation": (2.5, {"apply_vocal_isolation": True}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_v2_wav32f_matches_jax(engines, case):
    dur, pro = CASES[case]
    x = track(dur, seed=1)
    want, got = _both(engines, upload(x), target_lufs=-14.0,
                      out_format="wav32f", pro=dict(pro))
    a, sr = twav.read_wav(got["bytes"])
    b, _ = jwav.read_wav(want["bytes"])
    assert sr == got["sr"] == want["sr"] == SR
    assert a.shape == b.shape == x.shape
    assert _db(a, b) <= BAR_DBFS, case
    for k in ("before_lufs", "after_lufs"):
        assert abs(got[k] - want[k]) <= METER_LU, (case, k)
    assert sorted(got) == ["after_lufs", "before_lufs", "bytes", "sr"]


def test_v2_dithered_wav_matches_jax(engines):
    x = track(2.5, seed=2)
    want, got = _both(engines, upload(x), target_lufs=-14.0, pro={})
    a, _ = twav.read_wav(got["bytes"])
    b, _ = jwav.read_wav(want["bytes"])
    assert a.shape == b.shape == x.shape
    assert float(np.max(np.abs(a - b))) <= WAV16_BAR
    assert abs(got["after_lufs"] - want["after_lufs"]) <= METER_LU


def test_v2_auto_blank_and_mono_match_jax(engines):
    """A mono track whose last second is silent, with auto-blank at 0.2 s:
    both engines trim it to the same length."""
    x = track(2.5, seed=3, channels=1)
    x[:, -SR:] = 0.0
    want, got = _both(engines, upload(x), target_lufs=-16.0, pro={},
                      out_format="wav32f", auto_blank_sec=0.2)
    a, _ = twav.read_wav(got["bytes"])
    b, _ = jwav.read_wav(want["bytes"])
    assert a.shape == b.shape and a.shape[-1] < x.shape[-1]
    assert _db(a, b) <= BAR_DBFS


def test_silence_raises_validation_error(engines):
    jax_eng, port = engines
    data = upload(np.zeros((2, int(2.5 * SR)), np.float32))
    with pytest.raises(JaxValidationError, match="silence"):
        jax_eng.master_v2_bytes(data, "t.wav", target_lufs=-14.0, pro={})
    with pytest.raises(ValidationError, match="silence"):
        port.master_v2_bytes(data, "t.wav", target_lufs=-14.0, pro={})


def test_vocal_isolation_disabled_raises(engines, monkeypatch):
    jax_eng, port = engines
    monkeypatch.setattr(jconfig.settings, "vocal_isolation_enabled", False)
    monkeypatch.setattr(tconfig.settings, "vocal_isolation_enabled", False)
    data = upload(track(2.5))
    for eng in (jax_eng, port):
        with pytest.raises(RuntimeError, match="disabled"):
            eng.master_v2_bytes(data, "t.wav", target_lufs=-14.0,
                                pro={"apply_vocal_isolation": True})


@pytest.mark.parametrize("override", ["false", "true"])
def test_vocal_isolation_database_override(engines, monkeypatch, override):
    """Both engines read the settings store's ``vocal_isolation_enabled``
    before the env setting: the override off with the setting on raises
    in both; on with the setting off, both run the separator."""
    from amw_tpu.runtime import settings_store as jstore

    jax_eng, port = engines
    env_on = override == "false"
    monkeypatch.setattr(jconfig.settings, "vocal_isolation_enabled", env_on)
    monkeypatch.setattr(tconfig.settings, "vocal_isolation_enabled", env_on)
    jstore.set_setting("vocal_isolation_enabled", override)
    tstore.set_setting("vocal_isolation_enabled", override)
    try:
        data = upload(track(2.5, seed=4))
        kw = dict(target_lufs=-14.0, out_format="wav32f",
                  pro={"apply_vocal_isolation": True})
        if override == "false":
            for eng in (jax_eng, port):
                with pytest.raises(RuntimeError,
                                   match="Vocal isolation is disabled"):
                    eng.master_v2_bytes(data, "t.wav", **kw)
        else:
            want, got = _both(engines, data, **kw)
            a, _ = twav.read_wav(got["bytes"])
            b, _ = jwav.read_wav(want["bytes"])
            assert a.shape == b.shape and _db(a, b) <= BAR_DBFS
            assert abs(got["after_lufs"] - want["after_lufs"]) <= METER_LU
    finally:
        jstore.set_setting("vocal_isolation_enabled", None)
        tstore.set_setting("vocal_isolation_enabled", None)


def test_vocal_isolation_runs_the_network(engines, monkeypatch):
    """With the database row ``htdemucs_checkpoint = bundled`` in each
    package's settings store, both engines separate with the network on
    their own copy of the bundled checkpoint before the v2 graph; the
    outputs agree at the v2 bars, and the port's is not its DSP one."""
    from amw_tpu.runtime import settings_store as jstore
    from amw_tpu_torch.models import vocal as tvo

    monkeypatch.setattr(tvo, "_ht_cache", {})
    data = upload(track(2.5, seed=6))
    kw = dict(target_lufs=-14.0, out_format="wav32f",
              pro={"apply_vocal_isolation": True})
    _, port = engines
    dsp = port.master_v2_bytes(data, "t.wav", **kw)
    for store in (jstore, tstore):
        store.set_setting("htdemucs_checkpoint", "bundled")
    try:
        want, got = _both(engines, data, **kw)
    finally:
        for store in (jstore, tstore):
            store.set_setting("htdemucs_checkpoint", None)
    assert [k[0] for k in tvo._ht_cache] == [tvo.BUNDLED]
    a, _ = twav.read_wav(got["bytes"])
    b, _ = jwav.read_wav(want["bytes"])
    c, _ = twav.read_wav(dsp["bytes"])
    assert a.shape == b.shape and _db(a, b) <= BAR_DBFS
    assert abs(got["after_lufs"] - want["after_lufs"]) <= METER_LU
    assert abs(got["before_lufs"] - want["before_lufs"]) <= METER_LU
    assert _db(a, c) > -40.0
