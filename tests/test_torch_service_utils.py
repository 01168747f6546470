"""The port's service helpers against the JAX package's on the same
inputs: output branding (``utils/metadata``), the PNG writer and text
renderer (``utils/png``), the share card, the anomaly check, the notifier,
the product knowledge and the AI recommender's rule engine, and the
mastering trace (its loudness by the port's meter, within 0.01 LU of the
JAX package's host oracle).  Bytes are held identical, the loudness to
0.01 LU.
"""

import re
from unittest import mock

import numpy as np
import pytest

from amw_tpu.refimpl import integrated_lufs as oracle_lufs
from amw_tpu.runtime import ai as jai
from amw_tpu.runtime import anomaly as janomaly
from amw_tpu.runtime import db as jdb
from amw_tpu.runtime import jobs as jjobs
from amw_tpu.runtime import knowledge as jknowledge
from amw_tpu.runtime import notifier as jnotifier
from amw_tpu.runtime import share_card as jshare
from amw_tpu.utils import audio_io as jio
from amw_tpu.utils import metadata as jmeta
from amw_tpu.utils import png as jpng
from amw_tpu.utils import trace as jtrace
from amw_tpu_torch.qa import gates as tgates
from amw_tpu_torch.runtime import ai as tai
from amw_tpu_torch.runtime import anomaly as tanomaly
from amw_tpu_torch.runtime import db as tdb
from amw_tpu_torch.runtime import jobs as tjobs
from amw_tpu_torch.runtime import knowledge as tknowledge
from amw_tpu_torch.runtime import notifier as tnotifier
from amw_tpu_torch.runtime import share_card as tshare
from amw_tpu_torch.utils import metadata as tmeta
from amw_tpu_torch.utils import png as tpng
from amw_tpu_torch.utils import trace as ttrace
from amw_tpu_torch.utils import wav

SR = 44100
LU = 0.01


def _track(dur=1.5, seed=0, channels=2):
    g = np.random.default_rng(seed)
    n = int(SR * dur)
    t = np.arange(n) / SR
    x = 0.3 * np.sin(2 * np.pi * 330 * t) + 0.05 * g.standard_normal(n)
    x *= 0.4 + 0.6 * np.abs(np.sin(2 * np.pi * 0.8 * t))
    return np.clip(np.stack([x, 0.8 * x])[:channels], -1, 1).astype(
        np.float32)


def _encoded(fmt):
    if fmt == "wav":
        return wav.write_wav_int16(
            np.round(_track() * 32767).astype(np.int16), SR)
    if fmt != "flac" and not jio.lossy_codec_available():
        pytest.skip("no lossy codec here")
    return jio.export_audio(_track(), SR, fmt, dither_type="none")


def _strip_id3(data):
    """An MP3 stream without its leading ID3v2 tag (the encoder writes
    one; branding then keeps it as it is)."""
    if data[:3] != b"ID3":
        return data
    size = 0
    for b in data[6:10]:
        size = (size << 7) | b
    return data[10 + size:]


@pytest.mark.parametrize("fmt", ["wav", "flac", "mp3", "mp3_untagged", "aac",
                                 "opus"])
def test_branding_is_byte_identical(fmt):
    untagged = fmt == "mp3_untagged"
    fmt = "mp3" if untagged else fmt
    data = _encoded(fmt)
    if untagged:
        data = _strip_id3(data)
        assert data[:3] != b"ID3"
    got, want = tmeta.embed_branding(data, fmt), jmeta.embed_branding(data,
                                                                      fmt)
    assert got == want
    if fmt in ("wav", "flac") or untagged:
        assert got != data
        # a second pass keeps an existing tag in both
        assert tmeta.embed_branding(got, fmt) == jmeta.embed_branding(got,
                                                                      fmt)


@pytest.mark.parametrize("blob", [b"", b"RIFF", b"fLaC\x00", b"ID3xxxx",
                                  b"\x00" * 64])
@pytest.mark.parametrize("fmt", ["wav", "flac", "mp3", None])
def test_branding_of_malformed_input_matches_jax(blob, fmt):
    assert tmeta.embed_branding(blob, fmt) == jmeta.embed_branding(blob, fmt)


def test_png_and_text_are_byte_identical():
    g = np.random.default_rng(1)
    img = g.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    assert tpng.encode_png(img) == jpng.encode_png(img)
    a = np.zeros((60, 400, 3), np.uint8)
    b = a.copy()
    text = "MAGIC 0123456789 +-./:%! ?~ zq"
    tpng.draw_text(a, 3, 5, text, (255, 10, 20), scale=2)
    jpng.draw_text(b, 3, 5, text, (255, 10, 20), scale=2)
    np.testing.assert_array_equal(a, b)
    assert tpng.encode_png(a) == jpng.encode_png(b)


@pytest.mark.parametrize("case", ["wav", "flac", "no_lufs", "empty"])
def test_share_card_is_byte_identical(case):
    job = {"filename": "a_very_long_track_name_for_the_card_mastered.wav",
           "style": "edm", "before_lufs": -21.37, "after_lufs": -9.02}
    if case == "wav":
        job["result_bytes"] = _encoded("wav")
    elif case == "flac":
        job["result_bytes"] = _encoded("flac")
    elif case == "no_lufs":
        job.update(before_lufs=None, result_bytes=b"RIFF broken")
    else:
        job = {}
    got = tshare.render_share_png(job)
    assert got[:8] == b"\x89PNG\r\n\x1a\n"
    assert got == jshare.render_share_png(job)


@pytest.fixture
def dbs(tmp_path):
    jdb.set_db_path(str(tmp_path / "j.sqlite3"))
    tdb.set_db_path(str(tmp_path / "t.sqlite3"))
    with mock.patch.dict(jjobs._jobs, clear=True), \
            mock.patch.dict(tjobs._jobs, clear=True):
        yield


METRICS = [
    {"load_1m": 0.5, "load_5m": 0.4, "mem_total_mb": 64000,
     "mem_available_mb": 32000, "rss_mb": 900, "disk_free_mb": 50000,
     "disk_total_mb": 100000},
    {"load_1m": 12.0, "load_5m": 9.0, "mem_total_mb": 64000,
     "mem_available_mb": 200, "rss_mb": 9000, "disk_free_mb": 150,
     "disk_total_mb": 100000},
]


@pytest.mark.parametrize("metrics", METRICS, ids=["calm", "alarm"])
@pytest.mark.parametrize("errors", [0, 7])
def test_anomalies_match_jax(dbs, monkeypatch, metrics, errors):
    """The same alerts from the same server metrics, job mirror and
    queue."""
    for mod, jobs in ((janomaly, jjobs), (tanomaly, tjobs)):
        monkeypatch.setattr(mod, "server_metrics", lambda: dict(metrics))
        for i in range(12):
            jobs.new_job(f"j{i}", target_lufs=-14.0, style="standard",
                         data=b"", filename="t.wav", out_format="wav")
            if i < errors:
                jobs.update_job(f"j{i}", status="error", error="x")
            elif i < 10:
                jobs.update_job(f"j{i}", status="done")
    assert tanomaly.thresholds() == janomaly.thresholds()
    got = tanomaly.check_anomalies()
    assert got == janomaly.check_anomalies()
    assert bool(got) == (metrics is METRICS[1] or errors > 0)


def test_notifier_sends_nothing_without_a_token(monkeypatch):
    for var in ("MAGIC_MASTER_TELEGRAM_BOT_TOKEN", "AMW_TELEGRAM_BOT_TOKEN",
                "MAGIC_MASTER_TELEGRAM_ADMIN_CHAT_ID",
                "AMW_TELEGRAM_ADMIN_CHAT_ID"):
        monkeypatch.delenv(var, raising=False)
    with mock.patch("urllib.request.urlopen") as urlopen:
        for mod in (jnotifier, tnotifier):
            monkeypatch.setattr(mod, "_last_sent", {})
            assert mod.notify_admin("x", throttle_key="k") is False
            assert mod.notify_admin("x", throttle_key="k") is False
            assert mod.notify_job_error("id", "boom") is False
        assert not urlopen.called


@pytest.mark.parametrize("lang", ["en", "ru"])
def test_knowledge_matches_jax(dbs, lang):
    assert tknowledge.product_knowledge(lang) == \
        jknowledge.product_knowledge(lang)


@pytest.mark.parametrize("analysis", [
    {"lufs": -25.0, "spectrum_bars": [0.6] * 8 + [0.1] * 24,
     "duration_sec": 200, "channels": 2},
    {"lufs": -25.0, "spectrum_bars": [0.1] * 32, "duration_sec": 200},
    {"lufs": -12.0, "duration_sec": 900, "channels": 1},
    {"lufs": -12.0, "duration_sec": 60, "channels": 2},
    {"lufs": None},
    {},
])
def test_recommender_rules_match_jax(dbs, analysis):
    """No LLM configured here: both answer from the rule engine."""
    with mock.patch("urllib.request.urlopen") as urlopen:
        assert tai.recommend_preset(analysis) == jai.recommend_preset(analysis)
        assert not urlopen.called
    assert tai.generate_report(analysis) == jai.generate_report(analysis)


@pytest.mark.parametrize("text", [
    "make it louder and wider with more bass", "podcast speech, quiet",
    "тише и моно, реверб", "lofi", ""])
def test_nl_config_and_chat_rules_match_jax(dbs, text):
    """No LLM configured: the keyword rules and the canned chat reply."""
    with mock.patch("urllib.request.urlopen") as urlopen:
        assert tai.nl_to_config(text) == jai.nl_to_config(text)
        msgs = [{"role": "user", "content": text or "?"}]
        assert tai.chat(msgs) == jai.chat(msgs)
        assert not urlopen.called


def test_ai_limits_match_jax():
    for mod in (jai, tai):
        mod.reset_ai_usage()
    got = []
    for mod in (jai, tai):
        seq = []
        for tier in ("free", "pro", "studio", "other"):
            for _ in range(6):
                seq.append(mod.check_ai_limit(f"ip:{tier}", tier))
                mod.record_ai_usage(f"ip:{tier}")
        got.append(seq)
        mod.reset_ai_usage()
    assert got[1] == got[0]
    assert [s["ok"] for s in got[0][:6]] == [True] * 5 + [False]


def _trace_lines(mod, monkeypatch, audio):
    monkeypatch.setenv("AMW_MASTERING_TRACE", "1")
    monkeypatch.setenv("AMW_MASTERING_TRACE_LUFS_STAGES", "1")
    lines = []
    monkeypatch.setattr(mod.logger, "info",
                        lambda fmt, *args: lines.append(fmt % args))
    ctx = mod.TraceContext.build("id", "t.wav", "v2", style="edm",
                                 target_lufs=-9.0,
                                 pro_params={"b": True, "a": 0.5, "c": 0})
    mod.trace_job_start(ctx)
    mod.trace_stage(ctx, "normalize", audio, SR, gain=1.5)
    mod.trace_chain_modules(ctx, ["dc", "eq"])
    mod.trace_validate_failure(ctx, audio, "clip", SR)
    mod.trace_job_error(ctx, RuntimeError("boom"))
    return lines


@pytest.mark.parametrize("channels,dur", [(2, 3.0), (1, 1.2), (2, 0.2)])
def test_trace_matches_jax(monkeypatch, channels, dur):
    """The same lines, but the stage's loudness: the port's meter on a CPU
    tensor within 0.01 LU of the JAX package's oracle (a track under one
    gating block has no loudness in either)."""
    audio = _track(dur, seed=4, channels=channels)
    got = _trace_lines(ttrace, monkeypatch, audio)
    want = _trace_lines(jtrace, monkeypatch, audio)
    lufs = re.compile(r" lufs=(\S+)")
    assert [lufs.sub("", g) for g in got] == [lufs.sub("", w) for w in want]
    lg = [float(m) for g in got for m in lufs.findall(g)]
    lw = [float(m) for w in want for m in lufs.findall(w)]
    assert len(lg) == len(lw) == (1 if dur > 0.4 else 0)
    for a, b in zip(lg, lw):
        assert abs(a - b) <= LU
    if dur > 0.4:
        assert abs(tgates.integrated_lufs(audio, SR, device="cpu")
                   - oracle_lufs(audio, SR)) <= LU
