"""The port's stage-by-stage regression harness
(``amw_tpu_torch/qa/mastering_regression.py``) against
``amw_tpu.qa.mastering_regression`` on the CPU: the same stage list, every
stage's output within −90 dBFS of the JAX package's on
tests/test_regression_windows.py's 48 s synthetic input, and that file's
thresholds on the port's rows."""

import numpy as np
import pytest

from amw_tpu.qa import mastering_regression as jmr
from amw_tpu_torch.qa import mastering_regression as tmr

SR = 44100
WINDOWS = (("intro", 2.0, 10.0), ("mid", 20.0, 35.0), ("late", 40.0, 46.0))


def _synthetic_noise(dur_sec=48.0, sr=SR, seed=5):
    g = np.random.default_rng(seed)
    n = int(dur_sec * sr)
    t = np.arange(n) / sr
    base = 0.2 * np.sin(2 * np.pi * 180 * t) + 0.05 * g.standard_normal(n)
    x = np.clip(base, -1, 1).astype(np.float32)
    return np.stack([x, 0.9 * x])


@pytest.fixture(scope="module")
def stages():
    audio = _synthetic_noise()
    return (audio, tmr.run_default_chain_stages(audio, SR, device="cpu"),
            jmr.run_default_chain_stages(audio, SR))


def test_stage_list_equals_jax(stages):
    _, got, want = stages
    assert [s for s, _ in got] == [s for s, _ in want]


def test_every_stage_matches_jax(stages):
    _, got, want = stages
    for (sid, y), (_, y_j) in zip(got, want):
        assert y.shape == y_j.shape, sid
        err = np.max(np.abs(y.astype(np.float64) - y_j))
        assert 20 * np.log10(max(err, 1e-12)) < -90.0, (sid, err)


@pytest.fixture(scope="module")
def stage_rows(stages):
    audio, got, _ = stages
    return audio, [{"stage": sid, "windows": tmr.window_metrics(buf, SR,
                                                                WINDOWS)}
                   for sid, buf in got]


def test_window_metrics_equal_jax(stage_rows):
    """The host metrics are the JAX package's functions, copied: equal on
    the same buffer."""
    audio, _ = stage_rows
    assert tmr.window_metrics(audio, SR, WINDOWS) == jmr.window_metrics(
        audio, SR, WINDOWS)


def test_stage_list_complete(stage_rows):
    _, rows = stage_rows
    ids = [r["stage"] for r in rows]
    assert ids[0] in ("dc_offset", "dc_offset+peak_guard")
    assert ids[-2:] == ["chain_finalize_clip", "v2_output_fade_in"]
    assert any("dynamics" in s for s in ids)
    assert any(s == "normalize_lufs" or s.startswith("normalize_lufs+")
               for s in ids)


def test_hf_not_blown_up(stage_rows):
    audio, rows = stage_rows
    in_metrics = tmr.window_metrics(audio, SR, WINDOWS)
    out_metrics = rows[-1]["windows"]
    for name in out_metrics:
        hf_in = max(in_metrics[name]["hf_rms"], 1e-9)
        assert out_metrics[name]["hf_rms"] / hf_in < 80.0, name


def test_no_sample_discontinuities(stage_rows):
    _, rows = stage_rows
    for row in rows:
        for name, m in row["windows"].items():
            assert m["max_abs_diff"] < 1.5, (row["stage"], name, m)


def test_output_rms_reasonable(stage_rows):
    _, rows = stage_rows
    for name, m in rows[-1]["windows"].items():
        assert 1e-4 < m["rms"] < 1.0, (name, m)


def test_fixture_paths_are_the_jax_packages(monkeypatch, tmp_path):
    """The same thresholds file, and the same regression WAV lookup."""
    assert tmr.load_expected_thresholds() == jmr.load_expected_thresholds()
    assert tmr.load_expected_thresholds()["hf_ratio_limit"] > 0
    p = tmp_path / "r.wav"
    p.write_bytes(b"RIFF")
    monkeypatch.setenv("MM_REGRESSION_WAV", str(p))
    assert tmr.regression_wav_path() == jmr.regression_wav_path() == p
    monkeypatch.setenv("MM_REGRESSION_WAV", str(tmp_path / "missing.wav"))
    assert tmr.regression_wav_path() is None


def test_default_device_is_cuda(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tmr.run_default_chain_stages(np.zeros((2, SR), np.float32), SR)
