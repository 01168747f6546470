"""Window-metric regression harness for the v2 default chain (counterpart
of ``amw_tpu/qa/mastering_regression.py``).

Mirrors backend/app/qa/mastering_regression.py: run the default chain
*stage by stage* on a device (each module of ``models/chain.
build_chain_ops`` called on its own, so every intermediate buffer can be
read), compute per-time-window metrics — HF RMS above 8 kHz, the largest
absolute first difference, RMS — on the host in float64, and compare them
against the thresholds of
``tests/fixtures/mastering_regression/expected_metrics.json``.  Used by
tests/test_torch_regression_windows.py and ``chip_smoke.py``.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Iterable

import numpy as np
import torch

from .. import resolve_device
from ..convert import to_device
from ..models.chain import build_chain_ops, default_chain_config
from ..ops import basic
from ..spec import GraphSpec

DEFAULT_WINDOWS_SEC: tuple[tuple[str, float, float], ...] = (
    ("intro", 2.0, 10.0),
    ("mid_75_90", 75.0, 90.0),
    ("late_154_160", 154.0, 160.0),
)

_ROOT = Path(__file__).resolve().parent.parent.parent
_FIXTURES = _ROOT / "tests" / "fixtures" / "mastering_regression"


def regression_wav_path() -> Path | None:
    """The regression WAV: ``MM_REGRESSION_WAV`` where set, else the
    fixture ``python -m amw_tpu_torch.scripts.gen_regression_fixture``
    writes from the repository's root; ``None`` where the file is
    missing."""
    env = os.environ.get("MM_REGRESSION_WAV", "").strip()
    if env:
        p = Path(env).expanduser()
        return p if p.is_file() else None
    p = _FIXTURES / "regression.wav"
    return p if p.is_file() else None


def to_mono_float64(audio: np.ndarray) -> np.ndarray:
    a = np.asarray(audio, dtype=np.float64)
    if a.ndim == 1:
        return a
    return np.mean(a, axis=0)  # channel-major [C, N]


def slice_window(mono: np.ndarray, sr: int, t0: float, t1: float) -> np.ndarray:
    i0 = max(0, int(t0 * sr))
    i1 = min(len(mono), int(t1 * sr))
    return mono[i0:i1] if i0 < i1 else mono[:0]


def hf_rms(mono_win: np.ndarray, sr: int, hp_hz: float = 8000.0) -> float:
    if mono_win.size < 32:
        return 0.0
    from scipy import signal as sg

    wn = min(float(hp_hz) / (sr / 2.0), 0.99)
    b, a = sg.butter(2, wn, btype="high", output="ba")
    try:
        hf = sg.filtfilt(b, a, mono_win)
    except ValueError:  # a window too short for filtfilt's padding
        hf = mono_win
    return float(np.sqrt(np.mean(hf * hf) + 1e-20))


def max_abs_first_diff(mono_win: np.ndarray) -> float:
    if mono_win.size < 2:
        return 0.0
    return float(np.max(np.abs(np.diff(mono_win))))


def window_metrics(
    audio: np.ndarray, sr: int,
    windows_sec: Iterable[tuple[str, float, float]] = DEFAULT_WINDOWS_SEC,
) -> dict[str, dict[str, float]]:
    mono = to_mono_float64(audio)
    out: dict[str, dict[str, float]] = {}
    for name, t0, t1 in windows_sec:
        w = slice_window(mono, sr, t0, t1)
        out[name] = {
            "hf_rms": hf_rms(w, sr),
            "max_abs_diff": max_abs_first_diff(w),
            "rms": float(np.sqrt(np.mean(w * w) + 1e-20)) if w.size else 0.0,
            "samples": float(w.size),
        }
    return out


def run_default_chain_stages(
    audio: np.ndarray, sr: int, *,
    target_lufs: float = -14.0, style: str = "standard", device=None,
) -> list[tuple[str, np.ndarray]]:
    """Per-module outputs of the default chain (+ finalize clip + fade-in)
    on ``device`` (default ``cuda``), each copied to the host [C, N]."""
    dev = resolve_device(device)
    a = np.atleast_2d(np.asarray(audio, np.float32))
    spec = GraphSpec(sr=sr, n=a.shape[-1], channels=a.shape[0])
    config = default_chain_config(target_lufs=target_lufs, style=style)
    ids, params, fns, _ = build_chain_ops(
        spec, config, target_lufs=target_lufs, style=style, device=dev)
    stages: list[tuple[str, np.ndarray]] = []
    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(a)).to(dev)[None]
        for mid, p, f in zip(ids, params, fns):
            x = f(x, to_device(p, dev))
            stages.append((mid, x[0].cpu().numpy()))
        x = basic.finalize_clip(x)
        stages.append(("chain_finalize_clip", x[0].cpu().numpy()))
        faded = basic.output_edge_fade_in(x, sr, 6.0)
        stages.append(("v2_output_fade_in", faded[0].cpu().numpy()))
    return stages


def metrics_after_each_stage(
    audio: np.ndarray, sr: int,
    windows_sec: Iterable[tuple[str, float, float]] = DEFAULT_WINDOWS_SEC,
    **chain_kw: Any,
) -> list[dict[str, Any]]:
    return [
        {"stage": sid, "windows": window_metrics(buf, sr, windows_sec)}
        for sid, buf in run_default_chain_stages(audio, sr, **chain_kw)
    ]


def load_expected_thresholds() -> dict[str, Any] | None:
    p = _FIXTURES / "expected_metrics.json"
    if not p.is_file():
        return None
    try:
        return json.loads(p.read_text(encoding="utf-8"))
    except (OSError, ValueError):
        return None
