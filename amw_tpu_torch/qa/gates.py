"""Host meters of the operator tools: integrated loudness, true peak and
loudness normalization of one numpy track ``[C, N]`` (or ``[N]``), each
measured on a device.

The JAX package's scripts take these from its numpy oracle
(``refimpl.integrated_lufs``, ``true_peak_dbfs``, ``normalize_lufs``);
the port builds them from its own meters (``ops/meters``): the
K-weighting response at the device's FFT plan
(``fft_staged.site_plan``, as the graphs' normalizer plans it), the
pyloudnorm block framing and the two-stage gate, and the 4x oversampled
peak.  Each runs on ``device`` (``cuda`` unless given; raises without a
GPU) and returns Python floats / a float32 array, with the oracle's
conventions: a track gated away entirely measures ``-inf`` LUFS, and
normalizing it leaves it as it is.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops import fft_staged, meters

_GATED = -5e8  # meters.gated_loudness reports -1e9 when every block is gated


def _track(x, device) -> torch.Tensor:
    dev = resolve_device(device)
    a = np.atleast_2d(np.asarray(x, np.float32))
    return torch.from_numpy(np.ascontiguousarray(a)).to(dev)


def _lufs(t: torch.Tensor, sr: int) -> torch.Tensor:
    n = t.shape[-1]
    nfft = fft_staged.site_plan(n + meters.k_weight_settle(sr), t.device)[0]
    Hk = torch.from_numpy(meters.k_weight_response(sr, nfft)).to(t.device)
    with torch.no_grad():
        return meters.integrated_lufs(t, Hk, nfft, meters.plan_blocks(sr, n))


def integrated_lufs(x, sr: int, *, device=None) -> float:
    """BS.1770 integrated loudness of ``x`` in LUFS (``-inf`` where every
    block is gated)."""
    v = float(_lufs(_track(x, device), sr))
    return v if v > _GATED else float("-inf")


def true_peak_dbfs(x, sr: int, *, device=None) -> float:
    """The largest 4x oversampled sample magnitude in dBTP (``sr`` is the
    oracle's argument: the oversampling is 4x at any rate)."""
    with torch.no_grad():
        return float(meters.true_peak_dbfs(_track(x, device)))


def normalize_lufs(x, sr: int, target_lufs: float, *,
                   device=None) -> np.ndarray:
    """``x`` scaled to ``target_lufs`` by one gain, clamped to ±20 dB;
    unchanged where its loudness is not measurable."""
    t = _track(x, device)
    gain = float(meters.normalize_lufs_gain(_lufs(t, sr), target_lufs))
    return (np.asarray(x, np.float32) * np.float32(gain)).astype(np.float32)
