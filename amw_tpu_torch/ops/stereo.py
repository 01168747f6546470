"""Stereo field ops: M/S encode/decode and the stereo imager (counterpart
of ``amw_tpu/ops/stereo.py``).

Reference: backend/app/ms_utils.py:9-34 and pipeline.py:1329-1398
(``apply_stereo_imager``: M/S width, optional 4-band widths, Haas
stereoize).  Channel axis is ``-2``.
"""

from __future__ import annotations

import torch

from ..spec import GraphSpec
from .bands import band_split_plan


def ms_encode(x: torch.Tensor):
    """[..., 2, N] -> (mid, side), each [..., N]."""
    return ((x[..., 0, :] + x[..., 1, :]) * 0.5,
            (x[..., 0, :] - x[..., 1, :]) * 0.5)


def ms_decode(mid: torch.Tensor, side: torch.Tensor) -> torch.Tensor:
    return torch.stack([(mid + side).clamp(-1.0, 1.0),
                        (mid - side).clamp(-1.0, 1.0)], dim=-2)


def _apply_width(x: torch.Tensor, width: float) -> torch.Tensor:
    mid, side = ms_encode(x)
    return ms_decode(mid, side * width)


def build_stereo_imager(spec: GraphSpec, width: float = 1.0,
                        stereoize_delay_ms: float = 0.0,
                        stereoize_mix: float = 0.12, band_widths=None,
                        crossovers_hz=None, *, device):
    if spec.channels != 2:
        return [], lambda x, params: x

    use_bands = (band_widths is not None and len(band_widths) == 4
                 and spec.sr > 0)
    if use_bands:
        params, split_fn = band_split_plan(spec, crossovers_hz,
                                           device=device)
        widths = tuple(float(band_widths[i]) for i in range(4))
    else:
        params, split_fn, widths = [], None, None

    delay_n = 0
    mix = 0.0
    if stereoize_delay_ms > 0 and spec.sr > 0 and stereoize_mix > 0:
        delay_n = max(0, min(int(spec.sr * stereoize_delay_ms / 1000.0),
                             spec.n - 1))
        mix = min(0.35, max(0.0, float(stereoize_mix)))

    def fn(x, params):
        if use_bands:
            out = sum(_apply_width(band, w)
                      for band, w in zip(split_fn(x, params), widths))
            out = out.clamp(-1.0, 1.0)
        else:
            out = _apply_width(x, width)
        if delay_n > 0 and mix > 0:
            delayed = torch.nn.functional.pad(out[..., :-delay_n],
                                              (delay_n, 0))
            # cross-feed: L gets delayed R and vice versa
            out = (out + mix * delayed.flip(-2)).clamp(-1.0, 1.0)
        return out

    return params, fn
