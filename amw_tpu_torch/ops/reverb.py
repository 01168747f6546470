"""Schroeder reverb as a convolution with a precomputed impulse response
(counterpart of ``amw_tpu/ops/reverb.py``).

The reference runs per-sample comb and allpass recurrences
(pipeline.py:1065-1176).  They are linear and time-invariant, so the wet
impulse response is built on the host analytically (a comb: ``g^k`` at
lags ``k·d``; an allpass: ``-g``, then ``g^(k-1)(1 - g²)`` at lags
``k·d``), truncated at 1e-9, and convolved on the device with
``torch.fft`` (cuFFT on the GPU) at ``fft_staged.site_plan``'s size, as
the JAX package convolves with XLA's FFT.  The wet signal's peak
normalisation (pipeline.py:1126-1128) is per row and runs on the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..constants import REVERB_PRESETS
from ..spec import GraphSpec
from . import fft_staged, validctx
from .stereo import ms_decode, ms_encode

_EPS = 1e-9


def _comb_ir(d: int, g: float, max_len: int) -> np.ndarray:
    k_max = (int(np.ceil(np.log(_EPS) / np.log(max(abs(g), 1e-12))))
             if abs(g) < 1 else max_len // d)
    k_max = min(k_max, (max_len - 1) // d)
    ir = np.zeros(k_max * d + 1)
    ir[::d] = g ** np.arange(k_max + 1)
    return ir


def _allpass_ir(d: int, g: float, max_len: int) -> np.ndarray:
    k_max = (int(np.ceil(np.log(_EPS) / np.log(max(abs(g), 1e-12))))
             if abs(g) < 1 else max_len // d)
    k_max = min(max(k_max, 1), (max_len - 1) // d)
    ir = np.zeros(k_max * d + 1)
    ir[0] = -g
    k = np.arange(1, k_max + 1)
    ir[k * d] = (g ** (k - 1)) * (1.0 - g * g)
    return ir


@functools.lru_cache(maxsize=None)
def wet_ir(sr: int, n: int, reverb_type: str, decay_sec: float) -> np.ndarray:
    """The wet impulse response of a preset (float32, host), truncated to
    ``n`` samples: only the first ``n`` samples of the convolution are
    observable downstream.  Cached, and read-only for that reason."""
    from scipy.signal import fftconvolve

    preset = REVERB_PRESETS.get(reverb_type, REVERB_PRESETS["plate"])
    decay = decay_sec if decay_sec > 0 else preset[0]
    comb_d, comb_g, ap_d, ap_g = preset[1], preset[2], preset[3], preset[4]
    decay_per_sec = 0.001 ** (1.0 / max(0.1, decay))
    acc = np.zeros(1)
    for d_ms, g in zip(comb_d, comb_g):
        d = min(int(sr * d_ms / 1000.0), n - 1)
        if d < 1:
            # a degenerate comb passes the input through
            # (pipeline.py:1075-1076)
            ir = np.ones(1)
        else:
            ir = _comb_ir(d, g * (decay_per_sec ** (d_ms / 1000.0)), n)
        merged = np.zeros(max(len(acc), len(ir)))
        merged[: len(acc)] = acc
        merged[: len(ir)] += ir
        acc = merged
    acc = acc / max(len(comb_d), 1)
    for d_ms, g in zip(ap_d, ap_g):
        d = min(int(sr * d_ms / 1000.0), n - 1)
        if d < 1:
            continue
        acc = fftconvolve(acc, _allpass_ir(d, g, n))
    out = acc[:n].astype(np.float32)
    out.setflags(write=False)
    return out


def build_reverb(spec: GraphSpec, reverb_type: str = "plate",
                 decay_sec: float = 1.2, mix: float = 0.15,
                 mix_mid: float | None = None,
                 mix_side: float | None = None, *, device):
    """``(params, fn)``: ``params`` = ``[ir]`` (the wet impulse response,
    so the JAX package's own passes through ``convert.params_from_jax``);
    ``fn(x [..., C, N], params)``.  A stereo signal with ``mix_mid`` or
    ``mix_side`` given is mixed in M/S; otherwise every channel by
    ``mix``, then clipped to [-1, 1].  ``device`` plans the convolution's
    FFT (``fft_staged.site_plan``)."""
    preset = REVERB_PRESETS.get(reverb_type, REVERB_PRESETS["plate"])
    decay = decay_sec if decay_sec > 0 else preset[0]
    ir = wet_ir(spec.sr, spec.n, reverb_type, decay)
    nfft = fft_staged.site_plan(spec.n + len(ir), device)[0]
    use_ms = spec.channels == 2 and (mix_mid is not None
                                     or mix_side is not None)
    m_mid = float(np.clip(mix_mid if mix_mid is not None else mix, 0.0, 1.0))
    m_side = float(np.clip(mix_side if mix_side is not None else mix,
                           0.0, 1.0))

    def _wet(x, ir_dev):
        # the linear convolution cropped to the first n samples (all the
        # recurrence produces), its causal ring-out past the valid end
        # masked so that the peak (and the normalisation it drives) is the
        # exact-length graph's, then each row's peak normalisation
        y = torch.fft.irfft(torch.fft.rfft(x, n=nfft, dim=-1)
                            * torch.fft.rfft(ir_dev, n=nfft),
                            n=nfft, dim=-1)[..., :spec.n]
        y = validctx.mask_tail(y)
        peak = y.abs().amax(dim=-1, keepdim=True)
        scale = torch.where(peak > 1e-6, 1.0 / torch.clamp(peak, max=2.0),
                            1.0)
        return y * scale

    def fn(x, params):
        ir_dev = params[0]
        if use_ms:
            mid, side = ms_encode(x)
            mo = mid * (1.0 - m_mid) + _wet(mid, ir_dev) * m_mid
            so = side * (1.0 - m_side) + _wet(side, ir_dev) * m_side
            return ms_decode(mo, so)
        out = x * (1.0 - mix) + _wet(x, ir_dev) * mix
        return torch.clamp(out, -1.0, 1.0)

    return [ir], fn
