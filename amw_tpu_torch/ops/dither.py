"""Dither noise and 16-bit quantization on the device (counterpart of
``amw_tpu/ops/dither.py``).

Reference: backend/app/pipeline.py:830-899.  TPDF is the sum of two
uniforms minus 1 (1 LSB); ``ns_e`` is white noise through the one-pole
high pass ``y = x - x[n-1] + 0.99·y[n-1]`` (×0.9), ``ns_itu`` white noise
through the two-pole high pass ``b = [1, -2, 1], a = [1, -1.96, 0.9604]``
(×0.9).  The shaping filters are linear, so they run as a causal
frequency-domain filter on ``torch.fft`` (:func:`shape_noise`).  The draws
come from the caller's ``torch.Generator``, so parity with the reference
and with the JAX package (its counter-based PRNG) is statistical, not
bitwise; the shaping of given white noise matches exactly.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import design, fft_staged
from .zphase import pack_complex, unpack_complex

_NS_SETTLE = {"ns_e": 2000, "ns_itu": 4000}
_NS_MIN_N = {"ns_e": 4, "ns_itu": 8}


@functools.lru_cache(maxsize=None)
def _ns_response(kind: str, nfft: int, device: torch.device) -> torch.Tensor:
    """The shaping filter's response on the rFFT grid of ``nfft``, rounded
    to float32 planes as the JAX package packs it, as a complex tensor on
    ``device`` (cached: made once a plan)."""
    if kind == "ns_e":
        b, a = (1.0, -1.0), (1.0, -0.99)
    elif kind == "ns_itu":
        b, a = (1.0, -2.0, 1.0), (1.0, -1.96, 0.9604)
    else:
        raise ValueError(kind)
    packed = pack_complex(design.freqz(np.asarray(b), np.asarray(a), nfft))
    return unpack_complex(torch.from_numpy(packed).to(device))


def shape_noise(white: torch.Tensor, dither_type: str) -> torch.Tensor:
    """White noise in [-1, 1) [..., N] through the ``ns_e`` or ``ns_itu``
    high pass (zero initial state), times 0.9: the deterministic half of
    :func:`dither_noise`."""
    n = white.shape[-1]
    nfft = fft_staged.site_plan(n + _NS_SETTLE[dither_type],
                                white.device)[0]
    H = _ns_response(dither_type, nfft, white.device)
    y = torch.fft.irfft(torch.fft.rfft(white, n=nfft, dim=-1) * H, n=nfft,
                        dim=-1)[..., :n]
    return y * 0.9


def dither_noise(generator: torch.Generator, shape, dither_type: str = "tpdf",
                 *, device=None) -> torch.Tensor:
    """Dither noise in LSB units for a [..., N] signal, drawn from
    ``generator`` (which must live on ``device``, default ``cuda``).
    ``tpdf``, and ``ns_e`` / ``ns_itu`` under 4 / 8 samples: two uniform
    draws minus 1; otherwise 2·uniform - 1 shaped by :func:`shape_noise`."""
    from .. import resolve_device

    dev = resolve_device(device)
    shape = tuple(shape)
    if dither_type == "tpdf" or shape[-1] < _NS_MIN_N.get(dither_type, 8):
        u1 = torch.rand(shape, generator=generator, device=dev)
        u2 = torch.rand(shape, generator=generator, device=dev)
        return u1 + u2 - 1.0
    if dither_type not in _NS_SETTLE:
        raise ValueError(dither_type)
    white = 2.0 * torch.rand(shape, generator=generator, device=dev) - 1.0
    return shape_noise(white, dither_type)


def quantize16(x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """float [-1, 1] -> int16 with additive dither in LSB
    (pipeline.py:880-899); rounds half to even, as ``jnp.round``."""
    x = torch.nan_to_num(x, nan=0.0, posinf=1.0, neginf=-1.0)
    x = torch.clamp(x, -1.0, 1.0)
    d = x * 32767.0 + noise
    d = torch.nan_to_num(d, nan=0.0, posinf=32767.0, neginf=-32768.0)
    return torch.clamp(torch.round(d), -32768, 32767).to(torch.int16)
