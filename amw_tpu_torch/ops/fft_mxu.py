"""The matmul FFT route (``AMW_FFT_MXU=1``): Cooley-Tukey with the small
DFTs as matrix products (counterpart of ``amw_tpu/ops/fft_mxu.py``).

The four-step decomposition, recursive: a length-n transform is an
A × B grid (A the largest power of two ≤ 128 that divides n), B-point
transforms down the columns, a twiddle multiply, A-point transforms along
the rows, and a transpose; a transform of at most 128 points is one
product with its DFT matrix.  Complex values travel as separate float32
(re, im) planes, so each product is four real ones.  :func:`rfft_mxu`
and :func:`irfft_mxu` pack a real signal into a half-length complex one.
Powers of two only; ``fdfilter._apply_response`` takes this route for
power-of-two plans of 2^16 and more when ``AMW_FFT_MXU`` is ``"1"``.

The JAX module has no ``pallas_call``: its products are XLA's einsums
and its twiddles elementwise ops, so the port has no hand kernel here
either: the products are ``torch.matmul`` (cuBLAS on the card) and the
rest PyTorch's elementwise kernels.  They run in full float32
(:func:`amw_tpu_torch.precision.full_f32`, TF32 off whatever the
process's switches): TF32's 10-bit mantissa would put each 128-point
stage near 1e-3 relative error, far outside the chain's −90 dBFS bar.

The DFT and twiddle tables are computed in float64 with numpy and cast
to float32, as in the JAX module, and kept per (n, sign, device).  The
route's time on the card against cuFFT is in ``PERF.md``
(``chip_smoke.py``'s ``mxu`` phase).
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..precision import full_f32

_BASE = 128  # largest DFT evaluated directly as a matmul


def _planes(cos_sin, device) -> tuple:
    return tuple(torch.from_numpy(a).to(device) for a in cos_sin)


@functools.lru_cache(maxsize=None)
def _dft_mats(n: int, sign: float, device: torch.device) -> tuple:
    k = np.arange(n)
    ang = sign * 2.0 * np.pi * np.outer(k, k) / n
    return _planes((np.cos(ang).astype(np.float32),
                    np.sin(ang).astype(np.float32)), device)


@functools.lru_cache(maxsize=None)
def _twiddles(a: int, b: int, sign: float, device: torch.device) -> tuple:
    """W[n1, k2] = exp(sign · 2πi · k2 · n1 / (a·b)), n1 in [a], k2 in [b]
    (the JAX module's table, transposed as its ``_cfft`` uses it)."""
    ang = sign * 2.0 * np.pi * np.outer(np.arange(b), np.arange(a)) / (a * b)
    return _planes((np.ascontiguousarray(np.cos(ang).astype(np.float32).T),
                    np.ascontiguousarray(np.sin(ang).astype(np.float32).T)),
                   device)


def _split(n: int) -> tuple[int, int]:
    """Factor n = A*B with A the largest power-of-two <= _BASE."""
    a = min(_BASE, n)
    while n % a:
        a //= 2
    return a, n // a


def _cfft(re, im, n: int, sign: float):
    """Complex FFT over the last axis (length n, power of two)."""
    if n <= _BASE:
        cr, ci = _dft_mats(n, sign, re.device)
        return re @ cr - im @ ci, re @ ci + im @ cr
    a, b = _split(n)
    lead = re.shape[:-1]
    # x[n1 + a*n2] -> xr[..., n2, n1]; FFT_b over n2 (moved last)
    xr = re.reshape(lead + (b, a))
    xi = im.reshape(lead + (b, a))
    yr, yi = _cfft(xr.transpose(-1, -2), xi.transpose(-1, -2), b, sign)
    # [..., n1, k2] times the twiddle W[n1, k2]
    twr, twi = _twiddles(a, b, sign, re.device)
    zr = yr * twr - yi * twi
    zi = yr * twi + yi * twr
    # FFT_a over n1 (moved last): [..., k2, k1]; X[k2 + b*k1]
    wr, wi = _cfft(zr.transpose(-1, -2), zi.transpose(-1, -2), a, sign)
    return (wr.transpose(-1, -2).reshape(lead + (n,)),
            wi.transpose(-1, -2).reshape(lead + (n,)))


def cfft_mxu(re, im, inverse: bool = False):
    """Complex FFT of (re, im) over the last axis, a power of two; the
    inverse scaled by 1/n."""
    n = re.shape[-1]
    sign = 1.0 if inverse else -1.0
    with full_f32():
        yr, yi = _cfft(re, im, n, sign)
    if inverse:
        yr = yr / n
        yi = yi / n
    return yr, yi


@functools.lru_cache(maxsize=None)
def _rfft_unpack_tw(n: int, device: torch.device) -> tuple:
    # e^{-2πik/N} for k = 0..N/2 (N = full real length)
    k = np.arange(n // 2 + 1)
    ang = -2.0 * np.pi * k / n
    return _planes((np.cos(ang).astype(np.float32),
                    np.sin(ang).astype(np.float32)), device)


def rfft_mxu(x: torch.Tensor, nfft: int):
    """Real FFT via a half-length complex FFT: (re, im), each [...,
    nfft//2 + 1].  Pads or crops ``x`` to ``nfft`` first."""
    n = x.shape[-1]
    if n < nfft:
        x = F.pad(x, (0, nfft - n))
    elif n > nfft:
        x = x[..., :nfft]
    zr, zi = cfft_mxu(x[..., 0::2], x[..., 1::2])
    # Z[k], k = 0..h-1; extended with Z[h] = Z[0]
    zr_full = torch.cat([zr, zr[..., :1]], dim=-1)
    zi_full = torch.cat([zi, zi[..., :1]], dim=-1)
    # conj(Z[h-k]) for k = 0..h
    zcr = zr_full.flip(-1)
    zci = -zi_full.flip(-1)
    er = 0.5 * (zr_full + zcr)
    ei = 0.5 * (zi_full + zci)
    orr = 0.5 * (zi_full - zci)
    oi = -0.5 * (zr_full - zcr)
    twr, twi = _rfft_unpack_tw(nfft, x.device)
    # X[k] = E[k] + W^k * O[k] where O = (Z - conjZ)/(2i)
    return er + orr * twr - oi * twi, ei + orr * twi + oi * twr


def irfft_mxu(Xr: torch.Tensor, Xi: torch.Tensor, nfft: int) -> torch.Tensor:
    """Inverse of :func:`rfft_mxu`: (re, im) half spectrum -> real [...,
    nfft]."""
    h = nfft // 2
    twr, twi = _rfft_unpack_tw(nfft, Xr.device)
    # the packed half-length spectrum:
    # E[k] = (X[k] + conj(X[h-k]))/2 ;  O[k] = (X[k] - conj(X[h-k]))/(2 W^k)
    Xcr = Xr.flip(-1)
    Xci = -Xi.flip(-1)
    er = 0.5 * (Xr + Xcr)
    ei = 0.5 * (Xi + Xci)
    dr = 0.5 * (Xr - Xcr)
    di = 0.5 * (Xi - Xci)
    # divide by W^k == multiply by conj(W^k) (|W| = 1)
    orr = dr * twr + di * twi
    oi = di * twr - dr * twi
    # Z[k] = E[k] + i*O[k], k = 0..h-1
    zr = er[..., :h] - oi[..., :h]
    zi = ei[..., :h] + orr[..., :h]
    yr, yi = cfft_mxu(zr, zi, inverse=True)
    return torch.stack([yr, yi], dim=-1).reshape(yr.shape[:-1] + (nfft,))
