"""Frequency-domain LTI filtering and the box smoother.

Counterpart of ``amw_tpu/ops/fdfilter.py``.  Every ``scipy.signal.lfilter``
/ ``filtfilt`` / ``fftconvolve`` call of the reference chain maps onto
rFFT → complex multiply → irFFT (``torch.fft``, cuFFT on the GPU; with
``AMW_FFT_MXU=1``, power-of-two plans of 2^16 and more on the matmul FFT
of ``ops/fft_mxu.py``, as in the JAX package):

- :func:`lfilter_fd`   — causal filtering with zero initial state.
- :func:`filtfilt_fd`  — zero-phase forward-backward filtering with scipy's
                         odd extension and steady-state initialisation
                         (``exact=True``), or one fused ``|H|²`` pass.
- :func:`fftconvolve_same_fd` — FIR convolution with 'same' cropping.
- :func:`resample_fft`  — ``scipy.signal.resample``'s spectrum surgery.

:func:`box_smooth_same` (the de-esser's gain smoother) runs the CUDA box
kernel ``csrc/box_smooth.cu`` on a GPU tensor and its plain PyTorch
version (:func:`box_smooth_plain`) on a CPU tensor.

All functions work on the trailing axis and broadcast over leading axes;
the ``nv`` forms take ``n_valid`` [B] aligned with the leading axis.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from . import fft_mxu, validctx


def _use_mxu_fft(nfft: int) -> bool:
    """The JAX package's rule: power-of-two plans of 2^16 and more take the
    matmul FFT (``ops/fft_mxu.py``) when ``AMW_FFT_MXU`` is ``"1"`` (read
    at each call)."""
    if os.environ.get("AMW_FFT_MXU", "0") != "1":
        return False
    return nfft >= (1 << 16) and (nfft & (nfft - 1)) == 0


def _apply_response(x, H, nfft: int, conj: bool = False):
    """irfft(rfft(x, nfft) * H)[:nfft] on ``torch.fft``, or on the matmul
    FFT where :func:`_use_mxu_fft`; ``H`` complex (causal and exact
    responses) or real (zero-phase power responses)."""
    if _use_mxu_fft(nfft):
        xr, xi = fft_mxu.rfft_mxu(x, nfft)
        if H.is_complex():
            Hr, Hi = H.real, H.imag
            if conj:
                Hi = -Hi
            yr = xr * Hr - xi * Hi
            yi = xr * Hi + xi * Hr
        else:
            yr = xr * H
            yi = xi * H
        return fft_mxu.irfft_mxu(yr, yi, nfft)
    if conj:
        H = torch.conj(H)
    X = torch.fft.rfft(x, n=nfft, dim=-1)
    return torch.fft.irfft(X * H, n=nfft, dim=-1)


def odd_ext(x: torch.Tensor, p: int, pad_to: int | None = None):
    """Odd extension by ``p`` samples at both ends (scipy ``odd_ext``),
    optionally zero-padded to ``pad_to`` in the same concatenate."""
    if p <= 0:
        if pad_to is not None and pad_to > x.shape[-1]:
            return F.pad(x, (0, pad_to - x.shape[-1]))
        return x
    left = 2.0 * x[..., :1] - x[..., 1:p + 1].flip(-1)
    right = 2.0 * x[..., -1:] - x[..., -p - 1:-1].flip(-1)
    parts = [left, x, right]
    total = x.shape[-1] + 2 * p
    if pad_to is not None and pad_to > total:
        parts.append(x.new_zeros(x.shape[:-1] + (pad_to - total,)))
    return torch.cat(parts, dim=-1)


def odd_ext_valid(x: torch.Tensor, p: int, nv: torch.Tensor,
                  pad_to: int | None = None):
    """Odd extension anchored at each track's valid end ``nv`` [B].

    ``x`` [B, ..., n] must be zero beyond ``nv``.  Returns a buffer of
    length ``n + 2p`` (or ``pad_to``): left extension, the signal, then the
    right odd extension written at ``p + nv`` (zeros beyond)."""
    if p <= 0:
        return odd_ext(x, 0, pad_to)
    n = x.shape[-1]
    tail = max(p, (pad_to - n - p) if pad_to is not None else p)
    left = 2.0 * x[..., :1] - x[..., 1:p + 1].flip(-1)
    buf = torch.cat([left, x, x.new_zeros(x.shape[:-1] + (tail,))], dim=-1)
    last = validctx.gather_last(x, nv)
    # x[nv-2-j] for j < p, clamped at 0 (jnp gather semantics)
    idx = (validctx.per_track(nv, x) - 2
           - torch.arange(p, device=x.device)).clamp(min=0)
    right = 2.0 * last - torch.gather(x, -1, idx.expand(x.shape[:-1] + (p,)))
    return validctx.put(buf, right, p + nv)


def lfilter_fd(x: torch.Tensor, H: torch.Tensor, nfft: int):
    """Causal LTI filter, zero initial state.  ``H``: complex response on
    the rFFT grid of ``nfft`` (``nfft >= x.shape[-1] + settle``)."""
    n = x.shape[-1]
    return _apply_response(x, H, nfft)[..., :n]


def filtfilt_fd(x: torch.Tensor, H: torch.Tensor, nfft: int, *, padlen: int,
                settle: int, exact: bool = True, nv=None):
    """Zero-phase forward-backward filter (see ``amw_tpu`` filtfilt_fd).

    exact=True  — two passes emulating scipy ``filtfilt`` (odd extension +
                  steady state via a ``settle``-sample constant prefix and
                  suffix); ``H`` is the causal (complex) cascade response.
    exact=False — one pass multiplying by ``H = |H|²`` (real).
    nv          — [B] valid lengths (output zeroed beyond)."""
    n = x.shape[-1]
    p = min(padlen, max(n - 1, 0))
    core = odd_ext(x, p) if nv is None else odd_ext_valid(x, p, nv)
    ncore = n + 2 * p

    if not exact:
        y = _apply_response(core, H, nfft)[..., p:p + n]
        return y if nv is None else validctx.mask_tail(y, nv)

    M = settle
    prefix = core[..., :1].expand(x.shape[:-1] + (M,))
    ext1 = torch.cat([prefix, core], dim=-1)
    yf = _apply_response(ext1, H, nfft)[..., M:M + ncore]

    if nv is None:
        suffix = yf[..., -1:].expand(x.shape[:-1] + (M,))
        ext2 = torch.cat([yf, suffix], dim=-1)
        # Anti-causal pass: multiply by conj(H), with the right-end steady
        # state provided by the constant suffix.
        z = _apply_response(ext2, H, nfft, conj=True)
        return z[..., p:p + n]

    # Valid-end variant: the forward output past the right extension
    # (core position nv + 2p) is ringout the exact-length computation never
    # produces — zero it, then write the steady-state suffix there.
    end = nv + 2 * p
    t = torch.arange(ncore, device=x.device)
    yf = torch.where(t < validctx.per_track(end, yf), yf,
                     torch.zeros((), dtype=yf.dtype, device=yf.device))
    y_end = validctx.gather_last(yf, end)
    ext2 = torch.cat([yf, yf.new_zeros(x.shape[:-1] + (M,))], dim=-1)
    ext2 = validctx.put(ext2, y_end.expand(x.shape[:-1] + (M,)), end)
    z = _apply_response(ext2, H, nfft, conj=True)
    return validctx.mask_tail(z[..., p:p + n], nv)


def fftconvolve_same_fd(x: torch.Tensor, h: torch.Tensor, nfft: int):
    """Linear convolution with 'same' cropping (``scipy.signal.fftconvolve
    (x, h, mode='same')``); ``nfft >= n + len(h) - 1``."""
    n = x.shape[-1]
    L = h.shape[-1]
    y = torch.fft.irfft(torch.fft.rfft(x, n=nfft, dim=-1)
                        * torch.fft.rfft(h, n=nfft, dim=-1), n=nfft, dim=-1)
    start = (L - 1) // 2
    return y[..., start:start + n]


def resample_plan(n_in: int, n_out: int):
    """Always ``None``.  The JAX package builds Bluestein (chirp-z) tables
    here when either length lies outside XLA-TPU's native FFT sizes
    ({1, 3, 5}·2^k), which it would otherwise lower as an O(n²) DFT
    matmul; cuFFT and PyTorch's CPU FFT take any length, so the port
    resamples with plain transforms and needs no tables.  Kept so that
    callers have the JAX package's interface."""
    return None


def resample_fft(x: torch.Tensor, n_out: int, plan=None) -> torch.Tensor:
    """FFT resampling of the trailing axis with ``scipy.signal.resample``'s
    semantics for real input (reference: pipeline.py:920-936, the
    exciter's oversampling and ``/api/v2/upscale``): the spectrum truncated
    or zero-padded, the Nyquist bin doubled on the way down (to an even
    length) and halved on the way up (from an even length), the result
    scaled by ``n_out / n_in``.  ``plan``: :func:`resample_plan`'s result,
    or the JAX package's tables, which the port does not need (ignored)."""
    n_in = x.shape[-1]
    if n_out == n_in:
        return x
    nyq_out = n_out // 2 + 1
    X = torch.fft.rfft(x, dim=-1)
    if n_out < n_in:
        X = X[..., :nyq_out]
        if n_out % 2 == 0:
            # the new Nyquist bin gathers both conjugate halves of the old
            # interior bin (scipy doubles it; irfft uses its real part once)
            X = torch.cat([X[..., :-1], X[..., -1:] * 2.0], dim=-1)
    else:
        if n_in % 2 == 0:
            # the old Nyquist bin becomes an interior bin: split between the
            # positive and the (implicit) negative frequency
            X = torch.cat([X[..., :-1], X[..., -1:] * 0.5], dim=-1)
        X = F.pad(X, (0, nyq_out - X.shape[-1]))
    return torch.fft.irfft(X, n=n_out, dim=-1) * (n_out / n_in)


# Widest box the CUDA kernel takes (csrc/box_smooth.cu: the generic path
# stages the tile, its halo and its s8 sums, ~98 KB of shared memory).
BOX_MAX_K = 8193


def box_smooth_plain(x: torch.Tensor, k: int) -> torch.Tensor:
    """Plain PyTorch box smoother: the two-level shift-add of
    ``amw_tpu`` (fdfilter.py:305-329), ``k = a*b + r`` with a = 8."""
    n = x.shape[-1]
    half = k // 2
    xp = F.pad(x, (half, k - 1 - half))
    a = 8
    b = k // a
    if b >= 2:
        La = n + k - a
        sa = xp[..., 0:La]
        for s in range(1, a):
            sa = sa + xp[..., s:s + La]
        acc = sa[..., 0:n]
        for j in range(1, b):
            acc = acc + sa[..., j * a:j * a + n]
        for s in range(a * b, k):
            acc = acc + xp[..., s:s + n]
        return acc * (1.0 / k)
    acc = xp[..., :n]
    for s in range(1, k):
        acc = acc + xp[..., s:s + n]
    return acc * (1.0 / k)


def box_smooth_cuda(x2: torch.Tensor, k: int) -> torch.Tensor:
    """Launch the box kernel on ``x2`` f32 [R, n] (CUDA, contiguous): the
    plain version's sums in its order, so exactly its result.  Replaces
    ``amw_tpu/ops/fdfilter.py`` ``_box_pallas``."""
    from . import _cuda

    if not x2.is_cuda or x2.dtype != torch.float32 or x2.ndim != 2:
        raise ValueError("box_smooth_cuda: need a CUDA float32 [R, n] tensor")
    if not x2.is_contiguous():
        raise ValueError("box_smooth_cuda: input must be contiguous")
    R, n = x2.shape
    if not (1 <= k <= BOX_MAX_K) or R > 65535 or n > 2 ** 31 - 2 ** 15:
        raise ValueError(f"box_smooth_cuda: unsupported k={k} / shape "
                         f"{tuple(x2.shape)}")
    y = torch.empty_like(x2)
    _cuda.launch("amw_box_smooth", x2, y, R, n, k)
    box_smooth_cuda.launches += 1
    return y


box_smooth_cuda.launches = 0


def box_smooth_same(x: torch.Tensor, k: int) -> torch.Tensor:
    """Centered moving average of odd width ``k`` with zero-padded edges
    (``fftconvolve_same_fd(x, ones(k)/k, nfft)`` up to f32 summation
    order; the kernel and the plain version sum in one order).  On a CUDA tensor: the box kernel, for every row count; on a
    CPU tensor: :func:`box_smooth_plain`."""
    if k <= 1:
        return x
    if x.is_cuda:
        n = x.shape[-1]
        y = box_smooth_cuda(x.reshape(-1, n).contiguous(), k)
        return y.reshape(x.shape)
    if x.device.type != "cpu":
        raise ValueError(f"box_smooth_same: no kernel for {x.device}")
    return box_smooth_plain(x, k)
