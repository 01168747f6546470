"""Host-side filter design — float64 numpy (a copy of ``amw_tpu/ops/design.py``).

Every LTI stage of the mastering chain is a frequency-domain operator: the
filter's response on the FFT grid is computed here, on the host, in
float64, and handed to the device as a plain tensor ("weights").  The
device side (:mod:`amw_tpu_torch.ops.fdfilter`) only does rFFT → multiply
→ irFFT.

The FFT size rule is the JAX package's CPU rule (:func:`next_fft_size`,
no TPU preference), so the port and the JAX package on the CPU pick the
same ``nfft``.  :func:`tpu_fft_plan` is the JAX package's rule on a TPU: a
power of two the staged FFT takes (:func:`plan_ok`) replaces a smaller
3·2^k or 5·2^k size when it pads by at most ``AMW_FFT_PREFER_PALLAS_MAX``
(read at each call, default 1.75, as ``amw_tpu.ops.design`` reads it).
The builders plan with ``fft_staged.site_plan``, which adds that rule's
last term (the staged FFT is enabled for the power of two) and so takes
the TPU plan where the staged FFT runs and the CPU rule elsewhere, as the
JAX package's ``next_fft_size`` does on each backend.
"""

from __future__ import annotations

import functools
import math
import os

import numpy as np


# Settling tolerance for IIR tail truncation: responses are treated as FIR
# once the impulse response has decayed below this relative level.
SETTLE_EPS = 1e-9
# Hard cap on settle length so one extreme filter cannot blow up FFT sizes.
SETTLE_CAP = 1 << 18


@functools.lru_cache(maxsize=None)
def butter_ba(order: int, lo: float, hi: float | None, btype: str, sr: float):
    """Butterworth (b, a) like the reference's ``signal.butter(..., output="ba")``.

    ``lo``/``hi`` are in Hz; normalization by Nyquist happens here.  Mirrors the
    reference's clipping of normalized frequencies (pipeline.py:174-183 et al.)
    — callers pass already-clipped normalized values via :func:`butter_ba_norm`
    when they need exact reference semantics.
    """
    from scipy import signal

    nyq = sr / 2.0
    if hi is None:
        wn = min(lo / nyq, 0.99)
        b, a = signal.butter(order, wn, btype=btype, output="ba")
    else:
        b, a = signal.butter(order, [lo / nyq, hi / nyq], btype=btype, output="ba")
    return np.asarray(b, np.float64), np.asarray(a, np.float64)


@functools.lru_cache(maxsize=None)
def iirpeak_ba(w0: float, bw: float):
    """Peaking (bell) filter like ``scipy.signal.iirpeak(w0, Q)`` with the
    bandwidth parameterization of the reference dynamic EQ
    (pipeline.py:1660-1663 passes the *bandwidth* as the second positional
    argument, i.e. Q := bw there)."""
    from scipy import signal

    b, a = signal.iirpeak(w0, bw)
    return np.asarray(b, np.float64), np.asarray(a, np.float64)


@functools.lru_cache(maxsize=None)
def butter_ba_norm(order: int, wn: tuple | float, btype: str):
    """Butterworth from pre-normalized frequency/frequencies (0..1 of Nyquist)."""
    from scipy import signal

    wn_arg = list(wn) if isinstance(wn, tuple) else wn
    b, a = signal.butter(order, wn_arg, btype=btype, output="ba")
    return np.asarray(b, np.float64), np.asarray(a, np.float64)


def k_weighting_ba(sr: float):
    """BS.1770-4 K-weighting prefilter pair (high shelf + high pass).

    Parameterization follows the pyloudnorm reference meter used by the
    reference service (pipeline.py:658-664 via ``pyln.Meter``): RBJ biquads
    with G=+4 dB shelf at 1681.97 Hz (Q=0.70717...) and a 38.135 Hz high-pass
    (Q=0.50033...), which reproduce the ITU table coefficients at fs=48 kHz.
    Returns ``[(b_shelf, a_shelf), (b_hp, a_hp)]`` (a0-normalized, float64).
    """
    fs = float(sr)

    # Stage 1: high shelf (De Man's sample-rate-independent decomposition of
    # the ITU pre-filter: G=+3.99984 dB, Q=0.70718, fc=1681.97 Hz).
    G, Q, fc = 3.999843853973347, 0.7071752369554196, 1681.974450955533
    K = math.tan(math.pi * fc / fs)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh ** 0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    b = np.array([
        (Vh + Vb * K / Q + K * K) / a0,
        2.0 * (K * K - Vh) / a0,
        (Vh - Vb * K / Q + K * K) / a0,
    ])
    a = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0])
    shelf = (b, a)

    # Stage 2: RLB high pass (b left unnormalized at [1, -2, 1] per the ITU
    # table — the denominator alone is a0-normalized).
    Q, fc = 0.5003270373238773, 38.13547087602444
    K = math.tan(math.pi * fc / fs)
    a0 = 1.0 + K / Q + K * K
    b = np.array([1.0, -2.0, 1.0])
    a = np.array([1.0, 2.0 * (K * K - 1.0) / a0, (1.0 - K / Q + K * K) / a0])
    hp = (b, a)
    return [shelf, hp]


def settle_len(*ba_pairs, eps: float = SETTLE_EPS) -> int:
    """Number of samples for the cascade's impulse response to decay below
    ``eps`` (relative), from the largest pole radius.  Used to size the
    steady-state prefix and the FFT tail guard."""
    r_max = 0.0
    for b, a in ba_pairs:
        a = np.atleast_1d(np.asarray(a, np.float64))
        if a.size > 1:
            roots = np.roots(a)
            if roots.size:
                r_max = max(r_max, float(np.max(np.abs(roots))))
    if r_max <= 1e-12:
        return 8  # pure FIR
    r_max = min(r_max, 1.0 - 1e-7)
    n = int(math.ceil(math.log(eps) / math.log(r_max)))
    return int(np.clip(n, 8, SETTLE_CAP))


@functools.lru_cache(maxsize=2)
def _rfft_zinv(nfft: int) -> np.ndarray:
    """``e^{-jw_k}`` on the rFFT grid of ``nfft`` (read-only): one chain
    evaluates dozens of responses at the same plan."""
    w = 2.0 * np.pi * np.arange(nfft // 2 + 1, dtype=np.float64) / nfft
    zinv = np.exp(-1j * w)
    zinv.flags.writeable = False
    return zinv


def freqz(b, a, nfft: int) -> np.ndarray:
    """Complex response of (b, a) on the rFFT grid of an ``nfft``-point FFT.

    Float64 evaluation on the host: ``H[k] = B(e^{-jw_k}) / A(e^{-jw_k})``
    with ``w_k = 2πk/nfft``, ``k = 0..nfft//2``.
    """
    zinv = _rfft_zinv(nfft)

    def horner(c):
        # in place: at 2^23 points each temporary costs more than its
        # arithmetic; the same operations in the same order
        c = np.atleast_1d(np.asarray(c, np.float64))
        acc = np.full_like(zinv, c[-1])
        for coef in c[-2::-1]:
            acc *= zinv
            acc += coef
        return acc

    num = horner(b)
    num /= horner(a)
    return num


def cascade_response(ba_pairs, nfft: int) -> np.ndarray:
    """Product of the responses of a list of (b, a) pairs (complex128)."""
    H = np.ones(nfft // 2 + 1, dtype=np.complex128)
    for b, a in ba_pairs:
        H *= freqz(b, a, nfft)
    return H


def zero_phase_power(ba_pairs, nfft: int) -> np.ndarray:
    """|H|^2 of a cascade — the zero-phase (forward-backward) magnitude
    response used by the fused 'fast' filtfilt path (float64, real)."""
    return np.abs(cascade_response(ba_pairs, nfft)) ** 2


def linear_phase_ir_from_mag(mag: np.ndarray, n_fft: int) -> np.ndarray:
    """Linear-phase FIR of length ``n_fft`` whose magnitude on the half grid
    ``w = πk/(n_fft/2)`` is ``mag`` — delay (n_fft-1)/2 samples.  Mirrors the
    reference's linear-phase EQ IR construction (pipeline.py:187-217)."""
    n = int(n_fft)
    k_pos = np.arange(n // 2 + 1, dtype=np.float64)
    phase = -2.0 * np.pi * k_pos * (n - 1) / (2.0 * n)
    half = np.clip(mag, 1e-8, 1e8) * np.exp(1j * phase)
    H_full = np.zeros(n, dtype=np.complex128)
    H_full[: n // 2 + 1] = half
    H_full[n // 2 + 1:] = np.conj(half[1: n // 2][::-1])
    if n % 2 == 0:
        H_full[n // 2] = H_full[n // 2].real
    ir = np.fft.ifft(H_full).real
    return ir.astype(np.float64)


def next_fft_size(n: int) -> int:
    """Smallest FFT size >= n from the set {2^k, 3·2^k, 5·2^k}."""
    if n <= 16:
        return 16
    best = 1 << (n - 1).bit_length()
    for mult in (3, 5):
        k = max(0, ((n + mult - 1) // mult - 1).bit_length())
        size = mult << k
        if size >= n:
            best = min(best, size)
    return best


def plan_ok(nfft: int) -> bool:
    """Does the staged FFT take an ``nfft``-point plan?  ``nfft = 128·128·C``
    with ``C`` a power of two in [32, 1024], i.e. 2^19..2^24."""
    if nfft % (128 * 128):
        return False
    c = nfft // (128 * 128)
    return 32 <= c <= 1024 and (c & (c - 1)) == 0


def prefer_staged_max() -> float:
    """The largest padding factor at which a staged power of two replaces
    a 3·2^k or 5·2^k size: ``AMW_FFT_PREFER_PALLAS_MAX``, read at each
    call with the JAX package's default."""
    return float(os.environ.get("AMW_FFT_PREFER_PALLAS_MAX", "1.75"))


def tpu_fft_plan(n: int) -> int:
    """The FFT size the JAX package picks for ``n`` on a TPU with its
    Pallas FFT enabled: the CPU rule, except that a power of two the
    Pallas FFT takes replaces a smaller 3·2^k or 5·2^k size when it pads
    by at most :func:`prefer_staged_max`.  Where the staged FFT is off,
    ``fft_staged.site_plan`` keeps the CPU rule instead."""
    best = next_fft_size(n)
    if best & (best - 1):
        pow2 = 1 << (n - 1).bit_length()
        if (plan_ok(pow2) and not plan_ok(best)
                and pow2 <= prefer_staged_max() * best):
            return pow2
    return best
