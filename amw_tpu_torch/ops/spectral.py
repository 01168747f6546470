"""Spectral ops: the STFT Wiener denoiser, the spectral envelope and the
reference match (counterpart of ``amw_tpu/ops/spectral.py``).

The STFT follows ``scipy.signal.stft``'s conventions: ``nperseg // 2``
zeros on both sides, a tail padded to whole hops, a periodic Hann window
and the forward scale ``1 / win.sum()``; :func:`istft` inverts it with
the window-square overlap normalization.  Frames are a view of the padded
signal (``Tensor.unfold``); the overlap-add is ``F.fold``, which sums in a
fixed order on the card (no atomics).  The transforms are ``torch.fft``
(cuFFT on the GPU), as the JAX package runs XLA's FFT here.  Layout as
everywhere in the port: ``[..., N]`` with a leading batch axis that
``n_valid`` ([B]) is aligned with.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..spec import GraphSpec
from . import design, fft_staged, validctx
from .fdfilter import fftconvolve_same_fd

NPERSEG = 2048
HOP = 512


@functools.lru_cache(maxsize=None)
def _hann_periodic(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def _stft_geometry(n: int, nperseg: int, hop: int) -> tuple[int, int]:
    """scipy's padded length and frame count: ``nperseg // 2`` zeros on
    both sides, then a tail that makes ``len - nperseg`` a multiple of the
    hop."""
    ext = n + nperseg
    rem = (ext - nperseg) % hop
    total = ext + (0 if rem == 0 else hop - rem)
    return total, (total - nperseg) // hop + 1


@functools.lru_cache(maxsize=None)
def _ola_norm(frames: int, nperseg: int, hop: int) -> np.ndarray:
    """The window-square overlap-add of ``frames`` frames (float64, host):
    the normalization :func:`istft` divides by."""
    win2 = _hann_periodic(nperseg) ** 2
    total = (frames - 1) * hop + nperseg
    buf = np.zeros((frames + -(-nperseg // hop)) * hop)
    for s in range(0, nperseg, hop):  # frame t adds piece s at t*hop + s
        piece = win2[s:s + hop]
        buf[s:s + frames * hop].reshape(frames, hop)[:, :piece.size] += piece
    return buf[:total]


def _ola_norm_tensor(frames: int, nperseg: int, hop: int,
                     device) -> torch.Tensor:
    return torch.as_tensor(_ola_norm(frames, nperseg, hop),
                           dtype=torch.float32, device=device)


def stft(x: torch.Tensor, nperseg: int = NPERSEG,
         hop: int = HOP) -> torch.Tensor:
    """[..., N] → complex frames [..., T, nperseg // 2 + 1], scipy's
    scaling."""
    n = x.shape[-1]
    total = _stft_geometry(n, nperseg, hop)[0]
    lead = nperseg // 2
    framed = F.pad(x, (lead, total - n - lead)).unfold(-1, nperseg, hop)
    win = _hann_periodic(nperseg)
    w = torch.as_tensor(win, dtype=x.dtype, device=x.device)
    return torch.fft.rfft(framed * w, dim=-1) * (1.0 / win.sum())


def istft(Z: torch.Tensor, n: int, nperseg: int = NPERSEG, hop: int = HOP,
          n_frames_valid=None, norm: torch.Tensor | None = None):
    """Inverse of :func:`stft`, cropped to ``n`` output samples.

    ``n_frames_valid`` ([B], optional): the frames each exact-length track
    would have.  Frames past it are silent in a bucket-padded signal and
    add nothing to the overlap-add, but the static normalization counts
    them: the one frame that can overlap valid output (frame
    ``n_frames_valid``) is taken out of that track's denominator, so the
    result matches the exact-length istft's right edge.  ``norm``: the
    float32 normalization on ``Z``'s device, made once by a caller that
    runs many times (made here when None)."""
    win = _hann_periodic(nperseg)
    frames = Z.shape[-2]
    total = (frames - 1) * hop + nperseg
    if norm is None:
        norm = _ola_norm_tensor(frames, nperseg, hop, Z.device)
    w = torch.as_tensor(win, dtype=torch.float32, device=Z.device)
    seg = torch.fft.irfft(Z * win.sum(), n=nperseg, dim=-1) * w
    lead_shape = Z.shape[:-2]
    cols = seg.reshape((-1, frames, nperseg)).transpose(1, 2)
    out = F.fold(cols, output_size=(1, total), kernel_size=(1, nperseg),
                 stride=(1, hop)).reshape(lead_shape + (total,))
    if n_frames_valid is None:
        out = out / torch.where(norm > 1e-10, norm, 1.0)
    else:
        w2 = torch.as_tensor(np.concatenate([win * win, np.zeros(1)]),
                             dtype=torch.float32, device=Z.device)
        u = (torch.arange(total, device=Z.device)
             - (n_frames_valid * hop)[:, None])  # [B, total]
        inside = (u >= 0) & (u < nperseg)
        deficit = w2[u.clamp(0, nperseg)] * inside
        deficit = torch.where((n_frames_valid < frames)[:, None], deficit,
                              0.0)
        nv_norm = norm - deficit
        nv_norm = torch.where(nv_norm > 1e-10, nv_norm, 1.0)
        out = out / nv_norm.reshape(nv_norm.shape[:1]
                                    + (1,) * (out.ndim - 2) + (total,))
    lead = nperseg // 2
    return out[..., lead:lead + n]


def _percentile_sorted(s: torch.Tensor, q: float,
                       method: str = "linear") -> torch.Tensor:
    """``jnp.percentile`` (``"linear"``) or ``jnp.median``'s
    ``"midpoint"`` over the last axis of ``s``, sorted along it already;
    keeps the last axis.  The position in float32 as JAX computes it."""
    t = s.shape[-1]
    pos = np.float32(np.float32(q) / np.float32(100.0)) * np.float32(t - 1)
    lo, hi = int(np.floor(pos)), int(np.ceil(pos))
    v_lo, v_hi = s[..., lo:lo + 1], s[..., hi:hi + 1]
    if method == "midpoint":
        return (v_lo + v_hi) * 0.5
    hw = np.float32(pos - np.float32(lo))
    return v_lo * float(np.float32(1.0) - hw) + v_hi * float(hw)


def build_spectral_denoise(spec: GraphSpec, strength: float = 0.5,
                           noise_percentile: float = 15.0, *, device):
    """The STFT Wiener denoiser (pipeline.py:1472-1524): per bin, the
    ``noise_percentile``-th percentile of the magnitudes over the frames
    is the noise floor (at most 0.85 × the median), and each bin of each
    frame keeps ``1 - strength · (noise / |Z|)²`` of itself, clipped to
    [0.25, 1].  On a bucket-padded batch the percentiles run over the
    frames each exact-length track would have.  Both percentiles come from
    one sort."""
    strength = float(np.clip(strength, 0.0, 1.0))
    if strength < 0.01:
        return [], lambda x, params: x
    min_gain = 0.25
    norm = _ola_norm_tensor(_stft_geometry(spec.n, NPERSEG, HOP)[1],
                            NPERSEG, HOP, device)

    def fn(x, params):
        nv = validctx.n_valid()
        Z = stft(x)  # [..., T, F]
        mag = Z.abs()
        T = mag.shape[-2]
        magT = mag.transpose(-1, -2)  # [..., F, T]
        if nv is None:
            t_valid = None
            s = torch.sort(magT, dim=-1).values
            noise = _percentile_sorted(s, noise_percentile)
            med = _percentile_sorted(s, 50.0, "midpoint")
        else:
            # the noise profile over the frames the exact-length signal
            # would have: silent padding frames must not skew it
            t_valid = (nv + HOP - 1) // HOP + 1
            frame = torch.arange(T, device=x.device)
            masked = torch.where(frame < validctx.per_track(t_valid, magT),
                                 magT, torch.inf)
            s = torch.sort(masked, dim=-1).values
            noise = validctx.quantile_last_sorted(s, noise_percentile,
                                                  t_valid)
            med = validctx.quantile_last_sorted(s, 50.0, t_valid)
        del s
        noise = noise.clamp(min=1e-12)
        med = med.clamp(min=1e-12)
        noise = torch.minimum(noise, 0.85 * med)
        gain = 1.0 - strength * (noise.transpose(-1, -2)
                                 / (mag + 1e-10)) ** 2
        Zg = Z * gain.clamp(min_gain, 1.0)
        if t_valid is not None:
            # frame t_valid straddles the track's tail in the padded signal
            # but does not exist in the exact-length STFT: zero every frame
            # from t_valid on (istft's n_frames_valid mends the denominator)
            frame = torch.arange(T, device=x.device)[:, None]
            Zg = Zg * (frame < validctx.per_track(t_valid, Zg[..., :1]))
        rec = istft(Zg, spec.n, n_frames_valid=t_valid, norm=norm)
        return rec.clamp(-1.0, 1.0)

    return [], fn


def spectral_envelope(x: torch.Tensor, n_fft: int = 8192) -> torch.Tensor:
    """Averaged RMS magnitude spectrum of the mono mix of ``x`` [..., C, N]
    (pipeline.py:1527-1551).  Under a valid-length context only the frames
    the exact-length signal would have enter each track's average."""
    mono = x.mean(dim=-2) if x.ndim >= 2 else x
    n = mono.shape[-1]
    hop = n_fft // 4
    count = (n - n_fft) // hop + 1
    if count <= 0:
        return torch.ones(mono.shape[:-1] + (n_fft // 2 + 1,),
                          dtype=torch.float32, device=x.device)
    win = torch.as_tensor(np.hanning(n_fft).astype(np.float32),
                          device=x.device)
    frames = mono.unfold(-1, n_fft, hop) * win  # [..., count, n_fft]
    power = torch.fft.rfft(frames, dim=-1).abs() ** 2
    nv = validctx.n_valid()
    if nv is None:
        return power.mean(dim=-2).sqrt()
    count_v = ((nv - n_fft) // hop + 1).clamp(min=1)
    valid = torch.arange(count, device=x.device)[:, None] < \
        validctx.per_track(count_v, power[..., :1])
    return ((power * valid).sum(dim=-2)
            / validctx.per_track(count_v, power[..., 0, :])).sqrt()


@functools.lru_cache(maxsize=None)
def _savgol_plan(n_pts: int, window: int = 51, polyorder: int = 3):
    """The interior convolution kernel and the edge projections that
    reproduce ``scipy.signal.savgol_filter(..., mode='interp')``."""
    from scipy.signal import savgol_coeffs

    window = min(window, (n_pts // 4) * 2 + 1)
    window = max(5, window if window % 2 == 1 else window + 1)
    half = window // 2
    coeffs = savgol_coeffs(window, polyorder).astype(np.float64)
    pos = np.arange(window, dtype=np.float64)
    V = np.vander(pos, polyorder + 1, increasing=True)
    proj = V @ np.linalg.pinv(V)
    return window, half, coeffs, proj[:half], proj[window - half:]


def savgol_smooth(r: torch.Tensor, window: int = 51,
                  polyorder: int = 3) -> torch.Tensor:
    """Savitzky-Golay smoothing along the last axis of ``r`` (scipy's
    'interp' mode)."""
    n_pts = r.shape[-1]
    window, half, coeffs, a_left, a_right = _savgol_plan(n_pts, window,
                                                         polyorder)
    nfft = design.next_fft_size(n_pts + window)

    def t(a):
        return torch.as_tensor(a, dtype=r.dtype, device=r.device)

    interior = fftconvolve_same_fd(r, t(coeffs), nfft)
    left = r[..., :window] @ t(a_left).T
    right = r[..., -window:] @ t(a_right).T
    return torch.cat([left, interior[..., half:n_pts - half], right], dim=-1)


def build_reference_match(spec: GraphSpec, ref_env: np.ndarray,
                          strength: float = 1.0, n_fft: int = 8192, *,
                          device):
    """Match the track's spectral balance to a reference envelope
    (pipeline.py:1554-1612): the smoothed ratio of the envelopes as a
    windowed zero-phase FIR, one 'same' convolution on ``torch.fft`` (at
    the JAX package's ``next_fft_size(n + n_fft)`` for the backend).
    ``ref_env``: the reference track's :func:`spectral_envelope`
    ([n_fft // 2 + 1], an array or a tensor on ``device``)."""
    strength = float(np.clip(strength, 0.0, 1.0))
    if strength < 0.01:
        return [], lambda x, params: x
    hann = np.hanning(n_fft).astype(np.float32)
    conv_nfft = fft_staged.site_plan(spec.n + n_fft, device)[0]
    params = [ref_env if isinstance(ref_env, torch.Tensor)
              else np.asarray(ref_env, np.float32), hann]

    def fn(x, params):
        ref_e, win = params
        src_env = spectral_envelope(x, n_fft)
        eps = 1e-8
        ratio = (ref_e + eps) / (src_env + eps)
        ratio = savgol_smooth(ratio).clamp(0.1, 10.0)
        ratio = (1.0 + (ratio - 1.0) * strength).clamp(0.1, 10.0)
        # the reference mirrors the half spectrum and takes ifft(...).real
        # (pipeline.py:1599-1603), i.e. irfft, then windows the wrapped
        # zero-phase IR as it is
        ir = torch.fft.irfft(ratio, n=n_fft, dim=-1) * win
        ir = ir.reshape(ir.shape[:-1] + (1,) * (x.ndim - ir.ndim)
                        + (n_fft,))  # one IR a track, over its channels
        y = fftconvolve_same_fd(x, ir, conv_nfft)
        return y.clamp(-1.0, 1.0)

    return params, fn
