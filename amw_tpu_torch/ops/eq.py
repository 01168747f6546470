"""EQ op builders: target curve, final balance, style EQ, rumble filter,
high-frequency trim.

Counterpart of ``amw_tpu/ops/eq.py``: the target curve (minimum phase or
linear phase, optionally on Mid/Side), final spectral balance, style EQ,
their fusion ``build_final_balance_then_style``, the rumble filter and the
high-frequency trim.
Each ``build_*`` returns ``(params, fn)``: ``params`` is a nested list of
float32 numpy arrays (the op's "weights") and ``fn(x, params)`` applies the
op to ``[..., N]`` with the tensor version of that list.

Reference semantics: backend/app/pipeline.py:170-273 (target curve),
:576-607 (final spectral balance), :1401-1434 (style EQ), :1449-1469
(rumble filter), :1701-1702 (high-frequency trim).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from ..constants import FINAL_TRIM_DB, STYLE_CONFIGS
from ..spec import GraphSpec
from . import design, fft_staged
from .fdfilter import fftconvolve_same_fd
from .zphase import hybridize_op, make_zp, make_zp_from_power, scipy_padlen


def _db(x):
    return 10.0 ** (x / 20.0)


def _ms_wrap(spec: GraphSpec, fn):
    """Run a per-channel op on Mid/Side instead of L/R (eq_ms mode,
    pipeline.py:248-255).  Stereo only; decode clips to ±1."""

    def ms_fn(x, params):
        mid = (x[..., 0, :] + x[..., 1, :]) * 0.5
        side = (x[..., 0, :] - x[..., 1, :]) * 0.5
        out = fn(torch.stack([mid, side], dim=-2), params)
        m, s = out[..., 0, :], out[..., 1, :]
        return torch.stack([(m + s).clamp(-1.0, 1.0),
                            (m - s).clamp(-1.0, 1.0)], dim=-2)

    return ms_fn


def _target_curve_bas(spec: GraphSpec):
    nyq = spec.nyq
    b_hp, a_hp = design.butter_ba_norm(2, min(40.0 / nyq, 0.99), "high")
    b_lp, a_lp = design.butter_ba_norm(2, min(18000.0 / nyq, 0.99), "low")
    f_pres = min(3000.0 / nyq, 0.99)
    b_pr, a_pr = design.butter_ba_norm(1, (f_pres * 0.7, f_pres * 1.3), "band")
    f_mud = min(300.0 / nyq, 0.99)
    b_md, a_md = design.butter_ba_norm(1, (f_mud * 0.7, f_mud * 1.3), "band")
    return (b_hp, a_hp), (b_lp, a_lp), (b_pr, a_pr), (b_md, a_md)


def target_curve_power(spec: GraphSpec, nfft: int) -> np.ndarray:
    """The target curve's zero-phase power response (float64, rFFT grid)."""
    hp, lp, pr, md = _target_curve_bas(spec)
    g_p, g_m = _db(0.35), _db(-0.25)
    R = (design.zero_phase_power([hp], nfft)
         * design.zero_phase_power([lp], nfft))
    return R * (1.0 + (g_p - 1.0) * design.zero_phase_power([pr], nfft)
                + (g_m - 1.0) * design.zero_phase_power([md], nfft))


def build_target_curve(spec: GraphSpec, phase_mode: str = "minimum",
                       eq_ms: bool = False, *, device):
    """Studio curve: HP 40 Hz, LP 18 kHz, +0.35 dB presence, -0.25 dB mud.
    ``linear_phase``: the curve's magnitude as a 4096-tap linear-phase FIR,
    one 'same' convolution on ``torch.fft`` (at the JAX package's
    ``next_fft_size(n + 4096)`` for the backend), clipped to ±1."""
    hp, lp, pr, md = _target_curve_bas(spec)
    g_p, g_m = _db(0.35), _db(-0.25)

    if phase_mode == "linear_phase":
        n_fft = 4096
        H = design.cascade_response([hp, lp], n_fft)
        H = H * (1.0 + (g_p - 1.0) * design.freqz(*pr, n_fft)
                 + (g_m - 1.0) * design.freqz(*md, n_fft))
        ir = design.linear_phase_ir_from_mag(np.abs(H), n_fft).astype(
            np.float32)
        nfft = fft_staged.site_plan(spec.n + n_fft, device)[0]

        def fn(x, params):
            return fftconvolve_same_fd(x, params[0], nfft).clamp(-1.0, 1.0)

        if eq_ms and spec.channels == 2:
            fn = _ms_wrap(spec, fn)
        return [ir], fn

    def build(s: GraphSpec):
        if s.exact:
            zps = [make_zp(s, [ba], device=device) for ba in (hp, lp, pr, md)]
            params = [z.params for z in zps]

            def fn(x, params):
                y = zps[0](x, params[0])
                y = zps[1](y, params[1])
                pres = zps[2](y, params[2])
                mud = zps[3](y, params[3])
                return y + (g_p - 1.0) * pres + (g_m - 1.0) * mud

        else:
            padlen = scipy_padlen([hp])
            settle = design.settle_len(hp, lp, pr, md)
            nfft = fft_staged.site_plan(
                s.n + 2 * padlen + 3 * settle + 16, device)[0]
            zp = make_zp_from_power(s, target_curve_power(s, nfft), nfft,
                                    padlen, settle, device=device)
            params = [zp.params]

            def fn(x, params):
                return zp(x, params[0])

        return params, fn

    settle = design.settle_len(hp, lp, pr, md)
    params, fn = hybridize_op(spec, settle, scipy_padlen([hp]), build)
    if eq_ms and spec.channels == 2:
        fn = _ms_wrap(spec, fn)
    return params, fn


def _style_bands(spec: GraphSpec, style: str):
    cfg = STYLE_CONFIGS.get(style, STYLE_CONFIGS["standard"])
    nyq = spec.nyq
    raw = [
        (30.0, 90.0, cfg["sub"]), (90.0, 280.0, cfg["bass"]),
        (700.0, 2800.0, cfg["mids"]), (2800.0, 9000.0, cfg["presence"]),
        (10000.0, min(spec.sr * 0.46, 18000.0), cfg["air"]),
    ]
    bands = []
    for f_lo, f_hi, gain_db in raw:
        if abs(gain_db) < 0.05:
            continue
        lo_n, hi_n = min(f_lo / nyq, 0.98), min(f_hi / nyq, 0.98)
        if lo_n >= hi_n:
            continue
        ba = design.butter_ba_norm(1, (lo_n, hi_n), "band")
        bands.append((ba, _db(gain_db)))
    return bands


def build_style_eq(spec: GraphSpec, style: str = "standard", *, device):
    """Genre EQ: sequential parallel-band boosts/cuts over 5 bands."""
    bands = _style_bands(spec, style)
    if not bands:
        return [], lambda x, params: x

    def build(s: GraphSpec):
        if s.exact:
            zps = [make_zp(s, [ba], device=device) for ba, _ in bands]
            gains = [g for _, g in bands]
            params = [z.params for z in zps]

            def fn(x, params):
                out = x
                for z, p, g in zip(zps, params, gains):
                    out = out + (g - 1.0) * z(out, p)
                return out

        else:
            padlen = scipy_padlen([bands[0][0]])
            settle = design.settle_len(*[ba for ba, _ in bands])
            nfft = fft_staged.site_plan(
                s.n + 2 * padlen + 3 * settle + 16, device)[0]
            R = np.ones(nfft // 2 + 1, np.float64)
            for ba, g in bands:
                R = R * (1.0 + (g - 1.0) * design.zero_phase_power([ba], nfft))
            zp = make_zp_from_power(s, R, nfft, padlen, settle, device=device)
            params = [zp.params]

            def fn(x, params):
                return zp(x, params[0])

        return params, fn

    settle = design.settle_len(*[ba for ba, _ in bands])
    return hybridize_op(spec, settle, scipy_padlen([bands[0][0]]), build)


def _final_balance_bas(spec: GraphSpec):
    nyq = spec.nyq
    f3k = min(3000.0 / nyq, 0.99)
    b3 = design.butter_ba_norm(1, (f3k * 0.8, f3k * 1.2), "band")
    b16 = design.butter_ba_norm(2, min(16000.0 / nyq, 0.99), "high")
    blo = design.butter_ba_norm(2, min(180.0 / nyq, 0.99), "low")
    f8k = min(8000.0 / nyq, 0.99)
    b8 = design.butter_ba_norm(1, (f8k * 0.8, f8k * 1.2), "band")
    gains = (_db(-0.5), _db(-0.3), _db(0.3), _db(0.2))
    return (b3, b16, blo, b8), gains


def build_final_spectral_balance(spec: GraphSpec, *, device):
    """Final 'soothe2-style' corrections (25% mix each) + trim +0.5 dB."""
    bas, gains = _final_balance_bas(spec)
    trim = _db(FINAL_TRIM_DB)

    def build(s: GraphSpec):
        if s.exact:
            zps = [make_zp(s, [ba], device=device) for ba in bas]
            params = [z.params for z in zps]

            def fn(x, params):
                y = x
                for z, p, g in zip(zps, params, gains):
                    y = y + (g - 1.0) * z(x, p) * 0.25
                return y * trim

        else:
            padlen = scipy_padlen([bas[0]])
            settle = design.settle_len(*bas)
            nfft = fft_staged.site_plan(
                s.n + 2 * padlen + 3 * settle + 16, device)[0]
            R = np.ones(nfft // 2 + 1, np.float64)
            for ba, g in zip(bas, gains):
                R = R + (g - 1.0) * design.zero_phase_power([ba], nfft) * 0.25
            R = R * trim  # fast path applies R directly (no squaring)
            zp = make_zp_from_power(s, R, nfft, padlen, settle, device=device)
            params = [zp.params]

            def fn(x, params):
                return zp(x, params[0])

        return params, fn

    settle = design.settle_len(*bas)
    return hybridize_op(spec, settle, scipy_padlen([bas[0]]), build)


def build_final_balance_then_style(spec: GraphSpec, style: str = "standard",
                                   *, device):
    """Fused ``final_spectral_balance → style_eq``: one fast pass over the
    product response, the two exact two-pass ops in turn on the edge
    windows.  Returns ``None`` when the style has no EQ bands."""
    bands = _style_bands(spec, style)
    if not bands:
        return None
    bas_fb, gains_fb = _final_balance_bas(spec)
    trim = _db(FINAL_TRIM_DB)
    # composition transient <= the sum of the two ops' settles; padlen is
    # per op (each exact sub-op extends inside the window)
    settle = design.settle_len(*bas_fb) + design.settle_len(
        *[ba for ba, _ in bands])
    padlen = max(scipy_padlen([bas_fb[0]]), scipy_padlen([bands[0][0]]))

    def build(s: GraphSpec):
        if s.exact:
            s1 = dataclasses.replace(s, hybrid=False)
            p1, f1 = build_final_spectral_balance(s1, device=device)
            p2, f2 = build_style_eq(s1, style, device=device)
            params = [list(p1), list(p2)]

            def fn(x, params):
                return f2(f1(x, params[0]), params[1])

        else:
            nfft = fft_staged.site_plan(
                s.n + 2 * padlen + 3 * settle + 16, device)[0]
            R = np.ones(nfft // 2 + 1, np.float64)
            for ba, g in zip(bas_fb, gains_fb):
                R = R + (g - 1.0) * design.zero_phase_power([ba], nfft) * 0.25
            R = R * trim
            for ba, g in bands:
                R = R * (1.0 + (g - 1.0) * design.zero_phase_power([ba], nfft))
            zp = make_zp_from_power(s, R, nfft, padlen, settle, device=device)
            params = [zp.params]

            def fn(x, params):
                return zp(x, params[0])

        return params, fn

    return hybridize_op(spec, settle, padlen, build)


def build_rumble_filter(spec: GraphSpec, cutoff_hz: float = 80.0, *, device):
    """Zero-phase Butterworth-2 high pass at ``cutoff_hz`` (20..200 Hz)."""
    cutoff_hz = float(np.clip(cutoff_hz, 20.0, 200.0))
    ba = design.butter_ba_norm(2, min(cutoff_hz / spec.nyq, 0.99), "high")
    zp = make_zp(spec, [ba], device=device)

    def fn(x, params):
        return zp(x, params[0])

    return [zp.params], fn


def build_high_freq_trim(spec: GraphSpec, crossover_hz: float = 5000.0,
                         high_gain: float = 0.9, *, device=None):
    """Zero-phase Butterworth-2 low pass at ``crossover_hz``, the highs
    above it scaled by ``high_gain``, clipped to [-1, 1]; the identity
    where ``high_gain`` is within 0.001 of 1."""
    if abs(high_gain - 1.0) < 0.001:
        return [], lambda x, params: x
    ba = design.butter_ba_norm(2, min(crossover_hz / spec.nyq, 0.98), "low")
    zp = make_zp(spec, [ba], device=resolve_device(device))

    def fn(x, params):
        low = zp(x, params[0])
        return (low + high_gain * (x - low)).clamp(-1.0, 1.0)

    return [zp.params], fn
