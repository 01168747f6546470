"""Cross-op spectrum-sharing fusions of the v1 chain and the v2 chain.

Counterpart of ``amw_tpu/ops/fused.py``:

- ``target_curve → deesser``: the de-esser's sidechain is a zero-phase
  bandpass of the target-curve output, so both come from one forward FFT
  (``irfft(X·Rt)`` and ``irfft(X·Rt·Rb)``);
- ``normalize_lufs → final_spectral_balance [→ style_eq]``: normalization
  is a per-track scalar gain, so the K-weighted measurement and the EQ read
  the same spectrum: ``out = g · irfft(X·R_eq)`` with ``g`` from
  ``irfft(X·Hk)``;
- ``target_curve → dynamics`` (the v2 chain): the target curve's power
  response rides the band split's shared forward FFT
  (:func:`target_curve_pre` in front of ``bands.band_split_plan``).

Fast interiors skip the odd extension (only the outer settle+padlen
samples depend on it, and those are replaced by the spliced exact edge
windows).  Signals are ``[B, C, N]``; ``n_valid`` is per track.

At plans the staged FFT takes (``fft_staged.site_plan``: on CUDA from
about 5.8 s at 44.1 kHz) the interior runs through
``fft_staged.site_roundtrip`` (forward, both responses and the inverse in
the staged kernels) and the params follow the JAX package's Pallas route
(``fft_staged.site_params``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import FINAL_TRIM_DB
from ..spec import GraphSpec
from . import design, fft_staged, validctx
from .eq import (_db, _final_balance_bas, _style_bands, _target_curve_bas,
                 build_final_spectral_balance, build_style_eq,
                 build_target_curve, target_curve_power)
from .meters import (block_energies, gated_loudness, k_weight_settle,
                     normalize_lufs_gain, plan_blocks, valid_block_mask)
from .scan import ar_coefs, deesser_gain_combine
from .zphase import PreLTI, _edge_windows, make_zp, pack_complex, scipy_padlen


def build_target_then_deesser(spec: GraphSpec, threshold_db: float = -6.0,
                              ratio: float = 3.0, freq_lo: float = 5000.0,
                              freq_hi: float = 9000.0, attack_ms: float = 4.0,
                              release_ms: float = 85.0, *, device):
    """Fused minimum-phase target curve + de-esser.  Returns ``None`` when
    the fusion does not apply (empty sibilance band, tiny tracks, or a
    non-hybrid spec)."""
    lo_n = min(freq_lo / spec.nyq, 0.97)
    hi_n = min(freq_hi / spec.nyq, 0.97)
    if lo_n >= hi_n or not (spec.exact and spec.hybrid):
        return None
    hp, lp, pr, md = _target_curve_bas(spec)
    band = design.butter_ba_norm(2, (lo_n, hi_n), "band")

    settle_t = design.settle_len(hp, lp, pr, md)
    settle_b = design.settle_len(band)
    padlen = max(scipy_padlen([hp]), scipy_padlen([band]))
    # Window sized for the target∘bandpass composition (sidechain edges).
    L, w = _edge_windows(settle_t + settle_b, padlen, spec.n)
    if 2 * w + 16 >= spec.n:
        return None
    nfft, staged = fft_staged.site_plan(
        spec.n + 2 * padlen + 3 * (settle_t + settle_b) + 16, device)

    Rt = target_curve_power(spec, nfft)
    Rtb = Rt * design.zero_phase_power([band], nfft)

    small_spec = dataclasses.replace(spec, n=w, hybrid=False)
    p_t, f_t = build_target_curve(small_spec, device=device)
    band_zp = make_zp(small_spec, [band], device=device)

    att, rel = ar_coefs(spec.sr, attack_ms / 1000.0, release_ms / 1000.0)
    thresh = _db(threshold_db)
    k = max(3, int(spec.sr * 0.0015))
    if k % 2 == 0:
        k += 1
    if staged:
        params = fft_staged.site_params([Rt, Rtb], nfft, list(p_t),
                                        list(band_zp.params))
    else:
        params = [np.stack([Rt, Rtb]).astype(np.float32), list(p_t),
                  list(band_zp.params)]
    n = spec.n

    def fn(x, params):
        R2, pt, pb = params[:3]
        nv = validctx.n_valid()
        xr = validctx.right_window(x, w, nv)
        with validctx.cleared():
            if staged:
                # full nfft-length outputs: the splice slices to n
                ys = fft_staged.site_roundtrip(x, params, nfft)
            else:
                X = torch.fft.rfft(x, n=nfft, dim=-1)
                # one batched irfft over both responses
                Rb = R2.reshape((2,) + (1,) * (X.ndim - 1)
                                + (R2.shape[-1],))
                ys = torch.fft.irfft(X[None] * Rb, n=nfft, dim=-1)[..., :n]
            y3_f, sc_f = ys[0], ys[1]
            # exact edges: target on raw windows, band on the exact target
            # output
            y3lr = f_t(torch.stack([x[..., :w], xr]), pt)
            sclr = band_zp(y3lr, pb)
        y3 = validctx.splice(y3_f, y3lr[0], y3lr[1], n, L, nv)
        sc = validctx.splice(sc_f, sclr[0], sclr[1], n, L, nv)
        # envelope -> gain (kernel) -> box (kernel) -> combine
        return deesser_gain_combine(y3, sc, att, rel, thresh, ratio, k, nv=nv)

    return params, fn


def target_curve_pre(spec: GraphSpec) -> PreLTI:
    """The minimum-phase, per-channel target curve as a
    :class:`~amw_tpu_torch.ops.zphase.PreLTI`, for fusion in front of a
    band split."""
    hp, lp, pr, md = _target_curve_bas(spec)
    return PreLTI(settle=design.settle_len(hp, lp, pr, md),
                  padlen=scipy_padlen([hp]),
                  power=lambda nfft: target_curve_power(spec, nfft),
                  small_build=build_target_curve)


def build_target_then_dynamics(spec: GraphSpec, *, device, **dyn_kwargs):
    """Fused ``target_curve`` (minimum phase, per channel) + ``dynamics``:
    the band split's shared forward FFT also carries the target curve."""
    from .bands import build_dynamics

    return build_dynamics(spec, pre=target_curve_pre(spec), device=device,
                          **dyn_kwargs)


def build_normalize_then_final(spec: GraphSpec, target_lufs: float = -14.0,
                               style: str | None = None, *, device):
    """Fused normalize_lufs + final_spectral_balance (+ style_eq when the
    style has EQ bands).  Returns ``(params, fn, fused_ids)`` or ``None``
    when hybrid splicing does not apply."""
    if not (spec.exact and spec.hybrid):
        return None
    bas_fb, gains_fb = _final_balance_bas(spec)
    trim = _db(FINAL_TRIM_DB)
    bands = _style_bands(spec, style) if style is not None else []

    settle_e = design.settle_len(*bas_fb)
    padlen = scipy_padlen([bas_fb[0]])
    if bands:
        settle_e += design.settle_len(*[ba for ba, _ in bands])
        padlen = max(padlen, scipy_padlen([bands[0][0]]))
    L, w = _edge_windows(settle_e, padlen, spec.n)
    if 2 * w + 16 >= spec.n:
        return None

    settle_k = k_weight_settle(spec.sr)
    nfft, staged = fft_staged.site_plan(
        spec.n + max(2 * padlen + 3 * settle_e + 16, settle_k), device)
    plan = plan_blocks(spec.sr, spec.n)
    Hk_c = design.cascade_response(design.k_weighting_ba(spec.sr), nfft)

    R = np.ones(nfft // 2 + 1, np.float64)
    for ba, g in zip(bas_fb, gains_fb):
        R = R + (g - 1.0) * design.zero_phase_power([ba], nfft) * 0.25
    R = R * trim
    for ba, g in bands:
        R = R * (1.0 + (g - 1.0) * design.zero_phase_power([ba], nfft))

    small_spec = dataclasses.replace(spec, n=w, hybrid=False)
    p_fb, f_fb = build_final_spectral_balance(small_spec, device=device)
    if bands:
        p_se, f_se = build_style_eq(small_spec, style, device=device)

        def f_small(xw, ps):
            return f_se(f_fb(xw, ps[0]), ps[1])

        p_small = [list(p_fb), list(p_se)]
        fused_ids = "normalize_lufs+final_spectral_balance+style_eq"
    else:
        f_small, p_small = f_fb, list(p_fb)
        fused_ids = "normalize_lufs+final_spectral_balance"

    if staged:
        params = fft_staged.site_params([Hk_c, R], nfft,
                                        np.float32(target_lufs), p_small)
    else:
        params = [pack_complex(Hk_c), np.float32(target_lufs),
                  R.astype(np.float32), p_small]
    n = spec.n

    def fn(x, params):
        nv = validctx.n_valid()
        xr = validctx.right_window(x, w, nv)
        if staged:
            # full nfft-length outputs: block_energies frames only the
            # plan's span and the splice slices to n
            tgt, ps = params[1:3]
            z = fft_staged.site_roundtrip(x, params, nfft)
        else:
            Hk_d, tgt, R_d, ps = params
            X = torch.fft.rfft(x, n=nfft, dim=-1)
            # one batched irfft over K-weighting + EQ responses
            Y = torch.stack([X * torch.complex(Hk_d[0], Hk_d[1]), X * R_d])
            z = torch.fft.irfft(Y, n=nfft, dim=-1)[..., :n]
        # Causal K-weighting ringout past the valid end must not leak into
        # the truncated-tail gating blocks.
        yk = validctx.mask_tail(z[0], nv)
        mask = None if nv is None else valid_block_mask(plan, nv)
        lufs = gated_loudness(block_energies(yk, plan), block_mask=mask)
        g = validctx.per_track(normalize_lufs_gain(lufs, tgt), x)
        fast = z[1] * g
        with validctx.cleared():
            elr = f_small(torch.stack([x[..., :w], xr]) * g, ps)
        return validctx.splice(fast, elr[0], elr[1], n, L, nv)

    return params, fn, fused_ids
