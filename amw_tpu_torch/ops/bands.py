"""Multiband dynamics: band split, per-band soft-knee compression,
maximizer, brickwall limiter.

Counterpart of ``amw_tpu/ops/bands.py`` with both compressors: the
memoryless ``soft_knee`` (the reference's scipy fallback,
pipeline.py:282-330, the v1 default) and the ``envelope`` compressor (an
attack/release detector per band, the stand-in for the reference's
Pedalboard band compressor): the four bands come out of the split, each
band with ``ratio >= 1`` runs ``scan.envelope_follower`` (on the card the
chunked envelope kernel), then the limiter and gain.

Reference: backend/app/pipeline.py:333-481 (4-band Butterworth-2 filtfilt
split, ``apply_multiband_dynamics``) and :610-641 (``apply_dynamics`` =
multiband → maximizer → brickwall at -1.5 dBTP).

At plans the staged FFT takes (``fft_staged.site_plan``) the hybrid split
runs through ``fft_staged.site_roundtrip``: with band maps, one pipeline
from the signal to the mixed output (the maps and the band sum inside the
final inverse kernel, which reads each :class:`BandMap`'s parameter row);
without (the envelope compressor), the four bands.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..constants import (MULTIBAND_ATTACK_RELEASE_MS, MULTIBAND_CONFIG,
                         MULTIBAND_CROSSOVERS_HZ, TRUE_PEAK_LIMIT_DB)
from ..spec import GraphSpec
from . import design, fft_staged, validctx
from .basic import compress_soft_knee, db_to_lin, limiter, maximizer
from .fdfilter import odd_ext
from .scan import ar_coefs, envelope_follower
from .zphase import _edge_windows, make_zp, make_zp_from_power, scipy_padlen


def normalize_crossovers(crossovers_hz):
    cross = (tuple(float(c) for c in crossovers_hz)
             if crossovers_hz and len(crossovers_hz) == 3
             else MULTIBAND_CROSSOVERS_HZ)
    cross = tuple(float(np.clip(c, 20.0, 20000.0)) for c in cross)
    if cross[0] >= cross[1] or cross[1] >= cross[2]:
        cross = MULTIBAND_CROSSOVERS_HZ
    return cross


def band_split_plan(spec: GraphSpec, crossovers_hz=None, pre=None,
                    band_maps=None, *, device):
    """Prepare the 4-band split.  Returns ``(params, split_fn)`` where
    ``split_fn(x, params) -> [band1..band4]``, or, with ``band_maps`` (K
    memoryless per-sample callables), the mixed ``sum_k band_maps[k]
    (band_k)``.

    Hybrid mode shares ONE forward FFT across the four band responses and
    splices exact two-pass edge windows per band.  ``pre`` (PreLTI): a
    pure-LTI op fused in front of the split."""
    cross = normalize_crossovers(crossovers_hz)
    nyq = spec.nyq
    f1, f2, f3 = (min(c / nyq, 0.99) for c in cross)

    def lp(f):
        return design.butter_ba_norm(2, f, "low")

    def hp(f):
        return design.butter_ba_norm(2, f, "high")

    stages = [[lp(f1)], [hp(f1), lp(f2)], [hp(f2), lp(f3)], [hp(f3)]]
    all_bas = [ba for chain in stages for ba in chain]
    padlen = scipy_padlen([all_bas[0]])
    settle = design.settle_len(*all_bas)
    if pre is not None:
        padlen = max(padlen, pre.padlen)
        settle = settle + pre.settle

    def build_twopass(s, apply_maps=True):
        s1 = dataclasses.replace(s, hybrid=False)
        zps = [[make_zp(s1, [ba], device=device) for ba in chain]
               for chain in stages]
        band_params = [[z.params for z in chain] for chain in zps]
        if pre is not None:
            p_pre, f_pre = pre.small_build(s1, device=device)
            params = [list(p_pre), band_params]
        else:
            params = band_params

        def split_fn(x, params):
            if pre is not None:
                pp, bp = params
                x = f_pre(x, pp)
            else:
                bp = params
            out = []
            for chain, ps in zip(zps, bp):
                y = x
                for z, p in zip(chain, ps):
                    y = z(y, p)
                out.append(y)
            if band_maps is not None and apply_maps:
                return sum(band_maps[i](out[i]) for i in range(4))
            return out

        return params, split_fn

    if spec.exact and spec.hybrid:
        L, w_in = _edge_windows(settle, padlen, spec.n)
        if 2 * w_in + 16 >= spec.n:
            # short signals: pure two-pass
            return build_twopass(spec)
        n = spec.n
        nfft, staged = fft_staged.site_plan(n + 2 * padlen + 3 * settle + 16,
                                            device)
        R_pre = pre.power(nfft) if pre is not None else 1.0
        R_half = [np.prod([design.zero_phase_power([ba], nfft)
                           for ba in chain], axis=0) * R_pre
                  for chain in stages]
        small_spec = dataclasses.replace(spec, n=w_in, hybrid=False)
        p_small, f_small = build_twopass(small_spec, apply_maps=False)
        if staged:
            params = fft_staged.site_params(R_half, nfft, p_small)
        else:
            params = [np.stack(R_half).astype(np.float32), p_small]

        def split_fn(x, params):
            Rd, ps = params[:2]
            nv = validctx.n_valid()
            xr = validctx.right_window(x, w_in, nv)
            with validctx.cleared():
                # staged: extend and zero-pad to nfft in one concatenate
                core = odd_ext(x, padlen, pad_to=nfft if staged else None)
                lr = f_small(torch.stack([x[..., :w_in], xr]), ps)
            if staged:
                if band_maps is not None:
                    # maps and band sum inside the final inverse kernel;
                    # full nfft-length output, the splice slices past the
                    # odd extension (off=padlen)
                    mix = fft_staged.site_roundtrip(core, params, nfft,
                                                    band_maps)
                    el = sum(band_maps[i](lr[i][0]) for i in range(4))
                    er = sum(band_maps[i](lr[i][1]) for i in range(4))
                    return validctx.splice(mix, el, er, n, L, nv, off=padlen)
                ys = fft_staged.site_roundtrip(core, params, nfft)
                return [validctx.splice(ys[i], lr[i][0], lr[i][1], n, L, nv,
                                        off=padlen) for i in range(4)]
            # One batched inverse over the 4 band responses.
            X = torch.fft.rfft(core, n=nfft, dim=-1)
            Rb = Rd.reshape((4,) + (1,) * (X.ndim - 1) + (Rd.shape[-1],))
            ys = torch.fft.irfft(X[None] * Rb, n=nfft,
                                 dim=-1)[..., padlen:padlen + n]
            out = [validctx.splice(ys[i], lr[i][0], lr[i][1], n, L, nv)
                   for i in range(4)]
            if band_maps is not None:
                return sum(band_maps[i](out[i]) for i in range(4))
            return out

        return params, split_fn

    if spec.exact:
        return build_twopass(spec)

    nfft = fft_staged.site_plan(spec.n + 2 * padlen + 3 * settle + 16,
                                device)[0]
    R_pre = pre.power(nfft) if pre is not None else 1.0
    zps = []
    for chain in stages:
        R = np.ones(nfft // 2 + 1, np.float64) * R_pre
        for ba in chain:
            R = R * design.zero_phase_power([ba], nfft)
        zps.append(make_zp_from_power(spec, R, nfft, padlen, settle,
                                      device=device))
    params = [z.params for z in zps]

    def split_fn(x, params):
        out = [z(x, p) for z, p in zip(zps, params)]
        if band_maps is not None:
            return sum(band_maps[i](out[i]) for i in range(4))
        return out

    return params, split_fn


@dataclasses.dataclass(frozen=True)
class BandMap:
    """One band's memoryless map: ``compress_soft_knee`` → ``limiter`` →
    ``gain``.  Callable on a tensor (the plain path), and described by
    :meth:`table_row` for the staged FFT's reduce kernel."""

    threshold_db: float
    ratio: float
    knee_db: float
    max_upward_boost_db: float
    limit_db: float
    gain: float

    def __call__(self, band: torch.Tensor) -> torch.Tensor:
        band = compress_soft_knee(
            band, threshold_db=self.threshold_db, ratio=self.ratio,
            knee_db=self.knee_db,
            max_upward_boost_db=self.max_upward_boost_db)
        return limiter(band, threshold_db=self.limit_db) * self.gain

    def table_row(self) -> tuple:
        """``(mode, p1..p5, limit, gain)`` by the formulas and branches of
        ``basic.compress_soft_knee`` (see ``csrc/fft_reduce.cu``): mode 0
        bypass, 1 upward boost (threshold dB, 1 - ratio, max boost dB),
        2 hard knee (threshold, ratio), 3 soft knee (threshold, ratio,
        lower, upper, knee slope)."""
        thresh = db_to_lin(self.threshold_db)
        knee = max(0.0, float(self.knee_db))
        if self.ratio <= 0.0 or self.ratio == 1.0:
            head = (0, 0.0, 0.0, 0.0, 0.0, 0.0)
        elif self.ratio < 1.0:
            head = (1, self.threshold_db, 1.0 - self.ratio,
                    max(0.1, float(self.max_upward_boost_db)), 0.0, 0.0)
        elif knee < 0.5:
            head = (2, thresh, self.ratio, 0.0, 0.0, 0.0)
        else:
            lower = thresh * db_to_lin(-knee)
            upper = thresh * db_to_lin(knee)
            slope = ((thresh + (upper - thresh) / self.ratio - lower)
                     / (upper - lower))
            head = (3, thresh, self.ratio, lower, upper, slope)
        return head + (db_to_lin(self.limit_db), self.gain)


def build_multiband_dynamics(spec: GraphSpec, knee_db: float = 6.0,
                             crossovers_hz=None, band_ratios=None,
                             max_upward_boost_db: float = 12.0,
                             compressor: str = "soft_knee", pre=None, *,
                             device):
    ratios_override = (tuple(float(band_ratios[i]) for i in range(4))
                       if band_ratios is not None and len(band_ratios) == 4
                       else None)

    def _map(i):
        lim_db, comp_ratio, comp_db, gain = MULTIBAND_CONFIG[i]
        ratio = ratios_override[i] if ratios_override else comp_ratio
        return BandMap(comp_db, ratio, knee_db, max_upward_boost_db, lim_db,
                       gain)

    maps = [_map(i) for i in range(4)]
    if compressor != "envelope":
        # soft-knee is memoryless per sample, so the per-band compress,
        # limiter, gain and the band sum all fuse into the split.
        return band_split_plan(spec, crossovers_hz, pre=pre, band_maps=maps,
                               device=device)

    params, split_fn = band_split_plan(spec, crossovers_hz, pre=pre,
                                       device=device)

    def fn(x, params):
        out = None
        for i, band in enumerate(split_fn(x, params)):
            m = maps[i]
            if m.ratio >= 1.0:
                atk_ms, rel_ms = MULTIBAND_ATTACK_RELEASE_MS[i]
                band = _envelope_compress(band, spec.sr, m.threshold_db,
                                          m.ratio, atk_ms, rel_ms)
            else:
                band = compress_soft_knee(
                    band, threshold_db=m.threshold_db, ratio=m.ratio,
                    knee_db=m.knee_db,
                    max_upward_boost_db=m.max_upward_boost_db)
            band = limiter(band, threshold_db=m.limit_db) * m.gain
            out = band if out is None else out + band
        return out

    return params, fn


def _envelope_compress(band, sr, threshold_db, ratio, attack_ms, release_ms):
    """Feed-forward compressor with an attack/release detector."""
    att, rel = ar_coefs(sr, attack_ms / 1000.0, release_ms / 1000.0)
    env = envelope_follower(band.abs(), att, rel)
    env_db = 20.0 * torch.log10(env.clamp(min=1e-10))
    gain_db = (env_db - threshold_db).clamp(min=0.0) * (1.0 / ratio - 1.0)
    return band * 10.0 ** (gain_db / 20.0)


def build_dynamics(spec: GraphSpec, knee_db: float = 6.0, crossovers_hz=None,
                   band_ratios=None, max_upward_boost_db: float = 12.0,
                   compressor: str = "soft_knee", pre=None, *, device):
    """Full dynamics stage: 4-band dynamics → maximizer → brickwall."""
    params, mb_fn = build_multiband_dynamics(
        spec, knee_db, crossovers_hz, band_ratios, max_upward_boost_db,
        compressor, pre=pre, device=device)

    def fn(x, params):
        y = mb_fn(x, params)
        y = maximizer(y)
        return limiter(y, threshold_db=TRUE_PEAK_LIMIT_DB)

    return params, fn
