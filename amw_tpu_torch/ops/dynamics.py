"""Envelope-driven dynamics ops (counterpart of ``amw_tpu/ops/dynamics.py``):
de-esser, dynamic EQ, transient designer, transient-aware maximizer.

Every envelope runs through :func:`~amw_tpu_torch.ops.scan.
envelope_follower` (the chunked or the per-row CUDA kernel on a GPU) and
every band filter through a zero-phase pass (``zphase.make_zp``: the
staged FFT's ``apply_response`` at its plans on a GPU).  Signals are
``[B, C, N]``.

Reference: backend/app/pipeline.py:1200-1264 (de-esser), :1628-1696
(dynamic EQ), :1736-1768 (transient designer), :521-545 (transient-aware
maximizer).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import DYNAMIC_EQ_MASTERING_BANDS
from ..spec import GraphSpec
from . import design, validctx
from .basic import maximizer
from .eq import _db
from .scan import ar_coefs, deesser_gain_combine, envelope_follower
from .zphase import make_zp


def _scrub(x: torch.Tensor, fill: float) -> torch.Tensor:
    return torch.nan_to_num(x, nan=fill, posinf=fill, neginf=fill)


def build_deesser(spec: GraphSpec, threshold_db: float = -6.0,
                  ratio: float = 3.0, freq_lo: float = 5000.0,
                  freq_hi: float = 9000.0, attack_ms: float = 4.0,
                  release_ms: float = 85.0, *, device):
    """Sibilance-band (5-9 kHz) compressor with smoothed gain curve."""
    lo_n = min(freq_lo / spec.nyq, 0.97)
    hi_n = min(freq_hi / spec.nyq, 0.97)
    if lo_n >= hi_n:
        return [], lambda x, params: x
    ba = design.butter_ba_norm(2, (lo_n, hi_n), "band")
    zp = make_zp(spec, [ba], device=device)
    att, rel = ar_coefs(spec.sr, attack_ms / 1000.0, release_ms / 1000.0)
    thresh = _db(threshold_db)
    k = max(3, int(spec.sr * 0.0015))
    if k % 2 == 0:
        k += 1
    params = [zp.params]

    def fn(x, params):
        sidechain = zp(x, params[0])
        return deesser_gain_combine(x, sidechain, att, rel, thresh, ratio, k,
                                    nv=validctx.n_valid())

    return params, fn


def build_dynamic_eq(spec: GraphSpec, bands=None, *, device):
    """8-band bell-filter dynamic EQ, bands processed sequentially.

    Keeps the JAX package's deliberate divergence from the reference
    (amw_tpu/ops/dynamics.py:68-75): the reference passes a computed
    bandwidth as scipy ``iirpeak``'s Q, which gives unstable bells whose
    only observable behaviour is overflow scrubbed to zeros; this builds
    the stable bell of quality factor ``q`` the reference evidently
    intends."""
    if bands is None:
        bands = DYNAMIC_EQ_MASTERING_BANDS
    plans = []
    for band in bands:
        freq = float(band.get("freq", 1000))
        q = float(band.get("q", 1.4))
        if freq <= 0 or freq >= spec.nyq * 0.98:
            continue
        w0 = float(np.clip(freq / spec.nyq, 0.001, 0.98))
        try:
            ba = design.iirpeak_ba(w0, max(q, 0.1))
        except Exception:  # noqa: BLE001 - the reference skips such a band
            continue
        att, rel = ar_coefs(spec.sr, float(band.get("attack_ms", 5)) / 1000.0,
                            float(band.get("release_ms", 80)) / 1000.0)
        plans.append(dict(
            zp=make_zp(spec, [ba], device=device), att=att, rel=rel,
            thresh=_db(float(band.get("threshold_db", -12))),
            ratio=float(band.get("ratio", 3.0)),
            max_cut=_db(float(band.get("max_cut_db", -6)))))
    params = [p["zp"].params for p in plans]

    def fn(x, params):
        out = x
        for p, resp in zip(plans, params):
            band_sig = _scrub(p["zp"](out, resp), 0.0)
            env = _scrub(envelope_follower(band_sig.abs(), p["att"],
                                           p["rel"]), 0.0)
            gain = torch.where(
                env > p["thresh"],
                ((p["thresh"] + (env - p["thresh"]) / p["ratio"])
                 / (env + 1e-12)).clamp(p["max_cut"], 1.0),
                torch.ones((), dtype=env.dtype, device=env.device))
            gain = _scrub(gain, 1.0).clamp(0.3, 1.0)
            out = out - band_sig + band_sig * gain
        out = torch.where(torch.isfinite(out), out, x)
        return out.clamp(-1.0, 1.0)

    return params, fn


def build_transient_designer(spec: GraphSpec, attack_gain: float = 1.0,
                             sustain_gain: float = 1.0):
    attack_gain = float(np.clip(attack_gain, 0.1, 3.0))
    sustain_gain = float(np.clip(sustain_gain, 0.1, 3.0))
    if abs(attack_gain - 1.0) < 0.02 and abs(sustain_gain - 1.0) < 0.02:
        return [], lambda x, params: x
    f_att, f_rel = ar_coefs(spec.sr, 0.0005, 0.005)
    s_att, s_rel = ar_coefs(spec.sr, 0.005, 0.1)

    def fn(x, params):
        abs_x = x.abs()
        fast = envelope_follower(abs_x, f_att, f_rel)
        slow = envelope_follower(abs_x, s_att, s_rel)
        transient = (fast - slow).clamp(min=0.0)
        gain = ((transient * attack_gain + slow * sustain_gain)
                / (fast + 1e-12)).clamp(0.0, 4.0)
        return (x * gain).clamp(-1.0, 1.0)

    return [], fn


def build_maximizer_transient_aware(spec: GraphSpec,
                                    sensitivity: float = 0.5):
    f_att, f_rel = ar_coefs(spec.sr, 0.0005, 0.002)
    s_att, s_rel = ar_coefs(spec.sr, 0.01, 0.04)

    def fn(x, params):
        limited = maximizer(x)
        mono = x.abs().mean(dim=-2)  # average over the channel axis
        fast = envelope_follower(mono, f_att, f_rel)
        slow = envelope_follower(mono, s_att, s_rel)
        mask = ((fast - slow).clamp(min=0.0) / (slow + 1e-12)
                * float(sensitivity)).clamp(0.0, 1.0)[..., None, :]
        out = limited * (1.0 - mask) + x * mask
        return out.clamp(-1.0, 1.0)

    return [], fn
