"""Harmonic exciter: HF band saturation (counterpart of
``amw_tpu/ops/exciter.py``).

At ``oversample == 1`` (every style and the default v2 chain) the exciter
is a zero-phase 6 kHz high pass (``zphase.make_zp``: the staged FFT's
``apply_response`` at its plans on a GPU), a waveshaper and a mix.  The
oversampled variant needs the JAX package's FFT resampler
(``fdfilter.resample_fft``), which is not ported: it raises
``NotImplementedError`` (ROADMAP.md, 'Modules to port':
amw_tpu/ops/fdfilter.py).

Reference: backend/app/pipeline.py:1267-1326 (``apply_harmonic_exciter``)
and :1179-1197 (waveshaper curves).
"""

from __future__ import annotations

from ..spec import GraphSpec
from . import design
from .basic import exciter_saturate
from .zphase import make_zp


def build_harmonic_exciter(spec: GraphSpec, exciter_db: float = 0.0,
                           mode: str = "warm", oversample: int = 1, *,
                           device):
    if abs(exciter_db) < 0.05:
        return [], lambda x, params: x
    os_f = max(1, min(4, int(oversample)))
    if os_f > 1:
        raise NotImplementedError(
            f"the harmonic exciter at oversample={os_f} needs "
            "fdfilter.resample_fft, which is not ported to amw_tpu_torch yet "
            "(ROADMAP.md, 'Modules to port': amw_tpu/ops/fdfilter.py)")
    ba = design.butter_ba_norm(2, min(6000.0 / (spec.sr / 2.0), 0.97), "high")
    zp = make_zp(GraphSpec(sr=spec.sr, n=spec.n, channels=spec.channels,
                           exact=spec.exact), [ba], device=device)
    gain = 10.0 ** (exciter_db / 20.0) - 1.0
    sat_mode = mode if mode in ("warm", "tape", "tube", "transistor",
                                "digital") else "warm"
    k = 2.5 if sat_mode == "warm" else 2.0
    exciter_mix = 0.25
    # the JAX nesting: [zp params, up-resampler tables, down-resampler
    # tables], the tables empty without oversampling
    params = [zp.params, [], []]

    def fn(x, params):
        hf = zp(x, params[0])
        return x + (exciter_saturate(hf, sat_mode, k) - hf) * gain \
            * exciter_mix

    return params, fn
