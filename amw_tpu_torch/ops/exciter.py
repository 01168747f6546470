"""Harmonic exciter: HF band saturation with optional FFT oversampling
(counterpart of ``amw_tpu/ops/exciter.py``).

A zero-phase 6 kHz high pass (``zphase.make_zp``: the staged FFT's
``apply_response`` at its plans on a GPU), a waveshaper and a mix.  At
``oversample`` 2 or 4 that section runs at the work rate, between two
FFT resamplings (``fdfilter.resample_fft``, on ``torch.fft``); at 2x on a
180 s bucket the high pass plans 2^24 and runs the staged FFT's kernels,
at 4x it plans 2^25 and runs cuFFT.

Reference: backend/app/pipeline.py:1267-1326 (``apply_harmonic_exciter``)
and :1179-1197 (waveshaper curves).
"""

from __future__ import annotations

from ..spec import GraphSpec
from . import design, validctx
from .basic import exciter_saturate
from .fdfilter import resample_fft
from .zphase import make_zp


def build_harmonic_exciter(spec: GraphSpec, exciter_db: float = 0.0,
                           mode: str = "warm", oversample: int = 1, *,
                           device):
    if abs(exciter_db) < 0.05:
        return [], lambda x, params: x
    os_f = max(1, min(4, int(oversample)))
    work_sr = spec.sr * os_f
    work_n = spec.n * os_f
    ba = design.butter_ba_norm(2, min(6000.0 / (work_sr / 2.0), 0.97), "high")
    zp = make_zp(GraphSpec(sr=work_sr, n=work_n, channels=spec.channels,
                           exact=spec.exact), [ba], device=device)
    gain = 10.0 ** (exciter_db / 20.0) - 1.0
    sat_mode = mode if mode in ("warm", "tape", "tube", "transistor",
                                "digital") else "warm"
    k = 2.5 if sat_mode == "warm" else 2.0
    exciter_mix = 0.25
    # the JAX nesting: [zp params, up-resampler tables, down-resampler
    # tables]; the port's resampler needs no tables (fdfilter.resample_plan)
    # and ignores slots 1-2, which the JAX package fills with Bluestein
    # tables at lengths outside XLA-TPU's native FFT sizes
    params = [zp.params, [], []]

    def excite(x, p):
        hf = zp(x, p)
        return x + (exciter_saturate(hf, sat_mode, k) - hf) * gain \
            * exciter_mix

    if os_f == 1:
        return params, lambda x, params: excite(x, params[0])

    def fn(x, params):
        # the oversampled section runs in work-rate samples: the valid
        # length is scaled with it, so the zero-phase filter anchors its
        # edges at the true track end (FFT resampling of a zero-padded
        # bucket is a periodic interpolation, so padding invariance holds
        # to the sinc tail's level here, not exactly)
        nv = validctx.n_valid()
        with validctx.valid_length(None if nv is None else nv * os_f):
            out = excite(resample_fft(x, work_n), params[0])
        return resample_fft(out, spec.n)

    return params, fn
