"""Zero-phase filter passes — the building blocks for EQ-style ops.

Counterpart of ``amw_tpu/ops/zphase.py``.  Three strategies, selected by
the GraphSpec:

- two-pass exact (``exact=True, hybrid=False``): scipy ``filtfilt``
  emulation, two full-length FFT passes per filter call;
- fast (``exact=False``): one pass with the combined ``|H|²`` response;
- hybrid (``exact=True, hybrid=True``, the default): the fast pass over the
  whole track plus exact two-pass edge windows, spliced.

Every filter object exposes ``.params`` (a list of float32 numpy arrays;
complex responses travel as stacked real/imag planes, as in the JAX
package) and is called as ``filt(x, params)`` with the tensor version of
that list.  Builders take the ``device`` the graph will run on to plan
their FFTs (``fft_staged.site_plan``): a fast pass at a plan the staged FFT
takes (on CUDA from about 5.8 s at 44.1 kHz) carries the permuted response
and the plan tables, as the JAX package's ``ZP(pallas=True)``, and runs
``fft_staged.apply_response``; exact two-pass filters run ``torch.fft`` at
every size, as the JAX package runs XLA's FFT there.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field

import numpy as np
import torch

from ..spec import GraphSpec
from . import design, fft_staged, validctx
from .fdfilter import filtfilt_fd, lfilter_fd, odd_ext, odd_ext_valid


def scipy_padlen(ba_pairs) -> int:
    """scipy.signal.filtfilt default padlen for a single (b, a): 3*max(len)."""
    return max(3 * max(len(np.atleast_1d(b)), len(np.atleast_1d(a)))
               for b, a in ba_pairs)


def pack_complex(H: np.ndarray) -> np.ndarray:
    """complex response -> float32 [2, n] (real, imag)."""
    return np.stack([H.real, H.imag]).astype(np.float32)


def unpack_complex(p: torch.Tensor) -> torch.Tensor:
    return torch.complex(p[0], p[1])


@dataclass
class ZP:
    """One zero-phase pass (two-pass exact or fast).  ``staged``: a fast
    pass whose params are ``[permuted response, plan tables]`` for the
    staged FFT."""

    nfft: int
    padlen: int
    settle: int
    exact: bool
    params: list = field(repr=False)  # [resp]: packed complex | f32 power
    staged: bool = False

    def __call__(self, x, params):
        resp = params[0]
        nv = validctx.n_valid()
        if self.padlen >= x.shape[-1]:
            # scipy filtfilt raises for padlen >= n; the reference's
            # _safe_filtfilt then falls back to causal lfilter (exact
            # mode); fast mode bypasses (sub-10-sample input).
            if self.exact:
                return lfilter_fd(x, unpack_complex(resp), self.nfft)
            return x
        if self.staged:
            n = x.shape[-1]
            p = min(self.padlen, max(n - 1, 0))
            # extend and zero-pad to nfft in one concatenate
            core = (odd_ext(x, p, pad_to=self.nfft) if nv is None
                    else odd_ext_valid(x, p, nv, pad_to=self.nfft))
            y = fft_staged.apply_response(core, resp, self.nfft,
                                          tables=params[1])
            return validctx.mask_tail(y[..., p:p + n], nv)
        H = unpack_complex(resp) if self.exact else resp
        return filtfilt_fd(x, H, self.nfft, padlen=self.padlen,
                           settle=self.settle, exact=self.exact, nv=nv)


@dataclass
class HybridZP:
    """Fast full pass + exact edge windows, spliced."""

    n: int
    L: int
    w_in: int
    fast: ZP
    small: ZP

    @property
    def params(self):
        return [self.fast.params, self.small.params]

    def __call__(self, x, params):
        pf, ps = params
        nv = validctx.n_valid()
        xr = validctx.right_window(x, self.w_in, nv)
        # The fast interior and the extracted edge windows have their track
        # ends at static positions: run them with the context cleared.
        with validctx.cleared():
            y = self.fast(x, pf)
            ylr = self.small(torch.stack([x[..., :self.w_in], xr]), ps)
        return validctx.splice(y, ylr[0], ylr[1], self.n, self.L, nv)


@dataclass
class PreLTI:
    """A pure-LTI op to fuse in front of a multi-response split so the
    forward FFT is shared.  ``power(nfft)``: zero-phase power response
    (float64, rFFT grid); ``small_build(spec, device=...)``: the exact
    two-pass ``(params, fn)`` at window size for edge splicing."""

    settle: int
    padlen: int
    power: object
    small_build: object


def _edge_windows(settle: int, padlen: int, n: int) -> tuple[int, int]:
    L = settle + padlen + 256
    w_in = min(n, L + settle + padlen + 256)
    return L, w_in


def make_zp(spec: GraphSpec, ba_pairs, nfft: int | None = None, *, device):
    """Zero-phase pass for a cascade of (b, a) pairs, strategy per spec."""
    settle = design.settle_len(*ba_pairs)
    padlen = scipy_padlen(ba_pairs)

    def build(exact: bool, n: int, nfft_in=None):
        nfft_l = nfft_in or fft_staged.site_plan(
            n + 2 * padlen + 3 * settle + 16, device)[0]
        if exact:
            resp = pack_complex(design.cascade_response(ba_pairs, nfft_l))
            return ZP(nfft=nfft_l, padlen=padlen, settle=settle, exact=True,
                      params=[resp])
        return make_zp_from_power(spec, design.zero_phase_power(ba_pairs,
                                                                nfft_l),
                                  nfft_l, padlen, settle, device=device)

    if not spec.exact:
        return build(False, spec.n, nfft)
    L, w_in = _edge_windows(settle, padlen, spec.n)
    if not spec.hybrid or 2 * w_in + 16 >= spec.n:
        return build(True, spec.n, nfft)
    return HybridZP(n=spec.n, L=L, w_in=w_in,
                    fast=build(False, spec.n, nfft),
                    small=build(True, w_in))


def make_zp_from_power(spec: GraphSpec, power: np.ndarray, nfft: int,
                       padlen: int, settle: int, *, device) -> ZP:
    """Fast-mode pass from an arbitrary combined real power response: on
    the staged FFT where ``fft_staged.enabled`` takes ``nfft``."""
    if fft_staged.enabled(nfft, device):
        return ZP(nfft=nfft, padlen=padlen, settle=settle, exact=False,
                  params=[fft_staged.permute_full_response(power, nfft),
                          fft_staged.plan_params(nfft)], staged=True)
    return ZP(nfft=nfft, padlen=padlen, settle=settle, exact=False,
              params=[power.astype(np.float32)])


def hybridize_op(spec: GraphSpec, settle: int, padlen: int, build):
    """Op-level hybrid: ``build(spec)`` must honor spec.exact/hybrid and
    return ``(params, fn)``; wraps the op's fast variant (whole track) with
    its two-pass-exact variant (edge windows only).  Only valid for
    pure-LTI position-independent ops."""
    L, w_in = _edge_windows(settle, padlen, spec.n)
    if not spec.exact:
        return build(spec)
    if not spec.hybrid or 2 * w_in + 16 >= spec.n:
        return build(dataclasses.replace(spec, hybrid=False))
    p_small, f_small = build(dataclasses.replace(spec, n=w_in, hybrid=False))
    p_fast, f_fast = build(dataclasses.replace(spec, exact=False))
    params = [p_fast, p_small]
    n = spec.n

    def fn(x, params):
        pf, ps = params
        nv = validctx.n_valid()
        xr = validctx.right_window(x, w_in, nv)
        with validctx.cleared():
            y = f_fast(x, pf)
            ylr = f_small(torch.stack([x[..., :w_in], xr]), ps)
        return validctx.splice(y, ylr[0], ylr[1], n, L, nv)

    return params, fn
