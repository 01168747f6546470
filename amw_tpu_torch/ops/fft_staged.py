"""Staged permuted-spectrum FFT: the counterpart of ``amw_tpu/ops/fft_pallas.py``.

An ``nfft``-point transform with ``nfft = A·B·C`` (A = B = 128, C a power
of two in [32, 1024], i.e. nfft in [2^19, 2^24]) runs as three stages over
the ``[A, B, C]`` view of each row:

- stage A: a 128-point DFT along the A axis, times the stage-1 twiddle
  ``t1[a', col] = W_N^(a'·col)`` (``col = b·C + c``);
- stage B: a 128-point DFT along the B axis, times ``T2[b', c] =
  W_(BC)^(b'·c)``;
- stage C: a C-point DFT along the C axis.

The spectrum is left digit-permuted: ``X[k]`` with ``k = a' + A·b' +
A·B·kc(p)`` sits at ``a'·BC + b'·C + p`` (:func:`_perm`, the JAX package's
storage order exactly, composite C stage included).  Every use here is a
convolution, so responses are permuted once on the host
(:func:`permute_full_response`) and the inverse stages (adjoint, reversed)
restore natural order.  Responses built for the JAX package therefore
carry over unchanged.

Every Pallas kernel of the JAX module is ported, each as a CUDA kernel
(``csrc/fft_*.cu``) beside its plain PyTorch version (complex64
``torch.matmul`` with the DFT matrices, f32 arithmetic):

======================================  =====================================
``fft_pallas`` kernel                   here
======================================  =====================================
``_stage_a`` (complex, real-in,         :func:`_stage_a`: ``stage_a_plain`` /
real-out)                               ``stage_a_cuda`` (fft_stage_a.cu)
``_stage_bc``                           :func:`_stage_bc`: ``bc_plain`` /
                                        ``bc_cuda`` (fft_split.cu)
``_stage_cb``                           :func:`_stage_cb`: ``cb_plain`` /
                                        ``cb_cuda`` (fft_split.cu)
``_stage_cb_multi``                     :func:`_stage_cb_multi`:
                                        ``cb_multi_plain`` /
                                        ``cb_multi_cuda`` (fft_split.cu)
``_stage_bc_cb``                        :func:`_stage_bc_cb`:
                                        ``bc_cb_plain`` /
                                        ``bc_cb_cuda`` (fft_bccb.cu)
``_stage_bccb_multi``                   :func:`_stage_bccb_multi`:
                                        ``bccb_multi_plain`` /
                                        ``bccb_multi_cuda`` (fft_bccb.cu)
``_stage_a_inv_join``                   :func:`_stage_a_inv_join`:
                                        ``inv_join_plain`` /
                                        ``inv_join_cuda`` (fft_stage_a.cu)
``_reduce_stage_a_packed``              :func:`_reduce_stage_a_packed`:
                                        ``reduce_packed_plain`` /
                                        ``reduce_packed_cuda`` (fft_reduce.cu)
``_reduce_stage_a``                     :func:`_reduce_stage_a`:
                                        ``reduce_plain`` /
                                        ``reduce_cuda`` (fft_reduce.cu)
======================================  =====================================

A dispatcher takes the plain version for tensors on the CPU and launches
the kernel for tensors on a CUDA device; each ``*_cuda`` wrapper counts its
launches in ``.launches``.  The fused round trips' plain versions are the
compositions of the split ones (``bccb_multi_plain = cb_multi_plain ∘
bc_plain``), so both routes share one algebra.

The plan tables (``plan_params``: t1 and T2 for both directions) are
runtime parameters in the JAX package's nesting, float32 numpy arrays from
one cache per ``nfft``; ``convert.to_device`` uploads each of them once per
parameter tree, so the three fused sites of a chain share one copy on the
card.

The JAX package's planning and routing switches are read at each call,
with its defaults, so one variable steers both packages alike:

- ``AMW_FFT_PALLAS`` (:func:`enabled`): unset, the staged FFT runs on
  CUDA at every :func:`plan_ok` plan and never on the CPU; ``"1"`` takes
  it on any device (on the CPU through the plain versions), anything else
  refuses it, and the sites then plan the CPU rule's size on ``torch.fft``;
- ``AMW_FFT_PREFER_PALLAS_MAX`` (``design.prefer_staged_max``, default
  1.75): how far :func:`site_plan` pads a 3·2^k or 5·2^k size up to a
  staged power of two;
- ``AMW_FFT_FUSED_RT`` (:func:`fused_rt`, default ``"1"``): ``0`` selects
  the split route, where ``apply_response``, ``roundtrip_multi`` and
  ``roundtrip_multi_reduce`` run ``_stage_bc`` and then ``_stage_cb`` /
  ``_stage_cb_multi`` instead of the fused round trip.

``AMW_FFT_PACK`` (row packing, always on here) and ``AMW_FFT_DOT_PREC``
(the TPU matrix unit's passes) select no kernel of the port and are not
read; ``AMW_FFT_A_COLS`` tiles the TPU grid only.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from . import design
from .design import plan_ok

A = 128
B = 128
C1 = 128  # sub-factor of the C axis (C = C2·C1 when C >= 128)


def enabled(nfft: int, device) -> bool:
    """Route this plan through the staged FFT?  Never where :func:`plan_ok`
    refuses it; else ``AMW_FFT_PALLAS == "1"`` when that is set (read at
    each call, as ``fft_pallas.enabled`` reads it), else on CUDA only —
    the JAX rule with the card in the TPU's place."""
    if not plan_ok(nfft):
        return False
    flag = os.environ.get("AMW_FFT_PALLAS")
    if flag is not None:
        return flag == "1"
    return torch.device(device).type == "cuda"


# ---------------------------------------------------------------------------
# host-side tables (float64 numpy, stored as float32 planes)


def _f32(m):
    return m.real.astype(np.float32), m.imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tables(nfft: int, inverse: bool):
    """``(wa, wb, wc, t1, t2)`` as (re, im) float32 pairs: the A-, B- and
    C-point DFT matrices, the stage-1 twiddle ``[A, B·C]`` and ``T2``
    ``[B, C]``.  Sign -1 forward, +1 inverse."""
    C = nfft // (A * B)
    sign = 2.0 if inverse else -2.0
    wa = np.exp(sign * 1j * np.pi * np.outer(np.arange(A), np.arange(A)) / A)
    wb = np.exp(sign * 1j * np.pi * np.outer(np.arange(B), np.arange(B)) / B)
    wc = np.exp(sign * 1j * np.pi * np.outer(np.arange(C), np.arange(C)) / C)
    t1 = np.exp(sign * 1j * np.pi * np.arange(A)[:, None]
                * np.arange(B * C)[None, :] / nfft)
    t2 = np.exp(sign * 1j * np.pi * np.outer(np.arange(B), np.arange(C))
                / (B * C))
    return tuple(map(_f32, (wa, wb, wc, t1, t2)))


@functools.lru_cache(maxsize=None)
def plan_params(nfft: int) -> list:
    """The plan's runtime tables, ``[t1r, t1i, t2r, t2i]`` forward then
    inverse (``fft_pallas.plan_params``' order), as float32 numpy arrays."""
    out = []
    for inverse in (False, True):
        _, _, _, t1, t2 = _tables(nfft, inverse)
        out += [t1[0], t1[1], t2[0], t2[1]]
    return out


@functools.lru_cache(maxsize=None)
def _device_tables(nfft: int, device: torch.device) -> tuple:
    """:func:`plan_params` on ``device``, one copy per (nfft, device)."""
    return tuple(torch.from_numpy(t).to(device) for t in plan_params(nfft))


def _tabs(tables, inverse):
    off = 4 if inverse else 0
    return tables[off:off + 4]


def _c1(nfft: int) -> int:
    """C sub-factor: 128 when C >= 128, else C (a direct C-point DFT)."""
    return min(nfft // (A * B), C1)


@functools.lru_cache(maxsize=None)
def _ctab(nfft: int, inverse: bool):
    """Composite C-stage tables: ``W_c1`` (the c1-point DFT), the chunk
    twiddle ``ct[k2', j] = W_C^(j·k2')`` [C2, c1], and the radix-C2
    butterfly ``wm[c2, k2'] = W_C2^(c2·k2')`` (complex128)."""
    C = nfft // (A * B)
    c1 = _c1(nfft)
    C2 = C // c1
    sign = 2.0 if inverse else -2.0
    w1 = np.exp(sign * 1j * np.pi * np.outer(np.arange(c1), np.arange(c1)) / c1)
    ct = np.exp(sign * 1j * np.pi * np.outer(np.arange(C2), np.arange(c1)) / C)
    wm = np.exp(sign * 1j * np.pi * np.outer(np.arange(C2), np.arange(C2)) / C2)
    return _f32(w1), _f32(ct), wm


@functools.lru_cache(maxsize=None)
def _perm(nfft: int) -> np.ndarray:
    """k at stored position (a', b', p): ``k = a' + A·b' + A·B·kc(p)``
    with ``kc(p) = p // c1 + C2·(p % c1)``."""
    C = nfft // (A * B)
    c1 = _c1(nfft)
    C2 = C // c1
    a = np.arange(A)[:, None, None]
    b = np.arange(B)[None, :, None]
    p = np.arange(C)[None, None, :]
    kc = p // c1 + C2 * (p % c1)
    return (a + A * b + A * B * kc).ravel()


def permute_full_response(H_half: np.ndarray, nfft: int) -> np.ndarray:
    """Half-spectrum response ([nfft//2+1], complex or real) → the full
    conjugate-symmetric spectrum in permuted storage order, float32
    [2, nfft] (re, im)."""
    H_half = np.asarray(H_half, np.complex128)
    full = np.empty(nfft, np.complex128)
    full[: nfft // 2 + 1] = H_half
    full[nfft // 2 + 1:] = np.conj(H_half[1: nfft // 2][::-1])
    fp = full[_perm(nfft)]
    return np.stack([fp.real, fp.imag]).astype(np.float32)


# ---------------------------------------------------------------------------
# plain PyTorch versions (complex64, f32 arithmetic)


def _cmat(pair, device) -> torch.Tensor:
    return torch.complex(torch.from_numpy(pair[0]),
                         torch.from_numpy(pair[1])).to(device)


def _cplx(re, im) -> torch.Tensor:
    return torch.complex(re, torch.zeros_like(re) if im is None else im)


def _padded(x: torch.Tensor, nfft: int) -> torch.Tensor:
    n = x.shape[-1]
    return torch.nn.functional.pad(x, (0, nfft - n)) if n < nfft else x


def stage_a_plain(xr, xi, nfft: int, inverse: bool, tables,
                  real_in: bool = False, real_out: bool = False):
    """Plain stage A over rows ``[R, n]`` (``n <= nfft``, zeros beyond):
    forward ``(W_A @ x) · t1``, inverse ``W_A^H @ (x · t1^*) / nfft``.
    ``real_in``: ``xi`` is zero (None); ``real_out``: only the real plane
    is returned (``(yr, None)``)."""
    R = xr.shape[0]
    S = nfft // A
    wa = _cmat(_tables(nfft, inverse)[0], xr.device)
    t1r, t1i = _tabs(tables, inverse)[:2]
    t1 = torch.complex(t1r, t1i).reshape(A, S)
    x = _cplx(_padded(xr, nfft),
              None if real_in else _padded(xi, nfft)).reshape(R, A, S)
    if inverse:
        x = x * t1
    y = torch.matmul(wa, x)
    if inverse:
        y = y * (1.0 / nfft)
    else:
        y = y * t1
    y = y.reshape(R, nfft)
    if real_out:
        return y.real.contiguous(), None
    return y.real.contiguous(), y.imag.contiguous()


def _cstage_fwd(y: torch.Tensor, nfft: int) -> torch.Tensor:
    """Composite forward C-DFT along the last axis (natural order in,
    permuted order out): radix-C2 butterfly, chunk twiddle, c1-point DFT."""
    w1, ct, wm = _ctab(nfft, False)
    C2 = wm.shape[0]
    c1 = w1[0].shape[0]
    dev = y.device
    z = y.reshape(y.shape[:-1] + (C2, c1))
    wm_t = torch.from_numpy(wm.astype(np.complex64)).to(dev)
    u = torch.matmul(wm_t.transpose(0, 1), z) * _cmat(ct, dev)
    return torch.matmul(u, _cmat(w1, dev)).reshape(y.shape)


def _cstage_inv(x: torch.Tensor, nfft: int) -> torch.Tensor:
    """Adjoint of :func:`_cstage_fwd` (permuted in, natural order out)."""
    w1, ct, wm = _ctab(nfft, True)
    C2 = wm.shape[0]
    c1 = w1[0].shape[0]
    dev = x.device
    v = torch.matmul(x.reshape(x.shape[:-1] + (C2, c1)), _cmat(w1, dev))
    v = v * _cmat(ct, dev)
    wm_t = torch.from_numpy(wm.astype(np.complex64)).to(dev)
    return torch.matmul(wm_t, v).reshape(x.shape)


def bc_plain(xr, xi, nfft: int, tables):
    """Plain forward B+C: stage-A output ``[R, nfft]`` planes → the stored
    (permuted) spectrum ``[R, nfft]`` planes."""
    C = nfft // (A * B)
    R = xr.shape[0]
    dev = xr.device
    t2 = torch.complex(*_tabs(tables, False)[2:4]).reshape(B, C)
    x = torch.complex(xr, xi).reshape(R, A, B, C)
    y = torch.matmul(_cmat(_tables(nfft, False)[1], dev), x) * t2
    y = _cstage_fwd(y, nfft).reshape(R, nfft)
    return y.real.contiguous(), y.imag.contiguous()


def cb_multi_plain(Xr, Xi, resps, nfft: int, tables):
    """Plain inverse C+B of one stored spectrum ``[R, nfft]`` under K
    responses ``resps`` [K, 2, nfft] (permuted; ``None``: one pass with no
    response) → ``[K·R, nfft]`` planes for the final inverse stage A."""
    C = nfft // (A * B)
    R = Xr.shape[0]
    K = 1 if resps is None else resps.shape[0]
    dev = Xr.device
    it2 = torch.complex(*_tabs(tables, True)[2:4]).reshape(B, C)
    y = torch.complex(Xr, Xi).reshape(1, R, A, B, C)
    if resps is not None:
        y = y * torch.complex(resps[:, 0], resps[:, 1]).reshape(K, 1, A, B, C)
    z = _cstage_inv(y, nfft) * it2
    z = torch.matmul(_cmat(_tables(nfft, True)[1], dev), z)
    z = z.reshape(K * R, nfft)
    return z.real.contiguous(), z.imag.contiguous()


def cb_plain(Xr, Xi, resp, nfft: int, tables):
    """Plain inverse C+B of a stored spectrum ``[R, nfft]`` times one
    response ``resp`` [2, nfft] (permuted), or none (``resp=None``: the
    inverse of :func:`bc_plain`) → ``[R, nfft]`` planes."""
    return cb_multi_plain(Xr, Xi, None if resp is None else resp[None], nfft,
                          tables)


def bccb_multi_plain(xr, xi, resps, nfft: int, tables):
    """Plain fused forward B+C → K responses → inverse C+B: stage-A output
    ``[R, nfft]`` planes and ``resps`` [K, 2, nfft] (permuted) → ``[K·R,
    nfft]`` planes for the final inverse stage A (:func:`bc_plain`, then
    :func:`cb_multi_plain`)."""
    return cb_multi_plain(*bc_plain(xr, xi, nfft, tables), resps, nfft,
                          tables)


def bc_cb_plain(xr, xi, resp, nfft: int, tables):
    """Plain fused forward B+C → one response → inverse C+B: stage-A output
    ``[R, nfft]`` planes and ``resp`` [2, nfft] (permuted) → ``[R, nfft]``
    planes for the final inverse stage A."""
    return bccb_multi_plain(xr, xi, resp[None], nfft, tables)


def inv_join_plain(Yr, Yi, K: int, nfft: int, tables):
    """Plain packed inverse stage A over K response planes of R2 rows:
    ``[K·R2, nfft]`` planes → one ``[K, 2·R2, nfft]`` (real rows, then
    imaginary rows, per response)."""
    R2 = Yr.shape[0] // K
    yr, yi = stage_a_plain(Yr, Yi, nfft, True, tables)
    return torch.stack([yr.reshape(K, R2, nfft), yi.reshape(K, R2, nfft)],
                       dim=1).reshape(K, 2 * R2, nfft)


def reduce_packed_plain(Yr, Yi, K: int, R2: int, nfft: int, band_fns,
                        tables):
    """Plain packed reduce: inverse stage A of K spectra, ``band_fns[k]`` on
    each plane of band k, band sum per plane → ``[2·R2, nfft]``."""
    yr, yi = stage_a_plain(Yr, Yi, nfft, True, tables)
    yr = yr.reshape(K, R2, nfft)
    yi = yi.reshape(K, R2, nfft)
    acc_r = sum(band_fns[k](yr[k]) for k in range(K))
    acc_i = sum(band_fns[k](yi[k]) for k in range(K))
    return torch.cat([acc_r, acc_i], dim=0)


def reduce_plain(Yr, Yi, K: int, R: int, nfft: int, band_fns, tables):
    """Plain unpacked reduce: inverse stage A of K spectra of R rows, the
    real part, ``band_fns[k]`` on band k, band sum → ``[R, nfft]``."""
    yr, _ = stage_a_plain(Yr, Yi, nfft, True, tables, real_out=True)
    yr = yr.reshape(K, R, nfft)
    return sum(band_fns[k](yr[k]) for k in range(K))


# ---------------------------------------------------------------------------
# CUDA wrappers


def _check(name: str, t: torch.Tensor, shape=None, rows_only=False):
    if not (t.is_cuda and t.dtype == torch.float32):
        raise ValueError(f"{name}: need CUDA float32 tensors")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    ok = t.stride(-1) == 1 if rows_only else t.is_contiguous()
    if not ok:
        raise ValueError(f"{name}: tensors must be contiguous")


def _check_tables(name, tables, nfft, inverse, dev):
    t1r, t1i, t2r, t2i = _tabs(tables, inverse)
    C = nfft // (A * B)
    for t, shape in ((t1r, (A, B * C)), (t1i, (A, B * C)), (t2r, (B, C)),
                     (t2i, (B, C))):
        _check(name, t, shape)
        if t.device != dev:
            raise ValueError(f"{name}: plan tables on {t.device}, data on "
                             f"{dev}")
    return t1r, t1i, t2r, t2i


def stage_a_cuda(xr, xi, nfft: int, inverse: bool, tables,
                 real_in: bool = False, real_out: bool = False):
    """Launch the stage-A kernel (replaces ``fft_pallas._stage_a``) on rows
    ``xr``/``xi`` f32 [R, n] (``n <= nfft``, unit stride along a row; the
    kernel reads zeros past ``n``).  ``xi`` is ignored with ``real_in``."""
    from . import _cuda

    if not plan_ok(nfft):
        raise ValueError(f"stage_a_cuda: no plan for nfft={nfft}")
    if real_in and inverse or real_out and not inverse:
        raise ValueError("stage_a_cuda: real_in is forward-only, real_out "
                         "inverse-only")
    _check("stage_a_cuda", xr, rows_only=True)
    if xr.ndim != 2 or xr.shape[1] > nfft:
        raise ValueError(f"stage_a_cuda: rows {tuple(xr.shape)} for nfft "
                         f"{nfft}")
    R, n = xr.shape
    if real_in:
        xi = xr
    else:
        _check("stage_a_cuda", xi, shape=xr.shape, rows_only=True)
        if xi.stride(0) != xr.stride(0):
            raise ValueError("stage_a_cuda: xr and xi need one row stride")
    t1r, t1i, _, _ = _check_tables("stage_a_cuda", tables, nfft, inverse,
                                   xr.device)
    out_r = torch.empty((R, nfft), dtype=torch.float32, device=xr.device)
    out_i = out_r if real_out else torch.empty_like(out_r)
    scale = 1.0 / nfft if inverse else 1.0
    _cuda.launch("amw_fft_stage_a", xr, xi, t1r, t1i, out_r, out_i, R,
                 xr.stride(0), n, nfft // A, int(inverse), int(real_in),
                 int(real_out), scale)
    stage_a_cuda.launches += 1
    return out_r, (None if real_out else out_i)


stage_a_cuda.launches = 0


def inv_join_cuda(Yr, Yi, K: int, nfft: int, tables):
    """Launch the packed inverse stage-A join kernel (replaces
    ``fft_pallas._stage_a_inv_join``): ``[K·R2, nfft]`` planes → one
    ``[K, 2·R2, nfft]``."""
    from . import _cuda

    _check("inv_join_cuda", Yr)
    if Yr.ndim != 2 or Yr.shape[1] != nfft or Yr.shape[0] % K:
        raise ValueError(f"inv_join_cuda: planes {tuple(Yr.shape)} for K={K}"
                         f", nfft={nfft}")
    _check("inv_join_cuda", Yi, shape=Yr.shape)
    t1r, t1i, _, _ = _check_tables("inv_join_cuda", tables, nfft, True,
                                   Yr.device)
    R2 = Yr.shape[0] // K
    out = torch.empty((K, 2 * R2, nfft), dtype=torch.float32,
                      device=Yr.device)
    _cuda.launch("amw_fft_inv_join", Yr, Yi, t1r, t1i, out, K * R2, R2,
                 nfft // A, 1.0 / nfft)
    inv_join_cuda.launches += 1
    return out


inv_join_cuda.launches = 0


def _bc_args(name, xr, xi, resps, resp_shape, nfft, tables,
             directions=(False, True)):
    """The checks of the B/C kernels' wrappers (``resps`` may be None);
    returns the T2 tables of ``directions`` (False forward, True
    inverse)."""
    if not plan_ok(nfft):
        raise ValueError(f"{name}: no plan for nfft={nfft}")
    _check(name, xr)
    if xr.ndim != 2 or xr.shape[1] != nfft:
        raise ValueError(f"{name}: planes {tuple(xr.shape)} for nfft={nfft}")
    _check(name, xi, shape=xr.shape)
    dev = xr.device
    if resps is not None:
        _check(name, resps, shape=resp_shape)
        if resps.device != dev:
            raise ValueError(f"{name}: tensors must share one device")
    if xi.device != dev:
        raise ValueError(f"{name}: tensors must share one device")
    # the C pass moves the stored order as 16-byte vectors
    if any(t.data_ptr() % 16 for t in (xr, xi, resps) if t is not None):
        raise ValueError(f"{name}: tensors must start 16-byte aligned")
    return sum((_check_tables(name, tables, nfft, inverse, dev)[2:]
                for inverse in directions), ())


def bccb_multi_cuda(xr, xi, resps, nfft: int, tables):
    """Launch the B → C × K responses → C⁻¹ → B⁻¹ kernels (replaces
    ``fft_pallas._stage_bccb_multi``).  Three passes through device memory:
    forward B with T2 into a scratch pair, then per C-row the forward
    C-DFT, the K products and K inverse C-DFTs, then conj-T2 and inverse B
    in place on the output."""
    from . import _cuda

    K = resps.shape[0]
    t2 = _bc_args("bccb_multi_cuda", xr, xi, resps, (K, 2, nfft), nfft,
                  tables)
    R = xr.shape[0]
    zr = torch.empty_like(xr)
    zi = torch.empty_like(xi)
    out_r = torch.empty((K * R, nfft), dtype=torch.float32, device=xr.device)
    out_i = torch.empty_like(out_r)
    _cuda.launch("amw_fft_bccb", xr, xi, resps, *t2, zr, zi, out_r, out_i, R,
                 nfft // (A * B), K)
    bccb_multi_cuda.launches += 1
    return out_r, out_i


bccb_multi_cuda.launches = 0


def bc_cb_cuda(xr, xi, resp, nfft: int, tables):
    """Launch the B → C × one response → C⁻¹ → B⁻¹ kernels (replaces
    ``fft_pallas._stage_bc_cb``, the round trip of ``apply_response``): the
    three passes of :func:`bccb_multi_cuda` at K = 1, ``resp`` [2, nfft]."""
    from . import _cuda

    t2 = _bc_args("bc_cb_cuda", xr, xi, resp, (2, nfft), nfft, tables)
    zr = torch.empty_like(xr)
    zi = torch.empty_like(xi)
    out_r = torch.empty_like(xr)
    out_i = torch.empty_like(xr)
    _cuda.launch("amw_fft_bc_cb", xr, xi, resp, *t2, zr, zi, out_r, out_i,
                 xr.shape[0], nfft // (A * B))
    bc_cb_cuda.launches += 1
    return out_r, out_i


bc_cb_cuda.launches = 0


def bc_cuda(xr, xi, nfft: int, tables):
    """Launch the forward B+C kernel (replaces ``fft_pallas._stage_bc``):
    stage-A output ``[R, nfft]`` planes → the stored (permuted) spectrum.
    One pass: each (row, a') matrix's [128, C] tile stays on chip in a
    thread-block cluster's shared memory between the forward B (with T2)
    and the forward C-DFT."""
    from . import _cuda

    t2 = _bc_args("bc_cuda", xr, xi, None, None, nfft, tables, (False,))
    out_r = torch.empty_like(xr)
    out_i = torch.empty_like(xr)
    _cuda.launch("amw_fft_bc", xr, xi, *t2, out_r, out_i, xr.shape[0],
                 nfft // (A * B))
    bc_cuda.launches += 1
    return out_r, out_i


bc_cuda.launches = 0


def cb_cuda(Xr, Xi, resp, nfft: int, tables):
    """Launch the inverse C+B kernels (replaces ``fft_pallas._stage_cb``):
    a stored spectrum ``[R, nfft]`` times one response ``resp`` [2, nfft]
    (or none, ``resp=None``) → ``[R, nfft]`` planes.  Two passes: per C-row
    the product and the inverse C-DFT, then conj T2 and inverse B in
    place."""
    from . import _cuda

    it2 = _bc_args("cb_cuda", Xr, Xi, resp, (2, nfft), nfft, tables, (True,))
    out_r = torch.empty_like(Xr)
    out_i = torch.empty_like(Xr)
    # without a response the kernel reads no response plane: Xr stands in
    _cuda.launch("amw_fft_cb", Xr, Xi, Xr if resp is None else resp, *it2,
                 out_r, out_i, Xr.shape[0], nfft // (A * B),
                 int(resp is not None))
    cb_cuda.launches += 1
    return out_r, out_i


cb_cuda.launches = 0


def cb_multi_cuda(Xr, Xi, resps, nfft: int, tables):
    """Launch the inverse C+B kernels over K responses (replaces
    ``fft_pallas._stage_cb_multi``): a stored spectrum ``[R, nfft]`` and
    ``resps`` [K, 2, nfft] → ``[K·R, nfft]`` planes; each block of the
    spectrum is read once for all K responses."""
    from . import _cuda

    K = resps.shape[0]
    it2 = _bc_args("cb_multi_cuda", Xr, Xi, resps, (K, 2, nfft), nfft,
                   tables, (True,))
    R = Xr.shape[0]
    out_r = torch.empty((K * R, nfft), dtype=torch.float32, device=Xr.device)
    out_i = torch.empty_like(out_r)
    _cuda.launch("amw_fft_cb_multi", Xr, Xi, resps, *it2, out_r, out_i, R,
                 nfft // (A * B), K)
    cb_multi_cuda.launches += 1
    return out_r, out_i


cb_multi_cuda.launches = 0


@functools.lru_cache(maxsize=None)
def _band_table(rows: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(rows, dtype=torch.float32).to(device)


def band_table(band_fns, device) -> torch.Tensor:
    """float32 [K, 8] map parameters for the reduce kernel, from maps that
    describe themselves (``table_row()``, see ``bands.BandMap``)."""
    rows = []
    for f in band_fns:
        if not hasattr(f, "table_row"):
            raise TypeError("the reduce kernel applies only band maps with "
                            f"a parameter row (bands.BandMap), not {f!r}")
        rows.append(tuple(float(v) for v in f.table_row()))
    return _band_table(tuple(rows), torch.device(device))


def reduce_packed_cuda(Yr, Yi, K: int, R2: int, nfft: int, bands, tables):
    """Launch the packed reduce kernel (replaces
    ``fft_pallas._reduce_stage_a_packed``): ``[K·R2, nfft]`` planes and the
    [K, 8] map table ``bands`` → ``[2·R2, nfft]``."""
    from . import _cuda

    _check("reduce_packed_cuda", Yr, shape=(K * R2, nfft))
    _check("reduce_packed_cuda", Yi, shape=(K * R2, nfft))
    _check("reduce_packed_cuda", bands, shape=(K, 8))
    t1r, t1i, _, _ = _check_tables("reduce_packed_cuda", tables, nfft, True,
                                   Yr.device)
    out = torch.empty((2 * R2, nfft), dtype=torch.float32, device=Yr.device)
    _cuda.launch("amw_fft_reduce_packed", Yr, Yi, t1r, t1i, bands, out, R2,
                 K, nfft // A, 1.0 / nfft)
    reduce_packed_cuda.launches += 1
    return out


reduce_packed_cuda.launches = 0


def reduce_cuda(Yr, Yi, K: int, R: int, nfft: int, bands, tables):
    """Launch the unpacked reduce kernel (replaces
    ``fft_pallas._reduce_stage_a``): ``[K·R, nfft]`` planes and the [K, 8]
    map table ``bands`` → ``[R, nfft]`` (the real part, mapped and summed
    over the bands)."""
    from . import _cuda

    _check("reduce_cuda", Yr, shape=(K * R, nfft))
    _check("reduce_cuda", Yi, shape=(K * R, nfft))
    _check("reduce_cuda", bands, shape=(K, 8))
    t1r, t1i, _, _ = _check_tables("reduce_cuda", tables, nfft, True,
                                   Yr.device)
    out = torch.empty((R, nfft), dtype=torch.float32, device=Yr.device)
    _cuda.launch("amw_fft_reduce", Yr, Yi, t1r, t1i, bands, out, R, K,
                 nfft // A, 1.0 / nfft)
    reduce_cuda.launches += 1
    return out


reduce_cuda.launches = 0


# ---------------------------------------------------------------------------
# stage dispatch (the JAX package's stage names): plain on the CPU, the
# kernel on CUDA


def _on_cpu(name: str, t: torch.Tensor) -> bool:
    if t.is_cuda:
        return False
    if t.device.type != "cpu":
        raise ValueError(f"{name}: no kernel for {t.device}")
    return True


def _stage_a(xr, xi, nfft, inverse, tables, real_in=False, real_out=False):
    if _on_cpu("_stage_a", xr):
        return stage_a_plain(xr, xi, nfft, inverse, tables, real_in,
                             real_out)
    return stage_a_cuda(xr, xi, nfft, inverse, tables, real_in, real_out)


def _stage_bc(xr, xi, nfft, tables):
    if _on_cpu("_stage_bc", xr):
        return bc_plain(xr, xi, nfft, tables)
    return bc_cuda(xr, xi, nfft, tables)


def _stage_cb(Xr, Xi, resp, nfft, tables):
    if _on_cpu("_stage_cb", Xr):
        return cb_plain(Xr, Xi, resp, nfft, tables)
    return cb_cuda(Xr, Xi, resp, nfft, tables)


def _stage_cb_multi(Xr, Xi, resps, nfft, tables):
    if _on_cpu("_stage_cb_multi", Xr):
        return cb_multi_plain(Xr, Xi, resps, nfft, tables)
    return cb_multi_cuda(Xr, Xi, resps, nfft, tables)


def _stage_bc_cb(xr, xi, resp, nfft, tables):
    if _on_cpu("_stage_bc_cb", xr):
        return bc_cb_plain(xr, xi, resp, nfft, tables)
    return bc_cb_cuda(xr, xi, resp, nfft, tables)


def _stage_bccb_multi(xr, xi, resps, nfft, tables):
    if _on_cpu("_stage_bccb_multi", xr):
        return bccb_multi_plain(xr, xi, resps, nfft, tables)
    return bccb_multi_cuda(xr, xi, resps, nfft, tables)


def _stage_a_inv_join(Yr, Yi, K, nfft, tables):
    if _on_cpu("_stage_a_inv_join", Yr):
        return inv_join_plain(Yr, Yi, K, nfft, tables)
    return inv_join_cuda(Yr, Yi, K, nfft, tables)


def _reduce_stage_a_packed(Yr, Yi, K, R2, nfft, band_fns, tables):
    if _on_cpu("_reduce_stage_a_packed", Yr):
        return reduce_packed_plain(Yr, Yi, K, R2, nfft, band_fns, tables)
    return reduce_packed_cuda(Yr, Yi, K, R2, nfft,
                              band_table(band_fns, Yr.device), tables)


def _reduce_stage_a(Yr, Yi, K, R, nfft, band_fns, tables):
    if _on_cpu("_reduce_stage_a", Yr):
        return reduce_plain(Yr, Yi, K, R, nfft, band_fns, tables)
    return reduce_cuda(Yr, Yi, K, R, nfft, band_table(band_fns, Yr.device),
                       tables)


# ---------------------------------------------------------------------------
# public API


def _prep_rows(x: torch.Tensor, nfft: int):
    """Rows ``[R, min(n, nfft)]`` of ``x`` [..., n], not padded (the stage-A
    kernel reads zeros past the end)."""
    lead = tuple(x.shape[:-1])
    R = int(np.prod(lead)) if lead else 1
    xr = x.reshape(R, x.shape[-1])
    if xr.shape[1] > nfft:
        xr = xr[:, :nfft]
    return xr, lead, R


def _pack_ok(R: int) -> bool:
    return R >= 2 and R % 2 == 0


def _resolve_tables(tables, nfft, device):
    return _device_tables(nfft, torch.device(device)) if tables is None \
        else tables


def fused_rt() -> bool:
    """The fused round trip (default) or the split stages?  Reads
    ``AMW_FFT_FUSED_RT`` at each call exactly as ``fft_pallas._fused_rt``
    does, so one variable switches both packages."""
    return os.environ.get("AMW_FFT_FUSED_RT", "1") == "1"


def _round_trip(Xr, Xi, resp, nfft, tables):
    """Stage-A output → one response → planes for the final inverse stage
    A: kernel 8, or 6 then 7 on the split route."""
    if fused_rt():
        return _stage_bc_cb(Xr, Xi, resp, nfft, tables)
    Sr, Si = _stage_bc(Xr, Xi, nfft, tables)
    return _stage_cb(Sr, Si, resp, nfft, tables)


def _round_trip_multi(Xr, Xi, resps, nfft, tables):
    """As :func:`_round_trip` over K responses: kernel 9, or 6 then 10."""
    if fused_rt():
        return _stage_bccb_multi(Xr, Xi, resps, nfft, tables)
    Sr, Si = _stage_bc(Xr, Xi, nfft, tables)
    return _stage_cb_multi(Sr, Si, resps, nfft, tables)


def fft_permuted(xr, xi, nfft: int, tables=None):
    """Forward FFT of complex rows ``xr``/``xi`` [R, n] (``n <= nfft``,
    zeros beyond) → the stored (permuted) spectrum (re, im) [R, nfft]."""
    tables = _resolve_tables(tables, nfft, xr.device)
    Xr, Xi = _stage_a(xr, xi, nfft, False, tables)
    return _stage_bc(Xr, Xi, nfft, tables)


def ifft_permuted(Xr, Xi, nfft: int, tables=None):
    """Inverse of :func:`fft_permuted` (adjoint stages, reversed)."""
    tables = _resolve_tables(tables, nfft, Xr.device)
    Yr, Yi = _stage_cb(Xr, Xi, None, nfft, tables)
    return _stage_a(Yr, Yi, nfft, True, tables)


def apply_response(x, resp_perm, nfft: int, tables=None,
                   n_out: int | None = None, real_impulse: bool = True):
    """``irfft(rfft(x, nfft) · H)[..., :n_out]`` for real ``x`` [..., n]
    and one permuted response ``resp_perm`` [2, nfft]
    (:func:`permute_full_response`) → real [..., n_out] (``nfft`` when
    None).

    ``real_impulse`` declares that ``H`` is conjugate-symmetric (a real
    impulse response), true of every response this package builds; it
    gates the row packing (see :func:`roundtrip_multi`): even row counts
    ride packed (the packed forward stage A, the round trip, the join at
    K = 1).  Odd row counts, and every count with ``real_impulse=False``,
    run stage A real-in, the round trip, stage A real-out."""
    tables = _resolve_tables(tables, nfft, x.device)
    xr, lead, R = _prep_rows(x, nfft)
    m = nfft if n_out is None else n_out
    if real_impulse and _pack_ok(R):
        R2 = R // 2
        Xr, Xi = _stage_a(xr[:R2], xr[R2:], nfft, False, tables)
        Yr, Yi = _round_trip(Xr, Xi, resp_perm, nfft, tables)
        out = _stage_a_inv_join(Yr, Yi, 1, nfft, tables)[0]
        return out[:, :m].reshape(lead + (m,))
    Xr, Xi = _stage_a(xr, None, nfft, False, tables, real_in=True)
    Yr, Yi = _round_trip(Xr, Xi, resp_perm, nfft, tables)
    Yr, _ = _stage_a(Yr, Yi, nfft, True, tables, real_out=True)
    return Yr[:, :m].reshape(lead + (m,))


def fwd_real(x, nfft: int, tables=None):
    """Real ``x`` [..., n] → the stored spectrum (re, im) [R, nfft] of its
    rows, and the leading shape (for :func:`inv_multi`)."""
    tables = _resolve_tables(tables, nfft, x.device)
    xr, lead, _ = _prep_rows(x, nfft)
    Xr, Xi = _stage_a(xr, None, nfft, False, tables, real_in=True)
    Xr, Xi = _stage_bc(Xr, Xi, nfft, tables)
    return Xr, Xi, lead


def inv_multi(Xr, Xi, resps_perm, nfft: int, lead, n_out: int, tables=None):
    """Inverse of one stored spectrum [R, nfft] under K permuted responses
    [K, 2, nfft] → real [K, *lead, n_out]."""
    tables = _resolve_tables(tables, nfft, Xr.device)
    K = resps_perm.shape[0]
    Yr, Yi = _stage_cb_multi(Xr, Xi, resps_perm, nfft, tables)
    Yr, _ = _stage_a(Yr, Yi, nfft, True, tables, real_out=True)
    return Yr[:, :n_out].reshape((K,) + tuple(lead) + (n_out,))


def inv_multi_reduce(Xr, Xi, resps_perm, nfft: int, lead, n_out: int,
                     band_fns, tables=None):
    """:func:`inv_multi` with ``band_fns[k]`` applied to band k and the
    bands summed inside the final inverse stage → real [*lead, n_out]."""
    tables = _resolve_tables(tables, nfft, Xr.device)
    K = resps_perm.shape[0]
    R = Xr.shape[0]
    Yr, Yi = _stage_cb_multi(Xr, Xi, resps_perm, nfft, tables)
    out = _reduce_stage_a(Yr, Yi, K, R, nfft, band_fns, tables)
    return out[:, :n_out].reshape(tuple(lead) + (n_out,))


def roundtrip_multi(x, resps_perm, nfft: int, n_out: int, tables=None):
    """``[irfft(rfft(x, nfft) · H_k)[..., :n_out] for k]``: real [..., n] ×
    [K, 2, nfft] permuted responses (:func:`permute_full_response`) → real
    [K, ..., n_out].

    Even row counts ride two real rows as one complex row (first half of
    the rows on the real plane, second half on the imaginary plane): every
    response here has a real impulse, so the two convolutions separate
    after the inverse.  Odd row counts run unpacked."""
    tables = _resolve_tables(tables, nfft, x.device)
    xr, lead, R = _prep_rows(x, nfft)
    K = resps_perm.shape[0]
    if _pack_ok(R):
        R2 = R // 2
        Xr, Xi = _stage_a(xr[:R2], xr[R2:], nfft, False, tables)
        Yr, Yi = _round_trip_multi(Xr, Xi, resps_perm, nfft, tables)
        out = _stage_a_inv_join(Yr, Yi, K, nfft, tables)
        return out[..., :n_out].reshape((K,) + lead + (n_out,))
    Xr, Xi = _stage_a(xr, None, nfft, False, tables, real_in=True)
    Yr, Yi = _round_trip_multi(Xr, Xi, resps_perm, nfft, tables)
    Yr, _ = _stage_a(Yr, Yi, nfft, True, tables, real_out=True)
    return Yr[:, :n_out].reshape((K,) + lead + (n_out,))


def roundtrip_multi_reduce(x, resps_perm, nfft: int, n_out: int, band_fns,
                           tables=None):
    """:func:`roundtrip_multi` with ``band_fns[k]`` (memoryless, per sample)
    applied to band k and the bands summed inside the final inverse stage:
    real [..., n] → real [..., n_out].  On CUDA the maps must be
    ``bands.BandMap``s (the kernel reads their parameter rows)."""
    tables = _resolve_tables(tables, nfft, x.device)
    xr, lead, R = _prep_rows(x, nfft)
    K = resps_perm.shape[0]
    if _pack_ok(R):
        R2 = R // 2
        Xr, Xi = _stage_a(xr[:R2], xr[R2:], nfft, False, tables)
        Yr, Yi = _round_trip_multi(Xr, Xi, resps_perm, nfft, tables)
        out = _reduce_stage_a_packed(Yr, Yi, K, R2, nfft, band_fns, tables)
        return out[:, :n_out].reshape(lead + (n_out,))
    Xr, Xi = _stage_a(xr, None, nfft, False, tables, real_in=True)
    Yr, Yi = _round_trip_multi(Xr, Xi, resps_perm, nfft, tables)
    out = _reduce_stage_a(Yr, Yi, K, R, nfft, band_fns, tables)
    return out[:, :n_out].reshape(lead + (n_out,))


# ---------------------------------------------------------------------------
# fused sites (``fused`` and the hybrid band split in ``bands``)


def site_plan(n: int, device) -> tuple[int, bool]:
    """``(nfft, staged)`` for a full-length FFT of at least ``n`` points:
    the TPU plan (``design.tpu_fft_plan``) on the staged FFT where
    :func:`enabled` takes it, else the CPU rule's size
    (``design.next_fft_size``) on ``torch.fft``.  This is the JAX package's
    ``design.next_fft_size`` on each backend, its ``fp.enabled(pow2)`` term
    included (a power of two its Pallas FFT takes is preferred exactly
    where that FFT is enabled, so ``AMW_FFT_PALLAS=0`` plans the CPU rule
    on the card too), so every builder plans with it: the fused sites and
    fast zero-phase passes run the staged FFT when ``staged``, the exact
    two-pass filters and the meters ``torch.fft`` at ``nfft`` either
    way."""
    plan = design.tpu_fft_plan(n)
    if enabled(plan, device):
        return plan, True
    return design.next_fft_size(n), False


def site_params(responses, nfft: int, *rest) -> list:
    """A fused site's params on the staged route, in the JAX package's
    nesting: the half-spectrum ``responses`` permuted ``[K, 2, nfft]``,
    then ``rest``, then the plan tables."""
    return [np.stack([permute_full_response(h, nfft) for h in responses]),
            *rest, plan_params(nfft)]


def site_roundtrip(x, params, nfft: int, band_fns=None):
    """The round trip of :func:`site_params`' responses at full
    ``nfft`` length: [K, ..., nfft], or with ``band_fns`` the band-mapped
    sum [..., nfft]."""
    resps, tables = params[0], params[-1]
    if band_fns is None:
        return roundtrip_multi(x, resps, nfft, nfft, tables=tables)
    return roundtrip_multi_reduce(x, resps, nfft, nfft, band_fns,
                                  tables=tables)
