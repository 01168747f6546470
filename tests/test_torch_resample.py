"""The port's FFT resampler (``fdfilter.resample_fft``) and the harmonic
exciter at ``oversample`` 2 and 4 against scipy and the JAX package on the
CPU.

``resample_fft`` keeps ``scipy.signal.resample``'s spectrum surgery on
plain transforms (the JAX package routes lengths outside XLA-TPU's native
FFT sizes through Bluestein tables, which the port does not need).  Bars:
the repo's parity bar, max sample error <= -90 dBFS, against scipy in
float64 and against the JAX package's resampler with its own plan; the
exciter's output likewise, and its integrated loudness within 0.1 LU,
exact-length and bucket-padded, and on the
staged FFT (the JAX package's Pallas kernels in interpret mode, the port's
plain versions) where its work-rate high pass plans 2^19.
"""

import functools

import jax
import numpy as np
import pytest
import scipy.signal as sg
import torch

from amw_tpu import refimpl
from amw_tpu.ops import exciter as jexc
from amw_tpu.ops import fdfilter as jfd
from amw_tpu.ops import fft_pallas as jfp
from amw_tpu.ops import validctx as jvc
from amw_tpu.spec import GraphSpec as JSpec
from amw_tpu_torch import GraphSpec
from amw_tpu_torch.convert import params_from_jax
from amw_tpu_torch.ops import design as tdesign
from amw_tpu_torch.ops import exciter as texc
from amw_tpu_torch.ops import fdfilter as tfd
from amw_tpu_torch.ops import fft_staged
from amw_tpu_torch.ops import validctx as tvc

SR = 44100
BAR_DBFS = -90.0
BAR_LU = 0.1
# (n_in, n_out): even/odd, up and down, and the export path's 44.1 -> 48 kHz
LENGTHS = [(1000, 1500), (1001, 1500), (1000, 1501), (1500, 1000),
           (1501, 1000), (1500, 1001), (44100, 48000), (48000, 44100),
           (4096, 4096)]


def db(err):
    return 20 * np.log10(max(err, 1e-30))


def _rows(shape, seed=0):
    g = np.random.default_rng(seed)
    return (0.5 * g.standard_normal(shape)).clip(-1, 1).astype(np.float32)


@pytest.mark.parametrize("n_in,n_out", LENGTHS)
def test_resample_fft_matches_scipy_and_jax(n_in, n_out):
    x = _rows((3, n_in), seed=n_in + n_out)
    got = tfd.resample_fft(torch.from_numpy(x), n_out)
    assert got.shape == (3, n_out) and got.dtype == torch.float32
    got = got.numpy()
    want_sp = sg.resample(x.astype(np.float64), n_out, axis=-1)
    assert db(float(np.max(np.abs(got - want_sp)))) <= BAR_DBFS
    want_j = np.asarray(jfd.resample_fft(x, n_out,
                                         jfd.resample_plan(n_in, n_out)))
    assert db(float(np.max(np.abs(got - want_j)))) <= BAR_DBFS


def test_resample_plan_is_none_and_ignored():
    """cuFFT and the CPU FFT take any length: no Bluestein tables; the JAX
    package's tables, passed in, change nothing."""
    assert tfd.resample_plan(44100, 48000) is None
    x = torch.from_numpy(_rows((2, 44100)))
    plan = jfd.resample_plan(44100, 48000)
    assert plan is not None
    assert torch.equal(tfd.resample_fft(x, 48000, plan),
                       tfd.resample_fft(x, 48000))


N = SR // 2
NVS = [N, 19_000, 15_011]


def _batch(seed, n=N, nvs=None):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    B = len(nvs) if nvs else 2
    x = np.stack([
        np.stack([(0.3 * np.sin(2 * np.pi * (110 + 40 * b) * t)
                   + 0.15 * np.sin(2 * np.pi * 6100 * t)
                   + 0.08 * rng.standard_normal(n))
                  for _ in range(2)])
        for b in range(B)]).astype(np.float32)
    if nvs:
        for b, nv in enumerate(nvs):
            x[b, :, nv:] = 0.0
    return x


def _exciter_pair(os_f, n=N):
    """The JAX exciter and the port's, the port fed the JAX params (the
    Bluestein tables of slots 1-2 included, which it ignores) after
    checking that its zero-phase params agree."""
    jp, jf = jexc.build_harmonic_exciter(JSpec(sr=SR, n=n), 0.6,
                                         oversample=os_f)
    tp, tf = texc.build_harmonic_exciter(GraphSpec(sr=SR, n=n), 0.6,
                                         oversample=os_f, device="cpu")
    assert len(tp) == len(jp) == 3 and tp[1] == tp[2] == []
    for u, v in zip(jax.tree_util.tree_leaves(tp[0]),
                    jax.tree_util.tree_leaves(jp[0])):
        np.testing.assert_allclose(u, v, rtol=1e-6, atol=1e-7)
    jpd = jax.device_put(jp)
    tpd = params_from_jax(jp, device="cpu")
    return (lambda x: jf(x, jpd)), (lambda x: tf(x, tpd))


def _run(jf, tf, x, nvs=None):
    if nvs is None:
        want = np.asarray(jax.jit(jax.vmap(jf))(x))
        return want, tf(torch.from_numpy(x)).numpy()

    def one(xi, nvi):
        with jvc.valid_length(nvi):
            return jvc.mask_tail(jf(xi))

    want = np.asarray(jax.jit(jax.vmap(one))(x, np.asarray(nvs, np.int32)))
    with tvc.valid_length(torch.tensor(nvs, dtype=torch.int32)):
        got = tvc.mask_tail(tf(torch.from_numpy(x))).numpy()
    return want, got


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "padded"])
@pytest.mark.parametrize("os_f", [2, 4])
def test_oversampled_exciter_matches_jax(os_f, padded):
    jf, tf = _exciter_pair(os_f)
    nvs = NVS if padded else None
    x = _batch(os_f, nvs=nvs)
    want, got = _run(jf, tf, x, nvs)
    assert got.shape == x.shape
    assert db(float(np.max(np.abs(got - want)))) <= BAR_DBFS
    for b, nv in enumerate(nvs or [N] * len(x)):
        assert np.all(got[b, :, nv:] == 0.0)
        if nv >= 0.4 * SR:  # the loudness meter's gating block
            assert abs(refimpl.integrated_lufs(got[b, :, :nv], SR)
                       - refimpl.integrated_lufs(want[b, :, :nv], SR)
                       ) <= BAR_LU


def test_oversampled_padded_track_near_exact_length():
    """FFT resampling of a zero-padded bucket is a periodic interpolation,
    so a padded track equals its exact-length run only to the sinc tail's
    level, as in the JAX package (exciter.py:56-64); the two packages
    agree on that difference."""
    jf, tf = _exciter_pair(2)
    x = _batch(7, nvs=NVS)
    want, got = _run(jf, tf, x, NVS)
    nv = NVS[1]
    jf_e, tf_e = _exciter_pair(2, n=nv)
    xe = np.ascontiguousarray(x[1:2, :, :nv])
    want_e, got_e = _run(jf_e, tf_e, xe)
    d_port = got[1, :, :nv] - got_e[0]
    d_jax = want[1, :, :nv] - want_e[0]
    assert db(float(np.max(np.abs(d_port - d_jax)))) <= BAR_DBFS
    assert float(np.max(np.abs(d_port))) < 0.05


N_STAGED = 150_000  # the 2x work-rate high pass plans 2^19 on the card


@pytest.fixture
def staged_route(monkeypatch):
    """Both packages on the staged route, whatever the backend (the
    pattern of tests/test_torch_v2_staged.py); returns the port's
    ``apply_response`` plans."""
    monkeypatch.setattr(jfp, "enabled", jfp.plan_ok)
    for name in ("apply_response", "roundtrip_multi",
                 "roundtrip_multi_reduce"):
        monkeypatch.setattr(jfp, name, functools.partial(getattr(jfp, name),
                                                         interpret=True))
    monkeypatch.setattr(fft_staged, "enabled",
                        lambda nfft, device: fft_staged.plan_ok(nfft))
    calls = []
    orig = fft_staged.apply_response

    def counted(*a, **k):
        calls.append(a[2])
        return orig(*a, **k)

    monkeypatch.setattr(fft_staged, "apply_response", counted)
    return calls


def test_oversampled_exciter_on_staged_route(staged_route):
    assert tdesign.tpu_fft_plan(2 * N_STAGED) == 1 << 19
    jf, tf = _exciter_pair(2, n=N_STAGED)
    x = _batch(9, n=N_STAGED)
    want, got = _run(jf, tf, x)
    assert staged_route == [1 << 19]
    assert db(float(np.max(np.abs(got - want)))) <= BAR_DBFS
