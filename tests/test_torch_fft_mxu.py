"""The port's matmul FFT route (``amw_tpu_torch/ops/fft_mxu.py``, taken by
``fdfilter._apply_response`` under ``AMW_FFT_MXU=1``) against
``amw_tpu.ops.fft_mxu`` and its switch on the CPU.

The transforms at the sizes of tests/test_fft_mxu.py: the port within
2e-6 of the largest magnitude of JAX's, and numpy at that file's bars.
``_apply_response`` under the variable against JAX's under it, within
1e-6 on unit-scale input; the switch's rule counted in both packages;
and the v1 chain under the variable in both packages.  The v1 chain's
default (exact, hybrid) sites reach ``_apply_response`` only through
its edge windows, at most 32768 points at any track length, so the
route never engages there: the chain runs in fast mode
(``GraphSpec(exact=False)``), whose loudness meter filters the whole
track, at the shortest length at which that meter's plan is 2^16.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from amw_tpu import refimpl
from amw_tpu.ops import design as jdesign
from amw_tpu.ops import fdfilter as jfd
from amw_tpu.ops import fft_mxu as jmxu
from amw_tpu_torch.ops import fdfilter as tfd
from amw_tpu_torch.ops import fft_mxu as tmxu
from amw_tpu_torch.ops import meters

SR = 44100
REL = 2e-6  # of the largest magnitude (tests/test_fft_mxu.py's bar)
RT_ATOL = 5e-5  # round trips (tests/test_fft_mxu.py's bar)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("n", [128, 512, 4096, 1 << 16])
def test_cfft_matches_jax_and_numpy(n):
    g = np.random.default_rng(0)
    re = g.standard_normal((3, n)).astype(np.float32)
    im = g.standard_normal((3, n)).astype(np.float32)
    yr, yi = tmxu.cfft_mxu(_t(re), _t(im))
    jr, ji = jmxu.cfft_mxu(jnp.asarray(re), jnp.asarray(im))
    got = yr.numpy() + 1j * yi.numpy()
    assert _rel(got, np.asarray(jr) + 1j * np.asarray(ji)) < REL
    want = np.fft.fft(re + 1j * im, axis=-1)
    scale = np.max(np.abs(want))
    assert np.max(np.abs(yr.numpy() - want.real)) / scale < REL
    assert np.max(np.abs(yi.numpy() - want.imag)) / scale < REL


@pytest.mark.parametrize("n", [256, 4096, 1 << 17])
def test_cfft_inverse_matches_jax_and_round_trips(n):
    g = np.random.default_rng(1)
    re = g.standard_normal((2, n)).astype(np.float32)
    im = g.standard_normal((2, n)).astype(np.float32)
    yr, yi = tmxu.cfft_mxu(_t(re), _t(im))
    br, bi = tmxu.cfft_mxu(yr, yi, inverse=True)
    jr, ji = jmxu.cfft_mxu(jnp.asarray(yr.numpy()), jnp.asarray(yi.numpy()),
                           inverse=True)
    assert _rel(br.numpy(), np.asarray(jr)) < REL
    assert _rel(bi.numpy(), np.asarray(ji)) < REL
    assert np.max(np.abs(br.numpy() - re)) < RT_ATOL
    assert np.max(np.abs(bi.numpy() - im)) < RT_ATOL


@pytest.mark.parametrize("nfft", [256, 4096, 1 << 17, 1 << 18])
def test_rfft_matches_jax_and_numpy(nfft):
    g = np.random.default_rng(2)
    x = g.standard_normal((2, nfft)).astype(np.float32)
    xr, xi = tmxu.rfft_mxu(_t(x), nfft)
    jr, ji = jmxu.rfft_mxu(jnp.asarray(x), nfft)
    got = xr.numpy() + 1j * xi.numpy()
    assert _rel(got, np.asarray(jr) + 1j * np.asarray(ji)) < REL
    want = np.fft.rfft(x, axis=-1)
    scale = np.max(np.abs(want))
    assert np.max(np.abs(xr.numpy() - want.real)) / scale < REL
    assert np.max(np.abs(xi.numpy() - want.imag)) / scale < REL


@pytest.mark.parametrize("nfft,n", [(512, 384), (1 << 16, 49152),
                                    (4096, 5000)],
                         ids=["pad_512", "pad_2^16", "crop_4096"])
def test_rfft_pad_crop_and_irfft_match_jax(nfft, n):
    """Padding (n < nfft) and cropping (n > nfft) to ``nfft``, then the
    inverse: the port equals JAX's, and the round trip returns the
    (cropped) input with zeros past it."""
    g = np.random.default_rng(3)
    x = g.standard_normal((2, n)).astype(np.float32)
    xr, xi = tmxu.rfft_mxu(_t(x), nfft)
    back = tmxu.irfft_mxu(xr, xi, nfft).numpy()
    jr, ji = jmxu.rfft_mxu(jnp.asarray(x), nfft)
    jback = np.asarray(jmxu.irfft_mxu(jr, ji, nfft))
    assert back.shape == (2, nfft)
    assert _rel(back, jback) < REL
    m = min(n, nfft)
    assert np.max(np.abs(back[..., :m] - x[..., :m])) < RT_ATOL
    assert np.max(np.abs(back[..., m:]), initial=0.0) < RT_ATOL


def _responses(nfft):
    """A high-pass biquad's complex response and a zero-phase power
    response on the rFFT grid of ``nfft`` (real at DC and Nyquist, as
    every response of the chain)."""
    from scipy import signal as sg

    ba = sg.butter(2, 0.1, btype="high")
    Hc = jdesign.freqz(*ba, nfft).astype(np.complex64)
    Hp = jdesign.zero_phase_power([ba], nfft).astype(np.float32)
    return {"complex": (Hc, False), "complex_conj": (Hc, True),
            "real": (Hp, False)}


@pytest.mark.parametrize("kind", ["complex", "complex_conj", "real"])
@pytest.mark.parametrize("nfft", [1 << 16, 1 << 17])
def test_apply_response_on_the_route_matches_jax(monkeypatch, nfft, kind):
    monkeypatch.setenv("AMW_FFT_MXU", "1")
    g = np.random.default_rng(4)
    x = np.clip(0.3 * g.standard_normal((2, nfft - 3000)), -1, 1).astype(
        np.float32)
    H, conj = _responses(nfft)[kind]
    got = tfd._apply_response(_t(x), _t(H), nfft, conj=conj).numpy()
    want = np.asarray(jfd._apply_response(jnp.asarray(x), jnp.asarray(H),
                                          nfft, conj=conj))
    assert got.shape == want.shape == (2, nfft)
    assert np.max(np.abs(got - want)) < 1e-6
    monkeypatch.delenv("AMW_FFT_MXU")
    plain = tfd._apply_response(_t(x), _t(H), nfft, conj=conj).numpy()
    assert np.max(np.abs(got - plain)) < RT_ATOL


def _count_route(monkeypatch):
    """Count the route's forward transforms in both packages."""
    calls = {"jax": 0, "torch": 0}

    def counted(mod, key):
        inner = mod.rfft_mxu

        def rfft(*a, **kw):
            calls[key] += 1
            return inner(*a, **kw)

        monkeypatch.setattr(mod, "rfft_mxu", rfft)

    counted(jmxu, "jax")
    counted(tmxu, "torch")
    return calls


@pytest.mark.parametrize("nfft,flag,routed", [
    (1 << 15, "1", False), (3 << 16, "1", False), (1 << 16, "1", True),
    (1 << 16, "0", False)], ids=["2^15", "3x2^16", "2^16", "2^16_off"])
def test_switch_rule_matches_jax(monkeypatch, nfft, flag, routed):
    """``AMW_FFT_MXU=1`` and a power-of-two plan of 2^16 or more take the
    route in both packages; smaller or non-power-of-two plans, or the
    variable unset, stay on the FFT library."""
    monkeypatch.setenv("AMW_FFT_MXU", flag)
    calls = _count_route(monkeypatch)
    x = np.zeros((1, 1000), np.float32)
    H = np.ones(nfft // 2 + 1, np.float32)
    tfd._apply_response(_t(x), _t(H), nfft)
    jfd._apply_response(jnp.asarray(x), jnp.asarray(H), nfft)
    assert calls == {"jax": int(routed), "torch": int(routed)}
    assert tfd._use_mxu_fft(nfft) == jfd._use_mxu_fft(nfft) == routed


def test_v1_chain_on_the_route_matches_jax(monkeypatch):
    """The v1 ``standard`` chain in fast mode under ``AMW_FFT_MXU=1`` in
    both packages, at the shortest length whose meter plan is 2^16 on the
    CPU: the route engages as often in both, and the outputs agree at the
    repo's parity bars."""
    import jax

    from amw_tpu.models.pipeline_v1 import build_v1_pipeline as jax_build
    from amw_tpu.spec import GraphSpec as JSpec
    from amw_tpu_torch import GraphSpec
    from amw_tpu_torch.convert import params_from_jax
    from amw_tpu_torch.models import build_v1_pipeline

    n = (3 << 14) + 1 - meters.k_weight_settle(SR)  # plan(n + settle) = 2^16
    assert jdesign.next_fft_size(n + meters.k_weight_settle(SR)) == 1 << 16
    assert jdesign.next_fft_size(n - 1 + meters.k_weight_settle(SR)) < 1 << 16
    g = np.random.default_rng(5)
    t = np.arange(n) / SR
    x = (0.3 * np.sin(2 * np.pi * 110 * t) + 0.1 * np.sin(2 * np.pi * 997 * t)
         + 0.05 * g.standard_normal(n))
    x = np.stack([x, 0.85 * x]).astype(np.float32)

    monkeypatch.setenv("AMW_FFT_MXU", "1")
    calls = _count_route(monkeypatch)
    jp, jfn, jnames = jax_build(JSpec(sr=SR, n=n, channels=2, exact=False))
    want = np.asarray(jfn(x, jax.device_put(jp)))
    _, tfn, tnames = build_v1_pipeline(
        GraphSpec(sr=SR, n=n, channels=2, exact=False), device="cpu")
    with torch.inference_mode():
        got = tfn(_t(x), params_from_jax(jp, device="cpu")).numpy()
    assert tnames == jnames
    assert calls["torch"] == calls["jax"] > 0
    err = float(np.max(np.abs(got - want)))
    assert 20 * np.log10(max(err, 1e-30)) <= -90.0
    assert abs(refimpl.integrated_lufs(got, SR)
               - refimpl.integrated_lufs(want, SR)) <= 0.1
