"""The last DSP options on the card against the port's CPU path: the
true-peak limiter, the reverb, the FFT resampler and the oversampled
exciter (whose 2x high pass at 2^19 runs kernels 4, 8 and 5), the dither
and 16-bit quantization, and the DSP vocal separator.

GPU only (``cuda`` marker; every test skips without a card).  The file
imports no JAX, so it runs on a machine with the card and no JAX package:

    python -m pytest --noconftest -q tests/test_torch_finish_cuda.py

Bars: the repo's parity bar, max sample error <= -90 dBFS; the limiter's
guarantee, true peak <= ceiling + 0.05 dB; int16 equal to the CPU's given
the same noise.
"""

import numpy as np
import pytest
import torch

from amw_tpu_torch import GraphSpec
from amw_tpu_torch.convert import to_device
from amw_tpu_torch.models import vocal
from amw_tpu_torch.ops import design, dither, exciter, fdfilter, meters
from amw_tpu_torch.ops import fft_staged as fs
from amw_tpu_torch.ops import reverb, tplimit, validctx

SR = 44100
BAR_DBFS = -90.0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _batch(n, seed=0, nvs=(None, None)):
    g = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = np.stack([np.stack([0.6 * np.sin(2 * np.pi * (220 + 80 * b) * t)
                            + 0.3 * g.standard_normal(n)] * 2)
                  for b in range(len(nvs))])
    for b, nv in enumerate(nvs):
        if nv is not None:
            x[b, :, nv:] = 0.0
    return np.clip(x, -0.99, 0.99).astype(np.float32)


def _db(a, b):
    return 20 * np.log10(max(float((a.cpu() - b).abs().max()), 1e-30))


def _both(build, x, nvs=None, n=None):
    """``build(spec, device)`` run on the card and on the CPU, under
    ``nvs`` where given; returns (card output on the host, CPU output)."""
    spec = GraphSpec(sr=SR, n=n or x.shape[-1], channels=x.shape[-2])
    out = []
    for dev in (torch.device("cuda"), torch.device("cpu")):
        params, fn = build(spec, dev)
        nv = None if nvs is None else torch.tensor(nvs, dtype=torch.int32,
                                                  device=dev)
        with torch.no_grad(), validctx.valid_length(nv):
            out.append(fn(torch.from_numpy(x).to(dev),
                          to_device(params, dev)).cpu())
    return out


@pytest.mark.cuda
def test_true_peak_limiter_cuda(cuda_device):
    n = 10 * SR
    nvs = [n, 7 * SR + 13]
    x = _batch(n, 1, nvs)
    got, want = _both(lambda s, d: tplimit.build_true_peak_limiter(
        s, -1.0, device=d), x, nvs)
    assert _db(got, want) <= BAR_DBFS
    for b, nv in enumerate(nvs):
        tp = float(meters.true_peak_dbfs(got[b, :, :nv].to(cuda_device)))
        assert tp <= -1.0 + 0.05


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [{}, {"mix_mid": 0.12, "mix_side": 0.2}],
                         ids=["plain", "ms"])
def test_reverb_cuda(cuda_device, kw):
    n = 10 * SR
    nvs = [n, 6 * SR]
    got, want = _both(lambda s, d: reverb.build_reverb(
        s, "hall", device=d, **kw), _batch(n, 2, nvs), nvs)
    assert _db(got, want) <= BAR_DBFS


@pytest.mark.cuda
def test_resample_and_quantize_cuda(cuda_device):
    x = torch.from_numpy(_batch(441 * 100, 3)[:, 0])
    got = fdfilter.resample_fft(x.to(cuda_device), 48000)
    assert _db(got, fdfilter.resample_fft(x, 48000)) <= BAR_DBFS
    g = torch.Generator(device=cuda_device).manual_seed(0)
    noise = dither.dither_noise(g, got.shape, "tpdf", device=cuda_device)
    q = dither.quantize16(got, noise)
    assert q.dtype == torch.int16
    assert torch.equal(q.cpu(), dither.quantize16(got.cpu(), noise.cpu()))
    for kind in ("ns_e", "ns_itu"):
        white = 2.0 * torch.rand((2, 1 << 16), generator=g,
                                 device=cuda_device) - 1.0
        assert _db(dither.shape_noise(white, kind),
                   dither.shape_noise(white.cpu(), kind)) <= BAR_DBFS


@pytest.mark.cuda
@pytest.mark.parametrize("os_f", [2, 4])
def test_oversampled_exciter_cuda(cuda_device, os_f):
    """At 150 000 samples the 2x work-rate high pass plans 2^19: kernels
    4, 8 and 5 launch once each; at 4x it plans 2^20 on the staged FFT
    too."""
    n = 150_000
    x = _batch(n, 4) * 0.5
    counters = (fs.stage_a_cuda, fs.bc_cb_cuda, fs.inv_join_cuda)
    before = [f.launches for f in counters]
    got, want = _both(lambda s, d: exciter.build_harmonic_exciter(
        s, 0.6, oversample=os_f, device=d), x)
    assert fs.plan_ok(design.tpu_fft_plan(n * os_f))
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 1]
    assert _db(got, want) <= BAR_DBFS


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 2], ids=["mono", "stereo"])
def test_vocal_separator_cuda(cuda_device, channels):
    x = _batch(10 * SR + 7, 5)[0, :channels]
    got = vocal.isolate_vocal(x, SR, device=cuda_device)
    want = vocal.isolate_vocal(x, SR, device="cpu")
    assert got.shape == x.shape
    assert _db(torch.from_numpy(got), torch.from_numpy(want)) <= BAR_DBFS
