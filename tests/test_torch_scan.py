"""The port's de-esser envelope-gain tail against the JAX package's Pallas
gain-mode kernel (``_win_scan_pallas`` through ``deesser_gain_combine(...,
force_pallas=True, interpret=True)``).  atol 1e-5: every chunk equals the
exact recurrence to eps = 1e-8, and the two packages cut chunks
differently."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amw_tpu.ops import scan as jscan
from amw_tpu_torch.ops import fdfilter
from amw_tpu_torch.ops import scan as tscan


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    sc = (0.3 * rng.standard_normal(shape)).astype(np.float32)
    y3 = (0.5 * rng.standard_normal(shape)).astype(np.float32)
    return y3, sc


@pytest.mark.parametrize("nv", [None, 31000])
def test_gain_tail_matches_pallas_interpret(nv):
    sr = 44100
    att, rel = jscan.ar_coefs(sr, 0.004, 0.0085)  # short release: small W
    thresh = 10 ** (-6.0 / 20)
    ratio, k, n = 3.0, 67, 40000
    y3, sc = _pair((2, n), 0)
    want = np.asarray(jscan.deesser_gain_combine(
        jnp.asarray(y3), jnp.asarray(sc), att, rel, thresh, ratio, k,
        nv=nv, force_pallas=True, interpret=True))
    # the port takes a leading track axis: one track [1, 2, n]
    got = tscan.deesser_gain_combine(
        torch.from_numpy(y3[None]), torch.from_numpy(sc[None]), att, rel,
        thresh, ratio, k,
        nv=None if nv is None else torch.tensor([nv]))[0].numpy()
    W, C, K = tscan.chunk_geometry(2, n, tscan.warmup_len(att, rel))
    assert K > 1, "the test must exercise the chunked path"
    lim = n if nv is None else nv
    np.testing.assert_allclose(got[..., :lim], want[..., :lim], atol=1e-5)
    if nv is not None:
        # beyond the valid end the gain is zero before the box, so the
        # clipped gain is the floor: out = y3 - sc + 0.35 * sc
        tail = (y3 - sc + np.float32(0.35) * sc)[..., nv + k:]
        np.testing.assert_allclose(got[..., nv + k:], tail, atol=1e-6)


def test_gain_tail_batch_per_track_nv():
    sr = 96000
    att, rel = jscan.ar_coefs(sr, 0.004, 0.004)
    thresh = 10 ** (-6.0 / 20)
    k = max(3, int(sr * 0.0015))
    k += k % 2 == 0
    n, B = 42000, 3
    y3b, scb = _pair((B, 2, n), 1)
    nvs = [n, 33000, 39000]
    fv = jax.vmap(lambda a, b, nv: jscan.deesser_gain_combine(
        a, b, att, rel, thresh, 3.0, k, nv=nv, force_pallas=True,
        interpret=True))
    want = np.asarray(fv(jnp.asarray(y3b), jnp.asarray(scb),
                         jnp.asarray(nvs)))
    got = tscan.deesser_gain_combine(
        torch.from_numpy(y3b), torch.from_numpy(scb), att, rel, thresh, 3.0,
        k, nv=torch.tensor(nvs)).numpy()
    for i, nv in enumerate(nvs):
        err = np.max(np.abs(got[i, ..., :nv] - want[i, ..., :nv]))
        assert err < 1e-5, f"track {i} (nv={nv}): err {err}"


@pytest.mark.parametrize("rows,n", [(2, 40000), (16, 30000)])
def test_chunked_gain_equals_single_chunk(rows, n):
    """The port's chunk geometry against one exact sequential chunk."""
    att, rel = tscan.ar_coefs(44100, 0.001, 0.004)
    thresh = 10 ** (-6.0 / 20)
    x = torch.from_numpy(_pair((rows, n), 2)[1])
    nv = torch.full((rows,), n - 123, dtype=torch.int32)
    W, C, K = tscan.chunk_geometry(rows, n, tscan.warmup_len(att, rel))
    assert K > 1
    got = tscan.env_gain(x, nv, W, C, K, att, rel, thresh, 3.0, 0.35)
    want = tscan.env_gain_plain(x, nv, 0, n, 1, att, rel, thresh, 3.0, 0.35)
    assert got.shape == (rows, n)
    assert float((got - want).abs().max()) < 1e-5
    assert float(got[:, n - 123:].abs().max()) == 0.0


def test_gain_tail_at_card_geometry_matches_pallas_interpret():
    """The gain at the chunks the card takes (``scan_geometry`` for an
    H100's 132 SMs: many short chunks whose warm-ups reach back before 0),
    through the box and the combine, against the JAX package's gain-mode
    kernel."""
    sr = 44100
    att, rel = jscan.ar_coefs(sr, 0.004, 0.0085)
    thresh, ratio, floor = 10 ** (-6.0 / 20), 3.0, 0.35
    k, n, nv = 67, 40000, 31000
    y3, sc = _pair((2, n), 5)
    want = np.asarray(jscan.deesser_gain_combine(
        jnp.asarray(y3), jnp.asarray(sc), att, rel, thresh, ratio, k,
        nv=nv, force_pallas=True, interpret=True))
    W, C, K = tscan.scan_geometry(2, n, tscan.warmup_len(att, rel), 132)
    assert K > 1 and C < W, "the test must exercise the card's chunks"
    sct = torch.from_numpy(sc)
    gain = tscan.env_gain(sct, torch.full((2,), nv, dtype=torch.int32), W, C,
                          K, att, rel, thresh, ratio, floor)
    gain = fdfilter.box_smooth_same(gain, k).clamp(floor, 1.0)
    got = (torch.from_numpy(y3) - sct + sct * gain).numpy()
    np.testing.assert_allclose(got[..., :nv], want[..., :nv], atol=1e-5)


def test_envelope_follower_matches_jax():
    rng = np.random.default_rng(4)
    v = np.abs(0.3 * rng.standard_normal((2, 30000))).astype(np.float32)
    att, rel = jscan.ar_coefs(44100, 0.0005, 0.002)
    want = np.asarray(jscan.envelope_follower(jnp.asarray(v), att, rel,
                                              min_chunk=1024))
    got = tscan.envelope_follower(torch.from_numpy(v), att, rel).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.cuda
def test_env_gain_cuda_kernel_matches_plain(cuda_device):
    att, rel = tscan.ar_coefs(44100, 0.004, 0.085)
    thresh = 10 ** (-6.0 / 20)
    rows, n = 16, 220500
    x = torch.from_numpy(_pair((rows, n), 3)[1]).to(cuda_device)
    nv = torch.tensor([n, n - 50000] * 8, dtype=torch.int32,
                      device=cuda_device)
    W, C, K = tscan.chunk_geometry(rows, n, tscan.warmup_len(att, rel))
    before = tscan.env_gain_cuda.launches
    got = tscan.env_gain(x, nv, W, C, K, att, rel, thresh, 3.0, 0.35)
    torch.cuda.synchronize()
    assert tscan.env_gain_cuda.launches == before + 1
    want = tscan.env_gain_plain(x, nv, W, C, K, att, rel, thresh, 3.0, 0.35)
    assert float((got - want).abs().max()) <= 1e-5


def test_deesser_gain_combine_launches_the_kernel_on_cuda(monkeypatch):
    """No hidden fallback: on a CUDA tensor the de-esser's gain goes to
    the kernel's wrapper at the card geometry (``scan_geometry`` for the
    card's SMs), never to its plain version.  (A stand-in tensor, a
    recording wrapper and an H100's SM count: the check needs no GPU.)"""
    calls = []

    class _CudaTensor:
        is_cuda = True
        device = torch.device("cuda")

        def __init__(self, shape):
            self.shape = shape

        def reshape(self, *shape):
            return self

        def contiguous(self):
            return self

        def clamp(self, *args):
            return self

        __add__ = __sub__ = __mul__ = __rmul__ = lambda self, other: self

    def record(x2, nv_rows, *args):
        calls.append((nv_rows.tolist(), args))
        return x2

    monkeypatch.setattr(tscan, "env_gain_cuda", record)
    monkeypatch.setattr(tscan, "sm_count", lambda device: 132)
    monkeypatch.setattr(fdfilter, "box_smooth_same", lambda g, k: g)
    for name in ("env_gain_plain", "_env_chunks", "chunk_geometry"):
        monkeypatch.setattr(tscan, name, None)
    att, rel = tscan.ar_coefs(44100, 0.004, 0.085)
    thresh = 10 ** (-6.0 / 20)
    n = 7_938_000
    sc = _CudaTensor((8, 2, n))
    tscan.deesser_gain_combine(_CudaTensor((8, 2, n)), sc, att, rel, thresh,
                               3.0, 67, nv=torch.tensor([n] * 7 + [n // 2]))
    W, C, K = tscan.scan_geometry(16, n, tscan.warmup_len(att, rel), 132)
    assert (W, C, K) == (69_050, 30_080, 264)  # one block on every SM
    assert calls == [([n] * 14 + [n // 2] * 2,
                      (W, C, K, att, rel, thresh, 3.0, 0.35))]


def test_envelope_follower_raises_on_cuda_tensors(monkeypatch):
    """No hidden fallback: a CUDA tensor goes to a kernel wrapper (the
    JAX package's route: one sequence per row for short signals, the
    chunked kernel at the port's card geometry otherwise), never to the
    plain loop.  (A stand-in tensor, recording wrappers and an H100's SM
    count: the check needs no GPU.)"""
    calls = []

    class _CudaTensor:
        is_cuda = True
        device = torch.device("cuda")

        def __init__(self, n):
            self.shape = (2, n)

        def reshape(self, *shape):
            return self

        def contiguous(self):
            return self

    def record(name):
        def wrapper(v2, *args):
            calls.append((name, args))
            return torch.zeros(v2.shape)
        return wrapper

    monkeypatch.setattr(tscan, "env_rows_cuda", record("rows"))
    monkeypatch.setattr(tscan, "env_scan_cuda", record("scan"))
    monkeypatch.setattr(tscan, "sm_count", lambda device: 132)
    for name in ("env_rows_plain", "env_scan_plain", "_env_chunks"):
        monkeypatch.setattr(tscan, name, None)
    att, rel = tscan.ar_coefs(44100, 0.005, 0.1)
    w0 = tscan.warmup_len(att, rel)
    out = tscan.envelope_follower(_CudaTensor(2 * w0), att, rel)
    assert out.shape == (2, 2 * w0)
    n = 2 * w0 + 1
    tscan.envelope_follower(_CudaTensor(n), att, rel)
    assert calls == [("rows", (att, rel)),
                     ("scan", (*tscan.scan_geometry(2, n, w0, 132), att,
                               rel))]
