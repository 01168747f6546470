"""The envelope kernels (2, the de-esser's envelope → gain; 2′, the chunked
envelope; 3, the per-row envelope) against their plain PyTorch versions on
the card.

GPU only (``cuda`` marker; every test skips without a card).  The file
imports no JAX, so it runs on a machine with the card and no JAX package:

    python -m pytest --noconftest -q tests/test_torch_env_cuda.py

Bar: absolute 1e-5 on unit-scale input (every chunk equals the exact
recurrence to eps = 1e-8; kernel and plain version sum in f32).
"""

import numpy as np
import pytest
import torch

from amw_tpu_torch.ops import scan

ENV_ATOL = 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _v(rows, n, seed):
    g = np.random.default_rng(seed)
    env = 0.5 + 0.5 * np.abs(np.sin(np.arange(n) / 3000.0))
    return torch.from_numpy(np.abs(g.standard_normal((rows, n)) * env)
                            .astype(np.float32))


def _sidechain(rows, n, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy((0.3 * g.standard_normal((rows, n)))
                            .astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,ballistics", [
    (16, 300_000, (0.005, 0.1)),   # the transient designer's slow follower
    (4, 100_003, (0.0005, 0.005)),  # its fast follower
    (2, 90_000, (0.002, 0.04)),     # one chunk, no warm-up
])
def test_env_scan_cuda_matches_plain(cuda_device, rows, n, ballistics):
    att, rel = scan.ar_coefs(44100, *ballistics)
    v = _v(rows, n, 1).to(cuda_device)
    W, C, K = scan.chunk_geometry(rows, n, scan.warmup_len(att, rel))
    before = scan.env_scan_cuda.launches
    got = scan.env_scan_cuda(v, W, C, K, att, rel)
    torch.cuda.synchronize()
    assert scan.env_scan_cuda.launches == before + 1
    want = scan.env_scan_plain(v, W, C, K, att, rel)
    assert float((got - want).abs().max()) <= ENV_ATOL
    exact = scan.env_rows_plain(v, att, rel)
    assert float((got - exact).abs().max()) <= ENV_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,ballistics", [
    (16, 300_000, (0.005, 0.1)),     # slow follower: warm-ups before 0
    (3, 100_003, (0.0005, 0.005)),   # fast follower, a ragged last chunk
])
def test_env_scan_cuda_card_and_parent_geometry(cuda_device, rows, n,
                                                ballistics):
    """The staged kernel at the card geometry (``scan_geometry``, the SM
    count of this card) and at ``chunk_geometry``'s: each equals its plain
    version and the exact recurrence."""
    att, rel = scan.ar_coefs(44100, *ballistics)
    w0 = scan.warmup_len(att, rel)
    v = _v(rows, n, 4).to(cuda_device)
    exact = scan.env_rows_plain(v, att, rel)
    card = scan.scan_geometry(rows, n, w0, scan.sm_count(cuda_device))
    for W, C, K in (card, scan.chunk_geometry(rows, n, w0)):
        assert K > 1
        got = scan.env_scan_cuda(v, W, C, K, att, rel)
        torch.cuda.synchronize()
        want = scan.env_scan_plain(v, W, C, K, att, rel)
        assert float((got - want).abs().max()) <= ENV_ATOL, (W, C, K)
        assert float((got - exact).abs().max()) <= ENV_ATOL, (W, C, K)


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,W,C", [
    (1, 5_000, 333, 1_000),   # 5 chunks: rows that do not fill a block
    (2, 3_000, 0, 512),       # no warm-up
    (5, 7_001, 333, 384),     # 95 chunks: a last block of 31, W % 128 != 0
    (2, 4_000, 1_000, 256),   # warm-ups reaching back before 0
    (3, 700, 0, 700),         # one chunk a row, C not a multiple of 128
])
def test_env_scan_cuda_odd_geometries(cuda_device, rows, n, W, C):
    att, rel = scan.ar_coefs(44100, 0.0005, 0.004)
    K = -(-n // C)
    v = _v(rows, n, 5).to(cuda_device)
    got = scan.env_scan_cuda(v, W, C, K, att, rel)
    torch.cuda.synchronize()
    want = scan.env_scan_plain(v, W, C, K, att, rel)
    assert float((got - want).abs().max()) <= ENV_ATOL


@pytest.mark.cuda
def test_env_step_cycles(cuda_device):
    """The chain's clock: more steps take more cycles."""
    att, rel = scan.ar_coefs(44100, 0.005, 0.1)
    short = scan.env_step_cycles(1 << 12, att, rel, cuda_device)
    long = scan.env_step_cycles(1 << 16, att, rel, cuda_device)
    assert 0 < short < long


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [
    (16, 88_200),  # the kernels phase's [16, 88 200]: one block
    (2, 88_200),   # the 2 s clip's own two rows
    (33, 5_000),   # two blocks, the second of one row
    (1, 129),      # n not a multiple of the 128-step tile
    (3, 1_000),
])
def test_env_rows_cuda_matches_plain(cuda_device, rows, n):
    """Kernel 3, the staged walk at (W, C, K) = (0, n, 1)."""
    att, rel = scan.ar_coefs(44100, 0.005, 0.1)
    v = _v(rows, n, 2).to(cuda_device)
    before = scan.env_rows_cuda.launches
    got = scan.env_rows_cuda(v, att, rel)
    torch.cuda.synchronize()
    assert scan.env_rows_cuda.launches == before + 1
    want = scan.env_rows_plain(v, att, rel)
    assert float((got - want).abs().max()) <= ENV_ATOL
    assert torch.equal(got[:, 0], v[:, 0])  # env[0] = v[0]


@pytest.mark.cuda
def test_envelope_follower_routes_on_cuda(cuda_device):
    """Short signals launch the per-row kernel, long ones the chunked one,
    and both agree with the CPU path."""
    att, rel = scan.ar_coefs(44100, 0.005, 0.1)
    w0 = scan.warmup_len(att, rel)
    for n, counter in ((2 * w0, scan.env_rows_cuda),
                       (2 * w0 + 1, scan.env_scan_cuda)):
        v = _v(2, n, 3)
        before = counter.launches
        got = scan.envelope_follower(v.to(cuda_device), att, rel)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        want = scan.envelope_follower(v, att, rel)
        assert float((got.cpu() - want).abs().max()) <= ENV_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n,nv_short", [
    (16, 220_500, (185_220, 158_760)),  # the v1 5 s batch, two padded tracks
    (2, 88_200, (60_000,)),             # the 2 s clip, one row padded
    (1, 300_000, (250_000,)),           # one padded row
])
def test_env_gain_cuda_card_and_chunk_geometry(cuda_device, rows, n,
                                               nv_short):
    """Kernel 2 at the card geometry (``scan_geometry`` for this card's
    SMs, the main path's) and at ``chunk_geometry``'s: each equals its
    plain version (expected: exactly) and is 0 past each row's end."""
    att, rel = scan.ar_coefs(44100, 0.004, 0.085)
    thresh = 10 ** (-6.0 / 20)
    w0 = scan.warmup_len(att, rel)
    x = _sidechain(rows, n, 6).to(cuda_device)
    nvs = [n] * (rows - len(nv_short)) + list(nv_short)
    nv = torch.tensor(nvs, dtype=torch.int32, device=cuda_device)
    card = scan.scan_geometry(rows, n, w0, scan.sm_count(cuda_device))
    for W, C, K in (card, scan.chunk_geometry(rows, n, w0)):
        got = scan.env_gain_cuda(x, nv, W, C, K, att, rel, thresh, 3.0,
                                 0.35)
        torch.cuda.synchronize()
        want = scan.env_gain_plain(x, nv, W, C, K, att, rel, thresh, 3.0,
                                   0.35)
        assert float((got - want).abs().max()) <= 1e-5, (W, C, K)
        for r, v in enumerate(nvs):
            assert int(torch.count_nonzero(got[r, v:])) == 0
