"""The staged FFT's CUDA kernels against their plain PyTorch versions.

GPU only (``cuda`` marker; every test skips without a card).  The file
imports no JAX, so it runs on a machine with the card and no JAX package:

    python -m pytest --noconftest -q tests/test_torch_fft_cuda.py

Bars: relative 3e-6 of the largest magnitude for a stage's output,
absolute 2e-5 for round trips of unit-variance signals against
``torch.fft`` (cuFFT), relative 1e-5 for the reduce with its band maps —
the JAX suite's bars for its Pallas FFT (tests/test_fft_pallas.py).  The
kernels run radix-2 f32 transforms, the plain versions f32 complex matmuls
(TF32 off): both f32-accurate, summed in different orders.
"""

import numpy as np
import pytest
import torch

from amw_tpu_torch.ops import fft_staged as tfs
from amw_tpu_torch.ops.bands import BandMap

REL_STAGE = 3e-6
ABS_RT = 2e-5
REL_REDUCE = 1e-5
BANDS = [(-7.2, 1.0, 6.0, 12.0, -7.2, 1.5), (-18.5, 2.2, 6.0, 12.0, -18.5, 1.8),
         (-17.0, 0.6, 6.0, 12.0, -17.0, 1.65), (-15.0, 1.35, 0.2, 12.0, -15.0, 1.2)]
ALL_SIZES = [1 << k for k in range(19, 25)]  # every plan_ok size, C 32..1024


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _rel(got, want):
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def _planes(shape, seed, scale=1.0):
    g = np.random.default_rng(seed)
    return [torch.from_numpy((scale * g.standard_normal(shape)).astype(
        np.float32)) for _ in range(2)]


def _resps(nfft, K, seed):
    g = np.random.default_rng(seed)
    H = [g.random(nfft // 2 + 1) + 0.25 for _ in range(K)]
    return H, torch.from_numpy(
        np.stack([tfs.permute_full_response(h, nfft) for h in H]))


@pytest.mark.cuda
@pytest.mark.parametrize("nfft", ALL_SIZES)
def test_stage_a_and_join_cuda_match_plain(cuda_device, nfft):
    dev = cuda_device
    tabs = tfs._device_tables(nfft, dev)
    n = nfft - 777
    xr, xi = (p.to(dev) for p in _planes((4, n), 11))
    for inverse, real_in, real_out in ((False, False, False),
                                       (False, True, False),
                                       (True, False, True),
                                       (True, False, False)):
        a = xr if not inverse else torch.nn.functional.pad(xr, (0, 777))
        b = xi if not inverse else torch.nn.functional.pad(xi, (0, 777))
        before = tfs.stage_a_cuda.launches
        got = tfs._stage_a(a, b, nfft, inverse, tabs, real_in, real_out)
        torch.cuda.synchronize()
        assert tfs.stage_a_cuda.launches == before + 1
        want = tfs.stage_a_plain(a, b, nfft, inverse, tabs, real_in, real_out)
        for g, w in zip(got, want):
            if w is not None:
                assert _rel(g, w) < REL_STAGE
    yr = torch.nn.functional.pad(xr, (0, 777))
    yi = torch.nn.functional.pad(xi, (0, 777))
    got = tfs._stage_a_inv_join(yr, yi, 2, nfft, tabs)
    want = tfs.inv_join_plain(yr, yi, 2, nfft, tabs)
    assert _rel(got, want) < REL_STAGE


@pytest.mark.cuda
@pytest.mark.parametrize("nfft", ALL_SIZES)
def test_bccb_and_reduce_cuda_match_plain(cuda_device, nfft):
    dev = cuda_device
    tabs = tfs._device_tables(nfft, dev)
    xr, xi = (p.to(dev) for p in _planes((2, nfft), 12, 0.3))
    resps = _resps(nfft, 4, 13)[1].to(dev)
    for K in (2, 4):
        before = tfs.bccb_multi_cuda.launches
        gr, gi = tfs._stage_bccb_multi(xr, xi, resps[:K], nfft, tabs)
        torch.cuda.synchronize()
        assert tfs.bccb_multi_cuda.launches == before + 1
        wr, wi = tfs.bccb_multi_plain(xr, xi, resps[:K], nfft, tabs)
        assert _rel(gr, wr) < REL_STAGE
        assert _rel(gi, wi) < REL_STAGE
    maps = [BandMap(*b) for b in BANDS]
    got = tfs._reduce_stage_a_packed(gr, gi, 4, 2, nfft, maps, tabs)
    want = tfs.reduce_packed_plain(gr, gi, 4, 2, nfft, maps, tabs)
    assert _rel(got, want) < REL_REDUCE


@pytest.mark.cuda
@pytest.mark.parametrize("nfft", ALL_SIZES)
@pytest.mark.parametrize("rows", [2, 3])
def test_roundtrip_multi_cuda_matches_torch_fft(cuda_device, nfft, rows):
    dev = cuda_device
    n = nfft - 1234
    x = _planes((rows, n), 14)[0].to(dev)
    H, resps = _resps(nfft, 2, 15)
    ys = tfs.roundtrip_multi(x, resps.to(dev), nfft, n)
    X = torch.fft.rfft(x, n=nfft, dim=-1)
    for k in range(2):
        Hk = torch.from_numpy(H[k].astype(np.float32)).to(dev)
        want = torch.fft.irfft(X * Hk, n=nfft, dim=-1)[:, :n]
        assert float((ys[k] - want).abs().max()) < ABS_RT


@pytest.mark.cuda
@pytest.mark.parametrize("nfft", ALL_SIZES)
def test_bc_cb_cuda_matches_plain(cuda_device, nfft):
    """Kernel 8 (one response) against its plain version."""
    dev = cuda_device
    tabs = tfs._device_tables(nfft, dev)
    xr, xi = (p.to(dev) for p in _planes((3, nfft), 16, 0.3))
    resp = _resps(nfft, 1, 17)[1][0].to(dev)
    before = tfs.bc_cb_cuda.launches
    gr, gi = tfs._stage_bc_cb(xr, xi, resp, nfft, tabs)
    torch.cuda.synchronize()
    assert tfs.bc_cb_cuda.launches == before + 1
    wr, wi = tfs.bc_cb_plain(xr, xi, resp, nfft, tabs)
    assert _rel(gr, wr) < REL_STAGE
    assert _rel(gi, wi) < REL_STAGE


@pytest.mark.cuda
@pytest.mark.parametrize("nfft", ALL_SIZES)
@pytest.mark.parametrize("rows", [1, 2, 3])
def test_fused_round_trips_cuda_match_plain(cuda_device, nfft, rows):
    """Kernels 8 and 9 (one instance of the register C pass per plan)
    against their plain versions at K = 1..4 responses: K = 3 and the
    unpacked single row catch loop and edge faults the K = 2 / 4 cases
    miss.  One launch of the wrapper per call."""
    dev = cuda_device
    tabs = tfs._device_tables(nfft, dev)
    xr, xi = (p.to(dev) for p in _planes((rows, nfft), 27 + rows, 0.3))
    resps = _resps(nfft, 4, 31)[1].to(dev)
    before = tfs.bc_cb_cuda.launches
    gr, gi = tfs._stage_bc_cb(xr, xi, resps[1], nfft, tabs)
    torch.cuda.synchronize()
    assert tfs.bc_cb_cuda.launches == before + 1
    wr, wi = tfs.bc_cb_plain(xr, xi, resps[1], nfft, tabs)
    assert _rel(gr, wr) < REL_STAGE and _rel(gi, wi) < REL_STAGE
    for K in (1, 2, 3, 4):
        before = tfs.bccb_multi_cuda.launches
        gr, gi = tfs._stage_bccb_multi(xr, xi, resps[:K], nfft, tabs)
        torch.cuda.synchronize()
        assert tfs.bccb_multi_cuda.launches == before + 1
        assert gr.shape == (K * rows, nfft)
        wr, wi = tfs.bccb_multi_plain(xr, xi, resps[:K], nfft, tabs)
        assert _rel(gr, wr) < REL_STAGE and _rel(gi, wi) < REL_STAGE
    del gr, gi, wr, wi


@pytest.mark.cuda
@pytest.mark.parametrize("nfft", ALL_SIZES)
@pytest.mark.parametrize("rows", [2, 3])
def test_apply_response_cuda_matches_torch_fft(cuda_device, nfft, rows):
    """``apply_response``, packed (even rows) and unpacked (odd rows)."""
    dev = cuda_device
    n = nfft - 4321
    x = _planes((rows, n), 18)[0].to(dev)
    H, resps = _resps(nfft, 1, 19)
    y = tfs.apply_response(x, resps[0].to(dev), nfft, n_out=n)
    Hk = torch.from_numpy(H[0].astype(np.float32)).to(dev)
    want = torch.fft.irfft(torch.fft.rfft(x, n=nfft, dim=-1) * Hk, n=nfft,
                           dim=-1)[:, :n]
    assert y.shape == (rows, n)
    assert float((y - want).abs().max()) < ABS_RT


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 2, 4, 8])
@pytest.mark.parametrize("rows", [1, 3])
@pytest.mark.parametrize("nfft", [1 << 20, 1 << 23])
def test_reduce_kernels_cuda_match_plain(cuda_device, nfft, rows, K):
    """Kernels 11 (packed, R2 = rows) and 12 (unpacked, R = rows) at K
    bands whose maps cycle through every mode (bypass, soft knee, upward
    boost, hard knee), on spectra scaled so that each plane's inverse is
    ~0.2 RMS (mastering levels), so every branch of every map runs.  One
    launch of each wrapper per call."""
    dev = cuda_device
    tabs = tfs._device_tables(nfft, dev)
    maps = [BandMap(*BANDS[k % len(BANDS)]) for k in range(K)]
    yr, yi = (p.to(dev) for p in _planes((K * rows, nfft), 40 + K + rows,
                                         0.3 * (nfft / 2) ** 0.5))
    before = tfs.reduce_packed_cuda.launches
    got = tfs._reduce_stage_a_packed(yr, yi, K, rows, nfft, maps, tabs)
    torch.cuda.synchronize()
    assert tfs.reduce_packed_cuda.launches == before + 1
    assert got.shape == (2 * rows, nfft)
    want = tfs.reduce_packed_plain(yr, yi, K, rows, nfft, maps, tabs)
    assert _rel(got, want) < REL_REDUCE
    before = tfs.reduce_cuda.launches
    got = tfs._reduce_stage_a(yr, yi, K, rows, nfft, maps, tabs)
    torch.cuda.synchronize()
    assert tfs.reduce_cuda.launches == before + 1
    assert got.shape == (rows, nfft)
    want = tfs.reduce_plain(yr, yi, K, rows, nfft, maps, tabs)
    assert _rel(got, want) < REL_REDUCE


@pytest.mark.cuda
def test_unpacked_reduce_cuda_matches_plain_and_torch_fft(cuda_device):
    """Odd row counts take the unpacked reduce (kernel 12): it matches its
    plain version, and ``roundtrip_multi_reduce`` over 3 rows matches
    ``torch.fft`` with the maps applied per band.  The reference bands are
    float64 transforms, as the JAX suite's and tests/test_torch_fft.py's
    references for this bar are: the maps amplify a band's rounding ~10x,
    so a float32 reference spends the bar on its own error."""
    nfft = 1 << 19
    dev = cuda_device
    tabs = tfs._device_tables(nfft, dev)
    maps = [BandMap(*b) for b in BANDS]
    yr, yi = (p.to(dev) for p in _planes((4 * 3, nfft), 20, 0.3))
    before = tfs.reduce_cuda.launches
    got = tfs._reduce_stage_a(yr, yi, 4, 3, nfft, maps, tabs)
    torch.cuda.synchronize()
    assert tfs.reduce_cuda.launches == before + 1
    want = tfs.reduce_plain(yr, yi, 4, 3, nfft, maps, tabs)
    assert _rel(got, want) < REL_REDUCE
    n = nfft - 999
    x = _planes((3, n), 21)[0].to(dev)
    H, resps = _resps(nfft, 4, 22)
    got = tfs.roundtrip_multi_reduce(x, resps.to(dev), nfft, n, maps)
    X = torch.fft.rfft(x.double(), n=nfft, dim=-1)
    want = sum(maps[k](torch.fft.irfft(
        X * torch.from_numpy(H[k].astype(np.float32)).double().to(dev),
        n=nfft, dim=-1)[:, :n].float()) for k in range(4))
    assert _rel(got, want) < REL_REDUCE


@pytest.mark.cuda
@pytest.mark.parametrize("nfft", ALL_SIZES)
@pytest.mark.parametrize("rows", [1, 2, 3])
def test_split_stages_cuda_match_plain(cuda_device, nfft, rows):
    """Kernels 6 (forward B+C, one pass: every cluster size of its rule
    launched over the plans), 7 (inverse C+B with and without a response)
    and 10 (K = 1 to 4 responses) against their plain versions."""
    dev = cuda_device
    tabs = tfs._device_tables(nfft, dev)
    xr, xi = (p.to(dev) for p in _planes((rows, nfft), 23, 0.3))
    resps = _resps(nfft, 4, 24)[1].to(dev)
    before = tfs.bc_cuda.launches
    Sr, Si = tfs._stage_bc(xr, xi, nfft, tabs)
    torch.cuda.synchronize()
    assert tfs.bc_cuda.launches == before + 1
    Pr, Pi = tfs.bc_plain(xr, xi, nfft, tabs)
    assert _rel(Sr, Pr) < REL_STAGE and _rel(Si, Pi) < REL_STAGE
    for resp in (resps[0], None):
        before = tfs.cb_cuda.launches
        gr, gi = tfs._stage_cb(Sr, Si, resp, nfft, tabs)
        torch.cuda.synchronize()
        assert tfs.cb_cuda.launches == before + 1
        wr, wi = tfs.cb_plain(Sr, Si, resp, nfft, tabs)
        assert _rel(gr, wr) < REL_STAGE and _rel(gi, wi) < REL_STAGE
    for K in (1, 2, 3, 4):
        before = tfs.cb_multi_cuda.launches
        gr, gi = tfs._stage_cb_multi(Sr, Si, resps[:K], nfft, tabs)
        torch.cuda.synchronize()
        assert tfs.cb_multi_cuda.launches == before + 1
        assert gr.shape == (K * rows, nfft)
        wr, wi = tfs.cb_multi_plain(Sr, Si, resps[:K], nfft, tabs)
        assert _rel(gr, wr) < REL_STAGE and _rel(gi, wi) < REL_STAGE


@pytest.mark.cuda
@pytest.mark.parametrize("nfft", ALL_SIZES)
@pytest.mark.parametrize("rows", [1, 2, 3])
def test_bc_one_pass_equals_two_pass_yardstick(cuda_device, nfft, rows):
    """Kernel 6's one pass against the two-pass design it replaced
    (``scripts/bc_variants.cu``: the register B pass, then the C pass on
    its output in device memory) and against itself at half its cluster
    size where that tile fits a block: the same arithmetic in the same
    order, so equal bit for bit."""
    from amw_tpu_torch.scripts.ab_bccb import build_bc_variants, var_bc

    dev = cuda_device
    tabs = tfs._device_tables(nfft, dev)
    xr, xi = (p.to(dev) for p in _planes((rows, nfft), 50 + rows, 0.3))
    Sr, Si = tfs.bc_cuda(xr, xi, nfft, tabs)
    dll = build_bc_variants()
    for variant in (0, 1, 2):
        if variant == 2 and nfft == 1 << 24:
            continue  # Q = 4 at C = 1024: a 256 KB tile a block
        gr, gi, fit = var_bc(dll, variant, xr, xi, nfft, tabs)
        torch.cuda.synchronize()
        assert fit >= 1 or variant == 0  # clusters that fit at once
        assert torch.equal(gr, Sr) and torch.equal(gi, Si), variant


@pytest.mark.cuda
@pytest.mark.parametrize("nfft", ALL_SIZES)
@pytest.mark.parametrize("rows", [1, 3])
def test_split_forward_then_inverse_cuda_is_identity(cuda_device, nfft,
                                                     rows):
    """Kernel 6, then kernel 7 with no response: the forward and inverse
    instances of the register C pass at this plan's C, held against each
    other as adjoints.  Every B and C pass is unscaled (the 1/nfft sits in
    the inverse stage A), so the pair returns its input times 128 * C."""
    dev = cuda_device
    tabs = tfs._device_tables(nfft, dev)
    xr, xi = (p.to(dev) for p in _planes((rows, nfft), 32 + rows, 0.3))
    before = (tfs.bc_cuda.launches, tfs.cb_cuda.launches)
    gr, gi = tfs._stage_cb(*tfs._stage_bc(xr, xi, nfft, tabs), None, nfft,
                           tabs)
    torch.cuda.synchronize()
    assert (tfs.bc_cuda.launches, tfs.cb_cuda.launches) == (before[0] + 1,
                                                            before[1] + 1)
    scale = tfs.B * (nfft // (tfs.A * tfs.B))  # 128 * C
    assert _rel(gr, scale * xr) < REL_STAGE
    assert _rel(gi, scale * xi) < REL_STAGE


@pytest.mark.cuda
def test_bc_kernels_refuse_unaligned_planes(cuda_device):
    """The C pass moves the stored order as 16-byte vectors: a contiguous
    plane that starts 4 bytes off is refused, not read misaligned."""
    nfft = 1 << 19
    dev = cuda_device
    tabs = tfs._device_tables(nfft, dev)
    buf = torch.zeros(2 * nfft + 4, device=dev)
    off = buf[1:1 + nfft].view(1, nfft)
    ok = torch.zeros(1, nfft, device=dev)
    resp = torch.ones(2, nfft, device=dev)
    for call in (lambda: tfs.bc_cuda(off, ok, nfft, tabs),
                 lambda: tfs.cb_cuda(ok, off, None, nfft, tabs),
                 lambda: tfs.cb_cuda(ok, ok, buf[1:1 + 2 * nfft].view(2, nfft),
                                     nfft, tabs),
                 lambda: tfs.cb_multi_cuda(off, ok, resp[None], nfft, tabs),
                 lambda: tfs.bc_cb_cuda(off, ok, resp, nfft, tabs)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            call()
    tfs.cb_cuda(*tfs.bc_cuda(ok, ok, nfft, tabs), resp, nfft, tabs)


@pytest.mark.cuda
@pytest.mark.parametrize("nfft", ALL_SIZES)
def test_split_route_cuda_matches_torch_fft(cuda_device, nfft, monkeypatch):
    """``AMW_FFT_FUSED_RT=0``: ``apply_response`` (packed and unpacked)
    and ``roundtrip_multi`` through kernels 6, 7 and 10 against
    ``torch.fft``, and ``ifft_permuted`` inverting ``fft_permuted``."""
    monkeypatch.setenv("AMW_FFT_FUSED_RT", "0")
    dev = cuda_device
    n = nfft - 2345
    x = _planes((3, n), 25)[0].to(dev)
    H, resps = _resps(nfft, 2, 26)
    resps = resps.to(dev)
    X = torch.fft.rfft(x, n=nfft, dim=-1)
    want = [torch.fft.irfft(X * torch.from_numpy(H[k].astype(np.float32))
                            .to(dev), n=nfft, dim=-1)[:, :n] for k in (0, 1)]
    fused = (tfs.bc_cb_cuda.launches, tfs.bccb_multi_cuda.launches)
    for rows in (slice(0, 2), slice(0, 3)):
        y = tfs.apply_response(x[rows], resps[0], nfft, n_out=n)
        assert float((y - want[0][rows]).abs().max()) < ABS_RT
    ys = tfs.roundtrip_multi(x, resps, nfft, n)
    for k in (0, 1):
        assert float((ys[k] - want[k]).abs().max()) < ABS_RT
    assert (tfs.bc_cb_cuda.launches, tfs.bccb_multi_cuda.launches) == fused
    xr, xi = x[:2], x[1:]
    yr, yi = tfs.ifft_permuted(*tfs.fft_permuted(xr, xi, nfft), nfft)
    assert float((yr[:, :n] - xr).abs().max()) < ABS_RT
    assert float((yi[:, :n] - xi).abs().max()) < ABS_RT
