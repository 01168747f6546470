"""A CPU rehearsal of the B passes of the fused round trips, kernels 8 and 9
(``csrc/fft_breg.cuh``, launched by ``csrc/fft_bccb.cu``'s ``run_bccb``).

The replay takes the kernel's steps in torch index arithmetic, with
nothing taken from the kernel but the constants its headers declare
(checked against the replay's own): the grid of blocks (matrix ``b //
(C / 32)``, strip ``32 · (b % (C / 32))``), thread (g, t)'s rows ``g + 8 i``
of its column, the inverse's conj T2 on those input rows, the 16-point
DFT over i (radix 4 × 4 with ``fft_areg.cuh``'s W_16 constants), the
twiddle W_128^(g·k1) from the warp's own table, the exchange
``ex[k1][g][t]``, warp w's 8-point DFTs over g for ``k1 = w + 8 h``, their
output rows ``w + 8 (2 k2 + h)``, the forward's T2 on those output rows,
and the stores, each position once and each by the warp that loaded it
(so the inverse may run in place).  The forward sign is the inverse
transform between two swaps of the real and imaginary parts.

Held against the plain B steps inside ``bc_plain`` (the forward pass,
then the plain C stage) and ``cb_multi_plain`` (the plain inverse C stage
under K responses, then the inverse pass) at 1e-6 relative to the largest
magnitude, at nfft 2^19 and 2^20 (C = 32 and 64); and the whole round
trip (replayed B passes around the plain C stages) against the JAX
package's Pallas kernels ``_stage_bc_cb`` and ``_stage_bccb_multi``
(interpret mode) at ``REL_STAGE`` = 3e-6, the bar of
tests/test_torch_fft.py.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amw_tpu.ops import fft_pallas as jfp
from amw_tpu_torch.ops import fft_staged as tfs
from test_torch_reduce_factored import _idft

CSRC = Path(tfs.__file__).resolve().parent.parent / "csrc"
CPU = torch.device("cpu")
A, COLS, G, I = 128, 32, 8, 16  # rows, strip width, warps, rows a thread
BLOCKS_AN_SM = 3
REL_REPLAY = 1e-6
REL_STAGE = 3e-6
SIZES = [1 << 19, 1 << 20]  # C = 32 (one strip a matrix) and 64 (two)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread keeps them from spinning against
    the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _constants(name: str) -> dict:
    text = (CSRC / name).read_text()
    return {k: int(v) for k, v in re.findall(
        r"constexpr int (k\w+) = (\d+);", text)}


def test_header_constants_match_the_replay():
    assert _constants("fft_areg.cuh") == {"kAregRows": A, "kAregCols": COLS,
                                          "kAregG": G, "kAregI": I}
    assert _constants("fft_breg.cuh") == {"kBregBlocks": BLOCKS_AN_SM}
    breg = (CSRC / "fft_breg.cuh").read_text()
    assert '#include "fft_areg.cuh"' in breg
    # the pass's static shared memory, from its declarations: under the 48
    # KB a block gets without asking, and room for the launch bound's
    # blocks in the 227 KB of an SM
    assert re.findall(r"__shared__ (\w+) (\w+)(.*);", breg) == [
        ("AregExchange", "ex", ""),
        ("float2", "w128", "[kAregG][kAregRows]")]
    areg = (CSRC / "fft_areg.cuh").read_text()
    assert re.search(r"struct AregExchange \{\s*float2 v\[kAregI\]"
                     r"\[kAregG\]\[kAregCols\];", areg)
    smem = I * G * COLS * 8 + G * A * 8
    assert smem <= 48 * 1024 and BLOCKS_AN_SM * smem <= 227 * 1024


def test_round_trips_launch_the_register_b_pass():
    """run_bccb's passes 1 and 3 are the register B pass, forward then
    inverse in place on the outputs; col_dft128_kernel is gone from it."""
    text = (CSRC / "fft_bccb.cu").read_text()
    code = "\n".join(line for line in text.splitlines()
                     if not line.lstrip().startswith("//"))
    assert '#include "fft_breg.cuh"' in code
    assert "fft128.cuh" not in code and "col_dft128_kernel" not in code
    calls = re.findall(r"launch_b_pass\((\w+), (\w+), (\w+),", code)
    assert calls == [("false", "xr", "xi"), ("true", "out_r", "out_i")]


def _swap(z: torch.Tensor) -> torch.Tensor:
    return torch.complex(z.imag, z.real)


def replay(Xr, Xi, C: int, tw: torch.Tensor, inverse: bool):
    """The kernel's blocks, threads and steps, all blocks and lanes at once:
    ``[Q·128·C]`` planes of Q matrices ``[128, C]`` → the pass's output
    planes.  ``tw``: T2 (forward) or conj T2 (inverse), ``[128·C]``
    complex."""
    Q = Xr.numel() // (A * C)
    strips = C // COLS
    blk = torch.arange(Q * strips)
    m = (blk // strips)[:, None]
    col0 = (blk % strips) * COLS
    t = torch.arange(COLS)
    X = torch.complex(Xr, Xi).reshape(Q, A * C)
    w128 = torch.tensor(np.exp(2j * np.pi * np.arange(A) / A),
                        dtype=torch.complex64)

    def pos(g, i):  # [nb, 32]: row g + 8 i of every block's columns
        return ((g + G * i) * C + col0)[:, None] + t[None, :]

    ex = {}
    for g in range(G):
        x = [X[m, pos(g, i)] for i in range(I)]
        if inverse:
            x = [v * tw[pos(g, i)] for i, v in enumerate(x)]
        else:
            x = [_swap(v) for v in x]
        u = _idft(x, I)
        for k1 in range(I):
            ex[k1, g] = u[k1] * w128[g * k1] if k1 else u[k1]
    out = torch.full((Q, A * C), complex("nan"), dtype=torch.complex64)
    hits = torch.zeros((Q, A * C), dtype=torch.int32)
    for w in range(G):
        rows_in = {w + G * i for i in range(I)}
        rows_out = set()
        for h in range(2):
            z = _idft([ex[w + G * h, g] for g in range(G)], G)
            for k2 in range(G):
                j = 2 * k2 + h
                rows_out.add(w + G * j)  # row k1 + 16 k2, k1 = w + 8 h
                v = z[k2] if inverse else _swap(z[k2]) * tw[pos(w, j)]
                out[m, pos(w, j)] = v
                hits[m, pos(w, j)] += 1
        assert rows_out == rows_in, "a warp stores rows it did not load"
    assert bool((hits == 1).all()), "a position stored twice or never"
    return out.real.reshape(Xr.shape), out.imag.reshape(Xr.shape)


def _tw(tables, inverse: bool) -> torch.Tensor:
    return torch.complex(*tfs._tabs(tables, inverse)[2:4]).reshape(-1)


def _planes(R: int, nfft: int, seed: int):
    g = np.random.default_rng(seed)
    return [torch.from_numpy(g.standard_normal((R, nfft)).astype(np.float32))
            for _ in range(2)]


def _resps(nfft: int, K: int, seed: int) -> torch.Tensor:
    g = np.random.default_rng(seed)
    return torch.from_numpy(np.stack([
        tfs.permute_full_response(g.random(nfft // 2 + 1) + 0.25, nfft)
        for _ in range(K)]))


def _cpass(Zr, Zi, resps, nfft: int):
    """Pass 2 as the plain versions compute it: the forward C stage of the
    pass-1 output, the K products, the inverse C stage (no conj T2: pass 3
    applies it) → ``[K·R, nfft]`` planes."""
    R, K = Zr.shape[0], resps.shape[0]
    C = nfft // (A * A)
    y = tfs._cstage_fwd(torch.complex(Zr, Zi).reshape(R, A, A, C), nfft)
    y = y.reshape(1, R, A, A, C) * torch.complex(
        resps[:, 0], resps[:, 1]).reshape(K, 1, A, A, C)
    y = tfs._cstage_inv(y, nfft).reshape(K * R, nfft)
    return y.real.contiguous(), y.imag.contiguous()


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("nfft", SIZES)
def test_forward_replay_matches_bc_plain(nfft):
    """Pass 1, then the plain C stage, against ``bc_plain``."""
    C = nfft // (A * A)
    tabs = tfs._device_tables(nfft, CPU)
    xr, xi = _planes(2, nfft, 11)
    zr, zi = replay(xr, xi, C, _tw(tabs, False), inverse=False)
    y = tfs._cstage_fwd(torch.complex(zr, zi).reshape(2, A, A, C), nfft)
    wr, wi = tfs.bc_plain(xr, xi, nfft, tabs)
    assert _rel(y.real.reshape(2, nfft), wr) <= REL_REPLAY
    assert _rel(y.imag.reshape(2, nfft), wi) <= REL_REPLAY


@pytest.mark.parametrize("nfft", SIZES)
@pytest.mark.parametrize("K", [1, 3])
def test_inverse_replay_matches_cb_multi_plain(nfft, K):
    """The plain inverse C stage under K responses, then pass 3, against
    ``cb_multi_plain`` on the same stored spectrum."""
    C = nfft // (A * A)
    tabs = tfs._device_tables(nfft, CPU)
    Yr, Yi = _planes(2, nfft, 12 + K)
    resps = _resps(nfft, K, 13 + K)
    y = torch.complex(Yr, Yi).reshape(1, 2, A, A, C) * torch.complex(
        resps[:, 0], resps[:, 1]).reshape(K, 1, A, A, C)
    y = tfs._cstage_inv(y, nfft).reshape(K * 2, nfft)
    gr, gi = replay(y.real.contiguous(), y.imag.contiguous(), C,
                    _tw(tabs, True), inverse=True)
    wr, wi = tfs.cb_multi_plain(Yr, Yi, resps, nfft, tabs)
    assert _rel(gr, wr) <= REL_REPLAY
    assert _rel(gi, wi) <= REL_REPLAY


def _round_trip(xr, xi, resps, nfft: int):
    """Kernels 8 and 9 as run_bccb runs them: pass 1 (replayed), pass 2
    (plain), pass 3 (replayed)."""
    C = nfft // (A * A)
    tabs = tfs._device_tables(nfft, CPU)
    zr, zi = replay(xr, xi, C, _tw(tabs, False), inverse=False)
    return replay(*_cpass(zr, zi, resps, nfft), C, _tw(tabs, True),
                  inverse=True)


@pytest.mark.parametrize("K", [1, 2])
def test_round_trip_matches_jax(K):
    """Kernel 8 (K = 1, ``_stage_bc_cb``) and kernel 9 (K = 2,
    ``_stage_bccb_multi``) on two rows, replayed, against the JAX
    package's Pallas kernels in interpret mode."""
    nfft = SIZES[0]
    xr, xi = _planes(2, nfft, 20 + K)
    resps = _resps(nfft, K, 21 + K)
    gr, gi = _round_trip(xr, xi, resps, nfft)
    jx = (jnp.asarray(xr.numpy()), jnp.asarray(xi.numpy()))
    jr = jnp.asarray(resps.numpy())
    tabs = jfp.plan_params(nfft)
    if K == 1:
        wr, wi = jfp._stage_bc_cb(*jx, nfft, tabs, jr[0], interpret=True)
    else:
        wr, wi = jfp._stage_bccb_multi(*jx, jr, nfft, tabs, interpret=True)
    assert gr.shape == (K * 2, nfft)
    assert _rel(gr, wr) <= REL_STAGE
    assert _rel(gi, wi) <= REL_STAGE
    # and the plain version of the whole round trip
    pr, pi = tfs.bccb_multi_plain(xr, xi, resps, nfft,
                                  tfs._device_tables(nfft, CPU))
    assert _rel(gr, pr) <= REL_REPLAY
    assert _rel(gi, pi) <= REL_REPLAY
