"""The envelope kernels' geometry and their staged block/tile walk, on the
CPU.

- ``scan.scan_geometry`` invariants over a grid of rows, lengths and
  warm-ups, the v2 batch's shapes among them;
- the plain chunked envelope at that geometry against the exact
  recurrence and the JAX package's ``envelope_follower`` (1e-5, the bar of
  tests/test_torch_scan.py: every chunk equals the exact recurrence to
  eps = 1e-8);
- a rehearsal of ``env_staged_kernel`` (csrc/env_staged.cuh), the walk of
  all three envelope kernels: the same blocks, ring slots, loader
  columns, clamps and stored columns, step by step in torch index
  arithmetic with the plain versions' torch arithmetic, so it must equal
  them exactly, and write every position below n once.  With the
  envelope as its epilogue it must equal ``env_scan_plain`` (kernel 2′)
  and, at (W, C, K) = (0, n, 1), ``env_rows_plain`` (kernel 3); with the
  de-esser's (|v| at the scan, the gain map and the ``n_valid`` zeroing at
  the store) ``env_gain_plain`` (kernel 2).  Run with the loaders' work of
  a tile before the scan and after it, so that a slot shared by the two
  would show.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amw_tpu.ops import scan as jscan
from amw_tpu_torch.ops import scan

SR = 44100
H100_SMS = 132
CSRC = (Path(scan.__file__).resolve().parent.parent / "csrc"
        / "env_staged.cuh")


def _kernel_constants() -> dict:
    text = CSRC.read_text()
    return {name: int(val) for name, val in re.findall(
        r"constexpr int (kChunks|kStepTile|kStages|kRowPad|kLoaderSplit) "
        r"= (\d+);", text)}


def _v(rows, n, seed):
    g = np.random.default_rng(seed)
    env = 0.5 + 0.5 * np.abs(np.sin(np.arange(n) / 3000.0))
    return np.abs(g.standard_normal((rows, n)) * env).astype(np.float32)


def test_kernel_constants_match_the_geometry():
    k = _kernel_constants()
    assert k["kChunks"] == scan.SCAN_CHUNKS_PER_BLOCK
    assert k["kStepTile"] == scan.SCAN_TILE
    assert k["kStages"] >= 2 and k["kRowPad"] >= 0 and k["kLoaderSplit"] >= 1


W_SLOW = scan.warmup_len(*scan.ar_coefs(SR, 0.005, 0.1))
W_FAST = scan.warmup_len(*scan.ar_coefs(SR, 0.0005, 0.005))


@pytest.mark.parametrize("rows", [1, 2, 8, 16])
@pytest.mark.parametrize("n", [40_000, 300_000, 1_000_003, 7_938_000])
@pytest.mark.parametrize("w0", [W_FAST, W_SLOW])
def test_scan_geometry_invariants(rows, n, w0):
    T, G = scan.SCAN_TILE, scan.SCAN_CHUNKS_PER_BLOCK
    W, C, K = scan.scan_geometry(rows, n, w0, H100_SMS)
    assert K * C >= n > (K - 1) * C
    if K == 1:
        assert (W, C) == (0, n)
        return
    assert W == w0 and C % T == 0 and w0 + C < n
    if rows * -(-n // T) >= H100_SMS * G:  # the card can be filled
        assert rows * K >= H100_SMS * G


def test_scan_geometry_v2_batch():
    """The 180 s batch's 16 rows: every SM gets one full block, for both of
    the transient designer's followers."""
    rows, n = 16, int(SR * 180)
    for w0 in (W_SLOW, W_FAST):
        W, C, K = scan.scan_geometry(rows, n, w0, H100_SMS)
        assert W == w0 and C % scan.SCAN_TILE == 0
        assert rows * K == H100_SMS * scan.SCAN_CHUNKS_PER_BLOCK
        assert K * C >= n > (K - 1) * C


def test_scan_geometry_one_chunk_when_depth_would_not_drop():
    assert scan.scan_geometry(2, 1000, 5000, H100_SMS) == (0, 1000, 1)
    # the smallest chunk still reaches n: one exact chunk
    n = W_SLOW + scan.SCAN_TILE
    assert scan.scan_geometry(1, n, W_SLOW, H100_SMS) == (0, n, 1)
    W, C, K = scan.scan_geometry(1, n + 1, W_SLOW, H100_SMS)
    assert (W, C, K) == (W_SLOW, scan.SCAN_TILE, -(-(n + 1) // C))


def test_env_scan_plain_at_scan_geometry_matches_exact_and_jax():
    rows, n = 16, 300_000
    att, rel = scan.ar_coefs(SR, 0.005, 0.1)
    W, C, K = scan.scan_geometry(rows, n, W_SLOW, H100_SMS)
    assert W == W_SLOW and K > 1 and C < W  # warm-ups reach back before 0
    v = _v(rows, n, 5)
    got = scan.env_scan_plain(torch.from_numpy(v), W, C, K, att, rel)
    exact = scan.env_rows_plain(torch.from_numpy(v), att, rel)
    assert float((got - exact).abs().max()) <= 1e-5
    want = np.asarray(jscan.envelope_follower(jnp.asarray(v), att, rel))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def rehearse_env_scan(v: torch.Tensor, W: int, C: int, K: int, attack: float,
                      release: float, loaders_first: bool, gain=None):
    """``env_staged_kernel``'s walk over ``v`` [rows, n]: returns the output
    and how often each position was written.  ``gain`` = (n_valid [rows],
    thresh, ratio, floor) selects the de-esser's epilogue (csrc/env_gain.cu:
    the scanning lane reads |v|, the loaders store the gain map, 0 from
    n_valid[row] on); None the envelope's (csrc/env_scan.cu)."""
    k = _kernel_constants()
    G, T, S = k["kChunks"], k["kStepTile"], k["kStages"]
    pad, split = k["kRowPad"], k["kLoaderSplit"]
    rows, n = v.shape
    vflat = v.reshape(-1)
    out = torch.full((rows * n,), float("nan"))
    writes = torch.zeros(rows * n, dtype=torch.int64)
    a = torch.tensor(attack, dtype=torch.float32)
    r = torch.tensor(release, dtype=torch.float32)
    L = W + C
    tiles = -(-L // T)
    q = torch.arange(T)  # the loaders' step columns
    for b in range(-(-rows * K // G)):
        m0 = b * G
        nc = min(G, rows * K - m0)
        m = m0 + torch.arange(nc)
        row = m // K
        row_base = row * n
        win0 = (m - row * K) * C - W
        limit = gain[0][row] if gain is not None else torch.full((nc,), n)
        ring = torch.full((S, G, T + pad), float("nan"))

        # loader thread (j0, q) moves step column q of chunks j0, j0 + split..
        def load_tile(i, j0):
            t = i * T + q
            ok = (t < L) & (i < tiles)
            js = torch.arange(j0, nc, split)
            pos = win0[js, None] + t[None, :]
            src = row_base[js, None] + pos.clamp(0, n - 1)
            val = torch.where(pos < n, vflat[src], torch.zeros(()))
            ring[i % S, j0:nc:split, :T][:, ok] = val[:, ok]

        def store_tile(i, j0):
            t = i * T + q
            js = torch.arange(j0, nc, split)
            pos = win0[js, None] + t[None, :]
            mask = ((t >= W) & (t < L))[None, :] & (pos < n)
            idx = (row_base[js, None] + pos)[mask]
            val = ring[i % S, j0:nc:split, :T][mask]
            if gain is not None:
                keep = (pos < limit[js, None])[mask]
                val = torch.where(keep, scan._gain_map(val, *gain[1:]),
                                  torch.zeros(()))
            out[idx] = val
            writes[idx] += 1

        def loaders(i):
            for j0 in range(split):
                if i > 0:
                    store_tile(i - 1, j0)
                load_tile(i + S - 1, j0)

        for i in range(S - 1):
            for j0 in range(split):
                load_tile(i, j0)
        e = None
        # the scanning lane's input: |v| under the de-esser's epilogue
        inp = torch.abs if gain is not None else torch.clone
        for i in range(tiles + 1):
            if loaders_first:
                loaders(i)
            if i < tiles:
                tr = ring[i % S, :nc]
                if i == 0:
                    e = inp(tr[:, 0])
                up = torch.empty(nc, dtype=torch.bool)
                c = torch.empty(nc)
                d = torch.empty(nc)
                for s in range(min(T, L - i * T)):
                    x = inp(tr[:, s])
                    torch.gt(x, e, out=up)
                    torch.where(up, a, r, out=c)
                    torch.sub(e, x, out=d)
                    e = torch.addcmul(x, c, d)
                    tr[:, s] = e
            if not loaders_first:
                loaders(i)
    return out.reshape(rows, n), writes.reshape(rows, n)


@pytest.mark.parametrize("loaders_first", [False, True])
@pytest.mark.parametrize("rows,n,W,C", [
    (3, 5000, 300, 640),     # n not a multiple of C; one partial block
    (5, 7001, 333, 384),     # 95 chunks: a last block of 31; W % T != 0
    (2, 3000, 0, 512),       # no warm-up
    (3, 700, 0, 700),        # one chunk a row, C not a multiple of T
    (2, 4000, 1000, 256),    # warm-ups reaching back before 0
])
def test_rehearsed_kernel_walk_equals_plain(rows, n, W, C, loaders_first):
    att, rel = scan.ar_coefs(SR, 0.0005, 0.004)
    K = -(-n // C)
    v = torch.from_numpy(_v(rows, n, 6))
    got, writes = rehearse_env_scan(v, W, C, K, att, rel, loaders_first)
    assert torch.equal(writes, torch.ones_like(writes))
    assert torch.equal(got, scan.env_scan_plain(v, W, C, K, att, rel))


def test_rehearsed_kernel_walk_at_scan_geometry():
    """The geometry the card gets, for a short signal on a small card."""
    rows, n = 2, 9000
    att, rel = scan.ar_coefs(SR, 0.0005, 0.004)
    w0 = scan.warmup_len(att, rel)
    W, C, K = scan.scan_geometry(rows, n, w0, 2)
    assert W == w0 and K > 1
    v = torch.from_numpy(_v(rows, n, 7))
    got, writes = rehearse_env_scan(v, W, C, K, att, rel, False)
    assert torch.equal(writes, torch.ones_like(writes))
    assert torch.equal(got, scan.env_scan_plain(v, W, C, K, att, rel))
    assert float((got - scan.env_rows_plain(v, att, rel)).abs().max()) <= 1e-5


GAIN_ARGS = (10 ** (-6.0 / 20), 3.0, 0.35)  # the de-esser's thresh, ratio, floor


def _sidechain(rows, n, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy((0.3 * g.standard_normal((rows, n)))
                            .astype(np.float32))


def _n_valid(rows, n):
    """Whole rows, an empty row, a half row, a row one short, one sample."""
    return torch.tensor([n, 0, n // 2, n - 1, 1] * 2, dtype=torch.int32)[:rows]


@pytest.mark.parametrize("loaders_first", [False, True])
@pytest.mark.parametrize("rows,n,W,C", [
    (3, 5000, 300, 640),     # n not a multiple of C; one partial block
    (5, 7001, 333, 384),     # 95 chunks: a last block of 31; W % T != 0
    (2, 3000, 0, 512),       # no warm-up
    (3, 700, 0, 700),        # one chunk a row, C not a multiple of T
    (2, 4000, 1000, 256),    # warm-ups reaching back before 0
])
def test_rehearsed_gain_walk_equals_plain(rows, n, W, C, loaders_first):
    """Kernel 2's walk: |x| at the scan, the gain map and the n_valid
    zeroing at the store (rows with n_valid = n, 0, n // 2, n - 1, 1)."""
    att, rel = scan.ar_coefs(SR, 0.0005, 0.004)
    K = -(-n // C)
    x = _sidechain(rows, n, 8)
    nv = _n_valid(rows, n)
    got, writes = rehearse_env_scan(x, W, C, K, att, rel, loaders_first,
                                    gain=(nv, *GAIN_ARGS))
    assert torch.equal(writes, torch.ones_like(writes))
    want = scan.env_gain_plain(x, nv, W, C, K, att, rel, *GAIN_ARGS)
    assert torch.equal(got, want)
    assert float(got[1].abs().max()) == 0.0  # the row with n_valid = 0


def test_rehearsed_gain_walk_at_scan_geometry():
    """Kernel 2 at the geometry the card gets (a small card), warm-ups
    reaching back before 0, padded rows."""
    rows, n = 2, 9000
    att, rel = scan.ar_coefs(SR, 0.0005, 0.004)
    w0 = scan.warmup_len(att, rel)
    W, C, K = scan.scan_geometry(rows, n, w0, 2)
    assert W == w0 and K > 1 and C < W
    x = _sidechain(rows, n, 9)
    nv = torch.tensor([n, 6000], dtype=torch.int32)
    got, writes = rehearse_env_scan(x, W, C, K, att, rel, False,
                                    gain=(nv, *GAIN_ARGS))
    assert torch.equal(writes, torch.ones_like(writes))
    assert torch.equal(got, scan.env_gain_plain(x, nv, W, C, K, att, rel,
                                                *GAIN_ARGS))


@pytest.mark.parametrize("rows,n", [
    (2, 1000),   # the clip's two rows in one block
    (33, 300),   # two blocks, the second of one row
    (3, 701),    # n not a multiple of the tile
])
def test_rehearsed_row_walk_equals_plain(rows, n):
    """Kernel 3 is the walk at (W, C, K) = (0, n, 1): the exact recurrence
    along each row, env[0] = v[0]."""
    att, rel = scan.ar_coefs(SR, 0.005, 0.1)
    v = torch.from_numpy(_v(rows, n, 10))
    got, writes = rehearse_env_scan(v, 0, n, 1, att, rel, True)
    assert torch.equal(writes, torch.ones_like(writes))
    assert torch.equal(got, scan.env_rows_plain(v, att, rel))
    assert torch.equal(got[:, 0], v[:, 0])
