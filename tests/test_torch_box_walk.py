"""A CPU rehearsal of the box smoother's kernel (``csrc/box_smooth.cu``).

The replay takes the kernel's steps in numpy float32, with nothing taken
from the kernel but the constants its source declares (block, strip,
first-level width, the widths it walks in registers): the tiles of
``kBoxThreads * kBoxStrip`` outputs, each staged from ``box_lead(k)``
samples before its first output with zeros outside the row; for the
walked widths each thread's strip of ``kBoxStrip`` outputs read once in
order, the rolling eight samples, each s8 formed afresh and added to the
strip's outputs it belongs to, the remainder taps as their samples
arrive; for any other width the tile's s8 sums, then each output's b
sums and r taps.  Both are held bit for bit (``assert_array_equal``)
against ``box_smooth_plain``, which the card check holds the kernel to
exactly: a replay that adds in another order would differ in the last
bits.  The walk is also replayed at every width of at least 16, since the
kernel's template takes any.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from amw_tpu_torch.ops import fdfilter as tfd

CSRC = Path(tfd.__file__).resolve().parent.parent / "csrc"
THREADS, STRIP, A = 128, 32, 8
TILE = THREADS * STRIP
WALKED = (67, 73)
WIDTHS = (1, 2, 7, 15, 16, 17, 67, 73, 101)
# (rows, n): ragged against the tile, a row shorter than the tile, rows
# shorter than most widths
SHAPES = ((2, 2 * TILE + 1234), (3, 1000), (2, 50), (1, 10))


def _source() -> str:
    return (CSRC / "box_smooth.cu").read_text()


def test_source_constants_match_the_replay():
    consts = {name: int(val) for name, val in re.findall(
        r"constexpr int (kBox\w+) = (\d+);", _source())}
    assert consts == {"kBoxThreads": THREADS, "kBoxStrip": STRIP,
                      "kBoxA": A}
    walked = tuple(sorted(int(k) for k in re.findall(r"launch_walk<(\d+)>\(",
                                                      _source())))
    assert walked == WALKED


def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def _staged(x: np.ndarray, k: int, tile: int, length: int) -> np.ndarray:
    """[R, tiles, length]: tile T's samples x[:, T * tile - lead + m],
    zero outside the row."""
    R, n = x.shape
    lead = _round4(k // 2)
    nt = -(-n // tile)
    xz = np.zeros((R, lead + nt * tile + length), np.float32)
    xz[:, lead:lead + n] = x
    idx = np.arange(nt)[:, None] * tile + np.arange(length)[None, :]
    return xz[:, idx]


def walk_replay(x: np.ndarray, k: int, strip: int = STRIP) -> np.ndarray:
    """box_walk_kernel<k, strip>: each thread's strip in registers."""
    R, n = x.shape
    tile = THREADS * strip
    b, r = k // A, k % A
    assert b >= 2
    off = _round4(k // 2) - k // 2
    span = strip + k - 1
    st = _staged(x, k, tile, _round4(tile + off + k - 1))
    nt = st.shape[1]
    # samples[..., thread, i] = staged[thread * strip + off + i]
    idx = (np.arange(THREADS)[:, None] * strip + off
           + np.arange(span)[None, :])
    samples = st[:, :, idx]
    acc = [None] * strip
    v = [None] * A
    for i in range(span):
        v[i % A] = samples[..., i]
        if i >= A - 1:
            q = i - (A - 1)
            s8 = v[q % A]
            for c in range(1, A):
                s8 = s8 + v[(q + c) % A]
            for j in range(b):
                p = q - A * j
                if 0 <= p < strip:
                    acc[p] = s8 if j == 0 else acc[p] + s8
        for rho in range(r):
            p = i - A * b - rho
            if 0 <= p < strip:
                acc[p] = acc[p] + v[i % A]
    out = np.stack(acc, axis=-1) * np.float32(1.0 / k)  # [R, nt, T, strip]
    return out.reshape(R, nt * tile)[:, :n]


def generic_replay(x: np.ndarray, k: int) -> np.ndarray:
    """box_generic_kernel: the tile's s8 sums, then one output a thread."""
    R, n = x.shape
    b = k // A
    off = _round4(k // 2) - k // 2
    wo = _staged(x, k, TILE, _round4(TILE + off + k - 1))[..., off:]
    if b >= 2:
        ns = TILE + A * (b - 1)
        s8 = wo[..., 0:ns]
        for c in range(1, A):
            s8 = s8 + wo[..., c:c + ns]
        acc = s8[..., 0:TILE]
        for j in range(1, b):
            acc = acc + s8[..., A * j:A * j + TILE]
        tap = A * b
    else:
        acc = wo[..., 0:TILE]
        tap = 1
    for s in range(tap, k):
        acc = acc + wo[..., s:s + TILE]
    out = acc * np.float32(1.0 / k)
    return out.reshape(R, -1)[:, :n]


def kernel_replay(x: np.ndarray, k: int) -> np.ndarray:
    """What amw_box_smooth launches for width k."""
    return walk_replay(x, k) if k in WALKED else generic_replay(x, k)


def _rows(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("k", WIDTHS)
def test_kernel_replay_equals_plain_exactly(k, shape):
    x = _rows(shape, seed=k)
    want = tfd.box_smooth_plain(torch.from_numpy(x), k).numpy()
    np.testing.assert_array_equal(kernel_replay(x, k), want)


@pytest.mark.parametrize("k", [k for k in WIDTHS if k >= 2 * A])
def test_walk_replay_equals_plain_at_any_width(k):
    """The walk's template at widths the kernel sends to the generic
    path, and at strips of 8 and 64."""
    x = _rows((2, TILE + 777), seed=100 + k)
    want = tfd.box_smooth_plain(torch.from_numpy(x), k).numpy()
    for strip in (8, STRIP, 64):
        np.testing.assert_array_equal(walk_replay(x, k, strip), want)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", WIDTHS)
def test_box_kernel_equals_plain_on_card(cuda_device, k):
    """The kernel itself, at the 5 s batch's [16, 220 500] and on one
    ragged row (n odd: the 4-byte staging), exactly equal."""
    for R, n in ((16, 220_500), (1, 2 * TILE + 1233)):
        x = torch.from_numpy(_rows((R, n), seed=k)).to(cuda_device)
        got = tfd.box_smooth_cuda(x, k)
        want = tfd.box_smooth_plain(x, k)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (k, R, n)
