"""A CPU rehearsal of the reduce kernels 11 and 12 (``csrc/fft_reduce.cu``
on the transform of ``csrc/fft_areg.cuh``).

The replay takes the kernel's steps in torch index arithmetic, with
nothing taken from the kernel but the constants its header declares
(checked against the replay's own): the grid of blocks (row
``b % R``, strip ``32 · (b // R)``), thread (g, t)'s rows ``g + 8 i`` of
its column, t1 times the power-of-two scale read once, the 16-point DFT
over i (radix 4 × 4 with the header's W_16 constants), the twiddle
W_128^(g·k1), the exchange ``ex[k1][g][t]``, warp w's 8-point DFTs over g
for ``k1 = w + 8 h`` (radix 4 × 2), their output rows ``k1 + 16 k2 =
w + 8 (2 k2 + h)``, the band maps read from ``band_table``'s rows in the
kernel's operations (modes 2 and 3 times 1 / ratio), the band sums and
the stores, each position once.

Held against the plain versions (``reduce_packed_plain``, ``reduce_plain``)
at 1e-6 relative with maps that pass the samples unchanged (the transform
and the index arithmetic); with the band maps against the plain versions
and the JAX package's Pallas kernels (``_reduce_stage_a_packed``,
``_reduce_stage_a``, interpret mode) at ``REL_REDUCE`` = 1e-5, the bar of
tests/test_torch_fft.py, and no less accurate than the plain version
against a float64 reduce.  The spectra are those of signals at mastering
levels through the forward stages and K band responses, so every branch
of every map mode runs.  The replay with the plain version's division
instead of the reciprocal bounds what the reciprocal costs.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amw_tpu.ops import basic as jbasic
from amw_tpu.ops import fft_pallas as jfp
from amw_tpu_torch.ops import fft_staged as tfs
from amw_tpu_torch.ops.bands import BandMap

CSRC = Path(tfs.__file__).resolve().parent.parent / "csrc"
CPU = torch.device("cpu")
A, COLS, G, I = 128, 32, 8, 16  # rows, strip width, warps, rows a thread
REL_REPLAY = 1e-6
REL_REDUCE = 1e-5
# one band per branch of compress_soft_knee: bypass (ratio 1), soft knee,
# upward boost (ratio < 1), hard knee (knee < 0.5 dB)
BANDS = [(-7.2, 1.0, 6.0, 12.0, -7.2, 1.5), (-18.5, 2.2, 6.0, 12.0, -18.5, 1.8),
         (-17.0, 0.6, 6.0, 12.0, -17.0, 1.65), (-15.0, 1.35, 0.2, 12.0, -15.0, 1.2)]
NFFT = 1 << 19


def _header_constants() -> dict:
    text = (CSRC / "fft_areg.cuh").read_text()
    return {name: int(val) for name, val in re.findall(
        r"constexpr int (kAreg\w+) = (\d+);", text)}


def test_header_constants_match_the_replay():
    assert _header_constants() == {"kAregRows": A, "kAregCols": COLS,
                                   "kAregG": G, "kAregI": I}
    text = (CSRC / "fft_areg.cuh").read_text()
    # the W_16 literals of areg_cos16: cos(2 pi q / 16), q = 1..3
    lits = [float(v) for v in re.findall(r"q == \d \? ([\d.]+)f", text)]
    np.testing.assert_allclose(lits,
                               np.cos(2 * np.pi * np.arange(1, 4) / 16),
                               rtol=1e-15)


def _w16(m: int) -> torch.Tensor:
    return torch.tensor(np.exp(2j * np.pi * (m % 16) / 16),
                        dtype=torch.complex64)


def _idft(x: list, n: int) -> list:
    """areg_idft: inverse n-point DFT over the list, n = P·Q, n = n1 + P n2,
    k = k1 + Q k2 (16 = 4 × 4, 8 = 2 × 4)."""
    if n == 2:
        return [x[0] + x[1], x[0] - x[1]]
    if n == 4:
        t0, t1 = x[0] + x[2], x[0] - x[2]
        t2, t3 = x[1] + x[3], x[1] - x[3]
        return [t0 + t2, t1 + 1j * t3, t0 - t2, t1 - 1j * t3]
    p = 2 if n == 8 else 4
    q = n // p
    b = []
    for n1 in range(p):
        a = _idft([x[n1 + p * n2] for n2 in range(q)], q)
        b.append([a[k1] * _w16(n1 * k1 * (16 // n)) if n1 * k1 else a[k1]
                  for k1 in range(q)])
    out = [None] * n
    for k1 in range(q):
        c = _idft([b[n1][k1] for n1 in range(p)], p)
        for k2 in range(p):
            out[k1 + q * k2] = c[k2]
    return out


def _band_map(x: torch.Tensor, row, reciprocal: bool) -> torch.Tensor:
    """The kernel's map of one band's table row on f32 samples."""
    p = [np.float32(v) for v in row]
    mode = int(p[0])
    y = x
    if mode != 0:
        ax = x.abs()
        if mode == 1:
            level = torch.where(ax > 1e-12,
                                20.0 * torch.log10(ax.clamp(min=1e-12)),
                                torch.full_like(ax, -100.0))
            boost = ((p[1] - level) * p[2]).clamp(min=0.0).clamp(max=p[3])
            oa = (ax * torch.pow(10.0, boost / 20.0)).clamp(0.0, 1.0)
        else:
            inv = np.float32(1.0) / p[2]

            def over(d):
                return d * inv if reciprocal else d / p[2]

            if mode == 2:
                oa = torch.minimum(ax, p[1] + over((ax - p[1]).clamp(min=0)))
            else:
                knee = p[3] + (ax - p[3]) * p[5]
                above = p[1] + over(ax - p[1])
                oa = torch.where(ax <= p[3], ax,
                                 torch.where(ax >= p[4], above, knee))
                oa = oa.clamp(min=0.0)
        y = torch.where(x > 0, oa,
                        torch.where(x < 0, -oa, torch.zeros_like(x)))
    return y.clamp(-p[6], p[6]) * p[7]


def replay(Yr, Yi, K: int, R: int, nfft: int, rows, tables, packed: bool,
           reciprocal: bool = True):
    """The kernel's blocks, threads and steps, all blocks and lanes at once:
    ``[K·R, nfft]`` planes → ``[2·R, nfft]`` (packed) or ``[R, nfft]``."""
    S = nfft // A
    nb = R * (S // COLS)
    blk = torch.arange(nb)
    r = blk % R
    col0 = (blk // R) * COLS
    t = torch.arange(COLS)
    t1r, t1i = tfs._tabs(tables, True)[:2]
    scale = np.float32(1.0 / nfft)  # a power of two: exact products
    t1 = torch.complex(t1r * scale, t1i * scale)
    w128 = torch.tensor(np.exp(2j * np.pi * np.arange(A) / A),
                        dtype=torch.complex64)
    Y = torch.complex(Yr, Yi)

    def pos(g, i):  # [nb, 32]: row g + 8 i of every block's columns
        return ((g + G * i) * S + col0)[:, None] + t[None, :]

    acc = torch.zeros(nb, COLS, A, dtype=torch.complex64)  # [.., row]
    for k in range(K):
        row = (k * R + r)[:, None]
        ex = {}
        for g in range(G):
            x = [Y[row, pos(g, i)] * t1.reshape(-1)[pos(g, i)]
                 for i in range(I)]
            u = _idft(x, I)
            for k1 in range(I):
                ex[k1, g] = u[k1] * w128[g * k1] if k1 else u[k1]
        for w in range(G):
            for h in range(2):
                z = _idft([ex[w + G * h, g] for g in range(G)], G)
                for k2 in range(G):
                    j = 2 * k2 + h
                    a = w + G * j  # row k1 + 16 k2
                    mr = _band_map(z[k2].real, rows[k], reciprocal)
                    mi = (_band_map(z[k2].imag, rows[k], reciprocal)
                          if packed else torch.zeros_like(mr))
                    acc[:, :, a] += torch.complex(mr, mi)
    out = torch.full((2 * R if packed else R, nfft), float("nan"))
    hits = torch.zeros(out.shape, dtype=torch.int32)
    for w in range(G):
        for j in range(I):
            p = pos(w, j)
            out[r[:, None], p] = acc[:, :, w + G * j].real
            hits[r[:, None], p] += 1
            if packed:
                out[(R + r)[:, None], p] = acc[:, :, w + G * j].imag
                hits[(R + r)[:, None], p] += 1
    assert bool((hits == 1).all()), "a position stored twice or never"
    return out


def _spectra(K: int, R: int, seed: int, packed: bool):
    """``[K·R, nfft]`` planes: signals at 0.3 RMS through the forward
    stages and K band responses (the plain versions)."""
    g = np.random.default_rng(seed)
    rows = 2 * R if packed else R
    x = torch.from_numpy((0.3 * g.standard_normal((rows, NFFT - 3000)))
                         .astype(np.float32))
    H = [g.random(NFFT // 2 + 1) + 0.25 for _ in range(K)]
    resps = torch.from_numpy(np.stack([tfs.permute_full_response(h, NFFT)
                                       for h in H]))
    tabs = tfs._device_tables(NFFT, CPU)
    if packed:
        xr, xi = tfs.stage_a_plain(x[:R], x[R:], NFFT, False, tabs)
    else:
        xr, xi = tfs.stage_a_plain(x, None, NFFT, False, tabs, real_in=True)
    return tfs.bccb_multi_plain(xr, xi, resps, NFFT, tabs)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


def _jax_map(thr, ratio, knee, boost, lim, gain):
    return lambda y: jbasic.limiter(
        jbasic.compress_soft_knee(y, thr, ratio, knee, boost), lim) * gain


def _f64_reduce(Yr, Yi, K: int, R: int, maps, packed: bool):
    """The reduce in float64 (the DFT matrix, t1 and the maps): the truth
    the replay and the plain version are both measured against."""
    S = NFFT // A
    a = np.arange(A)
    t1 = torch.from_numpy(np.exp(2j * np.pi * a[:, None] * np.arange(S)
                                 / NFFT))
    wa = torch.from_numpy(np.exp(2j * np.pi * np.outer(a, a) / A))
    y = torch.complex(Yr.double(), Yi.double()).reshape(K, R, A, S)
    y = (torch.matmul(wa, y * t1) / NFFT).reshape(K, R, NFFT)
    acc = sum(maps[k](y[k].real) for k in range(K))
    if packed:
        acc = torch.cat([acc, sum(maps[k](y[k].imag) for k in range(K))])
    return acc


def _case(packed: bool, R: int, bands):
    K = len(bands)
    Yr, Yi = _spectra(K, R, 7 + R + K, packed)
    maps = [BandMap(*b) for b in bands]
    rows = tfs.band_table(maps, CPU).tolist()
    tabs = tfs._device_tables(NFFT, CPU)
    plain = (tfs.reduce_packed_plain if packed else tfs.reduce_plain)(
        Yr, Yi, K, R, NFFT, maps, tabs)
    return Yr, Yi, K, maps, rows, tabs, plain


@pytest.mark.parametrize("packed,R", [(True, 2), (False, 3)])
def test_replay_transform_matches_plain(packed, R):
    """The transform and the index arithmetic at 1e-6: four bands whose
    maps pass the samples unchanged (bypass, limit +20 dB, gain 1)."""
    Yr, Yi, K, _, rows, tabs, plain = _case(
        packed, R, [(-7.2, 1.0, 6.0, 12.0, 20.0, 1.0)] * 4)
    got = replay(Yr, Yi, K, R, NFFT, rows, tabs, packed)
    assert got.shape == plain.shape
    assert _rel(got, plain) <= REL_REPLAY


@pytest.mark.parametrize("packed,R,K", [(True, 2, 4), (False, 3, 4),
                                        (True, 1, 1), (True, 1, 2)])
def test_replay_matches_plain_and_jax(packed, R, K):
    """Kernel 11 (packed, R2 rows) and kernel 12 (unpacked, 3 mono rows)
    with one band per map mode (K = 4; K = 1 and 2 run the band loop's
    first and last exchange buffers).  The maps compress and clip, so the
    output's largest magnitude is smaller than the bands' and each f32
    reduce errs by more than 1e-6 of it: the replay is held against the
    plain version and the JAX kernel at REL_REDUCE, and must be no less
    accurate than the plain version against the float64 reduce."""
    bands = BANDS[:K] if K > 2 else BANDS[1::-1][:K]
    Yr, Yi, K, maps, rows, tabs, plain = _case(packed, R, bands)
    got = replay(Yr, Yi, K, R, NFFT, rows, tabs, packed)
    assert got.shape == plain.shape
    assert _rel(got, plain) <= REL_REDUCE
    truth = _f64_reduce(Yr, Yi, K, R, maps, packed)
    assert _rel(got, truth) <= _rel(plain, truth)
    jmaps = [_jax_map(*b) for b in bands]
    jY = (jnp.asarray(Yr.numpy()), jnp.asarray(Yi.numpy()))
    if packed:
        want = jfp._reduce_stage_a_packed(*jY, K, R, NFFT, jmaps,
                                          jfp.plan_params(NFFT),
                                          interpret=True)
    else:
        want = jfp._reduce_stage_a(*jY, K, R, NFFT, jmaps,
                                   jfp.plan_params(NFFT), interpret=True)
    assert _rel(got, want) <= REL_REDUCE


def test_reciprocal_costs_under_1e6():
    """What 1 / ratio costs against the plain version's division, on a
    soft and a hard knee whose limits (-1 dB) let the compressed samples
    through (in the standard config each band's limit is its threshold,
    which clips every sample the quotient reaches)."""
    bands = [(-18.5, 2.2, 6.0, 12.0, -1.0, 1.0),
             (-15.0, 1.35, 0.2, 12.0, -1.0, 1.0)]
    Yr, Yi, K, maps, rows, tabs, plain = _case(True, 1, bands)
    got = replay(Yr, Yi, K, 1, NFFT, rows, tabs, True)
    div = replay(Yr, Yi, K, 1, NFFT, rows, tabs, True, reciprocal=False)
    assert 0.0 < _rel(got, div) <= REL_REPLAY
    truth = _f64_reduce(Yr, Yi, K, 1, maps, True)
    assert _rel(got, truth) <= _rel(plain, truth)
