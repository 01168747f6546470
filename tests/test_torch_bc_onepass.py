"""A CPU rehearsal of kernel 6's one pass (``csrc/fft_split.cu``
``bc_onepass_kernel``, the split route's forward B+C, ``amw_fft_bc``).

The replay takes the kernel's partition in torch, with nothing taken from
the kernel but its cluster sizes (``kBcClusterQ``, read from the source):
the Q blocks of matrix m's cluster, block ``rank``'s column slice
``[rank · C/Q, (rank + 1) · C/Q)`` in strips of 32, each strip's forward B
transform as the register B pass computes it (``replay`` of
tests/test_torch_bpass_factored.py: thread (g, t)'s loads, the 16-point
DFTs, the exchange, the 8-point DFTs, T2 on the output rows), the push of
each output row b' into the tile of its owner ``b' // (128/Q)`` (every
tile element written once, before the barrier), then the C pass of each
block over its own rows (warp w: rows w, w + 8, ...) into the stored
spectrum, every C-row once.

Held against ``fft_staged.bc_plain`` at 1e-6 relative to the largest
magnitude (the B pass's replay bar), at C = 32, 128, 256, 512 and 1024
(nfft 2^19, 2^21 .. 2^24) with the Q the source picks for each, and
``bc_plain`` against the JAX package's ``_stage_bc`` in interpret mode at
the same plans at 3e-6, the bar of tests/test_torch_fft_split.py.  The
source tests check that the split stages no longer run ``fft128.cuh``.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amw_tpu.ops import fft_pallas as jfp
from amw_tpu_torch.ops import fft_staged as tfs
from test_torch_bpass_factored import (A, COLS, G, REL_REPLAY, REL_STAGE,
                                       _planes, _rel, _tw, replay)

CSRC = Path(tfs.__file__).resolve().parent.parent / "csrc"
CPU = torch.device("cpu")
# (nfft, rows): C = 32 (two rows), 128, 256, 512, 1024 (one row each)
PLANS = [(1 << 19, 2), (1 << 21, 1), (1 << 22, 1), (1 << 23, 1),
         (1 << 24, 1)]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Many small ops: one intra-op thread keeps them from spinning against
    the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _code(name: str) -> str:
    """A source without its comment lines."""
    return "\n".join(line for line in (CSRC / name).read_text().splitlines()
                     if not line.lstrip().startswith("//"))


def cluster_q() -> dict:
    """kBcClusterQ of fft_split.cu: the cluster size by C."""
    m = re.search(r"constexpr int kBcClusterQ\[6\] = \{([\d, ]+)\};",
                  _code("fft_split.cu"))
    qs = [int(v) for v in m.group(1).split(",")]
    return {32 << i: q for i, q in enumerate(qs)}


def _body(code: str, name: str) -> str:
    """The text of function ``name`` of ``code``, to its closing brace."""
    start = re.search(rf"\n\w[\w:<>, ]* {name}\(", code).start()
    end = code.index("\n}\n", start)
    return code[start:end]


def test_cluster_sizes_fit():
    """Every C has a cluster size: portable (at most 8), a whole number of
    strips and of warps' rows a block, and a tile of at most 128 KB a
    block (the exchange, W_128 and C-pass tables beside it under 227 KB)."""
    qs = cluster_q()
    assert sorted(qs) == [32, 64, 128, 256, 512, 1024]
    for C, Q in qs.items():
        assert 1 <= Q <= 8 and C // COLS % Q == 0 and (A // Q) % G == 0
        tile = 2 * (A // Q) * C * 4
        assert tile <= 128 * 1024
        assert tile + 8 * C + 32 * 1024 + 8 * 1024 <= 227 * 1024
    # Q = C / 64 where that keeps two blocks an SM, within the portable 8
    assert [qs[C] for C in (128, 256, 512)] == [2, 4, 8]


def test_split_stages_run_no_fft128():
    """kernels 6, 7 and 10 run the register B transform: fft_split.cu
    includes fft_breg.cuh and names neither fft128.cuh nor
    col_dft128_kernel."""
    code = _code("fft_split.cu")
    assert '#include "fft_breg.cuh"' in code
    assert "fft128.cuh" not in code and "col_dft128_kernel" not in code


@pytest.mark.parametrize("source,function,launches", [
    # kernel 6: one launch, the one pass on a cluster
    ("fft_split.cu", "run_bc", [r"launch_bc_onepass<kLogC, "
                                r"bc_cluster_q\(kLogC\)>\(\s*xr, xi, t2r, "
                                r"t2i, out_r, out_i, R, st\)"]),
    # kernels 7 and 10: the C pass, then the inverse register B pass in
    # place on the outputs
    ("fft_split.cu", "run_cb", [r"launch_c_pass\(cstage_inv_kernel<kLogC, "
                                r"true>", r"launch_c_pass\(cstage_inv_"
                                r"kernel<kLogC, false>",
                                r"launch_b_pass\(true, out_r, "
                                r"out_i, it2r, it2i, out_r,\s+out_i, "
                                r"K \* mats, C, st\)"]),
    # kernels 8 and 9, unchanged: forward B pass, C pass, inverse B pass
    ("fft_bccb.cu", "run_bccb", [r"launch_b_pass\(false, xr, xi, t2r, t2i, "
                                 r"zr, zi, mats, C, st\)",
                                 r"launch_c_pass\(cstage_multi_kernel<",
                                 r"launch_b_pass\(true, out_r, out_i, it2r, "
                                 r"it2i, out_r,\s+out_i, K \* mats, C, st\)"]),
])
def test_stage_launches(source, function, launches):
    body = _body(_code(source), function)
    for pat in launches:
        assert len(re.findall(pat, body)) == 1, (function, pat)
    kernels = re.findall(r"launch_\w+|<<<|cudaLaunchKernelEx", body)
    assert len(kernels) == len(launches), kernels


def test_one_pass_launches_one_cluster_a_matrix():
    """The one pass's launch: R * 128 * Q blocks of 256 threads, the
    cluster size Q by attribute where Q > 1, the tile and the C-pass table
    as dynamic shared memory; a start barrier of the cluster (relaxed
    arrive once the loads are out, wait) before the first push through
    map_shared_rank, then one cluster barrier before the C pass."""
    code = _code("fft_split.cu")
    cfg = _body(code, "bc_onepass_config")
    assert "static_cast<unsigned>(R) * kAregRows * kQ" in cfg
    assert "cudaLaunchAttributeClusterDimension" in cfg
    assert "clusterDim.x = kQ" in cfg
    kernel = code[code.index("bc_onepass_kernel(const float*"):]
    kernel = kernel[:kernel.index("\n}\n")]
    assert kernel.count("map_shared_rank(") == 2
    assert kernel.count("cg::this_cluster().sync()") == 1
    # every block of the cluster started before the first push
    assert "barrier.cluster.arrive.relaxed" in code
    assert "barrier.cluster.wait" in code
    assert kernel.count("cluster_arrive_relaxed()") == 1
    assert kernel.count("cluster_wait()") == 1
    assert (kernel.rindex("breg_load(") < kernel.index("cluster_arrive")
            < kernel.index("cluster_wait()") < kernel.index("breg_strip<")
            < kernel.index("map_shared_rank("))
    # every push is before the barrier, every C-row read after it
    assert kernel.index("map_shared_rank(") < kernel.index(".sync()")
    assert kernel.index(".sync()") < kernel.index("creg_forward<")


def replay_one_pass(xr, xi, nfft: int, Q: int, tables):
    """Kernel 6's one pass on planes ``[R, nfft]``: per cluster rank its
    strips' B transform (replayed), the push of each output row to its
    owner's tile, then each rank's C pass over its own rows → the stored
    spectrum's planes."""
    C = nfft // (A * A)
    R = xr.shape[0]
    M = R * A  # matrices, one cluster each
    rows = A // Q  # tile rows a block
    strips = C // COLS // Q
    X = torch.complex(xr, xi).reshape(M, A, C)
    t2 = _tw(tables, False).reshape(A, C)
    tiles = torch.full((Q, M, rows, C), complex("nan"), dtype=torch.complex64)
    hits = torch.zeros((Q, M, rows, C), dtype=torch.int32)
    remote = 0
    for rank in range(Q):
        for s in range(strips):
            col0 = (rank * strips + s) * COLS
            cols = slice(col0, col0 + COLS)
            sub = X[:, :, cols].contiguous()
            zr, zi = replay(sub.real.contiguous(), sub.imag.contiguous(),
                            COLS, t2[:, cols].reshape(-1), inverse=False)
            Z = torch.complex(zr, zi).reshape(M, A, COLS)
            for b in range(A):  # row b' of the strip → its owner's tile
                owner = b // rows
                tiles[owner, :, b % rows, cols] = Z[:, b]
                hits[owner, :, b % rows, cols] += 1
                remote += owner != rank
    assert bool((hits == 1).all()), "a tile element pushed twice or never"
    if Q > 1:  # all but a block's own rows go to peers
        assert remote == strips * Q * A * (Q - 1) // Q
    out = torch.full((M, A, C), complex("nan"), dtype=torch.complex64)
    done = torch.zeros((M, A), dtype=torch.int32)
    for rank in range(Q):
        for w in range(G):  # warp w: the block's rows w, w + 8, ...
            lr = torch.arange(w, rows, G)
            y = tfs._cstage_fwd(tiles[rank][:, lr], nfft)
            out[:, rank * rows + lr] = y
            done[:, rank * rows + lr] += 1
    assert bool((done == 1).all()), "a C-row stored twice or never"
    out = out.reshape(R, nfft)
    return out.real.contiguous(), out.imag.contiguous()


@pytest.mark.parametrize("nfft,rows", PLANS)
def test_one_pass_replay_matches_bc_plain_and_jax(nfft, rows):
    C = nfft // (A * A)
    Q = cluster_q()[C]
    tabs = tfs._device_tables(nfft, CPU)
    xr, xi = _planes(rows, nfft, 60 + C)
    gr, gi = replay_one_pass(xr, xi, nfft, Q, tabs)
    wr, wi = tfs.bc_plain(xr, xi, nfft, tabs)
    assert _rel(gr, wr) <= REL_REPLAY
    assert _rel(gi, wi) <= REL_REPLAY
    del gr, gi
    jr, ji = jfp._stage_bc(jnp.asarray(xr.numpy()), jnp.asarray(xi.numpy()),
                           nfft, jfp.plan_params(nfft), interpret=True)
    assert _rel(wr, jr) <= REL_STAGE
    assert _rel(wi, ji) <= REL_STAGE
