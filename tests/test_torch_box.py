"""The port's box smoother against the JAX package's Pallas halo kernel.

``amw_tpu_torch.ops.fdfilter.box_smooth_same`` runs the CUDA kernel on a
GPU tensor and its plain PyTorch version on a CPU tensor; both are held
against ``amw_tpu.ops.fdfilter._box_pallas`` (interpret mode) and the JAX
shift-add at atol 3e-5 (XLA may fuse the shifted adds in another order);
on the card the kernel equals the plain version exactly.
"""

import functools
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from amw_tpu.ops import fdfilter as jfd
from amw_tpu_torch.ops import fdfilter as tfd


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rows(shape, seed=3):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def test_box_plain_matches_pallas_interpret():
    k = 67
    x = _rows((16, 50000))
    orig = pl.pallas_call
    with mock.patch.object(pl, "pallas_call",
                           functools.partial(orig, interpret=True)):
        want = np.asarray(jfd._box_pallas(jnp.asarray(x), k))
    plain = tfd.box_smooth_plain(torch.from_numpy(x), k).numpy()
    same = tfd.box_smooth_same(torch.from_numpy(x), k).numpy()
    np.testing.assert_allclose(plain, want, atol=3e-5)
    np.testing.assert_allclose(same, want, atol=3e-5)


@pytest.mark.parametrize("k,n", [(1, 500), (67, 50), (101, 101), (9, 7)])
def test_box_edge_widths_match_jax(k, n):
    """k = 1 is the identity; k >= n (and k close to n) reads zeros past
    both ends, like the JAX shift-add."""
    x = _rows((3, n), seed=8)
    want = np.asarray(jfd.box_smooth_same(jnp.asarray(x), k))
    got = tfd.box_smooth_same(torch.from_numpy(x), k).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5)
    if k == 1:
        np.testing.assert_array_equal(got, x)


def test_box_batched_leading_axes():
    """Leading axes fold into rows: [B, C, n] equals row by row."""
    x = _rows((2, 3, 4000), seed=5)
    got = tfd.box_smooth_same(torch.from_numpy(x), 67).numpy()
    want = tfd.box_smooth_plain(torch.from_numpy(x.reshape(6, 4000)),
                                67).numpy()
    np.testing.assert_array_equal(got, want.reshape(2, 3, 4000))


@pytest.mark.cuda
def test_box_cuda_kernel_matches_plain(cuda_device):
    """The kernel adds in the plain version's order: exactly equal."""
    for R, n, k in ((16, 220500, 67), (1, 5000, 3), (2, 40, 145)):
        x = torch.from_numpy(_rows((R, n))).to(cuda_device)
        before = tfd.box_smooth_cuda.launches
        got = tfd.box_smooth_same(x, k)
        torch.cuda.synchronize()
        assert tfd.box_smooth_cuda.launches == before + 1
        want = tfd.box_smooth_plain(x, k)
        assert torch.equal(got, want)
