"""The port's v2 mastering job on the staged FFT against the JAX package's
on its Pallas FFT, both forced on the CPU, as a bucket-padded batch of two
tracks with per-track valid lengths (the JAX graph under ``vmap``).  The
route and the bars are tests/test_torch_v2_staged.py's.
"""

import test_torch_v2_job as v2
from test_torch_v2_staged import N_STAGED, staged_route  # noqa: F401

NVS = [N_STAGED, 411_000]


def test_staged_padded_batch_matches_jax(staged_route):  # noqa: F811
    want, got, x = v2.run_pair(N_STAGED, NVS, 12)
    assert len(staged_route) == 10
    v2.assert_parity(want, got, x, NVS)
