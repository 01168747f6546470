"""The traffic generator's valid lengths: drawn from the seed at sample
resolution on the traffic's range, the same audio seconds in every batch
and for every seed."""

import json

import numpy as np
import pytest

from portbench import generator
from portbench.manifest import ROOT

SR = 44100
TRAFFIC = json.loads((ROOT / "portbench/traffic/batch8.json").read_text())


def pool_lengths(seed, traffic=TRAFFIC, pool=4):
    g = np.random.default_rng(seed)
    return np.stack([generator.valid_lengths(traffic, SR, g)
                     for _ in range(pool)])


@pytest.mark.parametrize("seed", [1, 2 ** 31 + 1234567, 3_700_000_011])
def test_lengths_on_the_range_with_a_fixed_sum(seed):
    nv = pool_lengths(seed)
    lo, hi = (round(v * SR) for v in TRAFFIC["valid_s"])
    assert nv.dtype == np.int64 and nv.shape == (4, TRAFFIC["batch"])
    assert np.all(nv > lo) and np.all(nv <= hi)
    assert np.all(nv.sum(axis=1) == TRAFFIC["batch"] * (lo + (hi - lo) // 2))
    assert len(np.unique(nv)) == nv.size


def test_lengths_follow_the_seed():
    assert np.array_equal(pool_lengths(5), pool_lengths(5))
    assert not np.array_equal(pool_lengths(5), pool_lengths(6))
    # sample resolution: not on a grid of round tenths of a second
    assert np.any(pool_lengths(5) % (SR // 10))


def test_an_odd_batch_is_refused():
    with pytest.raises(ValueError):
        pool_lengths(1, {**TRAFFIC, "batch": 7})
