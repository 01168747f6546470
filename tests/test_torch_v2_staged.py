"""The port's v2 mastering job on the staged FFT against the JAX package's
on its Pallas FFT, both forced on the CPU: the JAX kernels in interpret
mode, the port's plain versions of its kernels.  At 500 000 samples every
fast zero-phase pass (rumble, de-esser, the eight dynamic-EQ bells) runs
``apply_response`` and the two fused sites the multi-response round trips;
the envelopes stay on the JAX package's CPU scan (their kernels are held in
interpret mode at module level, tests/test_torch_dynamics.py).

Bars as tests/test_torch_v2_job.py: <= -90 dBFS, <= 0.1 LU, the graph's
before/after loudness within 0.01 LU, padded tails exactly zero.  The
padded batch on this route is in tests/test_torch_v2_staged_batch.py (one
file each keeps a test worker's run near a minute).
"""

import functools

import pytest

from amw_tpu.ops import fft_pallas as jfp
from amw_tpu_torch.ops import fft_staged

import test_torch_v2_job as v2

N_STAGED = 500_000


@pytest.fixture
def staged_route(monkeypatch):
    """Both packages on the staged route, whatever the backend."""
    monkeypatch.setattr(jfp, "enabled", jfp.plan_ok)
    for name in ("apply_response", "roundtrip_multi",
                 "roundtrip_multi_reduce"):
        monkeypatch.setattr(jfp, name, functools.partial(getattr(jfp, name),
                                                         interpret=True))
    monkeypatch.setattr(fft_staged, "enabled",
                        lambda nfft, device: fft_staged.plan_ok(nfft))
    calls = []
    orig = fft_staged.apply_response

    def counted(*a, **k):
        calls.append(a[2])
        return orig(*a, **k)

    monkeypatch.setattr(fft_staged, "apply_response", counted)
    return calls


def test_staged_exact_length_clip_matches_jax(staged_route):
    want, got, x = v2.run_pair(N_STAGED, None, 11)
    # rumble 1 + de-esser 1 + dynamic EQ 8 fast passes on the staged FFT
    assert len(staged_route) == 10
    assert all(fft_staged.plan_ok(nfft) for nfft in staged_route)
    v2.assert_parity(want, got, x, None)
