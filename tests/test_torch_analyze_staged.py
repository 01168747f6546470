"""The port's analysis graph on the staged FFT against the JAX package's
on its Pallas FFT, both forced onto that route on the CPU (the JAX kernels
in interpret mode, the port's plain versions of its kernels), fused and
split (``AMW_FFT_FUSED_RT=0``).

At the 15 s bucket the K-weighting plan is 2^20 (``site_plan`` /
``next_fft_size`` with the staged FFT enabled), so the graph's one
K-weighting pass runs ``apply_response``: packed for a stereo track, real
in / real out for a mono one.  Bars as tests/test_torch_analyze.py: 0.01
LU / dB on the meters, 1e-4 on the correlation, 1e-5 on the K-weighted
signal, equal vectorscope points and dict keys / ``None`` pattern.
"""

import functools
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from amw_tpu.models import analyze as janalyze
from amw_tpu.ops import fft_pallas as jfp
from amw_tpu.ops import meters as jm
from amw_tpu_torch.ops import fft_staged
from amw_tpu_torch.ops import meters as tm

from test_torch_analyze import (SR, assert_graph_outputs, assert_same_dict,
                                graph_pair, sig)

tanalyze = importlib.import_module("amw_tpu_torch.models.analyze")
BUCKET = 15 * SR


def _clear():
    janalyze._analysis_graph.cache_clear()
    tanalyze._analysis_graph.cache_clear()


@pytest.fixture(params=["fused", "split"])
def staged_route(request, monkeypatch):
    """Both packages on the staged route (and on the split stages for
    ``split``); returns the plans the port's ``apply_response`` ran."""
    _clear()
    request.addfinalizer(_clear)
    monkeypatch.setattr(jfp, "enabled", jfp.plan_ok)
    monkeypatch.setattr(jfp, "apply_response",
                        functools.partial(jfp.apply_response, interpret=True))
    monkeypatch.setattr(fft_staged, "enabled",
                        lambda nfft, device: fft_staged.plan_ok(nfft))
    if request.param == "split":
        monkeypatch.setenv("AMW_FFT_FUSED_RT", "0")

        def refuse(*a, **k):
            raise AssertionError("fused round trip on the split route")

        monkeypatch.setattr(fft_staged, "_stage_bc_cb", refuse)
    else:
        monkeypatch.setenv("AMW_FFT_FUSED_RT", "1")
    calls = []
    orig = fft_staged.apply_response

    def counted(*a, **k):
        calls.append(a[2])
        return orig(*a, **k)

    monkeypatch.setattr(fft_staged, "apply_response", counted)
    return calls


@pytest.mark.parametrize("channels,seconds", [(2, 15.0), (2, 11.3),
                                              (1, 11.3)],
                         ids=["stereo-exact", "stereo-padded", "mono-padded"])
def test_staged_analysis_graph_matches_jax(staged_route, channels, seconds):
    n = int(seconds * SR)
    x = sig(n, 30, channels)
    assert tanalyze._bucket_for(SR, n) == BUCKET
    xp = np.pad(x, ((0, 0), (0, BUCKET - n)))
    got, want = graph_pair(xp, n, True, True)
    # one staged K-weighting pass per call (graph_pair calls the port's
    # graph twice: its own Hk, then the JAX graph's)
    assert staged_route == [1 << 20] * 2
    assert_graph_outputs(got, want)
    if channels == 2 and seconds < 15:
        assert_same_dict(tanalyze.lufs_analyze_tool(x, SR, device="cpu"),
                         janalyze.lufs_analyze_tool(x, SR))


def test_staged_k_weighting_matches_jax(staged_route):
    """The K-weighted signal itself, stereo (packed) and mono (unpacked),
    from the graphs' own ``Hk`` pairs."""
    _, jHk = janalyze._analysis_graph(SR, BUCKET, 2, False, False)
    _, tHk = tanalyze._analysis_graph(SR, BUCKET, 2, False, False,
                                      device=torch.device("cpu"))
    nfft = 1 << 20
    assert tHk[1] is not None and tHk[0].shape == (2, nfft)
    np.testing.assert_array_equal(tHk[0].numpy(), np.asarray(jHk[0]))
    x = np.pad(sig(int(12.5 * SR), 31), ((0, 0), (0, BUCKET - int(12.5 * SR))))
    for rows in (x, x[:1]):
        want = jm.k_weight_filter(jnp.asarray(rows), jHk[0], nfft,
                                  pallas_tables=jHk[1])
        got = tm.k_weight_filter(torch.from_numpy(rows), *tHk[:1], nfft,
                                 staged_tables=tHk[1])
        assert float(np.max(np.abs(got.numpy() - np.asarray(want)))) < 1e-5
