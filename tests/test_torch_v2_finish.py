"""The port's v2 job with the last DSP options against the JAX package's
on the CPU: the pro panel's true-peak ceiling (``true_peak_enabled``), and
a chain config with the reverb in M/S and the exciter at ``oversample`` 2.

Bars as tests/test_torch_v2_job.py: max sample error <= -90 dBFS,
integrated loudness within 0.1 LU, the graph's own before/after loudness
within 0.01 LU, padded tails exactly zero; the stage names are the JAX
package's, and every output keeps the ceiling (true peak <= ceiling +
0.05 dB, scipy's ``resample_poly``).
"""

import jax
import numpy as np
import pytest
import torch
from scipy.signal import resample_poly

import test_torch_v2_job as v2
from amw_tpu.models import v2_job as jv2
from amw_tpu.spec import GraphSpec as JSpec
from amw_tpu_torch import GraphSpec
from amw_tpu_torch.convert import params_from_jax
from amw_tpu_torch.models import chain as tchain
from amw_tpu_torch.models import v2_job as tv2

SR = v2.SR
CEILING_DB = -1.0  # the frontend's default (frontend/index.html:86)
PRO = {**v2.PRO, "true_peak_enabled": True,
       "true_peak_ceiling_db": CEILING_DB}


def finish_config() -> dict:
    """The default chain with the reverb on (plate, M/S) and the exciter
    at 0.6 dB, 2x oversampled."""
    cfg = tchain.default_chain_config()
    for m in cfg["modules"]:
        if m["id"] == "reverb":
            m.update(enabled=True, mix_mid=0.12, mix_side=0.2)
        if m["id"] == "exciter":
            m.update(enabled=True, exciter_db=0.6, oversample=2)
    return cfg


def run_pair(n, nvs, seed):
    cfg = finish_config()
    jp, jfn, jnames = jv2.build_v2_job_graph(JSpec(sr=SR, n=n, channels=2),
                                             cfg, PRO, -14.0, "standard")
    tp, tfn, tnames = tv2.build_v2_job_graph(GraphSpec(sr=SR, n=n,
                                                       channels=2),
                                             cfg, PRO, -14.0, "standard",
                                             device="cpu")
    assert tnames == jnames
    assert {"chain:exciter", "chain:reverb", "true_peak_limiter"} <= set(
        tnames)
    assert tnames.index("true_peak_limiter") == tnames.index(
        "dynamic_eq") + 1 == len(tnames) - 2
    pt = params_from_jax(jp, device="cpu")
    if nvs is None:
        x = v2.track(n, seed)
        want = jfn(x, jax.device_put(jp))
        got = tfn(torch.from_numpy(x), pt)
    else:
        x = np.stack([v2.track(n, seed + i) for i in range(len(nvs))])
        for i, nv in enumerate(nvs):
            x[i, :, nv:] = 0.0
        want = jax.jit(jax.vmap(jfn, in_axes=(0, None, 0)))(
            x, jax.device_put(jp), np.asarray(nvs, np.int32))
        got = tfn(torch.from_numpy(x), pt, torch.tensor(nvs))
    want = {k: np.asarray(v) for k, v in want.items()}
    got = {k: v.numpy() for k, v in got.items()}
    return want, got, x


def _tp_db(sig):
    return 20 * np.log10(np.abs(resample_poly(sig, 4, 1, axis=-1)).max())


@pytest.mark.parametrize("padded", [False, True], ids=["exact", "padded"])
def test_finish_options_match_jax(padded):
    nvs = v2.NVS if padded else None
    want, got, x = run_pair(v2.N, nvs, 21)
    v2.assert_parity(want, got, x, nvs)
    outs = ([got["out"]] if nvs is None
            else [got["out"][b, :, :nv] for b, nv in enumerate(nvs)])
    for y in outs:
        assert _tp_db(y) <= CEILING_DB + 0.05
