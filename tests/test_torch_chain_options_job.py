"""A short v2 job (2 s stereo, the pro set on) with the chain-config
options ported in slice 4, the envelope band compressor and the
linear-phase target curve, against the JAX package's on the CPU.  The
modules alone are held in tests/test_torch_chain_options.py.

Bars (the repo's, BASELINE.md, as tests/test_torch_v2_job.py): max sample
error <= -90 dBFS, integrated loudness within 0.1 LU, the job's
before/after loudness within 0.01 LU.
"""

import jax
import numpy as np
import pytest
import torch

from amw_tpu.models import v2_job as jv2
from amw_tpu.spec import GraphSpec as JSpec
from amw_tpu_torch import GraphSpec
from amw_tpu_torch.convert import params_from_jax
from amw_tpu_torch.models import chain as tchain
from amw_tpu_torch.models import v2_job as tv2

from test_torch_v2_job import PRO, SR, assert_parity, flat, track


def options_config(phase_mode):
    cfg = tchain.default_chain_config()
    for m in cfg["modules"]:
        if m["id"] == "target_curve":
            m["phase_mode"] = phase_mode
        if m["id"] == "dynamics":
            m["compressor"] = "envelope"
    return cfg


@pytest.mark.parametrize("phase_mode", ["linear_phase", "minimum"])
def test_v2_job_with_both_options_matches_jax(phase_mode):
    """A 2 s v2 job (pro set on) with the envelope compressor, behind the
    linear-phase target curve (separate modules) or the minimum-phase one
    (the fused peephole)."""
    n = 2 * SR
    cfg = options_config(phase_mode)
    jp, jfn, jnames = jv2.build_v2_job_graph(JSpec(sr=SR, n=n, channels=2),
                                             cfg, PRO, -14.0, "standard")
    tp, tfn, tnames = tv2.build_v2_job_graph(GraphSpec(sr=SR, n=n,
                                                       channels=2),
                                             cfg, PRO, -14.0, "standard",
                                             device="cpu")
    assert tnames == jnames
    fused = "chain:target_curve+dynamics" in tnames
    assert fused == (phase_mode == "minimum")
    assert len(list(flat(tp))) == len(list(flat(jp)))
    x = track(n, 23)
    want = {k: np.asarray(v) for k, v in jfn(x, jax.device_put(jp)).items()}
    got = {k: v.numpy() for k, v in tfn(torch.from_numpy(x),
                                        params_from_jax(jp, "cpu")).items()}
    assert_parity(want, got, x, None)
