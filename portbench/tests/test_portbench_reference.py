"""The frozen reference (``portbench/reference``) against the port's CPU
path at a few seconds of audio, one track at its own length and a
bucket-padded batch; its envelope follower against the plain loop; the
control's rounding against PyTorch's bfloat16."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import check, generator
from portbench.reference import chains, dsp
from portbench.reference.precision import bfloat16


ROOT = Path(__file__).resolve().parents[2]
SR = 44100
V2 = {"graph": "v2_job", "sr": SR, "channels": 2, "exact": True,
      "target_lufs": -14.0, "style": "standard",
      "pro": {"rumble_enabled": True, "rumble_cutoff": 60.0,
              "deesser_enabled": True, "transient_attack": 1.3,
              "transient_sustain": 0.85, "parallel_mix": 0.25,
              "dynamic_eq_enabled": True}}
V1 = {**{k: v for k, v in V2.items() if k != "pro"}, "graph": "v1_pipeline"}
TRAFFIC = {"batch": 2, "pool": 1, "bucket_s": 4.0, "valid_s": [2.6, 4.0],
           "material": json.loads((ROOT / "portbench/traffic/batch8.json")
                                  .read_text())["material"]}


def port(config, x, nv):
    from amw_tpu_torch.spec import GraphSpec

    from portbench.entries.graph_batch import build_graph

    spec = GraphSpec(sr=SR, n=x.shape[-1], channels=2, exact=True)
    params, fn = build_graph(config, spec, "cpu")
    with torch.inference_mode():
        res = fn(x, params, torch.as_tensor(nv, dtype=torch.int32))
    return res


@pytest.mark.parametrize("config", [V2, V1], ids=["v2_job", "v1_pipeline"])
def test_reference_matches_the_port_on_a_padded_batch(config):
    torch.manual_seed(0)
    x, nv = generator.make_pool(TRAFFIC, SR, 2, 7, "cpu")
    res = port(config, x[0], nv[0])
    out = res["out"] if isinstance(res, dict) else res
    samples = []
    for b in range(2):
        s = {"input": x[0, b, :, :nv[0, b]].double().numpy(),
             "out": out[b].double().numpy(), "n_valid": int(nv[0, b])}
        if isinstance(res, dict):
            s.update(before_lufs=float(res["before_lufs"][b]),
                     after_lufs=float(res["after_lufs"][b]),
                     peak=float(res["peak"][b]),
                     finite=bool(res["finite"][b]))
        samples.append(s)
    refs = [chains.master(config, s["input"]) for s in samples]
    nums = check.numbers(samples, refs)
    assert nums["out_err"] < 1e-5
    assert nums["tail_max"] == 0.0
    if config is V2:
        assert nums["lufs_err"] < 1e-4 and nums["peak_err"] < 1e-5
        assert nums["nonfinite"] == 0


@pytest.mark.parametrize("stage", ["dynamic_eq_enabled", "deesser_enabled"])
def test_the_material_engages_the_pro_stages(stage):
    """Each gain stage of the pro set changes this material: a chain
    without it is far from the reference."""
    x, nv = generator.make_pool(TRAFFIC, SR, 2, 3, "cpu")
    xin = x[0, 1, :, :nv[0, 1]].double().numpy()
    full = chains.master(V2, xin)["out"]
    pro = {k: v for k, v in V2["pro"].items() if k != stage}
    assert np.abs(chains.master({**V2, "pro": pro}, xin)["out"]
                  - full).max() > 1e-3


def plain_envelope(v, sr, a_s, r_s):
    att = np.exp(-1.0 / (sr * a_s))
    rel = np.exp(-1.0 / (sr * r_s))
    e = v[..., 0].copy()
    out = np.empty_like(v)
    out[..., 0] = e
    for i in range(1, v.shape[-1]):
        c = np.where(v[..., i] > e, att, rel)
        e = c * e + (1.0 - c) * v[..., i]
        out[..., i] = e
    return out


def test_chunked_envelope_equals_the_plain_loop():
    g = np.random.default_rng(5)
    v = np.abs(g.standard_normal((3, 20_000))) * np.linspace(0, 1, 20_000)
    got = dsp.envelope_follower(v, 1000, 0.005, 0.05)   # W ~ 1000 < N
    want = plain_envelope(v, 1000, 0.005, 0.05)
    assert np.abs(got - want).max() < 1e-8


def test_bfloat16_rounding_matches_torch():
    g = np.random.default_rng(1)
    a = g.standard_normal(10_000) * 10.0 ** g.uniform(-6, 1, 10_000)
    want = torch.from_numpy(a).float().to(torch.bfloat16).double().numpy()
    np.testing.assert_array_equal(bfloat16(a), want)
