"""The port's sequence-parallel mastering (``amw_tpu_torch/parallel/
timeshard.py``) against ``amw_tpu.parallel.timeshard`` on the CPU.

Each case runs the same track through the JAX package's ``sp_master`` on
its 8-device CPU mesh (conftest) and the port's on as many ``cpu``
positions, and holds the port's output to JAX's and to the port's own
single-device v2 graph (exact mode) at ≤ −90 dBFS over the whole track,
edges included (the cases of tests/test_timeshard.py, side by side)."""

import numpy as np
import pytest
import torch

from amw_tpu.parallel import mesh as jmesh
from amw_tpu.parallel import timeshard as jts
from amw_tpu_torch import GraphSpec
from amw_tpu_torch.models.v2_job import build_v2_job_graph
from amw_tpu_torch.parallel import mesh as tmesh
from amw_tpu_torch.parallel import timeshard as tts

SR = 44100
HALO = 32768
BAR_DBFS = -90.0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU paths here are many small ops: one intra-op thread
    keeps them from spinning against the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def track():
    g = np.random.default_rng(3)
    n = 8 * SR
    t = np.arange(n) / SR
    x = (0.25 * np.sin(2 * np.pi * 220 * t)
         + 0.1 * np.sin(2 * np.pi * 1500 * t)
         + 0.03 * g.standard_normal(n))
    env = 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 0.3 * t))
    x = np.clip(np.stack([x * env, 0.85 * x * env]), -0.99, 0.99)
    x = x.astype(np.float32)
    return x - x.mean(axis=-1, keepdims=True)


def _cpu_mesh(n, axis="sp"):
    return tmesh.make_mesh(n, axis=axis, devices=["cpu"] * n)


def _single(x, pro=None, config=None, target=-14.0, style="standard"):
    """The port's single-device v2 graph, exact mode, on the CPU."""
    spec = GraphSpec(sr=SR, n=x.shape[-1], channels=x.shape[0], exact=True)
    params, fn, _ = build_v2_job_graph(spec, config, pro or {}, target,
                                       style, device="cpu")
    with torch.inference_mode():
        return fn(torch.from_numpy(x), params)["out"].numpy()


def _db(got, want):
    err = np.max(np.abs(got.astype(np.float64) - want))
    return 20 * np.log10(max(err, 1e-12))


def _lufs(x):
    from amw_tpu import refimpl

    return refimpl.integrated_lufs(x, SR)


def _side_by_side(x, n_dev, **kw):
    """(port, JAX): ``sp_master`` over ``n_dev`` positions / devices."""
    got = tts.sp_master(x, SR, _cpu_mesh(n_dev), halo=HALO, **kw)
    want = jts.sp_master(x, SR, jmesh.make_mesh(n_dev, axis="sp"),
                         halo=HALO, **kw)
    return got, np.asarray(want)


@pytest.mark.parametrize("n_dev,cut", [(2, 0), (3, 4410 * 3 + 123), (4, 0)],
                         ids=["2", "3-ragged", "4"])
def test_sp_default_v2_matches_jax_and_single_device(track, n_dev, cut):
    x = track[:, :track.shape[-1] - cut]
    x = x - x.mean(axis=-1, keepdims=True)
    got, want = _side_by_side(x, n_dev, target_lufs=-14.0, style="standard")
    assert got.shape == want.shape == x.shape
    assert _db(got, want) < BAR_DBFS
    single = _single(x)
    assert _db(got, single) < BAR_DBFS
    assert abs(_lufs(got) - _lufs(single)) < 0.02
    assert np.all(np.isfinite(got))


def test_sp_last_chunk_shorter_than_halo_exact(track):
    """The fourth window variant: the last chunk's valid length is below
    the halo, so the second-to-last position's window ends at the track
    end (tests/test_timeshard.py's geometry, 8 positions)."""
    n = 8 * 8 * 4410 + 8
    x = track[:, :n] - track[:, :n].mean(axis=-1, keepdims=True)
    chunk = tts._round_up(tts._round_up(n, 8) // 8, 4410)
    lv = n - 7 * chunk
    assert 0 < lv < HALO, (chunk, lv)
    got, want = _side_by_side(x, 8, target_lufs=-14.0)
    assert _db(got, want) < BAR_DBFS
    single = _single(x)
    assert _db(got, single) < BAR_DBFS
    tail = slice(6 * chunk + (chunk - HALO), 7 * chunk)
    assert _db(got[:, tail], single[:, tail]) < BAR_DBFS


PRO = {"rumble_enabled": True, "rumble_cutoff": 60.0,
       "deesser_enabled": True, "transient_attack": 1.3,
       "transient_sustain": 0.85, "parallel_mix": 0.25,
       "dynamic_eq_enabled": True}


def test_sp_pro_modules_match(track):
    got, want = _side_by_side(track, 2, target_lufs=-14.0, pro=PRO)
    assert _db(got, want) < BAR_DBFS
    assert _db(got, _single(track, PRO)) < BAR_DBFS


def test_sp_true_peak_limiter_matches(track):
    pro = {"true_peak_enabled": True, "true_peak_ceiling_db": -1.5}
    got, want = _side_by_side(track, 3, target_lufs=-9.0, pro=pro)
    assert _db(got, want) < BAR_DBFS
    assert _db(got, _single(track, pro, target=-9.0)) < BAR_DBFS
    from scipy.signal import resample_poly

    tp = 20 * np.log10(np.abs(resample_poly(got, 4, 1, axis=-1)).max())
    assert tp <= -1.5 + 0.05, tp


CUSTOM = {"modules": [
    {"id": "dc_offset", "enabled": True, "amount": 1.0},
    {"id": "peak_guard", "enabled": True, "headroom_db": 0.5, "amount": 1.0},
    {"id": "target_curve", "enabled": True, "phase_mode": "minimum",
     "eq_ms": False, "amount": 0.7},
    {"id": "normalize_lufs", "enabled": True, "target_lufs": -13.0,
     "amount": 1.0},
    {"id": "style_eq", "enabled": True, "style": "hiphop", "amount": 1.0},
    {"id": "peak_guard", "enabled": True, "headroom_db": 0.5, "amount": 1.0},
]}
TWO_NORMALIZE = {"modules": [
    {"id": "dc_offset", "enabled": True, "amount": 1.0},
    {"id": "normalize_lufs", "enabled": True, "target_lufs": -18.0,
     "amount": 1.0},
    {"id": "style_eq", "enabled": True, "style": "standard", "amount": 1.0},
    {"id": "normalize_lufs", "enabled": True, "target_lufs": -14.0,
     "amount": 1.0},
    {"id": "peak_guard", "enabled": True, "headroom_db": 0.5,
     "amount": 0.6},
]}


@pytest.mark.parametrize("config,target,style", [
    (CUSTOM, -13.0, "hiphop"), (TWO_NORMALIZE, -14.0, "standard")],
    ids=["custom", "two_normalize"])
def test_sp_chain_configs_match(track, config, target, style):
    got, want = _side_by_side(track, 4, chain_config=config,
                              target_lufs=target, style=style)
    assert _db(got, want) < BAR_DBFS
    assert _db(got, _single(track, config=config, target=target,
                            style=style)) < BAR_DBFS


def test_sp_master_loudness_gate(track):
    got = tts.sp_master(track, SR, _cpu_mesh(2), target_lufs=-11.0,
                        halo=HALO)
    assert abs(_lufs(got) - (-11.0)) < 1.0


def test_sp_dp_batch_2d_mesh(track):
    """2-D (dp × sp): each dp row time-shards its own track; every track
    matches JAX's 2-D mesh and its own single-device output."""
    xb = np.stack([track, np.roll(track, 1000, axis=-1) * 0.8])
    mesh = tmesh.make_mesh2d(2, 2, devices=["cpu"] * 4)
    got = tts.sp_batch_master(xb, SR, mesh, target_lufs=-14.0, halo=HALO)
    want = np.asarray(jts.sp_batch_master(xb, SR, jmesh.make_mesh2d(2, 2),
                                          target_lufs=-14.0, halo=HALO))
    assert got.shape == xb.shape
    for i in range(2):
        assert _db(got[i], want[i]) < BAR_DBFS, i
        assert _db(got[i], _single(xb[i])) < BAR_DBFS, i


def test_sp_stats_are_the_meter_over_positions(track):
    """``stats=True``: the before/after loudness from the gated meter over
    positions equals the single-device graph's meter (0.01 LU), the peak
    and finite flag those of the output."""
    n = track.shape[-1]
    fn, params, n_pad = tts.build_sp_master(SR, n, 2, _cpu_mesh(4),
                                            halo=HALO, stats=True)
    res = fn(np.pad(track, ((0, 0), (0, n_pad - n))), params)
    spec = GraphSpec(sr=SR, n=n, channels=2, exact=True)
    p1, f1, _ = build_v2_job_graph(spec, None, {}, device="cpu")
    with torch.inference_mode():
        ref = f1(torch.from_numpy(track), p1)
    for k in ("before_lufs", "after_lufs"):
        assert abs(float(res[k]) - float(ref[k])) < 0.01, k
    assert float(res["peak"]) == float(res["out"].abs().max())
    assert bool(res["finite"])


@pytest.mark.parametrize("n_dev,dur_sec", [(2, 8.0), (4, 7.3)])
def test_sp_denoise(track, n_dev, dur_sec):
    """The histogram-quantile denoiser: against JAX's sp denoiser on the
    same positions (a magnitude on a bin edge may bin differently in the
    other package: bar −60 dBFS), and against the exact single-device
    denoiser at JAX's own bar, ≤ −22 dBFS away from the track edges."""
    n = int(dur_sec * SR)
    x = track[:, :n] - track[:, :n].mean(axis=-1, keepdims=True)
    pro = {"denoise_strength": 0.5}
    got, want = _side_by_side(x, n_dev, target_lufs=-14.0, pro=pro)
    assert _db(got, want) < -60.0
    single = _single(x, pro)
    assert _db(got[:, HALO:-HALO], single[:, HALO:-HALO]) < -22.0
    assert np.abs(got).max() > 0.05
    assert abs(_lufs(got) - _lufs(single)) < 0.3


def test_sp_denoise_histogram_vs_exact_denoiser(track):
    """``_build_denoise_sp`` on one position (the STFT frame grid of the
    exact denoiser) against ``build_spectral_denoise``: only the
    histogram quantile differs, ≤ −34 dBFS; and against JAX's
    ``_build_denoise_sp`` on a one-device mesh."""
    import jax
    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from amw_tpu_torch.ops.spectral import build_spectral_denoise

    n = 8 * SR
    x = track[:, :n]
    spec = GraphSpec(sr=SR, n=n, channels=2, exact=True)
    _, sp_fn = tts._build_denoise_sp(spec, 0.5, 15.0)
    _, exact_fn = build_spectral_denoise(spec, 0.5, 15.0, device="cpu")
    with torch.inference_mode():
        got = sp_fn([torch.from_numpy(x)], [])[0].numpy()
        exact = exact_fn(torch.from_numpy(x)[None], [])[0].numpy()
    assert _db(got, exact) < -34.0
    assert np.max(np.abs(exact - x)) > 1e-3

    from amw_tpu.spec import GraphSpec as JSpec

    _, j_fn = jts._build_denoise_sp(JSpec(sr=SR, n=n, channels=2), 0.5,
                                    15.0, "sp")
    mapped = shard_map(lambda a: j_fn(a, []),
                       mesh=jmesh.make_mesh(1, axis="sp"),
                       in_specs=P(None, "sp"), out_specs=P(None, "sp"),
                       check_vma=False)
    want = np.asarray(jax.jit(mapped)(jnp.asarray(x)))
    assert _db(got, want) < -60.0


REVERB_LONG = {"modules": [
    {"id": "reverb", "enabled": True, "reverb_type": "cathedral",
     "decay_sec": 8.0, "mix": 0.3, "amount": 1.0},
]}


@pytest.mark.parametrize("case", [
    "reverb_ir_exceeds_halo", "too_short_for_shards",
    "two_shards_lv_below_halo", "one_position", "non_uniform_grid",
    "batch_not_divisible"])
def test_sp_rejections_match_jax(case):
    """Every rejection of the JAX builder is a ``ValueError`` in both."""
    calls = {
        "reverb_ir_exceeds_halo": lambda b, m: b(
            SR, 12 * SR, 2, m(8), chain_config=REVERB_LONG, halo=8192),
        "too_short_for_shards": lambda b, m: b(SR, 61340, 2, m(8)),
        "two_shards_lv_below_halo": lambda b, m: b(SR, 50000, 2, m(2)),
        "one_position": lambda b, m: b(SR, 12 * SR, 2, m(1)),
        "non_uniform_grid": lambda b, m: b(11025, 20 * 11025, 2, m(2),
                                           halo=8192),
    }
    match = {"reverb_ir_exceeds_halo": "halo",
             "too_short_for_shards": "too short",
             "two_shards_lv_below_halo": "single-(chip|device)|too short",
             "one_position": ">= 2", "non_uniform_grid": "uniform gating",
             "batch_not_divisible": "not divisible"}[case]
    if case == "batch_not_divisible":
        xb = np.zeros((3, 2, 4 * SR), np.float32)
        with pytest.raises(ValueError, match=match):
            jts.sp_batch_master(xb, SR, jmesh.make_mesh2d(2, 2))
        with pytest.raises(ValueError, match=match):
            tts.sp_batch_master(xb, SR, tmesh.make_mesh2d(
                2, 2, devices=["cpu"] * 4))
        return
    with pytest.raises(ValueError, match=match):
        calls[case](jts.build_sp_master,
                    lambda k: jmesh.make_mesh(k, axis="sp"))
    with pytest.raises(ValueError, match=match):
        calls[case](tts.build_sp_master, _cpu_mesh)


def test_sp_params_one_copy_per_device(track):
    """Positions sharing a device share one copy of the params."""
    mesh = _cpu_mesh(4)
    _, params, _ = tts.build_sp_master(SR, track.shape[-1], 2, mesh,
                                       halo=HALO)
    assert list(params) == [torch.device("cpu")]
