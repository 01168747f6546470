"""The port's htdemucs network (``amw_tpu_torch/models/htdemucs.py``)
against the JAX package's (``amw_tpu/models/htdemucs_jax.py``) on the CPU.

The same weights (``htdemucs_jax.init_params``, carried across by
``convert.htdemucs_from_jax``) and the same inputs (numpy, seeded) go
through both.  Bars:

- f32 forward and overlap-add separation: max sample error <= -90 dBFS,
  the repo's parity bar (BASELINE.md:20); a float32 torch forward reaches
  about -150 dBFS against the JAX one here (summation order only).
- bf16: SNR >= 30 dB against f32 and against the JAX package's bf16
  forward, the JAX package's own bar for its bf16 mode
  (tests/test_htdemucs_parity.py:87-106): bf16 rounds the activations at
  ~1e-2 relative, in other places in the two frameworks.
- int16 upload: equal to the float32 upload bit for bit (the dequantise is
  exact); a grid mix against a sub-LSB-shifted one within 1e-5, the JAX
  package's bar (:150-173).
- the converted checkpoint: exactly equal, key for key, config too.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from amw_tpu.models import htdemucs_jax as hj
from amw_tpu_torch.convert import htdemucs_from_jax
from amw_tpu_torch.models import htdemucs as ht
from amw_tpu_torch.models import vocal as tvo

BAR_DBFS = -90.0
BAR_SNR_DB = 30.0
INT16_ATOL = 1e-5


def dbfs(a, b):
    return 20 * np.log10(max(float(np.max(np.abs(a - b))), 1e-30))


def snr_db(ref, est):
    return 10 * np.log10(np.sum(ref.astype(np.float64) ** 2)
                         / max(np.sum((ref.astype(np.float64) - est) ** 2),
                               1e-30))


def jax_forward(params, mix, cfg):
    return np.asarray(jax.jit(lambda p, x: hj.forward(p, x, cfg))(
        jax.device_put(params), jnp.asarray(mix)).astype(jnp.float32))


@pytest.fixture(scope="module")
def tiny():
    """(JAX config, port config, JAX params, port f32 module on the CPU,
    a seeded mix [2, 2, segment])."""
    jcfg, tcfg = hj.tiny_config(), ht.tiny_config()
    params = hj.init_params(jcfg, seed=0)
    model = htdemucs_from_jax(params, tcfg, device="cpu",
                              dtype=torch.float32)
    rng = np.random.default_rng(7)
    mix = (0.2 * rng.standard_normal((2, 2, jcfg.segment_samples))
           ).astype(np.float32)
    return jcfg, tcfg, params, model, mix


@pytest.fixture(scope="module")
def jax_f32(tiny):
    jcfg, _, params, _, mix = tiny
    return jax_forward(params, mix, jcfg)


def test_init_params_draws_the_jax_weights():
    """A seeded build draws the JAX package's initial weights exactly
    (both build the oracle's module tree under torch.manual_seed)."""
    want = hj.init_params(hj.tiny_config(), seed=3)
    got = ht.init_params(ht.tiny_config(), seed=3)
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


@pytest.mark.parametrize("kw", [{}, {"channels": 16, "bottom_channels": 48},
                                {"sources": ("drums", "bass", "other",
                                             "vocals", "guitar", "piano")}],
                         ids=["released", "bundled_shape", "six_stems"])
def test_config_vector_matches_jax(kw):
    """The config copy writes and reads the JAX package's vector."""
    jcfg, tcfg = hj.HTConfig(**kw), ht.HTConfig(**kw)
    vec = hj._config_vec(jcfg)
    np.testing.assert_array_equal(ht._config_vec(tcfg), vec)
    assert vars(ht._config_from_vec(vec)) == vars(hj._config_from_vec(vec))
    kwargs = {"sources": list(jcfg.sources), "t_hidden": 4.0,
              "freq_emb": 0.2, "nfft": jcfg.nfft, "unknown": 1}
    assert vars(ht.config_from_kwargs(kwargs)) == vars(
        hj.config_from_kwargs(kwargs))


def test_check_params_shape_rejects_another_variant(tiny):
    _, tcfg, params, _, _ = tiny
    ht.check_params_shape(params, tcfg)
    with pytest.raises(ValueError, match="encoder.0.conv.weight"):
        ht.check_params_shape(params, ht.tiny_config(audio_channels=1))
    with pytest.raises(ValueError, match="final decoder"):
        ht.check_params_shape(params, ht.tiny_config(
            sources=("drums", "vocals")))


def test_spectrogram_matches_jax():
    """demucs' ``_spec`` / ``_ispec`` against the JAX package's; the
    inverse drops the imaginary parts of the DC and Nyquist bins (the
    network's output has one at DC), as the CPU's and XLA's inverse real
    FFT do, so that cuFFT's gives the same result on the card."""
    cfg = ht.tiny_config()
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 2, 3000)).astype(np.float32)
    re, im = ht._spec(torch.from_numpy(x), cfg.nfft, cfg.hop)
    jre, jim = hj._spec(jnp.asarray(x), cfg.nfft, cfg.hop)
    assert dbfs(re.numpy(), np.asarray(jre)) <= BAR_DBFS
    assert dbfs(im.numpy(), np.asarray(jim)) <= BAR_DBFS
    zre = rng.standard_normal(re.shape).astype(np.float32)
    zim = rng.standard_normal(re.shape).astype(np.float32)
    got = ht._ispec(torch.from_numpy(zre), torch.from_numpy(zim), cfg.hop,
                    3000).numpy()
    want = np.asarray(hj._ispec(jnp.asarray(zre), jnp.asarray(zim), cfg.hop,
                                3000))
    assert got.shape == want.shape == (2, 2, 3000)
    assert dbfs(got, want) <= BAR_DBFS
    zim[..., 0, :] += 5.0  # an imaginary DC changes nothing
    again = ht._ispec(torch.from_numpy(zre), torch.from_numpy(zim), cfg.hop,
                      3000).numpy()
    np.testing.assert_array_equal(again, got)


def test_forward_matches_jax(tiny, jax_f32):
    """(i) The f32 forward on JAX's weights, a batch of two segments."""
    _, _, _, model, mix = tiny
    got = ht.forward(model, mix).numpy()
    assert got.dtype == np.float32 and got.shape == jax_f32.shape == (
        2, 4, 2, mix.shape[-1])
    assert dbfs(got, jax_f32) <= BAR_DBFS


def test_bf16_close_to_f32_and_to_jax_bf16(tiny, jax_f32, monkeypatch):
    """(ii) bf16 weights and activations, f32 statistics and softmax."""
    jcfg, tcfg, params, model, mix = tiny
    m16 = htdemucs_from_jax(params, tcfg, device="cpu",
                            dtype=torch.bfloat16)
    assert all(p.dtype == torch.bfloat16 for p in m16.parameters())
    got = ht.forward(m16, mix).numpy()
    assert got.dtype == np.float32 and np.all(np.isfinite(got))
    f32 = ht.forward(model, mix).numpy()
    assert snr_db(f32, got) >= BAR_SNR_DB
    monkeypatch.setattr(hj, "_DTYPE", "bf16")
    want = jax_forward(hj.inference_params(params), mix, jcfg)
    assert snr_db(want, got) >= BAR_SNR_DB
    assert snr_db(jax_f32, want) >= BAR_SNR_DB


def test_inference_dtype_modes(monkeypatch):
    monkeypatch.delenv("AMW_HTDEMUCS_DTYPE", raising=False)
    assert ht.inference_dtype("cpu") == torch.float32
    assert ht.inference_dtype(torch.device("cuda")) == torch.bfloat16
    for mode, want in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        monkeypatch.setenv("AMW_HTDEMUCS_DTYPE", mode)
        assert ht.inference_dtype("cpu") == ht.inference_dtype("cuda") == want
    monkeypatch.setenv("AMW_HTDEMUCS_DTYPE", "fp8")
    with pytest.warns(UserWarning, match="not a valid mode"):
        assert ht.inference_dtype("cpu") == torch.float32


def test_full_f32_restores_the_tf32_switches():
    """An f32 forward turns TF32 off for itself and puts the switches
    back; a bf16 one leaves them."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        with ht._full_f32(torch.float32):
            assert not torch.backends.cudnn.allow_tf32
            assert not torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
        with ht._full_f32(torch.bfloat16):
            assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


# (T in segments, batch): one window group; half a segment; 6 windows at
# batch 2 -> 3 groups, bucket 4 (test_separate_device_matches_host_oa)
OA_CASES = [(2.3, 3), (0.5, 3), (4.5, 2)]


@pytest.mark.parametrize("seg_mult,batch", OA_CASES,
                         ids=["one_group", "half_segment", "three_groups"])
def test_separate_matches_jax(tiny, seg_mult, batch):
    """(iii) Overlap-add against JAX's device route, all four stems and
    the vocals alone, on the device and host routes."""
    jcfg, _, params, model, _ = tiny
    T = int(jcfg.segment_samples * seg_mult)
    rng = np.random.default_rng(9)
    mix = (0.2 * rng.standard_normal((2, T))).astype(np.float32)
    assert ht.oa_plan(model.cfg, T, batch=batch) == hj.oa_plan(
        jcfg, T, batch=batch)
    want = hj.separate(params, mix, jcfg, batch=batch)
    assert want.shape == (4, 2, T)
    for stems, ref in ((None, want), (("vocals",), want[3:])):
        dev = ht.separate(model, mix, batch=batch, stems=stems)
        host = ht.separate(model, mix, batch=batch, stems=stems,
                           host_oa=True)
        assert dev.shape == host.shape == ref.shape
        assert dbfs(dev, ref) <= BAR_DBFS
        assert dbfs(host, ref) <= BAR_DBFS


def test_separate_uploads_the_mix_once(tiny, monkeypatch):
    """The device route uploads the whole mix once, padded to ``t_ext``,
    whatever the number of window groups (here 3, bucket 4), and the JAX
    package's ``AMW_HTDEMUCS_STREAM`` does not change that."""
    jcfg, _, _, model, _ = tiny
    T = int(jcfg.segment_samples * 5.1)
    mix = (0.1 * np.random.default_rng(4).standard_normal(
        (2, T))).astype(np.float32)
    uploads = []
    real = ht._upload
    monkeypatch.setattr(ht, "_upload",
                        lambda h, d: uploads.append(h.shape) or real(h, d))
    base = ht.separate(model, mix, stems=("vocals",))
    t_ext = ht.oa_plan(model.cfg, T)[4]
    assert uploads == [(2, t_ext)] and base.shape == (1, 2, T)
    monkeypatch.setenv("AMW_HTDEMUCS_STREAM", "1")
    got = ht.separate(model, mix, stems=("vocals",))
    assert uploads == [(2, t_ext)] * 2
    np.testing.assert_array_equal(got, base)


def test_separate_int16_transfer_lossless(tiny, monkeypatch):
    """A 16-bit-grid mix is uploaded as int16 and gives the stems of the
    same mix uploaded as float32, bit for bit; a non-grid mix is not
    quantised."""
    jcfg, _, _, model, _ = tiny
    rng = np.random.default_rng(11)
    T = int(jcfg.segment_samples * 1.4)
    mix = rng.standard_normal((2, T)).astype(np.float32) * 0.2
    grid = np.round(mix * 32768.0).clip(-32767, 32767) \
        .astype(np.float32) / np.float32(32768.0)
    assert ht._pack_mix(grid, T + 3).dtype == np.int16
    assert ht._pack_mix(mix, T + 3).dtype == np.float32
    out_grid = ht.separate(model, grid)
    off = grid.copy()
    off[0, 0] += np.float32(1e-9)
    assert ht._pack_mix(off, T).dtype == np.float32
    assert np.allclose(out_grid, ht.separate(model, off), atol=INT16_ATOL)
    real = ht._pack_mix
    monkeypatch.setattr(ht, "_pack_mix", lambda m, t: real(m, t).astype(
        np.float32) / (32768.0 if real(m, t).dtype == np.int16 else 1.0))
    np.testing.assert_array_equal(ht.separate(model, grid), out_grid)


def test_separate_takes_a_state_dict_on_a_device(tiny):
    """A state dict is built on ``device`` for the call; a module on
    another device than the one asked for is refused."""
    jcfg, tcfg, params, model, _ = tiny
    mix = (0.1 * np.random.default_rng(5).standard_normal(
        (2, jcfg.segment_samples))).astype(np.float32)
    state = {k: torch.from_numpy(v) for k, v in params.items()}
    got = ht.separate(state, mix, tcfg, device="cpu")
    np.testing.assert_array_equal(got, ht.separate(model, mix))
    with pytest.raises(ValueError, match="lies on cpu"):
        ht.separate(model, mix, device="meta")


def test_converted_checkpoint_equals_the_orbax_one():
    """(iv) ``htdemucs_tiny.npz`` (scripts/convert_htdemucs_port.py) holds
    exactly what ``htdemucs_jax.load_params`` reads from the bundled orbax
    checkpoint, and its config."""
    import os

    from amw_tpu.models import vocal as jvo

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("AMW_HTDEMUCS_CKPT", "bundled")
        jpath, tpath = jvo.htdemucs_checkpoint_path(), \
            tvo.htdemucs_checkpoint_path()
    assert tpath == tvo.BUNDLED and os.path.basename(jpath) == \
        "htdemucs_tiny"
    jcfg, want = hj.load_params(jpath)
    cfg, got = ht.load_params(tpath)
    assert vars(cfg) == vars(jcfg)
    assert (cfg.channels, cfg.bottom_channels) == (16, 48)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert sum(v.numel() for v in got.values()) == 1_219_456


def test_released_shape_round_trip_and_forward(tmp_path):
    """(iv) The released shape: a seeded state dict at htdemucs' published
    dimensions through save_params / load_params and one forward (a short
    hop-aligned input keeps the CPU cost down; the network takes any
    length), as the JAX package's released-shape dry run."""
    cfg = ht.HTConfig()
    state = ht.init_params(cfg, seed=1)
    assert sum(v.numel() for v in state.values()) == 41_473_616
    path = str(tmp_path / "released.npz")
    ht.save_params(state, path, cfg)
    cfg2, state2 = ht.load_params(path)
    assert vars(cfg2) == vars(cfg) and set(state2) == set(state)
    for k in ("encoder.0.conv.weight", "crosstransformer.layers.4.norm_out"
              ".bias", "tdecoder.3.conv_tr.weight"):
        assert torch.equal(state2[k], state[k])
    model = ht.inference_model(cfg2, state2, device="cpu")
    T = cfg2.hop * 64
    mix = (0.05 * np.random.default_rng(0).standard_normal((1, 2, T))
           ).astype(np.float32)
    out = ht.forward(model, mix).numpy()
    assert out.shape == (1, 4, 2, T) and np.all(np.isfinite(out))


def test_load_params_rejects_a_wrong_tree(tmp_path, tiny):
    """A file whose names differ from its config's tree does not load:
    the module's build from it raises ``ValueError`` naming the key."""
    _, tcfg, params, _, _ = tiny
    bad = dict(params)
    bad.pop("encoder.0.conv.bias")
    path = str(tmp_path / "bad.npz")
    ht.save_params(bad, path, tcfg)
    with pytest.raises(ValueError, match="encoder.0.conv.bias"):
        ht.inference_model(*ht.load_params(path), device="cpu")
