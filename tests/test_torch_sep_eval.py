"""The port's separation eval (``amw_tpu_torch/scripts/gen_sep_eval.py``)
against the JAX package's ``scripts/gen_sep_eval.py`` on the CPU: the
held-out corpus and the realistic mix bit for bit, and the four SNRs of
the bundled checkpoint (the port's ``.npz``, the JAX package's orbax
directory) within 0.05 dB.
"""

import json

import numpy as np
import pytest
import torch

from amw_tpu_torch.scripts import gen_sep_eval
from test_torch_scripts import jax_script, one_torch_thread

__all__ = ["one_torch_thread"]  # the fixture, imported for this module

SNR_TOL_DB = 0.05
KEYS = ("heldout_vocal_snr_db", "heldout_mixture_snr_db",
        "song_vocal_snr_db", "song_mixture_snr_db")


@pytest.fixture(scope="module")
def js():
    return jax_script("gen_sep_eval")


@pytest.mark.parametrize("batch,n,sr", [(2, 8000, 8000), (1, 4410, 44100)])
def test_heldout_corpus_equals_jax(js, batch, n, sr):
    a = gen_sep_eval.synth_batch_heldout(np.random.default_rng(7), batch, n,
                                         sr)
    b = js.synth_batch_heldout(np.random.default_rng(7), batch, n, sr)
    assert a.dtype == np.float32 and a.shape == (batch, 4, 2, n)
    np.testing.assert_array_equal(a, b)


def test_realistic_mix_equals_jax(js):
    a = gen_sep_eval.realistic_mix(24000, 8000)
    np.testing.assert_array_equal(a, js.realistic_mix(24000, 8000))
    assert a.shape == (4, 2, 24000) and float(np.abs(a).max()) > 0.1


def test_eval_checkpoint_matches_jax(js, monkeypatch):
    """The default batch of 8 and seed, on the bundled checkpoint."""
    from amw_tpu.models import vocal as jvocal

    monkeypatch.setenv("AMW_HTDEMUCS_CKPT", "bundled")
    monkeypatch.delenv("AMW_HTDEMUCS_DTYPE", raising=False)
    want = js.eval_checkpoint(jvocal.htdemucs_checkpoint_path())
    got = gen_sep_eval.eval_checkpoint(device="cpu")
    assert tuple(got) == tuple(want) == KEYS
    for k in KEYS:
        assert abs(got[k] - want[k]) <= SNR_TOL_DB, (k, got[k], want[k])
    # the network separates better than the mixture on both corpora
    assert got["heldout_vocal_snr_db"] > got["heldout_mixture_snr_db"]
    assert got["song_vocal_snr_db"] > got["song_mixture_snr_db"]


def test_main_prints_the_four_snrs(monkeypatch, capsys):
    """``main`` on the configured checkpoint (``bundled`` by default) and
    ``--dtype`` through ``AMW_HTDEMUCS_DTYPE``; the mixture SNRs do not
    depend on the network.  ``main`` leaves the environment as it found
    it."""
    import os

    from amw_tpu_torch.models import htdemucs

    for k in ("AMW_HTDEMUCS_CKPT", "AMW_HTDEMUCS_DTYPE"):
        # set first so that monkeypatch restores the caller's value
        monkeypatch.setenv(k, "")
        monkeypatch.delenv(k)
    seen = []
    real = htdemucs.inference_model

    def spy(cfg, state, *, device, dtype=None):
        seen.append(htdemucs.inference_dtype(device))
        return real(cfg, state, device=device, dtype=dtype)

    monkeypatch.setattr(htdemucs, "inference_model", spy)
    assert gen_sep_eval.main(["--device", "cpu"]) == 0
    f32 = json.loads(capsys.readouterr().out)
    assert gen_sep_eval.main(["--device", "cpu", "--dtype", "bf16"]) == 0
    bf16 = json.loads(capsys.readouterr().out)
    assert "AMW_HTDEMUCS_CKPT" not in os.environ
    assert "AMW_HTDEMUCS_DTYPE" not in os.environ
    assert seen == [torch.float32, torch.bfloat16]
    assert tuple(f32) == tuple(bf16) == KEYS
    for k in ("heldout_mixture_snr_db", "song_mixture_snr_db"):
        assert f32[k] == bf16[k]
    assert abs(f32["song_vocal_snr_db"] - bf16["song_vocal_snr_db"]) < 1.0


def test_orbax_directory_raises(js, monkeypatch):
    from amw_tpu.models import vocal as jvocal

    monkeypatch.setenv("AMW_HTDEMUCS_CKPT", "bundled")
    with pytest.raises(ValueError, match="convert_htdemucs_port"):
        gen_sep_eval.eval_checkpoint(jvocal.htdemucs_checkpoint_path(),
                                     device="cpu", batch=1)
