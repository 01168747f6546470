"""The port's htdemucs trainers (``amw_tpu_torch/scripts/train_htdemucs.py``
and ``train_htdemucs_tiny.py``) against the JAX package's
(``scripts/train_htdemucs_tpu.py``, ``scripts/train_htdemucs_tiny.py``) on
the CPU, without a JAX compile (those are in ``test_torch_train_jax.py``):

- the augmented corpus bit for bit, at the defaults and with each
  ``AMW_TRAIN_*`` changed;
- the tiny trainer's loop: its first three losses against the same loop
  (the JAX script's) on ``amw_tpu/models/htdemucs_torch.HTDemucsTorch``
  within 1e-5 relative (the same initial weights; after the first update
  the two networks' round-off-level gradients, normalised by Adam, part
  them slightly);
- ``main`` at tiny sizes on ``--device cpu``: a ``.npz`` that
  ``load_params`` reads and ``models/vocal`` serves; ``--init`` from a
  ``.th`` container and from a ``.npz``; each trainer raises without a
  GPU;
- a training step after a served forward (whose cached constants were
  made under inference mode).
"""

import os
import sys

import numpy as np
import pytest
import torch

from amw_tpu_torch.models import htdemucs as ht
from amw_tpu_torch.models import vocal
from amw_tpu_torch.scripts import htdemucs_gate
from amw_tpu_torch.scripts import train_htdemucs as tr
from amw_tpu_torch.scripts import train_htdemucs_tiny as tiny
from test_torch_scripts import jax_script, one_torch_thread

__all__ = ["one_torch_thread"]  # the fixture, imported for this module

LOOP_REL = 1e-5
TRAIN_ENV = ("AMW_TRAIN_RICH_FRAC", "AMW_TRAIN_REVERB_P",
             "AMW_TRAIN_REMIX_P", "AMW_TRAIN_DROP_P")
# main at tiny sizes: the narrow config, 2 segments a batch
SMALL = ("--channels", "8", "--bottom", "24", "--batch", "2",
         "--device", "cpu")


@pytest.fixture(scope="module")
def jtrain():
    """The JAX trainer's module: its host corpus (numpy) only.  Loading it
    sets ``AMW_HTDEMUCS_DTYPE`` and puts ``scripts/`` on ``sys.path``;
    both are put back."""
    saved_env = os.environ.get("AMW_HTDEMUCS_DTYPE")
    saved_path = list(sys.path)
    mod = jax_script("train_htdemucs_tpu")
    sys.path[:] = saved_path
    if saved_env is None:
        os.environ.pop("AMW_HTDEMUCS_DTYPE", None)
    else:
        os.environ["AMW_HTDEMUCS_DTYPE"] = saved_env
    jtiny = jax_script("train_htdemucs_tiny")
    with pytest.MonkeyPatch.context() as mp:
        # its augmented_batch imports the legacy recipe by module name
        mp.setitem(sys.modules, "train_htdemucs_tiny", jtiny)
        yield mod


@pytest.mark.parametrize("env", [None, *[(k, v) for k, v in zip(
    TRAIN_ENV, ("1.0", "0.0", "1.0", "0.5"))]],
    ids=["defaults", *TRAIN_ENV])
def test_augmented_batch_equals_jax(jtrain, monkeypatch, env):
    for k in TRAIN_ENV:
        monkeypatch.delenv(k, raising=False)
    if env is not None:
        monkeypatch.setenv(*env)
    batch, n, sr = 4, 4000, 8000
    got = tr.augmented_batch(np.random.default_rng(3), batch, n, sr)
    want = jtrain.augmented_batch(np.random.default_rng(3), batch, n, sr)
    assert got.dtype == np.float32 and got.shape == (batch, 4, 2, n)
    np.testing.assert_array_equal(got, want)
    assert float(np.abs(got).max()) > 0.05


def test_tiny_loop_against_the_oracle():
    """The tiny trainer's loop for three steps (its cosine over three,
    batch 8, rng seed 0) on the port's network against the JAX script's
    loop on its oracle, from the same seed-0 weights."""
    from amw_tpu.models import htdemucs_jax as hj
    from amw_tpu.models.htdemucs_torch import HTDemucsTorch

    steps = 3
    cfg = ht.tiny_config()
    model = ht.train_model(cfg, ht.init_params(cfg, seed=0), device="cpu")
    got = tiny.train(model, steps, rng=np.random.default_rng(0))

    # scripts/train_htdemucs_tiny.py:54-68 for three steps
    jcfg = hj.tiny_config()
    sr, n = jcfg.samplerate, jcfg.segment_samples
    torch.manual_seed(0)
    oracle = HTDemucsTorch(jcfg)
    opt = torch.optim.Adam(oracle.parameters(), lr=1e-3)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=steps)
    rng = np.random.default_rng(0)
    oracle.train()
    want = []
    for _ in range(steps):
        stems = htdemucs_gate.synth_batch(rng, 8, n, sr)
        pred = oracle(torch.from_numpy(stems.sum(axis=1)))
        loss = torch.nn.functional.l1_loss(pred, torch.from_numpy(stems))
        opt.zero_grad()
        loss.backward()
        opt.step()
        sched.step()
        want.append(loss.item())
    assert len(got) == steps
    np.testing.assert_allclose(got, want, rtol=LOOP_REL, atol=0)


def test_train_step_after_a_served_forward():
    """A forward under inference mode first (it fills the STFT's and the
    embeddings' caches), then a training step on the same shapes: every
    parameter gets a finite gradient."""
    cfg = ht.tiny_config(segment=0.25)
    state = ht.init_params(cfg, seed=1)
    mix = (0.1 * np.random.default_rng(2).standard_normal(
        (1, 2, cfg.segment_samples))).astype(np.float32)
    served = ht.inference_model(cfg, state, device="cpu")
    ht.forward(served, mix)
    model = ht.train_model(cfg, state, device="cpu")
    assert model.training and all(p.requires_grad and p.dtype == torch.float32
                                  for p in model.parameters())
    stems = torch.from_numpy(np.stack([mix] * 4, axis=1) / 4)
    w = torch.from_numpy(tr.stem_weights(1.0)).reshape(1, 4, 1, 1)
    loss = tr.loss_and_grads(model, torch.from_numpy(mix), stems, w)
    assert torch.isfinite(loss)
    for name, p in model.named_parameters():
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), name
    # the state passed in is copied, not trained in place
    for k, v in model.state_dict().items():
        assert v.data_ptr() != state[k].data_ptr(), k


def test_main_writes_a_checkpoint_that_serves(tmp_path, monkeypatch, capsys):
    """Three steps on the CPU: the JAX script's lines, a ``.npz`` of the
    config's shape that ``models/vocal`` loads and separates with."""
    out = tmp_path / "trained.npz"
    report = {}
    assert tr.main([str(out), "3", *SMALL, "--vocal-weight", "2"],
                   report=report) == 0
    said = capsys.readouterr().out.splitlines()
    for head in ("device=cpu", "cfg: channels=8 bottom=24 steps=3 batch=2",
                 "params: ", "step     0  l1 ", "step     2  l1 ",
                 "    probe gen-independent vocal SNR: ",
                 "best probe ", "same-generator held-out: ",
                 "generator-INDEPENDENT:   ", "timing: ",
                 f"saved {out}"):
        assert any(line.startswith(head) for line in said), head
    assert sorted(report["losses"]) == [0, 2]
    assert report["best_step"] == 2 and len(report["probes"]) == 1
    cfg, state = ht.load_params(str(out))
    assert (cfg.channels, cfg.bottom_channels, cfg.nfft) == (8, 24, 1024)
    assert set(state) == set(ht.init_params(cfg))

    monkeypatch.setenv("AMW_HTDEMUCS_CKPT", str(out))
    x = (0.2 * np.random.default_rng(4).standard_normal(
        (2, 3 * cfg.samplerate))).astype(np.float32)
    y = vocal.isolate_vocal(x, cfg.samplerate, device="cpu")
    assert (str(out), torch.device("cpu"), torch.float32) in vocal._ht_cache
    assert y.shape == x.shape and np.isfinite(y).all()
    assert float(np.abs(y).max()) > 0.0


def test_init_reads_th_and_npz(tmp_path, capsys):
    """``--init`` takes the JAX trainer's ``.th`` container and the port's
    ``.npz``: the run starts from those weights (the first loss is that
    of the saved weights, not of the seed's), and exits on a mismatch."""
    cfg = ht.tiny_config(channels=8, bottom_channels=24)
    state = ht.init_params(cfg, seed=7)
    th = tmp_path / "warm.th"
    torch.save({"klass": "HTDemucs", "args": (), "kwargs": {"channels": 8},
                "state": state, "metrics": {"steps": 0}}, th)
    npz = tmp_path / "warm.npz"
    ht.save_params(state, str(npz), cfg)
    losses = {}
    for path in (th, npz, None):
        report = {}
        init = ("--init", str(path)) if path else ()
        tr.main([str(tmp_path / "out.npz"), "2", *SMALL, *init],
                report=report)
        losses[path] = report["losses"][0]
        said = capsys.readouterr().out
        assert (f"warm-start from {path}" in said) == (path is not None)
    assert losses[th] == losses[npz] != losses[None]

    want = {k: v.numpy() for k, v in state.items()}
    got = tr.load_init(str(th), want)
    assert all(np.array_equal(got[k], want[k]) for k in want)
    with pytest.raises(SystemExit, match="missing keys"):
        tr.load_init(str(th), {**want, "extra.weight": np.zeros(3)})
    bad = dict(want)
    bad["encoder.0.conv.weight"] = np.zeros((1, 1))
    with pytest.raises(SystemExit, match="shape mismatch"):
        tr.load_init(str(npz), bad)


def test_trainers_raise_without_a_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = str(tmp_path / "x.npz")
    with pytest.raises(RuntimeError, match="CUDA"):
        tr.main([out, "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        tiny.main([out, "1"])
    assert not os.path.exists(out)


def test_defaults_are_the_jax_trainers():
    """The port's defaults are the JAX script's: its arguments, the queue,
    the probe's and the evaluations' seeds and sizes (read from the
    script's source)."""
    from test_torch_scripts import ROOT

    src = (ROOT / "scripts" / "train_htdemucs_tpu.py").read_text()
    for text in ('"steps", nargs="?", type=int, default=3000',
                 '"--channels", type=int, default=16',
                 '"--bottom", type=int, default=48',
                 '"--batch", type=int, default=16',
                 '"--lr", type=float, default=3e-4',
                 '"--seed", type=int, default=0',
                 '"--vocal-weight", type=float, default=1.0',
                 f"maxsize={tr.QUEUE_DEPTH}",
                 f"default_rng({tr.PROBE_SEED})",
                 f"default_rng({tr.SAME_SEED})",
                 f"synth_batch(ev, {tr.SAME_BATCH}, n, sr)",
                 f"default_rng({tr.HELD_SEED})",
                 f"synth_batch_heldout(ev2, {tr.HELD_BATCH}, n, sr)",
                 f"step % {tr.PROBE_EVERY} == {tr.PROBE_EVERY - 1}"):
        assert text in src, text
    ns = tr.build_parser().parse_args([])
    assert (ns.steps, ns.channels, ns.bottom, ns.batch, ns.lr, ns.seed,
            ns.vocal_weight, ns.init) == (3000, 16, 48, 16, 3e-4, 0, 1.0,
                                          None)
    tsrc = (ROOT / "scripts" / "train_htdemucs_tiny.py").read_text()
    for text in ("torch.manual_seed(0)", "lr=1e-3",
                 f"synth_batch(rng, {tiny.BATCH}, n, sr)",
                 f"default_rng({tiny.HELD_SEED})",
                 f"synth_batch(ev, {tiny.HELD_BATCH}, n, sr)",
                 f"s_base + {tiny.MARGIN_DB}", "else 400"):
        assert text in tsrc, text
    assert tiny.LR == 1e-3


def test_gate_cli(tmp_path, capsys):
    """``htdemucs_gate``'s CLI: the bundled checkpoint passes (exit 0);
    seed weights fail (exit 1)."""
    import json

    assert htdemucs_gate.main(["--device", "cpu", "--dtype", "f32"]) == 0
    said = json.loads(capsys.readouterr().out)
    assert said["passes"] and said["path"] == vocal.BUNDLED
    assert said["vocals_snr_db"] > htdemucs_gate.GATE_MIN_DB
    cfg = ht.tiny_config(channels=8, bottom_channels=24)
    path = tmp_path / "seed.npz"
    ht.save_params(ht.init_params(cfg), str(path), cfg)
    assert htdemucs_gate.main([str(path), "--device", "cpu"]) == 1
    assert json.loads(capsys.readouterr().out)["passes"] is False


def test_producer_hands_on_errors_and_closes(monkeypatch):
    """The corpus thread: batches in the JAX trainer's order (its rng
    seeded from the main generator's first draw), an error in the thread
    raised to the consumer, and ``close`` ending a thread blocked on a
    full queue."""
    n, sr = 800, 8000
    p = tr.Producer(np.random.default_rng(5), 6, 1, n, sr)
    seed = np.random.default_rng(5).integers(1 << 31)
    want = tr.augmented_batch(np.random.default_rng(seed), 1, n, sr)
    np.testing.assert_array_equal(p.get(), want)
    p.close()  # 5 batches left, at most 4 queued: the thread was blocked
    assert not p.thread.is_alive()

    def boom(*a):
        raise ValueError("corpus failed")

    monkeypatch.setattr(tr, "augmented_batch", boom)
    p = tr.Producer(np.random.default_rng(5), 3, 1, n, sr)
    with pytest.raises(ValueError, match="corpus failed"):
        p.get()
    p.close()
    assert not p.thread.is_alive()
