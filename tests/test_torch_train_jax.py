"""The port's training step (``amw_tpu_torch/scripts/train_htdemucs.py``
on ``models/htdemucs.train_model``) against the JAX trainer's
(``scripts/train_htdemucs_tpu.py:328-352``: ``jax.value_and_grad`` of
``htdemucs_jax.forward``, ``optax.adam`` under
``optax.warmup_cosine_decay_schedule``) on the CPU.  Bars:

- the schedule: optax's at every update count, for runs of 3, 40 and 3000
  steps, within 1e-7 relative where optax evaluates it at float64, within
  1e-5 of its float32 evaluation (its own rounding, up to ~7e-6 relative
  where the cosine nears its floor);
- Adam: the port's optimiser and schedule fed the same seeded gradients
  as ``optax.adam(sched)``: each of 5 updates within 1e-6 of the largest
  of optax's, the lr-0 first update included (zero in both);
- the loss at ``tiny_config(segment=0.5)``, batch 2 of the trainer's
  corpus, vocal weight 2: within 1e-6 relative of ``jax.value_and_grad``'s;
- the gradients: every tensor whose largest element exceeds 1e-9 of the
  network's largest within 1e-4 of its own largest (float32 sums in
  another order; the bias of the last time decoder, the largest gradient,
  sums 2 x 4000 terms that nearly cancel); each tensor under that floor
  within it in absolute error, and within 1e-4 of its own largest unless
  it is named in ``ROUND_OFF`` (gradients of ~1e-14, round-off in both
  packages);
- three steps of a 3-step run: the per-step losses within 1e-4 relative.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from amw_tpu.models import htdemucs_jax as hj
from amw_tpu_torch.models import htdemucs as ht
from amw_tpu_torch.scripts import train_htdemucs as tr
from test_torch_scripts import one_torch_thread

__all__ = ["one_torch_thread"]  # the fixture, imported for this module

SCHED_REL = 1e-7
SCHED_F32_REL = 1e-5
ADAM_REL = 1e-6
LOSS_REL = 1e-6
GRAD_REL = 1e-4
GRAD_FLOOR = 1e-9  # of the network's largest gradient
STEPS_REL = 1e-4
LR = 3e-4
VOCAL_WEIGHT = 2.0
BATCH = 2
RUN_STEPS = 3  # the three-step run's schedule
# the biases of the first encoders' first dconv convolutions: their
# gradients are round-off (~1e-14) in both packages
ROUND_OFF = {f"{enc}.0.dconv.layers.{i}.0.bias"
             for enc in ("encoder", "tencoder") for i in (0, 1)}


def jax_schedule(lr, steps):
    """scripts/train_htdemucs_tpu.py:328-333."""
    warmup = min(max(steps // 20, 10), max(steps // 2, 1))
    return optax.warmup_cosine_decay_schedule(
        0.0, lr, warmup_steps=warmup, decay_steps=steps,
        end_value=lr * 0.05)


@pytest.mark.parametrize("steps", [3, 40, 3000])
def test_schedule_equals_optax(steps):
    """At every update count: optax's schedule evaluated at float64
    (``jax.enable_x64``, integer counts) within 1e-7 relative, and its
    float32 evaluation from an int32 count, jitted as the JAX trainer runs
    it, within 1e-5 (optax's own rounding near the cosine's floor)."""
    sched = jax_schedule(LR, steps)
    port = tr.warmup_cosine_decay(0.0, LR, tr.warmup_steps(steps), steps,
                                  LR * 0.05)
    counts = range(steps + 2)
    got = np.array([port(c) for c in counts])
    with jax.enable_x64(True):
        want = np.array([float(sched(c)) for c in counts])
    f32 = np.asarray(jax.jit(jax.vmap(sched))(
        jnp.arange(steps + 2, dtype=jnp.int32)), np.float64)
    assert got[0] == want[0] == f32[0] == 0.0
    np.testing.assert_allclose(got, want, rtol=SCHED_REL, atol=0)
    np.testing.assert_allclose(got, f32, rtol=SCHED_F32_REL, atol=0)
    assert abs(got.max() - LR) <= LR * SCHED_REL


def test_adam_equals_optax():
    """Five updates of a 3-step schedule (warm-up, cosine, flat end) on
    seeded gradients, each applied to parameters at zero (so that the
    parameters after it are the update, not rounded by an add)."""
    rng = np.random.default_rng(11)
    shapes = {"a": (3, 4), "b": (7,)}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * 10.0 ** -i
              for k, s in shapes.items()} for i in range(5)]
    tx = optax.adam(jax_schedule(LR, RUN_STEPS))
    pj = {k: jnp.zeros(s, jnp.float32) for k, s in shapes.items()}
    st = tx.init(pj)
    update = jax.jit(tx.update)
    params = {k: torch.zeros(s, requires_grad=True)
              for k, s in shapes.items()}
    opt, sched = tr.make_optimizer(list(params.values()), LR, RUN_STEPS)
    for i, g in enumerate(grads):
        u, st = update({k: jnp.asarray(v) for k, v in g.items()}, st, pj)
        for k, p in params.items():
            p.grad = torch.from_numpy(g[k])
            with torch.no_grad():
                p.zero_()  # Adam's update does not read the parameters
        opt.step()
        sched.step()
        for k, p in params.items():
            want = np.asarray(u[k], np.float64)
            got = p.detach().double().numpy()  # 0 + the update, exactly
            if i == 0:
                assert not want.any() and not got.any(), k
                continue
            scale = np.abs(want).max()
            assert scale > 0
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=ADAM_REL * scale, err_msg=k)


@pytest.fixture(scope="module")
def setup():
    """(JAX config, port config, JAX params, the JAX trainer's step of a
    3-step run, jitted, returning (loss, grads, params, state) too, the
    stem weights, three batches of the trainer's corpus)."""
    jcfg = hj.tiny_config(segment=0.5)
    tcfg = ht.tiny_config(segment=0.5)
    params = hj.init_params(jcfg, seed=0)
    tx = optax.adam(jax_schedule(LR, RUN_STEPS))
    w = tr.stem_weights(VOCAL_WEIGHT)
    w_stems = jnp.asarray(w).reshape(1, 4, 1, 1)

    def loss_fn(pp, mix, target):
        pred = hj.forward(pp, mix, jcfg)
        return jnp.mean(jnp.abs(pred - target) * w_stems)

    @jax.jit
    def train_step(pp, st, mix, target):
        loss, grads = jax.value_and_grad(loss_fn)(pp, mix, target)
        updates, st = tx.update(grads, st, pp)
        pp = optax.apply_updates(pp, updates)
        return loss, grads, pp, st

    rng = np.random.default_rng(0)
    batches = [tr.augmented_batch(rng, BATCH, jcfg.segment_samples,
                                  jcfg.samplerate) for _ in range(RUN_STEPS)]
    return jcfg, tcfg, params, tx, train_step, w, batches


def port_inputs(stems, w):
    return (torch.from_numpy(stems.sum(axis=1)), torch.from_numpy(stems),
            torch.from_numpy(w).reshape(1, 4, 1, 1))


def test_loss_and_gradients_against_value_and_grad(setup):
    jcfg, tcfg, params, tx, train_step, w, batches = setup
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    stems = batches[0]
    lj, gj, _, _ = train_step(pj, tx.init(pj), jnp.asarray(stems.sum(axis=1)),
                              jnp.asarray(stems))
    model = ht.train_model(tcfg, params, device="cpu")
    lt = tr.loss_and_grads(model, *port_inputs(stems, w))
    assert abs(float(lt) - float(lj)) <= LOSS_REL * abs(float(lj))

    gt = {k: p.grad.numpy() for k, p in model.named_parameters()}
    assert set(gt) == set(gj) and len(gt) == 321
    gmax = max(float(np.abs(v).max()) for v in gj.values())
    floor = GRAD_FLOOR * gmax
    under, parted = [], []
    for k, want in gj.items():
        want = np.asarray(want)
        scale = float(np.abs(want).max())
        err = float(np.abs(gt[k] - want).max())
        if scale > floor:
            assert err <= GRAD_REL * scale, (k, err, scale)
            continue
        under.append(k)
        assert err <= floor, (k, err, floor)
        if err > GRAD_REL * scale:
            parted.append(k)
    # the round-off tensors lie under the floor; nothing else parts
    assert ROUND_OFF <= set(under)
    assert set(parted) <= ROUND_OFF, parted


def test_three_steps_against_jax_train_step(setup):
    jcfg, tcfg, params, tx, train_step, w, batches = setup
    pj = {k: jnp.asarray(v) for k, v in params.items()}
    st = tx.init(pj)
    want = []
    for stems in batches:
        loss, _, pj, st = train_step(pj, st, jnp.asarray(stems.sum(axis=1)),
                                     jnp.asarray(stems))
        want.append(float(loss))
    model = ht.train_model(tcfg, params, device="cpu")
    opt, sched = tr.make_optimizer(model.parameters(), LR, RUN_STEPS)
    got = [float(tr.train_step(model, opt, sched, *port_inputs(stems, w)))
           for stems in batches]
    np.testing.assert_allclose(got, want, rtol=STEPS_REL, atol=0)
    assert got[1] != got[0]  # the weights moved
