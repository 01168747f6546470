#!/usr/bin/env python
"""Train the tiny htdemucs on the synthetic four-stem corpus.

    python -m amw_tpu_torch.scripts.train_htdemucs_tiny [out.npz] [steps]
        [--device cpu]

The port's counterpart of the JAX package's
``scripts/train_htdemucs_tiny.py``, the earlier trainer: the port's
network (``models/htdemucs.py``) at ``tiny_config()`` from the seed-0
initial weights (``init_params``, the oracle's draw under
``torch.manual_seed(0)``), trained on ``htdemucs_gate.synth_batch``
(batch 8, rng seed 0) with plain L1, Adam at lr 1e-3 and cosine
annealing over the run, each step at full f32 (TF32 off:
``htdemucs._full_f32``).  Then the held-out check: at rng seed 1234, the
vocals' SNR on 16 fresh mixtures must beat the mixture's by 3 dB, else it
raises.  Writes the
weights as the port's ``.npz`` (``save_params`` with the config).  Runs
on ``cuda`` unless ``--device`` says otherwise, and raises without a
GPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
import torch.nn.functional as F

from amw_tpu_torch import resolve_device
from amw_tpu_torch.models import htdemucs
from amw_tpu_torch.scripts import gen_sep_eval
from amw_tpu_torch.scripts.htdemucs_gate import synth_batch

BATCH = 8
LR = 1e-3
HELD_SEED, HELD_BATCH = 1234, 16
MARGIN_DB = 3.0


def train(model, steps: int, *, rng) -> list:
    """Train ``model`` in place for ``steps`` steps under a ``steps``-step
    cosine schedule, printing the loss every 25 steps and at the last;
    returns every step's loss."""
    cfg = model.cfg
    dev = next(model.parameters()).device
    opt = torch.optim.Adam(model.parameters(), lr=LR)
    sched = torch.optim.lr_scheduler.CosineAnnealingLR(opt, T_max=steps)
    losses = []
    model.train()
    for step in range(steps):
        stems = synth_batch(rng, BATCH, cfg.segment_samples, cfg.samplerate)
        mix = torch.from_numpy(stems.sum(axis=1)).to(dev)
        target = torch.from_numpy(stems).to(dev)
        with htdemucs._full_f32(torch.float32):
            loss = F.l1_loss(model(mix), target)
            opt.zero_grad()
            loss.backward()
        opt.step()
        sched.step()
        losses.append(loss.detach())
        if step % 25 == 0 or step == steps - 1:
            print(f"step {step:4d}  l1 {loss.item():.5f}", flush=True)
    return [float(v) for v in losses]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_path", nargs="?", default="htdemucs_tiny.npz")
    ap.add_argument("steps", nargs="?", type=int, default=400)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = htdemucs.tiny_config()
    model = htdemucs.train_model(cfg, htdemucs.init_params(cfg, seed=0),
                                 device=dev)
    train(model, args.steps, rng=np.random.default_rng(0))

    # held-out eval: vocals SNR vs the mixture-as-estimate baseline
    model.eval()
    stems = synth_batch(np.random.default_rng(HELD_SEED), HELD_BATCH,
                        cfg.segment_samples, cfg.samplerate)
    mix = stems.sum(axis=1)
    pred = htdemucs.forward(model, mix).cpu().numpy()
    s_model = gen_sep_eval.snr_db(pred[:, 3], stems[:, 3])
    s_base = gen_sep_eval.snr_db(mix, stems[:, 3])
    print(f"held-out vocals SNR: model {s_model:.2f} dB vs "
          f"mixture-baseline {s_base:.2f} dB")
    if not s_model > s_base + MARGIN_DB:
        raise RuntimeError("model failed to learn separation: held-out "
                           f"vocals {s_model:.2f} dB against the mixture's "
                           f"{s_base:.2f} dB + {MARGIN_DB}")

    htdemucs.save_params(model.state_dict(), args.out_path, cfg)
    print(f"saved {args.out_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
