#!/usr/bin/env python
"""Convert an htdemucs orbax checkpoint of the JAX package into the PyTorch
port's checkpoint file.

Usage:
  python scripts/convert_htdemucs_port.py [SRC_DIR [OUT.npz]]

SRC_DIR defaults to the bundled checkpoint
``amw_tpu/models/checkpoints/htdemucs_tiny``; OUT.npz to
``amw_tpu_torch/models/checkpoints/htdemucs_tiny.npz``, which is what the
port's ``htdemucs_checkpoint`` setting ``bundled`` names.

The JAX package stores its weights as an orbax OCDBT directory; the port
does not import JAX or orbax, so it reads its own format instead: a
``.npz`` of float32 arrays under the upstream state-dict names plus
``__config__``, the architecture vector (``amw_tpu_torch.models.htdemucs
.load_params``).  This script runs where orbax does (it loads the source
with ``amw_tpu.models.htdemucs_jax.load_params``), copies every array as
it is (no rename, no transpose: both packages use the torch layouts),
checks the result against the port's module tree, and writes it.
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SRC = os.path.join(ROOT, "amw_tpu", "models", "checkpoints", "htdemucs_tiny")
OUT = os.path.join(ROOT, "amw_tpu_torch", "models", "checkpoints",
                   "htdemucs_tiny.npz")


def convert(src: str, out: str) -> int:
    """Convert ``src`` (orbax directory) to ``out`` (.npz); returns the
    number of parameters."""
    import numpy as np

    from amw_tpu.models import htdemucs_jax as hj
    from amw_tpu_torch.models import htdemucs as ht

    jcfg, params = hj.load_params(os.path.abspath(src))
    cfg = ht._config_from_vec(hj._config_vec(jcfg))
    state = {k: np.asarray(v, np.float32) for k, v in params.items()}
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    ht.save_params(state, out, cfg)
    cfg2, state2 = ht.load_params(out)  # the port's own check of the file
    assert np.array_equal(ht._config_vec(cfg2), hj._config_vec(jcfg))
    assert set(state2) == set(state)
    return sum(int(v.size) for v in state.values())


def main(argv) -> int:
    src = argv[1] if len(argv) > 1 else SRC
    out = argv[2] if len(argv) > 2 else OUT
    n = convert(src, out)
    print(f"{src} -> {out}: {n} parameters, "
          f"{os.path.getsize(out)} bytes")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
