"""PyTorch/CUDA port of the mastering framework (``amw_tpu``).

The JAX package ``amw_tpu`` is the reference; this package mirrors its
module layout (``ops/``, ``models/``) in PyTorch and replaces each Pallas
TPU kernel on the ported path with a CUDA kernel written for Hopper
(``csrc/``, built and bound by ``ops/_cuda.py``).

Layout at the public functions is the JAX package's: a track is
``[C, N]``; where the JAX code is batched by ``vmap``, the port takes an
explicit leading batch axis ``[B, C, N]``.

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``; with no GPU and no explicit CPU request they raise.
"""

from __future__ import annotations

import torch

from .spec import GraphSpec

__all__ = ["GraphSpec", "resolve_device"]

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless given.

    Raises ``RuntimeError`` when CUDA is asked for (explicitly or by
    default) and no GPU is present — there is no silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "amw_tpu_torch: CUDA device requested but torch.cuda."
            "is_available() is False; pass device='cpu' to run the plain "
            "PyTorch path on the CPU")
    return dev
