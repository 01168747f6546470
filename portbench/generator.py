"""The one traffic generator: a pool of bucket-padded batches of test
material, made on the device from the seed.

A traffic file gives the parameters:

- ``batch``, ``pool``, ``bucket_s``: the batches, how many distinct ones
  the loop cycles through, and the bucket every track is padded to;
- ``valid_s`` ``[lo, hi]``: each track's valid length, drawn from the
  seed at sample resolution on ``(lo, hi]``; the lengths of a batch come
  in pairs ``mid +- d`` about the middle of the range, so every batch
  (and every seed) masters the same audio seconds;
- ``material``: the shape of the JAX package's bench generator
  (``make_track``: partials, noise, a slow amplitude envelope
  ``1 - depth + depth |sin|``, the right channel a scaled copy, a clip),
  with the partials (Hz, amplitude), the noise level, the envelope's
  rate and depth, the right channel's gain and the clip level given
  here; each track has its own phases and noise.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def valid_lengths(traffic: dict, sr: int, g: np.random.Generator
                  ) -> np.ndarray:
    """One batch's ``batch`` valid lengths (samples), in the order ``g``
    draws: ``batch / 2`` pairs ``mid + d``, ``mid - d`` about
    ``mid = lo + half`` (``half = (hi - lo) // 2``), ``d`` uniform on
    ``[0, half)``, so each length lies on ``(lo, hi]`` and the batch holds
    ``batch * mid`` samples whatever the seed."""
    lo, hi = (int(round(float(v) * sr)) for v in traffic["valid_s"])
    b = int(traffic["batch"])
    if b % 2:
        raise ValueError("portbench: valid lengths come in pairs; "
                         f"a batch of {b} is odd")
    half = (hi - lo) // 2
    d = g.integers(0, half, b // 2)
    lens = np.concatenate([lo + half + d, lo + half - d]).astype(np.int64)
    return np.minimum(g.permutation(lens),
                      int(round(float(traffic["bucket_s"]) * sr)))


def make_pool(traffic: dict, sr: int, channels: int, seed: int, device):
    """``(x, nv)``: ``x`` float32 [pool, batch, channels, N] on ``device``
    (zero past each track's valid length) and ``nv`` int64 numpy
    [pool, batch], from ``seed``."""
    g = np.random.default_rng(abs(int(seed)))
    mat = traffic["material"]
    pool, b = int(traffic["pool"]), int(traffic["batch"])
    n = int(round(float(traffic["bucket_s"]) * sr))
    nv = np.stack([valid_lengths(traffic, sr, g) for _ in range(pool)])
    freqs = np.asarray(mat["partials_hz"], np.float64)
    amps = np.asarray(mat["partial_amps"], np.float64)
    phases = g.uniform(0.0, 2.0 * math.pi, (pool, b, len(freqs) + 1))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(g.integers(0, 2 ** 62)))
    t = torch.arange(n, dtype=torch.float64, device=device) / sr
    x = torch.zeros((pool, b, channels, n), dtype=torch.float32,
                    device=device)
    for p in range(pool):
        for i in range(b):
            ph = phases[p, i]
            s = float(mat["noise"]) * torch.randn(
                n, generator=gen, dtype=torch.float32, device=device
            ).to(torch.float64)
            for f, a, phi in zip(freqs, amps, ph):
                s += a * torch.sin(2.0 * math.pi * f * t + phi)
            depth = float(mat["am_depth"])
            env = (1.0 - depth) + depth * torch.sin(
                2.0 * math.pi * float(mat["am_hz"]) * t + ph[-1]).abs()
            s = s * env
            clip = float(mat["clip"])
            gains = [1.0, float(mat["right_gain"])][:channels]
            for c, gain in enumerate(gains):
                x[p, i, c, :nv[p, i]] = (gain * s[:nv[p, i]]).clamp(
                    -clip, clip).to(torch.float32)
    return x, nv
