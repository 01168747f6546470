"""The control's precision: the reference with every stage's output and
the meters' intermediates rounded to bfloat16, the step below the
float32 that the configurations state."""

from __future__ import annotations

import numpy as np


def bfloat16(a):
    """``a`` rounded to the nearest bfloat16 (ties to even), as float64."""
    f = np.asarray(a, np.float64).astype(np.float32)
    u = f.view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


ROUNDING = {"float64": None, "bfloat16": bfloat16}
