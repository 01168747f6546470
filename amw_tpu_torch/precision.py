"""Full-f32 matrix products on the card: TF32 off around a block.

cuBLAS and cuDNN take TF32 (a 10-bit mantissa) for float32 matmuls and
convolutions where PyTorch's process-wide switches allow it
(``torch.backends.cuda.matmul.allow_tf32``, ``torch.backends.cudnn.
allow_tf32``).  Where the port must compute in float32 (an f32 htdemucs
forward or training step, the matmul FFT of ``ops/fft_mxu.py``),
:func:`full_f32` switches both off for the block and restores them after,
under one re-entrant lock: the switches are global, and the engine serves
requests in threads.
"""

from __future__ import annotations

import contextlib
import threading

import torch

_F32_LOCK = threading.RLock()


@contextlib.contextmanager
def full_f32(dtype: torch.dtype = torch.float32):
    """Full-f32 convolutions and matmuls inside the block (TF32 off in
    cuDNN and cuBLAS), serialised; for another ``dtype`` (a bf16 forward)
    nothing changes.  The two switches are set and restored by hand:
    ``torch.backends.cudnn.flags`` would also reset the other cuDNN
    switches to its own defaults."""
    if dtype != torch.float32:
        yield
        return
    with _F32_LOCK:
        prev = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            yield
        finally:
            (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32) = prev
