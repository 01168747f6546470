"""Parameters between the JAX package and the port.

A graph's parameters are a nested list of float32 arrays (filter
responses, the LUFS target, the staged FFT's plan tables) — the op
"weights".  The JAX package's builders return them as numpy arrays (its
Pallas-route plan tables as device arrays); the port's builders return the
same nesting, and :func:`to_device` turns either into tensors on a device.
"""

from __future__ import annotations

import numpy as np
import torch


def to_device(params, device, _seen=None):
    """The same nesting as ``params`` (lists, tuples, arrays, tensors,
    scalars and ``None``), with every array as a tensor on ``device``.  An
    array object that occurs more than once (the plan tables that several
    fused sites share) becomes one tensor."""
    seen = {} if _seen is None else _seen
    if isinstance(params, (list, tuple)):
        return [to_device(p, device, seen) for p in params]
    if params is None:  # the analysis graph's (packed response, None)
        return None
    key = id(params)
    if key not in seen:
        if isinstance(params, torch.Tensor):
            t = params.to(device)
        else:
            a = np.asarray(params)
            t = torch.as_tensor(a if a.flags.writeable else a.copy(),
                                device=device)
        seen[key] = (params, t)  # keeps params alive, so its id stays its own
    return seen[key][1]


def params_from_jax(params, device=None):
    """The port's params from the nested list that a JAX package graph
    builder returns (numpy arrays; on its Pallas route also the device
    arrays of ``fft_pallas.plan_params``), as tensors on ``device``
    (default ``cuda``) in the same nesting.  Three builders are mirrored:
    ``amw_tpu.models.pipeline_v1.build_v1_pipeline`` (one list per stage),
    ``amw_tpu.models.v2_job.build_v2_job_graph`` (one list per stage,
    the chain's modules among them, then ``[[Hk]]``: the K-weighting
    response of the before/after loudness meter; a linear-phase target
    curve's params are ``[ir]``, its FIR taps), and the ``Hk`` pair of
    ``amw_tpu.models.analyze._analysis_graph``: ``(permuted response,
    plan tables)`` on the Pallas route, ``(packed response, None)``
    elsewhere, which ``models.analyze``'s graph takes as its ``Hk``."""
    from . import resolve_device

    return to_device(params, resolve_device(device))


def htdemucs_from_jax(params: dict, cfg=None, *, device=None, dtype=None):
    """The port's htdemucs network (``models.htdemucs.HTDemucs``, frozen,
    in eval mode) on ``device`` (default ``cuda``) from the JAX package's
    parameter dict (``htdemucs_jax.init_params`` / ``load_params`` /
    ``params_from_torch_state``: numpy arrays under the upstream names, in
    the torch layouts, so each array is taken as it is).  ``cfg``: the
    port's ``HTConfig`` (default the released shape); ``dtype``: the
    weights' inference dtype (default ``htdemucs.inference_dtype``)."""
    from .models import htdemucs

    state = {k: torch.from_numpy(np.array(v, np.float32))
             for k, v in params.items()}
    return htdemucs.inference_model(cfg or htdemucs.HTConfig(), state,
                                    device=device, dtype=dtype)
