"""Time the end-to-end runs of ``chip_smoke.py`` with the ``amw_tpu_torch``
package found in the current directory, on one GPU: the v1 ``standard``
chain on 8 stereo tracks of 5 s and of 180 s (the latter also on the split
route, ``AMW_FFT_FUSED_RT=0``), and the v2 job on 8 stereo
tracks of 180 s, one mono 180 s track, one 2 s stereo clip and one stereo
180 s track with the chain-config options (the inputs, configs and pro set
of the current directory's ``chip_smoke.py``).

    cd <checkout> && python <this file> [run ...]

(the runs named, by default all seven).

It compares two checkouts on one card: run it in the parent's and the
change's checkout in turns (parent, change, change, parent) within one
machine, as ``ab_env.py``.  Prints one JSON line: the checkout, the card's
name and power limit (``nvidia-smi``), and for each run the steady-state
wall per batch (host clock over ``reps`` batches after 2 warm-up batches,
synchronised), the device time per batch (torch.profiler over 2 batches:
the sum of the device events), the device's idle share of the wall, and
the de-esser's box smoother's device time (kernel 1) and its env-gain
kernel's (kernel 2), the envelope followers' (kernels 2′ and 3 together:
one template instance) and the reduce kernels' (11 and 12,
``reduce_kernel<true/false>``), and the
host's ten costliest operations (self CPU ms per batch,
calls per batch).  No output is checked here: ``chip_smoke.py`` does.
"""

from __future__ import annotations

import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from amw_tpu_torch import GraphSpec  # noqa: E402
from amw_tpu_torch.models import (build_v1_pipeline,  # noqa: E402
                                  build_v2_job_graph)
from amw_tpu_torch.ops import _cuda  # noqa: E402

# kernel 1's device events (the kernel before the register walk, the walk's
# instances, the generic path)
KERNEL_1 = ("box_smooth_kernel", "box_walk_kernel", "box_generic_kernel")
# kernel 2's and the envelope followers' (2′, 3) device events, by the
# names of the kernels before the staged walk and of its instances
KERNEL_2 = ("env_gain_kernel", "DeesserGain>")
FOLLOWERS = ("env_scan_kernel", "env_rows_kernel", "Envelope>")
# kernels 11 and 12 (PyTorch's own reductions are reduce_kernel<512, ...>)
REDUCE = ("reduce_kernel<true>", "reduce_kernel<false>")


def _smoke():
    """The current directory's ``chip_smoke.py`` (the checkout timed),
    importing the package of the current directory."""
    path = Path(os.getcwd()) / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("_ab_walls_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _device_ms(step, reps: int = 2) -> dict:
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    out = {"busy": 0.0, "kernel_1": 0.0, "kernel_2": 0.0, "followers": 0.0,
           "reduce": 0.0}
    host = []
    for evt in prof.key_averages():
        if str(getattr(evt, "device_type", "")).split(".")[-1] != "CUDA":
            host.append((evt.key[:60], evt.self_cpu_time_total / 1e3 / reps,
                         evt.count / reps))
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        ms = dev_us / 1e3 / reps
        out["busy"] += ms
        if any(k in evt.key for k in KERNEL_1):
            out["kernel_1"] += ms
        if any(k in evt.key for k in KERNEL_2):
            out["kernel_2"] += ms
        if any(k in evt.key for k in FOLLOWERS):
            out["followers"] += ms
        if any(k in evt.key for k in REDUCE):
            out["reduce"] += ms
    out["host_top"] = sorted(host, key=lambda h: -h[1])[:10]
    return out


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("ab_walls: needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    _cuda.build()
    cs = _smoke()
    dev = torch.device("cuda")
    out = {"checkout": os.getcwd(), "nvidia_smi": smi}
    long_s, long_valid = cs.LONG
    runs = [
        ("v1_5s", "v1", cs.SHORT[0], cs.SHORT[1], cs.BATCH, 2, "standard",
         False, 20),
        ("v1_180s", "v1", long_s, long_valid, cs.BATCH, 2, "standard",
         False, 5),
        ("v1_180s_split", "v1", long_s, long_valid, cs.BATCH, 2, "standard",
         False, 5),
        ("v2_180s", "v2", long_s, long_valid, cs.BATCH, 2, "standard",
         False, 3),
        ("v2_mono_180s", "v2", long_s, (), 1, 1, "podcast", False, 5),
        ("v2_clip_2s", "v2", cs.SHORT_CLIP_S, (), 1, 2, "edm", False, 20),
        ("v2_options_180s", "v2", long_s, (), 1, 2, "standard", True, 5),
    ]
    only = set(sys.argv[1:])
    for label, kind, dur, valid, batch, ch, style, options, reps in runs:
        if only and label not in only:
            continue
        n = int(cs.SR * dur)
        xb, nv = cs.make_batch(dur, valid, batch, ch, seed0=10)
        spec = GraphSpec(sr=cs.SR, n=n, channels=ch)
        if kind == "v1":
            params, fn, _ = build_v1_pipeline(
                spec, target_lufs=cs.TARGET_LUFS, style=style, device=dev)
        else:
            params, fn, _ = build_v2_job_graph(
                spec, cs.options_config() if options else None, cs.V2_PRO,
                cs.STYLE_CONFIGS[style]["lufs"], style, device=dev)
        x_d = torch.from_numpy(xb).to(dev)
        nv_d = torch.from_numpy(nv).to(dev)

        def step():
            return fn(x_d, params, nv_d)

        with torch.no_grad(), cs.fft_route(label.endswith("_split")):
            for _ in range(2):
                step()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                step()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / reps * 1e3
            dev_ms = _device_ms(step)
        out[label] = {"wall_ms": wall_ms, "reps": reps,
                      "device_ms": dev_ms["busy"],
                      "idle_share": 1.0 - dev_ms["busy"] / wall_ms,
                      "kernel_1_ms": dev_ms["kernel_1"],
                      "kernel_2_ms": dev_ms["kernel_2"],
                      "followers_ms": dev_ms["followers"],
                      "reduce_ms": dev_ms["reduce"],
                      "host_top": dev_ms["host_top"]}
        del params, fn, x_d, nv_d
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
