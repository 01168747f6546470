"""Entry ``graph_batch``: a closed loop of bucket-padded batches through a
job graph's ``fn(x, params, n_valid)``, each step ending when its results
are on the host (the v2 job's four stats per track, as the engine reads
them; the v1 pipeline, which returns only audio, ends on a synchronise).

The configuration names the graph (``v2_job``:
``amw_tpu_torch.models.v2_job.build_v2_job_graph``; ``v1_pipeline``:
``amw_tpu_torch.models.pipeline_v1.build_v1_pipeline``) and its knobs;
the traffic file the batches (``portbench/generator.py``).  The outputs
kept for the check are those of the last step on the pool's batch that
the seed draws, and of two of its tracks: the longest and one drawn from
the other half of the batch.
"""

from __future__ import annotations

import numpy as np
import torch

from portbench import generator as gen


def pick(traffic: dict, nv: np.ndarray, seed: int) -> tuple:
    """``(pool index, [track indices])`` checked in a run of ``seed``."""
    g = np.random.default_rng([abs(int(seed)), 1])
    j = int(g.integers(int(traffic["pool"])))
    b = nv.shape[1]
    longest = int(np.argmax(nv[j]))
    other = np.arange(b // 2, b) if longest < b // 2 else np.arange(b // 2)
    return j, [longest, int(g.choice(other))]


def build_graph(config: dict, spec, device):
    if config["graph"] == "v2_job":
        from amw_tpu_torch.models.v2_job import build_v2_job_graph

        params, fn, _ = build_v2_job_graph(
            spec, None, dict(config["pro"]), float(config["target_lufs"]),
            config["style"], device=device)
    elif config["graph"] == "v1_pipeline":
        from amw_tpu_torch.models.pipeline_v1 import build_v1_pipeline

        params, fn, _ = build_v1_pipeline(
            spec, float(config["target_lufs"]), config["style"],
            device=device)
    else:
        raise ValueError(f"portbench: no graph {config['graph']!r}")
    return params, fn


class Entry:
    def __init__(self, cell, seed: int, device):
        from amw_tpu_torch.spec import GraphSpec

        cfg, tr = cell.config, cell.traffic
        self.device = torch.device(device)
        self.sr = int(cfg["sr"])
        self.reports = cfg["graph"] == "v2_job"
        n = int(round(float(tr["bucket_s"]) * self.sr))
        spec = GraphSpec(sr=self.sr, n=n, channels=int(cfg["channels"]),
                         exact=bool(cfg["exact"]))
        if self.device.type == "cuda":
            from amw_tpu_torch.ops import _cuda

            _cuda.build()
        self.x, self.nv = gen.make_pool(tr, self.sr, spec.channels, seed,
                                        self.device)
        self.nv_dev = torch.as_tensor(self.nv, dtype=torch.int32,
                                      device=self.device)
        self.params, self.fn = build_graph(cfg, spec, self.device)
        self.j, self.tracks = pick(tr, self.nv, seed)
        self.kept = None
        self.attempted = 0
        self.failed = 0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self):
        """Every shape the loop uses: the graph at the bucket, twice."""
        for _ in range(2):
            with torch.inference_mode():
                self.fn(self.x[0], self.params, self.nv_dev[0])
            self._sync()

    def step(self, i: int) -> float:
        """Master batch ``i`` of the loop; returns its valid seconds."""
        p = i % self.x.shape[0]
        with torch.inference_mode():
            res = self.fn(self.x[p], self.params, self.nv_dev[p])
            if self.reports:
                stats = torch.stack(
                    [res["before_lufs"], res["after_lufs"], res["peak"],
                     res["finite"].to(torch.float32)]).cpu().numpy()
                self.failed += int(np.sum(stats[3] < 1.0))
            else:
                stats = None
                self._sync()
        self.attempted += self.x.shape[1]
        if p == self.j:
            self.kept = (res, stats)
        return float(self.nv[p].sum()) / self.sr

    def samples(self) -> list:
        """The checked tracks: input (valid samples) and what the graph
        returned for them, on the host."""
        res, stats = self.kept
        out = res["out"] if self.reports else res
        got = []
        for b in self.tracks:
            nv = int(self.nv[self.j, b])
            s = {"input": self.x[self.j, b, :, :nv].cpu().double().numpy(),
                 "out": out[b].cpu().double().numpy(), "n_valid": nv}
            if self.reports:
                s.update(before_lufs=float(stats[0, b]),
                         after_lufs=float(stats[1, b]),
                         peak=float(stats[2, b]), finite=bool(stats[3, b]))
            got.append(s)
        return got

    def close(self):
        self.x = self.params = self.kept = self.nv_dev = None
        self.fn = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
