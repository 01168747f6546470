"""Mastering execution engine: graph cache and job runners (counterpart of
``amw_tpu/runtime/engine.py``).

Each job resolves to a cached graph keyed by (sample rate, length bucket,
channels, chain/pro configuration).  Variable track lengths hit a small set
of buckets (``parallel/batch.DEFAULT_BUCKETS_SEC``), whose graphs then
serve every length below them through ``n_valid``; the loudness target is
baked into the graph's params.  Concurrent v2 jobs that share a graph run
as one batched call through the micro-batcher (``runtime/batcher.py``).

Per request: decode the upload on the host, pick a bucket, pad; stack
with the other requests of the micro-batch and upload the batch in one
copy; run the graph once; read back the four stats of each track
(loudness before and after, peak, finite); validate; export each track
from its device slice (dither and int16 on the device,
``utils/audio_io.export_audio``) and encode on the host.

Serving mesh (``parallel/mesh.py``), as the JAX engine's: on a host with
more than one GPU the engine builds a mesh of its local GPUs (or takes the
``mesh`` it is given, such as four positions on one card), micro-batches
split data-parallel over the mesh's first axis (each position runs the
graph on its slice with the params on its device, placed once per
distinct device), and uploads longer than ``engine_sp_threshold_sec``
(600 s: DJ sets) are time-sharded over the positions
(``_master_v2_sp``, ``parallel/timeshard.py``, the counterpart of
``amw_tpu/parallel/timeshard.py``).  A CPU engine, or one on a host with
one GPU, builds no mesh and serves as before.  Where
``engine_coordinator`` is set, the engine first joins the pod's process
group (``parallel/mesh.init_distributed``), and raises where the join
fails.

Entry points run on ``cuda`` unless the engine is made with
``device="cpu"``; without a GPU a default engine raises
(``amw_tpu_torch.resolve_device``).  Nothing falls back to the CPU: a
batch that fails sets its exception on every request of the batch.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from collections import OrderedDict

import numpy as np
import torch

from .. import resolve_device
from ..convert import to_device
from ..models.chain import as_batch
from ..models.pipeline_v1 import build_v1_pipeline
from ..models.v2_job import build_v2_job_graph
from ..ops import basic, fft_staged, meters, validctx
from ..spec import GraphSpec
from ..utils.audio_io import (add_seconds, export_audio,
                              load_audio_from_bytes)
from . import progress as prog_mod
from . import settings_store
from .batcher import Batcher
from .config import settings

_SILENT_MSG = (
    "Processing produced silence. Disable some of the extra modules "
    "(Spectral Denoiser, De-esser, Transient Designer, Parallel Compression, "
    "Dynamic EQ) and try again."
)
_NANINF_MSG = (
    "Processing produced invalid values (NaN/Inf). Disable Dynamic EQ or "
    "other extra modules and try again."
)
_log = logging.getLogger("amw_tpu_torch.engine")
_profile_seq = itertools.count()


class ValidationError(ValueError):
    pass


@contextlib.contextmanager
def _maybe_profile(tag: str):
    """A ``torch.profiler`` Chrome trace of the block, written to
    ``$AMW_PROFILE_DIR/<tag>/<pid>-<seq>.json`` when ``AMW_PROFILE_DIR`` is
    set (where the JAX engine writes an xprof trace).  One profiler runs at
    a time in a process."""
    prof_dir = os.environ.get("AMW_PROFILE_DIR")
    if not prof_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out_dir = os.path.join(prof_dir, tag)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(
        os.path.join(out_dir, f"{os.getpid()}-{next(_profile_seq)}.json"))


class MasteringEngine:
    """Thread-safe cache of mastering graphs on one device, and the job
    runners.  ``device``: ``None`` for ``cuda`` (raises without a GPU), or
    ``"cpu"`` for the plain path."""

    # Tracks shorter than this (seconds) run at their exact length: the
    # valid-end dynamic edge windows (ops.validctx) need the valid region
    # to dominate the largest filter settle window.
    MIN_BUCKET_SEC = 3.0

    def __init__(self, exact: bool | None = None, bucket: bool = True,
                 micro_batch: bool | None = None, *, device=None,
                 mesh=None):
        self.device = resolve_device(device)
        self.exact = settings.engine_exact_mode if exact is None else exact
        self.bucket = bucket
        self.micro_batch = (settings.engine_micro_batch
                            if micro_batch is None else micro_batch)
        self._join_pod()
        self.mesh = mesh if mesh is not None else self._serving_mesh()
        n_mesh = self.mesh.devices.size if self.mesh is not None else 1
        # LRU-capped: every distinct (bucket, chain-config, target, style)
        # signature builds its own graph whose params pin device memory;
        # unbounded custom configs would otherwise leak.
        self._cache: OrderedDict = OrderedDict()
        self._cache_cap = 32
        # Sequence-parallel graphs are built per track length (the edge
        # windows need static lengths), so distinct long uploads rarely
        # share one: their own small LRU, so that a burst of DJ-set jobs
        # cannot evict the bucketed graphs.
        self._sp_cache: OrderedDict = OrderedDict()
        self._sp_cache_cap = 4
        self._dur_ema: dict = {}  # graph key -> EMA of run wall time (sec)
        self._lock = threading.Lock()
        self._local = threading.local()  # the calling thread's timings
        self._batcher = None
        self.last_batch_info: dict | None = None
        if self.micro_batch:
            # per-batch capacity scales with the mesh: 8 tracks a position
            self._batcher = Batcher(
                self._run_v2_batch,
                window_ms=settings.engine_batch_window_ms,
                max_batch=settings.engine_max_micro_batch * n_mesh)
            self._batcher.start()

    @staticmethod
    def _join_pod() -> None:
        """The JAX engine's join: with ``engine_mesh`` on and
        ``engine_coordinator`` set, join the pod's process group
        (``parallel/mesh.init_distributed``) before the serving mesh is
        built.  A failed join raises (the JAX engine swallows it and
        serves alone: ``runtime/config.py`` says why the port does not)."""
        if not (settings.engine_mesh and settings.engine_coordinator):
            return
        from ..parallel import mesh as mesh_mod

        mesh_mod.init_distributed(
            settings.engine_coordinator,
            settings.engine_num_processes or None,
            None if settings.engine_process_id < 0
            else settings.engine_process_id)

    def _serving_mesh(self):
        """The JAX engine's rule: with ``engine_mesh`` on, a mesh of this
        process's GPUs where it has more than one; else ``None``.  In a
        pod the serving mesh stays over the process's own GPUs: a request
        lands on one process (docs/SCALING.md)."""
        if not settings.engine_mesh or self.device.type != "cuda":
            return None
        from ..parallel.mesh import make_mesh

        if torch.cuda.device_count() > 1:
            return make_mesh(local_only=True)
        return None

    def close(self) -> None:
        """Stop the micro-batcher's thread."""
        if self._batcher is not None:
            self._batcher.stop()

    def last_timings(self) -> dict:
        """Seconds by part of the calling thread's last request: ``decode``
        (upload decode and padding), ``vocal``, ``build`` (graph params),
        ``queue`` (submit to the batch's start, ``stack`` included),
        ``stack``, ``h2d``, ``graph`` (the call and the stats' read-back),
        ``export``, ``d2h``, ``encode``; those the request went through."""
        return dict(getattr(self._local, "timings", {}))

    def _start_timings(self) -> dict:
        self._local.timings = {}
        return self._local.timings

    # -- graph cache -------------------------------------------------------

    def _get_graph(self, kind: str, spec, key_extra: str, build):
        key = (kind, spec, key_extra)
        cache = self._sp_cache if kind == "sp" else self._cache
        cap = self._sp_cache_cap if kind == "sp" else self._cache_cap
        with self._lock:
            hit = cache.get(key)
            if hit is not None:
                cache.move_to_end(key)
                return hit
        built = build()
        with self._lock:
            cache.setdefault(key, built)
            cache.move_to_end(key)
            while len(cache) > cap:
                cache.popitem(last=False)
            return cache[key]

    def _note_duration(self, ema_key, dt: float) -> None:
        """EMA of a graph's wall time for progress interpolation; bounded
        (oldest-inserted entries dropped) so unbounded distinct configs
        don't leak key strings.  Locked: concurrent job threads write
        here."""
        with self._lock:
            prev = self._dur_ema.get(ema_key)
            self._dur_ema[ema_key] = (dt if prev is None
                                      else 0.7 * prev + 0.3 * dt)
            while len(self._dur_ema) > 4 * self._cache_cap:
                self._dur_ema.pop(next(iter(self._dur_ema)), None)

    def _get_duration(self, ema_key) -> float | None:
        with self._lock:
            return self._dur_ema.get(ema_key)

    def _spec_for(self, sr: int, n: int, channels: int):
        if self.bucket and n >= int(self.MIN_BUCKET_SEC * sr):
            from ..parallel.batch import DEFAULT_BUCKETS_SEC

            bn = n
            # Ladder cap (engine_max_bucket_sec): the long buckets trade
            # padded compute for shared graphs; beyond the cap uploads run
            # at exact length.
            max_sec = float(settings.engine_max_bucket_sec or 0)
            for s in DEFAULT_BUCKETS_SEC:
                if max_sec and s > max_sec:
                    break
                cand = int(round(s * sr))
                if cand >= n:
                    bn = cand
                    break
        else:
            bn = n
        return GraphSpec(sr=sr, n=bn, channels=channels, exact=self.exact)

    @staticmethod
    def _pad(x: np.ndarray, n_bucket: int) -> np.ndarray:
        pad = n_bucket - x.shape[-1]
        if pad <= 0:
            return x
        return np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, pad)])

    # -- running a graph -----------------------------------------------------

    def _execute(self, fn, params, xb: np.ndarray, nvb: np.ndarray,
                 prog_tok=None) -> list:
        """One call of a job graph on the host batch ``xb`` [B, C, N] with
        valid lengths ``nvb`` [B]: one upload, the call, one read-back of
        the four stats.  Per track a dict with its output (a view of the
        batch on the device), its stats and the batch's timings."""
        tm = {}
        t0 = time.perf_counter()
        x = torch.from_numpy(np.ascontiguousarray(xb, np.float32)).to(
            self.device)
        nv = torch.from_numpy(np.asarray(nvb, np.int32)).to(self.device)
        t0 = add_seconds(tm, "h2d", t0)
        res = fn(x, params, nv, prog_tok)
        stats = torch.stack([res["before_lufs"], res["after_lufs"],
                             res["peak"], res["finite"].to(torch.float32)]
                            ).cpu().numpy()
        add_seconds(tm, "graph", t0)
        return [{"out": res["out"][i], "before_lufs": stats[0, i],
                 "after_lufs": stats[1, i], "peak": stats[2, i],
                 "finite": bool(stats[3, i]), "timings": tm}
                for i in range(xb.shape[0])]

    def _execute_mesh(self, fn, placed: dict, xb: np.ndarray,
                      nvb: np.ndarray) -> list:
        """:meth:`_execute` split data-parallel over the mesh's first axis
        (``parallel/mesh.shard_batch``): each position runs the graph on
        its slice of the batch with the params on its device (``placed``);
        every call is launched before the stats are read back, so
        positions on different devices run at once.  The tracks in order,
        with the step's timings."""
        from ..parallel.mesh import axis_devices, shard_batch

        tm = {}
        t0 = time.perf_counter()
        xs = shard_batch(np.asarray(xb, np.float32), self.mesh)
        nvs = shard_batch(np.asarray(nvb, np.int32), self.mesh)
        t0 = add_seconds(tm, "h2d", t0)
        results = [fn(x, placed[d], nv, None) for d, x, nv in
                   zip(axis_devices(self.mesh), xs, nvs)]
        items = []
        for res in results:
            stats = torch.stack([res["before_lufs"], res["after_lufs"],
                                 res["peak"],
                                 res["finite"].to(torch.float32)]
                                ).cpu().numpy()
            items += [{"out": res["out"][i], "before_lufs": stats[0, i],
                       "after_lufs": stats[1, i], "peak": stats[2, i],
                       "finite": bool(stats[3, i]), "timings": tm}
                      for i in range(stats.shape[1])]
        add_seconds(tm, "graph", t0)
        return items

    # -- job runners -------------------------------------------------------

    def master_v2_bytes(
        self, data: bytes, filename: str, *,
        target_lufs: float, out_format: str = "wav", style: str = "standard",
        chain_config: dict | None = None, dither_type: str | None = None,
        auto_blank_sec: float | None = None, bitrate: int | None = None,
        pro: dict | None = None, progress=None,
    ) -> dict:
        """Full v2 job: decode → graph (micro-batched) → validate →
        export.  Returns ``{"bytes", "sr", "before_lufs", "after_lufs"}``."""
        tm = self._start_timings()
        report = progress or (lambda pct, msg: None)
        with torch.inference_mode():
            t0 = time.perf_counter()
            report(2, "Loading audio…")
            audio, sr = load_audio_from_bytes(data, filename or "wav")
            t0 = add_seconds(tm, "decode", t0)
            if (pro or {}).get("apply_vocal_isolation"):
                if not settings_store.get_setting_bool(
                        "vocal_isolation_enabled",
                        settings.vocal_isolation_enabled):
                    raise RuntimeError(
                        "Vocal isolation is disabled on this server")
                report(3, "Vocal isolation…")
                from ..models import vocal

                # on a serving mesh the network's window groups split
                # over its first axis (htdemucs.separate_mesh)
                audio = vocal.isolate_vocal(audio, sr, device=self.device,
                                            mesh=self.mesh)
                pro = {k: v for k, v in pro.items()
                       if k != "apply_vocal_isolation"}
                t0 = add_seconds(tm, "vocal", t0)
            n, C = audio.shape[-1], audio.shape[0]
            if (self.mesh is not None
                    and n > int(settings.engine_sp_threshold_sec * sr)):
                # DJ-set-length upload: time-shard the one track over the
                # serving mesh instead of one huge single-device graph
                sp = self._sp_graph(audio, sr, target_lufs=target_lufs,
                                    style=style, chain_config=chain_config,
                                    pro=pro)
                if sp is not None:
                    add_seconds(tm, "build", t0)
                    return self._master_v2_sp(
                        audio, sr, sp, out_format=out_format,
                        chain_config=chain_config, dither_type=dither_type,
                        auto_blank_sec=auto_blank_sec, bitrate=bitrate,
                        report=report)
            spec = self._spec_for(sr, n, C)
            key = json.dumps(
                {"cfg": chain_config, "pro": pro, "style": style,
                 "t": round(float(target_lufs), 2)},
                sort_keys=True, default=str)
            report(5, "Mastering (v2)…")
            use_ticks = (progress is not None and self._batcher is None
                         and prog_mod.callbacks_supported())
            params, fn, names, _ = self._get_graph(
                "v2", spec, key,
                lambda: self._built_v2(spec, chain_config, pro, target_lufs,
                                       style))
            t0 = add_seconds(tm, "build", t0)
            xb = self._pad(np.ascontiguousarray(audio, np.float32), spec.n)
            t0 = add_seconds(tm, "decode", t0)
            nv = np.int32(n)
            ema_key = ("v2", spec, key)
            t_run = time.monotonic()
            with _maybe_profile("master_v2"):
                if self._batcher is not None:
                    ema = self._get_duration(ema_key) if progress else None
                    # Memory-derived batch cap: B=8 at the 180 s bucket is
                    # the validated working set of a position; longer
                    # buckets batch fewer tracks (a 600 s bucket caps at
                    # 2), and a serving mesh multiplies the cap by its
                    # positions.
                    n_mesh = (self.mesh.devices.size
                              if self.mesh is not None else 1)
                    cap = n_mesh * max(
                        1, int((8 * 180 * 44100) // max(spec.n, 1)))
                    with prog_mod.TimedTicker(names, report, ema):
                        res = self._batcher.submit(
                            ("v2", spec, key), xb, aux=nv,
                            max_batch=cap).result(timeout=600.0)
                    self._note_duration(ema_key, time.monotonic() - t_run)
                    tm["queue"] = res["t_start"] - t0
                elif use_ticks:
                    tok = prog_mod.register(names, report)
                    try:
                        res = self._execute(fn, params, xb[None], nv[None],
                                            tok)[0]
                    finally:
                        prog_mod.unregister(tok)
                else:
                    # no progress callback: interpolate stage progress
                    # against this graph's measured wall time
                    ema = self._get_duration(ema_key) if progress else None
                    with prog_mod.TimedTicker(names, report, ema):
                        res = self._execute(fn, params, xb[None],
                                            nv[None])[0]
                    self._note_duration(ema_key, time.monotonic() - t_run)
            tm.update(res["timings"])
            return self._finish_v2(
                res["out"][..., :n], sr, res, report, out_format=out_format,
                chain_config=chain_config, dither_type=dither_type,
                auto_blank_sec=auto_blank_sec, bitrate=bitrate)

    def _finish_v2(self, out, sr, res, report, *, out_format, chain_config,
                   dither_type, auto_blank_sec, bitrate) -> dict:
        """Shared v2 tail: validate the device stats, export, shape the
        reply."""
        before = float(res["before_lufs"])
        after = float(res["after_lufs"])
        peak = float(res["peak"])
        finite = bool(res["finite"])

        if out.numel() == 0 or peak < 1e-5:
            raise ValidationError(_SILENT_MSG)
        if not finite:
            raise ValidationError(_NANINF_MSG)

        report(98, "Exporting file…")
        dt = dither_type or (chain_config or {}).get("dither_type") or "tpdf"
        if dt not in ("tpdf", "ns_e", "ns_itu"):
            dt = "tpdf"
        ab = (auto_blank_sec if auto_blank_sec is not None
              else float((chain_config or {}).get("auto_blank_sec", 0) or 0))
        out_bytes = export_audio(out, sr, out_format.lower(), dither_type=dt,
                                 auto_blank_sec=max(0.0, ab), bitrate=bitrate,
                                 timings=self._local.timings)
        return {
            "bytes": out_bytes, "sr": sr,
            "before_lufs": None if before < -1e8 else before,
            "after_lufs": None if after < -1e8 else after,
        }

    def _sp_graph(self, audio, sr, *, target_lufs, style, chain_config,
                  pro):
        """``(graph, key)`` of the sequence-parallel v2 job for ``audio``
        (``graph``: ``build_sp_master``'s ``(fn, params, n_pad)``; ``key``:
        its cache key), or ``None`` where the time-shard builder rejects
        the job (a reverb IR wider than the halo, a non-uniform gating
        grid, a track too short for the positions), logged: the
        single-device graph then serves it, as in the JAX engine.

        Graphs are cached per (track length, config): the edge windows
        that make the output match the single-device graph need static
        lengths.  ``engine_sp_quantize_sec`` snaps the length up to a grid
        (the pad mastered as trailing silence, gated out of BS.1770, and
        sliced off), so that distinct long uploads share one graph."""
        from ..parallel.timeshard import build_sp_master

        C, n = audio.shape
        grid = int(float(settings.engine_sp_quantize_sec or 0) * sr)
        n_q = ((n + grid - 1) // grid) * grid if grid > 0 else n
        key = json.dumps(
            {"cfg": chain_config, "pro": pro, "style": style,
             "t": round(float(target_lufs), 2), "sp": True},
            sort_keys=True, default=str)
        try:
            graph = self._get_graph(
                "sp", (sr, n_q, C), key,
                lambda: build_sp_master(
                    sr, n_q, C, self.mesh, target_lufs=target_lufs,
                    style=style, chain_config=chain_config, pro=pro,
                    stats=True))
        except ValueError as e:
            _log.warning("sp path rejected config (%s); falling back to "
                         "the single-device graph", e)
            return None
        return graph, ("sp", (sr, n_q, C), key)

    def _master_v2_sp(self, audio, sr, sp, *, out_format, chain_config,
                      dither_type, auto_blank_sec, bitrate, report) -> dict:
        """Sequence-parallel v2 job: ONE long track time-sharded over the
        serving mesh (``parallel/timeshard.py``) through the graph of
        :meth:`_sp_graph` — the 800 MB DJ-set uploads of the reference
        (config.py:26-33) served across every position instead of one."""
        tm = self._local.timings
        (fn, params, n_pad), ema_key = sp
        n = audio.shape[-1]
        report(5, "Mastering (sequence-parallel)…")
        t0 = time.perf_counter()
        xp = np.pad(np.ascontiguousarray(audio, np.float32),
                    ((0, 0), (0, n_pad - n)))
        t0 = add_seconds(tm, "decode", t0)
        t_run = time.monotonic()
        with _maybe_profile("master_v2_sp"):
            ema = self._get_duration(ema_key)
            with prog_mod.TimedTicker(["sp_master"], report, ema):
                res = fn(xp, params)
                stats = {k: float(res[k]) for k in
                         ("before_lufs", "after_lufs", "peak", "finite")}
            self._note_duration(ema_key, time.monotonic() - t_run)
        add_seconds(tm, "graph", t0)
        return self._finish_v2(
            res["out"][..., :n], sr, stats, report, out_format=out_format,
            chain_config=chain_config, dither_type=dither_type,
            auto_blank_sec=auto_blank_sec, bitrate=bitrate)

    def warmup(self, buckets_sec=(180.0,), sr: int = 44100,
               target_lufs: float = -14.0, style: str = "standard") -> None:
        """Build (and run once on zeros) the default v2 graph for the given
        buckets, through the micro-batcher's path when it is on, so that
        the first production job finds its params and plans built.  Run
        from a background thread at service startup."""
        with torch.inference_mode():
            for sec in buckets_sec:
                try:
                    spec = GraphSpec(sr=sr, n=int(round(sec * sr)),
                                     channels=2, exact=self.exact)
                    key = json.dumps(
                        {"cfg": None, "pro": {}, "style": style,
                         "t": round(float(target_lufs), 2)},
                        sort_keys=True, default=str)
                    params, fn, _, _ = self._get_graph(
                        "v2", spec, key,
                        lambda: self._built_v2(spec, None, {}, target_lufs,
                                               style))
                    x = np.zeros((1, 2, spec.n), np.float32)
                    nv = np.asarray([spec.n], np.int32)
                    if self._batcher is not None:
                        self._run_v2_batch(("v2", spec, key), x, nv)
                    else:
                        self._execute(fn, params, x, nv)
                except Exception:  # noqa: BLE001 — warmup is best-effort
                    _log.warning("warmup failed for bucket %.0fs", sec,
                                 exc_info=True)
        # htdemucs: nothing to warm without a checkpoint (the DSP
        # separator); with one configured, its weights and one separation
        # a window-group bucket on the engine's device
        if buckets_sec:
            try:
                from ..models import vocal

                vocal.warmup_htdemucs(buckets_sec, device=self.device)
            except Exception:  # noqa: BLE001 — warmup is best-effort
                _log.warning("htdemucs warmup failed", exc_info=True)

    def _built_v2(self, spec, chain_config, pro, target_lufs, style):
        """``(params, fn, names, placed)``: the v2 graph on the engine's
        device, and with a serving mesh its params on every device of the
        mesh (:meth:`_put_params`).  A graph reports its stages only when
        a job hands it a token, so one graph a key serves jobs with ticks
        and without (the JAX engine compiles a second graph, keyed
        ";ticks", for them)."""
        params, fn, names = build_v2_job_graph(
            spec, chain_config, pro, target_lufs, style, device=self.device)
        return params, fn, names, self._put_params(params)

    def _put_params(self, params):
        """With a serving mesh, the params once on each distinct device of
        the mesh (``parallel/mesh.replicate``; already on the engine's
        device, they are not copied there), by device; else ``None``."""
        if self.mesh is None:
            return None
        from ..parallel.mesh import replicate

        return replicate(params, self.mesh)

    # -- micro-batching (see runtime/batcher.py) ---------------------------

    def _batch_size_for(self, b: int) -> int:
        """Batch width for ``b`` submitted tracks: the next power of two
        (the JAX engine's compiled widths; a burst of 3 runs as 4), rounded
        up to a multiple of the serving mesh's positions so that the split
        is even."""
        b_eff = 1 << (b - 1).bit_length()
        if self.mesh is not None:
            n_dev = self.mesh.devices.size
            b_eff = n_dev * (-(-b_eff // n_dev))
        return b_eff

    def _run_v2_batch(self, bkey, xb, nvb):
        t_start = time.perf_counter()
        with self._lock:
            entry = self._cache.get(bkey)
        if entry is None:
            # LRU-evicted between submit and batch execution (needs >cap
            # distinct graphs inside one 50 ms batch window).
            raise RuntimeError(
                "compiled graph evicted under cache pressure; retry the job")
        params, fn, _names, placed = entry
        b = xb.shape[0]
        b_eff = self._batch_size_for(b)
        nvb = np.asarray(nvb, np.int32)
        if b_eff != b:
            xb = np.concatenate(
                [xb, np.repeat(xb[:1], b_eff - b, axis=0)], axis=0)
            nvb = np.concatenate([nvb, np.repeat(nvb[:1], b_eff - b)])
        if self.mesh is None:
            items = self._execute(fn, params, xb, nvb)[:b]
            devices = 1
        else:
            # data-parallel serving step: the micro-batch split over the
            # mesh's first axis, the params on each position's device
            from ..parallel.mesh import axis_devices

            items = self._execute_mesh(fn, placed, xb, nvb)[:b]
            devices = len(axis_devices(self.mesh))
        # Observability: how wide the step ran, over how many positions.
        self.last_batch_info = {"batch": b, "batch_compiled": b_eff,
                                "devices": devices}
        for it in items:
            it["t_start"] = t_start
            it["timings"]["stack"] = self._batcher.last_stack_s
        return items

    def master_v1_bytes(
        self, data: bytes, filename: str, *,
        target_lufs: float, out_format: str = "wav", style: str = "standard",
        denoise_strength: float = 0.0, transient_attack: float = 1.0,
        transient_sustain: float = 1.0, reference_env=None,
        reference_strength: float = 0.8, dither_type: str = "tpdf",
        bitrate: int | None = None, progress=None,
    ) -> dict:
        tm = self._start_timings()
        report = progress or (lambda pct, msg: None)
        with torch.inference_mode():
            t0 = time.perf_counter()
            report(2, "Loading audio…")
            audio, sr = load_audio_from_bytes(data, filename or "wav")
            n, C = audio.shape[-1], audio.shape[0]
            spec = self._spec_for(sr, n, C)
            xb = self._pad(np.ascontiguousarray(audio, np.float32), spec.n)
            t0 = add_seconds(tm, "decode", t0)
            key = json.dumps(
                {"style": style, "t": round(float(target_lufs), 2),
                 "dn": round(float(denoise_strength), 2),
                 "ta": round(float(transient_attack), 2),
                 "ts": round(float(transient_sustain), 2),
                 "ref": reference_env is not None,
                 "rs": round(float(reference_strength), 2)},
                sort_keys=True)
            report(5, "Mastering…")
            use_ticks = (progress is not None
                         and prog_mod.callbacks_supported())
            params, fn, names = self._get_graph(
                "v1", spec, key,
                lambda: self._built_v1(spec, target_lufs, style,
                                       denoise_strength, transient_attack,
                                       transient_sustain, reference_env,
                                       reference_strength))
            add_seconds(tm, "build", t0)
            nv = np.int32(n)
            ema_key = ("v1", spec, key)
            t_run = time.monotonic()
            with _maybe_profile("master_v1"):
                if use_ticks:
                    tok = prog_mod.register(names, report)
                    try:
                        res = self._execute(fn, params, xb[None], nv[None],
                                            tok)[0]
                    finally:
                        prog_mod.unregister(tok)
                else:
                    ema = self._get_duration(ema_key) if progress else None
                    with prog_mod.TimedTicker(names, report, ema):
                        res = self._execute(fn, params, xb[None],
                                            nv[None])[0]
                    self._note_duration(ema_key, time.monotonic() - t_run)
            tm.update(res["timings"])
            out = res["out"][..., :n]
            before = float(res["before_lufs"])
            after = float(res["after_lufs"])
            if out.numel() == 0 or float(res["peak"]) < 1e-5:
                raise ValidationError(_SILENT_MSG)
            if not res["finite"]:
                raise ValidationError(_NANINF_MSG)
            report(98, "Exporting file…")
            out_bytes = export_audio(out, sr, out_format.lower(),
                                     dither_type=dither_type,
                                     bitrate=bitrate, timings=tm)
            return {
                "bytes": out_bytes, "sr": sr,
                "before_lufs": None if before < -1e8 else before,
                "after_lufs": None if after < -1e8 else after,
            }

    def _built_v1(self, spec, target_lufs, style, denoise_strength,
                  transient_attack, transient_sustain, reference_env,
                  reference_strength):
        """The v1 pipeline wrapped in the before/after loudness meter and
        the validation stats, returning the v2 graph's dict."""
        params, raw_fn, names = build_v1_pipeline(
            spec, target_lufs=target_lufs, style=style,
            denoise_strength=denoise_strength,
            transient_attack=transient_attack,
            transient_sustain=transient_sustain,
            reference_env=reference_env,
            reference_strength=reference_strength, device=self.device,
        )
        settle = meters.k_weight_settle(spec.sr)
        nfft = fft_staged.site_plan(spec.n + settle, self.device)[0]
        Hk = meters.k_weight_response(spec.sr, nfft)
        try:
            plan = meters.plan_blocks(spec.sr, spec.n)
        except ValueError:
            plan = None
        all_params = list(params) + [to_device([Hk], self.device)]

        def loudness(x, Hk_d, nv):
            if plan is None:
                return torch.full((x.shape[0],), -1e9, dtype=torch.float32,
                                  device=x.device)
            return meters.integrated_lufs(x, Hk_d, nfft, plan, n_valid=nv)

        def fn(x, ps, n_valid=None, prog_tok=None):
            xb, nv, _ = as_batch(x, n_valid)
            before = loudness(xb, ps[-1][0], nv)
            y = raw_fn(xb, ps[:-1], nv, prog_tok)
            after = loudness(y, ps[-1][0], nv)
            finite, peak = basic.validate_stats(y)
            return {"out": y, "before_lufs": before, "after_lufs": after,
                    "peak": peak, "finite": finite}

        return all_params, fn, names

    # -- synchronous tools -------------------------------------------------

    def reference_match_bytes(self, data_src: bytes, fname_src: str,
                              data_ref: bytes, fname_ref: str, *,
                              strength: float = 0.8,
                              out_format: str = "wav",
                              bitrate: int | None = None) -> dict:
        """Reference mastering tool (mastering.py:1305-1366): match the
        source's spectral balance to the reference track."""
        from ..ops.spectral import build_reference_match

        with torch.inference_mode():
            audio, sr = load_audio_from_bytes(data_src, fname_src)
            ref_audio, ref_sr = load_audio_from_bytes(data_ref, fname_ref)
            ref_env = self._reference_envelope(ref_audio, ref_sr, sr)
            n, C = audio.shape[-1], audio.shape[0]
            spec = self._spec_for(sr, n, C)
            # The reference envelope is a runtime parameter (params[0]), so
            # the graph is cached per (spec, strength) and reused across
            # reference tracks.
            key = f"refmatch:{round(float(strength), 3)}"

            def _build_tool():
                raw = build_reference_match(
                    spec, np.ones(ref_env.shape[-1], np.float32),
                    strength=float(strength), device=self.device)[1]

                def tool_fn(x, p, nv):
                    # Source-envelope frames and output anchored at the
                    # valid length of the bucket-padded track.
                    with validctx.valid_length(nv):
                        return validctx.mask_tail(raw(x, p))

                return None, tool_fn, None

            _, fn, _ = self._get_graph("tool", spec, key, _build_tool)
            params = to_device(build_reference_match(
                spec, ref_env, strength=float(strength),
                device=self.device)[0], self.device)
            xb = self._pad(np.ascontiguousarray(audio, np.float32), spec.n)
            x = torch.from_numpy(xb[None]).to(self.device)
            nv = torch.tensor([n], dtype=torch.int32, device=self.device)
            out = fn(x, params, nv)[0, :, :n]
            out_bytes = export_audio(out, sr, out_format.lower(),
                                     bitrate=bitrate)
            return {"bytes": out_bytes, "sr": sr}

    def _reference_envelope(self, ref_audio: np.ndarray, ref_sr: int,
                            sr: int) -> torch.Tensor:
        """The reference track's spectral envelope at the source's rate
        ``sr``, on the device: at another rate, of its mono mix resampled
        (where the JAX engine takes both on the host,
        ``amw_tpu/refimpl/pipeline.py``)."""
        from ..ops.fdfilter import resample_fft
        from ..ops.spectral import spectral_envelope

        ref = torch.from_numpy(
            np.ascontiguousarray(ref_audio, np.float32)).to(self.device)
        if ref_sr != sr:
            ref = resample_fft(ref.mean(dim=0, keepdim=True),
                               int(round(ref.shape[-1] * sr / ref_sr)))
        return spectral_envelope(ref)

    def upscale_bytes(self, data: bytes, filename: str, *,
                      target_sr: int) -> dict:
        """FFT resample to a higher rate + 16-bit WAV
        (mastering.py:1369-1406)."""
        from ..ops.fdfilter import resample_fft, resample_plan

        with torch.inference_mode():
            audio, sr = load_audio_from_bytes(data, filename)
            if target_sr <= sr:
                raise ValueError(
                    f"Upscale: target_sr ({target_sr}) must exceed the "
                    f"current sample rate ({sr})")
            n = audio.shape[-1]
            n_out = int(round(n * target_sr / sr))

            def _build_upscale():
                # resample_plan is None: cuFFT takes any length
                return ((lambda x, p: resample_fft(x, n_out, p)),
                        resample_plan(n, n_out))

            # Through _get_graph: one cached entry per (sr, n, target) with
            # LRU eviction — upscale keys are effectively per-track.
            fn, plan = self._get_graph("upscale", (sr, n), str(target_sr),
                                       _build_upscale)
            x = torch.from_numpy(np.ascontiguousarray(audio, np.float32)).to(
                self.device)
            out_bytes = export_audio(fn(x, plan), target_sr, "wav",
                                     dither_type="tpdf")
            return {"bytes": out_bytes, "sr": target_sr}


# Module-level default engine (created lazily by the service).
_default_engine: MasteringEngine | None = None


def get_engine() -> MasteringEngine:
    global _default_engine
    if _default_engine is None:
        _default_engine = MasteringEngine()
    return _default_engine
