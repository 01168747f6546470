"""Smoke run of the PyTorch/CUDA port (``amw_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing JSON lines:

1. device  — requires CUDA; prints ``nvidia-smi``'s name and power limit;
2. build   — compiles the CUDA kernels of ``amw_tpu_torch/csrc`` (nvcc,
             one process per source, all started together);
   env_step — tau, one dependent step of the envelope recurrence: one
             warp's clock64 cycles over 2^20 steps on register values
             (``scan.env_step_cycles``) at the card's maximum SM clock
             (``nvidia-smi``), beside the CUDA-event time of that launch;
             the envelope kernels' latency bound is their serial depth
             times tau;
3. kernels — each of the thirteen kernels against its plain PyTorch
             version on the card at the shapes of the 180 s batch (16 rows
             of 7 938 000 samples; the staged FFT at nfft = 2^23, 8 packed
             rows, K = 2 and 4 responses; kernel 8 also unpacked on one
             row, kernel 12 at K = 4 on one mono row; the split stages:
             kernel 6, kernel 7 with a response, without one and on one
             unpacked row, kernel 10 at K = 2 and 4; the chunked envelope
             with the transient designer's slow ballistics at the card
             geometry (``scan.scan_geometry``, the main path's) and at
             ``scan.chunk_geometry``'s, each checked, both timed; the
             per-row envelope at the 2 s clip's own [2, 88 200] and at
             [16, 88 200], each checked and timed), with CUDA-event
             times (median of 20; the envelope kernels' plain versions one
             run after a warm-up), the bound and a PyTorch library
             yardstick; the B/C kernels 7-10 also their C pass alone
             (``cstage_multi_kernel``, ``cstage_inv_kernel``:
             torch.profiler over 10 launches) beside its bound, 8 and 9
             also each B pass alone (``breg_fwd_kernel``,
             ``breg_inv_kernel``, from the same profile), 7 and 10 their
             inverse B pass (``breg_inv_kernel``) beside its bound;
             kernel 6 its one pass alone (``bc_onepass_kernel``, beside
             the kernel's bound); the box and env-gain kernels
             also at the 5 s batch's shapes (16 rows of 220 500
             samples); the env-gain
             kernel at both batches' card geometry (the main path's) and
             ``chunk_geometry``'s, each checked, timed at both at 180 s
             and at the card geometry at 5 s, each with its W, C, K and
             latency bound;
4. entry   — ``fft_staged.roundtrip_multi`` (K = 2) and
             ``roundtrip_multi_reduce`` (K = 4, the band maps) at [16, 2^23]
             against ``torch.fft`` (rfft → × K → irfft), and a sweep of
             ``roundtrip_multi`` over every staged plan (2^19 .. 2^24);
5. slice   — the v1 ``standard`` chain (``build_v1_pipeline``) on a
             micro-batch of 8 stereo 44.1 kHz tracks, two of them
             bucket-padded, twice: 5 s tracks (no FFT kernel) and 180 s
             tracks (the staged FFT).  Each run: kernel launch counts
             (reset just before, read just after), output checks (finite,
             |y| <= 1, padded tails zero, integrated loudness within 1 LU
             of -14), parity
             with the port's plain path on the CPU (<= -90 dBFS, <= 0.1 LU;
             at 180 s for the padded 97.5 s track; every run's CPU path
             runs in one of two worker processes, ``CpuParity``, all of
             them submitted after the kernel and entry phases from the
             one table of runs that the card runs read too,
             ``parity_runs``, collected by the run that checks them, and
             paused in every timed loop), and the
             steady-state realtime factor; a profile of the 180 s batch
             (device time by kernel, idle share);
6. v1_split — the same 180 s batch on the split route
             (``AMW_FFT_FUSED_RT=0``: kernel 6 then 10 at each fused site),
             launch counts, the output against the fused route's (<= -90
             dBFS, <= 0.1 LU), the wall beside the fused route's;
7. analyze — ``analyze(extended=True)`` and ``lufs_analyze_tool`` on a
             180 s and a 97.5 s stereo track, a 180 s mono track and a 5 s
             clip, each on the fused and the split route: launch counts,
             the graph's outputs and both response dicts against the
             port's CPU path (0.01 LU / dB, correlation 1e-4, vectorscope
             equal, same keys and None pattern), wall per call and
             realtime factor; a profile of the 180 s stereo tool call;
8. v2      — the v2 mastering job (``build_v2_job_graph``: the default
             ``standard`` chain config plus the pro set ``V2_PRO``) three
             times: 8 stereo 180 s tracks (the last two bucket-padded to
             150 s and 97.5 s), one mono 180 s track at ``podcast`` (odd
             rows: the unpacked kernels 8 and 12), and one 2 s stereo clip
             at ``edm`` (the per-row envelope, the exciter and imager);
             then one stereo 180 s track with the linear-phase target curve
             and the envelope compressor (``options_config``).  Each run:
             launch counts against those derived from the code, output
             checks, parity with the port's CPU path for one track each
             (the batch's padded 97.5 s track; <= -90 dBFS, <= 0.1 LU, the
             graph's before/after loudness within 0.01 LU), the realtime
             factor; a profile of the 180 s batch;
   spectral — the spectral stages (``ops/spectral.py``: torch.fft and a
             sort, no kernel of their own): ``v2_denoise_180s``, the v2
             180 s batch with the pro set plus the pro panel's "medium"
             denoiser preset, and ``v1_reference_180s``, the v1 180 s batch
             with denoise strength 0.5 and a reference match to the
             envelope of another track (``spectral_envelope`` on the card),
             each with the checks of its kind's runs (the v1 run's
             loudness held to the CPU path only: the reference's own
             reference match leaves it far below the target), a profile,
             and each spectral stage alone (CUDA events) with its share of
             the batch's device time;
   finish  — the last DSP options (torch.fft, reductions and elementwise
             passes, no kernel of their own but the exciter's 2x high
             pass): ``v2_finish_180s``, the v2 180 s batch with the pro set
             plus the true-peak ceiling at -1.0 dBTP and a chain config
             with the plate reverb in M/S and the exciter at 2x (its high
             pass at 2^24 on kernels 4, 8 and 5, counted by plan), with
             every output's true peak checked, a profile and each new
             stage alone; ``export_180s``, that output resampled to 48
             kHz, TPDF dither and int16 (the resampler against the CPU
             path, TPDF statistics on silence, the shaped noises
             high-passed); ``options_finish_180s``, one 180 s track
             through the chain with the exciter at 4x (cuFFT at 2^25), the
             hall reverb and the limiter as a chain module at -7.0 dBTP,
             where it engages; ``vocal_180s``, the DSP vocal separator
             (``isolate_vocal``) on a stereo and a mono 180 s track, one a
             call; each with launch counts and parity with the CPU path;
   htdemucs — the neural vocal separator (``models/htdemucs.py``: cuDNN,
             cuBLAS, cuFFT, no hand kernel), with cuDNN's and cuBLAS's TF32
             switches on (its f32 forwards turn them off themselves): (a)
             ``isolate_vocal`` on the bundled checkpoint
             (``AMW_HTDEMUCS_CKPT=bundled``) for a 180 s stereo and a mono
             track in f32 and bf16 (f32 against the port's CPU path, <= -90
             dBFS, <= 0.1 LU; bf16 against f32, SNR >= 30 dB; the wall of
             a call, median of 3; the network's own CUDA-event ms on the
             8 kHz track) and the checkpoint's separation gate in bf16 on
             the card; (b) the released shape with seeded weights, saved
             to a temporary file that ``AMW_HTDEMUCS_CKPT`` names:
             ``isolate_vocal`` of a 180 s track at 44.1 kHz in f32 and
             bf16 and ``warmup_htdemucs`` of 180 s through the entry
             points, then on the models they loaded one 7.8 s segment
             against the CPU (<= -90 dBFS), the track
             separated in f32 and bf16 (CUDA-event ms, realtime factor,
             peak memory, the FLOP bound; SNR >= 30 dB), a profile of the
             bf16 track by kernel class; (c) ``MasteringEngine`` on the
             card masters a 30 s upload with ``apply_vocal_isolation``
             under the database row ``htdemucs_checkpoint = bundled``,
             within 2.5 LSB and 0.01 LU of the v2 graph on
             ``separate_htdemucs``'s vocals, then ``warmup_htdemucs`` of
             180 s warms one bucket;
9. engine  — the serving engine (``runtime/engine.MasteringEngine()`` on
             the card, micro-batch on): ``warmup((180,))`` (the default
             graph cached and run once), one warm request of each kind,
             then a burst of 10 concurrent requests as 16-bit WAV uploads
             (8 stereo 180 s with ``V2_PRO``, two of them 170 s and 165 s;
             one mono 180 s at ``podcast``; one 2 s clip at ``edm``: the
             v2 180 s, mono and clip runs as requests) three times: burst
             1 at a 1 s batch window, checked (launches equal to
             ``job_expected``'s for the three runs, one batch of 8 for the
             stereo key, each response int16 at its own length and within
             2.5 LSB and 0.01 LU of the graphs that ``build_v2_job_graph``
             built for the v2 180 s, mono and clip runs, called directly);
             burst 2 at 1 s profiled (device busy, idle share; device
             memory equal to burst 1's); burst 3 at the engine's default
             50 ms window, profiled (the batches it formed, its idle
             share).  Each burst's wall, realtime factor and per-request
             split (decode, queue, stack, H2D, graph, export, D2H,
             encode).  Then once each against the op on the card: stage
             ticks without the batcher, on the burst's stereo graph (>= 8
             labels, monotonic, each tick after its stage's CUDA event
             completed), ``master_v1_bytes``, ``reference_match_bytes``,
             ``upscale_bytes`` (44.1 -> 48 kHz), ``isolate_vocal_bytes``;
10. service — the HTTP service (``runtime/service.create_app``) on that
             engine, its graphs warm, served on 127.0.0.1 over real
             sockets (``web.AppRunner``, ``web.TCPSite``) with a
             temporary database and the anonymous limits off, the client
             ``aiohttp.ClientSession`` (``"http": true``): health,
             version, metrics; ``/api/v2/batch`` of the 8 stereo uploads
             at the defaults (the warm default graph; 8 jobs in turn
             under the default semaphore of 1; one job on its SSE stream;
             every result within 2.5 LSB and 0.01 LU of ``embed_branding``
             of ``master_v2_bytes`` on the same bytes, its header, length
             and branding equal; launches those of 8 single-track runs);
             the engine burst's 10 requests as concurrent ``POST
             /api/v2/master`` calls with the pro set, at the default
             semaphore and at 8 slots, each under torch.profiler (wall,
             realtime factor, device busy and idle share, the batches
             formed, launches those of the batches, each stereo job's
             upload and parse, semaphore wait, the engine's split, its
             branding and download); then analysis and the LUFS tool
             (against the calls on the card), reference match, upscale to
             48 kHz, vocal isolation (the settings store's override on)
             and auto mastering once each; with the initial admin
             configured and registration and the AI routes on, a line
             for each of (e) the landing page's demo renderer, which the
             service starts at its start on the card because the clips
             are missing (their directory a new temporary one): both 8 s
             clips, launches those of two default-chain runs, each WAV
             within the v2 loudness window and within one int16 step of
             the card's and (edm) the CPU's render; (b) a registered
             user's bearer ``POST /api/v2/master`` of one 180 s stereo
             upload within 2.5 LSB and 0.01 LU of ``embed_branding`` of
             ``master_v2_bytes``, one v2 run's launches, the record in
             the user's history; (c) ``/api/ai/recommend`` of it, the
             recommendation of ``analyze`` called on the card, its
             analysis within 0.01, the launches of kernels 4, 8 and 5
             those of the analyze phase's fused 180 s run; (d) the user
             bot (``Bot(engine=eng)``, a fake transport) mastering it as
             a WAV message, the document (not the failure text) within
             2.5 LSB and 0.01 LU of ``master_v2_bytes``, one v2 run's
             launches; (a) the admin's ``/api/admin/stats`` counting the
             phase's 31 masterings;
11. mesh    — the serving mesh over meshes of positions on ``cuda:0``
             (``parallel/mesh.py``): (a) a 660 s stereo upload (the
             shortest the default 600 s threshold routes to the
             sequence-parallel path) through ``MasteringEngine(mesh=<4
             positions>)``'s ``master_v2_bytes`` with the pro set and the
             true-peak ceiling at -1.0 dBTP: routed to ``_master_v2_sp``,
             each position's launches against those derived from the code
             (``sp_expected``), a warm request profiled (wall, device busy
             and idle share, peak memory), each window variant's host
             build time, the sp graph from the engine's cache against the
             single-device v2 graph (exact mode) on the card (<= -90 dBFS
             over the whole track, loudness before and after within 0.01
             LU, true peak under the ceiling); (b) 4 concurrent 30 s
             stereo requests to an engine over 2 positions and one over 1
             (one graph build, shared): one step over 2 positions, each
             response within 2.5 LSB and 0.01 LU of the graph and within 2
             LSB and 0.01 LU of the other engine's; (c) ``isolate_vocal``
             on the bundled checkpoint (f32) over 2 positions
             (``htdemucs.separate_mesh``) against ``separate``: <= -90
             dBFS; (d) the stage-by-stage regression harness
             (``qa/mastering_regression``) on
             ``amw_tpu_torch/scripts/gen_regression_fixture.render()``'s
             165 s stereo,
             every window metric within
             ``tests/fixtures/mastering_regression/expected_metrics.json``;
12. cli     — the operator CLIs of ``amw_tpu_torch/scripts`` on the card,
             in a temporary directory on a temporary database: (a)
             ``python -m amw_tpu_torch.scripts.run_self_diagnosis`` as its
             own process, exit 0 with every preset's gates passed (±1 LU,
             true peak <= -0.5 dBTP, finite), then each preset in this
             process, its wall and the first one's launches (the v1
             chain's on the staged FFT: the 12 s track plans 2^20); (b)
             ``run_debug`` as its own process, every check passed, its op
             errors (the card against the port's CPU path); (c)
             ``run_test_master`` on a 180 s 16-bit WAV, first call and
             warm, the output within 1 LU of -14, the printed wall and
             realtime factor; (d) ``run_audio_test`` prints PASS; (e)
             ``gen_regression_fixture`` writes the fixture the mesh phase
             read and ``run_diagnose_file`` reports its stages; (f)
             ``run_isolate_vocal`` on 30 s with the DSP separator and with
             htdemucs (bundled), each within 120 dB SNR of
             ``isolate_vocal``; (g)
             ``gen_api_docs --out``, a row for each route; (h)
             ``gen_sep_eval``'s four SNRs in f32 and bf16, f32 within 1e-3
             dB of the port's CPU path (bf16 is 0.004 dB from f32);
13. train   — the htdemucs trainer (``amw_tpu_torch/scripts/
             train_htdemucs.py``: autograd over the port's network, cuDNN,
             cuBLAS, cuFFT, no hand kernel; TF32 switches on, the step
             turns them off), a line each: (a) one step at the trainer's
             defaults (channels 16, bottom 48, batch 16, seed 0) on one
             augmented batch, the card's f32 loss and gradients against
             the port's CPU path at float64 (loss within 1e-6 relative,
             each gradient tensor above 1e-9 of the largest within 1e-4
             of its own largest, the rest within that floor; the CPU path
             at f32 against it reported beside); (b) 200 steps through
             ``main`` (20 of them profiled): ms a step at steady state,
             the host corpus's ms a batch against it and the queue's wait,
             device idle share and kernels a step, peak memory, the
             training realtime factor (audio seconds a wall second), the
             L1 at the first and last logged steps (the last below), the
             probe SNR; (c) five steps at the released widths (channels
             48, bottom 512): ms a step, peak memory, the FLOPs of a
             forward and backward (``torch.utils.flop_counter``) and their
             bound at ``F32_FLOPS``, every loss finite; (d) the ``.npz``
             of (b) served by ``models/vocal`` (``AMW_HTDEMUCS_CKPT``):
             ``isolate_vocal`` of a 30 s track; (e) none of the 13 kernels
             launched over the phase;
14. mxu     — the matmul FFT route (``AMW_FFT_MXU=1``,
             ``amw_tpu_torch/ops/fft_mxu.py``: cuBLAS products at full f32
             and PyTorch's elementwise kernels, no hand kernel): (a) one
             rfft → K-weighting response → irfft pair over the 180 s
             batch's 16 rows at 2^23 through ``fdfilter._apply_response``
             on the route and on ``torch.fft``: the route's error against
             the library's (<= -90 dBFS), the CUDA-event ms of each, the
             route's bound (its bytes, its f32 operations at
             ``F32_FLOPS``), the output with TF32 switched on globally
             (bit for bit the same), and, for the record, the route with
             its TF32 guard taken out; (b) the v1 180 s batch under the
             variable against the same graph on the default route, in
             exact mode (the default: launches ``V1_STAGED`` on both; its
             ``_apply_response`` sites are edge windows below 2^16, so
             the route's calls are counted, not required) and in fast
             mode (``GraphSpec(exact=False)``: its meter filters the
             whole batch on the route, calls > 0, launches equal on both
             routes): outputs within -90 dBFS and 0.01 LU, walls;
15. pod     — two worker processes (``chip_smoke.py --pod-worker``), each
             ``init_distributed`` on 127.0.0.1 (gloo) with two positions
             on ``cuda:0``, build ``make_pod_mesh(sp=2)`` and run
             ``sp_batch_master`` on 2 × 60 s stereo tracks: each rank's
             whole batch within -90 dBFS of this process's
             ``sp_batch_master`` over ``make_mesh2d(2, 2)`` on ``cuda:0``,
             each rank's cold and warm wall, the exchange's ms and bytes,
             the 13 kernels' launches by rank (summing to this process's);
             a worker's non-zero exit or timeout fails the run;
16. last_ops — the last public functions of ``amw_tpu`` that the port
             took on, at 180 s stereo: ``eq.build_high_freq_trim`` on the
             8-track batch (its fast pass on kernels 4, 8, 5 at 2^23),
             ``scan.envelope_follower_xsr`` on its 16 rows (2') and on a
             2 s stereo clip (3), ``basic.maximizer_lookahead`` on the
             batch and ``basic.auto_blank_end_index`` of each track (no
             kernel): each call's launches by kernel (exactly those
             kernels), its CUDA-event ms, its output against the port's
             CPU path from a parity worker (<= -90 dBFS, the index
             equal); then ``runtime.batcher.BatchedChainRunner`` with 4
             of the batch's tracks on 4 threads at the default
             ``standard`` chain config, cold and warm (two batches of 4,
             the warm one's launches, wall and realtime factor), each
             row within -90 dBFS of the single-track ``compile_chain``
             output on the card (the runner's cached graph);
17. a ``kernels`` line: each kernel's launches on the path that uses it
   (the v1 180 s batch for kernels 1, 2, 4, 5, 9, 11; its split run for 6
   and 10; the split 180 s analysis for 7; the v2 runs for 8, 12, 2' and
   3), error, times, bound.

Every phase line carries ``t_s``, the seconds since the script's imports,
and ``phase_s``, its host seconds (since the line before, where the phase
states none of its own); the v1 and v2 runs also ``cpu_parity_wait_s``,
the seconds they waited for their CPU path's result.
Any failure raises (non-zero exit).  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Imports nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import functools
import io
import json
import os
import re
import shutil
import signal
import socket
import statistics
import struct
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import aiohttp
import numpy as np
import scipy.signal
import torch
from aiohttp import web

from amw_tpu_torch import GraphSpec
from amw_tpu_torch.constants import (DYNAMIC_EQ_MASTERING_BANDS,
                                     MULTIBAND_ATTACK_RELEASE_MS,
                                     MULTIBAND_CONFIG, PRESET_LUFS,
                                     STYLE_CONFIGS)
from amw_tpu_torch.models import (analyze, build_v1_pipeline,
                                  build_v2_job_graph, compile_chain,
                                  default_chain_config, lufs_analyze_tool)
from amw_tpu_torch.convert import to_device
from amw_tpu_torch.models.analyze import _analysis_graph, _bucket_for
from amw_tpu_torch.models.v2_job import resolve_denoise
from amw_tpu_torch.models import htdemucs, vocal
from amw_tpu_torch.models.vocal import isolate_vocal, isolate_vocal_bytes
from amw_tpu_torch.ops import (_cuda, basic, design, dither, fdfilter, meters,
                               scan, validctx)
from amw_tpu_torch.ops import fft_staged as fs
from amw_tpu_torch.ops.bands import BandMap
from amw_tpu_torch.ops.eq import build_high_freq_trim
from amw_tpu_torch.ops.exciter import build_harmonic_exciter
from amw_tpu_torch.ops.reverb import build_reverb
from amw_tpu_torch.ops.spectral import (build_reference_match,
                                        build_spectral_denoise,
                                        spectral_envelope)
from amw_tpu_torch.ops.tplimit import build_true_peak_limiter
from amw_tpu_torch.parallel import timeshard
from amw_tpu_torch.ops import fft_mxu
from amw_tpu_torch.parallel.mesh import (init_distributed, make_mesh,
                                         make_mesh2d, make_pod_mesh)
from amw_tpu_torch.qa import gates, mastering_regression
from amw_tpu_torch.runtime import ai
from amw_tpu_torch.runtime.bot import Bot
from amw_tpu_torch.runtime import db as service_db
from amw_tpu_torch.runtime import jobs as service_jobs
from amw_tpu_torch.runtime import progress, service, settings_store
from amw_tpu_torch.runtime.batcher import BatchedChainRunner
from amw_tpu_torch.runtime.config import settings as runtime_settings
from amw_tpu_torch.runtime.engine import MasteringEngine
from amw_tpu_torch.scripts import (gen_api_docs, gen_demo_assets,
                                   gen_regression_fixture, gen_sep_eval,
                                   htdemucs_gate, run_audio_test,
                                   run_diagnose_file, run_isolate_vocal,
                                   run_self_diagnosis, run_test_master,
                                   train_htdemucs)
from amw_tpu_torch.scripts.ab_bccb import (B_INV, kernel_ms, pass_ms,
                                           passes_ms, profile_ms)
from amw_tpu_torch.utils import wav
from amw_tpu_torch.utils.metadata import embed_branding

SR = 44100
BATCH = 8
TARGET_LUFS = -14.0
# the two micro-batches: track seconds, the two padded tracks' valid seconds
SHORT = (5.0, (4.2, 3.6))
LONG = (180.0, (150.0, 97.5))
LONG_NFFT = 1 << 23  # the staged plan of all three fused sites at 180 s
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and f32 (non-tensor) FLOP/s.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
ENV_ATOL = 1e-5
FFT_REL = 3e-6         # a stage's output, relative to its largest magnitude
FFT_REDUCE_REL = 1e-5  # the reduce with its band maps, relative
FFT_RT_ATOL = 2e-5     # a round trip of unit-variance signals, absolute
PARITY_DBFS = -90.0
PARITY_LU = 0.1
METER_LU = 0.01  # the graph's own before/after loudness, GPU vs CPU
# The v2 job's pro set: every PRE and POST stage the engine runs but the
# spectral denoiser (frontend/app.js:137-170).
V2_PRO = {"rumble_enabled": True, "rumble_cutoff": 60.0,
          "deesser_enabled": True, "transient_attack": 1.3,
          "transient_sustain": 0.85, "parallel_mix": 0.25,
          "dynamic_eq_enabled": True}
# The POST stages run after the normalization and lower the loudness (in
# the JAX package's job too, which the port matches on the CPU:
# tests/test_torch_v2_job.py), so the v2 output is held to
# [target - 2 LU, target + 1 LU].
V2_LU_BELOW = 2.0
# the pro panel's denoiser preset (frontend/app.js:152-156) on top of
# V2_PRO, and the v1 chain's spectral options: denoise strength 0.5 and a
# reference envelope of another track (make_track, seed REFERENCE_SEED)
V2_DENOISE_PRO = {**V2_PRO, "denoise_preset": "medium"}
V1_DENOISE = 0.5
REFERENCE_SEED = 99
SHORT_CLIP_S = 2.0
# the last DSP options: the pro panel's true-peak ceiling at the frontend's
# default (frontend/index.html:86) on top of V2_PRO; every output's true
# peak is held to it within TP_SLACK_DB
TP_CEILING_DB = -1.0
TP_SLACK_DB = 0.05
V2_FINISH_PRO = {**V2_PRO, "true_peak_enabled": True,
                 "true_peak_ceiling_db": TP_CEILING_DB}
# the chain module's ceiling in the options run: below that chain's output
# true peak without a limiter on this material (about -5.4 dBTP), so that
# the module limits there (the v2 batch stays under -1.0 without it)
OPTIONS_TP_CEILING_DB = -7.0
EXPORT_SR = 48000  # the export path (bench.py:368-396): 44.1 -> 48 kHz
VOCAL_SEED = 30
# the v1 chain's launches in one call on the staged FFT (every plan
# 2^19..2^24: tracks from ~5.8 s), one track or a batch
V1_STAGED = {"box_smooth_same": 1, "env_gain": 1, "fft_stage_a": 3,
             "fft_bccb_multi": 3, "fft_stage_a_inv_join": 2,
             "fft_reduce_stage_a_packed": 1}
# the launch counters of the kernels' wrappers, by kernel name
COUNTERS = {
    "box_smooth_same": fdfilter.box_smooth_cuda,
    "env_gain": scan.env_gain_cuda,
    "fft_stage_a": fs.stage_a_cuda,
    "fft_bccb_multi": fs.bccb_multi_cuda,
    "fft_stage_a_inv_join": fs.inv_join_cuda,
    "fft_reduce_stage_a_packed": fs.reduce_packed_cuda,
    "fft_bc_cb": fs.bc_cb_cuda,
    "fft_reduce_stage_a": fs.reduce_cuda,
    "env_scan": scan.env_scan_cuda,
    "env_rows": scan.env_rows_cuda,
    "fft_bc": fs.bc_cuda,
    "fft_cb": fs.cb_cuda,
    "fft_cb_multi": fs.cb_multi_cuda,
}


T_START = time.perf_counter()
_LAST_PHASE = [T_START]  # when the last phase line was emitted


def emit(obj) -> None:
    """Print one JSON line; a phase line gets ``t_s`` (seconds since the
    imports) and, unless it carries its own, ``phase_s`` (host seconds
    since the previous phase line)."""
    if "phase" in obj:
        now = time.perf_counter()
        obj = {"phase_s": now - _LAST_PHASE[0], **obj, "t_s": now - T_START}
        _LAST_PHASE[0] = now
    print(json.dumps(obj), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def make_track(sr: int, dur_sec: float, seed: int = 0) -> np.ndarray:
    """Stereo test material (a copy of the JAX package's bench generator):
    three partials plus noise under a slow amplitude envelope."""
    g = np.random.default_rng(seed)
    n = int(sr * dur_sec)
    t = np.arange(n) / sr
    x = (0.28 * np.sin(2 * np.pi * 110 * t)
         + 0.12 * np.sin(2 * np.pi * 997 * t)
         + 0.06 * np.sin(2 * np.pi * 6100 * t)
         + 0.05 * g.standard_normal(n))
    env = 0.5 + 0.5 * np.abs(np.sin(2 * np.pi * 0.25 * t))
    left = (x * env).astype(np.float32)
    right = (0.85 * x * env).astype(np.float32)
    return np.clip(np.stack([left, right]), -0.99, 0.99)


def reset_counts() -> None:
    for f in COUNTERS.values():
        f.launches = 0


def read_counts() -> dict:
    return {name: f.launches for name, f in COUNTERS.items()}


def rel_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, float]:
    """(max abs error, max abs error / max |want|)."""
    err = float((got.double() - want.double()).abs().max())
    return err, err / max(float(want.abs().max()), 1e-30)


def standard_band_maps() -> list:
    """The multiband dynamics' maps of the v1 chain (bands.build_dynamics
    defaults: knee 6 dB, max upward boost 12 dB)."""
    return [BandMap(comp_db, ratio, 6.0, 12.0, lim_db, gain)
            for lim_db, ratio, comp_db, gain in MULTIBAND_CONFIG]


def cuda_ms(fn, reps: int = 20, warmup: int = 2) -> float:
    """Median CUDA-event time of ``fn()`` over ``reps`` runs, with the CPU
    parity workers paused."""
    with PARITY.paused():
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
    return statistics.median(times)


def bound_ms(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_device() -> None:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})


def phase_build() -> None:
    secs = _cuda.build(verbose=True)
    emit({"phase": "build", "seconds": secs, "build_dir": str(_cuda.BUILD)})


def kernel_entry(name, source, replaces, shape, err, rel, bar, fn, plain,
                 nbytes, flops, library, plain_reps=20, **extra) -> dict:
    b_ms, b_by = bound_ms(nbytes, flops)
    entry = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "shape": shape, "max_abs_err": err,
             "max_rel_err": rel, "bar": bar, "ms": cuda_ms(fn),
             "plain_ms": cuda_ms(plain, reps=plain_reps,
                                 warmup=1 if plain_reps < 20 else 2),
             "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
             "flops": flops, **extra}
    if library is None:
        entry.update(library_ms=None)
    else:
        entry.update(library_ms=cuda_ms(library[1]), library=library[0])
    emit({"phase": "kernel", **entry})
    return entry


BOX_K = 67  # the de-esser's box width at 44.1 kHz


def deesser_kernel_inputs(dev, g, dur: float, valid) -> tuple:
    """The de-esser kernels' inputs at one batch's shapes: the box
    smoother's gain rows and the env-gain arguments (sidechain rows, two
    tracks shorter) at the card geometry of that length (the main path's:
    ``scan.scan_geometry`` for this card's SMs) and at
    ``scan.chunk_geometry``'s."""
    rows, n = BATCH * 2, int(SR * dur)
    x = torch.rand(rows, n, generator=g).to(dev)
    att, rel = scan.ar_coefs(SR, 0.004, 0.085)
    thresh, ratio, floor = 10 ** (-6.0 / 20), 3.0, 0.35
    sc = (0.3 * torch.randn(rows, n, generator=g)).to(dev)
    nv = torch.tensor([n] * (rows - 4) + [int(valid[0] * SR)] * 2
                      + [int(valid[1] * SR)] * 2, dtype=torch.int32,
                      device=dev)
    w0 = scan.warmup_len(att, rel)
    tail = (att, rel, thresh, ratio, floor)
    return x, {"card": (sc, nv, *scan.scan_geometry(rows, n, w0,
                                                   scan.sm_count(dev)), *tail),
               "chunk": (sc, nv, *scan.chunk_geometry(rows, n, w0), *tail)}


def check_deesser_kernels(x, geoms) -> tuple[float, dict]:
    """Box and env-gain kernels against their plain versions, the latter
    at each geometry; returns the box's max abs error and the env-gain's
    by geometry."""
    got = fdfilter.box_smooth_cuda(x, BOX_K)
    want = fdfilter.box_smooth_plain(x, BOX_K)
    torch.cuda.synchronize()
    box_err = float((got - want).abs().max())
    check(torch.equal(got, want), f"box kernel differs from its plain "
          f"version (max abs err {box_err}) at {list(x.shape)}")
    del got, want
    env_errs = {}
    for key, args in geoms.items():
        got = scan.env_gain_cuda(*args)
        want = scan.env_gain_plain(*args)
        torch.cuda.synchronize()
        env_errs[key] = float((got - want).abs().max())
        check(env_errs[key] <= ENV_ATOL, f"env-gain kernel err "
              f"{env_errs[key]} > {ENV_ATOL} at {list(x.shape)}, "
              f"(W, C, K) = {args[2:5]}")
        del got, want
    return box_err, env_errs


def phase_env_step(dev) -> float:
    """tau in ns: one warp's clock64 cycles a dependent step of the
    envelope recurrence on register values, at the maximum SM clock that
    ``nvidia-smi`` reports (so ``steps * tau`` is a least time)."""
    att, rel_c = scan.ar_coefs(SR, 0.005, 0.1)
    steps = 1 << 20
    scan.env_step_cycles(steps, att, rel_c, dev)  # warm-up
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    cycles = scan.env_step_cycles(steps, att, rel_c, dev)  # synchronises
    b.record()
    b.synchronize()
    event_ms = a.elapsed_time(b)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.splitlines()[0]
    max_mhz, sm_mhz = (float(f) for f in clocks.split(","))
    check(cycles > 0 and max_mhz > 0, f"env_step: {cycles} cycles at "
          f"{max_mhz} MHz")
    tau_ns = cycles / steps / max_mhz * 1e3
    emit({"phase": "env_step", "steps": steps, "cycles": cycles,
          "cycles_per_step": cycles / steps, "clocks_max_sm_mhz": max_mhz,
          "clocks_sm_mhz_after": sm_mhz, "tau_ns": tau_ns,
          "event_ns_per_step": event_ms * 1e6 / steps,
          "event_clock_mhz": cycles / (event_ms * 1e3)})
    return tau_ns


def phase_kernels(dev, tau_ns: float) -> dict:
    # matmuls/convolutions in full f32 (the plain versions, the yardsticks)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device="cpu").manual_seed(0)
    out = {}

    # -- the de-esser's two kernels at both batches' shapes (at 5 s most
    #    chunks' warm-up reaches back before sample 0); timed at 180 s, the
    #    env-gain kernel also at 5 s
    errs, gains = {}, {}
    for dur, valid in (SHORT, LONG):
        x, gains[dur] = deesser_kernel_inputs(dev, g, dur, valid)
        errs[dur] = check_deesser_kernels(x, gains[dur])
        emit({"phase": "kernel_check", "track_s": dur, "shape": list(x.shape),
              "box_max_abs_err": errs[dur][0],
              "env_max_abs_err": errs[dur][1],
              "env_W_C_K": {key: args[2:5]
                            for key, args in gains[dur].items()}})
    rows, n = x.shape
    box_err, env_errs = errs[LONG[0]]
    box_err_5s, env_errs_5s = errs[SHORT[0]]

    k = BOX_K
    w = torch.full((1, 1, k), 1.0 / k, device=dev)
    out["box_smooth_same"] = kernel_entry(
        "box_smooth_same", "amw_tpu_torch/csrc/box_smooth.cu",
        "amw_tpu/ops/fdfilter.py:219", [rows, n], box_err, None, 0.0,
        lambda: fdfilter.box_smooth_cuda(x, k),
        lambda: fdfilter.box_smooth_plain(x, k), 2 * rows * n * 4,
        rows * n * (k + 1),
        ("torch.nn.functional.conv1d",
         lambda: torch.nn.functional.conv1d(x[:, None], w, padding=k // 2)),
        k=k, max_abs_err_5s=box_err_5s)
    del x

    args, a_chunk = gains[LONG[0]]["card"], gains[LONG[0]]["chunk"]
    a_5s = gains[SHORT[0]]["card"]
    W, C, K = args[2:5]
    Wp, Cp, Kp = a_chunk[2:5]
    W5, C5, K5 = a_5s[2:5]
    # the function's own work: each sample through the recurrence (compare,
    # select, 2 mul, 1 sub, 1 add) and the gain map (~6), once
    out["env_gain"] = kernel_entry(
        "env_gain", "amw_tpu_torch/csrc/env_gain.cu",
        "amw_tpu/ops/scan.py:375", [rows, n],
        max(*env_errs.values(), *env_errs_5s.values()), None, ENV_ATOL,
        lambda: scan.env_gain_cuda(*args),
        lambda: scan.env_gain_plain(*args), 2 * rows * n * 4 + rows * 4,
        rows * n * 12, None, plain_reps=1, W=W, C=C, K=K,
        serial_steps=W + C, latency_bound_ms=(W + C) * tau_ns * 1e-6,
        max_abs_err_card_geometry=env_errs["card"],
        chunk_geometry=[Wp, Cp, Kp],
        ms_chunk_geometry=cuda_ms(lambda: scan.env_gain_cuda(*a_chunk)),
        max_abs_err_chunk_geometry=env_errs["chunk"],
        latency_bound_ms_chunk_geometry=(Wp + Cp) * tau_ns * 1e-6,
        shape_5s=list(a_5s[0].shape), geometry_5s=[W5, C5, K5],
        ms_5s=cuda_ms(lambda: scan.env_gain_cuda(*a_5s)),
        latency_bound_ms_5s=(W5 + C5) * tau_ns * 1e-6,
        max_abs_err_5s=env_errs_5s["card"],
        max_abs_err_5s_chunk_geometry=env_errs_5s["chunk"],
        ballistics_ms=[4.0, 85.0])
    del args, a_chunk, a_5s, gains

    out.update(fft_kernels(dev, g, rows, n))
    return out


def fft_kernels(dev, g, rows: int, n: int) -> dict:
    """The staged FFT's four kernels at the 180 s batch's shapes: the
    packed forward stage A on the unpadded [16, n] signal, the B/C stage
    over K = 2 (and 4) responses, the join over K = 2 and the reduce over
    the K = 4 bands with the chain's band maps."""
    nfft = LONG_NFFT
    R2 = rows // 2
    S = nfft // fs.A
    lg = 16  # log2(B * C): the B/C stage is one 65536-point DFT per (row, a')
    tabs = fs._device_tables(nfft, dev)
    x = (0.3 * torch.randn(rows, n, generator=g)).to(dev)
    H = [0.25 + torch.rand(nfft // 2 + 1, generator=g, dtype=torch.float64)
         .numpy() for _ in range(4)]
    resps = torch.from_numpy(np.stack([fs.permute_full_response(h, nfft)
                                       for h in H])).to(dev)
    out = {}

    # -- kernel 4, stage A: complex forward of the packed rows
    a4 = (x[:R2], x[R2:], nfft, False, tabs)
    Xr, Xi = fs.stage_a_cuda(*a4)
    Pr, Pi = fs.stage_a_plain(*a4)
    torch.cuda.synchronize()
    e = [rel_err(Xr, Pr), rel_err(Xi, Pi)]
    err, rel = max(v[0] for v in e), max(v[1] for v in e)
    check(rel <= FFT_REL, f"stage-A kernel rel err {rel} > {FFT_REL}")
    del Pr, Pi
    z = torch.complex(torch.nn.functional.pad(x[:R2], (0, nfft - n)),
                      torch.nn.functional.pad(x[R2:], (0, nfft - n))
                      ).view(R2, fs.A, S)
    out["fft_stage_a"] = kernel_entry(
        "fft_stage_a", "amw_tpu_torch/csrc/fft_stage_a.cu",
        "amw_tpu/ops/fft_pallas.py:513", [R2, nfft], err, rel, FFT_REL,
        lambda: fs.stage_a_cuda(*a4), lambda: fs.stage_a_plain(*a4),
        rows * n * 4 + 2 * R2 * nfft * 4 + 2 * nfft * 4,
        R2 * nfft * (5 * 7 + 6),
        ("torch.fft.fft(dim=1) of [8, 128, 65536] complex (no twiddle)",
         lambda: torch.fft.fft(z, dim=1)),
        input_n=n)
    del z

    # -- kernel 9, B/C stage over K responses; the yardstick computes the
    #    same function: B, T2 and C are one 65536-point DFT along the joint
    #    (b, c) axis, with the permuted responses gathered to natural order
    order = yardstick_order(nfft, dev)
    xc = torch.complex(Xr, Xi).view(R2, fs.A, S)
    ys = {}
    for K in (2, 4):
        a9 = (Xr, Xi, resps[:K], nfft, tabs)
        Yr, Yi = fs.bccb_multi_cuda(*a9)
        Pr, Pi = fs.bccb_multi_plain(*a9)
        torch.cuda.synchronize()
        e = [rel_err(Yr, Pr), rel_err(Yi, Pi)]
        err, rel = max(v[0] for v in e), max(v[1] for v in e)
        check(rel <= FFT_REL, f"B/C kernel (K={K}) rel err {rel} > {FFT_REL}")
        del Pr, Pi
        hn = torch.complex(resps[:K, 0], resps[:K, 1]).view(K, fs.A, -1)
        hn = torch.gather(hn, 2, order.expand(K, -1, -1))[:, None]

        def lib(K=K, hn=hn):
            X = torch.fft.fft(xc, dim=-1)
            # unscaled inverse, as the kernel's (1/nfft is in stage A)
            return torch.fft.ifft(X[None] * hn, dim=-1, norm="forward")

        lib_err = rel_err(lib().reshape(K * R2, nfft).real, Yr)[1]
        ys[K] = (Yr, Yi)
        nbytes = (2 * R2 * nfft + 2 * K * nfft + 2 * K * R2 * nfft) * 4
        entry = kernel_entry(
            "fft_bccb_multi", "amw_tpu_torch/csrc/fft_bccb.cu",
            "amw_tpu/ops/fft_pallas.py:684", [R2, nfft], err, rel, FFT_REL,
            lambda a9=a9: fs.bccb_multi_cuda(*a9),
            lambda a9=a9: fs.bccb_multi_plain(*a9), nbytes,
            R2 * nfft * (5 * lg + 6 + K * (6 + 5 * lg + 6)),
            ("torch.fft.fft + K x (mul + torch.fft.ifft) along the joint "
             "(b, c) axis of [8, 128, 65536] complex", lib),
            K=K, library_rel_err=lib_err,
            split_extra_bytes=(4 * R2 * nfft + 4 * K * R2 * nfft) * 4,
            # the C pass alone moves the fused bytes: its bound is the same;
            # each B pass reads and writes its planes once (K inverse)
            **passes_ms(lambda a9=a9: fs.bccb_multi_cuda(*a9),
                        "cstage_multi_kernel"),
            cpass_bound_ms=bound_ms(nbytes, 0)[0],
            bfwd_bound_ms=bound_ms(4 * R2 * nfft * 4, 0)[0],
            binv_bound_ms=bound_ms(4 * K * R2 * nfft * 4, 0)[0])
        if K == 2:
            out["fft_bccb_multi"] = entry
        else:
            out["fft_bccb_multi"]["k4"] = {
                k: entry[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "library_ms", "max_rel_err",
                                      "cpass_ms", "cpass_bound_ms",
                                      "bfwd_ms", "bfwd_bound_ms", "binv_ms",
                                      "binv_bound_ms")}
    del xc

    # -- kernel 5, the packed inverse stage A with the join, K = 2
    Yr, Yi = ys[2]
    a5 = (Yr, Yi, 2, nfft, tabs)
    got = fs.inv_join_cuda(*a5)
    want = fs.inv_join_plain(*a5)
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    check(rel <= FFT_REL, f"join kernel rel err {rel} > {FFT_REL}")
    del got, want
    yc = torch.complex(Yr, Yi).view(2 * R2, fs.A, S)
    out["fft_stage_a_inv_join"] = kernel_entry(
        "fft_stage_a_inv_join", "amw_tpu_torch/csrc/fft_stage_a.cu",
        "amw_tpu/ops/fft_pallas.py:563", [2 * R2, nfft], err, rel, FFT_REL,
        lambda: fs.inv_join_cuda(*a5), lambda: fs.inv_join_plain(*a5),
        (2 * 2 * R2 * nfft * 2 + 2 * nfft) * 4,
        2 * R2 * nfft * (5 * 7 + 6 + 2),
        ("torch.fft.ifft(dim=1) of [16, 128, 65536] complex (no twiddle)",
         lambda: torch.fft.ifft(yc, dim=1)), K=2)
    del yc, ys[2]

    # -- kernel 11, the packed reduce over the K = 4 bands
    Yr, Yi = ys[4]
    maps = standard_band_maps()
    table = fs.band_table(maps, dev)
    a11 = (Yr, Yi, 4, R2, nfft)
    got = fs.reduce_packed_cuda(*a11, table, tabs)
    want = fs.reduce_packed_plain(*a11, maps, tabs)
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    check(rel <= FFT_REDUCE_REL,
          f"reduce kernel rel err {rel} > {FFT_REDUCE_REL}")
    del got, want
    yc = torch.complex(Yr, Yi).view(4 * R2, fs.A, S)
    out["fft_reduce_stage_a_packed"] = kernel_entry(
        "fft_reduce_stage_a_packed", "amw_tpu_torch/csrc/fft_reduce.cu",
        "amw_tpu/ops/fft_pallas.py:991", [2 * R2, nfft], err, rel,
        FFT_REDUCE_REL, lambda: fs.reduce_packed_cuda(*a11, table, tabs),
        lambda: fs.reduce_packed_plain(*a11, maps, tabs),
        (2 * 4 * R2 * nfft + 2 * nfft + 2 * R2 * nfft) * 4,
        4 * R2 * nfft * (5 * 7 + 6 + 2 + 2 * 12),
        ("torch.fft.ifft(dim=1) of [32, 128, 65536] complex (no twiddle, "
         "no maps)", lambda: torch.fft.ifft(yc, dim=1)), K=4)
    return out


def yardstick_order(nfft: int, dev) -> torch.Tensor:
    """Per a' row, the stored positions in natural order of the joint
    (b, c) DFT index: stored (a', b', p) holds k = a' + A * k2 with
    k2 = b' + B * k3."""
    k2 = ((fs._perm(nfft).reshape(fs.A, nfft // fs.A)
           - np.arange(fs.A)[:, None]) // fs.A)
    return torch.from_numpy(np.argsort(k2, axis=1)).to(dev)


def phase_new_kernels(dev, tau_ns: float) -> dict:
    """The four kernels of the v2 job's path against their plain versions:
    kernel 8 (one response) on the 180 s batch's 8 packed rows and on one
    unpacked row at nfft = 2^23; kernel 12 over K = 4 bands of one mono
    180 s row; the chunked envelope at [16, 7 938 000] with the transient
    designer's slow ballistics (5 ms / 100 ms); the per-row envelope at the
    2 s clip's own [2, 88 200] and at [16, 88 200]."""
    g = torch.Generator(device="cpu").manual_seed(2)
    nfft = LONG_NFFT
    n = int(SR * LONG[0])
    rows = BATCH * 2
    R2 = rows // 2
    S = nfft // fs.A
    lg = 16  # log2(B * C)
    tabs = fs._device_tables(nfft, dev)
    out = {}

    # -- kernel 8: stage-A output of the packed 180 s batch, one response
    x = (0.3 * torch.randn(rows, n, generator=g)).to(dev)
    Xr, Xi = fs.stage_a_cuda(x[:R2], x[R2:], nfft, False, tabs)
    h = 0.25 + torch.rand(nfft // 2 + 1, generator=g, dtype=torch.float64)
    resp = torch.from_numpy(fs.permute_full_response(h.numpy(), nfft)).to(dev)
    a8 = (Xr, Xi, resp, nfft, tabs)
    Yr, Yi = fs.bc_cb_cuda(*a8)
    Pr, Pi = fs.bc_cb_plain(*a8)
    torch.cuda.synchronize()
    e = [rel_err(Yr, Pr), rel_err(Yi, Pi)]
    err, rel = max(v[0] for v in e), max(v[1] for v in e)
    check(rel <= FFT_REL, f"B/C one-response kernel rel err {rel} > {FFT_REL}")
    del Pr, Pi, Yr, Yi
    # unpacked: one real row (a mono track)
    Ur, Ui = fs.stage_a_cuda(x[:1], None, nfft, False, tabs, real_in=True)
    u8 = (Ur, Ui, resp, nfft, tabs)
    got = fs.bc_cb_cuda(*u8)
    want = fs.bc_cb_plain(*u8)
    torch.cuda.synchronize()
    rel_u = max(rel_err(got[0], want[0])[1], rel_err(got[1], want[1])[1])
    check(rel_u <= FFT_REL, f"B/C kernel, one row: rel err {rel_u}")
    del got, want
    order = yardstick_order(nfft, dev)
    xc = torch.complex(Xr, Xi).view(R2, fs.A, S)
    hn = torch.gather(torch.complex(resp[0], resp[1]).view(fs.A, S), 1, order)

    def lib8():
        X = torch.fft.fft(xc, dim=-1)
        return torch.fft.ifft(X * hn, dim=-1, norm="forward")

    nbytes = (4 * R2 * nfft + 2 * nfft) * 4
    out["fft_bc_cb"] = kernel_entry(
        "fft_bc_cb", "amw_tpu_torch/csrc/fft_bccb.cu",
        "amw_tpu/ops/fft_pallas.py:658", [R2, nfft], err, rel, FFT_REL,
        lambda: fs.bc_cb_cuda(*a8), lambda: fs.bc_cb_plain(*a8), nbytes,
        R2 * nfft * (5 * lg + 6 + 6 + 5 * lg + 6),
        ("torch.fft.fft + mul + torch.fft.ifft along the joint (b, c) axis "
         "of [8, 128, 65536] complex", lib8),
        max_rel_err_unpacked=rel_u,
        unpacked_ms=cuda_ms(lambda: fs.bc_cb_cuda(*u8)),
        **passes_ms(lambda: fs.bc_cb_cuda(*a8), "cstage_multi_kernel"),
        cpass_bound_ms=bound_ms(nbytes, 0)[0],
        bfwd_bound_ms=bound_ms(4 * R2 * nfft * 4, 0)[0],
        binv_bound_ms=bound_ms(4 * R2 * nfft * 4, 0)[0])
    del xc, Xr, Xi, Ur, Ui, x, a8, u8

    # -- kernel 12: K = 4 band spectra of one mono 180 s row
    K = 4
    xm = (0.3 * torch.randn(1, n, generator=g)).to(dev)
    H = 0.25 + torch.rand(K, nfft // 2 + 1, generator=g, dtype=torch.float64)
    resps = torch.from_numpy(np.stack([fs.permute_full_response(hk.numpy(),
                                                                nfft)
                                       for hk in H])).to(dev)
    Mr, Mi = fs.stage_a_cuda(xm, None, nfft, False, tabs, real_in=True)
    Yr, Yi = fs.bccb_multi_cuda(Mr, Mi, resps, nfft, tabs)
    del Mr, Mi
    maps = standard_band_maps()
    table = fs.band_table(maps, dev)
    a12 = (Yr, Yi, K, 1, nfft)
    got = fs.reduce_cuda(*a12, table, tabs)
    want = fs.reduce_plain(*a12, maps, tabs)
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    check(rel <= FFT_REDUCE_REL,
          f"unpacked reduce kernel rel err {rel} > {FFT_REDUCE_REL}")
    del got, want
    yc = torch.complex(Yr, Yi).view(K, fs.A, S)
    out["fft_reduce_stage_a"] = kernel_entry(
        "fft_reduce_stage_a", "amw_tpu_torch/csrc/fft_reduce.cu",
        "amw_tpu/ops/fft_pallas.py:1017", [K, 1, nfft], err, rel,
        FFT_REDUCE_REL, lambda: fs.reduce_cuda(*a12, table, tabs),
        lambda: fs.reduce_plain(*a12, maps, tabs),
        (2 * K * nfft + nfft + 2 * nfft) * 4,
        K * nfft * (5 * 7 + 6 + 2 + 12),
        ("torch.fft.ifft(dim=1) of [4, 128, 65536] complex (no twiddle, "
         "no maps)", lambda: torch.fft.ifft(yc, dim=1)), K=K)
    del yc, Yr, Yi, xm, resps

    # -- kernel 2': the chunked envelope, transient designer's slow follower,
    #    at the card geometry (the main path's) and at chunk_geometry's
    att, rel_c = scan.ar_coefs(SR, 0.005, 0.1)
    v = (0.3 * torch.randn(rows, n, generator=g)).abs().to(dev)
    w0 = scan.warmup_len(att, rel_c)
    geoms = {"card": scan.scan_geometry(rows, n, w0, scan.sm_count(dev)),
             "chunk": scan.chunk_geometry(rows, n, w0)}
    errs = {}
    for key, geom in geoms.items():
        got = scan.env_scan_cuda(v, *geom, att, rel_c)
        want = scan.env_scan_plain(v, *geom, att, rel_c)
        torch.cuda.synchronize()
        errs[key] = float((got - want).abs().max())
        check(errs[key] <= ENV_ATOL, f"chunked envelope kernel err "
              f"{errs[key]} > {ENV_ATOL} at (W, C, K) = {geom}")
        del got, want
    a2 = (v, *geoms["card"], att, rel_c)
    a_chunk = (v, *geoms["chunk"], att, rel_c)
    W, C, Kc = geoms["card"]
    Wp, Cp, _ = geoms["chunk"]
    # per sample: compare, select, subtract, fused multiply-add
    out["env_scan"] = kernel_entry(
        "env_scan", "amw_tpu_torch/csrc/env_scan.cu",
        "amw_tpu/ops/scan.py:375", [rows, n], max(errs.values()), None,
        ENV_ATOL, lambda: scan.env_scan_cuda(*a2),
        lambda: scan.env_scan_plain(*a2), 2 * rows * n * 4, rows * n * 5,
        None, plain_reps=1, W=W, C=C, K=Kc, serial_steps=W + C,
        latency_bound_ms=(W + C) * tau_ns * 1e-6,
        max_abs_err_card_geometry=errs["card"],
        chunk_geometry=list(geoms["chunk"]),
        ms_chunk_geometry=cuda_ms(lambda: scan.env_scan_cuda(*a_chunk)),
        max_abs_err_chunk_geometry=errs["chunk"],
        latency_bound_ms_chunk_geometry=(Wp + Cp) * tau_ns * 1e-6,
        ballistics_ms=[5.0, 100.0])
    del v, a2, a_chunk

    # -- kernel 3: one sequence per row at the 2 s clip's own [2, 88 200]
    #    (the main path's) and at [16, 88 200]
    ns = int(SR * SHORT_CLIP_S)
    v16 = (0.3 * torch.randn(rows, ns, generator=g)).abs().to(dev)
    v = v16[:2].contiguous()
    errs = {}
    for vv in (v, v16):
        got = scan.env_rows_cuda(vv, att, rel_c)
        want = scan.env_rows_plain(vv, att, rel_c)
        torch.cuda.synchronize()
        errs[vv.shape[0]] = float((got - want).abs().max())
        check(errs[vv.shape[0]] <= ENV_ATOL, f"per-row envelope kernel err "
              f"{errs[vv.shape[0]]} > {ENV_ATOL} at {list(vv.shape)}")
        del got, want
    out["env_rows"] = kernel_entry(
        "env_rows", "amw_tpu_torch/csrc/env_scan.cu",
        "amw_tpu/ops/scan.py:122", list(v.shape), max(errs.values()), None,
        ENV_ATOL, lambda: scan.env_rows_cuda(v, att, rel_c),
        lambda: scan.env_rows_plain(v, att, rel_c),
        2 * v.numel() * 4, v.numel() * 5, None, plain_reps=1,
        serial_steps=ns, latency_bound_ms=ns * tau_ns * 1e-6,
        max_abs_err_2_rows=errs[2], shape_16_rows=[rows, ns],
        ms_16_rows=cuda_ms(lambda: scan.env_rows_cuda(v16, att, rel_c)),
        max_abs_err_16_rows=errs[rows],
        latency_bound_ms_16_rows=ns * tau_ns * 1e-6,
        ballistics_ms=[5.0, 100.0])
    return out


def inv_passes_ms(fn) -> dict:
    """Kernel 7's or 10's two passes alone, ms a launch, from one profile:
    the C pass and the inverse B pass; raises where the profiler recorded
    no launch of either."""
    table = profile_ms(fn)
    return {"cpass_ms": pass_ms(table, "cstage_inv_kernel"),
            "binv_ms": pass_ms(table, *B_INV)}


def phase_split_kernels(dev) -> dict:
    """The split route's three kernels against their plain versions at the
    split v1 batch's shapes (nfft = 2^23, the packed stage-A output of 16
    rows of 7 938 000 samples): kernel 6 (forward B+C), kernel 7 (inverse
    C+B with one response, and without one; also on one unpacked row) and
    kernel 10 (K = 2 and 4 responses)."""
    g = torch.Generator(device="cpu").manual_seed(3)
    nfft = LONG_NFFT
    n = int(SR * LONG[0])
    rows = BATCH * 2
    R2 = rows // 2
    S = nfft // fs.A
    lg = 16  # log2(B * C)
    t2_bytes = 2 * nfft // fs.A * 4  # one direction's T2 table
    tabs = fs._device_tables(nfft, dev)
    out = {}
    x = (0.3 * torch.randn(rows, n, generator=g)).to(dev)
    Xr, Xi = fs.stage_a_cuda(x[:R2], x[R2:], nfft, False, tabs)
    H = 0.25 + torch.rand(4, nfft // 2 + 1, generator=g, dtype=torch.float64)
    resps = torch.from_numpy(np.stack([fs.permute_full_response(h.numpy(),
                                                                nfft)
                                       for h in H])).to(dev)

    # -- kernel 6: forward B+C into the stored spectrum
    a6 = (Xr, Xi, nfft, tabs)
    Sr, Si = fs.bc_cuda(*a6)
    Pr, Pi = fs.bc_plain(*a6)
    torch.cuda.synchronize()
    e = [rel_err(Sr, Pr), rel_err(Si, Pi)]
    err, rel = max(v[0] for v in e), max(v[1] for v in e)
    check(rel <= FFT_REL, f"forward B/C kernel rel err {rel} > {FFT_REL}")
    del Pr, Pi
    xc = torch.complex(Xr, Xi).view(R2, fs.A, S)
    out["fft_bc"] = kernel_entry(
        "fft_bc", "amw_tpu_torch/csrc/fft_split.cu",
        "amw_tpu/ops/fft_pallas.py:608", [R2, nfft], err, rel, FFT_REL,
        lambda: fs.bc_cuda(*a6), lambda: fs.bc_plain(*a6),
        4 * R2 * nfft * 4 + t2_bytes, R2 * nfft * (5 * lg + 6),
        ("torch.fft.fft along the joint (b, c) axis of [8, 128, 65536] "
         "complex", lambda: torch.fft.fft(xc, dim=-1)),
        # the one pass alone (torch.profiler), beside the kernel's bound
        onepass_ms=kernel_ms(lambda: fs.bc_cuda(*a6), "bc_onepass_kernel"))
    # the yardstick's spectrum in natural order, the responses gathered
    Xn = torch.fft.fft(xc, dim=-1)
    del xc
    order = yardstick_order(nfft, dev)
    hn = torch.gather(torch.complex(resps[:, 0], resps[:, 1]).view(4, fs.A, S),
                      2, order.expand(4, -1, -1))[:, None]

    # -- kernel 7: inverse C+B under one response, and without one
    a7 = (Sr, Si, resps[0], nfft, tabs)
    Yr, Yi = fs.cb_cuda(*a7)
    Pr, Pi = fs.cb_plain(*a7)
    torch.cuda.synchronize()
    e = [rel_err(Yr, Pr), rel_err(Yi, Pi)]
    err, rel = max(v[0] for v in e), max(v[1] for v in e)
    check(rel <= FFT_REL, f"inverse C/B kernel rel err {rel} > {FFT_REL}")
    del Pr, Pi

    def lib7():
        return torch.fft.ifft(Xn * hn[0], dim=-1, norm="forward")

    lib_err = rel_err(lib7().reshape(R2, nfft).real, Yr)[1]
    del Yr, Yi
    a7n = (Sr, Si, None, nfft, tabs)
    got = fs.cb_cuda(*a7n)
    want = fs.cb_plain(*a7n)
    torch.cuda.synchronize()
    rel_n = max(rel_err(got[0], want[0])[1], rel_err(got[1], want[1])[1])
    check(rel_n <= FFT_REL, f"inverse C/B kernel, no response: {rel_n}")
    del got, want
    # one unpacked row (a mono track): real-in stage A, then kernel 6
    Ur, Ui = fs.bc_cuda(*fs.stage_a_cuda(x[:1], None, nfft, False, tabs,
                                         real_in=True), nfft, tabs)
    u7 = (Ur, Ui, resps[0], nfft, tabs)
    got = fs.cb_cuda(*u7)
    want = fs.cb_plain(*u7)
    torch.cuda.synchronize()
    rel_u = max(rel_err(got[0], want[0])[1], rel_err(got[1], want[1])[1])
    check(rel_u <= FFT_REL, f"inverse C/B kernel, one row: rel err {rel_u}")
    del got, want
    out["fft_cb"] = kernel_entry(
        "fft_cb", "amw_tpu_torch/csrc/fft_split.cu",
        "amw_tpu/ops/fft_pallas.py:628", [R2, nfft], err, rel, FFT_REL,
        lambda: fs.cb_cuda(*a7), lambda: fs.cb_plain(*a7),
        (4 * R2 * nfft + 2 * nfft) * 4 + t2_bytes,
        R2 * nfft * (6 + 5 * lg + 6),
        ("mul + torch.fft.ifft along the joint (b, c) axis of "
         "[8, 128, 65536] complex", lib7),
        library_rel_err=lib_err, max_rel_err_no_response=rel_n,
        no_response_ms=cuda_ms(lambda: fs.cb_cuda(*a7n)),
        max_rel_err_unpacked=rel_u,
        unpacked_ms=cuda_ms(lambda: fs.cb_cuda(*u7)),
        unpacked_bound_ms=bound_ms((4 * nfft + 2 * nfft) * 4 + t2_bytes,
                                   nfft * (6 + 5 * lg + 6))[0],
        **inv_passes_ms(lambda: fs.cb_cuda(*a7)),
        cpass_bound_ms=bound_ms((4 * R2 * nfft + 2 * nfft) * 4, 0)[0],
        binv_bound_ms=bound_ms(4 * R2 * nfft * 4, 0)[0])
    del Ur, Ui, u7

    # -- kernel 10: one stored spectrum under K responses
    for K in (2, 4):
        a10 = (Sr, Si, resps[:K], nfft, tabs)
        Yr, Yi = fs.cb_multi_cuda(*a10)
        Pr, Pi = fs.cb_multi_plain(*a10)
        torch.cuda.synchronize()
        e = [rel_err(Yr, Pr), rel_err(Yi, Pi)]
        err, rel = max(v[0] for v in e), max(v[1] for v in e)
        check(rel <= FFT_REL, f"inverse C/B kernel (K={K}) rel err {rel}")
        del Pr, Pi, Yr, Yi

        def lib10(K=K):
            return torch.fft.ifft(Xn[None] * hn[:K], dim=-1, norm="forward")

        nbytes = (2 * R2 * nfft + 2 * K * nfft + 2 * K * R2 * nfft) * 4
        entry = kernel_entry(
            "fft_cb_multi", "amw_tpu_torch/csrc/fft_split.cu",
            "amw_tpu/ops/fft_pallas.py:718", [R2, nfft], err, rel, FFT_REL,
            lambda a10=a10: fs.cb_multi_cuda(*a10),
            lambda a10=a10: fs.cb_multi_plain(*a10), nbytes + t2_bytes,
            R2 * nfft * K * (6 + 5 * lg + 6),
            ("K x (mul + torch.fft.ifft) along the joint (b, c) axis of "
             "[8, 128, 65536] complex", lib10), K=K,
            **inv_passes_ms(lambda a10=a10: fs.cb_multi_cuda(*a10)),
            cpass_bound_ms=bound_ms(nbytes, 0)[0],
            binv_bound_ms=bound_ms(4 * K * R2 * nfft * 4, 0)[0])
        if K == 2:
            out["fft_cb_multi"] = entry
        else:
            out["fft_cb_multi"]["k4"] = {
                k: entry[k] for k in ("ms", "plain_ms", "bound_ms",
                                      "library_ms", "max_rel_err",
                                      "cpass_ms", "cpass_bound_ms",
                                      "binv_ms", "binv_bound_ms")}
    return out


def phase_entry(dev) -> None:
    """The staged FFT's entry points against torch.fft on the same inputs:
    at the 180 s batch's [16, 2^23] (K = 2 responses, and the K = 4 bands
    with the chain's maps), then 2 rows at every staged plan."""
    g = torch.Generator(device="cpu").manual_seed(1)
    nfft = LONG_NFFT
    n = int(SR * LONG[0])
    x = (0.3 * torch.randn(BATCH * 2, n, generator=g)).to(dev)
    H = torch.rand(4, nfft // 2 + 1, generator=g, dtype=torch.float64) + 0.25
    resps = torch.from_numpy(np.stack([fs.permute_full_response(h.numpy(),
                                                                nfft)
                                       for h in H])).to(dev)
    Hd = H.float().to(dev)
    maps = standard_band_maps()

    def staged2():
        return fs.roundtrip_multi(x, resps[:2], nfft, n)

    def torch2():
        X = torch.fft.rfft(x, n=nfft, dim=-1)
        return torch.fft.irfft(X[None] * Hd[:2, None], n=nfft,
                               dim=-1)[..., :n]

    def staged4():
        return fs.roundtrip_multi_reduce(x, resps, nfft, n, maps)

    def torch4():
        X = torch.fft.rfft(x, n=nfft, dim=-1)
        ys = torch.fft.irfft(X[None] * Hd[:, None], n=nfft, dim=-1)[..., :n]
        return sum(maps[k](ys[k]) for k in range(4))

    err2 = float((staged2() - torch2()).abs().max())
    err4 = rel_err(staged4(), torch4())[1]
    check(err2 <= FFT_RT_ATOL, f"roundtrip_multi err {err2} vs torch.fft")
    check(err4 <= FFT_REDUCE_REL,
          f"roundtrip_multi_reduce rel err {err4} vs torch.fft")
    emit({"phase": "entry", "shape": [BATCH * 2, n], "nfft": nfft,
          "roundtrip_multi_k2": {"ms": cuda_ms(staged2, reps=10),
                                 "torch_fft_ms": cuda_ms(torch2, reps=10),
                                 "max_abs_err": err2},
          "roundtrip_multi_reduce_k4": {
              "ms": cuda_ms(staged4, reps=10),
              "torch_fft_ms": cuda_ms(torch4, reps=10),
              "max_rel_err": err4}})
    del x, resps, Hd

    sweep = []
    for k in range(19, 25):
        nfft = 1 << k
        m = nfft - 12345
        x = torch.randn(2, m, generator=g).to(dev)
        H = torch.rand(2, nfft // 2 + 1, generator=g,
                       dtype=torch.float64) + 0.25
        resps = torch.from_numpy(np.stack([
            fs.permute_full_response(h.numpy(), nfft) for h in H])).to(dev)
        Hd = H.float().to(dev)

        def staged(x=x, resps=resps, nfft=nfft, m=m):
            return fs.roundtrip_multi(x, resps, nfft, m)

        def ref(x=x, Hd=Hd, nfft=nfft, m=m):
            X = torch.fft.rfft(x, n=nfft, dim=-1)
            return torch.fft.irfft(X[None] * Hd[:, None], n=nfft,
                                   dim=-1)[..., :m]

        err = float((staged() - ref()).abs().max())
        check(err <= FFT_RT_ATOL, f"roundtrip_multi at 2^{k}: err {err}")
        sweep.append({"nfft": nfft, "C": nfft // (fs.A * fs.B),
                      "max_abs_err": err, "ms": cuda_ms(staged, reps=10),
                      "torch_fft_ms": cuda_ms(ref, reps=10)})
    emit({"phase": "sweep", "rows": 2, "K": 2, "atol": FFT_RT_ATOL,
          "plans": sweep})


def track_lufs(sig: np.ndarray, nv: np.ndarray) -> np.ndarray:
    """Integrated loudness of each track of ``sig`` [B, C, n] over its valid
    length (the port's meter on the CPU, the CPU FFT plan)."""
    n = sig.shape[-1]
    nfft = design.next_fft_size(n + meters.k_weight_settle(SR))
    Hk = torch.from_numpy(meters.k_weight_response(SR, nfft))
    return meters.integrated_lufs(
        torch.as_tensor(sig), Hk, nfft, meters.plan_blocks(SR, n),
        n_valid=torch.as_tensor(nv)).numpy()


@functools.cache
def make_batch(dur: float, valid_s, batch: int, channels: int,
               seed0: int = 0):
    """``batch`` tracks of ``dur`` s (``make_track``, first ``channels``),
    the last ``len(valid_s)`` zero past their valid seconds, and the valid
    lengths; made once for the runs that share them (read only)."""
    xb = np.stack([make_track(SR, dur, seed=seed0 + i)[:channels]
                   for i in range(batch)])
    nv = valid_lengths(dur, valid_s, batch)
    for i in range(batch):
        xb[i, :, nv[i]:] = 0.0
    return xb, nv


def valid_lengths(dur: float, valid_s, batch: int) -> np.ndarray:
    """[batch] valid lengths: ``dur`` s, the last ``len(valid_s)`` tracks
    ``valid_s`` s."""
    nv = np.full(batch, int(SR * dur), np.int32)
    if valid_s:
        nv[-len(valid_s):] = [int(v * SR) for v in valid_s]
    return nv


def batch_rows(dur: float, valid_s, batch: int, channels: int, seed0: int,
               idx: tuple) -> tuple:
    """The tracks ``idx`` of :func:`make_batch`'s batch and their valid
    lengths, made alone (equal to ``make_batch(...)`` indexed by ``idx``)."""
    nv = valid_lengths(dur, valid_s, batch)[list(idx)]
    x = np.stack([make_track(SR, dur, seed=seed0 + i)[:channels]
                  for i in idx])
    for j in range(len(idx)):
        x[j, :, nv[j]:] = 0.0
    return x, nv


def cpu_v1(dur: float, valid_s, idx: tuple, v1_kw: dict) -> tuple:
    """A v1 run's plain path on the CPU (:func:`phase_slice`'s parity):
    the tracks ``idx`` of its batch through the chain built on the CPU.
    Returns the output, its loudness and the run's seconds."""
    x, nv = batch_rows(dur, valid_s, BATCH, 2, 0, idx)
    spec = GraphSpec(sr=SR, n=int(SR * dur), channels=2)
    params, fn, _ = build_v1_pipeline(spec, target_lufs=TARGET_LUFS,
                                      style="standard", device="cpu",
                                      **v1_kw)
    with torch.no_grad():
        t0 = time.perf_counter()
        y = fn(torch.from_numpy(x), params, torch.from_numpy(nv)).numpy()
        cpu_s = time.perf_counter() - t0
    return y, track_lufs(y, nv), cpu_s


def cpu_v2(dur: float, valid_s, batch: int, channels: int, idx: tuple,
           style: str, config, pro: dict) -> tuple:
    """A v2 run's plain path on the CPU (:func:`phase_v2`'s parity): the
    tracks ``idx`` of its batch through the job graph built on the CPU.
    Returns the graph's outputs (numpy), the output's loudness and the
    run's seconds."""
    x, nv = batch_rows(dur, valid_s, batch, channels, 10, idx)
    spec = GraphSpec(sr=SR, n=int(SR * dur), channels=channels)
    params, fn, _ = build_v2_job_graph(spec, config, pro,
                                       STYLE_CONFIGS[style]["lufs"], style,
                                       device="cpu")
    with torch.no_grad():
        t0 = time.perf_counter()
        res = fn(torch.from_numpy(x), params, torch.from_numpy(nv))
        cpu_s = time.perf_counter() - t0
    res = {k: v.numpy() for k, v in res.items()}
    return res, track_lufs(res["out"], nv), cpu_s


def _parity_worker(threads: int) -> None:
    torch.set_num_threads(threads)


class CpuParity:
    """The runs' plain paths on the CPU, computed by worker processes
    (spawned, so they never touch CUDA) while the card phases run: each
    run's job is submitted under its label at the start and collected by
    that label.  Inside :meth:`paused` the workers are stopped, so that a
    timed loop has the host to itself."""

    def __init__(self) -> None:
        self.pool = None
        self.pids: list = []
        self.jobs: dict = {}
        self.depth = 0

    def start(self, workers: int, threads: int) -> None:
        import multiprocessing

        before = set(multiprocessing.active_children())
        self.pool = multiprocessing.get_context("spawn").Pool(
            workers, initializer=_parity_worker, initargs=(threads,))
        self.pids = [p.pid for p in set(multiprocessing.active_children())
                     - before]
        check(len(self.pids) == workers,
              f"CPU parity: {len(self.pids)} workers, expected {workers}")

    def submit(self, label: str, fn, args: tuple) -> None:
        self.jobs[label] = self.pool.apply_async(fn, args)

    def result(self, label: str):
        check(label in self.jobs, f"{label}: no CPU parity job submitted")
        return self.jobs.pop(label).get()

    @contextlib.contextmanager
    def paused(self):
        """The workers stopped (SIGSTOP) inside the block and continued
        (SIGCONT) after it, also when it raises; nested blocks stop them
        once."""
        self.depth += 1
        if self.depth == 1:
            for pid in self.pids:
                os.kill(pid, signal.SIGSTOP)
        try:
            yield
        finally:
            self.depth -= 1
            if self.depth == 0:
                for pid in self.pids:
                    os.kill(pid, signal.SIGCONT)

    def stop(self) -> None:
        if self.pool is not None:
            self.pool.terminate()
            self.pool.join()
            self.pool = None
        self.pids = []
        self.jobs.clear()


PARITY = CpuParity()


@dataclasses.dataclass(frozen=True)
class V1Run:
    """A v1 run (:func:`phase_slice`): 8 stereo tracks of ``dur`` s, the
    last two bucket-padded to ``valid_s``; ``cpu_tracks`` run again on the
    port's CPU path for parity; ``v1_kw``: more options of
    ``build_v1_pipeline``.  The card run and its CPU parity both read
    these fields."""
    label: str
    dur: float
    valid_s: tuple
    cpu_tracks: tuple = tuple(range(BATCH))
    v1_kw: dict = dataclasses.field(default_factory=dict)

    def parity(self) -> tuple:
        return cpu_v1, (self.dur, self.valid_s, self.cpu_tracks, self.v1_kw)


@dataclasses.dataclass(frozen=True)
class V2Run:
    """A v2 run (:func:`phase_v2`): ``batch`` tracks of ``dur`` s with
    ``channels`` channels at ``style`` and its target loudness, through
    the chain config of :func:`options_config` with ``options``, else
    ``config`` (None: the default), and the pro set ``pro``;
    ``cpu_tracks`` run again on the port's CPU path for parity."""
    label: str
    dur: float
    valid_s: tuple
    batch: int
    channels: int
    style: str
    cpu_tracks: tuple
    options: bool = False
    config: dict | None = None
    pro: dict = dataclasses.field(default_factory=lambda: V2_PRO)

    def chain_config(self):
        return options_config() if self.options else self.config

    def parity(self) -> tuple:
        return cpu_v2, (self.dur, self.valid_s, self.batch, self.channels,
                        self.cpu_tracks, self.style, self.chain_config(),
                        self.pro)


def parity_runs(ref_env: np.ndarray) -> dict:
    """Every v1 and v2 run of :func:`run_phases` by label, in the order it
    checks them: the one place each run's batch, options and parity
    tracks are written."""
    last = (BATCH - 1,)
    runs = [V1Run("v1_5s", *SHORT),
            V1Run("v1_180s", *LONG, last),
            V2Run("v2_180s", *LONG, BATCH, 2, "standard", last),
            V2Run("v2_mono_180s", LONG[0], (), 1, 1, "podcast", (0,)),
            V2Run("v2_clip_2s", SHORT_CLIP_S, (), 1, 2, "edm", (0,)),
            V2Run("v2_options_180s", LONG[0], (), 1, 2, "standard", (0,),
                  options=True),
            V2Run("v2_denoise_180s", *LONG, BATCH, 2, "standard", last,
                  pro=V2_DENOISE_PRO),
            V1Run("v1_reference_180s", *LONG, last,
                  {"denoise_strength": V1_DENOISE, "reference_env": ref_env}),
            V2Run("v2_finish_180s", *LONG, BATCH, 2, "standard", last,
                  config=finish_config(), pro=V2_FINISH_PRO),
            V2Run("options_finish_180s", LONG[0], (), 1, 2, "standard",
                  (0,), config=options_finish_config(), pro={})]
    return {run.label: run for run in runs}


def steady_wall(step, reps: int) -> float:
    """Seconds a call of ``step`` in the steady state: two calls, then the
    mean of ``reps``, with the CPU parity workers paused."""
    with PARITY.paused():
        for _ in range(2):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps


def phase_slice(dev, run: V1Run, expect: dict, reps: int = 10,
                target_window: bool = True):
    """Master the batch of ``run`` through the v1 ``standard`` chain on the
    card, its parity tracks held to their CPU path (``PARITY``).
    ``expect``: the launches of each kernel on one batch.
    ``target_window``: hold every track's loudness within 1 LU of the
    target.  Returns the launch counts, a steady-state step for the
    profile, its wall time and the output."""
    label, dur, valid_s = run.label, run.dur, run.valid_s
    n = int(SR * dur)
    t0 = time.perf_counter()
    xb, nv = make_batch(dur, valid_s, BATCH, 2)
    data_s = time.perf_counter() - t0
    spec = GraphSpec(sr=SR, n=n, channels=2)

    t0 = time.perf_counter()
    params, fn, names = build_v1_pipeline(spec, target_lufs=TARGET_LUFS,
                                          style="standard", device=dev,
                                          **run.v1_kw)
    build_s = time.perf_counter() - t0
    x_d = torch.from_numpy(xb).to(dev)
    nv_d = torch.from_numpy(nv).to(dev)

    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        y = fn(x_d, params, nv_d)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        for name, want in expect.items():
            check(launches[name] == want,
                  f"{label}: kernel {name} launched {launches[name]} "
                  f"times, expected {want}")

        y_np = y.cpu().numpy()
        del y
        check(y_np.shape == xb.shape, f"{label}: output shape {y_np.shape}")
        check(bool(np.all(np.isfinite(y_np))), f"{label}: non-finite output")
        check(float(np.max(np.abs(y_np))) <= 1.0,
              f"{label}: output exceeds full scale")
        for i in range(BATCH):
            check(bool(np.all(y_np[i, :, nv[i]:] == 0.0)),
                  f"{label}: padded tail of track {i} not zero")

        idx = list(run.cpu_tracks)
        l_gpu = track_lufs(y_np, nv)
        check(bool(np.all(np.isfinite(l_gpu))), f"{label}: loudness "
              f"{l_gpu.tolist()}")
        check(not target_window
              or bool(np.all(np.abs(l_gpu - TARGET_LUFS) <= 1.0)),
              f"{label}: loudness {l_gpu.tolist()} not within 1 LU of "
              f"{TARGET_LUFS}")

        # the port's plain path on the CPU, same input
        t0 = time.perf_counter()
        y_cpu, l_cpu, cpu_s = PARITY.result(label)
        wait_s = time.perf_counter() - t0
        err = float(np.max(np.abs(y_np[idx] - y_cpu)))
        err_db = 20 * np.log10(max(err, 1e-30))
        d_lu = float(np.max(np.abs(l_gpu[idx] - l_cpu)))
        check(err_db <= PARITY_DBFS,
              f"{label}: GPU vs CPU max error {err_db:.1f} dBFS")
        check(d_lu <= PARITY_LU,
              f"{label}: GPU vs CPU loudness delta {d_lu} LU")

        wall = steady_wall(lambda: fn(x_d, params, nv_d), reps)

    emit({"phase": "slice", "run": label, "stages": names, "batch": BATCH,
          "track_s": dur, "n_valid": nv.tolist(), "data_s": data_s,
          "params_build_s": build_s, "first_batch_s": first_s,
          "launches": launches, "expected_launches": expect,
          "peak_device_gb": peak_gb, "lufs": l_gpu.tolist(),
          "target_window": target_window, "cpu_parity_tracks": idx, "max_err_vs_cpu": err,
          "max_err_vs_cpu_dbfs": err_db, "max_lu_delta_vs_cpu": d_lu,
          "cpu_plain_s": cpu_s, "cpu_parity_wait_s": wait_s,
          "wall_s_per_batch": wall, "realtime_factor": BATCH * dur / wall})
    return launches, (lambda: fn(x_d, params, nv_d)), wall, y_np


def job_expected(n: int, rows: int, style: str, options: bool = False,
                 pro: dict = V2_PRO, exciter_os: int = 0) -> dict:
    """Each kernel's launches on one call of the v2 job with the pro set
    ``pro`` (``V2_PRO`` or a subset of its stages) over ``rows`` signal
    rows (tracks x channels) of ``n`` samples, as the code reads
    (amw_tpu_torch/models/v2_job.py and the ops it builds).  ``options``:
    the chain config of :func:`options_config`; ``exciter_os``: 0 for the
    default config's exciter (on where ``style`` enables it), else a config
    whose exciter runs at that oversampling (its high pass at ``n *
    exciter_os`` samples).  The reverb and the true-peak limiter run no
    kernel (cuFFT and elementwise passes)."""
    e = {name: 0 for name in COUNTERS}
    dyn_eq = bool(pro.get("dynamic_eq_enabled"))
    if pro.get("deesser_enabled"):
        # the de-esser: envelope -> gain, box (scan.deesser_gain_combine)
        e["env_gain"] = e["box_smooth_same"] = 1
    # the envelope followers: the transient designer's fast and slow, one
    # per dynamic-EQ band; routed by scan.short_route as in the JAX package
    ballistics = [(0.0005, 0.005), (0.005, 0.1)] if (
        "transient_attack" in pro) else []
    if dyn_eq:
        ballistics += [(b["attack_ms"] / 1000.0, b["release_ms"] / 1000.0)
                       for b in DYNAMIC_EQ_MASTERING_BANDS]
    for att_s, rel_s in ballistics:
        a, r = scan.ar_coefs(SR, att_s, rel_s)
        short = scan.short_route(n, scan.warmup_len(a, r))
        e["env_rows" if short else "env_scan"] += 1
    packed = rows % 2 == 0

    def fast_passes(count: int) -> None:
        # fast zero-phase passes (zphase.ZP on the staged FFT ->
        # fft_staged.apply_response)
        e["fft_bc_cb"] += count
        e["fft_stage_a"] += count * (1 if packed else 2)
        e["fft_stage_a_inv_join"] += count if packed else 0

    if exciter_os > 1 and fs.plan_ok(design.tpu_fft_plan(n * exciter_os)):
        fast_passes(1)  # the exciter's high pass at the work rate
    if fs.plan_ok(design.tpu_fft_plan(n)):  # the staged FFT, from ~5.8 s
        # rumble, the de-esser's sidechain, one per dynamic-EQ band, the
        # exciter's high pass where it runs at the track's rate
        exciter = (exciter_os == 1 or exciter_os == 0
                   and STYLE_CONFIGS[style]["exciter_db"] >= 0.05)
        fast_passes(int(bool(pro.get("rumble_enabled")))
                    + int(bool(pro.get("deesser_enabled")))
                    + (len(DYNAMIC_EQ_MASTERING_BANDS) if dyn_eq else 0)
                    + int(exciter))
        # the fused sites: target_curve+dynamics (roundtrip_multi_reduce)
        # and normalize+final balance+style EQ (roundtrip_multi)
        e["fft_bccb_multi"] = 2
        e["fft_stage_a"] += 2 if packed else 3
        e["fft_stage_a_inv_join"] += 1 if packed else 0
        e["fft_reduce_stage_a_packed" if packed
          else "fft_reduce_stage_a"] = 1
        if options:
            # the linear-phase target curve runs torch.fft and ends the
            # target_curve+dynamics fusion; the envelope compressor's split
            # is roundtrip_multi over the 4 bands: the join (packed) or
            # stage A real-out (unpacked) instead of the reduce
            e["fft_reduce_stage_a_packed" if packed
              else "fft_reduce_stage_a"] = 0
            e["fft_stage_a_inv_join" if packed else "fft_stage_a"] += 1
    if options:  # one envelope per band (every band ratio is >= 1)
        for att_ms, rel_ms in MULTIBAND_ATTACK_RELEASE_MS:
            a, r = scan.ar_coefs(SR, att_ms / 1000.0, rel_ms / 1000.0)
            short = scan.short_route(n, scan.warmup_len(a, r))
            e["env_rows" if short else "env_scan"] += 1
    return e


def options_config() -> dict:
    """The default chain config with the two chain-config options of
    slice 4: the linear-phase target curve and the envelope compressor."""
    cfg = default_chain_config()
    for m in cfg["modules"]:
        if m["id"] == "target_curve":
            m["phase_mode"] = "linear_phase"
        if m["id"] == "dynamics":
            m["compressor"] = "envelope"
    return cfg


def finish_config() -> dict:
    """The default chain config with the reverb on (plate, M/S: mix_mid
    0.12, mix_side 0.2) and the exciter at 0.6 dB, 2x oversampled."""
    cfg = default_chain_config()
    for m in cfg["modules"]:
        if m["id"] == "reverb":
            m.update(enabled=True, mix_mid=0.12, mix_side=0.2)
        if m["id"] == "exciter":
            m.update(enabled=True, exciter_db=0.6, oversample=2)
    return cfg


def options_finish_config() -> dict:
    """The default chain config with the exciter at 0.6 dB, 4x
    oversampled, the hall reverb mixed plainly (``mix`` 0.15 on every
    channel) and the true-peak limiter as the last chain module, at
    ``OPTIONS_TP_CEILING_DB``."""
    cfg = default_chain_config()
    for m in cfg["modules"]:
        if m["id"] == "reverb":
            m.update(enabled=True, reverb_type="hall", decay_sec=2.2)
        if m["id"] == "exciter":
            m.update(enabled=True, exciter_db=0.6, oversample=4)
    cfg["modules"].append({"id": "true_peak_limiter", "enabled": True,
                           "ceiling_db": OPTIONS_TP_CEILING_DB,
                           "amount": 1.0})
    return cfg


# kernels 4, 8 and 5: the dispatcher that calls each one's counted wrapper
# on a CUDA tensor, and the position of its nfft
PLAN_ARGS = {"fft_stage_a": ("_stage_a", 2),
             "fft_bc_cb": ("_stage_bc_cb", 3),
             "fft_stage_a_inv_join": ("_stage_a_inv_join", 3)}


@contextlib.contextmanager
def staged_plans():
    """Inside the block, the plan of every launch of kernels 4, 8 and 5:
    yields ``{kernel: {nfft: launches}}``, filled as they launch (on a
    CUDA tensor each dispatcher call launches its kernel once through the
    wrapper, or raises; the counters stay the wrappers' own)."""
    seen: dict = {}
    originals = {}
    for name, (attr, pos) in PLAN_ARGS.items():
        f = originals[attr] = getattr(fs, attr)

        def recorded(*a, _f=f, _name=name, _pos=pos, **k):
            if a[0].is_cuda:
                nfft = a[_pos] if len(a) > _pos else k["nfft"]
                plans = seen.setdefault(_name, {})
                plans[nfft] = plans.get(nfft, 0) + 1
            return _f(*a, **k)

        setattr(fs, attr, recorded)
    try:
        yield seen
    finally:
        for attr, f in originals.items():
            setattr(fs, attr, f)


def phase_v2(dev, run: V2Run, reps: int = 5, exciter_os: int = 0,
             tp_ceiling_db: float | None = None, keep: dict | None = None):
    """Master the batch of ``run`` through the v2 job on the card (its
    chain config's exciter at ``exciter_os``): launch counts against
    :func:`job_expected`, output checks, parity of its parity tracks with
    the port's CPU path (``PARITY``), the steady-state realtime factor; with ``tp_ceiling_db`` also every output's true peak
    (``meters.true_peak_dbfs`` per track on the card) against that ceiling.
    ``keep``: where given, ``keep[label]`` is set to the graph's ``(spec,
    params, fn)``.  Returns the launch counts, a steady-state step, its wall time, the
    stage names and the output (host)."""
    label, dur, valid_s, batch, channels, style, options, pro = (
        run.label, run.dur, run.valid_s, run.batch, run.channels, run.style,
        run.options, run.pro)
    n = int(SR * dur)
    config = run.chain_config()
    target = STYLE_CONFIGS[style]["lufs"]
    t0 = time.perf_counter()
    xb, nv = make_batch(dur, valid_s, batch, channels, seed0=10)
    data_s = time.perf_counter() - t0
    spec = GraphSpec(sr=SR, n=n, channels=channels)
    t0 = time.perf_counter()
    params, fn, names = build_v2_job_graph(spec, config, pro, target,
                                           style, device=dev)
    build_s = time.perf_counter() - t0
    x_d = torch.from_numpy(xb).to(dev)
    nv_d = torch.from_numpy(nv).to(dev)
    expect = job_expected(n, batch * channels, style, options, pro,
                          exciter_os)

    with torch.no_grad():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        with staged_plans() as plans:
            res = fn(x_d, params, nv_d)
            torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = read_counts()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        check(launches == expect, f"{label}: launches {launches}, expected "
              f"{expect}")
        if exciter_os > 1 and fs.plan_ok(design.tpu_fft_plan(n * exciter_os)):
            # the exciter's work-rate high pass, one launch of each
            plan = design.tpu_fft_plan(n * exciter_os)
            check(all(plans.get(k, {}).get(plan) == 1 for k in PLAN_ARGS),
                  f"{label}: launches by plan {plans}, expected one of each "
                  f"of {list(PLAN_ARGS)} at {plan}")
        tp_db = None
        if tp_ceiling_db is not None:
            tp_db = [float(meters.true_peak_dbfs(res["out"][i, :, :nv[i]]))
                     for i in range(batch)]
            check(max(tp_db) <= tp_ceiling_db + TP_SLACK_DB,
                  f"{label}: true peaks {tp_db} dBTP above the ceiling "
                  f"{tp_ceiling_db}")
        res = {k: v.cpu().numpy() for k, v in res.items()}
        y = res.pop("out")
        check(y.shape == xb.shape, f"{label}: output shape {y.shape}")
        check(bool(np.all(np.isfinite(y))) and bool(np.all(res["finite"])),
              f"{label}: non-finite output")
        check(float(np.max(np.abs(y))) <= 1.0,
              f"{label}: output exceeds full scale")
        check(bool(np.all(res["peak"] == np.abs(y).reshape(batch, -1)
                          .max(axis=1))), f"{label}: peak stat")
        after = res["after_lufs"]
        check(bool(np.all((after >= target - V2_LU_BELOW)
                          & (after <= target + 1.0))),
              f"{label}: loudness {after.tolist()} outside [{target} - "
              f"{V2_LU_BELOW}, {target} + 1] LU")
        for i in range(batch):
            check(bool(np.all(y[i, :, nv[i]:] == 0.0)),
                  f"{label}: padded tail of track {i} not zero")

        # the port's plain path on the CPU, same input
        idx = list(run.cpu_tracks)
        t0 = time.perf_counter()
        res_c, l_cpu, cpu_s = PARITY.result(label)
        wait_s = time.perf_counter() - t0
        err = float(np.max(np.abs(y[idx] - res_c["out"])))
        err_db = 20 * np.log10(max(err, 1e-30))
        d_lu = float(np.max(np.abs(track_lufs(y[idx], nv[idx]) - l_cpu)))
        d_meter = max(float(np.max(np.abs(res[k][idx] - res_c[k])))
                      for k in ("before_lufs", "after_lufs"))
        check(err_db <= PARITY_DBFS,
              f"{label}: GPU vs CPU max error {err_db:.1f} dBFS")
        check(d_lu <= PARITY_LU, f"{label}: GPU vs CPU loudness delta {d_lu}")
        check(d_meter <= METER_LU,
              f"{label}: GPU vs CPU before/after loudness delta {d_meter}")

        wall = steady_wall(lambda: fn(x_d, params, nv_d), reps)

    emit({"phase": "v2", "run": label, "stages": names, "style": style,
          "config": ("options" if options else
                     "default" if config is None else "custom"),
          "pro": pro, "batch": batch, "channels": channels,
          "track_s": dur, "n_valid": nv.tolist(), "data_s": data_s,
          "params_build_s": build_s, "first_batch_s": first_s,
          "launches": launches, "expected_launches": expect,
          "launches_by_plan": {k: {str(p): c for p, c in v.items()}
                               for k, v in plans.items()},
          "peak_device_gb": peak_gb, "target_lufs": target,
          "before_lufs": res["before_lufs"].tolist(),
          "after_lufs": after.tolist(), "peak": res["peak"].tolist(),
          "cpu_parity_tracks": idx, "max_err_vs_cpu": err,
          "max_err_vs_cpu_dbfs": err_db, "max_lu_delta_vs_cpu": d_lu,
          "max_meter_delta_vs_cpu": d_meter, "cpu_plain_s": cpu_s,
          "cpu_parity_wait_s": wait_s, "true_peak_dbtp": tp_db,
          "wall_s_per_batch": wall,
          "realtime_factor": batch * dur / wall})
    if keep is not None:
        keep[label] = (spec, params, fn, names)
    return launches, (lambda: fn(x_d, params, nv_d)), wall, names, y


@contextlib.contextmanager
def fft_route(split: bool):
    """The staged FFT's route inside the block: ``AMW_FFT_FUSED_RT`` 0
    (the split stages) or 1 (the fused round trips), the earlier value
    restored after it, also when the block raises."""
    old = os.environ.get("AMW_FFT_FUSED_RT")
    os.environ["AMW_FFT_FUSED_RT"] = "0" if split else "1"
    try:
        check(fs.fused_rt() != split, "AMW_FFT_FUSED_RT not read")
        yield
    finally:
        if old is None:
            os.environ.pop("AMW_FFT_FUSED_RT", None)
        else:
            os.environ["AMW_FFT_FUSED_RT"] = old


def phase_v1_split(step, y_fused: np.ndarray, nv: np.ndarray,
                   wall_fused: float, reps: int = 5) -> dict:
    """The v1 180 s batch again on the split route (the same graph and
    input: the route is read at each call): launch counts as the code
    reads (kernel 6 then 10 at each fused site, no kernel 9), the output
    against the fused route's, and the wall beside it."""
    expect = {name: 0 for name in COUNTERS}
    expect.update(box_smooth_same=1, env_gain=1, fft_stage_a=3, fft_bc=3,
                  fft_cb_multi=3, fft_stage_a_inv_join=2,
                  fft_reduce_stage_a_packed=1)
    with torch.no_grad(), fft_route(split=True):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        y = step()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = read_counts()
        check(launches == expect, f"v1 180 s split: launches {launches}, "
              f"expected {expect}")
        y_np = y.cpu().numpy()
        del y
        wall = steady_wall(step, reps)
    check(bool(np.all(np.isfinite(y_np))), "split route: non-finite output")
    err = float(np.max(np.abs(y_np - y_fused)))
    err_db = 20 * np.log10(max(err, 1e-30))
    d_lu = float(np.max(np.abs(track_lufs(y_np, nv) - track_lufs(y_fused,
                                                                  nv))))
    check(err_db <= PARITY_DBFS, f"split vs fused route {err_db:.1f} dBFS")
    check(d_lu <= PARITY_LU, f"split vs fused route loudness delta {d_lu}")
    emit({"phase": "v1_split", "track_s": LONG[0], "batch": BATCH,
          "launches": launches, "expected_launches": expect,
          "first_batch_s": first_s, "max_err_vs_fused": err,
          "max_err_vs_fused_dbfs": err_db, "max_lu_delta_vs_fused": d_lu,
          "wall_s_per_batch": wall, "fused_wall_s_per_batch": wall_fused,
          "realtime_factor": BATCH * LONG[0] / wall})
    return launches


# the analysis runs: label, seconds, channels
ANALYZE_RUNS = (("analyze_180s", 180.0, 2), ("analyze_97s", 97.5, 2),
                ("analyze_mono_180s", 180.0, 1), ("analyze_5s", 5.0, 2))
ANALYZE_TOL = {"correlation": 1e-4}  # else 0.01 LU / dB


def analyze_expected(n_pad: int, channels: int, split: bool) -> dict:
    """Each kernel's launches on one call of the analysis graph at bucket
    length ``n_pad``: its one K-weighting pass (``fft_staged.
    apply_response`` where the plan is staged, else cuFFT)."""
    e = {name: 0 for name in COUNTERS}
    nfft, staged = fs.site_plan(n_pad + meters.k_weight_settle(SR), "cuda")
    if staged:
        packed = channels % 2 == 0
        e["fft_stage_a"] = 1 if packed else 2
        e["fft_stage_a_inv_join"] = 1 if packed else 0
        if split:
            e["fft_bc"] = e["fft_cb"] = 1
        else:
            e["fft_bc_cb"] = 1
    return e


def same_dict(got, want, path: str = "") -> None:
    """The response dicts: same keys, same None pattern, floats within
    0.01 (values rounded to 0.01 may land one step apart), the rest
    equal."""
    check(type(got) is type(want), f"{path}: {type(got)} vs {type(want)}")
    if isinstance(want, dict):
        check(list(got) == list(want), f"{path}: keys {list(got)}")
        for k in want:
            same_dict(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        check(len(got) == len(want), f"{path}: length {len(got)}")
        for i, (a, b) in enumerate(zip(got, want)):
            same_dict(a, b, f"{path}[{i}]")
    elif isinstance(want, float):
        check(abs(got - want) <= 0.01 + 1e-9, f"{path}: {got} vs {want}")
    else:
        check(got == want, f"{path}: {got} vs {want}")


def phase_analyze(dev) -> dict:
    """``analyze(extended=True)`` and ``lufs_analyze_tool`` on the card for
    each of ``ANALYZE_RUNS``, on the fused and the split route: the
    graph's launch counts, its raw outputs and both response dicts against
    the port's CPU path on the same input, the wall per call and the
    realtime factor.  Returns each run's launch counts by label."""
    out = {}
    for i, (label, dur, channels) in enumerate(ANALYZE_RUNS):
        x = make_track(SR, dur, seed=20 + i)[:channels]
        n = x.shape[-1]
        n_pad = _bucket_for(SR, n)
        xp = np.pad(x, ((0, 0), (0, n_pad - n)))
        fn_c, Hk_c = _analysis_graph(SR, n_pad, channels, True, True,
                                     device=torch.device("cpu"))
        t0 = time.perf_counter()
        with torch.no_grad():
            want = {k: v.numpy()
                    for k, v in fn_c(torch.from_numpy(xp), Hk_c, n).items()}
        cpu_s = time.perf_counter() - t0
        dicts_c = (analyze(x, SR, extended=True, device="cpu"),
                   lufs_analyze_tool(x, SR, device="cpu"))
        fn, Hk = _analysis_graph(SR, n_pad, channels, True, True, device=dev)
        x_d = torch.from_numpy(xp).to(dev)
        for route in ("fused", "split"):
            run = f"{label}_split" if route == "split" else label
            with torch.no_grad(), fft_route(split=route == "split"):
                expect = analyze_expected(n_pad, channels, route == "split")
                torch.cuda.synchronize()
                reset_counts()
                got = {k: v.cpu().numpy() for k, v in fn(x_d, Hk, n).items()}
                launches = read_counts()
                check(launches == expect, f"{run}: launches {launches}, "
                      f"expected {expect}")
                errs = {}
                for k, w in want.items():
                    g = got[k]
                    check(g.shape == w.shape, f"{run}: {k} shape {g.shape}")
                    if w.dtype == bool or k == "vectorscope":
                        check(bool(np.array_equal(g, w)), f"{run}: {k}")
                        continue
                    # gated values (-1e9) must agree exactly
                    errs[k] = float(np.max(np.abs(g.astype(np.float64) - w)))
                    check(errs[k] <= ANALYZE_TOL.get(k, 0.01),
                          f"{run}: {k} differs from the CPU path by "
                          f"{errs[k]}")
                dicts = (analyze(x, SR, extended=True, device=dev),
                         lufs_analyze_tool(x, SR, device=dev))
                for d, dc in zip(dicts, dicts_c):
                    same_dict(d, dc, run)
                walls = {}
                for name, call in (
                        ("analyze", lambda: analyze(x, SR, extended=True,
                                                    device=dev)),
                        ("lufs_analyze_tool",
                         lambda: lufs_analyze_tool(x, SR, device=dev))):
                    call()
                    ts = []
                    with PARITY.paused():
                        for _ in range(5):
                            t0 = time.perf_counter()
                            call()  # ends in a copy to the host: synchronous
                            ts.append(time.perf_counter() - t0)
                    walls[name] = statistics.median(ts)
                if run == "analyze_180s":
                    phase_profile(lambda: lufs_analyze_tool(x, SR,
                                                            device=dev),
                                  walls["lufs_analyze_tool"] * 1e3,
                                  "analyze_180s_lufs_tool", reps=3)
            out[run] = launches
            emit({"phase": "analyze", "run": run, "track_s": dur,
                  "channels": channels, "bucket_s": n_pad / SR,
                  "nfft": fs.site_plan(n_pad + meters.k_weight_settle(SR),
                                       dev)[0],
                  "launches": launches, "expected_launches": expect,
                  "max_err_vs_cpu": errs, "cpu_graph_s": cpu_s,
                  "lufs": dicts[0]["lufs"],
                  "true_peak_dbfs": dicts[1]["true_peak_dbfs"],
                  "loudness_range_lu": dicts[1]["loudness_range_lu"],
                  "wall_s_per_call": walls,
                  "realtime_factor": {k: dur / v for k, v in walls.items()}})
        del x_d, fn, Hk
    return out


def tilt(power: np.ndarray, freqs: np.ndarray) -> float:
    """Mean power above 15 kHz over the mean below 30 Hz (DC excluded):
    the high-pass check of the JAX package's noise-shaping test
    (tests/test_coverage_extra.py)."""
    lo = power[..., (freqs > 0) & (freqs < 30.0)].mean()
    return float(power[..., freqs > 15000.0].mean() / lo)


def phase_export(dev, y: np.ndarray, reps: int = 3) -> None:
    """The export path (bench.py:368-396) on the card: the v2 batch's
    output ``y`` [B, C, n] as rows resampled 44.1 -> 48 kHz
    (``fdfilter.resample_fft``), TPDF dither (``dither.dither_noise`` from
    a seeded ``torch.Generator``) and int16 (``dither.quantize16``); no
    kernel of its own (cuFFT and elementwise passes).  Checks: no kernel
    launched, int16 out, the resampled float finite within full scale and
    one row against the port's CPU path (<= -90 dBFS), that row's int16
    equal to ``quantize16`` on the CPU with the same noise; TPDF on a
    silent input (every value in (-1, 1), |mean| < 0.01 LSB, variance
    within 2 % of 1/6, int16 in {-1, 0, 1}); ``ns_e`` and ``ns_itu`` noise
    high-passed (the top octave > 3x near DC) with the filter's own tilt
    (within 0.3-3x of |H|^2's).  Reports the wall time per batch and the
    realtime factor."""
    rows = np.ascontiguousarray(y.reshape(-1, y.shape[-1]))
    n = rows.shape[-1]
    n_out = n * EXPORT_SR // SR
    check(n_out * SR == n * EXPORT_SR, f"export: {n} samples at {SR} Hz")
    x_d = torch.from_numpy(rows).to(dev)
    gen = torch.Generator(device=dev)

    def export(seed: int = 0):
        gen.manual_seed(seed)
        z = fdfilter.resample_fft(x_d, n_out)
        noise = dither.dither_noise(gen, z.shape, "tpdf", device=dev)
        return z, noise, dither.quantize16(z, noise)

    with torch.no_grad():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        z, noise, q = export()
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = read_counts()
        check(not any(launches.values()), f"export: launches {launches}")
        check(q.dtype == torch.int16 and tuple(q.shape) == (rows.shape[0],
                                                           n_out),
              f"export: {q.dtype} {tuple(q.shape)}")
        check(bool(torch.isfinite(z).all()), "export: non-finite resample")
        z_peak = float(z.abs().max())
        check(z_peak <= 1.0, f"export: resampled peak {z_peak}")
        row = rows.shape[0] - 2  # the padded 97.5 s track's left channel
        z_cpu = fdfilter.resample_fft(torch.from_numpy(rows[row]), n_out)
        err = float((z[row].cpu() - z_cpu).abs().max())
        err_db = 20 * np.log10(max(err, 1e-30))
        check(err_db <= PARITY_DBFS,
              f"export: resample GPU vs CPU {err_db:.1f} dBFS")
        q_cpu = dither.quantize16(z[row].cpu(), noise[row].cpu())
        check(torch.equal(q[row].cpu(), q_cpu),
              "export: int16 on the card differs from quantize16 on the CPU")
        del z, noise, q

        gen.manual_seed(1)
        noise = dither.dither_noise(gen, (rows.shape[0], n_out), "tpdf",
                                    device=dev)
        q0 = dither.quantize16(torch.zeros_like(noise), noise)
        nd = noise.double()
        tpdf = {"max_abs": float(nd.abs().max()), "mean": float(nd.mean()),
                "var": float(nd.var()),
                "int16_values": sorted(torch.unique(q0).tolist())}
        del noise, nd, q0
        check(tpdf["max_abs"] < 1.0 and abs(tpdf["mean"]) < 0.01
              and abs(tpdf["var"] - 1.0 / 6.0) <= 0.02 / 6.0
              and set(tpdf["int16_values"]) <= {-1, 0, 1},
              f"export: TPDF statistics {tpdf}")

        shaped = {}
        m = 1 << 16
        freqs = np.fft.rfftfreq(m, 1 / SR)
        for kind, (b, a) in (("ns_e", ((1.0, -1.0), (1.0, -0.99))),
                             ("ns_itu", ((1.0, -2.0, 1.0),
                                         (1.0, -1.96, 0.9604)))):
            ns = dither.dither_noise(gen, (2, m), kind, device=dev)
            power = (torch.fft.rfft(ns.double(), dim=-1).abs() ** 2
                     ).cpu().numpy()
            want = tilt(np.abs(design.freqz(np.asarray(b), np.asarray(a),
                                            m)) ** 2, freqs)
            got = tilt(power, freqs)
            shaped[kind] = {"tilt": got, "filter_tilt": want}
            check(got > 3.0 and 0.3 < got / want < 3.0,
                  f"export: {kind} noise not high-passed: {shaped[kind]}")

        with PARITY.paused():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(reps):
                export(i)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / reps
    dur = n / SR
    emit({"phase": "export", "rows": rows.shape[0], "n_in": n,
          "n_out": n_out, "sr_out": EXPORT_SR, "dither": "tpdf",
          "launches": launches, "first_batch_s": first_s,
          "resampled_peak": z_peak, "cpu_parity_row": row,
          "max_err_vs_cpu": err, "max_err_vs_cpu_dbfs": err_db,
          "tpdf_silence": tpdf, "noise_shaping": shaped,
          "wall_s_per_batch": wall,
          "realtime_factor": rows.shape[0] / 2 * dur / wall})


def phase_vocal(dev, reps: int = 3) -> None:
    """``models.vocal.isolate_vocal`` (the DSP separator: STFT on cuFFT,
    no kernel of its own) on one stereo and one mono 180 s track, one
    track a call as the engine calls it (host array in, host array out):
    no kernel launched, output shape, finite, within full scale, against
    the port's CPU path (<= -90 dBFS, <= 0.1 LU); wall time per call and
    realtime factor."""
    out = {}
    for label, channels in (("stereo", 2), ("mono", 1)):
        x = make_track(SR, LONG[0], seed=VOCAL_SEED)[:channels]
        n = x.shape[-1]
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        y = isolate_vocal(x, SR, device=dev)
        first_s = time.perf_counter() - t0
        launches = read_counts()
        check(not any(launches.values()), f"vocal {label}: launches "
              f"{launches}")
        check(y.shape == x.shape and y.dtype == np.float32,
              f"vocal {label}: {y.dtype} {y.shape}")
        check(bool(np.all(np.isfinite(y))) and float(np.abs(y).max()) <= 1.0,
              f"vocal {label}: non-finite or over full scale")
        t0 = time.perf_counter()
        y_cpu = isolate_vocal(x, SR, device="cpu")
        cpu_s = time.perf_counter() - t0
        err = float(np.max(np.abs(y - y_cpu)))
        err_db = 20 * np.log10(max(err, 1e-30))
        nv = np.array([n], np.int32)
        d_lu = float(np.max(np.abs(track_lufs(y[None], nv)
                                   - track_lufs(y_cpu[None], nv))))
        check(err_db <= PARITY_DBFS,
              f"vocal {label}: GPU vs CPU {err_db:.1f} dBFS")
        check(d_lu <= PARITY_LU, f"vocal {label}: GPU vs CPU {d_lu} LU")
        t0 = time.perf_counter()
        for _ in range(reps):
            isolate_vocal(x, SR, device=dev)
        wall = (time.perf_counter() - t0) / reps
        out[label] = {"channels": channels, "launches": launches,
                      "first_call_s": first_s, "max_err_vs_cpu": err,
                      "max_err_vs_cpu_dbfs": err_db,
                      "max_lu_delta_vs_cpu": d_lu, "cpu_plain_s": cpu_s,
                      "wall_s_per_call": wall,
                      "realtime_factor": n / SR / wall}
    emit({"phase": "vocal", "run": "vocal_180s", "track_s": LONG[0],
          "tracks": out})


# ---- the neural vocal separator (htdemucs) --------------------------------

HT_SEED = 31
HT_ENGINE_S = 30.0  # the engine run's track: the 30 s bucket's graph
HT_SNR_DB = 30.0  # bf16 against f32 (tests/test_htdemucs_parity.py:87-106)
HT_REPS = 3
# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet)
BF16_FLOPS = 989e12
# device kernels by class, first match (torch.profiler kernel names)
KERNEL_CLASSES = (("fft", ("fft",)), ("softmax", ("softmax",)),
                  ("convolution", ("fprop", "dgrad", "wgrad", "conv",
                                   "implicit", "winograd", "cudnn")),
                  ("gemm", ("gemm", "nvjet", "matmul", "cublas", "cutlass")),
                  ("copy", ("memcpy", "memset")))


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in KERNEL_CLASSES:
        if any(k in low for k in keys):
            return cls
    return "elementwise"


@contextlib.contextmanager
def env_set(**values):
    """Environment variables set (``None``: unset) for the block."""
    saved = {k: os.environ.get(k) for k in values}
    try:
        for k, v in values.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def snr_db(ref: np.ndarray, est: np.ndarray) -> float:
    ref = ref.astype(np.float64)
    return float(10 * np.log10(np.sum(ref ** 2) / max(
        np.sum((ref - est) ** 2), 1e-30)))


def ht_bundled(dev) -> dict:
    """(a) ``isolate_vocal`` on the bundled checkpoint (source 1,
    ``AMW_HTDEMUCS_CKPT=bundled``) for a 180 s stereo and a 180 s mono
    track, f32 and bf16 on the card: the network ran (its weights cached
    for the dtype), none of the 13 kernels launched, shape, finite, full
    scale; card f32 against the port's CPU f32 path (<= -90 dBFS, <= 0.1
    LU), card bf16 against card f32 (SNR >= 30 dB); the wall of a call
    (median of 3 after a first); the separation gate in bf16 on the card."""
    out = {}
    with env_set(AMW_HTDEMUCS_CKPT="bundled"):
        for label, channels in (("stereo", 2), ("mono", 1)):
            x = make_track(SR, LONG[0], seed=HT_SEED)[:channels]
            n = x.shape[-1]
            run = {}
            ys = {}
            for mode in ("f32", "bf16"):
                with env_set(AMW_HTDEMUCS_DTYPE=mode):
                    torch.cuda.synchronize()
                    reset_counts()
                    t0 = time.perf_counter()
                    y = isolate_vocal(x, SR, device=dev)
                    first_s = time.perf_counter() - t0
                    launches = read_counts()
                    key = (vocal.BUNDLED, dev, htdemucs.inference_dtype(dev))
                    check(key in vocal._ht_cache,
                          f"htdemucs {label} {mode}: the network did not run")
                    check(not any(launches.values()),
                          f"htdemucs {label} {mode}: launches {launches}")
                    check(y.shape == x.shape and y.dtype == np.float32,
                          f"htdemucs {label} {mode}: {y.dtype} {y.shape}")
                    check(bool(np.all(np.isfinite(y)))
                          and float(np.abs(y).max()) <= 1.0,
                          f"htdemucs {label} {mode}: non-finite or over "
                          "full scale")
                    walls = []
                    for _ in range(HT_REPS):
                        t0 = time.perf_counter()
                        isolate_vocal(x, SR, device=dev)
                        walls.append(time.perf_counter() - t0)
                    wall = statistics.median(walls)
                ys[mode] = y
                run[mode] = {"first_call_s": first_s, "wall_s": wall,
                             "walls_s": walls,
                             "realtime_factor": n / SR / wall}
            with env_set(AMW_HTDEMUCS_DTYPE="f32"):
                t0 = time.perf_counter()
                y_cpu = isolate_vocal(x, SR, device="cpu")
                cpu_s = time.perf_counter() - t0
            err = float(np.max(np.abs(ys["f32"] - y_cpu)))
            err_db = 20 * np.log10(max(err, 1e-30))
            nv = np.array([n], np.int32)
            d_lu = float(np.max(np.abs(track_lufs(ys["f32"][None], nv)
                                       - track_lufs(y_cpu[None], nv))))
            check(err_db <= PARITY_DBFS,
                  f"htdemucs {label}: f32 card vs CPU {err_db:.1f} dBFS")
            check(d_lu <= PARITY_LU,
                  f"htdemucs {label}: f32 card vs CPU {d_lu} LU")
            snr = snr_db(ys["f32"], ys["bf16"])
            check(snr >= HT_SNR_DB,
                  f"htdemucs {label}: bf16 vs f32 SNR {snr:.1f} dB")
            if channels == 2:  # the network alone on the 8 kHz track
                cfg = vocal._htdemucs(dev)[0]
                x8 = scipy.signal.resample(
                    x.astype(np.float64), int(round(n * cfg.samplerate / SR)),
                    axis=-1).astype(np.float32)
                for mode in ("f32", "bf16"):
                    with env_set(AMW_HTDEMUCS_DTYPE=mode):
                        model = vocal._htdemucs(dev)[1]
                        run[mode]["network_ms"] = cuda_ms(
                            lambda: htdemucs.separate(model, x8,
                                                      stems=("vocals",)),
                            reps=HT_REPS, warmup=1)
            out[label] = {**run, "channels": channels,
                          "f32_max_err_vs_cpu": err,
                          "f32_max_err_vs_cpu_dbfs": err_db,
                          "f32_max_lu_delta_vs_cpu": d_lu,
                          "cpu_f32_s": cpu_s, "bf16_snr_vs_f32_db": snr}
        with env_set(AMW_HTDEMUCS_DTYPE="bf16"):
            cfg, model = vocal._htdemucs(dev)
            s_model, s_mix = htdemucs_gate.vocals_snr(model)
        check(htdemucs_gate.passes(s_model, s_mix),
              f"htdemucs: bundled checkpoint separation gate {s_model:.2f} "
              f"dB (mixture {s_mix:.2f} dB)")
    out["gate_bf16"] = {"vocals_snr_db": s_model, "mix_snr_db": s_mix}
    out["params"] = sum(p.numel() for p in model.parameters())
    return out


def ht_released(dev) -> dict:
    """(b) The released shape (``HTConfig()``, ``init_params(seed=0)``),
    written by ``save_params`` to a temporary file and served through the
    entry points: ``isolate_vocal`` of a 180 s stereo track at 44.1 kHz
    (the model's rate: no resample) with ``AMW_HTDEMUCS_CKPT`` naming the
    file, in f32 and bf16 (the weights cached under the file's key for each
    dtype, none of the 13 kernels launched; shape, finite, full scale; bf16
    vs f32 SNR >= 30 dB), then ``warmup_htdemucs((180,))`` (one bucket).
    On the models the entry point loaded: one 7.8 s segment at batch 1,
    card f32 against CPU f32 (<= -90 dBFS); ``separate`` of the track
    (vocals) in f32 and bf16 (SNR >= 30 dB; its f32 vocals are the entry
    point's within -90 dBFS): CUDA-event ms a track (median of 3 after
    one), realtime factor, peak device memory, the FLOPs of the windows run
    (``torch.utils.flop_counter`` on one segment, times the windows) over
    the peak rate of the dtype; a torch.profiler run of one bf16 track:
    device time by kernel class, idle share."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    cfg = htdemucs.HTConfig()
    check(cfg.samplerate == SR, f"released rate {cfg.samplerate}")
    tmp = tempfile.mkdtemp(prefix="amw_htdemucs_released_")
    path = os.path.join(tmp, "htdemucs_released.npz")
    t0 = time.perf_counter()
    state = htdemucs.init_params(cfg, seed=0)
    htdemucs.save_params(state, path, cfg)
    cpu_model = htdemucs.inference_model(cfg, state, device="cpu",
                                         dtype=torch.float32)
    build_s = time.perf_counter() - t0
    n_params = sum(v.numel() for v in state.values())
    del state
    x = make_track(SR, LONG[0], seed=HT_SEED)
    models, voc, entry = {}, {}, {}
    try:
        with env_set(AMW_HTDEMUCS_CKPT=path):
            for mode in ("f32", "bf16"):
                with env_set(AMW_HTDEMUCS_DTYPE=mode):
                    torch.cuda.synchronize()
                    reset_counts()
                    t0 = time.perf_counter()
                    voc[mode] = isolate_vocal(x, SR, device=dev)
                    first_s = time.perf_counter() - t0
                    launches = read_counts()
                    key = (path, dev, htdemucs.inference_dtype(dev))
                    check(key in vocal._ht_cache,
                          f"released {mode}: isolate_vocal did not run the "
                          "network")
                    check(not any(launches.values()),
                          f"released {mode}: launches {launches}")
                    check(voc[mode].shape == x.shape
                          and bool(np.all(np.isfinite(voc[mode])))
                          and float(np.abs(voc[mode]).max()) <= 1.0,
                          f"released {mode}: isolate_vocal "
                          f"{voc[mode].shape}, non-finite or over full "
                          "scale")
                    models[mode] = vocal._ht_cache[key][1]
                    entry[mode] = {"first_call_s": first_s}
            with env_set(AMW_HTDEMUCS_DTYPE="bf16"):
                t0 = time.perf_counter()
                warmed = vocal.warmup_htdemucs((LONG[0],), device=dev)
                warm_s = time.perf_counter() - t0
        check(warmed == 1, f"released warmup: {warmed} buckets")
    finally:
        for k in [k for k in vocal._ht_cache if k[0] == path]:
            del vocal._ht_cache[k]
        shutil.rmtree(tmp, ignore_errors=True)
    entry_snr = snr_db(voc["f32"], voc["bf16"])
    check(entry_snr >= HT_SNR_DB,
          f"released isolate_vocal: bf16 vs f32 SNR {entry_snr:.1f} dB")
    seg = make_track(SR, cfg.segment, seed=HT_SEED + 1)[None]
    check(seg.shape[-1] == cfg.segment_samples, f"segment {seg.shape}")
    y_card = htdemucs.forward(models["f32"], seg).cpu().numpy()
    t0 = time.perf_counter()
    y_cpu = htdemucs.forward(cpu_model, seg).numpy()
    cpu_s = time.perf_counter() - t0
    del cpu_model
    seg_err = float(np.max(np.abs(y_card - y_cpu)))
    seg_db = 20 * np.log10(max(seg_err, 1e-30))
    check(y_card.shape == (1, 4, 2, seg.shape[-1]),
          f"released segment {y_card.shape}")
    check(seg_db <= PARITY_DBFS,
          f"released segment f32 card vs CPU {seg_db:.1f} dBFS")
    with FlopCounterMode(display=False) as fc:
        htdemucs.forward(models["bf16"], seg)
    seg_flops = fc.get_total_flops()

    plan = htdemucs.oa_plan(cfg, x.shape[-1])
    windows = len(plan[2])
    flops = seg_flops * windows
    runs, ys = {}, {}
    for mode, model in models.items():
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ys[mode] = htdemucs.separate(model, x, stems=("vocals",))
        ms = cuda_ms(lambda: htdemucs.separate(model, x, stems=("vocals",)),
                     reps=HT_REPS, warmup=0)
        peak = torch.cuda.max_memory_allocated() / 1e9
        check(ys[mode].shape == (1,) + x.shape
              and bool(np.all(np.isfinite(ys[mode]))),
              f"released {mode}: {ys[mode].shape}, non-finite")
        rate = BF16_FLOPS if mode == "bf16" else F32_FLOPS
        runs[mode] = {"ms": ms, "realtime_factor": LONG[0] / (ms / 1e3),
                      "peak_gb": peak, "bound_ms": flops / rate * 1e3,
                      "bound_by": "operations",
                      "share_of_bound": flops / rate * 1e3 / ms}
    snr = snr_db(ys["f32"], ys["bf16"])
    check(snr >= HT_SNR_DB, f"released: bf16 vs f32 SNR {snr:.1f} dB")
    entry_err = float(np.max(np.abs(
        np.clip(ys["f32"][0], -1.0, 1.0) - voc["f32"])))
    entry_db = 20 * np.log10(max(entry_err, 1e-30))
    check(entry_db <= PARITY_DBFS, f"released f32: isolate_vocal vs "
          f"separate {entry_db:.1f} dBFS")

    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA]) as prof:
        htdemucs.separate(models["bf16"], x, stems=("vocals",))
        torch.cuda.synchronize()
    rows = device_rows(prof, 1)
    by_class: dict = {}
    for name, ms, calls in rows:
        c = by_class.setdefault(kernel_class(name), {"ms": 0.0, "calls": 0})
        c["ms"] += ms
        c["calls"] += calls
    busy = sum(r[1] for r in rows)
    wall = runs["bf16"]["ms"]
    del models
    return {"params": n_params, "build_s": build_s,
            "segment_samples": seg.shape[-1],
            "segment_f32_max_err_vs_cpu": seg_err,
            "segment_f32_max_err_vs_cpu_dbfs": seg_db,
            "segment_cpu_s": cpu_s, "segment_flops": seg_flops,
            "windows": windows, "track_flops": flops, "runs": runs,
            "bf16_snr_vs_f32_db": snr,
            "isolate_vocal": {**entry, "bf16_snr_vs_f32_db": entry_snr,
                              "f32_max_err_vs_separate_dbfs": entry_db,
                              "warmup_buckets": warmed,
                              "warmup_s": warm_s},
            "profile_bf16": {
                "wall_ms": wall, "device_ms": busy if rows else None,
                "device_idle_share": 1.0 - busy / wall if rows else None,
                "by_class": by_class,
                "top": [{"kernel": k[:90], "ms": ms, "calls": c}
                        for k, ms, c in rows[:12]]}}


def ht_engine(dev) -> dict:
    """(c) The engine: ``MasteringEngine(device=cuda)`` masters a 30 s
    stereo upload with ``apply_vocal_isolation`` under the bundled
    checkpoint, configured by the database row (source 3) of a temporary
    database: the engine's one cached graph is the default chain's at
    ``TARGET_LUFS`` (its whole key checked), and the response is within
    2.5 LSB and 0.01 LU of that graph run directly on
    ``separate_htdemucs``'s vocals of the decoded upload; then
    ``warmup_htdemucs((180,))`` warms one bucket.  (The engine's graph
    builds are held against independent ones in the engine phase.)"""
    tmp = tempfile.mkdtemp(prefix="amw_htdemucs_")
    saved = (runtime_settings.vocal_isolation_enabled, service_db.db_path())
    service_db.set_db_path(os.path.join(tmp, "htdemucs.sqlite3"))
    runtime_settings.vocal_isolation_enabled = True
    settings_store.set_setting("htdemucs_checkpoint", "bundled")
    eng = MasteringEngine(micro_batch=False, device=dev)
    try:
        with env_set(AMW_HTDEMUCS_CKPT=None, AMW_HTDEMUCS_DTYPE=None):
            x = make_track(SR, HT_ENGINE_S, seed=HT_SEED + 2)
            data = wav16(x)
            t0 = time.perf_counter()
            res = eng.master_v2_bytes(data, "t.wav", target_lufs=TARGET_LUFS,
                                      pro={"apply_vocal_isolation": True})
            wall = time.perf_counter() - t0
            split = eng.last_timings()
            audio = wav.read_wav(data)[0]
            voc = vocal.separate_htdemucs(audio, SR, device=dev)
            check(voc is not None, "engine: the network did not load")
            n = audio.shape[-1]
            spec = eng._spec_for(SR, n, 2)
            # the engine's own graph for the request (one build)
            (gkey, (params, fn, _, _)), = eng._cache.items()
            want = json.dumps({"cfg": None, "pro": {}, "style": "standard",
                               "t": round(TARGET_LUFS, 2)},
                              sort_keys=True, default=str)
            check(gkey == ("v2", spec, want), f"htdemucs engine: {gkey}")
            with torch.inference_mode():
                y = fn(torch.from_numpy(eng._pad(voc, spec.n)[None]).to(dev),
                       params, torch.tensor([n], dtype=torch.int32,
                                            device=dev))
                lsb = lsb_err(res["bytes"], y["out"][0, :, :n])
                d_lu = abs(res["after_lufs"] - float(y["after_lufs"][0]))
            check(lsb <= WAV16_LSB, f"htdemucs engine: {lsb} LSB from the "
                  "graph on the separated vocals")
            check(d_lu <= METER_LU, f"htdemucs engine: after_lufs {d_lu} LU")
            t0 = time.perf_counter()
            warmed = vocal.warmup_htdemucs((LONG[0],), device=dev)
            warm_s = time.perf_counter() - t0
            check(warmed == 1, f"htdemucs warmup: {warmed} buckets")
    finally:
        eng.close()
        settings_store.set_setting("htdemucs_checkpoint", None)
        runtime_settings.vocal_isolation_enabled = saved[0]
        service_db.set_db_path(saved[1])
        shutil.rmtree(tmp, ignore_errors=True)
    return {"track_s": HT_ENGINE_S, "bucket_n": spec.n, "wall_s": wall,
            "vocal_s": split.get("vocal"), "max_lsb": lsb,
            "after_lu_delta": d_lu, "warmup_buckets": warmed,
            "warmup_s": warm_s}


def phase_htdemucs(dev) -> None:
    """The neural vocal separator (``models/htdemucs.py`` through
    ``models/vocal.py``; cuDNN, cuBLAS and cuFFT, no hand kernel): (a) the
    bundled checkpoint, (b) the released shape with seeded weights, (c)
    through the engine.  Run with cuDNN's and cuBLAS's TF32 switches on (the
    smoke's kernel phases turned them off): the f32 forwards must turn TF32
    off themselves; the smoke's switches are put back after."""
    t_phase = time.perf_counter()
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        bundled = ht_bundled(dev)
        released = ht_released(dev)
        engine = ht_engine(dev)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
    emit({"phase": "htdemucs", "track_s": LONG[0], "bundled": bundled,
          "released": released, "engine": engine,
          "phase_s": time.perf_counter() - t_phase})


def device_rows(prof, reps: int) -> list:
    """(name, device ms per rep, calls per rep) of every device-side event
    of a torch.profiler run, costliest first."""
    rows = []
    for evt in prof.key_averages():
        # device-side events only (kernels, memcpy, memset): the CPU ops
        # that launched them carry the same time again
        if str(getattr(evt, "device_type", "")).split(".")[-1] != "CUDA":
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = evt.self_cuda_time_total
        rows.append((evt.key, dev_us / 1e3 / reps, evt.count / reps))
    rows.sort(key=lambda r: -r[1])
    return rows


def phase_profile(step, wall_ms: float, label: str, reps: int = 3):
    """Device time by CUDA kernel over ``reps`` steady-state batches
    (torch.profiler, CUPTI), and the device's idle share of the
    unprofiled wall time ``wall_ms`` per batch.  Returns the device ms
    per batch (None when the profiler saw no device event)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad(), PARITY.paused(), profile(
            activities=[ProfilerActivity.CPU,
                        ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
    rows = device_rows(prof, reps)
    busy = sum(r[1] for r in rows)
    emit({"phase": "profile", "run": label, "wall_ms_per_batch": wall_ms,
          "device_ms_per_batch": busy if rows else None,
          "device_idle_share": 1.0 - busy / wall_ms if rows else None,
          "device_events": len(rows),
          "top": [{"kernel": k[:90], "ms": ms, "calls": c}
                  for k, ms, c in rows[:15]]})
    return busy if rows else None


def phase_stages(dev, label: str, stages: dict, seed0: int,
                 device_ms: float | None, reps: int = 5) -> None:
    """Each of ``stages`` (name -> ``build(spec, device)``) alone on
    the run's 8 x 180 s input (``make_batch``, same seeds), under its valid
    lengths: CUDA-event median ms, and its share of the run's device time
    per batch."""
    xb, nv = make_batch(*LONG, BATCH, 2, seed0=seed0)
    spec = GraphSpec(sr=SR, n=xb.shape[-1], channels=2)
    x_d = torch.from_numpy(xb).to(dev)
    nv_d = torch.from_numpy(nv).to(dev)
    del xb
    out = {}
    for name, build in stages.items():
        params, fn = build(spec, dev)
        p_d = to_device(params, dev)
        with torch.no_grad(), validctx.valid_length(nv_d):
            ms = cuda_ms(lambda: fn(x_d, p_d), reps=reps, warmup=1)
        out[name] = {"ms": ms, "share_of_device": (
            ms / device_ms if device_ms else None)}
    emit({"phase": "stages", "run": label, "device_ms_per_batch": device_ms,
          "stages": out})


# ---- the serving engine (the port's request path) -------------------------

# The burst of the engine phase (the v2 runs as requests): 8 stereo 180 s
# requests with the pro set (two shorter, padded inside the 180 s bucket),
# one mono 180 s request at podcast, one 2 s clip at edm.
ENGINE_STEREO_S = (180.0,) * 6 + (170.0, 165.0)
ENGINE_RUNS = (("stereo", LONG[0], 2, "standard"),
               ("mono", LONG[0], 1, "podcast"),
               ("clip", SHORT_CLIP_S, 2, "edm"))
# the earlier phase whose graph (built by build_v2_job_graph, kept) each
# kind of request is checked against
ENGINE_GRAPHS = {"stereo": "v2_180s", "mono": "v2_mono_180s",
                 "clip": "v2_clip_2s"}
# the kind whose graph the engine builds itself (the others are handed the
# v2 runs' graphs), so that one engine build is held against an
# independent one
ENGINE_BUILDS = "clip"
ENGINE_SEED = 40
# The window of the checked bursts: ten uploads decoded at once on the
# host spread their submissions over more than the default 50 ms, which
# splits the 8-track batch (PERF.md §5).  The numbers of these bursts are
# the smoke's window, not the engine's; the third burst runs at the
# engine's default and reports the batches it formed and its own idle
# share.
ENGINE_WINDOW_S = 1.0
WAV16_LSB = 2.5  # the engine's dithered int16 against the graph, in LSB


class RecordingEngine(MasteringEngine):
    """The engine, recording each micro-batch's key and ``last_batch_info``
    (the batcher runs one batch at a time), and, while ``calls`` is a
    dict, each ``master_v2_bytes`` call in the thread that makes it: its
    upload, entry and exit times, ``last_timings()`` and its response
    bytes (keyed by ``id(upload)``; the service phase's job timelines)."""

    def __init__(self, *args, **kwargs):
        self.batches = []
        self.calls = None
        super().__init__(*args, **kwargs)

    def _run_v2_batch(self, bkey, xb, nvb):
        items = super()._run_v2_batch(bkey, xb, nvb)
        self.batches.append((bkey, dict(self.last_batch_info)))
        return items

    def master_v2_bytes(self, data, *args, **kwargs):
        if self.calls is None:
            return super().master_v2_bytes(data, *args, **kwargs)
        rec = {"data": data, "enter": time.perf_counter()}
        self.calls[id(data)] = rec
        res = super().master_v2_bytes(data, *args, **kwargs)
        rec.update(exit=time.perf_counter(), split=self.last_timings(),
                   out=res["bytes"])
        return res


def wav16(x: np.ndarray) -> bytes:
    return wav.write_wav_int16(np.round(x * 32767).astype(np.int16), SR)


def decode_int16(blob: bytes, sr: int = SR) -> np.ndarray:
    """A 16-bit PCM WAV's samples as int16 [C, N] (header checked; chunks
    after the data, the service's branding, left out)."""
    tag, channels, rate, _, _, bits = struct.unpack_from("<HHIIHH", blob, 20)
    size = struct.unpack_from("<I", blob, 40)[0]
    check(blob[:4] == b"RIFF" and blob[36:40] == b"data" and tag == 1
          and bits == 16 and rate == sr and 44 + size <= len(blob),
          "engine: response is not int16 WAV")
    return np.frombuffer(blob, "<i2", count=size // 2,
                         offset=44).reshape(-1, channels).T


def engine_requests() -> list:
    """The burst's requests: label, upload bytes, length, channels, style,
    and the ``master_v2_bytes`` keywords."""
    runs = [("stereo", d, 2, "standard") for d in ENGINE_STEREO_S] + [
        ENGINE_RUNS[1], ENGINE_RUNS[2]]
    reqs = []
    for i, (kind, dur, channels, style) in enumerate(runs):
        x = make_track(SR, dur, seed=ENGINE_SEED + i)[:channels]
        reqs.append({"label": f"{kind}_{dur:g}s_{i}", "kind": kind,
                     "data": wav16(x), "n": x.shape[-1],
                     "channels": channels, "style": style,
                     "kw": {"target_lufs": STYLE_CONFIGS[style]["lufs"],
                            "style": style, "pro": dict(V2_PRO)}})
    return reqs


def run_burst(eng, reqs) -> tuple[list, float]:
    """Every request in its own thread, released together: per request
    (response, wall from submit to bytes, the engine's split); the
    burst's wall.  Raises the first request's error."""
    barrier = threading.Barrier(len(reqs) + 1)
    out = [None] * len(reqs)
    errors = []

    def work(i):
        barrier.wait()
        t0 = time.perf_counter()
        try:
            res = eng.master_v2_bytes(reqs[i]["data"], "t.wav",
                                      **reqs[i]["kw"])
            out[i] = (res, time.perf_counter() - t0, eng.last_timings())
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=work, args=(i,))
               for i in range(len(reqs))]
    for th in threads:
        th.start()
    barrier.wait()
    t0 = time.perf_counter()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    check(not any(th.is_alive() for th in threads), "engine: burst hung")
    if errors:
        raise errors[0]
    return out, wall


def request_key(style: str) -> str:
    """The graph key ``master_v2_bytes`` makes for a burst request."""
    return json.dumps({"cfg": None, "pro": dict(V2_PRO), "style": style,
                       "t": round(float(STYLE_CONFIGS[style]["lufs"]), 2)},
                      sort_keys=True, default=str)


def lsb_err(blob: bytes, y: torch.Tensor, sr: int = SR) -> float:
    """Max |response - y quantized without dither| in LSB."""
    q = decode_int16(blob, sr).astype(np.int32)
    with torch.inference_mode():
        ref = dither.quantize16(y, torch.zeros_like(y)).cpu().numpy()
    check(q.shape == ref.shape, f"engine: shape {q.shape} vs {ref.shape}")
    return float(np.max(np.abs(q - ref)))


def check_against_graph(eng, reqs, out, dev, graphs) -> dict:
    """Each response within ``WAV16_LSB`` of its track through the graph
    that ``build_v2_job_graph`` built for its run (``graphs``, kept by
    :func:`phase_v2`; for ``ENGINE_BUILDS`` not the graph the engine
    built and serves from its cache), called directly on the
    bucket-padded decoded upload (the same batch for the stereo requests);
    its ``after_lufs`` within ``METER_LU`` of the graph's.  Returns the
    largest deltas by kind."""
    worst = {}
    for kind, label in ENGINE_GRAPHS.items():
        idx = [i for i, r in enumerate(reqs) if r["kind"] == kind]
        r0 = reqs[idx[0]]
        spec, params, fn, _ = graphs[label]
        espec = eng._spec_for(SR, r0["n"], r0["channels"])
        check(espec == spec, f"engine {kind}: bucket {espec} is not the "
              f"{label} graph's {spec}")
        xb = np.stack([eng._pad(wav.read_wav(reqs[i]["data"])[0], spec.n)
                       for i in idx])
        nv = np.asarray([reqs[i]["n"] for i in idx], np.int32)
        with torch.inference_mode():
            res = fn(torch.from_numpy(xb).to(dev), params,
                     torch.from_numpy(nv).to(dev))
            errs, dlu = [], []
            for j, i in enumerate(idx):
                resp = out[i][0]
                errs.append(lsb_err(resp["bytes"],
                                    res["out"][j, :, :reqs[i]["n"]]))
                dlu.append(abs(resp["after_lufs"]
                               - float(res["after_lufs"][j])))
        check(max(errs) <= WAV16_LSB, f"engine {kind}: {errs} LSB from "
              "the graph")
        check(max(dlu) <= METER_LU, f"engine {kind}: after_lufs {dlu} LU "
              "from the graph")
        worst[kind] = {"max_lsb": max(errs), "max_after_lu": max(dlu)}
        del res
    return worst


def burst_summary(reqs, out, wall: float) -> dict:
    audio_s = sum(r["n"] / SR for r in reqs)
    return {"wall_s": wall, "audio_s": audio_s,
            "realtime_factor": audio_s / wall,
            "requests": [{"label": r["label"], "wall_s": o[1], "split": o[2]}
                         for r, o in zip(reqs, out)]}


def profiled_burst(eng, reqs) -> tuple[list, float, dict]:
    """:func:`run_burst` under torch.profiler: its responses, wall, and
    the device's busy time and idle share over that wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out, wall = run_burst(eng, reqs)
        torch.cuda.synchronize()
    rows = device_rows(prof, 1)
    check(rows, "engine: the profiler saw no device event")
    busy = sum(ms for _, ms, _ in rows)
    return out, wall, {"wall_s": wall, "device_busy_ms": busy,
                       "device_idle_share": 1.0 - busy / (wall * 1e3),
                       "top": [{"kernel": k[:90], "ms": ms, "calls": c}
                               for k, ms, c in rows[:10]]}


def phase_engine(dev, eng, graphs: dict) -> dict:
    """The serving engine (``runtime/engine.MasteringEngine``) on the card.
    Warmup (the default graph cached and run once through the batcher
    path), one request of each kind (the stereo and mono graphs the ones
    the v2 runs built, ``graphs``, handed to the engine's cache; the
    clip's, ``ENGINE_BUILDS``, built by the engine), then the
    burst three times: burst 1 checked (launches, one batch of 8 for the
    stereo key, every response against the graphs the v2 runs built,
    ``graphs``), burst 2 under torch.profiler (device busy and idle share;
    memory equal to burst 1's), burst 3 at the default 50 ms window, under
    torch.profiler (the batches it formed, its idle share).  Then the
    other entry points once each against the op on the card: stage ticks
    without the batcher, ``master_v1_bytes``, ``reference_match_bytes``,
    ``upscale_bytes`` (44.1 -> 48 kHz), ``isolate_vocal_bytes``.  ``eng``:
    a new :class:`RecordingEngine`, left open and warm for the service
    phase."""
    t_phase = time.perf_counter()
    reqs = engine_requests()
    check(eng.device == dev and eng._batcher is not None
          and eng._batcher.window == 0.05, "engine: not the default")
    t0 = time.perf_counter()
    eng.warmup((LONG[0],))
    warmup_s = time.perf_counter() - t0
    default_key = json.dumps(
        {"cfg": None, "pro": {}, "style": "standard",
         "t": round(TARGET_LUFS, 2)}, sort_keys=True, default=str)
    spec = GraphSpec(sr=SR, n=int(SR * LONG[0]), channels=2,
                     exact=eng.exact)
    check(list(eng._cache) == [("v2", spec, default_key)],
          f"engine: warmup cached {list(eng._cache)}")
    check(len(eng.batches) == 1 and eng.batches[0][1]["batch"] == 1,
          f"engine: warmup did not run its graph: {eng.batches}")

    # the request kinds' graphs are the ones the v2 runs built (one build
    # each, shared): handed to the engine under its own keys, but for one
    # kind's, which the engine builds
    for kind, label in ENGINE_GRAPHS.items():
        if kind == ENGINE_BUILDS:
            continue
        spec_k, params, fn, names = graphs[label]
        style = next(s_ for k, _, _, s_ in ENGINE_RUNS if k == kind)
        eng._cache[("v2", spec_k, request_key(style))] = (params, fn, names,
                                                         None)
    first = {}
    for kind, dur, channels, style in ENGINE_RUNS:
        r = next(q for q in reqs if q["kind"] == kind)
        t0 = time.perf_counter()
        eng.master_v2_bytes(r["data"], "t.wav", **r["kw"])
        first[kind] = {"first_request_s": time.perf_counter() - t0,
                       "split": eng.last_timings()}
    spec_b, _, fn_b, _ = graphs[ENGINE_GRAPHS[ENGINE_BUILDS]]
    style_b = next(s_ for k, _, _, s_ in ENGINE_RUNS if k == ENGINE_BUILDS)
    built = eng._cache.get(("v2", spec_b, request_key(style_b)))
    check(built is not None and built[1] is not fn_b,
          f"engine: the {ENGINE_BUILDS} graph was not the engine's build")

    eng._batcher.window = ENGINE_WINDOW_S
    expect = {name: 0 for name in COUNTERS}
    for kind, dur, channels, style in ENGINE_RUNS:
        rows = (BATCH if kind == "stereo" else 1) * channels
        for k, v in job_expected(int(SR * dur), rows, style).items():
            expect[k] += v
    eng.batches.clear()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    out1, wall1 = run_burst(eng, reqs)
    launches = read_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    mem1 = torch.cuda.memory_allocated()
    check(launches == expect, f"engine: launches {launches}, expected "
          f"{expect}")
    sizes = {}
    for (_, spec, _), info in eng.batches:
        sizes.setdefault((spec.n, spec.channels), []).append(
            info["batch"])
    check(sizes == {(int(SR * LONG[0]), 2): [BATCH],
                    (int(SR * LONG[0]), 1): [1],
                    (int(SR * SHORT_CLIP_S), 2): [1]},
          f"engine: batches by key {sizes}")
    for r, o in zip(reqs, out1):
        q = decode_int16(o[0]["bytes"])
        check(q.shape == (r["channels"], r["n"]),
              f"engine: {r['label']} came back {q.shape}")
    graph_deltas = check_against_graph(eng, reqs, out1, dev, graphs)

    out2, wall2, prof2 = profiled_burst(eng, reqs)
    mem2 = torch.cuda.memory_allocated()
    check(mem2 == mem1, f"engine: memory {mem2} after the second "
          f"burst, {mem1} after the first")

    eng._batcher.window = 0.05
    eng.batches.clear()
    out3, wall3, prof3 = profiled_burst(eng, reqs)
    default_sizes = [info["batch"] for (_, spec, _), info in eng.batches
                     if (spec.n, spec.channels)
                     == (int(SR * LONG[0]), 2)]
    check(sum(default_sizes) == BATCH, f"engine: {default_sizes}")
    mem3 = torch.cuda.memory_allocated()
    emit({"phase": "engine", "run": "burst",
          "requests": len(reqs), "window_s": ENGINE_WINDOW_S,
          "warmup_s": warmup_s, "first_request": first,
          "launches": launches, "expected_launches": expect,
          "batches_by_key": {f"{n}x{c}": b for (n, c), b in
                             sizes.items()},
          "against_graph": graph_deltas, "peak_device_gb": peak_gb,
          "memory_allocated": [mem1, mem2, mem3],
          "burst1": burst_summary(reqs, out1, wall1),
          "burst2_profiled": {
              **prof2, "device_idle_share_vs_burst1": 1.0 - prof2[
                  "device_busy_ms"] / (wall1 * 1e3)},
          "burst3_default_window": {
              "window_s": 0.05, "stereo_batches": default_sizes,
              **burst_summary(reqs, out3, wall3),
              "profiled": {k: v for k, v in prof3.items()
                           if k != "wall_s"}}})
    del out1, out2, out3
    tools = engine_tools(dev, eng, reqs, graphs)
    emit({"phase": "engine", "run": "entry_points", **tools,
          "phase_s": time.perf_counter() - t_phase})
    return launches


def engine_tools(dev, eng, reqs, graphs) -> dict:
    """The other entry points, one request each, against the op on the
    card."""
    out = {}
    r = next(q for q in reqs
             if q["kind"] == "stereo" and q["n"] == int(SR * LONG[0]))
    x, _ = wav.read_wav(r["data"])

    # stage ticks: no batcher; each tick after its stage's event completed
    marks, late = {}, []
    stage_done, emit_tick = progress.stage_done, progress.emit_stage_tick

    def recorded_stage_done(tok, idx, device):
        # recorded just before the stage's own event, at the same point of
        # the stream: it has completed once that one has
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(device))
        marks[(int(tok), int(idx))] = ev
        stage_done(tok, idx, device)

    def checked_tick(tok, idx):
        ev = marks.get((int(tok), int(idx)))
        if ev is None or not ev.query():
            late.append(int(idx))
        emit_tick(tok, idx)

    events = []
    peng = MasteringEngine(micro_batch=False)
    # handed the burst's stereo graph: an engine graph ticks when a job
    # gives it a token, so one graph a key serves both engines
    spec, params, fn, _ = graphs[ENGINE_GRAPHS["stereo"]]
    gkey = ("v2", spec, request_key(r["style"]))
    check(gkey in eng._cache, f"engine: no cached graph {gkey}")
    peng._cache[gkey] = eng._cache[gkey]
    progress.stage_done, progress.emit_stage_tick = (recorded_stage_done,
                                                     checked_tick)
    try:
        t0 = time.perf_counter()
        res = peng.master_v2_bytes(r["data"], "t.wav", **r["kw"],
                                   progress=lambda p, m: events.append(
                                       (p, m)))
        wall = time.perf_counter() - t0
    finally:
        progress.stage_done, progress.emit_stage_tick = stage_done, emit_tick
    labels = [m for _, m in events if m.startswith("Mastering: ")]
    pcts = [p for p, _ in events]
    check(len(set(labels)) >= 8 and pcts == sorted(pcts) and not late
          and len(marks) == len(labels),
          f"engine progress: {len(set(labels))} labels, late {late}, "
          f"{len(marks)} events, monotonic {pcts == sorted(pcts)}")
    check(list(peng._cache) == [gkey], "engine progress: built "
          f"{[k for k in peng._cache if k != gkey]}")
    with torch.inference_mode():
        ref = fn(torch.from_numpy(x[None]).to(dev), params,
                 torch.tensor([r["n"]], dtype=torch.int32, device=dev))
        err = lsb_err(res["bytes"], ref["out"][0])
        dlu = abs(res["after_lufs"] - float(ref["after_lufs"][0]))
    del ref, params, fn
    peng.close()
    del peng
    check(err <= WAV16_LSB and dlu <= METER_LU,
          f"engine progress: {err} LSB, {dlu} LU from the graph")
    out["progress"] = {"labels": len(set(labels)), "ticks": len(labels),
                       "late_ticks": late, "wall_s": wall, "max_lsb": err,
                       "after_lu": dlu}

    # master_v1_bytes on the same upload
    t0 = time.perf_counter()
    res = eng.master_v1_bytes(r["data"], "t.wav", target_lufs=TARGET_LUFS)
    wall = time.perf_counter() - t0
    (params, fn, _), = [v for k, v in eng._cache.items() if k[0] == "v1"]
    with torch.inference_mode():
        ref = fn(torch.from_numpy(x[None]).to(dev), params,
                 torch.tensor([r["n"]], dtype=torch.int32, device=dev))
        err = lsb_err(res["bytes"], ref["out"][0])
        dlu = abs(res["after_lufs"] - float(ref["after_lufs"][0]))
    del ref
    check(err <= WAV16_LSB and dlu <= METER_LU,
          f"engine v1: {err} LSB, {dlu} LU from the graph")
    out["v1"] = {"wall_s": wall, "max_lsb": err, "after_lu": dlu}

    # reference_match_bytes against another 180 s track
    ref_data = wav16(make_track(SR, LONG[0], seed=REFERENCE_SEED))
    t0 = time.perf_counter()
    res = eng.reference_match_bytes(r["data"], "s.wav", ref_data, "r.wav")
    wall = time.perf_counter() - t0
    with torch.inference_mode():
        env = spectral_envelope(torch.from_numpy(
            wav.read_wav(ref_data)[0]).to(dev))
    spec = GraphSpec(sr=SR, n=r["n"], channels=2)
    p_rm, f_rm = build_reference_match(spec, env, strength=0.8, device=dev)
    with torch.inference_mode():
        nv = torch.tensor([r["n"]], dtype=torch.int32, device=dev)
        with validctx.valid_length(nv):
            y = validctx.mask_tail(f_rm(torch.from_numpy(x[None]).to(dev),
                                        to_device(p_rm, dev)))
        err = lsb_err(res["bytes"], y[0])
    del y
    check(err <= WAV16_LSB, f"engine reference match: {err} LSB")
    out["reference_match"] = {"wall_s": wall, "max_lsb": err}

    # upscale_bytes, 44.1 -> 48 kHz
    t0 = time.perf_counter()
    res = eng.upscale_bytes(r["data"], "t.wav", target_sr=EXPORT_SR)
    wall = time.perf_counter() - t0
    n_out = int(round(r["n"] * EXPORT_SR / SR))
    check(res["sr"] == EXPORT_SR, f"engine upscale: sr {res['sr']}")
    with torch.inference_mode():
        y = fdfilter.resample_fft(torch.from_numpy(x).to(dev), n_out)
    err = lsb_err(res["bytes"], y, EXPORT_SR)
    del y
    check(err <= WAV16_LSB, f"engine upscale: {err} LSB")
    out["upscale"] = {"wall_s": wall, "n_out": n_out, "max_lsb": err}

    # isolate_vocal_bytes (float32 WAV)
    t0 = time.perf_counter()
    blob = isolate_vocal_bytes(r["data"], "t.wav")
    wall = time.perf_counter() - t0
    v, _ = wav.read_wav(blob)
    want = isolate_vocal(x, SR, device=dev)
    err = float(np.max(np.abs(v - want)))
    err_db = 20 * np.log10(max(err, 1e-30))
    check(v.shape == want.shape and err_db <= PARITY_DBFS,
          f"engine vocal bytes: {v.shape} {err_db} dBFS")
    out["isolate_vocal"] = {"wall_s": wall, "max_err_dbfs": err_db}
    return out


# ---- the HTTP service (the port's mastering API on the engine) -------------

# The 10-request burst again at this many normal-job semaphore slots (the
# default is 1: jobs.select_semaphore runs anonymous jobs one at a time)
SERVICE_WIDE_SLOTS = 8
SERVICE_POLL_S = 0.05  # the client's status poll
# the pro set as the service's form fields
V2_PRO_FIELDS = {k: ("true" if v is True else str(v)) for k, v in
                 V2_PRO.items()}


@contextlib.contextmanager
def served(app):
    """``app`` served on 127.0.0.1 (an ephemeral port) by ``web.AppRunner``
    and ``web.TCPSite`` on an event loop of its own thread; yields the base
    URL and stops the loop, the runner and the thread on exit."""
    loop = asyncio.new_event_loop()
    runner = web.AppRunner(app)
    ready = threading.Event()
    box = {}

    def serve():
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(runner.setup())
            site = web.TCPSite(runner, "127.0.0.1", 0)
            loop.run_until_complete(site.start())
            box["url"] = "http://127.0.0.1:%d" % runner.addresses[0][1]
        except BaseException as e:  # noqa: BLE001 — re-raised below
            box["error"] = e
        ready.set()
        if "url" in box:
            loop.run_forever()
        loop.run_until_complete(runner.cleanup())
        loop.close()

    th = threading.Thread(target=serve, name="service", daemon=True)
    th.start()
    ready.wait(120)
    if "error" in box:
        th.join(60)
        raise box["error"]
    check("url" in box, "service: the server did not start")
    try:
        yield box["url"]
    finally:
        loop.call_soon_threadsafe(loop.stop)
        th.join(120)
        check(not th.is_alive(), "service: the server did not stop")


def form(fields: dict) -> aiohttp.FormData:
    """A multipart form: an upload is (name, bytes), a list of them sends
    each under the field's name."""
    f = aiohttp.FormData()
    for k, v in fields.items():
        for item in (v if isinstance(v, list) else [v]):
            if isinstance(item, tuple):
                f.add_field(k, item[1], filename=item[0],
                            content_type="audio/wav")
            else:
                f.add_field(k, str(item))
    return f


async def http_json(session, method: str, url: str, **kw):
    async with session.request(method, url, **kw) as r:
        body = await r.read()
        check(r.status == 200, f"service: {method} {url} answered "
              f"{r.status}: {body[:300]!r}")
        return json.loads(body)


async def http_bytes(session, url: str, **kw) -> tuple[bytes, float]:
    """A response's body (a POST where ``data`` is given) and its wall."""
    t0 = time.perf_counter()
    method = "POST" if "data" in kw else "GET"
    async with session.request(method, url, **kw) as r:
        body = await r.read()
        check(r.status == 200, f"service: {url} answered {r.status}: "
              f"{body[:300]!r}")
    return body, time.perf_counter() - t0


async def follow_sse(session, url: str) -> list:
    """The events of a job's progress stream, to its end."""
    events = []
    async with session.get(url) as r:
        check(r.status == 200 and r.headers["Content-Type"]
              == "text/event-stream", f"service: SSE answered {r.status}")
        async for line in r.content:
            line = line.decode().strip()
            if line.startswith("data: "):
                events.append(json.loads(line[6:]))
                if events[-1]["status"] in ("done", "error"):
                    break
    return events


async def wait_done(session, base: str, job_id: str) -> dict:
    while True:
        st = await http_json(session, "GET",
                             f"{base}/api/master/status/{job_id}")
        if st["status"] in ("done", "error"):
            check(st["status"] == "done", f"service: job {job_id} {st}")
            return st
        await asyncio.sleep(SERVICE_POLL_S)


def job_uploads(job_ids) -> dict:
    """id() of each job's upload in the job store (the key of the engine's
    record of its call), read while the jobs are held there."""
    return {jid: id(service_jobs.get_job(jid)["original_bytes"])
            for jid in job_ids}


def timed_branding(eng):
    """``embed_branding`` timing each call into the engine's record of the
    call whose response it brands."""
    def brand(data, fmt):
        t0 = time.perf_counter()
        out = embed_branding(data, fmt)
        dt = time.perf_counter() - t0
        for rec in (eng.calls or {}).values():
            if rec.get("out") is data:
                rec["branding_s"] = dt
                del rec["out"]
        return out
    return brand


def job_timeline(rec: dict, posted: float, download_s: float) -> dict:
    """A job's split: the wait from its upload's answer to the engine's
    start (the semaphore; the thread hand-off in it), the engine's call and
    its split, branding, the result's download."""
    return {"semaphore_wait_s": rec["enter"] - posted,
            "engine_s": rec["exit"] - rec["enter"],
            "engine_split": rec["split"],
            "branding_s": rec.get("branding_s"),
            "download_s": download_s}


def batches_summary(eng) -> dict:
    out = {}
    for (_, spec, key), info in eng.batches:
        style = json.loads(key)["style"]
        out.setdefault(f"{spec.n}x{spec.channels}:{style}", []).append(
            info["batch"])
    return out


def batches_expected(eng) -> dict:
    """Each kernel's launches for the micro-batches the engine ran (the
    compiled width, a power of two, times the channels are the rows)."""
    expect = {name: 0 for name in COUNTERS}
    for (_, spec, key), info in eng.batches:
        cfg = json.loads(key)
        for k, v in job_expected(spec.n, info["batch_compiled"]
                                 * spec.channels, cfg["style"],
                                 pro=cfg["pro"]).items():
            expect[k] += v
    return expect


async def service_batch(session, base, eng, uploads) -> dict:
    """``POST /api/v2/batch`` with the stereo uploads at the defaults:
    one job followed on its SSE stream, the others polled, every result
    fetched."""
    eng.calls, eng.batches[:] = {}, []
    reset_counts()
    t0 = time.perf_counter()
    resp = await http_json(session, "POST", f"{base}/api/v2/batch", data=form(
        {"files": [(f"t{i}.wav", d) for i, d in enumerate(uploads)]}))
    posted = time.perf_counter()
    ids = resp["job_ids"]
    check(len(ids) == len(uploads), f"service batch: {resp}")
    keys = job_uploads(ids)
    events, *status = await asyncio.gather(
        follow_sse(session, f"{base}/api/master/progress/{ids[0]}"),
        *[wait_done(session, base, jid) for jid in ids[1:]])
    check(events[-1]["status"] == "done", f"service SSE: {events[-1]}")
    pct = [e["progress"] for e in events]
    check(pct == sorted(pct) and pct[-1] == 100, f"service SSE: {pct}")
    status = [events[-1]] + status
    blobs, timelines = [], []
    for jid in ids:
        blob, dl = await http_bytes(session,
                                    f"{base}/api/master/result/{jid}")
        blobs.append(blob)
        timelines.append(job_timeline(eng.calls[keys[jid]], posted, dl))
    wall = time.perf_counter() - t0
    launches = read_counts()
    eng.calls = None
    return {"ids": ids, "status": status, "blobs": blobs, "wall": wall,
            "post_s": posted - t0, "sse_events": len(events),
            "timelines": timelines, "launches": launches,
            "batches": batches_summary(eng)}


async def service_burst(session, base, eng, reqs) -> dict:
    """The engine burst's requests as concurrent ``POST /api/v2/master``
    calls with the pro set as form fields, each job polled and its result
    fetched, under torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    eng.calls, eng.batches[:] = {}, []
    reset_counts()

    async def one(r):
        fields = {"file": ("t.wav", r["data"]), "style": r["style"],
                  "target_lufs": r["kw"]["target_lufs"], **V2_PRO_FIELDS}
        t0 = time.perf_counter()
        resp = await http_json(session, "POST", f"{base}/api/v2/master",
                               data=form(fields))
        posted = time.perf_counter()
        key = job_uploads([resp["job_id"]])[resp["job_id"]]
        st = await wait_done(session, base, resp["job_id"])
        blob, dl = await http_bytes(
            session, f"{base}/api/master/result/{resp['job_id']}")
        return {"upload_parse_s": posted - t0, "posted": posted,
                "key": key, "status": st, "blob": blob, "download_s": dl}

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = await asyncio.gather(*[one(r) for r in reqs])
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
    launches = read_counts()
    expect = batches_expected(eng)
    check(launches == expect, f"service burst: launches {launches}, "
          f"expected {expect} for the batches {eng.batches}")
    rows = device_rows(prof, 1)
    check(rows, "service burst: the profiler saw no device event")
    busy = sum(ms for _, ms, _ in rows)
    for r, o in zip(reqs, out):
        q = decode_int16(o["blob"])
        check(q.shape == (r["channels"], r["n"]),
              f"service burst: {r['label']} came back {q.shape}")
    audio_s = sum(r["n"] / SR for r in reqs)
    jobs_out = [{"label": r["label"], "upload_parse_s": o["upload_parse_s"],
                 **job_timeline(eng.calls[o["key"]], o["posted"],
                                o["download_s"])}
                for r, o in zip(reqs, out) if r["kind"] == "stereo"]
    eng.calls = None
    return {"wall_s": wall, "audio_s": audio_s,
            "realtime_factor": audio_s / wall, "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / (wall * 1e3),
            "batches": batches_summary(eng), "launches": launches,
            "stereo_jobs": jobs_out}


async def service_tools(session, base, dev, eng, x, data) -> dict:
    """The other routes once each on a 180 s stereo upload, against the
    call they make, on the card."""
    out = {}

    async def post(route, fields):
        t0 = time.perf_counter()
        body = await http_json(session, "POST", f"{base}{route}",
                               data=form(fields))
        return body, time.perf_counter() - t0

    got, wall = await post("/api/v2/analyze", {"file": ("t.wav", data),
                                               "extended": "true"})
    want = json.loads(json.dumps(analyze(x, SR, True, device=dev)))
    same_dict(got, want, "service analyze")
    out["analyze_s"] = wall
    got, wall = await post("/api/tools/lufs-analyze",
                           {"file": ("t.wav", data)})
    same_dict(got, json.loads(json.dumps(lufs_analyze_tool(
        x, SR, "wav", device=dev))), "service lufs tool")
    out["lufs_analyze_s"] = wall

    ref = wav16(make_track(SR, LONG[0], seed=REFERENCE_SEED))
    blob, wall = await http_bytes(
        session, f"{base}/api/v2/reference-match",
        data=form({"file": ("s.wav", data), "reference": ("r.wav", ref)}))
    want = eng.reference_match_bytes(data, "s.wav", ref, "r.wav")["bytes"]
    err = float(np.max(np.abs(decode_int16(blob).astype(np.int32)
                              - decode_int16(want))))
    check(err <= WAV16_LSB, f"service reference match: {err} LSB")
    out["reference_match"] = {"wall_s": wall, "max_lsb": err}

    blob, wall = await http_bytes(
        session, f"{base}/api/v2/upscale",
        data=form({"file": ("t.wav", data), "target_sr": EXPORT_SR}))
    want = eng.upscale_bytes(data, "t.wav", target_sr=EXPORT_SR)["bytes"]
    q = decode_int16(blob, EXPORT_SR).astype(np.int32)
    err = float(np.max(np.abs(q - decode_int16(want, EXPORT_SR))))
    check(q.shape == (2, int(round(x.shape[-1] * EXPORT_SR / SR)))
          and err <= WAV16_LSB, f"service upscale: {q.shape}, {err} LSB")
    out["upscale"] = {"wall_s": wall, "max_lsb": err}

    settings_store.set_setting("vocal_isolation_enabled", "true")
    try:
        blob, wall = await http_bytes(session, f"{base}/api/v2/isolate-vocal",
                                      data=form({"file": ("t.wav", data)}))
    finally:
        settings_store.set_setting("vocal_isolation_enabled", None)
    v, _ = wav.read_wav(blob)
    want, _ = wav.read_wav(isolate_vocal_bytes(data, "t.wav", device=dev))
    err_db = 20 * np.log10(max(float(np.max(np.abs(v - want))), 1e-30))
    check(v.shape == want.shape and err_db <= PARITY_DBFS,
          f"service vocal: {v.shape}, {err_db} dBFS")
    out["isolate_vocal"] = {"wall_s": wall, "max_err_dbfs": err_db}

    t0 = time.perf_counter()
    resp, _ = await post("/api/v2/master/auto", {"file": ("t.wav", data)})
    rec = ai.recommend_preset(analyze(x, SR, True, device=dev))
    check(resp["style"] == rec["style"] and resp["target_lufs"]
          == max(-24.0, min(-6.0, float(rec["target_lufs"]))),
          f"service auto: {resp} against {rec}")
    await wait_done(session, base, resp["job_id"])
    blob, _ = await http_bytes(session,
                               f"{base}/api/master/result/{resp['job_id']}")
    check(decode_int16(blob).shape == x.shape, "service auto: result shape")
    out["master_auto"] = {"wall_s": time.perf_counter() - t0,
                          "style": resp["style"],
                          "target_lufs": resp["target_lufs"]}
    return out


async def service_requests(base: str, dev, eng, analyze_launches) -> dict:
    reqs = engine_requests()
    stereo = [r for r in reqs if r["kind"] == "stereo"]
    timeout = aiohttp.ClientTimeout(total=900)
    async with aiohttp.ClientSession(timeout=timeout) as session:
        health = await http_json(session, "GET", f"{base}/api/health")
        version = await http_json(session, "GET", f"{base}/api/version")
        metrics = await http_json(session, "GET", f"{base}/api/metrics")
        check(health["status"] == "ok" and health["db"] == "ok"
              and version["engine"] == "amw_tpu_torch"
              and metrics["mesh_devices"] == 1,
              f"service: {health} {version} {metrics}")

        # 1. the batch route at the defaults: the default graph, 8 jobs in
        # turn under the default semaphore
        batch = await service_batch(session, base, eng,
                                    [r["data"] for r in stereo])
        one = {name: 0 for name in COUNTERS}
        for k, v in job_expected(int(SR * LONG[0]), 2, "standard",
                                 pro={}).items():
            one[k] = v * len(stereo)
        check(batch["launches"] == one, f"service batch: launches "
              f"{batch['launches']}, expected {one}")
        check(all(b == 1 for bs in batch["batches"].values() for b in bs),
              f"service batch: batches {batch['batches']}")
        direct, _ = run_burst(eng, [{"data": r["data"], "kw": {
            "target_lufs": TARGET_LUFS}} for r in stereo])
        worst_lsb = worst_lu = 0.0
        for r, blob, st, d in zip(stereo, batch["blobs"], batch["status"],
                                  direct):
            want = embed_branding(d[0]["bytes"], "wav")
            q = decode_int16(blob)
            check(q.shape == (2, r["n"]) and len(blob) == len(want)
                  and blob[:44] == want[:44]
                  and blob[44 + q.size * 2:] == want[44 + q.size * 2:],
                  f"service batch: {r['label']} header, length or branding")
            worst_lsb = max(worst_lsb, float(np.max(np.abs(
                q.astype(np.int32) - decode_int16(want)))))
            worst_lu = max(worst_lu, abs(st["after_lufs"]
                                         - d[0]["after_lufs"]))
        check(worst_lsb <= WAV16_LSB and worst_lu <= METER_LU,
              f"service batch: {worst_lsb} LSB, {worst_lu} LU from "
              "master_v2_bytes")
        audio_s = sum(r["n"] / SR for r in stereo)
        batch_line = {
            "jobs": len(stereo), "wall_s": batch["wall"],
            "post_s": batch["post_s"], "audio_s": audio_s,
            "realtime_factor": audio_s / batch["wall"],
            "batches": batch["batches"], "launches": batch["launches"],
            "sse_events": batch["sse_events"], "max_lsb": worst_lsb,
            "max_after_lu": worst_lu, "jobs_split": batch["timelines"]}
        del batch, direct

        # 2. the engine burst's requests, at the default semaphore and at
        # SERVICE_WIDE_SLOTS (the semaphores are cached per loop: cleared)
        bursts = {}
        for slots in (runtime_settings.semaphore_normal, SERVICE_WIDE_SLOTS):
            default = runtime_settings.semaphore_normal
            runtime_settings.semaphore_normal = slots
            service_jobs._sems.clear()
            try:
                bursts[f"semaphore_{slots}"] = await service_burst(
                    session, base, eng, reqs)
            finally:
                runtime_settings.semaphore_normal = default
                service_jobs._sems.clear()

        # 3. the other routes once each
        x, _ = wav.read_wav(stereo[0]["data"])
        tools = await service_tools(session, base, dev, eng, x,
                                    stereo[0]["data"])

        # 4. the accounts, the AI routes and the user bot on one upload,
        # then the admin's view of the phase's jobs
        hdr, user = await service_user_master(session, base, eng, stereo[0])
        emit({"phase": "service", **user})
        line = await service_ai(session, base, dev, hdr, stereo[0],
                                analyze_launches)
        emit({"phase": "service", **line})
        line = await service_bot(eng, stereo[0])
        emit({"phase": "service", **line})
        jobs_posted = len(stereo) + 2 * len(reqs) + 2  # + auto, + the user's
        line = await service_admin(session, base, jobs_posted)
        emit({"phase": "service", **line})
    return {"batch": batch_line, "bursts": bursts, "tools": tools}


# the accounts of the service phase: the initial admin (its environment)
# and a user who registers
SERVICE_ADMIN = ("admin@example.com", "smoke-admin-pw")
SERVICE_USER = ("user@example.com", "smoke-user-pw")
BOT_PRESET = "spotify"


class FakeTelegram:
    """The user bot's Telegram transport, faked: serves the upload,
    records the messages and documents the bot sends."""

    def __init__(self, upload: bytes):
        self.upload, self.sent, self.docs = upload, [], []

    def api(self, method, payload):
        self.sent.append((method, payload))
        return {"ok": True, "result": {}}

    def download(self, file_id):
        return self.upload

    def send_document(self, chat_id, filename, blob, caption=""):
        self.docs.append((chat_id, filename, blob, caption))


def same_master(label: str, blob: bytes, want: bytes, after: float,
                want_after: float, n: int) -> tuple[float, float]:
    """A mastered 16-bit WAV against the engine's direct answer: the same
    shape, within ``WAV16_LSB`` (the TPDF draws differ), the loudness
    within ``METER_LU``.  Returns (max LSB, loudness delta)."""
    q = decode_int16(blob)
    check(q.shape == (2, n), f"{label}: came back {q.shape}")
    lsb = float(np.max(np.abs(q.astype(np.int32) - decode_int16(want))))
    d_lu = abs(after - want_after)
    check(lsb <= WAV16_LSB and d_lu <= METER_LU,
          f"{label}: {lsb} LSB, {d_lu} LU from master_v2_bytes")
    return lsb, d_lu


def demo_expected() -> dict:
    """Each kernel's launches on the demo renderer's two clips: the default
    chain at the clips' length (the staged FFT from ~5.8 s), which the v2
    job without a pro stage runs."""
    n = int(gen_demo_assets.DUR * gen_demo_assets.SR)
    return {k: 2 * v for k, v in job_expected(
        n, 2, gen_demo_assets.STYLE, pro={}).items()}


def service_demo(app, dev, t0: float) -> dict:
    """(e) The demo renderer the service started on its engine's device
    (the clips were missing): its launches from the app's start, the four
    WAVs, each mastered clip within the v2 loudness window, finite on the
    card, and the edm clip within one int16 step of the CPU's render."""
    th = app["demo_render"]
    check(th is not None, "service demo: the service started no render")
    th.join(600)
    check(not th.is_alive(), "service demo: the render hung")
    wall = time.perf_counter() - t0
    launches = read_counts()
    expect = demo_expected()
    check(launches == expect, f"service demo: launches {launches}, "
          f"expected {expect}")
    staged = sum(v for k, v in launches.items() if k.startswith("fft_"))
    check(staged > 0, f"service demo: no staged FFT launch in {launches}")
    out = {"check": "e_demo_render", "wall_s": wall, "launches": launches,
           "staged_fft_launches": staged, "clips": {}}
    for name, x in gen_demo_assets.source_clips():
        files = {tag: decode_int16((gen_demo_assets.DEMO_DIR
                                    / f"{name}_{tag}.wav").read_bytes())
                 for tag in ("original", "mastered")}
        check(np.array_equal(files["original"], gen_demo_assets.to_int16(x)),
              f"service demo: {name}_original.wav")
        y = gen_demo_assets.master(x, dev)
        check(bool(np.all(np.isfinite(y))) and y.shape == x.shape,
              f"service demo: {name} not finite or {y.shape}")
        q = files["mastered"].astype(np.int32)
        err = float(np.max(np.abs(q - gen_demo_assets.to_int16(y))))
        check(err <= 1, f"service demo: {name}_mastered.wav {err} steps "
              "from the card's render")
        lufs = float(track_lufs((q / 32768.0).astype(np.float32)[None],
                                np.array([x.shape[-1]]))[0])
        check(TARGET_LUFS - V2_LU_BELOW <= lufs <= TARGET_LUFS + 1.0,
              f"service demo: {name} at {lufs} LUFS")
        clip = {"lufs": lufs, "peak": float(np.max(np.abs(y)))}
        if name == "edm":
            cpu = gen_demo_assets.to_int16(gen_demo_assets.master(x, "cpu"))
            clip["max_steps_vs_cpu"] = float(np.max(np.abs(q - cpu)))
            check(clip["max_steps_vs_cpu"] <= 1,
                  f"service demo: edm {clip['max_steps_vs_cpu']} steps "
                  "from the CPU's render")
        out["clips"][name] = clip
    return out


async def service_user_master(session, base, eng, upload: dict) -> tuple:
    """(b) A user registers and logs in; a bearer-authenticated ``POST
    /api/v2/master`` of one 180 s stereo upload against ``embed_branding``
    of ``master_v2_bytes``; its record in the user's history."""
    t0 = time.perf_counter()
    await http_json(session, "POST", f"{base}/api/auth/register", json={
        "email": SERVICE_USER[0], "password": SERVICE_USER[1]})
    login = await http_json(session, "POST", f"{base}/api/auth/login",
                            json={"email": SERVICE_USER[0],
                                  "password": SERVICE_USER[1]})
    hdr = {"Authorization": f"Bearer {login['access_token']}"}
    me = await http_json(session, "GET", f"{base}/api/auth/me", headers=hdr)
    check(me["email"] == SERVICE_USER[0] and me["tier"] == "pro",
          f"service user: {me}")
    reset_counts()
    t1 = time.perf_counter()
    resp = await http_json(session, "POST", f"{base}/api/v2/master",
                           data=form({"file": ("t.wav", upload["data"])}),
                           headers=hdr)
    st = await wait_done(session, base, resp["job_id"])
    blob, _ = await http_bytes(session,
                               f"{base}/api/master/result/{resp['job_id']}")
    master_s = time.perf_counter() - t1
    launches = read_counts()
    expect = job_expected(upload["n"], 2, "standard", pro={})
    check(launches == expect, f"service user: launches {launches}, "
          f"expected {expect}")
    direct, _ = run_burst(eng, [{"data": upload["data"],
                                 "kw": {"target_lufs": TARGET_LUFS}}])
    res = direct[0][0]
    want = embed_branding(res["bytes"], "wav")
    check(len(blob) == len(want) and blob[:44] == want[:44],
          "service user: header or length")
    lsb, d_lu = same_master("service user", blob, want, st["after_lufs"],
                            res["after_lufs"], upload["n"])
    hist = await http_json(session, "GET", f"{base}/api/auth/history",
                           headers=hdr)
    items = hist["items"]
    check(hist["count"] == 1 and items[0]["filename"] == "t.wav"
          and abs(items[0]["after_lufs"] - res["after_lufs"]) <= METER_LU,
          f"service user: history {hist}")
    return hdr, {"check": "b_user_master", "wall_s":
                 time.perf_counter() - t0, "master_s": master_s,
                 "launches": launches, "max_lsb": lsb, "after_lu_delta":
                 d_lu, "history_records": hist["count"]}


async def service_ai(session, base, dev, hdr, upload: dict,
                     analyze_launches: dict) -> dict:
    """(c) ``/api/ai/recommend`` of the upload: the recommendation of the
    port's ``analyze`` called on the card, its analysis within 0.01; the
    analysis graph's launches those of the analyze phase's fused 180 s
    run."""
    x, _ = wav.read_wav(upload["data"])
    reset_counts()
    t0 = time.perf_counter()
    body = await http_json(session, "POST", f"{base}/api/ai/recommend",
                           data=form({"file": ("t.wav", upload["data"])}),
                           headers=hdr)
    wall = time.perf_counter() - t0
    launches = read_counts()
    expect = analyze_expected(_bucket_for(SR, x.shape[-1]), 2, split=False)
    check(launches == expect == analyze_launches,
          f"service ai: launches {launches}, expected {expect}, the "
          f"analyze phase's {analyze_launches}")
    a = json.loads(json.dumps(analyze(x, SR, True, device=dev)))
    rec = ai.recommend_preset(a)
    got = dict(body)
    same_dict(got.pop("analysis"), {k: a.get(k) for k in (
        "lufs", "peak_dbfs", "duration_sec", "channels")}, "service ai")
    check(got == rec, f"service ai: {got} against {rec}")
    return {"check": "c_ai_recommend", "wall_s": wall, "launches": launches,
            "style": rec["style"], "target_lufs": rec["target_lufs"],
            "source": rec["source"]}


async def service_bot(eng, upload: dict) -> dict:
    """(d) ``Bot(engine=eng)`` with a fake transport: an audio message of a
    180 s stereo WAV and the preset; the document sent (not the failure
    text) against ``master_v2_bytes``, the row recorded, the launches those
    of one single-track v2 run."""
    tg = FakeTelegram(upload["data"])
    bot = Bot(api_call=tg.api, download=tg.download,
              send_document=tg.send_document, engine=eng)
    reset_counts()
    t0 = time.perf_counter()
    await bot.handle_update({"message": {"chat": {"id": 7}, "document": {
        "file_id": "f1", "file_name": "track.wav"}}})
    await bot.handle_update({"callback_query": {
        "message": {"chat": {"id": 7}}, "data": f"preset:{BOT_PRESET}"}})
    wall = time.perf_counter() - t0
    launches = read_counts()
    texts = [p.get("text", "") for _, p in tg.sent]
    check(len(tg.docs) == 1 and not any("failed" in s for s in texts),
          f"service bot: {len(tg.docs)} documents, messages {texts}")
    expect = job_expected(upload["n"], 2, "standard", pro={})
    check(launches == expect, f"service bot: launches {launches}, "
          f"expected {expect}")
    res = eng.master_v2_bytes(upload["data"], "track.wav",
                              target_lufs=PRESET_LUFS[BOT_PRESET],
                              out_format="wav", style="standard")
    with service_db.connect() as c:
        rows = [dict(r) for r in c.execute(
            "SELECT * FROM mastering_records WHERE source='telegram'")]
    check(len(rows) == 1 and rows[0]["filename"] == "track.wav",
          f"service bot: rows {rows}")
    lsb, d_lu = same_master("service bot", tg.docs[0][2], res["bytes"],
                            rows[0]["after_lufs"], res["after_lufs"],
                            upload["n"])
    return {"check": "d_bot_master", "wall_s": wall, "launches": launches,
            "document": tg.docs[0][1], "caption": tg.docs[0][3],
            "max_lsb": lsb, "after_lu_delta": d_lu}


async def service_admin(session, base, jobs_posted: int) -> dict:
    """(a) The initial admin logs in; ``/api/admin/stats`` counts the
    phase's masterings (its jobs over HTTP and the bot's), none errored,
    none left in the job store; anonymous calls are refused."""
    t0 = time.perf_counter()
    async with session.get(f"{base}/api/admin/stats") as r:
        check(r.status == 401, f"service admin: anonymous {r.status}")
    login = await http_json(session, "POST", f"{base}/api/auth/login",
                            json={"email": SERVICE_ADMIN[0],
                                  "password": SERVICE_ADMIN[1]})
    check(login["is_admin"] is True and login["tier"] == "studio",
          f"service admin: {login}")
    stats = await http_json(session, "GET", f"{base}/api/admin/stats",
                            headers={"Authorization":
                                     f"Bearer {login['access_token']}"})
    # every job's result was fetched, which takes it out of the job store
    check(stats["masterings_total"] == stats["masterings_24h"]
          == jobs_posted + 1 and stats["job_errors_24h"] == 0
          and stats["jobs_total"] == stats["jobs_running"] == 0
          and stats["users_total"] == 2,
          f"service admin: stats {stats}, {jobs_posted} jobs posted")
    return {"check": "a_admin_stats", "wall_s": time.perf_counter() - t0,
            "jobs_posted": jobs_posted,
            **{k: stats[k] for k in ("masterings_total", "masterings_24h",
                                     "job_errors_24h", "jobs_total",
                                     "users_total")}}


def phase_service(dev, eng, analyze_launches: dict) -> None:
    """The HTTP service (``runtime/service.create_app``) on the engine of
    the engine phase (its graphs warm), served over real sockets on
    127.0.0.1 with a temporary database, the initial admin configured,
    registration and the AI routes on, and the anonymous weekly limit off
    (as tests/test_service.py runs it); the smoke, one client, also lifts
    the per-IP request limit.  The landing page's demo clips are missing
    (their directory a new temporary one), so the service renders them at
    start on the card: check (e), its launches counted from the start.  ``GET /api/health``, ``/api/version``,
    ``/api/metrics``; ``POST /api/v2/batch`` of the 8 stereo uploads at the
    defaults (one job on its SSE stream, the others polled, every result
    within 2.5 LSB and 0.01 LU of ``embed_branding`` of
    ``master_v2_bytes`` on the same bytes, launches those of 8
    single-track runs); the engine burst's 10 requests as concurrent
    ``POST /api/v2/master`` calls with the pro set, at the default
    semaphore and at ``SERVICE_WIDE_SLOTS`` (wall, realtime factor, device
    busy and idle share, the batches formed, launches those of the
    batches, each stereo job's split); then analysis, the LUFS tool,
    reference match, upscale, vocal isolation (the settings store's
    override on) and auto mastering once each against the calls they
    make; then (b) a user's bearer-authenticated master and history, (c)
    the AI recommender, (d) the user bot (``Bot(engine=eng)``, a fake
    transport) on one 180 s upload, each against the port's direct call
    with its launches, and (a) the admin's stats of the phase's jobs."""
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="amw_service_")
    saved = (runtime_settings.mastering_debug_skip_limits,
             runtime_settings.rate_limit_per_minute, service.embed_branding,
             runtime_settings.registration_enabled,
             runtime_settings.feature_ai_enabled, gen_demo_assets.DEMO_DIR)
    saved_env = {k: os.environ.get(k) for k in ("AMW_ADMIN_EMAIL",
                                                "AMW_ADMIN_PASSWORD")}
    # its path is not restored: the cli phase sets its own
    service_db.set_db_path(os.path.join(tmp, "service.sqlite3"))
    runtime_settings.mastering_debug_skip_limits = True
    runtime_settings.rate_limit_per_minute = 1 << 30
    runtime_settings.registration_enabled = True
    runtime_settings.feature_ai_enabled = True
    os.environ["AMW_ADMIN_EMAIL"], os.environ["AMW_ADMIN_PASSWORD"] = \
        SERVICE_ADMIN
    gen_demo_assets.DEMO_DIR = Path(tmp) / "demos"
    service.embed_branding = timed_branding(eng)
    try:
        app = service.create_app(eng)
        torch.cuda.synchronize()
        reset_counts()
        t_start = time.perf_counter()
        with served(app) as base:
            demo = service_demo(app, dev, t_start)
            emit({"phase": "service", **demo})
            out = asyncio.run(service_requests(base, dev, eng,
                                               analyze_launches))
    finally:
        service.embed_branding = saved[2]
        runtime_settings.rate_limit_per_minute = saved[1]
        runtime_settings.mastering_debug_skip_limits = saved[0]
        runtime_settings.registration_enabled = saved[3]
        runtime_settings.feature_ai_enabled = saved[4]
        gen_demo_assets.DEMO_DIR = saved[5]
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        eng.calls = None
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "service", "http": True, **out,
          "demo_staged_fft_launches": demo["staged_fft_launches"],
          "phase_s": time.perf_counter() - t_phase})


# ---- the serving mesh: positions on one card -------------------------------

# (a) the shortest upload the default 600 s threshold routes to the
# sequence-parallel path, over 4 positions; (b) the data-parallel burst;
# (c) the separator over 2 positions; (d) the regression fixture's render
MESH_SP_S = 660.0
# an upload off the engine's 30 s sp grid (engine_sp_quantize_sec): served
# by the 660 s graph on the zero-padded upload, as most DJ sets are
MESH_SP_OFFGRID_S = 645.0
MESH_SP_POSITIONS = 4
MESH_DP_S = 30.0
MESH_DP_REQUESTS = 4
MESH_SEED = 50
MESH_HT_S = 180.0
WAV16_PAIR_LSB = 2.0  # two dithered int16 responses of one master
# the most a staged site plans past its window (twice the filter's padlen,
# three settles and 16; ~157 000 samples in this chain): the launch model
# holds where the window's plan and that length's plan agree
SITE_PAD_MAX = 1 << 18


def positions(k: int):
    """A mesh of ``k`` positions, all on ``cuda:0``."""
    return make_mesh(k, devices=["cuda:0"] * k)


def sp_position_expected(n: int, exact: bool, rows: int, pro: dict,
                         style: str) -> dict:
    """Each kernel's launches of one position's local stages, as the code
    reads (amw_tpu_torch/parallel/timeshard.py and the ops it builds), for
    the default chain config at ``style`` with the pro set ``pro``, on a
    window of ``n`` samples of ``rows`` signal rows: the interior window
    in fast mode (``exact`` False), an edge window exact (hybrid: the fast
    pass over the window plus two-pass edges on ``torch.fft``).  Unlike
    the single-device graph, the chain's modules run unfused (DC offset,
    peak guard and the normalization are reductions over the positions):
    the target curve, the multiband split (four fast passes in fast mode;
    one ``roundtrip_multi_reduce`` in exact mode), the final balance and
    the style EQ (one pass where the style sets a band) each on their
    own."""
    e = {name: 0 for name in COUNTERS}
    packed = rows % 2 == 0
    if pro.get("deesser_enabled"):
        e["env_gain"] = e["box_smooth_same"] = 1
    ballistics = [(0.0005, 0.005), (0.005, 0.1)] if (
        "transient_attack" in pro) else []
    dyn_eq = bool(pro.get("dynamic_eq_enabled"))
    if dyn_eq:
        ballistics += [(b["attack_ms"] / 1000.0, b["release_ms"] / 1000.0)
                       for b in DYNAMIC_EQ_MASTERING_BANDS]
    for att_s, rel_s in ballistics:
        a, r = scan.ar_coefs(SR, att_s, rel_s)
        short = scan.short_route(n, scan.warmup_len(a, r))
        e["env_rows" if short else "env_scan"] += 1
    if not fs.plan_ok(design.tpu_fft_plan(n)):
        return e
    cfg = STYLE_CONFIGS[style]
    style_eq = any(abs(cfg[k]) >= 0.05
                   for k in ("sub", "bass", "mids", "presence", "air"))
    passes = (int(bool(pro.get("rumble_enabled")))
              + int(bool(pro.get("deesser_enabled")))
              + 1 + 1 + int(style_eq)  # target curve, final balance, style
              + (len(DYNAMIC_EQ_MASTERING_BANDS) if dyn_eq else 0)
              + (0 if exact else 4))  # the multiband split, fast mode
    e["fft_bc_cb"] += passes
    e["fft_stage_a"] += passes * (1 if packed else 2)
    e["fft_stage_a_inv_join"] += passes if packed else 0
    if exact:  # the hybrid multiband split: one forward, the reduce
        e["fft_bccb_multi"] += 1
        e["fft_stage_a"] += 1
        e["fft_reduce_stage_a_packed" if packed
          else "fft_reduce_stage_a"] += 1
    return e


def sp_expected(n_total: int, n_pad: int, n_dev: int, rows: int,
                pro: dict, style: str) -> list:
    """Each position's launches (:func:`sp_position_expected`) at its
    window: the interior window (the chunk and both halos), the first
    position's (chunk and right halo), the last's (left halo and its
    valid samples), and where those are below the halo the
    second-to-last's (left halo, chunk and the last's valid samples)."""
    chunk = n_pad // n_dev
    halo = min(timeshard.DEFAULT_HALO, chunk)
    lv = n_total - (n_dev - 1) * chunk
    out = []
    for p in range(n_dev):
        if p == n_dev - 1:
            n, exact = halo + lv, True
        elif lv < halo and p == n_dev - 2:
            n, exact = halo + chunk + lv, True
        elif p == 0:
            n, exact = chunk + halo, True
        else:
            n, exact = chunk + 2 * halo, False
        check(design.tpu_fft_plan(n)
              == design.tpu_fft_plan(n + SITE_PAD_MAX),
              f"sp launch model: a {n}-sample window is within "
              f"{SITE_PAD_MAX} of another plan")
        out.append(sp_position_expected(n, exact, rows, pro, style))
    return out


@contextlib.contextmanager
def launches_by_position():
    """Inside the block, each position's kernel launches: every launch of
    the time-sharded step happens in a position's local stage
    (``timeshard._run_variant``; the reductions run ``torch.fft`` and
    reductions only), so the counters' change across each call is that
    position's.  Yields ``{position: {kernel: launches}}``."""
    by_pos: dict = {}
    real = timeshard._run_variant

    def counted(p, *a):
        before = read_counts()
        y = real(p, *a)
        after = read_counts()
        d = by_pos.setdefault(p, {name: 0 for name in COUNTERS})
        for name in d:
            d[name] += after[name] - before[name]
        return y

    timeshard._run_variant = counted
    try:
        yield by_pos
    finally:
        timeshard._run_variant = real


def sp_against_single(sp, y_sp, ref, n: int) -> tuple[float, dict]:
    """The sp graph's output ``y_sp`` (``n`` samples) against the
    single-device graph's ``ref`` over those samples: the largest
    difference, and the before/after loudness deltas of ``sp`` and
    ``ref``."""
    err = float((y_sp.double() - ref["out"][..., :n].double()).abs().max())
    return err, {k: abs(float(sp[k]) - float(ref[k]))
                 for k in ("before_lufs", "after_lufs")}


def mesh_sp(dev) -> dict:
    """(a) A 660 s stereo upload through ``MasteringEngine(mesh=<4
    positions on cuda:0>)``'s ``master_v2_bytes`` with ``V2_FINISH_PRO``:
    routed to ``_master_v2_sp`` (checked), its launches by position
    against :func:`sp_expected`; a warm second request under
    torch.profiler (wall, device busy and idle share, and its memory: the
    peak above what the process held before it); the sp graph from the
    engine's cache run directly on the decoded upload against the
    single-device v2 graph (exact mode) on the card: <= -90 dBFS over the
    whole track, before/after loudness within 0.01 LU, true peak under
    the ceiling; the engine's response within 2.5 LSB of its graph's
    output.  Then the first 645 s of the track, off the 30 s grid: served
    by the same sp graph (the upload zero-padded to 660 s), held to the
    single-device 660 s graph on the same zero-padded input by the same
    bars over its 645 s."""
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    track = make_track(SR, MESH_SP_S, seed=MESH_SEED)
    data = wav16(track)
    n_off = int(MESH_SP_OFFGRID_S * SR)
    data_off = wav16(track[:, :n_off])
    del track
    x, _ = wav.read_wav(data)
    x_off, _ = wav.read_wav(data_off)
    n = x.shape[-1]
    data_s = time.perf_counter() - t0
    eng = MasteringEngine(micro_batch=False, mesh=positions(
        MESH_SP_POSITIONS))
    taken = []
    real_sp = eng._master_v2_sp
    eng._master_v2_sp = lambda *a, **k: taken.append(1) or real_sp(*a, **k)
    kw = {"target_lufs": TARGET_LUFS, "style": "standard",
          "pro": dict(V2_FINISH_PRO)}
    spec = GraphSpec(sr=SR, n=n, channels=2, exact=True)

    def build_single():
        t0 = time.perf_counter()
        built = build_v2_job_graph(spec, None, kw["pro"], TARGET_LUFS,
                                   "standard", device=dev)
        return built, time.perf_counter() - t0

    # the single-device graph's host build (numpy, mostly outside the GIL)
    # beside the engine's cold request, which builds the sp graph
    pool = ThreadPoolExecutor(1)
    single = pool.submit(build_single)
    try:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        with launches_by_position() as by_pos:
            res = eng.master_v2_bytes(data, "t.wav", **kw)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        split_cold = eng.last_timings()
        launches = read_counts()
        check(taken == [1] and len(eng._sp_cache) == 1,
              f"mesh sp: route {taken}, sp graphs {list(eng._sp_cache)}")
        (key, (fn, params, n_pad)), = eng._sp_cache.items()
        check(key[1] == (SR, n, 2), f"mesh sp: graph length {key[1]}")
        expect = sp_expected(n, n_pad, MESH_SP_POSITIONS, 2, kw["pro"],
                             "standard")
        got = [by_pos.get(p) for p in range(MESH_SP_POSITIONS)]
        total = {k: sum(e[k] for e in expect) for k in COUNTERS}
        check(got == expect, f"mesh sp: launches by position {got}, "
              f"expected {expect}")
        check(launches == total, f"mesh sp: launches {launches}, "
              f"expected {total}")
        # the single-device graph on the device before the warm request,
        # so that its memory is in the baseline and not in the request's
        t0 = time.perf_counter()
        (p1, f1, _), single_build_s = single.result()
        single_wait_s = time.perf_counter() - t0

        torch.cuda.synchronize()
        base_gb = torch.cuda.memory_allocated() / 1e9
        torch.cuda.reset_peak_memory_stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res2 = eng.master_v2_bytes(data, "t.wav", **kw)
            torch.cuda.synchronize()
            warm_s = time.perf_counter() - t0
        split_warm = eng.last_timings()
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        rows = device_rows(prof, 1)
        check(rows, "mesh sp: the profiler saw no device event")
        busy = sum(ms for _, ms, _ in rows)
        graph_s = split_warm.get("graph", warm_s)

        t0 = time.perf_counter()
        res_off = eng.master_v2_bytes(data_off, "t.wav", **kw)
        torch.cuda.synchronize()
        off_s = time.perf_counter() - t0
        check(taken == [1, 1, 1] and list(eng._sp_cache) == [key],
              f"mesh sp {MESH_SP_OFFGRID_S:g} s: route {taken}, sp graphs "
              f"{list(eng._sp_cache)}")

        with torch.inference_mode():
            out = {}
            for label, xi, blobs in (("on_grid", x, (res, res2)),
                                     ("off_grid", x_off, (res_off,))):
                ni = xi.shape[-1]
                sp = fn(np.pad(xi, ((0, 0), (0, n_pad - ni))), params)
                y_sp = sp["out"][..., :ni]
                ref = f1(torch.from_numpy(
                    np.pad(xi, ((0, 0), (0, n - ni)))).to(dev), p1)
                err, d_lu = sp_against_single(sp, y_sp, ref, ni)
                out[label] = {
                    "track_s": ni / SR, "max_err_vs_single_device": err,
                    "max_err_vs_single_device_dbfs":
                        20 * np.log10(max(err, 1e-30)),
                    "lu_delta_vs_single_device": d_lu,
                    "before_lufs": blobs[0]["before_lufs"],
                    "after_lufs": blobs[0]["after_lufs"],
                    "true_peak_dbtp": float(meters.true_peak_dbfs(y_sp)),
                    "max_lsb_vs_graph": max(lsb_err(b["bytes"], y_sp)
                                            for b in blobs)}
                del sp, y_sp, ref
            del p1, f1
        for label, o in out.items():
            check(o["max_err_vs_single_device_dbfs"] <= PARITY_DBFS,
                  f"mesh sp {label}: {o['max_err_vs_single_device_dbfs']:.1f}"
                  " dBFS from the single-device graph")
            check(max(o["lu_delta_vs_single_device"].values()) <= METER_LU,
                  f"mesh sp {label}: loudness deltas "
                  f"{o['lu_delta_vs_single_device']}")
            check(o["true_peak_dbtp"] <= TP_CEILING_DB + TP_SLACK_DB,
                  f"mesh sp {label}: true peak {o['true_peak_dbtp']} dBTP")
            check(o["max_lsb_vs_graph"] <= WAV16_LSB,
                  f"mesh sp {label}: response {o['max_lsb_vs_graph']} LSB "
                  "from its graph")
    finally:
        eng.close()
        pool.shutdown()
    return {"track_s": MESH_SP_S, "positions": MESH_SP_POSITIONS,
            "n_pad": n_pad, "chunk": n_pad // MESH_SP_POSITIONS,
            "data_s": data_s, "cold_request_s": cold_s,
            "split_cold": split_cold, "variant_build_s": fn.build_seconds,
            "warm_request_s": warm_s, "split_warm": split_warm,
            "realtime_factor_warm": MESH_SP_S / warm_s,
            "device_busy_ms": busy,
            "device_idle_share_of_graph": 1.0 - busy / (graph_s * 1e3),
            "device_idle_share_of_request": 1.0 - busy / (warm_s * 1e3),
            "memory_before_request_gb": base_gb,
            "peak_device_gb": peak_gb,
            "request_peak_above_before_gb": peak_gb - base_gb,
            "launches": launches, "launches_by_position": got,
            "top": [{"kernel": k[:90], "ms": ms, "calls": c}
                    for k, ms, c in rows[:10]],
            **out["on_grid"],
            "off_grid": {**out["off_grid"], "request_s": off_s},
            "single_device_build_s": single_build_s,
            "single_device_build_wait_s": single_wait_s}


def mesh_dp(dev) -> dict:
    """(b) Four concurrent 30 s stereo requests (``V2_PRO``) to an engine
    over 2 positions and to one over 1 position (the graph built once,
    shared): the first runs one step over 2 positions, the second over
    1; launches those of the graph calls; each response within 2.5 LSB
    and 0.01 LU of the graph called directly on the batch, and within 2
    LSB and 0.01 LU of the other engine's."""
    reqs = []
    for i in range(MESH_DP_REQUESTS):
        x = make_track(SR, MESH_DP_S, seed=MESH_SEED + 1 + i)
        reqs.append({"label": f"dp_{i}", "data": wav16(x), "n": x.shape[-1],
                     "channels": 2, "kw": {"target_lufs": TARGET_LUFS,
                                           "style": "standard",
                                           "pro": dict(V2_PRO)}})
    engines = {k: RecordingEngine(mesh=positions(k)) for k in (2, 1)}
    out = {}
    try:
        two, one = engines[2], engines[1]
        t0 = time.perf_counter()
        two.master_v2_bytes(reqs[0]["data"], "t.wav", **reqs[0]["kw"])
        build_s = time.perf_counter() - t0
        (gkey, entry), = two._cache.items()
        one._cache[gkey] = entry  # one build for both engines
        spec = gkey[1]
        calls = {2: 2, 1: 1}  # graph calls of the step: positions
        for k, eng in engines.items():
            eng._batcher.window = ENGINE_WINDOW_S
            eng.batches.clear()
            torch.cuda.synchronize()
            reset_counts()
            res, wall = run_burst(eng, reqs)
            launches = read_counts()
            rows = MESH_DP_REQUESTS * 2 // k
            expect = {n_: v * calls[k] for n_, v in job_expected(
                spec.n, rows, "standard").items()}
            check(eng.batches == [(gkey, {"batch": MESH_DP_REQUESTS,
                                          "batch_compiled":
                                          MESH_DP_REQUESTS,
                                          "devices": k})],
                  f"mesh dp {k}: batches {eng.batches}")
            check(launches == expect, f"mesh dp {k}: launches {launches}, "
                  f"expected {expect}")
            out[k] = {"res": res, "wall_s": wall, "launches": launches}
        params, fn = entry[0], entry[1]
        xb = np.stack([eng._pad(wav.read_wav(r["data"])[0], spec.n)
                       for r in reqs])
        nv = np.asarray([r["n"] for r in reqs], np.int32)
        with torch.inference_mode():
            ref = fn(torch.from_numpy(xb).to(dev), params,
                     torch.from_numpy(nv).to(dev))
            to_graph = max(lsb_err(out[k]["res"][i][0]["bytes"],
                                   ref["out"][i, :, :r["n"]])
                           for k in engines for i, r in enumerate(reqs))
            lu_graph = max(abs(out[k]["res"][i][0]["after_lufs"]
                               - float(ref["after_lufs"][i]))
                           for k in engines for i in range(len(reqs)))
        del ref
        pair = max(float(np.max(np.abs(
            decode_int16(out[2]["res"][i][0]["bytes"]).astype(np.int32)
            - decode_int16(out[1]["res"][i][0]["bytes"]))))
            for i in range(len(reqs)))
        lu_pair = max(abs(out[2]["res"][i][0]["after_lufs"]
                          - out[1]["res"][i][0]["after_lufs"])
                      for i in range(len(reqs)))
        check(to_graph <= WAV16_LSB and lu_graph <= METER_LU,
              f"mesh dp: {to_graph} LSB, {lu_graph} LU from the graph")
        check(pair <= WAV16_PAIR_LSB and lu_pair <= METER_LU,
              f"mesh dp: engines {pair} LSB, {lu_pair} LU apart")
    finally:
        for eng in engines.values():
            eng.close()
    return {"requests": MESH_DP_REQUESTS, "track_s": MESH_DP_S,
            "bucket_n": spec.n, "graph_build_s": build_s,
            "wall_s": {f"{k}_positions": out[k]["wall_s"] for k in out},
            "launches": {f"{k}_positions": out[k]["launches"] for k in out},
            "max_lsb_vs_graph": to_graph, "max_lu_vs_graph": lu_graph,
            "max_lsb_between_engines": pair, "max_lu_between_engines":
            lu_pair}


def mesh_separate(dev) -> dict:
    """(c) ``isolate_vocal`` on the bundled checkpoint (f32) for a 180 s
    stereo track over 2 positions (through ``htdemucs.separate_mesh``,
    checked) against the call without a mesh (``separate``): <= -90
    dBFS."""
    x = make_track(SR, MESH_HT_S, seed=MESH_SEED + 9)
    mesh = positions(2)
    runs = []
    real = htdemucs.separate_mesh

    def spied(*a, **k):
        runs.append(1)
        return real(*a, **k)

    with env_set(AMW_HTDEMUCS_CKPT="bundled", AMW_HTDEMUCS_DTYPE="f32"):
        htdemucs.separate_mesh = spied
        try:
            t0 = time.perf_counter()
            got = isolate_vocal(x, SR, device=dev, mesh=mesh)
            mesh_s = time.perf_counter() - t0
        finally:
            htdemucs.separate_mesh = real
        t0 = time.perf_counter()
        want = isolate_vocal(x, SR, device=dev)
        single_s = time.perf_counter() - t0
    err = float(np.max(np.abs(got.astype(np.float64) - want)))
    err_db = 20 * np.log10(max(err, 1e-30))
    check(runs == [1], f"mesh separate: separate_mesh ran {len(runs)}x")
    check(got.shape == want.shape == x.shape and err_db <= PARITY_DBFS,
          f"mesh separate: {got.shape}, {err_db:.1f} dBFS from separate")
    return {"track_s": MESH_HT_S, "positions": 2, "dtype": "f32",
            "mesh_wall_s": mesh_s, "single_wall_s": single_s,
            "max_err": err, "max_err_dbfs": err_db}


@functools.cache
def regression_fixture_wav() -> bytes:
    """The regression fixture's WAV (165 s stereo, int16, no dither), as
    ``amw_tpu_torch/scripts/gen_regression_fixture.py`` writes it."""
    return wav.write_wav_int16(gen_regression_fixture.to_int16(
        gen_regression_fixture.render()), gen_regression_fixture.SR)


def mesh_regression(dev) -> dict:
    """(d) The stage-by-stage regression harness
    (``qa/mastering_regression``) on the card: the fixture that
    ``amw_tpu_torch/scripts/gen_regression_fixture.render()`` makes (165 s
    stereo, as its WAV holds it: int16, no dither), the default chain's
    full stage list, and every window metric within the thresholds of
    ``tests/fixtures/mastering_regression/expected_metrics.json``."""
    x, sr = wav.read_wav(regression_fixture_wav())
    t0 = time.perf_counter()
    rows = mastering_regression.metrics_after_each_stage(x, sr, device=dev)
    wall = time.perf_counter() - t0
    th = mastering_regression.load_expected_thresholds()
    check(th is not None, "mesh regression: no thresholds")
    ids = [r["stage"] for r in rows]
    check(ids[-2:] == ["chain_finalize_clip", "v2_output_fade_in"]
          and any("dynamics" in s for s in ids),
          f"mesh regression: stages {ids}")
    in_m = mastering_regression.window_metrics(x, sr)
    final = rows[-1]["windows"]
    ratios = {}
    for name, m in final.items():
        ratio = m["hf_rms"] / max(in_m[name]["hf_rms"], 1e-9)
        ratios[name] = ratio
        check(ratio < min(th["hf_ratio_limit"],
                          th["max_hf_rms_ratio_vs_input"][name]),
              f"mesh regression: {name} HF ratio {ratio}")
        check(m["max_abs_diff"] < min(th["max_abs_diff_limit"],
                                      th["max_final_abs_diff"]),
              f"mesh regression: {name} max |diff| {m['max_abs_diff']}")
    return {"track_s": x.shape[-1] / sr, "stages": ids, "wall_s": wall,
            "hf_ratio": ratios,
            "final_max_abs_diff": {k: m["max_abs_diff"]
                                   for k, m in final.items()},
            "thresholds": {k: th[k] for k in ("hf_ratio_limit",
                                              "max_abs_diff_limit")}}


def phase_mesh(dev) -> None:
    """The serving mesh on the card, over meshes of positions on
    ``cuda:0``: (a) :func:`mesh_sp`, (b) :func:`mesh_dp`, (c)
    :func:`mesh_separate`, (d) :func:`mesh_regression`, a line each."""
    t_phase = time.perf_counter()
    for label, run in (("sp", mesh_sp), ("dp", mesh_dp),
                       ("separate", mesh_separate),
                       ("regression", mesh_regression)):
        t0 = time.perf_counter()
        out = run(dev)
        emit({"phase": "mesh", "run": label, **out,
              "run_s": time.perf_counter() - t0})
    emit({"phase": "mesh", "phase_s": time.perf_counter() - t_phase})


# ---- the operator CLIs: amw_tpu_torch/scripts ------------------------------

CLI_MASTER_S = 180.0  # run_test_master's track (make_track, seed CLI_SEED)
CLI_VOCAL_S = 30.0  # run_isolate_vocal's track (seed VOCAL_SEED)
CLI_SEED = 60
CLI_TIMEOUT_S = 300  # a CLI run as its own process
# gen_sep_eval's f32 SNRs, card against the CPU: under bf16's own distance
# from f32 (0.004 dB), so an f32 run that went bf16 on the card fails
SEP_TOL_DB = 1e-3
# run_isolate_vocal's float32 WAV against isolate_vocal on the same input
# (the same path: bit for bit equal but for the WAV's float32 rounding)
CLI_VOCAL_SNR_DB = 120.0
ROOT = Path(__file__).resolve().parent


def cli_call(main_fn, *argv) -> tuple[int, str, float]:
    """``main_fn(argv)`` in this process: (exit code, stdout, wall s)."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(list(argv))
    return rc, buf.getvalue(), time.perf_counter() - t0


def cli_process(module: str, *argv) -> tuple[int, str, float]:
    """``python -m amw_tpu_torch.scripts.<module>`` as its own process
    from the checkout's root, as an operator runs it: (exit code, stdout,
    wall s, the process's start included); its output is printed to
    stderr where it fails."""
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", f"amw_tpu_torch.scripts.{module}", *argv],
        cwd=ROOT, capture_output=True, text=True, timeout=CLI_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        print(p.stdout[-4000:], p.stderr[-4000:], file=sys.stderr,
              flush=True)
    return p.returncode, p.stdout, wall


def cli_self_diagnosis(dev, tmp: Path) -> dict:
    """(a) ``run_self_diagnosis`` as its own process: exit 0, every
    preset's gates passed; then each preset in this process
    (``run_self_diagnosis.diagnose``: ``master_v1`` and the meters), its
    wall, its loudness as the process printed it, and the first preset's
    launches (those of the v1 chain on the staged FFT: the 12 s track
    plans 2^20)."""
    rc, out, wall = cli_process("run_self_diagnosis")
    check(rc == 0, f"cli: run_self_diagnosis exited {rc}")
    lines = out.splitlines()
    check(lines[-1] == "All self-diagnosis gates passed.",
          f"cli: run_self_diagnosis said {lines[-1:]}")
    printed = {}
    for line in lines:
        f = line.split()
        if len(f) == 11 and f[1] == "target":
            printed[f[0]] = {"target": float(f[2]), "lufs": float(f[4]),
                             "tp_dbtp": float(f[7]), "verdict": f[-1]}
    check(list(printed) == list(PRESET_LUFS)
          and all(r["verdict"] == "OK" for r in printed.values()),
          f"cli: self-diagnosis rows {printed}")
    x = run_self_diagnosis.make_track()
    idle = {name: 0 for name in COUNTERS}
    walls, launches = {}, None
    for preset in PRESET_LUFS:
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        r = run_self_diagnosis.diagnose(preset, x, SR, dev)
        walls[preset] = time.perf_counter() - t0
        counts = read_counts()
        check(r["ok"], f"cli: self-diagnosis {preset} failed in process")
        # the process printed two decimals
        check(abs(r["lufs"] - printed[preset]["lufs"]) <= 0.0051
              and abs(r["tp"] - printed[preset]["tp_dbtp"]) <= 0.0051,
              f"cli: self-diagnosis {preset}: {r['lufs']}, {r['tp']} "
              f"against {printed[preset]}")
        printed[preset].update(lufs_in_process=r["lufs"],
                               tp_in_process=r["tp"])
        if launches is None:
            launches = counts
    check(launches == {**idle, **V1_STAGED},
          f"cli: self-diagnosis launches {launches}")
    return {"process_wall_s": wall, "presets": printed,
            "preset_wall_s": walls, "launches_preset":
            next(iter(PRESET_LUFS)), "launches": launches}


def cli_debug(dev, tmp: Path) -> dict:
    """(b) ``run_debug`` as its own process: exit 0, every check passed;
    its op errors (the card against the port's CPU path)."""
    rc, out, wall = cli_process("run_debug")
    check(rc == 0, f"cli: run_debug exited {rc}")
    check(out.splitlines()[-1] == "14/14 checks passed",
          f"cli: run_debug said {out.splitlines()[-1:]}")
    errs = {name: float(e) for name, e in
            re.findall(r"\[PASS\] (.+?) \(err ([^)]*)\)", out)}
    check(len(errs) == 8, f"cli: run_debug errors {errs}")
    env = re.search(r"\[PASS\] torch devices \((.*)\)", out)
    return {"process_wall_s": wall, "checks": 14, "errors": errs,
            "environment": env.group(1) if env else None}


def cli_test_master(dev, tmp: Path) -> dict:
    """(c) ``run_test_master`` on a 180 s WAV (16-bit) twice, the first
    call and warm: exit 0, the WAV written at the input's length within 1
    LU of the target (measured again on the card), the printed wall and
    realtime factor beside this process's wall of the call."""
    x = make_track(SR, CLI_MASTER_S, seed=CLI_SEED)
    src = tmp / "in_180s.wav"
    src.write_bytes(wav16(x))
    runs = []
    for k in range(2):
        dst = tmp / f"mastered_{k}.wav"
        rc, out, wall = cli_call(run_test_master.main, str(src), str(dst))
        check(rc == 0, f"cli: run_test_master exited {rc}")
        m = re.search(r"mastered in ([\d.]+)s \(([\d.]+)x realtime\), "
                      r"(-?[\d.]+) LUFS, TP (-?[\d.]+) dBTP", out)
        check(m is not None, f"cli: run_test_master said {out!r}")
        y, sr = wav.read_wav(dst.read_bytes())
        check(sr == SR and y.shape == x.shape and np.isfinite(y).all(),
              f"cli: run_test_master wrote {y.shape} at {sr}")
        lufs = gates.integrated_lufs(y, SR, device=dev)
        check(abs(lufs - TARGET_LUFS) <= 1.0,
              f"cli: run_test_master output at {lufs} LUFS")
        runs.append({"call": "first" if k == 0 else "warm",
                     "printed_wall_s": float(m.group(1)),
                     "printed_realtime": float(m.group(2)),
                     "printed_lufs": float(m.group(3)),
                     "printed_tp_dbtp": float(m.group(4)),
                     "wav_lufs": lufs, "main_wall_s": wall})
    return {"track_s": CLI_MASTER_S, "runs": runs}


def cli_audio_test(dev, tmp: Path) -> dict:
    """(d) ``run_audio_test`` in a temporary working directory: PASS,
    both WAVs written."""
    with contextlib.chdir(tmp):
        rc, out, wall = cli_call(run_audio_test.main)
    lines = out.splitlines()
    check(rc == 0 and lines[-1] == "PASS",
          f"cli: run_audio_test exited {rc}: {lines[-1:]}")
    for name in ("test_output_v1.wav", "test_output_v2.wav"):
        y, _ = wav.read_wav((tmp / name).read_bytes())
        check(y.shape == (2, 8 * SR), f"cli: {name} is {y.shape}")
    lufs = [float(v) for v in re.findall(r"v\d: (-?[\d.]+) LUFS", out)]
    return {"wall_s": wall, "v1_lufs": lufs[0], "v2_lufs": lufs[1]}


def cli_diagnose_file(dev, tmp: Path) -> dict:
    """(e) ``gen_regression_fixture`` writes the fixture (the bytes the
    mesh phase's harness read), then ``run_diagnose_file`` on it: exit 0,
    the default chain's stages, every printed number finite."""
    with contextlib.chdir(tmp):
        rc, _, gen_wall = cli_call(gen_regression_fixture.main)
    path = tmp / gen_regression_fixture.OUT
    check(rc == 0 and path.read_bytes() == regression_fixture_wav(),
          "cli: gen_regression_fixture wrote another fixture")
    rc, out, wall = cli_call(run_diagnose_file.main, str(path))
    check(rc == 0, f"cli: run_diagnose_file exited {rc}")
    stages = [ln.split()[0] for ln in out.splitlines()
              if ln.startswith("  ") and " intro: " in ln]
    nums = [float(v) for v in re.findall(r"-?\d+\.\d+", out)]
    check(len(stages) >= 7 and stages[-1] == "v2_output_fade_in"
          and all(np.isfinite(nums)), f"cli: run_diagnose_file {stages}")
    return {"track_s": gen_regression_fixture.DUR, "stages": stages,
            "fixture_wall_s": gen_wall, "wall_s": wall}


def cli_isolate_vocal(dev, tmp: Path) -> dict:
    """(f) ``run_isolate_vocal`` on a 30 s WAV with the DSP separator and
    with htdemucs on the bundled checkpoint: exit 0, each output within
    ``CLI_VOCAL_SNR_DB`` of ``isolate_vocal`` called on the same decoded
    input, the network's output not the separator's."""
    src = tmp / "vocal_30s.wav"
    src.write_bytes(wav16(make_track(SR, CLI_VOCAL_S, seed=VOCAL_SEED)))
    x, _ = wav.read_wav(src.read_bytes())
    out = {}
    for model, extra, ckpt in (("center_extract", (), None),
                               ("htdemucs", ("--weights", "bundled"),
                                "bundled")):
        dst = tmp / f"vocals_{model}.wav"
        with env_set(AMW_HTDEMUCS_CKPT=None):
            rc, _, wall = cli_call(run_isolate_vocal.main, str(src),
                                   str(dst), "--model", model, *extra)
        y, sr = wav.read_wav(dst.read_bytes())
        check(rc == 0 and sr == SR and y.shape == x.shape
              and np.isfinite(y).all() and np.abs(y).max() > 1e-3,
              f"cli: run_isolate_vocal {model}: {y.shape}")
        with env_set(AMW_HTDEMUCS_CKPT=ckpt):
            want = isolate_vocal(x, SR, model=model, device=dev)
        snr = snr_db(want, y)
        check(snr >= CLI_VOCAL_SNR_DB,
              f"cli: run_isolate_vocal {model} SNR {snr}")
        out[model] = {"wall_s": wall, "snr_db_vs_call": snr, "y": y}
    diff = float(np.abs(out["htdemucs"]["y"]
                        - out["center_extract"]["y"]).max())
    check(diff > 1e-3, "cli: run_isolate_vocal htdemucs ran the DSP path")
    for r in out.values():
        del r["y"]
    return {"track_s": CLI_VOCAL_S, **out}


def cli_api_docs(dev, tmp: Path) -> dict:
    """(g) ``gen_api_docs --out``: exit 0, a table row for each route of
    the port's app on the card's engine, the header naming the port's
    script."""
    dst = tmp / "API.md"
    rc, out, wall = cli_call(gen_api_docs.main, "--out", str(dst))
    text = dst.read_text()
    rows = [ln for ln in text.splitlines()
            if ln.startswith("| ") and not ln.startswith("| Method")]
    groups = [ln[3:] for ln in text.splitlines() if ln.startswith("## ")]
    check(rc == 0 and out == f"wrote {dst} ({len(rows)} endpoints)\n"
          and len(rows) >= 150 and gen_api_docs.SCRIPT in text,
          f"cli: gen_api_docs said {out!r} for {len(rows)} rows")
    return {"wall_s": wall, "endpoints": len(rows), "groups": groups}


def cli_sep_eval(dev, tmp: Path) -> dict:
    """(h) ``gen_sep_eval`` on the bundled checkpoint on the card in f32
    and bf16 (``--dtype``): its four SNRs, the network above the mixture
    on both corpora, f32 within ``SEP_TOL_DB`` of the port's CPU path."""
    out = {}
    for dtype in ("f32", "bf16"):
        with env_set(AMW_HTDEMUCS_DTYPE=None, AMW_HTDEMUCS_CKPT=None):
            rc, said, wall = cli_call(gen_sep_eval.main, "--dtype", dtype)
        r = json.loads(said)
        check(rc == 0 and r["heldout_vocal_snr_db"]
              > r["heldout_mixture_snr_db"] and r["song_vocal_snr_db"]
              > r["song_mixture_snr_db"], f"cli: gen_sep_eval {dtype} {r}")
        out[dtype] = {**r, "wall_s": wall}
    t0 = time.perf_counter()
    with env_set(AMW_HTDEMUCS_DTYPE="f32"):
        cpu = gen_sep_eval.eval_checkpoint(device="cpu")
    out["cpu_f32"] = {**cpu, "wall_s": time.perf_counter() - t0}
    err = {k: abs(out["f32"][k] - v) for k, v in cpu.items()}
    check(max(err.values()) <= SEP_TOL_DB,
          f"cli: gen_sep_eval f32 card against CPU: {err}")
    return {**out, "f32_vs_cpu_db": err, "tol_db": SEP_TOL_DB}


def phase_cli(dev) -> None:
    """The operator CLIs of ``amw_tpu_torch/scripts`` on the card, each
    through its ``main`` (as an operator's command runs it) in a
    temporary directory with a temporary database: (a)
    :func:`cli_self_diagnosis`, (b) :func:`cli_debug`, (c)
    :func:`cli_test_master`, (d) :func:`cli_audio_test`, (e)
    :func:`cli_diagnose_file`, (f) :func:`cli_isolate_vocal`, (g)
    :func:`cli_api_docs`, (h) :func:`cli_sep_eval`, a line each."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()  # room for the CLIs run as their own process
    tmp = Path(tempfile.mkdtemp(prefix="amw_cli_"))
    service_db.set_db_path(str(tmp / "cli.sqlite3"))
    try:
        for label, run in (("self_diagnosis", cli_self_diagnosis),
                           ("debug", cli_debug),
                           ("test_master", cli_test_master),
                           ("audio_test", cli_audio_test),
                           ("diagnose_file", cli_diagnose_file),
                           ("isolate_vocal", cli_isolate_vocal),
                           ("api_docs", cli_api_docs),
                           ("sep_eval", cli_sep_eval)):
            t0 = time.perf_counter()
            out = run(dev, tmp)
            emit({"phase": "cli", "run": label, **out,
                  "run_s": time.perf_counter() - t0})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "cli", "phase_s": time.perf_counter() - t_phase})


# ---- the htdemucs trainer: amw_tpu_torch/scripts/train_htdemucs.py -------

TRAIN_SEED = 0
TRAIN_STEPS = 200
TRAIN_PROFILE_STEPS = 20
TRAIN_RELEASED = ("--channels", "48", "--bottom", "512")
TRAIN_RELEASED_STEPS = 5
TRAIN_SERVE_S = 30.0
# the CPU test's bars (tests/test_torch_train_jax.py)
TRAIN_LOSS_REL = 1e-6
TRAIN_GRAD_REL = 1e-4
TRAIN_GRAD_FLOOR = 1e-9  # of the network's largest gradient


def train_inputs(args, dev):
    """(config, seed-0 state, one augmented batch as (mix, target) on
    ``dev``, the stem weights) of the trainer's parser defaults plus
    ``args``."""
    cli = train_htdemucs.build_parser().parse_args(["x.npz", *args])
    cfg = htdemucs.tiny_config(channels=cli.channels,
                               bottom_channels=cli.bottom)
    stems = train_htdemucs.augmented_batch(
        np.random.default_rng(TRAIN_SEED), cli.batch, cfg.segment_samples,
        cfg.samplerate)
    w = torch.from_numpy(train_htdemucs.stem_weights(cli.vocal_weight))
    return (cli, cfg, htdemucs.init_params(cfg, seed=cli.seed),
            torch.from_numpy(stems.sum(axis=1)), torch.from_numpy(stems),
            w.reshape(1, 4, 1, 1))


def grad_agreement(got: dict, want: dict) -> dict:
    """Per gradient tensor, ``got`` against ``want``: the worst error over
    the tensor's largest among the tensors above ``TRAIN_GRAD_FLOOR`` of
    the network's largest, and the worst absolute error of the others."""
    gmax = max(float(g.abs().max()) for g in want.values())
    floor = TRAIN_GRAD_FLOOR * gmax
    worst, worst_k, under, worst_under = 0.0, None, 0, 0.0
    for k, w in want.items():
        err = float((got[k] - w).abs().max())
        scale = float(w.abs().max())
        check(np.isfinite(err), f"train: gradient of {k} not finite")
        if scale > floor:
            if err / scale >= worst:
                worst, worst_k = err / scale, k
        else:
            under += 1
            worst_under = max(worst_under, err)
    return {"grad_max": gmax, "floor": floor, "worst_rel_err": worst,
            "worst_tensor": worst_k, "under_floor": under,
            "under_floor_worst_abs_err": worst_under}


def train_one_step(dev, tmp: Path) -> dict:
    """(a) One step's loss and gradients at the trainer's defaults, the
    card's f32 against the port's CPU path at float64 (the network in f64
    behind its f32 STFT), to the CPU test's bars.  Beside it, reported:
    the CPU path at f32 against the same f64, and the card against it (the
    CPU's f32 reduction of the last time decoder's bias gradient, 1.3e5
    L1 signs a channel that nearly cancel, parts from f64 by ~3.4e-4 of
    its largest)."""
    cli, cfg, state, mix, target, w = train_inputs((), dev)
    cpu = torch.device("cpu")
    runs = {}
    for label, d, dtype in (("card", dev, torch.float32),
                            ("cpu_f32", cpu, torch.float32),
                            ("cpu_f64", cpu, torch.float64)):
        model = htdemucs.train_model(cfg, state, device=d).to(dtype)
        t0 = time.perf_counter()
        loss = train_htdemucs.loss_and_grads(
            model, mix.to(d, dtype), target.to(d, dtype), w.to(d, dtype))
        runs[label] = (float(loss), {k: p.grad.cpu().double() for k, p in
                                     model.named_parameters()},
                       time.perf_counter() - t0)
    (l_card, g_card, s_card) = runs["card"]
    (l_ref, g_ref, s_ref) = runs["cpu_f64"]
    (l_f32, g_f32, s_f32) = runs["cpu_f32"]
    loss_rel = abs(l_card - l_ref) / abs(l_ref)
    check(np.isfinite(l_card) and loss_rel <= TRAIN_LOSS_REL,
          f"train: card loss {l_card} against the CPU's {l_ref}")
    card = grad_agreement(g_card, g_ref)
    check(card["worst_rel_err"] <= TRAIN_GRAD_REL,
          f"train: card gradient of {card['worst_tensor']} "
          f"{card['worst_rel_err']} of its largest from the CPU's")
    check(card["under_floor_worst_abs_err"] <= card["floor"],
          f"train: card gradients under the floor {card}")
    return {"batch": cli.batch, "channels": cli.channels,
            "bottom": cli.bottom, "grad_tensors": len(g_ref),
            "loss_card": l_card, "loss_cpu_f64": l_ref,
            "loss_cpu_f32": l_f32, "loss_rel_err": loss_rel,
            "card_vs_cpu_f64": card,
            "cpu_f32_vs_cpu_f64": grad_agreement(g_f32, g_ref),
            "card_vs_cpu_f32": grad_agreement(g_card, g_f32),
            "card_step_s": s_card, "cpu_f32_step_s": s_f32,
            "cpu_f64_step_s": s_ref}


def train_main(dev, tmp: Path) -> dict:
    """(b) ``train_htdemucs.main`` for ``TRAIN_STEPS`` steps on the card,
    ``TRAIN_PROFILE_STEPS`` of them profiled; its ``.npz`` is left in
    ``tmp`` for (d)."""
    out = tmp / "trained.npz"
    report = {}
    rc, said, wall = cli_call(
        lambda argv: train_htdemucs.main(argv, report=report), str(out),
        str(TRAIN_STEPS), "--profile-steps", str(TRAIN_PROFILE_STEPS))
    lines = said.splitlines()
    check(rc == 0 and lines[-1] == f"saved {out}" and out.is_file(),
          f"train: main exited {rc}: {lines[-1:]}")
    losses = report["losses"]
    first, last = losses[min(losses)], losses[max(losses)]
    check(np.isfinite(first) and np.isfinite(last) and last < first,
          f"train: l1 {first} at the first logged step, {last} at the last")
    prof = report["profile"]
    check(prof["device_idle_share"] is not None,
          "train: the profile saw no device time")
    check(np.isfinite(report["best_probe_snr_db"]),
          f"train: probe {report['probes']}")
    return {"steps": TRAIN_STEPS, "main_wall_s": wall,
            "l1_first": first, "l1_last": last,
            "l1_logged": {str(k): v for k, v in losses.items()},
            **{k: report[k] for k in (
                "steady_ms_per_step", "steady_window", "host_batch_ms",
                "queue_wait_ms_per_step", "realtime_factor",
                "realtime_factor_run", "first_step_s", "peak_memory_gb",
                "wall_s",
                "probes", "best_probe_snr_db", "best_step",
                "same_vocal_snr_db", "same_mixture_snr_db",
                "heldout_vocal_snr_db", "heldout_mixture_snr_db",
                "params")},
            "host_batch_over_step": (report["host_batch_ms"]
                                     / report["steady_ms_per_step"]),
            "profile": prof}


def train_released(dev, tmp: Path) -> dict:
    """(c) Five steps at the released widths on one augmented batch each
    (made on the host before): CUDA-event ms a step (the median of the
    last four), peak memory (above what the process held before), the
    FLOPs of one forward and backward
    (``FlopCounterMode``) and their bound at ``F32_FLOPS``."""
    from torch.utils.flop_counter import FlopCounterMode

    cli, cfg, state, mix, target, w = train_inputs(TRAIN_RELEASED, dev)
    rng = np.random.default_rng(TRAIN_SEED + 1)
    batches = [(mix, target)] + [
        (torch.from_numpy(b.sum(axis=1)), torch.from_numpy(b))
        for b in (train_htdemucs.augmented_batch(
            rng, cli.batch, cfg.segment_samples, cfg.samplerate)
            for _ in range(TRAIN_RELEASED_STEPS - 1))]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    model = htdemucs.train_model(cfg, state, device=dev)
    opt, sched = train_htdemucs.make_optimizer(model.parameters(), cli.lr,
                                               TRAIN_RELEASED_STEPS)
    w = w.to(dev)
    with FlopCounterMode(display=False) as fc:
        train_htdemucs.loss_and_grads(model, mix.to(dev), target.to(dev), w)
    flops = fc.get_total_flops()
    losses, ms = [], []
    for m, t in batches:
        m, t = m.to(dev), t.to(dev)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        loss = train_htdemucs.train_step(model, opt, sched, m, t, w)
        b.record()
        b.synchronize()
        ms.append(a.elapsed_time(b))
        losses.append(float(loss))
    peak = (torch.cuda.max_memory_allocated() - mem0) / 1e9
    check(all(np.isfinite(losses)), f"train released: losses {losses}")
    step_ms = statistics.median(ms[1:])
    bound = flops / F32_FLOPS * 1e3
    return {"channels": cli.channels, "bottom": cli.bottom,
            "batch": cli.batch, "params": sum(p.numel() for p in
                                              model.parameters()),
            "losses": losses, "step_ms": ms, "ms_per_step": step_ms,
            "peak_memory_gb": peak, "step_flops": flops, "bound_ms": bound,
            "bound_by": "operations", "share_of_bound": bound / step_ms}


def train_serves(dev, tmp: Path) -> dict:
    """(d) The ``.npz`` that (b) wrote, configured through
    ``AMW_HTDEMUCS_CKPT``: ``isolate_vocal`` of a 30 s stereo track ran
    the network (its weights cached under the file's key), shape,
    finite, full scale, not silent."""
    path = str(tmp / "trained.npz")
    x = make_track(SR, TRAIN_SERVE_S, seed=HT_SEED + 3)
    try:
        with env_set(AMW_HTDEMUCS_CKPT=path, AMW_HTDEMUCS_DTYPE=None):
            t0 = time.perf_counter()
            y = isolate_vocal(x, SR, device=dev)
            wall = time.perf_counter() - t0
            key = (path, dev, htdemucs.inference_dtype(dev))
            check(key in vocal._ht_cache,
                  "train: isolate_vocal did not run the trained network")
            cfg = vocal._ht_cache[key][0]
    finally:
        for k in [k for k in vocal._ht_cache if k[0] == path]:
            del vocal._ht_cache[k]
    check(y.shape == x.shape and bool(np.all(np.isfinite(y)))
          and 1e-3 < float(np.abs(y).max()) <= 1.0,
          f"train: isolate_vocal {y.shape}, non-finite, silent or over "
          "full scale")
    return {"track_s": TRAIN_SERVE_S, "wall_s": wall,
            "config": {"channels": cfg.channels,
                       "bottom": cfg.bottom_channels,
                       "samplerate": cfg.samplerate},
            "peak": float(np.abs(y).max())}


def phase_train(dev) -> None:
    """The htdemucs trainer on the card, a line each: (a)
    :func:`train_one_step`, (b) :func:`train_main`, (c)
    :func:`train_released`, (d) :func:`train_serves`; (e) none of the 13
    kernels launched over the phase.  Run with cuDNN's and cuBLAS's TF32
    switches on, as the htdemucs phase runs: the step turns them off."""
    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    reset_counts()
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    tmp = Path(tempfile.mkdtemp(prefix="amw_train_"))
    try:
        for label, run in (("one_step", train_one_step),
                           ("main", train_main),
                           ("released", train_released),
                           ("serves", train_serves)):
            t0 = time.perf_counter()
            out = run(dev, tmp)
            emit({"phase": "train", "run": label, **out,
                  "run_s": time.perf_counter() - t0})
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved
        shutil.rmtree(tmp, ignore_errors=True)
    launches = read_counts()
    check(not any(launches.values()), f"train: launches {launches}")
    emit({"phase": "train", "launches": launches,
          "phase_s": time.perf_counter() - t_phase})


# ---- the matmul FFT route (AMW_FFT_MXU=1) ----------------------------------

MXU_REPS = 10


@contextlib.contextmanager
def route_calls():
    """The matmul FFT route's forward transforms inside the block
    (``fft_mxu.rfft_mxu``, once a routed ``fdfilter._apply_response``),
    counted in a one-element list."""
    inner = fft_mxu.rfft_mxu
    calls = [0]

    def counted(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    fft_mxu.rfft_mxu = counted
    try:
        yield calls
    finally:
        fft_mxu.rfft_mxu = inner


def mxu_cfft_flops(n: int, rows: int) -> float:
    """f32 operations of ``fft_mxu._cfft`` on ``rows`` rows of ``n``
    points, as the code runs them: at 128 points or fewer four real
    products with the DFT matrix (2·n² a row each) and two sums; above,
    the B-point transforms, the twiddle (six a point), the A-point ones."""
    if n <= 128:
        return rows * (8.0 * n * n + 2.0 * n)
    a, b = fft_mxu._split(n)
    return (mxu_cfft_flops(b, rows * a) + 6.0 * rows * n
            + mxu_cfft_flops(a, rows * b))


def mxu_pair_flops(nfft: int, rows: int) -> float:
    """rfft → complex response → irfft on the route: two half-length
    transforms, the unpack and pack (16 a bin each), the product (6 a
    bin) and the inverse's 1/n (2 a point)."""
    h = nfft // 2
    return (2 * mxu_cfft_flops(h, rows) + rows * (h + 1) * (16 + 6 + 16)
            + rows * 2.0 * h)


def mxu_pair(dev, xb: np.ndarray) -> dict:
    """(a) One transform pair over the batch's rows on the route and on
    ``torch.fft``; its error, times and bound, and the error with TF32
    on."""
    nfft = LONG_NFFT
    x = torch.from_numpy(xb.reshape(-1, xb.shape[-1])).to(dev)
    Hp = torch.from_numpy(meters.k_weight_response(SR, nfft)).to(dev)
    H = torch.complex(Hp[0], Hp[1])

    def pair():
        return fdfilter._apply_response(x, H, nfft)

    with torch.no_grad():
        with env_set(AMW_FFT_MXU=None):
            y_lib = pair()
            lib_ms = cuda_ms(pair, reps=MXU_REPS)
        with env_set(AMW_FFT_MXU="1"), route_calls() as calls:
            y = pair()
            torch.cuda.synchronize()
            check(calls[0] == 1, f"mxu pair: {calls[0]} route calls")
            route_ms = cuda_ms(pair, reps=MXU_REPS)
            saved = (torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32)
            guard = fft_mxu.full_f32
            try:
                torch.backends.cuda.matmul.allow_tf32 = True
                torch.backends.cudnn.allow_tf32 = True
                y_tf32 = pair()
                fft_mxu.full_f32 = lambda *a: contextlib.nullcontext()
                y_unguarded = pair()
            finally:
                fft_mxu.full_f32 = guard
                (torch.backends.cuda.matmul.allow_tf32,
                 torch.backends.cudnn.allow_tf32) = saved
        err, rel = rel_err(y, y_lib)
        err_tf32, _ = rel_err(y_tf32, y_lib)
        err_unguarded, _ = rel_err(y_unguarded, y_lib)
        same_tf32 = bool(torch.equal(y_tf32, y))
        del y, y_lib, y_tf32, y_unguarded
    err_db = 20 * np.log10(max(err, 1e-30))
    check(err_db <= PARITY_DBFS, f"mxu pair: route vs torch.fft "
          f"{err_db:.1f} dBFS")
    check(same_tf32 and err_tf32 == err, f"mxu pair: with TF32 on, error "
          f"{err_tf32} against {err}")
    rows = x.shape[0]
    nbytes = 4.0 * rows * (x.shape[-1] + nfft) + 8.0 * (nfft // 2 + 1)
    flops = mxu_pair_flops(nfft, rows)
    b_ms, b_by = bound_ms(nbytes, flops)
    return {"rows": rows, "n": int(x.shape[-1]), "nfft": nfft,
            "max_abs_err": err, "max_rel_err": rel, "max_err_dbfs": err_db,
            "max_abs_err_tf32_on": err_tf32, "equal_with_tf32_on": same_tf32,
            "max_abs_err_tf32_unguarded": err_unguarded,
            "ms": route_ms, "library_ms": lib_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bytes": nbytes, "flops": flops,
            "ms_over_bound": route_ms / b_ms}


def mxu_v1(dev, xb: np.ndarray, nv: np.ndarray, exact: bool) -> dict:
    """(b) The v1 180 s batch under ``AMW_FFT_MXU=1`` against the same
    graph on the default route (the variable is read at each call):
    launches, route calls, output and loudness, walls."""
    n = xb.shape[-1]
    spec = GraphSpec(sr=SR, n=n, channels=2, exact=exact)
    t0 = time.perf_counter()
    params, fn, names = build_v1_pipeline(spec, target_lufs=TARGET_LUFS,
                                          style="standard", device=dev)
    build_s = time.perf_counter() - t0
    x_d = torch.from_numpy(xb).to(dev)
    nv_d = torch.from_numpy(nv).to(dev)

    def step():
        return fn(x_d, params, nv_d)

    out = {}
    with torch.no_grad():
        for route, flag in (("default", None), ("mxu", "1")):
            with env_set(AMW_FFT_MXU=flag), route_calls() as calls:
                torch.cuda.synchronize()
                reset_counts()
                y = step()
                torch.cuda.synchronize()
                out[route] = {"launches": read_counts(), "calls": calls[0],
                              "y": y.cpu().numpy()}
                del y
                out[route]["wall_s"] = steady_wall(step, 3)
    y_mxu, y_def = out["mxu"].pop("y"), out["default"].pop("y")
    label = "exact" if exact else "fast"
    check(bool(np.all(np.isfinite(y_mxu))), f"mxu v1 {label}: non-finite")
    err = float(np.max(np.abs(y_mxu - y_def)))
    err_db = 20 * np.log10(max(err, 1e-30))
    d_lu = float(np.max(np.abs(track_lufs(y_mxu, nv)
                               - track_lufs(y_def, nv))))
    check(err_db <= PARITY_DBFS, f"mxu v1 {label}: {err_db:.1f} dBFS from "
          f"the default route")
    check(d_lu <= METER_LU, f"mxu v1 {label}: loudness delta {d_lu} LU")
    check(out["mxu"]["launches"] == out["default"]["launches"],
          f"mxu v1 {label}: launches {out['mxu']['launches']} against "
          f"{out['default']['launches']}")
    if exact:
        expect = {**{name: 0 for name in COUNTERS}, **V1_STAGED}
        check(out["mxu"]["launches"] == expect,
              f"mxu v1 exact: launches {out['mxu']['launches']}")
    else:
        check(out["mxu"]["calls"] > 0, "mxu v1 fast: the route never ran")
    return {"mode": label, "stages": names, "params_build_s": build_s,
            "route_calls": out["mxu"]["calls"],
            "launches": out["mxu"]["launches"],
            "max_err_vs_default": err, "max_err_vs_default_dbfs": err_db,
            "max_lu_delta_vs_default": d_lu,
            "wall_s_per_batch": out["mxu"]["wall_s"],
            "default_wall_s_per_batch": out["default"]["wall_s"],
            "realtime_factor": BATCH * LONG[0] / out["mxu"]["wall_s"]}


def phase_mxu(dev) -> None:
    """The matmul FFT route on the card: (a) :func:`mxu_pair`, (b)
    :func:`mxu_v1` in exact and in fast mode, a line each."""
    t_phase = time.perf_counter()
    xb, nv = make_batch(*LONG, BATCH, 2)
    t0 = time.perf_counter()
    emit({"phase": "mxu", "run": "pair", **mxu_pair(dev, xb),
          "run_s": time.perf_counter() - t0})
    for exact in (True, False):
        t0 = time.perf_counter()
        emit({"phase": "mxu", "run": "v1_180s", **mxu_v1(dev, xb, nv, exact),
              "run_s": time.perf_counter() - t0})
    emit({"phase": "mxu", "phase_s": time.perf_counter() - t_phase})


# ---- the pod mesh across processes ------------------------------------------

POD_RANKS = 2
POD_S = 60.0
POD_SEED = 70
POD_TIMEOUT_S = 300  # a worker process, its start included


def pod_batch() -> np.ndarray:
    return np.stack([make_track(SR, POD_S, seed=POD_SEED + i)
                     for i in range(POD_RANKS)])


def pod_worker(rank: int, port: int, out_dir: Path) -> None:
    """One rank of the pod (``--pod-worker``): join the group, build the
    pod mesh of two positions on ``cuda:0`` a rank, master the batch
    (cold: ``sp_batch_master``, its build included; warm: the built
    graph's second call), and write the batch and a report to
    ``out_dir``."""
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    init_distributed(f"127.0.0.1:{port}", POD_RANKS, rank)
    mesh = make_pod_mesh(sp=2, devices=["cuda:0"] * 2)
    check(mesh.shape == {"dp": POD_RANKS, "sp": 2}
          and mesh.process_index.tolist() == [[r, r] for r in
                                              range(POD_RANKS)],
          f"pod rank {rank}: mesh {mesh}")
    xb = pod_batch()
    n = xb.shape[-1]
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        y = timeshard.sp_batch_master(xb, SR, mesh, target_lufs=TARGET_LUFS)
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        launches = read_counts()
        fn, params, n_pad = timeshard.build_sp_master(
            SR, n, xb.shape[1], mesh, batch=True, target_lufs=TARGET_LUFS)
        xp = np.pad(xb, ((0, 0), (0, 0), (0, n_pad - n)))
        fn(xp, params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_warm = fn(xp, params)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        same = bool(np.array_equal(y_warm.cpu().numpy()[..., :n], y))
    np.save(out_dir / f"pod{rank}.npy", y)
    (out_dir / f"pod{rank}.json").write_text(json.dumps({
        "rank": rank, "cold_s": cold_s, "warm_s": warm_s,
        "exchange": fn.last_exchange, "launches": launches,
        "warm_equals_cold": same, "n_pad": n_pad}))
    import torch.distributed as dist

    dist.destroy_process_group()


def pod_run_workers(tmp: Path) -> float:
    """Start the pod's worker processes on a free 127.0.0.1 port and wait
    for them, each within ``POD_TIMEOUT_S`` of the start (killed past
    it); a worker's log is printed to stderr where it failed, and the run
    fails unless every worker exited 0.  Returns the wall."""
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = []
    t0 = time.perf_counter()
    try:
        for rank in range(POD_RANKS):
            log = open(tmp / f"pod{rank}.log", "w")
            procs.append((subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--pod-worker", str(rank), str(port), str(tmp)],
                cwd=ROOT, stdout=log, stderr=subprocess.STDOUT), log))
        rcs = []
        for p, _ in procs:
            left = max(POD_TIMEOUT_S - (time.perf_counter() - t0), 1.0)
            try:
                rcs.append(p.wait(timeout=left))
            except subprocess.TimeoutExpired:
                rcs.append(f"timeout {POD_TIMEOUT_S} s")
    finally:
        for p, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for rank, rc in enumerate(rcs):
        if rc != 0:
            print((tmp / f"pod{rank}.log").read_text()[-4000:],
                  file=sys.stderr, flush=True)
    check(rcs == [0] * POD_RANKS, f"pod workers exited {rcs}")
    return time.perf_counter() - t0


def phase_pod(dev) -> None:
    """The pod mesh across two processes on the card against this
    process's single-process mesh of the same grid."""
    t_phase = time.perf_counter()
    xb = pod_batch()
    with torch.no_grad():
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        ref = timeshard.sp_batch_master(
            xb, SR, make_mesh2d(2, 2, devices=["cuda:0"] * 4),
            target_lufs=TARGET_LUFS)
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t0
        ref_launches = read_counts()
    tmp = Path(tempfile.mkdtemp(prefix="pod-"))
    try:
        workers_s = pod_run_workers(tmp)
        ranks = []
        for rank in range(POD_RANKS):
            rep = json.loads((tmp / f"pod{rank}.json").read_text())
            y = np.load(tmp / f"pod{rank}.npy")
            check(y.shape == xb.shape and bool(np.all(np.isfinite(y))),
                  f"pod rank {rank}: output {y.shape}")
            err = float(np.max(np.abs(y.astype(np.float64) - ref)))
            rep["max_err_vs_single"] = err
            rep["max_err_vs_single_dbfs"] = 20 * np.log10(max(err, 1e-30))
            check(rep["max_err_vs_single_dbfs"] <= PARITY_DBFS,
                  f"pod rank {rank}: {rep['max_err_vs_single_dbfs']:.1f} "
                  f"dBFS from the single-process mesh")
            check(rep["warm_equals_cold"], f"pod rank {rank}: warm != cold")
            ranks.append(rep)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    summed = {k: sum(r["launches"][k] for r in ranks) for k in ref_launches}
    check(summed == ref_launches, f"pod: launches by rank {summed} against "
          f"the single process's {ref_launches}")
    emit({"phase": "pod", "ranks": ranks, "tracks": POD_RANKS,
          "track_s": POD_S, "single_process_s": ref_s,
          "single_process_launches": ref_launches, "workers_s": workers_s,
          "phase_s": time.perf_counter() - t_phase})


# ---- the last public functions ----------------------------------------------

LAST_ENV_S = (0.005, 0.1)  # envelope_follower_xsr's attack and release, s
LAST_CLIP_SEED = 80
RUNNER_TRACKS = 4


def last_ops_inputs() -> tuple:
    """The ``last_ops`` phase's inputs: the 180 s batch (``make_batch``,
    8 stereo tracks, the last two padded), its 16 rows, and a 2 s stereo
    clip."""
    xb, _ = make_batch(*LONG, BATCH, 2)
    return xb, xb.reshape(-1, xb.shape[-1]), make_track(
        SR, SHORT_CLIP_S, seed=LAST_CLIP_SEED)


def last_ops_calls(dev, xb, rows, clip) -> dict:
    """The phase's functions on ``dev`` by name, each a call with no
    arguments (inputs and the trim's params already on ``dev``)."""
    spec = GraphSpec(sr=SR, n=xb.shape[-1], channels=2)
    params, trim = build_high_freq_trim(spec, device=dev)
    params = to_device(params, dev)
    x, r, c = (torch.from_numpy(a).to(dev) for a in (xb, rows, clip))
    return {
        "high_freq_trim": lambda: trim(x, params),
        "envelope_xsr": lambda: scan.envelope_follower_xsr(r, SR,
                                                           *LAST_ENV_S),
        "envelope_xsr_clip": lambda: scan.envelope_follower_xsr(
            c, SR, *LAST_ENV_S),
        "maximizer_lookahead": lambda: basic.maximizer_lookahead(x, SR),
        "auto_blank_end_index": lambda: torch.stack(
            [basic.auto_blank_end_index(x[i], SR) for i in range(BATCH)]),
    }


def cpu_last_ops() -> tuple:
    """The ``last_ops`` phase's functions on the port's CPU path (in a
    parity worker).  Returns their outputs by name and the seconds."""
    with torch.no_grad():
        t0 = time.perf_counter()
        out = {k: f().numpy() for k, f in
               last_ops_calls(torch.device("cpu"), *last_ops_inputs()).items()}
        return out, time.perf_counter() - t0


def last_ops_runner(dev, xb: np.ndarray) -> dict:
    """``BatchedChainRunner`` on the card: ``RUNNER_TRACKS`` 180 s stereo
    tracks of the batch mastered on as many threads at the default
    ``standard`` chain config, cold (the chain's build included) and warm
    (launches by kernel, the wall, the realtime factor); each row within
    -90 dBFS of the single-track ``compile_chain`` output on the card,
    which shares the runner's cached graph."""
    n = xb.shape[-1]
    spec = GraphSpec(sr=SR, n=n, channels=2)
    config = default_chain_config(TARGET_LUFS, "standard")
    cfg_json = json.dumps(config, sort_keys=True, default=str)
    tracks = [xb[i] for i in range(RUNNER_TRACKS)]
    runner = BatchedChainRunner(window_ms=1000.0, max_batch=RUNNER_TRACKS,
                                device=dev)
    sizes, run = [], runner.batcher._run_batch

    def spy(key, xs, *aux):
        sizes.append(xs.shape[0])
        return run(key, xs, *aux)

    runner.batcher._run_batch = spy

    def burst() -> tuple[list, float]:
        with ThreadPoolExecutor(RUNNER_TRACKS) as pool:
            t0 = time.perf_counter()
            out = list(pool.map(
                lambda x: runner.master(spec, cfg_json, x, timeout=300.0),
                tracks))
            return out, time.perf_counter() - t0

    try:
        _, cold_s = burst()
        torch.cuda.synchronize()
        reset_counts()
        with PARITY.paused():
            ys, warm_s = burst()
        launches = read_counts()
    finally:
        runner.close()
    check(sizes == [RUNNER_TRACKS] * 2,
          f"runner: batches {sizes}, expected two of {RUNNER_TRACKS}")
    chain = compile_chain(spec, config, device=dev)
    errs = []
    with torch.no_grad():
        for x, y in zip(tracks, ys):
            check(y.shape == x.shape and bool(np.all(np.isfinite(y)))
                  and float(np.abs(y).max()) <= 1.0,
                  f"runner: output {y.shape}")
            one = chain.fn(torch.from_numpy(x).to(dev), chain.params)
            errs.append(float(np.max(np.abs(
                y.astype(np.float64) - one.cpu().numpy()))))
    err_db = 20 * np.log10(max(max(errs), 1e-30))
    check(err_db <= PARITY_DBFS,
          f"runner: {err_db:.1f} dBFS from the single-track chain")
    return {"tracks": RUNNER_TRACKS, "track_s": LONG[0], "batches": sizes,
            "cold_s": cold_s, "warm_s": warm_s,
            "realtime_factor": RUNNER_TRACKS * LONG[0] / warm_s,
            "launches": {k: v for k, v in launches.items() if v},
            "max_err_vs_single": max(errs),
            "max_err_vs_single_dbfs": err_db,
            "modules": chain.module_ids}


# the kernels each function must launch on the card, by name
LAST_OPS_KERNELS = {
    "high_freq_trim": ("fft_stage_a", "fft_bc_cb", "fft_stage_a_inv_join"),
    "envelope_xsr": ("env_scan",), "envelope_xsr_clip": ("env_rows",),
    "maximizer_lookahead": (), "auto_blank_end_index": ()}


def phase_last_ops(dev) -> None:
    """The last public functions of the port on the card: (a) each of
    ``last_ops_calls`` once (launches by kernel, reset just before, read
    just after: the trim's fast pass on kernels 4, 8, 5 at 2^23, the
    chunked envelope on 2′, the clip's on 3, the maximizer and the
    silence index on none), its output against the port's CPU path
    (``cpu_last_ops``, from a parity worker: <= -90 dBFS, the index
    equal), its CUDA-event ms; (b) :func:`last_ops_runner`."""
    t_phase = time.perf_counter()
    inputs = last_ops_inputs()
    calls = last_ops_calls(dev, *inputs)
    got, ops = {}, {}
    with torch.no_grad():
        for name, fn in calls.items():
            torch.cuda.synchronize()
            reset_counts()
            got[name] = fn().cpu().numpy()
            launches = {k: v for k, v in read_counts().items() if v}
            check(set(launches) == set(LAST_OPS_KERNELS[name]),
                  f"{name}: launched {launches}, expected "
                  f"{LAST_OPS_KERNELS[name]}")
            ops[name] = {"launches": launches, "ms": cuda_ms(fn, reps=10),
                         "shape": list(got[name].shape)}
    t0 = time.perf_counter()
    want, cpu_s = PARITY.result("last_ops")
    wait_s = time.perf_counter() - t0
    for name, entry in ops.items():
        g, w = got[name], want[name]
        check(g.shape == w.shape and bool(np.all(np.isfinite(g))),
              f"{name}: output {g.shape} against {w.shape}")
        if name == "auto_blank_end_index":
            check(np.array_equal(g, w), f"{name}: {g} against {w}")
            entry["index"] = g.tolist()
            continue
        err = float(np.max(np.abs(g.astype(np.float64) - w)))
        entry["max_err_vs_cpu"] = err
        entry["max_err_vs_cpu_dbfs"] = 20 * np.log10(max(err, 1e-30))
        check(entry["max_err_vs_cpu_dbfs"] <= PARITY_DBFS,
              f"{name}: {entry['max_err_vs_cpu_dbfs']:.1f} dBFS from the CPU")
    del calls, got, want
    emit({"phase": "last_ops", "ops": ops, "cpu_plain_s": cpu_s,
          "cpu_parity_wait_s": wait_s,
          "runner": last_ops_runner(dev, inputs[0]),
          "phase_s": time.perf_counter() - t_phase})


def main() -> None:
    phase_device()
    dev = torch.device("cuda")
    phase_build()
    tau_ns = phase_env_step(dev)
    kernels = phase_kernels(dev, tau_ns)
    kernels.update(phase_new_kernels(dev, tau_ns))
    kernels.update(phase_split_kernels(dev))
    phase_entry(dev)

    # the v1 reference run's envelope (the card's), then every run's CPU
    # parity in two worker processes, so that it runs while the card does;
    # started after the kernel phases, whose CUDA-event times include the
    # host's launch gaps, and paused in every timed loop after them
    with torch.no_grad():
        ref_env = spectral_envelope(torch.from_numpy(make_track(
            SR, LONG[0], seed=REFERENCE_SEED)).to(dev)).cpu().numpy()
    runs = parity_runs(ref_env)
    PARITY.start(2, max(1, (torch.get_num_threads() - 2) // 2))
    try:
        for label, run in runs.items():
            PARITY.submit(label, *run.parity())
        PARITY.submit("last_ops", cpu_last_ops, ())
        run_phases(dev, kernels, runs)
        check(not PARITY.jobs, f"CPU parity jobs never collected: "
              f"{list(PARITY.jobs)}")
    finally:
        PARITY.stop()


def run_phases(dev, kernels: dict, runs: dict) -> None:
    # v1: the 5 s batch runs no FFT kernel, the 180 s batch the staged FFT
    # (fused route, then split); neither runs an envelope follower or a
    # one-response pass
    idle = {name: 0 for name in COUNTERS}
    phase_slice(dev, runs["v1_5s"],
                expect={**idle, "box_smooth_same": 1, "env_gain": 1})
    v1, step, wall, y_v1 = phase_slice(
        dev, runs["v1_180s"], reps=5,
        expect={**idle, **V1_STAGED})
    phase_profile(step, wall * 1e3, "v1_180s", reps=2)
    v1_split = phase_v1_split(step, y_v1, valid_lengths(*LONG, BATCH), wall)
    del step, y_v1

    # the analysis endpoints, both routes
    an = phase_analyze(dev)

    # v2: 8 x 180 s stereo, one mono 180 s track, one 2 s clip, and one
    # 180 s track with the chain-config options of slice 4
    graphs = {}  # the v2 graphs the engine's responses are held to
    v2, step, wall, _, _ = phase_v2(dev, runs["v2_180s"], keep=graphs)
    phase_profile(step, wall * 1e3, "v2_180s", reps=2)
    del step
    mono, _, _, _, _ = phase_v2(dev, runs["v2_mono_180s"], reps=3,
                                keep=graphs)
    clip, _, _, names, _ = phase_v2(dev, runs["v2_clip_2s"], reps=10,
                                    keep=graphs)
    check({"chain:exciter", "chain:imager"} <= set(names),
          f"2 s edm clip: no exciter or imager in {names}")
    phase_v2(dev, runs["v2_options_180s"], reps=3)

    # the spectral stages: the v2 batch with the pro panel's denoiser, the
    # v1 batch with the denoiser and a reference match; no kernel of their
    # own (torch.fft, a sort), so the launches of the runs without them
    def denoise(strength, pct):
        return lambda spec, d: build_spectral_denoise(spec, strength, pct,
                                                      device=d)

    _, step, wall, _, _ = phase_v2(dev, runs["v2_denoise_180s"], reps=2)
    busy = phase_profile(step, wall * 1e3, "v2_denoise_180s", reps=1)
    del step
    phase_stages(dev, "v2_denoise_180s",
                 {"spectral_denoise": denoise(
                     *resolve_denoise(V2_DENOISE_PRO))}, 10, busy)
    # the reference match windows the wrapped zero-phase IR as the
    # reference does (pipeline.py:1599-1603, kept by amw_tpu and the
    # port), which leaves the output ~50 dB below the target: its loudness
    # is held to the port's CPU path, not to the target's window
    _, step, wall, _ = phase_slice(
        dev, runs["v1_reference_180s"], reps=2, target_window=False,
        expect={**idle, **V1_STAGED})
    busy = phase_profile(step, wall * 1e3, "v1_reference_180s", reps=1)
    del step
    ref_env = runs["v1_reference_180s"].v1_kw["reference_env"]
    phase_stages(dev, "v1_reference_180s", {
        "spectral_denoise": denoise(V1_DENOISE, 15.0),
        "reference_match": lambda spec, d: build_reference_match(
            spec, ref_env, strength=0.8, device=d)}, 0, busy)

    # the last DSP options: the v2 batch with the true-peak ceiling, the
    # reverb in M/S and the exciter at 2x (its high pass on kernels 4, 8
    # and 5 at 2^24), then its output through the export path; one track
    # with the exciter at 4x (cuFFT at 2^25), the hall reverb and the
    # limiter as a chain module; the DSP vocal separator
    _, step, wall, _, y_fin = phase_v2(
        dev, runs["v2_finish_180s"], reps=2, exciter_os=2,
        tp_ceiling_db=TP_CEILING_DB)
    busy = phase_profile(step, wall * 1e3, "v2_finish_180s", reps=1)
    del step
    phase_stages(dev, "v2_finish_180s", {
        "true_peak_limiter": lambda spec, d: build_true_peak_limiter(
            spec, TP_CEILING_DB, device=d),
        "reverb": lambda spec, d: build_reverb(
            spec, "plate", mix_mid=0.12, mix_side=0.2, device=d),
        "exciter_os2": lambda spec, d: build_harmonic_exciter(
            spec, 0.6, oversample=2, device=d)}, 10, busy)
    phase_export(dev, y_fin)
    del y_fin
    phase_v2(dev, runs["options_finish_180s"], reps=3, exciter_os=4,
             tp_ceiling_db=OPTIONS_TP_CEILING_DB)
    phase_vocal(dev)
    phase_htdemucs(dev)
    eng = RecordingEngine()
    try:
        phase_engine(dev, eng, graphs)
        del graphs
        phase_service(dev, eng, an["analyze_180s"])
    finally:
        eng.close()
    phase_mesh(dev)
    phase_cli(dev)
    phase_train(dev)
    phase_mxu(dev)
    phase_pod(dev)
    phase_last_ops(dev)

    # each kernel's launches on the path that uses it
    paths = {name: ("v1_180s", v1) for name in kernels}
    paths.update(fft_bc_cb=("v2_180s", v2), env_scan=("v2_180s", v2),
                 fft_reduce_stage_a=("v2_mono_180s", mono),
                 env_rows=("v2_clip_2s", clip),
                 fft_bc=("v1_180s_split", v1_split),
                 fft_cb_multi=("v1_180s_split", v1_split),
                 fft_cb=("analyze_180s_split", an["analyze_180s_split"]))
    for name, entry in kernels.items():
        label, launches = paths[name]
        check(launches[name] > 0, f"kernel {name} not launched on {label}")
        entry["launches"] = launches[name]
        entry["path"] = label
    check(len(kernels) == 13, f"{len(kernels)} kernels, expected 13")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "path")
    emit({"kernels": [{k: v[k] for k in keys} for v in kernels.values()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    if sys.argv[1:2] == ["--pod-worker"]:
        pod_worker(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]))
    else:
        main()
