"""HTTP service shell (aiohttp) on the port's engine (counterpart of
``amw_tpu/runtime/service.py``).

    python -m amw_tpu_torch.runtime.service

The mastering API (v1 + v2 + batch), job status/SSE/result/preview/share,
the analysis endpoints, reference match, upscale, vocal isolation, auto
mastering, health/metrics/version, presets/styles/chain config and the
static frontend, with the JAX package's route names, response shapes and
status codes; the routers of ``runtime/auth_routes.py`` (accounts),
``ai_routes.py``, ``admin_routes.py`` (and the initial admin from
``MAGIC_MASTER_``/``AMW_ADMIN_EMAIL`` and ``_PASSWORD``), ``payments.py``
and ``misc_routes.py`` (public info, referrals, the blog), registered in
the JAX service's order; the Telegram user bot and the admin/notify bot
(``runtime/bot.py``) on their webhooks where their tokens are set.  Jobs
run on ``MasteringEngine`` (micro-batched, over its serving mesh where
it has one) under the job
semaphores of ``runtime/jobs.py``; the analysis handlers, the AI routes'
analysis, the vocal separator and the user bot run on the engine's device,
so an app made with ``MasteringEngine(device="cpu")`` runs wholly on the
CPU and the default one on ``cuda`` (raising without a GPU).  At start,
where the landing page's demo clips are missing, a thread renders them on
the engine's device (``amw_tpu_torch/scripts/gen_demo_assets.py``), where
the JAX service runs its own script in a subprocess.
"""

from __future__ import annotations

import asyncio
import json
import logging
import threading
import time
import uuid

import numpy as np
from aiohttp import web

from .. import __version__
from ..constants import PRESET_LUFS, STYLE_CONFIGS
from ..models.analyze import analyze, lufs_analyze_tool
from ..models.chain import default_chain_config
from ..utils import audio_io
from ..utils.audio_io import ffmpeg_available, load_audio_from_bytes
from ..utils.metadata import embed_branding
from ..utils.trace import (TraceContext, trace_job_done, trace_job_error,
                           trace_job_start)
from . import (admin_routes, ai_routes, auth_routes, db, deps, jobs,
               misc_routes, payments, settings_store, users)
from .config import settings
from .engine import MasteringEngine, get_engine

START_TIME = time.time()


def _spawn_job(app, coro):
    """Run a job coroutine as a tracked task (cancelled on app cleanup)."""
    task = asyncio.create_task(coro)
    app["job_tasks"].add(task)
    task.add_done_callback(app["job_tasks"].discard)
    return task


async def _cancel_jobs_on_cleanup(app):
    for task in list(app["job_tasks"]):
        task.cancel()
    if app["job_tasks"]:
        await asyncio.gather(*app["job_tasks"], return_exceptions=True)

ALLOWED_EXTS = ("wav", "mp3", "flac")


def _ext(filename: str) -> str:
    return (filename or "").rsplit(".", 1)[-1].lower()


def allowed_file(filename: str) -> bool:
    return _ext(filename) in ALLOWED_EXTS


def check_audio_magic_bytes(data: bytes, filename: str) -> bool:
    """Magic-byte sniff (reference helpers.py:33-49)."""
    if len(data) < 12:
        return False
    ext = _ext(filename)
    if ext == "wav":
        return data[:4] == b"RIFF" and data[8:12] == b"WAVE"
    if ext == "flac":
        return data[:4] == b"fLaC"
    if ext == "mp3":
        return data[:3] == b"ID3" or (data[0] == 0xFF and (data[1] & 0xE0) == 0xE0)
    return False


def _json_safe(v):
    if v is None:
        return None
    f = float(v)
    if not np.isfinite(f):
        return None
    return round(f, 2)


def _err(status: int, detail: str) -> web.HTTPException:
    exc_cls = {400: web.HTTPBadRequest, 403: web.HTTPForbidden,
               404: web.HTTPNotFound,
               409: web.HTTPConflict, 429: web.HTTPTooManyRequests,
               503: web.HTTPServiceUnavailable}.get(status, web.HTTPBadRequest)
    return exc_cls(text=json.dumps({"detail": detail}),
                   content_type="application/json")


async def _read_upload(request: web.Request):
    """Parse multipart form -> (fields dict, file bytes, filename)."""
    reader = await request.multipart()
    fields: dict = {}
    data = None
    filename = None
    async for part in reader:
        if part.name == "file":
            filename = part.filename or "audio.wav"
            data = await part.read(decode=False)
        else:
            fields[part.name] = (await part.read(decode=False)).decode()
    return fields, data, filename


def _validate_upload(data: bytes, filename: str, max_mb: int) -> None:
    if not allowed_file(filename):
        raise _err(400, "Unsupported format. Allowed: WAV, MP3, FLAC.")
    if data is None or len(data) == 0:
        raise _err(400, "Empty upload")
    if len(data) > max_mb * 1024 * 1024:
        raise _err(400, f"File larger than {max_mb} MB.")
    if not check_audio_magic_bytes(data, filename):
        raise _err(400, "File content does not match a supported audio format.")
    ext = _ext(filename)
    if ext != "wav" and not audio_io.lossy_codec_available():
        # FLAC still decodes through native/flac.cpp without any codec shim
        from .. import native

        if not (ext == "flac" and native.flac_available()):
            raise _err(400, f"Reading {ext.upper()} requires ffmpeg. "
                            "Install: sudo apt-get install -y ffmpeg")


def _resolve_target_lufs(fields: dict) -> tuple[float, str]:
    preset = (fields.get("preset") or "").strip().lower()
    if preset in PRESET_LUFS:
        return PRESET_LUFS[preset], preset
    try:
        t = float(fields.get("target_lufs", settings.default_target_lufs))
    except ValueError:
        t = settings.default_target_lufs
    return float(np.clip(t, -36.0, -6.0)), preset or "custom"


# ───────────────────────────── job execution ─────────────────────────────


async def _run_job_v1(app, job_id: str, kwargs: dict):
    sem = jobs.select_semaphore(kwargs.pop("is_priority", False))
    async with sem:
        job = jobs.get_job(job_id)
        if job is None:
            return
        engine: MasteringEngine = app["engine"]
        ctx = TraceContext.build(job_id, job.get("original_filename") or "",
                                 "v1", style=job.get("style", "standard"),
                                 target_lufs=job.get("target_lufs"))
        trace_job_start(ctx)

        def progress(pct, msg):
            jobs.update_job(job_id, progress=pct, message=msg)

        try:
            res = await asyncio.to_thread(
                engine.master_v1_bytes,
                job["original_bytes"], job["original_filename"],
                progress=progress, **kwargs,
            )
            out_name = ((job["original_filename"] or "master").rsplit(".", 1)[0]
                        + f"_mastered.{job['out_format']}")
            branded = embed_branding(res["bytes"], job["out_format"])
            jobs.update_job(
                job_id, status="done", progress=100, message="Done",
                result_bytes=branded, filename=out_name,
                before_lufs=res["before_lufs"], after_lufs=res["after_lufs"],
                done_at=time.time(),
            )
            db.record_mastering(job.get("notify_user_id"),
                                job["original_filename"], job.get("style"),
                                job.get("target_lufs"), res["before_lufs"],
                                res["after_lufs"], job["out_format"])
            trace_job_done(ctx, before_lufs=res["before_lufs"],
                           after_lufs=res["after_lufs"])
        except Exception as e:  # noqa: BLE001
            jobs.update_job(job_id, status="error", progress=0, message="",
                            error=str(e), done_at=time.time())
            trace_job_error(ctx, e)


async def _run_job_v2(app, job_id: str, kwargs: dict):
    sem = jobs.select_semaphore(kwargs.pop("is_priority", False))
    async with sem:
        job = jobs.get_job(job_id)
        if job is None:
            return
        engine: MasteringEngine = app["engine"]
        ctx = TraceContext.build(job_id, job.get("original_filename") or "",
                                 "v2", style=job.get("style", "standard"),
                                 target_lufs=job.get("target_lufs"),
                                 pro_params=kwargs.get("pro"))
        trace_job_start(ctx)

        def progress(pct, msg):
            jobs.update_job(job_id, progress=pct, message=msg)

        try:
            res = await asyncio.to_thread(
                engine.master_v2_bytes,
                job["original_bytes"], job["original_filename"],
                progress=progress, **kwargs,
            )
            fmt = job["out_format"]
            out_ext = "m4a" if fmt == "aac" else fmt
            out_name = ((job["original_filename"] or "master").rsplit(".", 1)[0]
                        + f"_mastered.{out_ext}")
            branded = embed_branding(res["bytes"], fmt)
            jobs.update_job(
                job_id, status="done", progress=100, message="Done",
                result_bytes=branded, filename=out_name,
                before_lufs=res["before_lufs"], after_lufs=res["after_lufs"],
                done_at=time.time(),
            )
            db.record_mastering(job.get("notify_user_id"),
                                job["original_filename"], job.get("style"),
                                job.get("target_lufs"), res["before_lufs"],
                                res["after_lufs"], fmt)
            trace_job_done(ctx, before_lufs=res["before_lufs"],
                           after_lufs=res["after_lufs"])
        except Exception as e:  # noqa: BLE001
            jobs.update_job(job_id, status="error", progress=0, message="",
                            error=str(e), done_at=time.time())
            trace_job_error(ctx, e)


# ───────────────────────────── handlers ──────────────────────────────────


async def h_bot_webhook(request):
    bot = request.app.get("bot")
    if bot is None:
        raise _err(404, "Bot is not configured")
    try:
        update = await request.json()
    except Exception:  # noqa: BLE001
        raise _err(400, "Invalid JSON")
    _spawn_job(request.app, bot.handle_update(update))
    return web.json_response({"ok": True})


async def h_notify_bot_webhook(request):
    """Admin/notify bot webhook (reference: bot/notify_webhook_route.py:15):
    optional secret-token check, then feed the update to the notify bot."""
    secret = (settings.telegram_bot_webhook_secret or "").strip()
    if secret and request.headers.get(
            "X-Telegram-Bot-Api-Secret-Token") != secret:
        raise _err(403, "Invalid secret")
    nbot = request.app.get("notify_bot")
    if nbot is None:
        raise _err(503, "Notify bot not configured")
    try:
        update = await request.json()
    except Exception:  # noqa: BLE001
        raise _err(400, "Invalid JSON")

    async def _bg():
        # Off the event loop: the notify bot's transport is blocking
        # urllib, and /broadcast loops over every linked user.
        try:
            await asyncio.to_thread(nbot.handle_update_sync, update)
        except Exception:  # noqa: BLE001 — mirror the reference: log only
            logging.getLogger("amw_tpu_torch.bot").exception(
                "notify bot update failed")

    _spawn_job(request.app, _bg())
    return web.json_response({"ok": True})


async def h_health(request):
    ok_db = True
    try:
        db.setting_get("_health_probe")
    except Exception:
        ok_db = False
    c = jobs.counts()
    status = "ok" if ok_db else "degraded"
    return web.json_response({
        "status": status,
        "uptime_sec": round(time.time() - START_TIME, 1),
        "db": "ok" if ok_db else "unavailable",
        # "ffmpeg" is the reference's health key for the lossy-codec
        # boundary (main.py:381-466); here it is "ok" when either the
        # in-process lavc shim or the CLI can serve MP3/OPUS/AAC
        "ffmpeg": "ok" if audio_io.lossy_codec_available() else "missing",
        "lossy_codec": ("native" if audio_io.lavc_available() else
                        "cli" if ffmpeg_available() else "missing"),
        "jobs_running": c["jobs_running"],
        "jobs_total": c["jobs_total"],
        "version": __version__,
    })


async def h_metrics(request):
    c = jobs.counts()
    engine = request.app["engine"]
    return web.json_response({
        "uptime_sec": round(time.time() - START_TIME, 1),
        "jobs_running": c["jobs_running"],
        "jobs_total": c["jobs_total"],
        "version": __version__,
        # Serving-mesh observability: the mesh's positions and the last
        # micro-batch (batch width / compiled width / positions used).
        "mesh_devices": (int(engine.mesh.devices.size)
                         if getattr(engine, "mesh", None) is not None
                         else 1),
        "last_batch": engine.last_batch_info,
    })


async def h_version(request):
    return web.json_response({"version": __version__,
                              "engine": "amw_tpu_torch"})


async def h_presets(request):
    return web.json_response({"presets": PRESET_LUFS})


async def h_styles(request):
    styles = {
        name: {"lufs": cfg["lufs"], "exciter_db": cfg["exciter_db"],
               "imager_width": cfg["imager_width"],
               "parallel_mix": cfg["parallel_mix"],
               "comp_mult": cfg["comp_mult"]}
        for name, cfg in STYLE_CONFIGS.items()
    }
    return web.json_response({"styles": styles})


async def h_chain_default(request):
    try:
        target = float(request.query.get("target_lufs", -14.0))
    except ValueError:
        target = -14.0
    style = request.query.get("style", "standard")
    return web.json_response(default_chain_config(target, style))


def _admit(request, filename: str, data: bytes):
    """Shared admission: user, tier upload limit, free-anon weekly limit.
    Returns (user, is_priority)."""
    user = deps.get_current_user_optional(request)
    tier = (user.get("tier") if user else "free") or "free"
    _validate_upload(data, filename,
                     settings_store.get_max_upload_mb(filename, tier))
    if user is None and not settings.debug \
            and not settings.mastering_debug_skip_limits:
        ip = deps.client_ip(request)
        lim = deps.check_free_weekly_limit(ip)
        if not lim["allowed"]:
            raise _err(429, "Free weekly limit reached. Sign in or upgrade.")
        deps.record_free_usage(ip)
    return user, deps.is_priority_user(user)


async def h_master_v1(request):
    jobs.prune_jobs()
    fields, data, filename = await _read_upload(request)
    target_lufs, preset = _resolve_target_lufs(fields)
    style = (fields.get("style") or "standard").strip().lower()
    if style not in STYLE_CONFIGS:
        style = "standard"
    out_format = (fields.get("out_format") or "wav").strip().lower()
    user, is_priority = _admit(request, filename, data)
    try:
        load_audio_from_bytes(data[: 4 << 20] if _ext(filename) == "wav" else data,
                              filename)
    except Exception:
        # trial decode of the head may fail for truncated WAV chunks; decode
        # fully in the job instead
        pass

    job_id = str(uuid.uuid4())
    jobs.new_job(job_id, target_lufs=target_lufs, style=style, data=data,
                 filename=filename, out_format=out_format,
                 notify_user_id=int(user["sub"]) if user else None)
    kwargs = dict(
        target_lufs=target_lufs, out_format=out_format, style=style,
        denoise_strength=float(fields.get("denoise_strength", 0) or 0),
        transient_attack=float(fields.get("transient_attack", 1.0) or 1.0),
        transient_sustain=float(fields.get("transient_sustain", 1.0) or 1.0),
        dither_type=(fields.get("dither_type") or "tpdf"),
        is_priority=is_priority,
    )
    _spawn_job(request.app, _run_job_v1(request.app, job_id, kwargs))
    return web.json_response({"job_id": job_id, "preset": preset,
                              "target_lufs": target_lufs, "style": style})


async def h_master_v2(request):
    jobs.prune_jobs()
    fields, data, filename = await _read_upload(request)
    target_lufs, preset = _resolve_target_lufs(fields)
    style = (fields.get("style") or "standard").strip().lower()
    if style not in STYLE_CONFIGS:
        style = "standard"
    out_format = (fields.get("out_format") or "wav").strip().lower()
    if out_format not in ("wav", "flac", "mp3", "opus", "aac"):
        out_format = "wav"
    bitrate = None
    if fields.get("bitrate"):
        try:
            bitrate = int(fields["bitrate"])
        except ValueError:
            bitrate = None
    chain_config = None
    if fields.get("config"):
        try:
            chain_config = json.loads(fields["config"])
        except json.JSONDecodeError:
            raise _err(400, "Invalid chain config JSON")
    user, is_priority = _admit(request, filename, data)

    pro = {}
    for k in ("rumble_enabled", "deesser_enabled", "dynamic_eq_enabled",
              "true_peak_enabled", "apply_vocal_isolation"):
        if fields.get(k) is not None:
            pro[k] = fields[k].strip().lower() in ("1", "true", "yes", "on")
    for k in ("rumble_cutoff", "denoise_strength", "denoise_noise_percentile",
              "deesser_threshold", "deesser_freq_hi", "transient_attack",
              "transient_sustain", "parallel_mix", "true_peak_ceiling_db"):
        if fields.get(k) not in (None, ""):
            try:
                pro[k] = float(fields[k])
            except ValueError:
                pass
    if fields.get("denoise_preset"):
        pro["denoise_preset"] = fields["denoise_preset"]
    if pro.get("apply_vocal_isolation") and not settings_store.get_setting_bool(
            "vocal_isolation_enabled", settings.vocal_isolation_enabled):
        raise _err(503, "Vocal isolation is disabled on this server")

    job_id = str(uuid.uuid4())
    jobs.new_job(job_id, target_lufs=target_lufs, style=style, data=data,
                 filename=filename, out_format=out_format,
                 notify_user_id=int(user["sub"]) if user else None)
    kwargs = dict(
        target_lufs=target_lufs, out_format=out_format, style=style,
        chain_config=chain_config,
        dither_type=fields.get("dither_type"),
        auto_blank_sec=(float(fields["auto_blank_sec"])
                        if fields.get("auto_blank_sec") else None),
        bitrate=bitrate, pro=pro, is_priority=is_priority,
    )
    _spawn_job(request.app, _run_job_v2(request.app, job_id, kwargs))
    return web.json_response({"job_id": job_id, "preset": preset,
                              "target_lufs": target_lufs, "style": style,
                              "version": "v2"})


async def h_batch_v2(request):
    if not settings_store.get_setting_bool("feature_batch_enabled", True):
        raise _err(503, "Batch mastering is disabled")
    jobs.prune_jobs()
    reader = await request.multipart()
    files = []
    fields: dict = {}
    async for part in reader:
        if part.name == "files":
            files.append((part.filename or "audio.wav",
                          await part.read(decode=False)))
        else:
            fields[part.name] = (await part.read(decode=False)).decode()
    if not files:
        raise _err(400, "No files uploaded")
    if len(files) > settings.batch_max_files:
        raise _err(400, f"At most {settings.batch_max_files} files per batch")
    target_lufs, _ = _resolve_target_lufs(fields)
    style = (fields.get("style") or "standard").strip().lower()
    out_format = (fields.get("out_format") or "wav").strip().lower()
    job_ids = []
    user = deps.get_current_user_optional(request)
    is_priority = deps.is_priority_user(user)
    tier = (user.get("tier") if user else "free") or "free"
    for filename, data in files:
        _validate_upload(data, filename,
                         settings_store.get_max_upload_mb(filename, tier))
        job_id = str(uuid.uuid4())
        jobs.new_job(job_id, target_lufs=target_lufs, style=style, data=data,
                     filename=filename, out_format=out_format,
                     notify_user_id=int(user["sub"]) if user else None)
        kwargs = dict(target_lufs=target_lufs, out_format=out_format,
                      style=style, chain_config=None, dither_type=None,
                      auto_blank_sec=None, bitrate=None, pro={},
                      is_priority=is_priority)
        _spawn_job(request.app, _run_job_v2(request.app, job_id, kwargs))
        job_ids.append(job_id)
    return web.json_response({"job_ids": job_ids, "count": len(job_ids)})


def _job_payload(job):
    return {
        "status": job["status"],
        "progress": int(job.get("progress", 0)),
        "message": job.get("message") or "",
        "error": job.get("error"),
        "before_lufs": _json_safe(job.get("before_lufs")),
        "after_lufs": _json_safe(job.get("after_lufs")),
        "target_lufs": _json_safe(job.get("target_lufs")),
        "style": job.get("style", "standard"),
    }


async def h_status(request):
    jobs.prune_jobs()
    job = jobs.get_job(request.match_info["job_id"])
    if job is None:
        raise _err(404, "Job not found")
    return web.json_response(_job_payload(job))


async def h_progress_sse(request):
    job_id = request.match_info["job_id"]
    resp = web.StreamResponse(headers={
        "Content-Type": "text/event-stream",
        "Cache-Control": "no-cache",
        "X-Accel-Buffering": "no",
        "Connection": "keep-alive",
    })
    await resp.prepare(request)

    async def send(payload):
        await resp.write(f"data: {json.dumps(payload)}\n\n".encode())

    poll, max_wait, elapsed, last = 0.4, 600.0, 0.0, -1
    while elapsed < max_wait:
        job = jobs.get_job(job_id)
        if job is None:
            await send({"status": "error", "progress": 0,
                        "message": "Job not found"})
            break
        progress = int(job.get("progress", 0))
        status = job.get("status", "running")
        if progress != last or status in ("done", "error"):
            await send(_job_payload(job))
            last = progress
            if status in ("done", "error"):
                break
        await asyncio.sleep(poll)
        elapsed += poll
    else:
        await send({"status": "error", "progress": 0, "message": "Timeout"})
    await resp.write_eof()
    return resp


async def h_result(request):
    job_id = request.match_info["job_id"]
    job = jobs.get_job(job_id)
    if job is None:
        raise _err(404, "Job not found")
    if job["status"] != "done" or not job.get("result_bytes"):
        raise _err(400, "Result not ready or job errored")
    out = job["result_bytes"]
    filename = job.get("filename") or "mastered.wav"
    jobs.all_jobs().pop(job_id, None)
    return web.Response(
        body=out, content_type="application/octet-stream",
        headers={"Content-Disposition": f'attachment; filename="{filename}"'},
    )


async def h_preview(request):
    job = jobs.get_job(request.match_info["job_id"])
    if job is None:
        raise _err(404, "Job not found")
    src = request.query.get("src", "mastered")
    if src == "original":
        blob = job.get("original_bytes")
        ext = _ext(job.get("original_filename") or "audio.wav")
    else:
        if job.get("status") != "done" or not job.get("result_bytes"):
            raise _err(400, "Mastered version not ready yet")
        blob = job.get("result_bytes")
        ext = job.get("out_format", "wav")
    if not blob:
        raise _err(404, "Audio unavailable")
    mime = {"wav": "audio/wav", "mp3": "audio/mpeg", "flac": "audio/flac",
            "opus": "audio/ogg", "aac": "audio/mp4",
            "m4a": "audio/mp4"}.get(ext, "audio/wav")
    return web.Response(body=blob, content_type=mime, headers={
        "Accept-Ranges": "bytes", "Cache-Control": "no-cache"})


async def h_share(request):
    job = jobs.get_job(request.match_info["job_id"])
    if job is None:
        raise _err(404, "Job not found")
    if job.get("status") != "done" or not job.get("result_bytes"):
        raise _err(400, "Result not ready yet")
    from .share_card import render_share_png

    png = render_share_png(job)
    if not png:
        raise _err(503, "Share card unavailable")
    return web.Response(body=png, content_type="image/png", headers={
        "Cache-Control": "no-store",
        "Content-Disposition": 'inline; filename="magic-master-share.png"'})


async def h_analyze(request):
    fields, data, filename = await _read_upload(request)
    _validate_upload(data, filename, settings_store.get_max_upload_mb(filename))
    try:
        audio, sr = load_audio_from_bytes(data, filename)
    except Exception as e:  # noqa: BLE001
        raise _err(400, f"Could not read audio: {e}")
    extended = (fields.get("extended") or "").strip().lower() in (
        "1", "true", "yes", "on")
    out = await asyncio.to_thread(analyze, audio, sr, extended,
                                  device=request.app["engine"].device)
    return web.json_response(out)


async def h_reference_match(request):
    reader = await request.multipart()
    fields: dict = {}
    files: dict = {}
    async for part in reader:
        if part.name in ("file", "reference"):
            files[part.name] = (part.filename or "audio.wav",
                                await part.read(decode=False))
        else:
            fields[part.name] = (await part.read(decode=False)).decode()
    if "file" not in files or "reference" not in files:
        raise _err(400, "Both 'file' and 'reference' uploads are required")
    user = deps.get_current_user_optional(request)
    tier = (user.get("tier") if user else "free") or "free"
    for key in ("file", "reference"):
        fname, data = files[key]
        _validate_upload(data, fname,
                         settings_store.get_max_upload_mb(fname, tier))
    strength = float(np.clip(float(fields.get("strength", 0.8) or 0.8), 0.0, 1.0))
    out_format = (fields.get("out_format") or "wav").strip().lower()
    if out_format not in ("wav", "flac", "mp3", "opus", "aac"):
        raise _err(400, "Export format: wav, mp3, flac, opus or aac.")
    bitrate = None
    if fields.get("bitrate"):
        try:
            bitrate = int(fields["bitrate"])
        except ValueError:
            bitrate = None
    engine: MasteringEngine = request.app["engine"]
    try:
        res = await asyncio.to_thread(
            engine.reference_match_bytes,
            files["file"][1], files["file"][0],
            files["reference"][1], files["reference"][0],
            strength=strength, out_format=out_format, bitrate=bitrate)
    except Exception as e:  # noqa: BLE001
        raise _err(400, f"Processing error: {e}")
    out_ext = "m4a" if out_format == "aac" else out_format
    base = files["file"][0].rsplit(".", 1)[0]
    media = "audio/mp4" if out_format == "aac" else f"audio/{out_format}"
    return web.Response(body=res["bytes"], content_type=media, headers={
        "Content-Disposition":
        f'attachment; filename="{base}_ref_matched.{out_ext}"'})


_UPSCALE_ALLOWED_SR = (48000, 96000, 192000)


async def h_upscale(request):
    fields, data, filename = await _read_upload(request)
    try:
        target_sr = int(fields.get("target_sr", 96000))
    except ValueError:
        target_sr = 96000
    if target_sr not in _UPSCALE_ALLOWED_SR:
        raise _err(400, f"target_sr must be one of {_UPSCALE_ALLOWED_SR}.")
    _validate_upload(data, filename, settings_store.get_max_upload_mb(filename))
    engine: MasteringEngine = request.app["engine"]
    try:
        res = await asyncio.to_thread(engine.upscale_bytes, data, filename,
                                      target_sr=target_sr)
    except ValueError as e:
        raise _err(400, str(e))
    base = (filename or "audio").rsplit(".", 1)[0]
    return web.Response(body=res["bytes"], content_type="audio/wav", headers={
        "Content-Disposition":
        f'attachment; filename="{base}_upscale_{target_sr // 1000}k.wav"'})


async def h_master_auto(request):
    """Auto mastering: analyze -> AI preset recommendation -> v2 job
    (mastering.py:1040-1172)."""
    from . import ai

    jobs.prune_jobs()
    fields, data, filename = await _read_upload(request)
    out_format = (fields.get("out_format") or "wav").strip().lower()
    if out_format not in ("wav", "flac", "mp3", "opus", "aac"):
        raise _err(400, "Export format: wav, mp3, flac, opus or aac.")
    user, is_priority = _admit(request, filename, data)
    ident = (f"user:{user['sub']}" if user
             else f"ip:{deps.client_ip(request)}")
    tier = (user.get("tier") if user else "free") or "free"
    lim = ai.check_ai_limit(ident, tier)
    if not lim["ok"]:
        raise _err(429, f"AI daily limit reached: {lim['limit']}/day.")
    try:
        audio, sr = load_audio_from_bytes(data, filename)
    except Exception as e:  # noqa: BLE001
        raise _err(400, f"Could not read audio: {e}")
    analysis = await asyncio.to_thread(analyze, audio, sr, True,
                                       device=request.app["engine"].device)
    rec = await asyncio.to_thread(ai.recommend_preset, analysis)
    ai.record_ai_usage(ident)
    style = rec.get("style") if rec.get("style") in STYLE_CONFIGS else "standard"
    target_lufs = max(-24.0, min(-6.0, float(rec.get("target_lufs", -14.0))))
    job_id = str(uuid.uuid4())
    jobs.new_job(job_id, target_lufs=target_lufs, style=style, data=data,
                 filename=filename, out_format=out_format,
                 notify_user_id=int(user["sub"]) if user else None)
    kwargs = dict(target_lufs=target_lufs, out_format=out_format, style=style,
                  chain_config=rec.get("chain_config"), dither_type=None,
                  auto_blank_sec=None, bitrate=None, pro={},
                  is_priority=is_priority)
    _spawn_job(request.app, _run_job_v2(request.app, job_id, kwargs))
    return web.json_response({"job_id": job_id, "status": "running",
                              "version": "v2", "style": style,
                              "target_lufs": target_lufs,
                              "reason": rec.get("reason")})


async def h_isolate_vocal(request):
    if not settings_store.get_setting_bool("vocal_isolation_enabled",
                                            settings.vocal_isolation_enabled):
        raise _err(503, "Vocal isolation is disabled on this server")
    fields, data, filename = await _read_upload(request)
    _validate_upload(data, filename, settings_store.get_max_upload_mb(filename))
    from ..models.vocal import isolate_vocal_bytes

    try:
        vocal_bytes = await asyncio.to_thread(
            isolate_vocal_bytes, data, filename or "audio.wav",
            device=request.app["engine"].device)
    except Exception as e:  # noqa: BLE001
        raise _err(400, f"Vocal isolation failed: {e}")
    base = (filename or "audio").rsplit(".", 1)[0]
    return web.Response(
        body=vocal_bytes, content_type="audio/wav",
        headers={"Content-Disposition":
                 f'attachment; filename="{base}_vocals.wav"'})


async def h_lufs_tool(request):
    fields, data, filename = await _read_upload(request)
    if not allowed_file(filename or ""):
        raise _err(400, "Format: WAV, MP3 or FLAC.")
    if len(data) > 50 * 1024 * 1024:
        raise _err(400, "File larger than 50 MB.")
    if not check_audio_magic_bytes(data, filename):
        raise _err(400, "File content does not look like a supported format.")
    try:
        audio, sr = load_audio_from_bytes(data, filename)
    except Exception as e:  # noqa: BLE001
        raise _err(400, f"Could not read audio: {e}")
    out = await asyncio.to_thread(lufs_analyze_tool, audio, sr,
                                  _ext(filename),
                                  device=request.app["engine"].device)
    return web.json_response(out)


async def h_measure(request):
    fields, data, filename = await _read_upload(request)
    _validate_upload(data, filename, settings_store.get_max_upload_mb(filename))
    try:
        audio, sr = load_audio_from_bytes(data, filename)
    except Exception as e:  # noqa: BLE001
        raise _err(400, f"Could not read audio: {e}")
    out = await asyncio.to_thread(analyze, audio, sr, False,
                                  device=request.app["engine"].device)
    return web.json_response({
        "lufs": out.get("lufs"),
        "peak_dbfs": out.get("peak_dbfs"),
        "duration_sec": out.get("duration_sec"),
        "sample_rate": out.get("sample_rate"),
        "channels": out.get("channels"),
    })


@web.middleware
async def _gate_middleware(request, handler):
    """Global per-IP rate limit (main.py:151-187) and maintenance mode
    (main.py:202-217)."""
    path = request.path
    if path.startswith("/api"):
        ip = deps.client_ip(request)
        if not deps.check_global_rate_limit(ip):
            raise _err(429, "Too many requests. Try again in a minute.")
        if settings_store.get_setting_bool("maintenance_mode", False):
            if not (path.startswith("/api/health")
                    or path.startswith("/api/admin")
                    or path.startswith("/api/auth/login")):
                raise _err(503, "Maintenance in progress. Please retry later.")
    return await handler(request)


async def h_locale(request):
    accept = request.headers.get("Accept-Language", "")
    loc = "ru" if accept.lower().startswith("ru") else "en"
    return web.json_response({"locale": loc, "supported": ["en", "ru"]})


def start_demo_render(device) -> threading.Thread | None:
    """Render the landing page's A/B demo clips on ``device`` in a thread
    where ``edm_mastered.wav`` is missing from
    ``gen_demo_assets.DEMO_DIR`` (they are not committed blobs).  Returns
    the render's thread, or ``None`` where the clips are there."""
    from ..scripts import gen_demo_assets

    if (gen_demo_assets.DEMO_DIR / "edm_mastered.wav").is_file():
        return None

    def _gen():
        try:
            gen_demo_assets.render(device=device)
        except Exception:  # noqa: BLE001 — demos are cosmetic
            logging.getLogger("amw_tpu_torch.service").exception(
                "demo clip render failed")

    th = threading.Thread(target=_gen, daemon=True, name="demo-assets")
    th.start()
    return th


def create_app(engine: MasteringEngine | None = None) -> web.Application:
    db.create_tables()
    users.ensure_schema()
    jobs.restore_from_db()
    app = web.Application(client_max_size=900 * 1024 * 1024,
                          middlewares=[_gate_middleware])
    app["engine"] = engine or get_engine()
    app["job_tasks"] = set()
    app.on_cleanup.append(_cancel_jobs_on_cleanup)
    auth_routes.register_routes(app)
    ai_routes.register_routes(app)
    admin_routes.register_routes(app)
    payments.register_routes(app)
    misc_routes.register_routes(app)
    admin_routes.ensure_initial_admin()
    app.router.add_post("/bot/webhook", h_bot_webhook)
    app.router.add_post("/bot/notify/webhook", h_notify_bot_webhook)
    from . import bot as bot_mod

    # the user bot masters on this app's engine (runtime/bot.py)
    app["bot"] = (bot_mod.Bot(engine=app["engine"]) if bot_mod.bot_token()
                  else None)
    app["notify_bot"] = (bot_mod.NotifyBot()
                         if bot_mod.notify_bot_token() else None)

    async def _start_background(app):
        from .anomaly import anomaly_loop

        app["anomaly_task"] = asyncio.create_task(anomaly_loop())
        raw = settings.engine_warmup_buckets.strip()
        if raw:
            buckets = [float(s) for s in raw.split(",") if s.strip()]
            threading.Thread(
                target=app["engine"].warmup, args=(buckets,),
                daemon=True, name="engine-warmup").start()
        # Landing A/B demo clips are deterministic self-mastered renders
        # (amw_tpu_torch/scripts/gen_demo_assets.py), rendered on the
        # engine's device where the deploy lacks them.
        app["demo_render"] = start_demo_render(app["engine"].device)

    async def _stop_background(app):
        task = app.get("anomaly_task")
        if task:
            task.cancel()
            try:
                await task
            except (asyncio.CancelledError, Exception):  # noqa: BLE001
                pass

    app.on_startup.append(_start_background)
    app.on_cleanup.append(_stop_background)

    # Static frontend (reference: main.py:752 StaticFiles mount).
    import pathlib

    front = pathlib.Path(__file__).resolve().parent.parent.parent / "frontend"
    if front.is_dir():
        # Page cache: token-bearing pages are static per (path, base), so
        # read each file once and keep the rendered body per origin — no
        # blocking read_text() on the event loop for the hottest public
        # routes.  Bounded: pages are finite, bases are one configured URL
        # or a handful of request origins behind the proxy.
        _page_text: dict = {}
        _page_rendered: dict = {}

        def _page_response(request, path):
            """Serve an HTML page; pages carrying the ``{{BASE}}`` token
            (OG/Twitter meta need absolute URLs) get it rendered against
            the configured public URL or this request's origin — same
            policy as robots.txt/sitemap.xml below."""
            has_token = _page_text.get(path)
            if has_token is None:
                text = path.read_text()
                has_token = (text if "{{BASE}}" in text else False)
                _page_text[path] = has_token
            if has_token is False:
                return web.FileResponse(path)
            base = (settings.public_base_url.rstrip("/")
                    or str(request.url.origin()))
            body = _page_rendered.get((path, base))
            if body is None:
                if len(_page_rendered) > 512:  # origin-spray guard
                    _page_rendered.clear()
                body = has_token.replace("{{BASE}}", base)
                _page_rendered[(path, base)] = body
            return web.Response(text=body, content_type="text/html")

        async def h_index(request):
            return _page_response(request, front / "index.html")

        app.router.add_get("/", h_index)
        app.router.add_get("/app", h_index)
        app.router.add_static("/static", front)

        async def h_appjs(request):
            return web.FileResponse(front / "app.js")

        app.router.add_get("/app.js", h_appjs)

        async def h_sw(request):
            return web.FileResponse(front / "sw.js")

        async def h_manifest(request):
            return web.FileResponse(front / "manifest.json")

        app.router.add_get("/sw.js", h_sw)
        app.router.add_get("/manifest.json", h_manifest)

        # Every page in frontend/ is reachable at /<name> and /<name>.html
        # (reference: FastAPI mounts each page explicitly, main.py:700-752).
        def _page(name: str):
            async def h(request):
                return _page_response(request, front / f"{name}.html")
            return h

        for page_file in sorted(front.glob("*.html")):
            stem = page_file.stem
            if stem == "index":
                continue
            app.router.add_get(f"/{stem}", _page(stem))
            app.router.add_get(f"/{stem}.html", _page(stem))
        app.router.add_get("/tools/lufs-analyzer", _page("lufs-analyzer"))

        async def h_robots(request):
            # The Sitemap directive must be an absolute URL — render it
            # against this request's origin (or the configured public URL).
            base = (settings.public_base_url.rstrip("/")
                    or str(request.url.origin()))
            text = (front / "robots.txt").read_text().replace(
                "Sitemap: /sitemap.xml", f"Sitemap: {base}/sitemap.xml")
            return web.Response(text=text, content_type="text/plain")

        async def h_sitemap(request):
            # <loc> values must be fully qualified; the template keeps
            # relative paths so one file serves any deployment host.
            base = (settings.public_base_url.rstrip("/")
                    or str(request.url.origin()))
            xml = (front / "sitemap.xml").read_text().replace(
                "<loc>/", f"<loc>{base}/")
            return web.Response(text=xml, content_type="application/xml")

        async def h_favicon(request):
            return web.FileResponse(
                front / "icon.svg",
                headers={"Content-Type": "image/svg+xml"})

        app.router.add_get("/robots.txt", h_robots)
        app.router.add_get("/sitemap.xml", h_sitemap)
        app.router.add_get("/favicon.ico", h_favicon)

        async def h_clarity(request):
            # Microsoft Clarity loader, active only when a project id is
            # configured (reference: main.py /analytics/clarity.js).
            # Strictly validate the id — it is interpolated into served JS,
            # so a stray quote would be a stored-XSS vector via settings.
            import re as _re

            pid = settings.clarity_project_id.strip()
            if pid and not _re.fullmatch(r"[A-Za-z0-9_-]{1,64}", pid):
                pid = ""
            if not pid:
                return web.Response(text="/* analytics disabled */",
                                    content_type="application/javascript")
            js = (
                '(function(c,l,a,r,i,t,y){c[a]=c[a]||function(){'
                '(c[a].q=c[a].q||[]).push(arguments)};t=l.createElement(r);'
                't.async=1;t.src="https://www.clarity.ms/tag/"+i;'
                'y=l.getElementsByTagName(r)[0];y.parentNode.insertBefore('
                f't,y);}})(window,document,"clarity","script","{pid}");'
            )
            return web.Response(text=js,
                                content_type="application/javascript")

        app.router.add_get("/analytics/clarity.js", h_clarity)

        # PWA icons + Open Graph image (reference: main.py:709-731 serves
        # frontend/icons/*.png when present, else generated placeholders)
        # and the PROGRESS.md status page (main.py:687-706).
        _img_cache: dict = {}

        def _brand_png(w: int, h: int, label: str, scale: int) -> bytes:
            key = (w, h, label, scale)
            png = _img_cache.get(key)
            if png is None:
                import numpy as _np

                from ..utils.png import draw_text, encode_png

                img = _np.zeros((h, w, 3), _np.uint8)
                # vertical indigo->violet gradient, the site's accent ramp
                t = _np.linspace(0.0, 1.0, h)[:, None]
                img[..., 0] = (40 + 80 * t).astype(_np.uint8)
                img[..., 1] = (30 + 30 * t).astype(_np.uint8)
                img[..., 2] = (120 + 100 * t).astype(_np.uint8)
                tw = len(label) * 6 * scale
                draw_text(img, (w - tw) // 2, (h - 7 * scale) // 2, label,
                          (255, 255, 255), scale=scale)
                png = encode_png(img)
                _img_cache[key] = png
            return png

        def _icon_handler(size: int):
            async def h(request):
                p = front / "icons" / f"icon-{size}.png"
                if p.is_file():
                    return web.FileResponse(p)
                return web.Response(
                    body=_brand_png(size, size, "MM", max(2, size // 24)),
                    content_type="image/png",
                    headers={"Cache-Control": "public, max-age=86400"})
            return h

        async def h_og_image(request):
            p = front / "og-image.png"
            if p.is_file():
                return web.FileResponse(p)
            return web.Response(
                body=_brand_png(1200, 630, "MAGIC MASTER", 12),
                content_type="image/png",
                headers={"Cache-Control": "public, max-age=86400"})

        async def h_progress_page(request):
            import html as _html

            pp = pathlib.Path(__file__).resolve().parent.parent.parent \
                / "PROGRESS.md"
            body = (f"<pre>{_html.escape(pp.read_text())}</pre>"
                    if pp.is_file() else "<p>PROGRESS.md not found.</p>")
            page = ("<!DOCTYPE html><html lang='en'><head>"
                    "<meta charset='UTF-8'>"
                    "<meta name='viewport' content="
                    "'width=device-width,initial-scale=1'>"
                    "<title>Build status — Magic Master</title>"
                    "<style>body{background:#040408;color:#eee;"
                    "font-family:system-ui,sans-serif;padding:1.5rem;"
                    "max-width:900px;margin:0 auto;line-height:1.5}"
                    "pre{white-space:pre-wrap;word-break:break-word}</style>"
                    "</head><body><h1>Build status</h1>"
                    + body + "</body></html>")
            return web.Response(text=page, content_type="text/html")

        async def h_api_docs(request):
            # Rendered endpoint reference (docs/API.md is generated from the
            # live route table by scripts/gen_api_docs.py).
            dp = pathlib.Path(__file__).resolve().parent.parent.parent \
                / "docs" / "API.md"
            if not dp.is_file():
                raise web.HTTPNotFound(text="API.md not generated")
            try:
                import markdown as md

                body = md.markdown(dp.read_text(), extensions=["tables"])
            except Exception:  # noqa: BLE001 — plain text fallback
                import html as _html

                body = f"<pre>{_html.escape(dp.read_text())}</pre>"
            page = ("<!DOCTYPE html><html lang='en'><head>"
                    "<meta charset='UTF-8'>"
                    "<meta name='viewport' content="
                    "'width=device-width,initial-scale=1'>"
                    "<title>API reference — Magic Master</title>"
                    "<style>body{background:#040408;color:#eee;"
                    "font-family:system-ui,sans-serif;padding:1.5rem;"
                    "max-width:900px;margin:0 auto;line-height:1.5}"
                    "table{border-collapse:collapse}td,th{border:1px solid "
                    "#333;padding:4px 8px}code{color:#9fd}</style>"
                    "</head><body>" + body + "</body></html>")
            return web.Response(text=page, content_type="text/html")

        app.router.add_get("/icons/icon-192.png", _icon_handler(192))
        app.router.add_get("/icons/icon-512.png", _icon_handler(512))
        app.router.add_get("/og-image.png", h_og_image)
        app.router.add_get("/progress.html", h_progress_page)
        app.router.add_get("/api-docs", h_api_docs)
    async def h_api_root(request):
        out = {"service": "Magic Master TPU API", "version": __version__}
        if settings.debug:
            out["endpoints"] = sorted(
                {r.resource.canonical for r in app.router.routes()
                 if r.resource and r.resource.canonical.startswith("/api")})
        return web.json_response(out)

    app.router.add_get("/api", h_api_root)
    app.router.add_get("/api/health", h_health)
    app.router.add_get("/api/metrics", h_metrics)
    app.router.add_get("/api/version", h_version)
    app.router.add_get("/api/locale", h_locale)
    app.router.add_get("/api/presets", h_presets)
    app.router.add_get("/api/styles", h_styles)
    app.router.add_get("/api/v2/chain/default", h_chain_default)
    app.router.add_post("/api/master", h_master_v1)
    app.router.add_post("/api/v2/master", h_master_v2)
    app.router.add_post("/api/v2/batch", h_batch_v2)
    app.router.add_get("/api/master/status/{job_id}", h_status)
    app.router.add_get("/api/master/progress/{job_id}", h_progress_sse)
    app.router.add_get("/api/master/result/{job_id}", h_result)
    app.router.add_get("/api/master/preview/{job_id}", h_preview)
    app.router.add_get("/api/master/share/{job_id}", h_share)
    app.router.add_post("/api/v2/analyze", h_analyze)
    app.router.add_post("/api/v2/isolate-vocal", h_isolate_vocal)
    app.router.add_post("/api/v2/reference-match", h_reference_match)
    app.router.add_post("/api/v2/upscale", h_upscale)
    app.router.add_post("/api/v2/master/auto", h_master_auto)
    app.router.add_post("/api/tools/lufs-analyze", h_lufs_tool)
    app.router.add_post("/api/measure", h_measure)
    return app


def main(host: str = "0.0.0.0", port: int = 8000, *, device=None):
    """Serve on ``device`` (``cuda`` unless given; raises without a GPU)."""
    web.run_app(create_app(MasteringEngine(device=device)), host=host,
                port=port)


if __name__ == "__main__":
    main()
