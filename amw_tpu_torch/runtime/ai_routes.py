"""AI endpoints (reference: backend/app/routers/ai_router.py:35-187).

The port's copy of ``amw_tpu/runtime/ai_routes.py``; the upload's analysis
runs on the serving engine's device.
"""

from __future__ import annotations

import asyncio
import json

from aiohttp import web

from ..models.analyze import analyze
from ..utils.audio_io import load_audio_from_bytes
from . import ai, deps, llm_guard


def _err(status, detail):
    cls = {400: web.HTTPBadRequest, 401: web.HTTPUnauthorized,
           429: web.HTTPTooManyRequests,
           503: web.HTTPServiceUnavailable}.get(status, web.HTTPBadRequest)
    return cls(text=json.dumps({"detail": detail}),
               content_type="application/json")


def _identity(request) -> tuple[str, str]:
    user = deps.get_current_user_optional(request)
    if user:
        return f"user:{user['sub']}", (user.get("tier") or "free").lower()
    return f"ip:{deps.client_ip(request)}", "free"


def _check_limit(request):
    deps.require_feature("feature_ai_enabled")
    ident, tier = _identity(request)
    lim = ai.check_ai_limit(ident, tier)
    if not lim["ok"]:
        raise _err(429, "Daily AI limit reached for your tier.")
    return ident, tier, lim


async def _analysis_from_upload(request, extended=True) -> dict:
    from .service import _read_upload, _validate_upload
    from . import settings_store

    fields, data, filename = await _read_upload(request)
    _validate_upload(data, filename, settings_store.get_max_upload_mb(filename))
    try:
        audio, sr = load_audio_from_bytes(data, filename)
    except Exception as e:  # noqa: BLE001
        raise _err(400, f"Could not read audio: {e}")
    return await asyncio.to_thread(analyze, audio, sr, extended,
                                   device=request.app["engine"].device)


async def h_limits(request):
    ident, tier = _identity(request)
    lim = ai.check_ai_limit(ident, tier)
    lim["tier"] = tier
    return web.json_response(lim)


async def h_recommend(request):
    ident, tier, _ = _check_limit(request)
    analysis = await _analysis_from_upload(request)
    rec = await asyncio.to_thread(ai.recommend_preset, analysis)
    ai.record_ai_usage(ident)
    rec["analysis"] = {k: analysis.get(k) for k in
                       ("lufs", "peak_dbfs", "duration_sec", "channels")}
    return web.json_response(rec)


async def h_report(request):
    ident, tier, _ = _check_limit(request)
    analysis = await _analysis_from_upload(request)
    rep = await asyncio.to_thread(ai.generate_report, analysis)
    ai.record_ai_usage(ident)
    return web.json_response(rep)


async def h_nl_config(request):
    ident, tier, _ = _check_limit(request)
    try:
        body = await request.json()
    except Exception:  # noqa: BLE001
        raise _err(400, "JSON body required")
    text = body.get("text") or ""
    ok, err, cleaned = llm_guard.validate_llm_input(text, "nl_config")
    if not ok:
        raise _err(400, err)
    out = await asyncio.to_thread(ai.nl_to_config, cleaned)
    ai.record_ai_usage(ident)
    return web.json_response(out)


async def h_chat(request):
    ident, tier, _ = _check_limit(request)
    try:
        body = await request.json()
    except Exception:  # noqa: BLE001
        raise _err(400, "JSON body required")
    messages = body.get("messages") or []
    if not isinstance(messages, list) or not messages:
        raise _err(400, "messages list required")
    cleaned = []
    for m in messages[-10:]:
        role = m.get("role", "user")
        ok, err, text = llm_guard.validate_chat_message(m.get("content", ""), role)
        if not ok:
            raise _err(400, err)
        cleaned.append({"role": role, "content": text})
    out = await asyncio.to_thread(ai.chat, cleaned)
    ai.record_ai_usage(ident)
    return web.json_response(out)


def register_routes(app: web.Application) -> None:
    app.router.add_get("/api/ai/limits", h_limits)
    app.router.add_post("/api/ai/recommend", h_recommend)
    app.router.add_post("/api/ai/report", h_report)
    app.router.add_post("/api/ai/nl-config", h_nl_config)
    app.router.add_post("/api/ai/chat", h_chat)
