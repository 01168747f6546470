"""AI agents: preset recommender, report, NL→chain-config, chat.

Reference: backend/app/ai.py.  The LLM (OpenAI/DeepSeek-compatible chat API)
is optional — admin-stored keys enable it; without a key every agent falls
back to its deterministic rule engine exactly like the reference
(ai.py:223-264).  The OpenAI SDK is not in this image, so the LLM client is
a plain aiohttp-less ``urllib`` JSON call (synchronous; callers run it in a
thread).  Per-tier daily limits: free 5 / pro 50 / studio unlimited.

The port's copy of ``amw_tpu/runtime/ai.py`` with both wires of the LLM
client: the OpenAI wire (an admin-stored key, the ``openai`` and
``deepseek`` backends) and the ``anthropic`` backend's Messages API, with
the same URLs, headers, bodies and reply parsing.
"""

from __future__ import annotations

import datetime
import json
import urllib.request

from ..constants import STYLE_CONFIGS
from ..models.chain import default_chain_config
from . import settings_store

_ai_usage: dict[str, dict] = {}

TIER_DAILY_LIMITS = {"free": 5, "pro": 50, "studio": -1}


def check_ai_limit(identifier: str, tier: str) -> dict:
    limit = TIER_DAILY_LIMITS.get(tier, 5)
    today = datetime.date.today().isoformat()
    entry = _ai_usage.get(identifier)
    used = entry["count"] if entry and entry.get("day") == today else 0
    if limit < 0:
        return {"ok": True, "used": used, "limit": -1, "remaining": -1,
                "reset_at": today}
    tomorrow = (datetime.date.today() + datetime.timedelta(days=1)).isoformat()
    return {"ok": used < limit, "used": used, "limit": limit,
            "remaining": max(0, limit - used), "reset_at": tomorrow}


def record_ai_usage(identifier: str) -> None:
    today = datetime.date.today().isoformat()
    entry = _ai_usage.get(identifier)
    if not entry or entry.get("day") != today:
        _ai_usage[identifier] = {"count": 1, "day": today}
    else:
        entry["count"] += 1


def reset_ai_usage() -> None:
    _ai_usage.clear()


# --- LLM client (optional) -------------------------------------------------


def _llm_config():
    """Admin-stored key first (settings store), then env settings per the
    reference's backend selection (config.py:47-56: openai | deepseek |
    anthropic).  openai/deepseek share the OpenAI wire protocol
    (``wire='openai'``); anthropic uses the Messages API (``wire='anthropic'``)."""
    from .config import settings

    key = settings_store.get_setting_str("ai_api_key", None)
    if key:
        return {
            "wire": "openai",
            "key": key,
            "base": settings_store.get_setting_str(
                "ai_api_base",
                "https://api.openai.com/v1") or "https://api.openai.com/v1",
            "model": settings_store.get_setting_str("ai_model", "gpt-4o-mini")
            or "gpt-4o-mini",
        }
    backend = (settings.ai_backend or "openai").lower()
    if backend == "deepseek" and settings.deepseek_api_key:
        return {"wire": "openai",
                "key": settings.deepseek_api_key,
                "base": settings.deepseek_base_url.rstrip("/") + "/v1"
                if not settings.deepseek_base_url.endswith("/v1")
                else settings.deepseek_base_url,
                "model": settings.deepseek_model}
    if backend == "anthropic" and settings.anthropic_api_key:
        return {"wire": "anthropic",
                "key": settings.anthropic_api_key,
                "base": "https://api.anthropic.com/v1",
                "model": settings_store.get_setting_str(
                    "ai_model", "claude-3-5-haiku-latest")
                or "claude-3-5-haiku-latest"}
    if settings.openai_api_key:
        return {"wire": "openai",
                "key": settings.openai_api_key,
                "base": "https://api.openai.com/v1",
                "model": settings_store.get_setting_str(
                    "ai_model", "gpt-4o-mini") or "gpt-4o-mini"}
    return None


def _llm_request(conf: dict, messages: list[dict], max_tokens: int,
                 json_mode: bool) -> urllib.request.Request:
    if conf.get("wire") == "anthropic":
        # Anthropic Messages API: system prompt is a top-level field, JSON
        # mode is requested via instruction (no response_format parameter).
        system = "\n".join(m["content"] for m in messages
                           if m.get("role") == "system")
        turns = [m for m in messages if m.get("role") != "system"]
        if json_mode:
            system = (system + "\nRespond with a single JSON object and "
                      "nothing else.").strip()
        body = {"model": conf["model"], "max_tokens": max_tokens,
                "messages": turns}
        if system:
            body["system"] = system
        return urllib.request.Request(
            conf["base"].rstrip("/") + "/messages",
            data=json.dumps(body).encode(),
            headers={"x-api-key": conf["key"],
                     "anthropic-version": "2023-06-01",
                     "Content-Type": "application/json"},
        )
    body = {"model": conf["model"], "messages": messages,
            "max_tokens": max_tokens}
    if json_mode:
        body["response_format"] = {"type": "json_object"}
    return urllib.request.Request(
        conf["base"].rstrip("/") + "/chat/completions",
        data=json.dumps(body).encode(),
        headers={"Authorization": f"Bearer {conf['key']}",
                 "Content-Type": "application/json"},
    )


def llm_chat(messages: list[dict], max_tokens: int = 300,
             json_mode: bool = False) -> str | None:
    conf = _llm_config()
    if conf is None:
        return None
    req = _llm_request(conf, messages, max_tokens, json_mode)
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            data = json.loads(resp.read())
        if conf.get("wire") == "anthropic":
            parts = [b.get("text", "") for b in data.get("content", [])
                     if b.get("type") == "text"]
            return "".join(parts).strip()
        return (data["choices"][0]["message"]["content"] or "").strip()
    except Exception:  # noqa: BLE001
        return None


def _parse_json_loose(text: str) -> dict | None:
    try:
        return json.loads(text)
    except (json.JSONDecodeError, TypeError):
        if text and "{" in text and "}" in text:
            i, j = text.find("{"), text.rfind("}") + 1
            try:
                return json.loads(text[i:j])
            except json.JSONDecodeError:
                return None
    return None


# --- recommender -----------------------------------------------------------


def rule_based_recommend(analysis: dict) -> dict:
    """Deterministic preset recommendation (ai.py:223-264 semantics)."""
    lufs = analysis.get("lufs")
    duration_sec = analysis.get("duration_sec") or 0
    channels = analysis.get("channels", 1)
    spectrum = analysis.get("spectrum_bars")
    low_freq_energy = 0.0
    if isinstance(spectrum, (list, tuple)) and len(spectrum) >= 4:
        q = max(1, len(spectrum) // 4)
        low_freq_energy = sum(spectrum[:q]) / q

    style, target, reason = "standard", -14.0, \
        "Standard streaming preset (-14 LUFS)."
    if lufs is not None:
        if lufs < -20.0 and low_freq_energy > 0.3:
            style, target = "edm", -9.0
            reason = "Quiet track with strong lows — EDM preset (-9 LUFS)."
        elif lufs < -20.0:
            reason = "Quiet track — streaming target -14 LUFS."
        elif duration_sec > 600 and channels == 1:
            style, target = "podcast", -16.0
            reason = "Long mono track — podcast preset (-16 LUFS)."
        elif duration_sec < 120:
            reason = "Short track — streaming -14 LUFS."
    return {"style": style, "target_lufs": target, "chain_config": None,
            "reason": reason, "source": "rules"}


def recommend_preset(analysis: dict) -> dict:
    payload = {k: analysis.get(k) for k in
               ("lufs", "peak_dbfs", "duration_sec", "sample_rate",
                "channels", "stereo_correlation")}
    bars = analysis.get("spectrum_bars")
    if isinstance(bars, (list, tuple)) and len(bars) >= 8:
        q = len(bars) // 4
        payload["spectrum_low"] = sum(bars[:q]) / q
        payload["spectrum_mid"] = sum(bars[q:3 * q]) / max(1, 2 * q)
        payload["spectrum_high"] = sum(bars[3 * q:]) / max(1, len(bars) - 3 * q)
    text = llm_chat(
        [{"role": "system", "content": settings_store.get_setting_str(
            "ai_prompt_recommend",
            "You are a mastering engineer. Given track analysis JSON, return"
            " JSON with keys style (one of %s), target_lufs (float), reason."
            % ", ".join(STYLE_CONFIGS))},
         {"role": "user", "content": json.dumps(payload)}],
        json_mode=True)
    if text:
        data = _parse_json_loose(text)
        if data and data.get("style") in STYLE_CONFIGS:
            try:
                target = float(data.get("target_lufs", -14.0))
            except (TypeError, ValueError):
                target = -14.0
            return {"style": data["style"],
                    "target_lufs": max(-36.0, min(-6.0, target)),
                    "chain_config": None,
                    "reason": str(data.get("reason", ""))[:500],
                    "source": "llm"}
    return rule_based_recommend(analysis)


# --- report ----------------------------------------------------------------


def generate_report(analysis: dict) -> dict:
    lufs = analysis.get("lufs")
    tp = analysis.get("peak_dbfs")
    corr = analysis.get("stereo_correlation")
    lines = []
    if lufs is not None:
        if lufs > -9:
            lines.append(f"Integrated loudness {lufs:.1f} LUFS is very hot; "
                         "platforms will turn it down.")
        elif lufs < -18:
            lines.append(f"Integrated loudness {lufs:.1f} LUFS is quiet for "
                         "streaming; consider -14 LUFS.")
        else:
            lines.append(f"Integrated loudness {lufs:.1f} LUFS sits in a "
                         "healthy streaming range.")
    if tp is not None and tp > -1.0:
        lines.append(f"Peak level {tp:.1f} dBFS leaves little headroom; "
                     "target -1 dBTP or lower.")
    if corr is not None:
        if corr < 0.2:
            lines.append("Low L/R correlation — check mono compatibility.")
        elif corr > 0.98:
            lines.append("Nearly mono image — consider widening if intended "
                         "to be stereo.")
    if not lines:
        lines.append("No obvious issues detected by the rule engine.")
    text = llm_chat(
        [{"role": "system", "content": "Summarize this audio analysis for a"
          " musician in 3 short sentences."},
         {"role": "user", "content": json.dumps(analysis)[:4000]}],
        max_tokens=200)
    return {"report": text or " ".join(lines),
            "source": "llm" if text else "rules"}


# --- NL -> chain config ----------------------------------------------------

_NL_RULES = [
    (("bass", "низ", "бас"), {"module": "style", "field": "sub", "dir": +1}),
    (("bright", "air", "ярч", "воздух"), {"module": "style", "field": "air", "dir": +1}),
    (("warm", "тепл"), {"module": "style", "field": "bass", "dir": +1}),
    (("loud", "громч", "club", "клуб"), {"target": -9.0}),
    (("quiet", "тих", "soft"), {"target": -16.0}),
    (("wide", "шире", "stereo"), {"imager": 1.25}),
    (("narrow", "mono", "моно", "уже"), {"imager": 0.9}),
    (("punch", "удар"), {"transient": 1.3}),
    (("reverb", "реверб", "hall", "space"), {"reverb": True}),
    (("vocal", "вокал", "voice"), {"style_name": "dry_vocal"}),
    (("podcast", "подкаст", "speech"), {"style_name": "podcast"}),
    (("edm", "dance", "электро"), {"style_name": "edm"}),
    (("lofi", "lo-fi", "лоу-фай"), {"style_name": "lofi"}),
]


def nl_to_config(text: str) -> dict:
    """Natural language -> chain config.  LLM when configured, else keyword
    rules mapped onto the default config."""
    llm = llm_chat(
        [{"role": "system", "content":
          "Convert the user's mastering request to JSON: {style, target_lufs,"
          " modules: optional overrides}. Styles: " + ", ".join(STYLE_CONFIGS)},
         {"role": "user", "content": text[:1000]}],
        json_mode=True)
    if llm:
        data = _parse_json_loose(llm)
        if data and data.get("style") in STYLE_CONFIGS:
            target = float(data.get("target_lufs", -14.0))
            cfg = default_chain_config(target, data["style"])
            return {"style": data["style"], "target_lufs": target,
                    "chain_config": cfg, "source": "llm"}

    low = (text or "").lower()
    style = "standard"
    target = -14.0
    imager = None
    reverb = False
    notes = []
    for keys, action in _NL_RULES:
        if any(k in low for k in keys):
            if "style_name" in action:
                style = action["style_name"]
                notes.append(f"style={style}")
            if "target" in action:
                target = action["target"]
                notes.append(f"target={target}")
            if "imager" in action:
                imager = action["imager"]
                notes.append(f"width={imager}")
            if action.get("reverb"):
                reverb = True
                notes.append("reverb=on")
    cfg = default_chain_config(target, style)
    for m in cfg["modules"]:
        if imager is not None and m["id"] == "imager":
            m["enabled"] = True
            m["width"] = imager
        if reverb and m["id"] == "reverb":
            m["enabled"] = True
            m["mix"] = 0.15
    return {"style": style, "target_lufs": target, "chain_config": cfg,
            "reason": "; ".join(notes) or "default streaming chain",
            "source": "rules"}


# --- chat ------------------------------------------------------------------

_CANNED = (
    "I can recommend a preset (upload a track and ask for a recommendation), "
    "explain any module of the mastering chain, or convert a plain-language "
    "request into chain settings. The LLM backend is not configured on this "
    "server, so answers use the built-in rule engine."
)


def chat(messages: list[dict]) -> dict:
    # Ground the assistant in the generated product knowledge base
    # (reference: ai.py:486-491 injects bot/knowledge_base.py into the
    # system prompt as the sole source of truth).
    from .knowledge import product_knowledge

    last = next((m.get("content", "") for m in reversed(messages)
                 if m.get("role") == "user"), "")
    lang = "ru" if any("Ѐ" <= ch <= "ӿ" for ch in last) else "en"
    system = ("You are the product's audio mastering assistant. Use the "
              "PRODUCT_KNOWLEDGE section below as your sole source of truth "
              "about features, styles, presets and limits; answer in the "
              "user's language.\n\n## PRODUCT_KNOWLEDGE\n"
              + product_knowledge(lang))
    text = llm_chat([{"role": "system", "content": system}]
                    + messages[-10:], max_tokens=400)
    return {"reply": text or _CANNED, "source": "llm" if text else "rules"}
