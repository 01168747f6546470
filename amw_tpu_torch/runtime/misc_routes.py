"""Misc/referral/blog routes (reference: routers/misc.py, referral.py,
blog.py).

The port's copy of ``amw_tpu/runtime/misc_routes.py``.  ``/api/extensions``
names the port's backend, ``torch-`` and the engine's device type
(``torch-cuda`` as served), where the JAX package says ``jax-tpu``.  The
blog reads its posts with ``yaml`` and renders them with ``markdown``,
imported where they are used, as the JAX package does.
"""

from __future__ import annotations

import json
import pathlib

from aiohttp import web

from ..constants import DENOISE_PRESETS, PRESET_LUFS, REVERB_PRESETS
from . import db, deps, settings_store, users
from .config import settings


def _err(status, detail):
    cls = {400: web.HTTPBadRequest, 401: web.HTTPUnauthorized,
           404: web.HTTPNotFound}.get(status, web.HTTPBadRequest)
    return cls(text=json.dumps({"detail": detail}),
               content_type="application/json")


async def h_news_public(request):
    with db.connect() as c:
        rows = c.execute(
            "SELECT id, title, body, created_at FROM news_posts"
            " WHERE published=1 ORDER BY id DESC LIMIT 20").fetchall()
    return web.json_response({"items": [dict(r) for r in rows]})


async def h_debug_mode(request):
    return web.json_response({"debug": bool(settings.debug)})


async def h_limits(request):
    """Current tier and mastering limits (misc.py:69-126)."""
    user = deps.get_current_user_optional(request)
    if settings.debug:
        return web.json_response({
            "tier": "pro", "used": 0, "limit": -1, "remaining": 999,
            "tokens_balance": 999, "daily_used": 0, "daily_limit": 30,
            "reset_at": None, "debug": True, "priority_queue": True,
        })
    if user:
        tier = (user.get("tier") or "free").lower()
        u = users.get_user_by_id(int(user["sub"]))
        tokens = int(u.get("tokens") or 0) if u else 0
        daily_limit = {"free": 3, "pro": 30, "studio": -1}.get(tier, 3)
        return web.json_response({
            "tier": tier, "used": 0, "limit": -1 if tier != "free" else 1,
            "remaining": tokens if tier != "free" else 1,
            "tokens_balance": tokens,
            "daily_used": 0, "daily_limit": daily_limit, "reset_at": None,
            "priority_queue": tier in ("pro", "studio"),
        })
    ip = deps.client_ip(request)
    lim = deps.check_free_weekly_limit(ip)
    return web.json_response({
        "tier": "free", "used": lim["used"], "limit": lim["limit"],
        "remaining": max(0, lim["limit"] - lim["used"]),
        "tokens_balance": 0, "daily_used": lim["used"],
        "daily_limit": lim["limit"], "reset_at": None,
        "priority_queue": False,
    })


async def h_progress_md(request):
    p = pathlib.Path(__file__).resolve().parent.parent.parent / "PROGRESS.md"
    text = p.read_text() if p.is_file() else "# Progress\n(no file)"
    return web.Response(text=text, content_type="text/markdown")


async def h_presets_info(request):
    """Preset catalog: platform LUFS + denoise + reverb presets."""
    return web.json_response({
        "presets": PRESET_LUFS,
        "denoise_presets": {k: {"strength": v[0], "noise_percentile": v[1]}
                            for k, v in DENOISE_PRESETS.items()},
        "reverb_presets": sorted(REVERB_PRESETS),
    })


def _community_seed() -> tuple[list, bool, bool]:
    """(items, extra_configured, extra_loaded): the shipped starter presets
    (presets_community.json beside this module — reference: misc.py:151-197)
    merged with an optional admin-provided file or directory of JSON files
    (``community_presets_extra``).  Mirrors the reference's validation:
    only dict items carrying id + name + target_lufs, first id wins,
    relative extra paths resolve against the package dir."""
    items: list = []
    seen: set = set()

    def _append_valid(data) -> bool:
        added = False
        for it in (data if isinstance(data, list) else []):
            if not isinstance(it, dict):
                continue
            pid = it.get("id")
            if not pid or pid in seen:
                continue
            if "name" in it and "target_lufs" in it:
                seen.add(pid)
                items.append(it)
                added = True
        return added

    here = pathlib.Path(__file__).resolve().parent
    try:
        _append_valid(json.loads((here / "presets_community.json")
                                 .read_text()))
    except Exception:  # noqa: BLE001 — a broken seed must not 500 the API
        pass
    extra = (settings.community_presets_extra or "").strip()
    loaded = False
    if extra:
        p = pathlib.Path(extra)
        if not p.is_absolute():
            p = here / extra
        files = sorted(p.glob("*.json")) if p.is_dir() else \
            ([p] if p.is_file() else [])
        for f in files:
            try:
                loaded = _append_valid(json.loads(f.read_text())) or loaded
            except Exception:  # noqa: BLE001
                pass
    return items, bool(extra), loaded


async def h_presets_community(request):
    seed, extra_cfg, extra_loaded = _community_seed()
    items = users.list_community_presets()
    for it in items:
        try:
            it["config"] = json.loads(it.pop("config_json"))
        except Exception:  # noqa: BLE001
            it["config"] = None
    return web.json_response({
        "items": seed + items,
        "community_presets_extra_configured": extra_cfg,
        "community_presets_extra_loaded": extra_loaded,
    })


async def h_extensions(request):
    """Optional-extension availability (misc.py:209-230)."""
    from ..utils.audio_io import ffmpeg_available, lavc_available
    from .. import native

    return web.json_response({
        "ffmpeg": ffmpeg_available(),
        "native_lossy_codec": lavc_available(),
        "native_pcm": native.available(),
        # Same gate the /api/v2/master route enforces: the runtime
        # settings-store override, falling back to the env default.
        "vocal_isolation": settings_store.get_setting_bool(
            "vocal_isolation_enabled", settings.vocal_isolation_enabled),
        "ai_llm": settings_store.get_setting_str("ai_api_key", None) is not None,
        "telegram_bot_url": settings.user_bot_telegram_url or None,
        "backend": f"torch-{request.app['engine'].device.type}",
    })


# --- referral (reference: routers/referral.py) ----------------------------


async def h_referral_link(request):
    user = deps.get_current_user_optional(request)
    if not user:
        raise _err(401, "Not authorized")
    u = users.get_user_by_id(int(user["sub"]))
    if not u:
        raise _err(404, "User not found")
    code = u.get("referral_code") or ""
    base = str(request.url.origin())
    return web.json_response({
        "code": code,
        "link": f"{base}/register?ref={code}",
        "reward_inviter_tokens": settings.referral_reward_inviter_tokens,
        "reward_invitee_tokens": settings.referral_reward_invitee_tokens,
    })


async def h_referral_stats(request):
    user = deps.get_current_user_optional(request)
    if not user:
        raise _err(401, "Not authorized")
    uid = int(user["sub"])
    with db.connect() as c:
        total = c.execute("SELECT COUNT(*) n FROM referrals WHERE"
                          " inviter_id=?", (uid,)).fetchone()["n"]
        rewarded = c.execute("SELECT COUNT(*) n FROM referrals WHERE"
                             " inviter_id=? AND rewarded=1",
                             (uid,)).fetchone()["n"]
    return web.json_response({
        "invited_total": total, "rewarded": rewarded,
        "tokens_earned": rewarded * settings.referral_reward_inviter_tokens,
    })


def reward_inviter_on_first_mastering(user_id: int) -> None:
    """Referral hook: reward the inviter when the invitee completes the first
    mastering (database.py:514-554 semantics)."""
    with db.connect() as c:
        row = c.execute(
            "SELECT * FROM referrals WHERE invitee_id=? AND rewarded=0",
            (user_id,)).fetchone()
        if row is None:
            return
        c.execute("UPDATE referrals SET rewarded=1 WHERE id=?", (row["id"],))
    users.add_tokens(int(row["inviter_id"]),
                     settings.referral_reward_inviter_tokens)


# --- blog (reference: routers/blog.py:316-384 — markdown + YAML
# frontmatter rendered through the shared site shell) ------------------------
#
# Posts live in content/blog/*.md.  Each file is bilingual: YAML
# frontmatter carries title/description plus *_ru variants, and the body
# holds the English article followed by the Russian one after a
# ``<!-- lang:ru -->`` marker.  ``?lang=ru`` serves the Russian variant
# (same convention the static pages use via mm.js), and both variants
# cross-link through hreflang alternates.

BLOG_DIR = pathlib.Path(__file__).resolve().parent.parent.parent / "content" / "blog"
_RU_MARKER = "<!-- lang:ru -->"
_posts_cache: tuple | None = None  # (mtime_signature, posts)


def _load_posts() -> list[dict]:
    import yaml

    global _posts_cache
    if not BLOG_DIR.is_dir():
        return []
    files = sorted(BLOG_DIR.glob("*.md"))
    sig = tuple((p.name, p.stat().st_mtime_ns) for p in files)
    if _posts_cache and _posts_cache[0] == sig:
        return _posts_cache[1]
    posts = []
    for p in files:
        text = p.read_text(encoding="utf-8")
        meta = {}
        body = text
        if text.startswith("---"):
            parts = text.split("---", 2)
            if len(parts) >= 3:
                try:
                    meta = yaml.safe_load(parts[1]) or {}
                except yaml.YAMLError:
                    meta = {}
                body = parts[2]
        body_en, _, body_ru = body.partition(_RU_MARKER)
        posts.append({
            "slug": p.stem,
            "date": str(meta.get("date", "")),
            "author": str(meta.get("author", "Magic Master")),
            "tags": meta.get("tags") or [],
            "en": {"title": meta.get("title", p.stem),
                   "description": meta.get("description", ""),
                   "body_md": body_en.strip()},
            "ru": {"title": meta.get("title_ru", meta.get("title", p.stem)),
                   "description": meta.get("description_ru",
                                           meta.get("description", "")),
                   "body_md": (body_ru or body_en).strip()},
        })
    posts.sort(key=lambda x: x["date"], reverse=True)
    _posts_cache = (sig, posts)
    return posts


def _req_lang(request) -> str:
    return "ru" if request.query.get("lang") == "ru" else "en"


def _base_url(request) -> str:
    # Same policy as the static pages' {{BASE}} substitution
    # (service.py): configured public URL wins, else this request's origin.
    return (settings.public_base_url.rstrip("/")
            or str(request.url.origin()).rstrip("/"))


def _blog_shell(request, *, lang: str, title: str, description: str,
                path: str, body_html: str, extra_head: str = "") -> str:
    """Site chrome shared with the static pages: mm.css/mm.js header+footer,
    canonical + en/ru hreflang alternates, OG/Twitter meta."""
    import html as h

    base = _base_url(request)
    url = f"{base}{path}"
    t, d = h.escape(title), h.escape(description)
    return f"""<!doctype html>
<html lang="{lang}">
<head>
<meta charset="utf-8">
<meta name="viewport" content="width=device-width, initial-scale=1">
<meta name="description" content="{d}">
<link rel="stylesheet" href="/static/mm.css">
<link rel="icon" href="/static/icon.svg" type="image/svg+xml">
<title>{t} — Magic Master</title>
<meta property="og:type" content="article">
<meta property="og:url" content="{url}">
<meta property="og:title" content="{t}">
<meta property="og:description" content="{d}">
<meta property="og:site_name" content="Magic Master">
<meta property="og:image" content="{base}/og-image.png">
<meta name="twitter:card" content="summary_large_image">
<meta name="twitter:image" content="{base}/og-image.png">
<link rel="canonical" href="{url}">
<link rel="alternate" hreflang="en" href="{url}?lang=en">
<link rel="alternate" hreflang="ru" href="{url}?lang=ru">
<link rel="alternate" hreflang="x-default" href="{url}">
{extra_head}
<style>
.post-body img{{max-width:100%}}
.post-body table{{border-collapse:collapse;margin:14px 0}}
.post-body th,.post-body td{{border:1px solid var(--border,#2a2a3a);padding:6px 12px}}
.post-body h2{{margin-top:28px}}
.post-meta{{opacity:.65;font-size:.85rem;margin-bottom:18px}}
article.card{{max-width:860px;margin:0 auto}}
</style>
</head>
<body>
<div class="wrap">
<header class="mm"></header>
{body_html}
<footer class="mm"></footer>
</div>
<script src="/static/mm.js"></script>
<script>mmHeader();</script>
</body>
</html>"""


async def h_blog_index(request):
    import html as h

    lang = _req_lang(request)
    posts = _load_posts()
    qs = "?lang=ru" if lang == "ru" else ""
    items = "".join(
        f'<div class="card"><h3><a href="/blog/{h.escape(p["slug"])}{qs}">'
        f'{h.escape(p[lang]["title"])}</a></h3>'
        f'<div class="post-meta">{h.escape(p["date"])}</div>'
        f'<p class="muted">{h.escape(p[lang]["description"])}</p></div>'
        for p in posts)
    head = ("Блог Magic Master" if lang == "ru" else "Magic Master Blog")
    sub = ("Гайды по мастерингу, LUFS и AI-музыке."
           if lang == "ru" else
           "Guides on mastering, LUFS and AI music.")
    body = (f'<div class="hero" style="padding:24px 10px"><h1>{head}</h1>'
            f'<p class="muted">{sub}</p></div>{items}')
    return web.Response(
        text=_blog_shell(request, lang=lang, title=head, description=sub,
                         path="/blog", body_html=body),
        content_type="text/html")


async def h_blog_post(request):
    import html as h

    import markdown as md

    slug = request.match_info["slug"]
    lang = _req_lang(request)
    for p in _load_posts():
        if p["slug"] != slug:
            continue
        loc = p[lang]
        body_html = md.markdown(loc["body_md"], extensions=["tables"])
        base = _base_url(request)
        schema = {
            "@context": "https://schema.org",
            "@type": "Article",
            "headline": loc["title"],
            "description": loc["description"],
            "datePublished": p["date"],
            "inLanguage": lang,
            "author": {"@type": "Organization", "name": p["author"]},
            "mainEntityOfPage": {"@type": "WebPage",
                                 "@id": f"{base}/blog/{slug}"},
        }
        extra = ('<script type="application/ld+json">'
                 + json.dumps(schema, ensure_ascii=False) + "</script>")
        cta_title = ("Попробуйте Magic Master" if lang == "ru"
                     else "Try Magic Master")
        cta_sub = ("Загрузите трек — готовый мастер за секунды."
                   if lang == "ru" else
                   "Upload a track — a finished master in seconds.")
        cta_btn = ("Открыть студию →" if lang == "ru"
                   else "Open the studio →")
        back = ("← Все статьи" if lang == "ru" else "← All posts")
        qs = "?lang=ru" if lang == "ru" else ""
        body = f"""<article class="card">
<p><a href="/blog{qs}">{back}</a></p>
<h1>{h.escape(loc["title"])}</h1>
<div class="post-meta">{h.escape(p["date"])} · {h.escape(p["author"])}</div>
<div class="post-body">{body_html}</div>
<div class="card" style="text-align:center">
<h3>{cta_title}</h3>
<p class="muted">{cta_sub}</p>
<a class="btn" href="/app">{cta_btn}</a>
</div>
</article>"""
        return web.Response(
            text=_blog_shell(request, lang=lang, title=loc["title"],
                             description=loc["description"],
                             path=f"/blog/{slug}", body_html=body,
                             extra_head=extra),
            content_type="text/html")
    raise _err(404, "Post not found")


def register_routes(app: web.Application) -> None:
    r = app.router
    r.add_get("/api/news", h_news_public)
    r.add_get("/api/debug-mode", h_debug_mode)
    r.add_get("/api/limits", h_limits)
    r.add_get("/api/progress", h_progress_md)
    r.add_get("/api/presets/info", h_presets_info)
    r.add_get("/api/presets/community", h_presets_community)
    r.add_get("/api/extensions", h_extensions)
    r.add_get("/api/referral/my-link", h_referral_link)
    r.add_get("/api/referral/stats", h_referral_stats)
    r.add_get("/blog", h_blog_index)
    r.add_get("/blog/{slug}", h_blog_post)
