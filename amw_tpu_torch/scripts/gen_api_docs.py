#!/usr/bin/env python
"""Generate the API reference from the port's live route table.

    python -m amw_tpu_torch.scripts.gen_api_docs [--out PATH]
        [--device cuda|cpu]

Builds the port's aiohttp app (``runtime/service.create_app``) on an
engine made for ``device`` (``cuda`` unless given; raises without a
GPU), walks every registered route, and emits a grouped endpoint
reference with the curated one-liners below or the handler docstrings'
first lines, so the document cannot drift from the code.  The curated
lines and the groups are those of the JAX package's
``scripts/gen_api_docs.py``; the document is written to stdout, or to
``--out``, never over ``docs/API.md`` (the JAX script's output).
"""

from __future__ import annotations

import argparse
import asyncio
import re
import sys

from amw_tpu_torch import resolve_device

SCRIPT = "amw_tpu_torch/scripts/gen_api_docs.py"

# Curated one-liners for handlers without docstrings (key = "METHOD path").
DESC = {
    "POST /api/master": "v1 fixed-pipeline mastering job (legacy path)",
    "POST /api/v2/master": "Config-driven v2 mastering job (chain config + PRO modules)",
    "POST /api/v2/master/auto": "Analyze, pick preset via AI, then run a v2 job",
    "POST /api/v2/batch": "Up to N files -> one v2 job each (returns job_ids)",
    "GET /api/master/status/{job_id}": "Job state, progress %, message, LUFS in/out",
    "GET /api/master/progress/{job_id}": "SSE stream of job progress events",
    "GET /api/master/result/{job_id}": "Download the mastered file (deletes the job)",
    "GET /api/master/preview/{job_id}": "Short A/B preview (src=original|mastered)",
    "GET /api/master/share/{job_id}": "PNG share card for the mastering result",
    "POST /api/v2/analyze": "LUFS/peak/spectrum/correlation (+extended streaming preview)",
    "POST /api/v2/reference-match": "Match the track's tonal balance to a reference upload",
    "POST /api/v2/upscale": "FFT resample to 48/96/192 kHz, 16-bit WAV out",
    "POST /api/v2/isolate-vocal": "htdemucs vocal stem (DSP fallback); WAV out",
    "POST /api/measure": "Bare LUFS/peak measurement of an upload",
    "POST /api/tools/lufs-analyze": "Free loudness tool: LUFS, 4x true peak, LRA, advice",
    "POST /api/auth/register": "Create account (optional referral code)",
    "POST /api/auth/login": "Password login -> JWT",
    "POST /api/auth/logout": "Invalidate the presented token",
    "GET /api/auth/me": "Token's user summary",
    "GET /api/auth/profile": "Full profile: tier, tokens, subscription, stats",
    "GET /api/auth/history": "Mastering history records",
    "GET /api/auth/history/export.csv": "History as CSV",
    "DELETE /api/auth/history/{record_id}": "Delete one history record",
    "GET /api/auth/api-keys": "List API keys (prefixes only)",
    "POST /api/auth/api-keys": "Create an API key (shown once)",
    "DELETE /api/auth/api-keys/{key_id}": "Revoke an API key",
    "GET /api/auth/presets": "Saved chain presets",
    "POST /api/auth/presets": "Save a chain preset",
    "GET /api/auth/presets/{preset_id}": "Fetch one preset (with config)",
    "DELETE /api/auth/presets/{preset_id}": "Delete a preset",
    "POST /api/auth/change-password": "Change password (old + new)",
    "POST /api/auth/forgot-password": "Email a reset link",
    "POST /api/auth/reset-password": "Set a new password from a reset token",
    "GET /api/auth/verify-email": "Confirm email from the mailed token",
    "POST /api/auth/resend-verification": "Resend the confirmation email",
    "POST /api/auth/record": "Record a client-side mastering into history",
    "POST /api/auth/telegram-link-code": "One-time code to link the Telegram bot",
    "GET /api/ai/limits": "Remaining AI calls for the caller's tier",
    "POST /api/ai/recommend": "Upload -> analysis -> preset/style recommendation",
    "POST /api/ai/report": "Upload -> human-readable mastering report",
    "POST /api/ai/nl-config": "Natural language -> chain config",
    "POST /api/ai/chat": "Mastering-assistant chat (messages list)",
    "GET /api/payments/plans": "Subscription plans and prices",
    "POST /api/payments/create": "Create a payment (demo-completes without provider)",
    "POST /api/payments/webhook": "Provider webhook (content-authenticated, idempotent)",
    "GET /api/referral/my-link": "Caller's referral link and code",
    "GET /api/referral/stats": "Invited/rewarded counts",
    "GET /api/health": "Liveness + dependency checks",
    "GET /api/metrics": "Operational counters",
    "GET /api/version": "Version and build info",
    "GET /api": "Service info (endpoint list in debug)",
    "GET /api/locale": "Locale negotiation",
    "GET /api/limits": "Caller's tier limits and remaining quota",
    "GET /api/presets": "Target-loudness presets",
    "GET /api/presets/community": "Community chain presets",
    "GET /api/presets/info": "Preset metadata",
    "GET /api/styles": "Style configs (EQ/dynamics per genre)",
    "GET /api/v2/chain/default": "Default v2 chain config",
    "GET /api/news": "Published news posts",
    "GET /api/debug-mode": "Debug flag",
    "GET /api/extensions": "Optional-capability availability",
    "GET /api/progress": "Project progress notes (markdown)",
    "POST /bot/webhook": "Telegram bot updates",
}

GROUPS = [
    ("Mastering", r"^/api/(master|v2/master|v2/batch|v2/analyze|"
                  r"v2/reference-match|v2/upscale|v2/isolate-vocal|measure)"),
    ("Tools", r"^/api/tools"),
    ("Auth & account", r"^/api/auth"),
    ("AI assistant", r"^/api/ai"),
    ("Payments", r"^/api/payments"),
    ("Referral", r"^/api/referral"),
    ("Admin", r"^/api/admin"),
    ("Service & misc", r"^/api"),
    ("Bot webhooks", r"^/bot"),
    ("Pages & assets", r"^/"),
]


def route_rows(app) -> list:
    """Sorted unique ``(path, method, description)`` rows of ``app``'s
    routes (HEAD, OPTIONS and catch-all methods left out)."""
    rows = []
    for route in app.router.routes():
        if route.resource is None:
            continue
        path = route.resource.canonical
        method = route.method
        if method in ("HEAD", "OPTIONS", "*"):
            continue
        doc = DESC.get(f"{method} {path}") \
            or (route.handler.__doc__ or "").strip().split("\n")[0]
        rows.append((path, method, doc))
    return sorted(set(rows))


def render(rows) -> str:
    """The grouped Markdown document of ``rows``."""
    out = ["# API reference",
           "",
           f"Generated from the route table by `{SCRIPT}` — "
           "do not edit by hand.",
           "",
           "Authentication: `Authorization: Bearer <JWT>` (from "
           "`/api/auth/login`) or `X-API-Key: <key>` (from "
           "`/api/auth/api-keys`).  Admin endpoints additionally require "
           "`is_admin`.",
           ""]
    used = set()
    for title, pat in GROUPS:
        rx = re.compile(pat)
        group = [r for r in rows if rx.search(r[0]) and r not in used]
        if not group:
            continue
        used.update(group)
        out.append(f"## {title}")
        out.append("")
        out.append("| Method | Path | Description |")
        out.append("|---|---|---|")
        for path, method, doc in group:
            cell = doc.replace("|", "\\|")
            out.append(f"| {method} | `{path}` | {cell} |")
        out.append("")
    return "\n".join(out) + "\n"


def app_rows(device) -> list:
    """The route rows of the port's app on an engine on ``device``."""
    from amw_tpu_torch.runtime.engine import MasteringEngine
    from amw_tpu_torch.runtime.service import create_app

    eng = MasteringEngine(device=resolve_device(device))
    try:
        async def mk():
            return create_app(eng)

        loop = asyncio.new_event_loop()
        try:
            return route_rows(loop.run_until_complete(mk()))
        finally:
            loop.close()
    finally:
        eng.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None,
                    help="write the document here (default: stdout)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    rows = app_rows(args.device)
    text = render(rows)
    if args.out is None:
        sys.stdout.write(text)
        return 0
    with open(args.out, "w", encoding="utf-8") as f:
        f.write(text)
    print(f"wrote {args.out} ({len(rows)} endpoints)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
