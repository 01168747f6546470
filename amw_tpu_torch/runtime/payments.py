"""Payments: plans, payment creation (demo mode), YooKassa-style webhook.

Reference: backend/app/payments.py.  Without provider credentials the
create endpoint runs in demo mode (instant succeeded transaction + tier
upgrade), exactly like the reference's no-keys path; the webhook validates
an optional IP whitelist and upgrades tier/tokens on ``payment.succeeded``.

The port's copy of ``amw_tpu/runtime/payments.py``.
"""

from __future__ import annotations

import hmac
import json
import time
import uuid

from aiohttp import web

from . import db, deps, notifier, settings_store, users

TIER_PRICES: dict[str, dict] = {
    "pro_month": {"tier": "pro", "label": "Pro — 1 month", "amount": "1000.00",
                  "currency": "RUB", "period_days": 30, "tokens_included": 50},
    "pro_year": {"tier": "pro", "label": "Pro — 1 year", "amount": "10000.00",
                 "currency": "RUB", "period_days": 365, "tokens_included": 600},
    "studio_month": {"tier": "studio", "label": "Studio — 1 month",
                     "amount": "2500.00", "currency": "RUB",
                     "period_days": 30, "tokens_included": 200},
    "studio_year": {"tier": "studio", "label": "Studio — 1 year",
                    "amount": "25000.00", "currency": "RUB",
                    "period_days": 365, "tokens_included": 2400},
    "tokens_10": {"tier": None, "label": "10 tokens", "amount": "1000.00",
                  "currency": "RUB", "period_days": 0, "tokens_included": 10},
}


def _err(status, detail):
    cls = {400: web.HTTPBadRequest, 401: web.HTTPUnauthorized,
           403: web.HTTPForbidden}.get(status, web.HTTPBadRequest)
    return cls(text=json.dumps({"detail": detail}),
               content_type="application/json")


def _plan_terms(plan_key: str | None, metadata: dict | None = None) -> dict:
    """Resolve tier/period/tokens for a payment.

    Known catalogue key wins; otherwise fall back to validated metadata
    fields (tier / tokens_included / period_days), mirroring the reference
    (backend/app/payments.py metadata fallback) so custom top-ups sent by
    the provider are credited rather than silently dropped."""
    plan = TIER_PRICES.get(plan_key or "")
    if plan:
        return {"tier": plan.get("tier"),
                "period_days": int(plan.get("period_days", 0)),
                "tokens_included": int(plan.get("tokens_included", 0))}
    md = metadata or {}
    tier = md.get("tier")
    if tier not in ("pro", "studio"):
        tier = None
    try:
        days = max(0, min(int(md.get("period_days", 0)), 3660))
    except (TypeError, ValueError):
        days = 0
    try:
        tokens = max(0, min(int(md.get("tokens_included", 0)), 100000))
    except (TypeError, ValueError):
        tokens = 0
    return {"tier": tier, "period_days": days, "tokens_included": tokens}


def _apply_plan(user_id: int, plan_key: str, payment_id: str,
                amount: float, currency: str, status: str = "succeeded",
                metadata: dict | None = None):
    terms = _plan_terms(plan_key, metadata)
    tier = terms["tier"]
    days = terms["period_days"]
    tokens = terms["tokens_included"]
    with db.connect() as c:
        # Idempotency: providers redeliver webhooks as normal operation.
        # A prior succeeded row for this payment means the plan was already
        # applied — never re-credit.  A pending row (created by h_create)
        # flips to the new status instead of inserting a duplicate.
        if payment_id:
            row = c.execute(
                "SELECT id, status FROM transactions WHERE provider_id = ?"
                " ORDER BY id DESC LIMIT 1", (payment_id,)).fetchone()
            if row is not None:
                if row["status"] == "succeeded":
                    return
                c.execute("UPDATE transactions SET status = ?, amount = ?,"
                          " currency = ? WHERE id = ?",
                          (status, amount, currency, row["id"]))
            else:
                row = None
        else:
            row = None
        if row is None:
            c.execute(
                "INSERT INTO transactions (user_id, amount, currency, status,"
                " provider, provider_id, plan, created_at)"
                " VALUES (?,?,?,?,?,?,?,?)",
                (user_id, amount, currency, status, "yookassa", payment_id,
                 plan_key, time.time()))
    if status != "succeeded":
        return
    if tier:
        u = users.get_user_by_id(user_id)
        base = max(time.time(), float(u.get("subscription_until") or 0))
        users.update_user(user_id, tier=tier,
                          subscription_until=base + days * 86400,
                          subscription_status="active")
    if tokens:
        users.add_tokens(user_id, tokens)
    try:
        u = users.get_user_by_id(user_id)
        notifier.notify_payment(u["email"] if u else str(user_id),
                                amount, plan_key)
    except Exception:  # noqa: BLE001
        pass


async def h_plans(request):
    return web.json_response({"plans": TIER_PRICES})


async def h_create(request):
    user = deps.get_current_user_optional(request)
    if not user:
        raise _err(401, "Authorization required for payment")
    try:
        body = await request.json()
    except Exception:  # noqa: BLE001
        body = {}
    plan_key = body.get("plan")
    plan = TIER_PRICES.get(plan_key or "")
    if not plan:
        raise _err(400, f"Unknown plan: {plan_key}. "
                        f"Available: {list(TIER_PRICES)}")
    shop_id = settings_store.get_setting_str("yookassa_shop_id", "") or ""
    if not shop_id.strip():
        # Demo mode: no provider configured — complete instantly.
        payment_id = f"demo-{uuid.uuid4()}"
        _apply_plan(int(user["sub"]), plan_key, payment_id,
                    float(plan["amount"]), plan["currency"])
        return web.json_response({
            "demo": True, "payment_id": payment_id, "status": "succeeded",
            "confirmation_url": body.get("return_url") or "/pricing",
        })
    # Real provider path requires the YooKassa API (no SDK in this image):
    # record a pending transaction; the webhook completes it.
    payment_id = f"pending-{uuid.uuid4()}"
    _apply_plan(int(user["sub"]), plan_key, payment_id,
                float(plan["amount"]), plan["currency"], status="pending")
    return web.json_response({
        "demo": False, "payment_id": payment_id, "status": "pending",
        "confirmation_url": body.get("return_url") or "/pricing",
    })


async def h_webhook(request):
    # Authenticate by content, not just source IP: if a webhook secret is
    # configured, the provider must echo it (query param or header set up in
    # the YooKassa callback URL).  Constant-time compare.
    secret = (settings_store.get_setting_str(
        "yookassa_webhook_secret", "") or "").strip()
    if secret:
        supplied = (request.query.get("secret")
                    or request.headers.get("X-Webhook-Secret") or "")
        if not hmac.compare_digest(supplied, secret):
            raise _err(403, "Forbidden")
    whitelist = (settings_store.get_setting_str(
        "yookassa_webhook_ip_whitelist", "") or "").strip()
    if whitelist:
        allowed = {ip.strip() for ip in whitelist.split(",") if ip.strip()}
        if deps.client_ip(request) not in allowed:
            raise _err(403, "Forbidden")
    try:
        body = await request.json()
    except Exception:  # noqa: BLE001
        raise _err(400, "Invalid JSON")
    event = body.get("event")
    obj = body.get("object", {}) or {}
    if event != "payment.succeeded":
        return web.json_response({"status": "ignored"})
    metadata = obj.get("metadata") or {}
    user_id = metadata.get("user_id")
    if not user_id:
        return web.json_response({"status": "ignored"})
    try:
        user_id = int(user_id)
    except (TypeError, ValueError):
        return web.json_response({"status": "ignored"})
    amount = obj.get("amount") or {}
    _apply_plan(user_id, metadata.get("plan"), obj.get("id") or "",
                float(amount.get("value", 0)),
                (amount.get("currency") or "RUB").strip(),
                metadata=metadata)
    return web.json_response({"status": "ok"})


def register_routes(app: web.Application) -> None:
    app.router.add_get("/api/payments/plans", h_plans)
    app.router.add_post("/api/payments/create", h_create)
    app.router.add_post("/api/payments/webhook", h_webhook)
