"""Settings of the serving engine and the HTTP service (the port's copy
of ``amw_tpu/runtime/config.py``).

The same field names and defaults as the JAX package's, read from the
environment with the reference's ``MAGIC_MASTER_`` prefix or the ``AMW_``
alias, so that a deployment's environment means the same to both
packages.  ``settings_store`` layers the database's overrides over these
defaults.

Left out, and ignored where a deployment's environment sets them:

- ``compilation_cache_dir``: the directory of XLA's persistent
  compilation cache, which the port has no counterpart of;
- fields that no code of either package reads: ``ai_limit_free``,
  ``ai_limit_pro`` and ``ai_limit_studio`` (the AI routes' daily limits
  are ``ai.TIER_DAILY_LIMITS``), ``ai_prompt_report``,
  ``ai_prompt_nl_config`` and ``ai_prompt_chat`` (only the recommender's
  prompt has an override), ``cors_origins`` (the service sets no CORS
  headers), ``yookassa_secret_key`` and ``yookassa_return_url`` (payment
  creation calls no payment API; the return URL comes with the request),
  ``user_bot_token`` and ``user_bot_webhook_secret`` (the user bot's token
  is ``MAGIC_MASTER_``/``AMW_TELEGRAM_BOT_TOKEN``, see ``bot.bot_token``),
  ``alert_monitoring_enabled`` and ``alert_throttle_minutes``,
  ``demucs_model`` (the separator reads ``htdemucs_checkpoint``), and
  ``max_upload_mb``, ``allowed_extensions`` and ``temp_dir`` (uploads are
  held to the per-format and per-tier limits above).

``engine_coordinator``, ``engine_num_processes`` and ``engine_process_id``
are kept, with one deliberate difference: the JAX engine swallows a failed
join (its ``except Exception`` around the mesh setup) and serves alone
while its peers wait in the rendezvous; the port's engine raises, since a
rank that serves alone is a fault that a fallback would hide.

Also left out, but not ignored: ``mastering_trace`` and
``mastering_trace_lufs_stages``, which ``utils/trace.py`` reads from the
environment itself, and ``admin_email`` and ``admin_password``, which
``admin_routes.ensure_initial_admin`` reads so, both as in the JAX package.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, fields


def _env(name: str, default):
    for prefix in ("MAGIC_MASTER_", "AMW_"):
        v = os.environ.get(prefix + name.upper())
        if v is None:
            continue
        if isinstance(default, bool):
            return v.strip().lower() in ("1", "true", "yes", "on", "y")
        if isinstance(default, int):
            try:
                return int(v)
            except ValueError:
                return default
        if isinstance(default, float):
            try:
                return float(v)
            except ValueError:
                return default
        return v
    return default


@dataclass
class Settings:
    # Upload limits (MB) per format and tier.
    max_upload_mb_wav: int = 800
    max_upload_mb_mp3: int = 300
    max_upload_mb_flac: int = 500
    tier_upload_mb_free: int = 100
    tier_upload_mb_pro: int = 300
    tier_upload_mb_studio: int = 800

    # Admission control: the job semaphores' slots.
    semaphore_priority: int = 2
    semaphore_normal: int = 1

    # Jobs store.
    jobs_done_ttl_seconds: int = 3600
    jobs_max_entries: int = 100

    # Debug flags.
    debug: bool = False
    mastering_debug_skip_limits: bool = False

    # Defaults.
    default_target_lufs: float = -14.0
    batch_max_files: int = 10

    # Feature flags.
    feature_ai_enabled: bool = True
    feature_batch_enabled: bool = True
    registration_enabled: bool = True
    require_email_verify: bool = False
    maintenance_mode: bool = False
    vocal_isolation_enabled: bool = False

    # Auth and rate limits.
    jwt_secret: str = "change-me-in-production"
    jwt_expire_minutes: int = 60 * 24 * 7
    free_weekly_limit: int = 1
    auth_rate_per_minute: int = 10
    lufs_tool_rate_per_hour: int = 20
    rate_limit_per_minute: int = 300
    # Comma-separated reverse-proxy IPs allowed to set X-Real-IP /
    # X-Forwarded-For; empty = trust loopback + RFC1918 only.
    trusted_proxies: str = ""

    engine_exact_mode: bool = True
    # Coalesce concurrent same-graph jobs into one batch (see
    # runtime/batcher.py).  Single jobs pay only the batch window (50 ms)
    # over solo latency.
    engine_micro_batch: bool = True
    engine_batch_window_ms: float = 50.0
    engine_max_micro_batch: int = 8
    # Serve across every local GPU: micro-batches split data-parallel over
    # a mesh of the devices, and tracks longer than the sp threshold are
    # time-sharded over the same devices (parallel/timeshard.py).  With one
    # GPU both are off: single-card behaviour is unchanged.
    engine_mesh: bool = True
    engine_sp_threshold_sec: float = 600.0
    # Highest bucket of the length ladder the engine pads up to
    # (parallel/batch.DEFAULT_BUCKETS_SEC); longer uploads run at exact
    # length.
    engine_max_bucket_sec: float = 2520.0
    # Time-shard (sp) graphs are built per exact track length; snapping
    # long uploads up to this grid (zero-padded, output sliced back) lets
    # distinct lengths share one graph.  The padding is mastered as
    # trailing silence, gated out of BS.1770, and sliced off before export.
    # 0 = off (every length exact).
    engine_sp_quantize_sec: float = 30.0
    # A pod of processes (parallel/mesh.py, docs/SCALING.md): when set,
    # the engine joins a torch.distributed group at start
    # (mesh.init_distributed) and raises where the join fails; its serving
    # mesh stays over the process's own GPUs.  "auto" = the launcher's
    # environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK); "" = one
    # process (default).  Otherwise "host:port" of process 0, with
    # engine_num_processes (0: from the environment) and engine_process_id
    # (-1: from the environment).
    engine_coordinator: str = ""
    engine_num_processes: int = 0
    engine_process_id: int = -1
    # Build and run the default chain's graph for these buckets at service
    # start (comma separated seconds; "" = off).
    engine_warmup_buckets: str = ""
    db_path: str = "amw_tpu.sqlite3"

    # Referral rewards.
    referral_reward_inviter_tokens: int = 3
    referral_reward_invitee_tokens: int = 2

    # AI agents: the LLM backend and keys (none: the rule engine answers),
    # the recommender's prompt override.
    ai_backend: str = "openai"
    openai_api_key: str = ""
    anthropic_api_key: str = ""
    deepseek_api_key: str = ""
    deepseek_base_url: str = "https://api.deepseek.com"
    deepseek_model: str = "deepseek-chat"
    ai_prompt_recommend: str = ""

    # SMTP transactional mail (runtime/mailer.py).
    smtp_host: str = ""
    smtp_port: int = 587
    smtp_user: str = ""
    smtp_password: str = ""
    smtp_from: str = "noreply@localhost"
    smtp_use_tls: bool = True

    # YooKassa payments (runtime/payments.py).
    yookassa_shop_id: str = ""
    yookassa_webhook_ip_whitelist: str = ""
    yookassa_webhook_secret: str = ""

    # Telegram: the admin notifier's bot and chat, the webhook secret; the
    # user bot's settings (runtime/bot.py).
    telegram_bot_token: str = ""
    telegram_admin_chat_id: str = ""
    telegram_bot_webhook_secret: str = ""
    user_bot_channel_id: str = ""
    user_bot_telegram_url: str = ""
    public_base_url: str = ""

    # Extensions / analytics.
    clarity_project_id: str = ""
    community_presets_extra: str = ""

    # Monitoring alerts and anomaly thresholds.
    alert_queue_threshold: int = 0
    anomaly_check_interval: int = 60
    anomaly_cpu_threshold: float = 85.0
    anomaly_ram_threshold: float = 85.0
    anomaly_disk_threshold: float = 85.0
    anomaly_error_rate_threshold: float = 35.0
    anomaly_rss_max_mb: int = 8192
    anomaly_min_jobs_for_error_rate: int = 8

    # Vocal isolation: the htdemucs checkpoint the neural separator loads
    # ("" = the DSP separator; "bundled" = the port's converted tiny
    # checkpoint; else a path to a checkpoint file of models/htdemucs.py's
    # format).
    htdemucs_checkpoint: str = ""

    def __post_init__(self):
        for f in fields(self):
            object.__setattr__(self, f.name, _env(f.name, getattr(self, f.name)))


settings = Settings()


def reload_settings():
    """Re-read :class:`Settings` from the environment into ``settings``.
    Modules that imported ``settings`` by name keep the object they
    imported, as in the JAX package."""
    global settings
    settings = Settings()
    return settings
