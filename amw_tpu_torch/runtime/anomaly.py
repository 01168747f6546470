"""Anomaly monitor background loop (reference: bot/anomaly_monitor.py:38-129).

Every ``interval`` seconds checks CPU load, available RAM, disk space,
process RSS, the last-hour job error rate, and queue length against
thresholds, and sends throttled Telegram admin alerts.

The port's copy of ``amw_tpu/runtime/anomaly.py``.
"""

from __future__ import annotations

import asyncio
import logging
import time

from . import db, jobs, notifier
from .server_metrics import server_metrics

logger = logging.getLogger("amw_tpu_torch.anomaly")

def thresholds() -> dict:
    """Reference-compatible env-tunable thresholds (config.py:139-146:
    anomaly_cpu/ram/disk/error-rate/rss + alert_queue_threshold)."""
    from .config import settings

    return {
        "load_1m": max(1.0, settings.anomaly_cpu_threshold / 10.0),
        "min_available_mb": 300.0,
        "ram_pct": settings.anomaly_ram_threshold,
        "disk_pct": settings.anomaly_disk_threshold,
        "min_disk_mb": 200.0,
        "max_rss_mb": float(settings.anomaly_rss_max_mb),
        "max_error_rate": settings.anomaly_error_rate_threshold / 100.0,
        "min_jobs_for_error_rate": settings.anomaly_min_jobs_for_error_rate,
        "max_queue": settings.alert_queue_threshold or 10,
    }


def check_anomalies() -> list[str]:
    th = thresholds()
    alerts = []
    m = server_metrics()
    if m["load_1m"] > th["load_1m"]:
        alerts.append(f"High CPU load: {m['load_1m']}")
    if 0 < m["mem_available_mb"] < th["min_available_mb"]:
        alerts.append(f"Low RAM: {m['mem_available_mb']} MB available")
    if m.get("mem_total_mb", 0) > 0:
        ram_pct = 100.0 * (1.0 - m["mem_available_mb"] / m["mem_total_mb"])
        if ram_pct > th["ram_pct"]:
            alerts.append(f"RAM usage {ram_pct:.0f}% > {th['ram_pct']:.0f}%")
    if 0 < m["disk_free_mb"] < th["min_disk_mb"]:
        alerts.append(f"Low disk: {m['disk_free_mb']} MB free")
    if m.get("disk_total_mb", 0) > 0:
        disk_pct = 100.0 * (1.0 - m["disk_free_mb"] / m["disk_total_mb"])
        if disk_pct > th["disk_pct"]:
            alerts.append(f"Disk usage {disk_pct:.0f}% > {th['disk_pct']:.0f}%")
    if m["rss_mb"] > th["max_rss_mb"]:
        alerts.append(f"High RSS: {m['rss_mb']} MB")
    try:
        hour = time.time() - 3600
        with db.connect() as c:
            total = c.execute(
                "SELECT COUNT(*) n FROM mastering_jobs WHERE created_at > ?",
                (hour,)).fetchone()["n"]
            errors = c.execute(
                "SELECT COUNT(*) n FROM mastering_jobs WHERE created_at > ?"
                " AND status='error'", (hour,)).fetchone()["n"]
        if (total >= th["min_jobs_for_error_rate"]
                and errors / total > th["max_error_rate"]):
            alerts.append(f"Job error rate {errors}/{total} in the last hour")
    except Exception:  # noqa: BLE001
        pass
    queue = jobs.counts()["jobs_running"]
    if queue > th["max_queue"]:
        alerts.append(f"Queue length {queue}")
    return alerts


async def anomaly_loop(interval: float | None = None):
    if interval is None:
        from .config import settings

        interval = float(settings.anomaly_check_interval)
    while True:
        try:
            for alert in check_anomalies():
                notifier.notify_admin(f"⚠️ {alert}", throttle_key=alert[:24])
        except Exception as e:  # noqa: BLE001
            logger.warning("anomaly check failed: %s", e)
        await asyncio.sleep(interval)
