"""Server metrics for admin reports (reference: bot/server_metrics.py, which
uses psutil; this reads /proc directly — psutil is not in this image).

The port's copy of ``amw_tpu/runtime/server_metrics.py``.
"""

from __future__ import annotations

import os
import shutil


def cpu_load() -> tuple[float, float, float]:
    try:
        return os.getloadavg()
    except OSError:
        return (0.0, 0.0, 0.0)


def mem_info_mb() -> tuple[float, float]:
    """(total_mb, available_mb) from /proc/meminfo."""
    total = avail = 0.0
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    total = float(line.split()[1]) / 1024
                elif line.startswith("MemAvailable:"):
                    avail = float(line.split()[1]) / 1024
    except OSError:
        pass
    return total, avail


def rss_mb() -> float:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024
    except OSError:
        pass
    return 0.0


def disk_free_mb(path: str = "/") -> float:
    try:
        return shutil.disk_usage(path).free / (1 << 20)
    except OSError:
        return 0.0


def disk_total_mb(path: str = "/") -> float:
    try:
        return shutil.disk_usage(path).total / (1 << 20)
    except OSError:
        return 0.0


def server_metrics() -> dict:
    load1, load5, load15 = cpu_load()
    total, avail = mem_info_mb()
    return {
        "load_1m": round(load1, 2),
        "load_5m": round(load5, 2),
        "mem_total_mb": round(total),
        "mem_available_mb": round(avail),
        "rss_mb": round(rss_mb()),
        "disk_free_mb": round(disk_free_mb()),
        "disk_total_mb": round(disk_total_mb()),
    }


def server_metrics_text() -> str:
    m = server_metrics()
    return (f"🖥 load {m['load_1m']} / {m['load_5m']}\n"
            f"RAM {m['mem_available_mb']}/{m['mem_total_mb']} MB free\n"
            f"RSS {m['rss_mb']} MB · disk {m['disk_free_mb']} MB free")
