"""Mastering trace subsystem (reference: backend/app/mastering_trace.py).

Env/config-gated structured per-stage logging: a ``TraceContext`` (job id,
filename, path v1|v2, style, user, target LUFS, compressed pro-flag string)
is threaded through job execution; ``trace_stage`` logs cheap signal metrics
(channels, samples, duration, peak linear/dB, NaN/Inf counts) per DSP stage,
plus optional per-stage LUFS.  Job-level events: start/done/error, chain
module list, validation failures.

The port's copy of ``amw_tpu/utils/trace.py``.  The service logs the
job-level events; ``trace_stage`` is for a caller that holds a stage's
output (the graphs expose no intermediate buffers), such as the
stage-by-stage run of ``qa/mastering_regression.run_default_chain_stages``,
and its optional loudness is the port's meter on the CPU
(``qa/gates.integrated_lufs``).
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np

from ..qa import gates

logger = logging.getLogger("amw_tpu_torch.mastering_trace")
if not logger.handlers:
    _h = logging.StreamHandler()
    _h.setFormatter(logging.Formatter("%(asctime)s %(name)s %(message)s"))
    logger.addHandler(_h)
    logger.setLevel(logging.INFO)
    logger.propagate = False


def trace_enabled() -> bool:
    for prefix in ("MAGIC_MASTER_", "AMW_"):
        v = os.environ.get(prefix + "MASTERING_TRACE")
        if v is not None:
            return v.strip().lower() in ("1", "true", "yes", "on")
    return False


def trace_lufs_enabled() -> bool:
    for prefix in ("MAGIC_MASTER_", "AMW_"):
        v = os.environ.get(prefix + "MASTERING_TRACE_LUFS_STAGES")
        if v is not None:
            return v.strip().lower() in ("1", "true", "yes", "on")
    return False


@dataclass
class TraceContext:
    job_id: str
    filename: str = ""
    path: str = "v1"  # v1 | v2 | telegram
    style: str = "standard"
    user_id: Optional[int] = None
    target_lufs: Optional[float] = None
    pro_flags: str = ""
    started_at: float = field(default_factory=time.time)

    @classmethod
    def build(cls, job_id: str, filename: str, path: str, *,
              style: str = "standard", user_id=None, target_lufs=None,
              pro_params: dict | None = None) -> "TraceContext":
        flags = ",".join(
            f"{k}={v}" for k, v in sorted((pro_params or {}).items())
            if v not in (None, False, 0, 0.0, "")
        )
        return cls(job_id=job_id, filename=filename, path=path, style=style,
                   user_id=user_id, target_lufs=target_lufs, pro_flags=flags)


def signal_metrics(audio: np.ndarray, sr: int) -> dict[str, Any]:
    a = np.atleast_2d(np.asarray(audio))
    peak = float(np.max(np.abs(a))) if a.size else 0.0
    return {
        "channels": int(a.shape[0]),
        "samples": int(a.shape[-1]),
        "duration_sec": round(a.shape[-1] / sr, 3) if sr else 0.0,
        "peak": round(peak, 6),
        "peak_db": round(20 * np.log10(max(peak, 1e-12)), 2),
        "nan": int(np.isnan(a).sum()),
        "inf": int(np.isinf(a).sum()),
    }


def _fmt(d: dict) -> str:
    return " ".join(f"{k}={v}" for k, v in d.items())


def trace_stage(ctx: Optional[TraceContext], stage: str, audio, sr: int,
                **extra) -> None:
    if ctx is None or not trace_enabled():
        return
    m = signal_metrics(audio, sr)
    if trace_lufs_enabled():
        try:
            m["lufs"] = round(gates.integrated_lufs(audio, sr,
                                                    device="cpu"), 2)
        except Exception:  # noqa: BLE001
            pass
    logger.info("mastering_trace job_id=%s path=%s stage=%s %s %s",
                ctx.job_id, ctx.path, stage, _fmt(m),
                _fmt(extra) if extra else "")


def trace_job_start(ctx: Optional[TraceContext]) -> None:
    if ctx is None or not trace_enabled():
        return
    logger.info(
        "mastering_trace job_id=%s path=%s event=job_start file=%s style=%s "
        "target_lufs=%s pro=%s", ctx.job_id, ctx.path, ctx.filename,
        ctx.style, ctx.target_lufs, ctx.pro_flags)


def trace_job_done(ctx: Optional[TraceContext], **extra) -> None:
    if ctx is None or not trace_enabled():
        return
    logger.info("mastering_trace job_id=%s path=%s event=job_done dt=%.2f %s",
                ctx.job_id, ctx.path, time.time() - ctx.started_at,
                _fmt(extra))


def trace_job_error(ctx: Optional[TraceContext], exc: BaseException) -> None:
    if ctx is None or not trace_enabled():
        return
    logger.info("mastering_trace job_id=%s path=%s event=job_error error=%s",
                ctx.job_id, ctx.path, str(exc)[:300])


def trace_chain_modules(ctx: Optional[TraceContext], module_ids) -> None:
    if ctx is None or not trace_enabled():
        return
    logger.info("mastering_trace job_id=%s path=%s event=chain_modules "
                "modules=%s", ctx.job_id, ctx.path, ",".join(module_ids))


def trace_validate_failure(ctx: Optional[TraceContext], audio, reason: str,
                           sr: int) -> None:
    if ctx is None or not trace_enabled():
        return
    logger.info("mastering_trace job_id=%s path=%s event=validate_failure "
                "reason=%s %s", ctx.job_id, ctx.path, reason,
                _fmt(signal_metrics(audio, sr)))
