"""Config-driven mastering chain (counterpart of ``amw_tpu/models/chain.py``).

The reference's v2 chain runtime (backend/app/chain.py) interprets a JSON
config into a list of modules run in turn.  Here each module id maps to an
op builder returning ``(params, fn)``; the chain threads the audio through
every enabled module, with the per-module ``amount`` dry/wet blend
(base.py:33-50), the peephole fusions of adjacent modules, and the final
clip/NaN scrub of chain.py:93-94.

Failure semantics are the JAX package's with one exception.  A builder
that raises at build time is bypassed and recorded in ``bypassed`` (the
reference bypasses a module that fails), and a fusion that fails to build
falls back to the separate modules.  A ``NotImplementedError``, however,
is what the port raises for an op it does not have; it propagates, so
that a chain never quietly skips a module the JAX package runs.  Every
module of ``MODULE_BUILDERS`` is ported (the reverb and the true-peak
limiter last), so none raises it today.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..constants import STYLE_CONFIGS
from ..convert import to_device
from ..ops import basic, eq, meters, validctx
from ..ops import fused as ops_fused
from ..ops.bands import build_dynamics
from ..ops.dynamics import build_maximizer_transient_aware
from ..ops.exciter import build_harmonic_exciter
from ..ops.reverb import build_reverb
from ..ops.stereo import build_stereo_imager
from ..ops.tplimit import build_true_peak_limiter
from ..spec import GraphSpec


def _b_dc(spec, cfg, device):
    return [], lambda x, p: basic.remove_dc_offset(x)


def _b_peak_guard(spec, cfg, device):
    headroom = float(cfg.get("headroom_db", 0.5))
    return [], lambda x, p: basic.remove_intersample_peaks(x, headroom)


def _b_target_curve(spec, cfg, device):
    return eq.build_target_curve(
        spec, phase_mode=str(cfg.get("phase_mode", "minimum")),
        eq_ms=bool(cfg.get("eq_ms", False)), device=device)


def _dyn_kwargs(cfg):
    return dict(knee_db=float(cfg.get("knee_db", 6.0)),
                crossovers_hz=cfg.get("crossovers_hz"),
                band_ratios=cfg.get("band_ratios"),
                max_upward_boost_db=float(cfg.get("max_upward_boost_db",
                                                  12.0)),
                compressor=str(cfg.get("compressor", "soft_knee")))


def _b_dynamics(spec, cfg, device):
    return build_dynamics(spec, device=device, **_dyn_kwargs(cfg))


def _b_maximizer(spec, cfg, device):
    return build_maximizer_transient_aware(
        spec, sensitivity=float(cfg.get("sensitivity", 0.5)))


def _b_normalize(spec, cfg, device):
    return meters.build_normalize_lufs(
        spec, target_lufs=float(cfg.get("target_lufs", -14.0)),
        device=device)


def _b_final_balance(spec, cfg, device):
    return eq.build_final_spectral_balance(spec, device=device)


def _b_style_eq(spec, cfg, device):
    return eq.build_style_eq(spec, style=str(cfg.get("style", "standard")),
                             device=device)


def _b_exciter(spec, cfg, device):
    return build_harmonic_exciter(
        spec, exciter_db=float(cfg.get("exciter_db", 0.0)),
        mode=str(cfg.get("mode", "warm")),
        oversample=int(cfg.get("oversample", 1)), device=device)


def _b_imager(spec, cfg, device):
    return build_stereo_imager(
        spec, width=float(cfg.get("width", 1.0)),
        stereoize_delay_ms=float(cfg.get("stereoize_delay_ms", 0.0)),
        stereoize_mix=float(cfg.get("stereoize_mix", 0.12)),
        band_widths=cfg.get("band_widths"),
        crossovers_hz=cfg.get("crossovers_hz"), device=device)


def _b_reverb(spec, cfg, device):
    return build_reverb(
        spec, reverb_type=str(cfg.get("reverb_type", "plate")),
        decay_sec=float(cfg.get("decay_sec", 1.2)),
        mix=float(cfg.get("mix", 0.15)), mix_mid=cfg.get("mix_mid"),
        mix_side=cfg.get("mix_side"), device=device)


def _b_true_peak(spec, cfg, device):
    return build_true_peak_limiter(
        spec, ceiling_db=float(cfg.get("ceiling_db", -1.5)),
        lookahead_ms=float(cfg.get("lookahead_ms", 1.5)), device=device)


MODULE_BUILDERS: dict[str, Callable] = {
    "dc_offset": _b_dc,
    "peak_guard": _b_peak_guard,
    "target_curve": _b_target_curve,
    "dynamics": _b_dynamics,
    "maximizer": _b_maximizer,
    "normalize_lufs": _b_normalize,
    "final_spectral_balance": _b_final_balance,
    "style_eq": _b_style_eq,
    "exciter": _b_exciter,
    "imager": _b_imager,
    "reverb": _b_reverb,
    "true_peak_limiter": _b_true_peak,
}


def default_chain_config(target_lufs: float = -14.0,
                         style: str = "standard") -> dict:
    """Default v2 chain config: chain.py:101-125 verbatim, including the
    2230 Hz crossover drift (the v1 pipeline splits at 3500 Hz)."""
    cfg = STYLE_CONFIGS.get(style, STYLE_CONFIGS["standard"])
    exciter_db = cfg.get("exciter_db", 0.0)
    imager_width = cfg.get("imager_width", 1.0)
    return {
        "modules": [
            {"id": "dc_offset", "enabled": True, "amount": 1.0},
            {"id": "peak_guard", "enabled": True, "headroom_db": 0.5, "amount": 1.0},
            {"id": "target_curve", "enabled": True, "phase_mode": "minimum", "eq_ms": False, "amount": 1.0},
            {"id": "dynamics", "enabled": True, "knee_db": 6.0, "crossovers_hz": [214.0, 2230.0, 10000.0], "amount": 1.0},
            {"id": "normalize_lufs", "enabled": True, "target_lufs": target_lufs, "amount": 1.0},
            {"id": "final_spectral_balance", "enabled": True, "amount": 1.0},
            {"id": "style_eq", "enabled": True, "style": style, "amount": 1.0},
            {"id": "exciter", "enabled": abs(exciter_db) >= 0.05, "exciter_db": exciter_db, "mode": "warm", "oversample": 1, "amount": 1.0},
            {"id": "imager", "enabled": abs(imager_width - 1.0) >= 0.01, "width": imager_width, "stereoize_delay_ms": 0.0, "stereoize_mix": 0.12, "band_widths": None, "crossovers_hz": [214.0, 2230.0, 10000.0], "amount": 1.0},
            {"id": "reverb", "enabled": False, "reverb_type": "plate", "decay_sec": 1.2, "mix": 0.15, "mix_mid": None, "mix_side": None, "amount": 1.0},
            {"id": "peak_guard", "enabled": True, "headroom_db": 0.5, "amount": 1.0},
        ]
    }


def _amount_blend(f, amount: float):
    def blended(x, p):
        return x * (1.0 - amount) + f(x, p) * amount

    return blended


def _try_fusion(build):
    """A fusion's build, or ``None`` where it fails (the separate modules
    then run); an unported op's ``NotImplementedError`` propagates."""
    try:
        return build()
    except NotImplementedError:
        raise
    except Exception:  # noqa: BLE001 - the JAX package's fallback
        return None


def build_chain_ops(spec: GraphSpec, config: dict, *,
                    target_lufs: float | None = None,
                    style: str | None = None, device):
    """The per-module op list of a config: ``(ids, params_list, fns,
    bypassed)`` with params as numpy arrays (used by :func:`compile_chain`
    and the v2 job graph)."""
    fns, params_all, ids, bypassed = [], [], [], []
    modules = [dict(m) for m in config.get("modules", [])]
    skip_ids: set = set()

    def _is(idx2, mid2):
        return (0 <= idx2 < len(modules)
                and modules[idx2].get("id") == mid2
                and bool(modules[idx2].get("enabled", True))
                and float(modules[idx2].get("amount", 1.0)) >= 1.0)

    for idx, item in enumerate(modules):
        mid = item.pop("id", None)
        if not mid or mid not in MODULE_BUILDERS:
            continue
        if not bool(item.get("enabled", True)) or idx in skip_ids:
            continue
        full = float(item.get("amount", 1.0)) >= 1.0
        # peephole fusions of adjacent modules (each saves a full pass or a
        # forward FFT per track)
        if mid == "dc_offset" and full and _is(idx + 1, "peak_guard"):
            headroom = float(modules[idx + 1].get("headroom_db", 0.5))
            skip_ids.add(idx + 1)
            fns.append(lambda x, p, _h=headroom:
                       basic.remove_dc_then_peak_guard(x, _h))
            params_all.append([])
            ids.append("dc_offset+peak_guard")
            continue
        if (mid == "target_curve" and full
                and str(item.get("phase_mode", "minimum")) == "minimum"
                and not bool(item.get("eq_ms", False))
                and _is(idx + 1, "dynamics")):
            dyn = modules[idx + 1]
            fused = _try_fusion(lambda: ops_fused.build_target_then_dynamics(
                spec, device=device, **_dyn_kwargs(dyn)))
            if fused is not None:
                skip_ids.add(idx + 1)
                fns.append(fused[1])
                params_all.append(list(fused[0]))
                ids.append("target_curve+dynamics")
                continue
        if (mid == "normalize_lufs" and full
                and _is(idx + 1, "final_spectral_balance")):
            with_style = _is(idx + 2, "style_eq")
            st = (style if style is not None
                  else modules[idx + 2].get("style", "standard")) \
                if with_style else None
            tgt = (target_lufs if target_lufs is not None
                   else float(item.get("target_lufs", -14.0)))
            fused = _try_fusion(lambda: ops_fused.build_normalize_then_final(
                spec, tgt, st, device=device))
            if fused is not None:
                p_nf, f_nf, nf_id = fused
                skip_ids.add(idx + 1)
                if with_style and nf_id.endswith("style_eq"):
                    skip_ids.add(idx + 2)
                fns.append(f_nf)
                params_all.append(list(p_nf))
                ids.append(nf_id)
                continue
        if (mid == "final_spectral_balance" and full
                and _is(idx + 1, "style_eq")):
            st = style if style is not None else modules[idx + 1].get(
                "style", "standard")
            fused = _try_fusion(lambda: eq.build_final_balance_then_style(
                spec, st, device=device))
            if fused is not None:
                skip_ids.add(idx + 1)
                fns.append(fused[1])
                params_all.append(list(fused[0]))
                ids.append("final_spectral_balance+style_eq")
                continue
        if target_lufs is not None and mid == "normalize_lufs":
            item["target_lufs"] = target_lufs
        if style is not None and mid == "style_eq":
            item["style"] = style
        amount = float(np.clip(float(item.get("amount", 1.0)), 0.0, 1.0))
        try:
            p, f = MODULE_BUILDERS[mid](spec, item, device)
        except NotImplementedError:
            raise
        except Exception as exc:  # noqa: BLE001 - the reference's bypass
            bypassed.append((mid, repr(exc)))
            continue
        if amount < 1.0:
            f = _amount_blend(f, amount)
        fns.append(f)
        params_all.append(list(p))
        ids.append(mid)
    return ids, params_all, fns, bypassed


def as_batch(x: torch.Tensor, n_valid):
    """``(xb, nv, single)``: ``x`` [C, N] or [B, C, N] as a batch, and
    ``n_valid`` as an int32 [B] tensor on its device (or None)."""
    single = x.ndim == 2
    xb = x[None] if single else x
    nv = None
    if n_valid is not None:
        nv = torch.as_tensor(n_valid, dtype=torch.int32,
                             device=xb.device).reshape(-1)
        if nv.shape[0] != xb.shape[0]:
            raise ValueError("n_valid needs one length per track")
    return xb, nv, single


@dataclass
class CompiledChain:
    spec: GraphSpec
    module_ids: list
    params: list = field(repr=False)  # per-module tensors on the device
    fn: Callable = field(repr=False)  # (x, params, n_valid=None) -> x
    device: torch.device = None
    bypassed: list = field(default_factory=list)

    def __call__(self, x):
        x = torch.as_tensor(np.ascontiguousarray(x, np.float32),
                            device=self.device)
        with torch.no_grad():
            return self.fn(x, self.params).cpu().numpy()


_CHAIN_CACHE: dict = {}


def compile_chain(spec: GraphSpec, config: dict | None = None, *,
                  target_lufs: float | None = None, style: str | None = None,
                  device=None) -> CompiledChain:
    """Build a chain from a v2-style config dict, cached by (spec, config,
    overrides, device).  ``target_lufs``/``style`` override the per-module
    values (chain.py:86-90).  ``fn(x, params, n_valid=None)`` takes
    ``[C, N]`` or ``[B, C, N]``."""
    dev = resolve_device(device)
    if config is None:
        config = default_chain_config(
            target_lufs if target_lufs is not None else -14.0,
            style if style is not None else "standard")
    key = (spec, json.dumps(config, sort_keys=True, default=str),
           target_lufs, style, str(dev))
    cached = _CHAIN_CACHE.get(key)
    if cached is not None:
        return cached

    ids, params_all, fns, bypassed = build_chain_ops(
        spec, config, target_lufs=target_lufs, style=style, device=dev)

    def chain_fn(x, params, n_valid=None):
        xb, nv, single = as_batch(x, n_valid)
        with validctx.valid_length(nv):
            for f, p in zip(fns, params):
                # keep the bucket padding silent between modules
                xb = validctx.mask_tail(f(xb, p))
        out = basic.finalize_clip(xb)
        return out[0] if single else out

    out = CompiledChain(spec=spec, module_ids=ids,
                        params=to_device(params_all, dev), fn=chain_fn,
                        device=dev, bypassed=bypassed)
    _CHAIN_CACHE[key] = out
    return out
