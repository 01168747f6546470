"""Sequence-parallel mastering: one long track sharded over a mesh of
positions by TIME (counterpart of ``amw_tpu/parallel/timeshard.py``).

A DJ-set-length track (up to 800 MB of WAV) is split into one chunk per
position of the mesh's last (``sp``) axis.  Each position extends its chunk
with halos taken from its neighbours' chunks (zeros at the track's ends;
halo >= the largest filter settle and envelope warm-up), runs each local
stage on the extended chunk, whose interior is then exact, and keeps its
chunk of the result.  Where the JAX code runs one program per device under
``shard_map`` and exchanges halos with ``ppermute``, the port loops over
the positions in one process (``parallel/mesh.py``): every position's
extended chunk is built from the chunks as they stand before the stage,
and the collectives are reductions over the positions' tensors, summed in
position order in float32:

- DC offset: the global mean (``psum``).
- Peak guard: the global |max| (``pmax``).
- BS.1770 normalize: per-position gating-block energies of the
  K-weighted extended chunk (``fdfilter.lfilter_fd``, ``chunk + 3·hop``
  kept so that blocks straddling positions are whole); the two-stage
  gate's counts and sums summed over positions — the full-track meter's
  blocks, gated on the global statistics.
- Output fade-in: by each position's sample index.
- Spectral denoise: the global per-(channel, bin) noise percentile from a
  256-bin log-magnitude histogram summed over positions (the one
  approximate stage: the exact percentile would need every STFT frame in
  one place).  The summed histogram is the global histogram exactly, so
  the error does not grow with the position count or track length: the
  quantile's bin width, 140 dB / 256 ≈ 0.55 dB of noise profile, and the
  per-chunk STFT frame grid near chunk boundaries (within ±nperseg).
  tests/test_torch_timeshard.py holds it to the exact denoiser at the JAX
  package's bars (≤ −22 dBFS for the whole output, ≤ −34 dBFS for the
  histogram term) and to the JAX package's sp denoiser.

On a pod mesh (``mesh.make_pod_mesh`` in a group of processes) every
rank runs the same call on the same input, as every process of the JAX
program runs the same jit: each rank masters the dp rows whose positions
are its own (an sp row never straddles processes), then every row's
output, and its stats, is broadcast by its rank in row order
(``_gather_rows``, host tensors over gloo), so that every rank returns
the whole batch, equal to one process's over the same grid.

Surface: the engine's v2 ``(config, pro)`` pair, as
``MasteringEngine.master_v2_bytes`` takes it — PRE [rumble] [denoise]
[deesser], any module list the chain accepts (amount blend included), POST
[transient designer] [parallel compression] [dynamic EQ] [true-peak
limiter] — plus the default chain for ``style=``-only calls.  The reverb
runs where its wet IR fits in the halo (longer decays are rejected at
build).

Track edges: every local stage is built in window variants — interior
(the extended chunk, fast mode), left edge (the window anchored at the
track start) and right edge (the window ending at the track end), both at
exact length — and each position runs its variant, so the whole track,
edges included, matches the single-device graph to ≤ −90 dBFS.  Where the
last chunk's valid length ``lv`` is below the halo, the second-to-last
position's right context crosses the track end: it runs a fourth variant
whose window also ends at the track end.  With two positions that window
would span the whole track, and the builder rejects (``ValueError``); the
engine then serves the single-device graph.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ..models.chain import MODULE_BUILDERS, default_chain_config
from ..models.v2_job import resolve_denoise
from ..ops import basic, fft_staged, meters
from ..ops.dynamics import (build_deesser, build_dynamic_eq,
                            build_transient_designer)
from ..ops.eq import build_rumble_filter
from ..ops.fdfilter import lfilter_fd
from ..spec import GraphSpec
from .mesh import Mesh, device_type, replicate

DEFAULT_HALO = 1 << 17  # 131072: covers filter settles and envelope warm-ups

# the window variants of a local stage, in the order of its params list:
# interior, left edge, right edge, and the second-to-last position's
# window ending at the track end (lv < halo only)
VARIANTS = ("i", "l", "r", "r2")


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _amount(f, a: float):
    if a >= 1.0:
        return f
    return lambda x, p: x * (1.0 - a) + f(x, p) * a


def _psum(vals: list) -> torch.Tensor:
    """The sum of the positions' tensors, in position order, on the first
    position's device."""
    acc = vals[0]
    for v in vals[1:]:
        acc = acc + v.to(acc.device)
    return acc


def _pmax(vals: list) -> torch.Tensor:
    acc = vals[0]
    for v in vals[1:]:
        acc = torch.maximum(acc, v.to(acc.device))
    return acc


def _build_denoise_sp(spec_ext: GraphSpec, strength: float,
                      noise_percentile: float):
    """The STFT Wiener denoiser over positions: frames on each position,
    the noise profile from a per-(channel, bin) log-magnitude histogram
    summed over positions (the percentile to the histogram's resolution).
    Returns ``([], fn)``: ``fn(exts, params)`` takes the positions'
    extended chunks [..., C, n_ext] (a list, position order) and returns
    their denoised outputs in a list."""
    from ..ops.spectral import istft, stft

    strength = float(np.clip(strength, 0.0, 1.0))
    nbins_h = 256
    lo, hi = -120.0, 20.0  # dB range of STFT magnitudes
    edges = np.linspace(lo, hi, nbins_h + 1).astype(np.float32)

    def fn(exts, params):
        Zs, hists = [], []
        for ext in exts:
            Z = stft(ext)  # [..., C, T, F]
            mag = Z.abs()
            mdb = 20.0 * torch.log10(mag.clamp(min=1e-12))
            binned = (((mdb - lo) / (hi - lo) * nbins_h).to(torch.int32)
                      .clamp(0, nbins_h - 1))
            # per-(track, channel, bin) histograms over the local frames,
            # counted into [rows * F * H] segments (the channels' profiles
            # stay apart, as the exact denoiser's percentile is per channel)
            F_ = mag.shape[-1]
            rows = int(np.prod(mag.shape[:-2]))
            row_idx = torch.arange(rows, device=ext.device).reshape(
                mag.shape[:-2] + (1, 1))
            freq_idx = torch.arange(F_, device=ext.device)
            seg = ((row_idx * F_ + freq_idx) * nbins_h + binned).reshape(-1)
            hist = torch.bincount(seg, minlength=rows * F_ * nbins_h)
            hists.append(hist.to(torch.float32).reshape(
                mag.shape[:-2] + (F_, nbins_h)))
            Zs.append(Z)
        hist = _psum(hists)
        total = hist.sum(dim=-1, keepdim=True)
        cum = torch.cumsum(hist, dim=-1)
        edges_t = torch.from_numpy(edges).to(hist.device)

        def quant(q):
            target = q / 100.0 * total
            idx = (cum < target).sum(dim=-1).clamp(0, nbins_h - 1)
            return 10.0 ** (edges_t[idx] / 20.0)  # [..., C, F]

        noise = quant(noise_percentile).clamp(min=1e-12)
        med = quant(50.0).clamp(min=1e-12)
        noise = torch.minimum(noise, 0.85 * med)
        outs = []
        for ext, Z in zip(exts, Zs):
            nz = noise.to(ext.device).unsqueeze(-2)  # [..., C, 1, F]
            gain = 1.0 - strength * (nz / (Z.abs() + 1e-10)) ** 2
            rec = istft(Z * gain.clamp(0.25, 1.0), spec_ext.n)
            outs.append(rec.clamp(-1.0, 1.0))
        return outs

    return [], fn


def build_sp_master(
    sr: int,
    n_total: int,
    channels: int,
    mesh: Mesh,
    *,
    target_lufs: float = -14.0,
    style: str = "standard",
    chain_config: dict | None = None,
    pro: dict | None = None,
    halo: int = DEFAULT_HALO,
    batch: bool = False,
    stats: bool = False,
):
    """Build a time-sharded mastering step with the engine's (config, pro)
    surface over the mesh's last (``sp``) axis.

    Returns ``(fn, params, n_pad)``: ``fn(x, params)`` takes ``x`` [C,
    n_pad] (with ``batch``, [B, C, n_pad] over a 2-D (dp, sp) mesh: each dp
    row time-shards B / dp of the tracks), numpy or a tensor, and returns
    the output as a tensor on this process's first position's device;
    pad the input with zeros to ``n_pad`` and slice the output back to
    ``n_total``.  ``params``: one copy per distinct device of this
    process's positions, by device.  On a pod mesh every rank calls
    ``fn`` on the same input and gets the whole output; ``fn.last_exchange``
    is then the last call's ``{"ms", "bytes"}`` of the rows' exchange.

    ``stats=True`` makes ``fn`` return the engine's v2 result dict —
    ``{out, before_lufs, after_lufs, peak, finite}``, the scalars computed
    over the positions by the same gated meter (per track with
    ``batch``).  ``fn.build_seconds``: the host seconds spent building
    the local stages, by window variant."""
    pro = dict(pro or {})
    axis = mesh.axis_names[-1]
    n_dev = mesh.shape[axis]
    if n_dev < 2:
        raise ValueError("sequence-parallel mastering needs >= 2 positions "
                         "on the sp axis (use the single-device engine "
                         "otherwise)")
    device_type(mesh)  # one type: every variant is planned for it
    dev = mesh.distinct_devices()[0]
    plan = meters.plan_blocks(sr, n_total)
    hop = plan.hop if plan.uniform else 1
    chunk = _round_up(_round_up(n_total, n_dev) // n_dev, max(hop, 256))
    n_pad = chunk * n_dev
    # A halo wider than the chunk would take more than one neighbour's
    # chunk; clamp (only tracks too short to need sp get there).
    halo = min(halo, chunk)
    n_ext = chunk + 2 * halo
    # The track end lands at sample ``lv`` of the last chunk.  Chunk
    # rounding (hop multiples) can leave the last position no valid sample
    # on a short track: reject (the engine falls back to one device).
    lv = n_total - (n_dev - 1) * chunk
    if lv <= 0:
        raise ValueError(
            f"track ({n_total} samples) too short for {n_dev}-way time "
            f"sharding (chunk {chunk}): last shard would hold no valid "
            f"samples — use fewer sp positions or the single-device path")
    # lv < halo: the second-to-last position's right context crosses the
    # track end; it runs a fourth variant ending at the track end.  With
    # two positions that window is the whole track: reject.
    need_r2 = lv < halo
    if need_r2 and n_dev < 3:
        raise ValueError(
            f"track ({n_total} samples) too short for {n_dev}-way time "
            f"sharding (last chunk {lv} < halo {halo}): the exact track-end "
            f"window would cover the whole track — use the single-device "
            f"path")
    spec_ext = GraphSpec(sr=sr, n=n_ext, channels=channels, exact=False)
    # Track-edge windows, at exact length: their own (scipy-exact) edge
    # handling lands on the track start / end; the far edge of each window
    # is >= halo from any kept sample.
    variant_specs = {
        "l": GraphSpec(sr=sr, n=chunk + halo, channels=channels, exact=True),
        "r": GraphSpec(sr=sr, n=halo + lv, channels=channels, exact=True)}
    if need_r2:
        variant_specs["r2"] = GraphSpec(sr=sr, n=halo + chunk + lv,
                                        channels=channels, exact=True)

    config = chain_config or default_chain_config(target_lufs=target_lufs,
                                                  style=style)

    # Stage plan: ("local", name, params by variant, fns by variant) run on
    # the extended chunk (edge positions through their windows);
    # ("uniform", ...) for the stage with reductions inside (the
    # denoiser), run over every position at once; ("dc" | "peak" |
    # "normalize", cfg) with reductions over positions.
    stages: list = []
    norm_targets: list[float] = []  # per-normalize-stage targets, in order
    build_s = dict.fromkeys(("i", *variant_specs), 0.0)  # host seconds

    def timed_build(key, build, spec):
        t0 = time.perf_counter()
        try:
            return build(spec)
        finally:
            build_s[key] += time.perf_counter() - t0

    def add_local(name, build, amount=1.0):
        """``build(spec) -> (params, fn)`` for the interior window and each
        edge window.  An edge variant that fails to build (a filter
        invalid at a short window) runs the interior fn at that position:
        zero-history edges for that one stage rather than no stage."""
        # an interior failure bypasses the module
        p, f = timed_build("i", build, spec_ext)
        ps, fs = {"i": list(p)}, {"i": _amount(f, amount)}
        for key, vspec in variant_specs.items():
            try:
                pv, fv = timed_build(key, build, vspec)
            except Exception:  # noqa: BLE001 — per-variant fallback
                ps[key], fs[key] = [], None
                continue
            ps[key], fs[key] = list(pv), _amount(fv, amount)
        stages.append(("local", name, [ps.get(k, []) for k in VARIANTS], fs))

    def add_uniform(name, built):
        p, f = built
        stages.append(("uniform", name, [list(p)], {"i": f}))

    # --- PRE pro modules (reference mastering.py:493-529) ---
    if pro.get("rumble_enabled"):
        add_local("rumble_filter", lambda s: build_rumble_filter(
            s, float(pro.get("rumble_cutoff", 80.0)), device=dev))
    strength, noise_pct = resolve_denoise(pro)
    if strength > 0.01:
        add_uniform("spectral_denoise",
                    _build_denoise_sp(spec_ext, strength, noise_pct))
    if pro.get("deesser_enabled"):
        add_local("deesser", lambda s: build_deesser(
            s, threshold_db=float(pro.get("deesser_threshold", -6.0)),
            freq_hi=float(pro.get("deesser_freq_hi", 9000.0)), device=dev))

    # --- chain modules ---
    for item in [dict(m) for m in config.get("modules", [])]:
        mid = item.pop("id", None)
        if not mid or not bool(item.get("enabled", True)):
            continue
        amount = float(np.clip(float(item.get("amount", 1.0)), 0.0, 1.0))
        if mid == "dc_offset":
            stages.append(("dc", amount, None, None))
            continue
        if mid == "peak_guard":
            stages.append(("peak",
                           (float(item.get("headroom_db", 0.5)), amount),
                           None, None))
            continue
        if mid == "normalize_lufs":
            tgt = float(item.get("target_lufs", target_lufs))
            stages.append(("normalize", (len(norm_targets), amount),
                           None, None))
            norm_targets.append(tgt)
            continue
        if mid == "reverb":
            from ..ops.reverb import wet_ir

            decay = float(item.get("decay_sec", 1.2) or 1.2)
            ir = wet_ir(sr, n_ext, str(item.get("reverb_type", "plate")),
                        decay)
            if len(ir) > halo:
                raise ValueError(
                    f"reverb IR ({len(ir)} samples) exceeds the halo "
                    f"({halo}); raise halo= or disable reverb in SP mode")
        if mid == "style_eq" and style is not None:
            item.setdefault("style", style)
        builder = MODULE_BUILDERS.get(mid)
        if builder is None:
            continue
        try:
            add_local(f"chain:{mid}",
                      lambda s, _b=builder, _it=item: _b(s, _it, dev),
                      amount)
        except NotImplementedError:
            raise
        except Exception:  # noqa: BLE001 — build-time bypass (chain policy)
            continue

    # --- POST pro modules (reference mastering.py:552-581) ---
    ta = pro.get("transient_attack")
    ts = pro.get("transient_sustain", 1.0)
    if ta is not None and (abs(float(ta) - 1.0) > 0.02
                           or abs(float(ts) - 1.0) > 0.02):
        add_local("transient_designer",
                  lambda s: build_transient_designer(s, float(ta), float(ts)))
    pmix = float(pro.get("parallel_mix", 0) or 0)
    if pmix > 0:
        add_local("parallel_compression",
                  lambda s: ([], lambda x, p, _m=pmix:
                             basic.parallel_compression(x, mix=_m)))
    if pro.get("dynamic_eq_enabled"):
        add_local("dynamic_eq", lambda s: build_dynamic_eq(s, device=dev))
    if pro.get("true_peak_enabled"):
        # the last gain stage before the fade, as in the single-device
        # graph (models/v2_job.py); its smoothing windows (~ms) sit far
        # inside the halo
        from ..ops.tplimit import build_true_peak_limiter

        ceiling = float(pro.get("true_peak_ceiling_db", -1.5))
        add_local("true_peak_limiter", lambda s: build_true_peak_limiter(
            s, ceiling_db=ceiling, device=dev))

    # The meter: causal K-weighting of the extended chunk, at the FFT size
    # the JAX package's design.next_fft_size picks on this backend.
    settle_k = meters.k_weight_settle(sr)
    nfft_k = fft_staged.site_plan(n_ext + settle_k, dev)[0]
    Hk = meters.k_weight_response(sr, nfft_k)
    if not plan.uniform or chunk % plan.hop != 0:
        raise ValueError("sequence-parallel meter needs a uniform gating grid")
    sub_per_chunk = chunk // plan.hop

    params_dev = replicate(
        [[p for kind, _, p, _ in stages if kind in ("local", "uniform")],
         Hk, np.asarray(norm_targets or [target_lufs], np.float32)], mesh)

    n_fade = max(2, min(int(round(sr * 0.006)), int(sr * 0.1)))
    g_weights = np.asarray(meters._CHANNEL_GAINS[:channels]
                           if channels <= 5 else (1.0,) * channels,
                           np.float32)
    local_fns = [(kind, fns) for kind, _, _, fns in stages
                 if kind in ("local", "uniform")]
    stage_kinds = [(kind, cfg) for kind, cfg, _, _ in stages]
    rows = mesh.devices.reshape(-1, n_dev)

    def variant(p: int) -> str:
        if p == n_dev - 1:
            return "r"
        if need_r2 and p == n_dev - 2:
            return "r2"
        return "l" if p == 0 else "i"

    def with_halo(xs, devs):
        """Each position's extended chunk [left halo, chunk, right halo],
        built from the chunks as they stand (zeros past the track ends)."""
        exts = []
        for p, x in enumerate(xs):
            z = x.new_zeros(x.shape[:-1] + (halo,))
            left = xs[p - 1][..., -halo:].to(devs[p]) if p > 0 else z
            right = (xs[p + 1][..., :halo].to(devs[p]) if p < n_dev - 1
                     else z)
            exts.append(torch.cat([left, x, right], dim=-1))
        return exts

    def run_row(xs, devs, params):
        """The stages over one row's positions: ``xs``, the chunks [b, C,
        chunk] on ``devs``."""
        pos = [p * chunk + torch.arange(chunk, device=d)
               for p, d in enumerate(devs)]
        valid = [lp < n_total for lp in pos]
        ps = [params[d] for d in devs]

        def gated_lufs(xs):
            exts = with_halo(xs, devs)
            parts = []
            for p, ext in enumerate(exts):
                Hc = torch.complex(ps[p][1][0], ps[p][1][1])
                y = lfilter_fd(ext, Hc, nfft_k)[
                    ..., halo:halo + chunk + 3 * plan.hop]
                nsub = sub_per_chunk + 3
                ysub = y.square()[..., :nsub * plan.hop].reshape(
                    y.shape[:-1] + (nsub, plan.hop)).sum(-1)
                z = (ysub[..., 0:sub_per_chunk]
                     + ysub[..., 1:sub_per_chunk + 1]
                     + ysub[..., 2:sub_per_chunk + 2]
                     + ysub[..., 3:sub_per_chunk + 3]) / plan.div
                j = p * sub_per_chunk + torch.arange(sub_per_chunk,
                                                     device=devs[p])
                g = torch.from_numpy(g_weights).to(devs[p])
                zsum = (g[:, None] * z).sum(-2)  # [b, J]
                l_j = -0.691 + 10.0 * torch.log10(zsum.clamp(min=1e-30))
                m1 = (l_j > -70.0) & (j < plan.n_blocks)
                parts.append((zsum, l_j, m1))
            c1 = _psum([m1.sum(-1) for _, _, m1 in parts])
            s1 = _psum([(zsum * m1).sum(-1) for zsum, _, m1 in parts])
            gamma_r = -0.691 + 10.0 * torch.log10(
                (s1 / c1.clamp(min=1)).clamp(min=1e-30)) - 10.0
            m2s = [m1 & (l_j > gamma_r.to(l_j.device)[:, None])
                   for _, l_j, m1 in parts]
            c2 = _psum([m2.sum(-1) for m2 in m2s])
            s2 = _psum([(zsum * m2).sum(-1)
                        for (zsum, _, _), m2 in zip(parts, m2s)])
            lufs = -0.691 + 10.0 * torch.log10(
                (s2 / c2.clamp(min=1)).clamp(min=1e-30))
            return torch.where(c2 > 0, lufs, torch.full_like(lufs, -1e9))

        def blend(x, y, a):
            return y if a >= 1.0 else x * (1.0 - a) + y * a

        before = gated_lufs(xs) if stats else None
        li = 0
        for kind, cfg in stage_kinds:
            if kind == "dc":
                s = _psum([torch.where(v, x, 0.0).sum(-1)
                           for x, v in zip(xs, valid)])
                mean = s / n_total
                xs = [blend(x, torch.where(v, x - mean.to(d)[..., None],
                                           0.0), cfg)
                      for x, v, d in zip(xs, valid, devs)]
            elif kind == "peak":
                headroom_db, a = cfg
                xn = [torch.nan_to_num(x, nan=0.0, posinf=1.0, neginf=-1.0)
                      for x in xs]
                peak = _pmax([x.abs().amax(dim=(-2, -1)) for x in xn])
                limit = 10.0 ** (-headroom_db / 20.0)
                scale = torch.where(peak > limit,
                                    limit / peak.clamp(min=1e-12),
                                    torch.ones_like(peak))
                xs = [blend(x, (y * scale.to(d)[:, None, None]).clamp(
                    -1.0, 1.0), a) for x, y, d in zip(xs, xn, devs)]
            elif kind == "normalize":
                norm_i, a = cfg
                gain = meters.normalize_lufs_gain(gated_lufs(xs),
                                                  ps[0][2][norm_i])
                xs = [blend(x, x * gain.to(d)[:, None, None], a)
                      for x, d in zip(xs, devs)]
            else:
                lkind, fns = local_fns[li]
                exts = with_halo(xs, devs)
                if lkind == "uniform":
                    ys = [y[..., halo:halo + chunk] for y in fns["i"](
                        exts, [p[0][li][0] for p in ps])]
                else:
                    ys = [_run_variant(p, variant(p), fns, ps[p][0][li],
                                       exts[p], halo, chunk, lv)
                          for p in range(n_dev)]
                li += 1
                xs = [torch.where(v, y, 0.0) for y, v in zip(ys, valid)]

        # --- fade-in + clip ---
        xs = [x * (lp / (n_fade - 1)).clamp(0.0, 1.0)
              for x, lp in zip(xs, pos)]
        outs = [basic.finalize_clip(torch.where(v, x, 0.0))
                for x, v in zip(xs, valid)]
        if not stats:
            return {"out": outs}
        nonfinite = _psum([(~torch.isfinite(x)).sum(dim=(-2, -1))
                           for x in xs])
        return {"out": outs, "before_lufs": before,
                "after_lufs": gated_lufs(outs),
                "peak": _pmax([o.abs().amax(dim=(-2, -1)) for o in outs]),
                "finite": nonfinite == 0}

    owners = mesh.process_index.reshape(-1, n_dev)[:, 0]
    home = mesh.distinct_devices()[0]

    def fn(x, params):
        x = torch.as_tensor(x, dtype=torch.float32)
        xb = x if batch else x[None]
        B = xb.shape[0]
        used = rows if batch else rows[:1]
        if B % len(used):
            raise ValueError(f"batch {B} not divisible by dp axis "
                             f"{len(used)}")
        per = B // len(used)
        results = {}
        with torch.inference_mode():
            for r, devs in enumerate(used):
                if devs[0] is None:  # another process's row
                    continue
                xr = xb[r * per:(r + 1) * per]
                xs = [xr[..., p * chunk:(p + 1) * chunk].to(d)
                      for p, d in enumerate(devs)]
                res = run_row(xs, list(devs), params)
                results[r] = {"out": torch.cat(
                    [o.to(home) for o in res["out"]], dim=-1),
                    **{k: res[k].to(home) for k in STATS if stats}}
            if mesh.spans_processes:
                results, fn.last_exchange = _gather_rows(
                    results, owners[:len(used)], (per,) + xb.shape[1:],
                    home, stats)
            out = torch.cat([results[r]["out"] for r in range(len(used))])
            if not stats:
                return out if batch else out[0]
            res = {"out": out}
            for k in STATS:
                res[k] = torch.cat([results[r][k] for r in range(len(used))])
            return res if batch else {k: v[0] for k, v in res.items()}

    fn.build_seconds = build_s
    fn.last_exchange = None
    return fn, params_dev, n_pad


STATS = ("before_lufs", "after_lufs", "peak", "finite")


def _gather_rows(done: dict, owners, shape: tuple, home, stats: bool):
    """Every row's result on every rank of a pod mesh: row ``r``, mastered
    by the rank ``owners[r]`` (its entry of ``done``), broadcast by that
    rank as host tensors over the group (gloo), in row order.  Returns the
    rows by index and ``{"ms", "bytes"}``: the exchange's host wall and the
    bytes of the rows broadcast (outputs ``shape`` float32, and with
    ``stats`` the four stats as float32 [4, rows])."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    nbytes = 0
    out = {}
    for r, owner in enumerate(owners):
        mine = r in done
        buf = (done[r]["out"].cpu() if mine
               else torch.empty(shape, dtype=torch.float32))
        dist.broadcast(buf, src=int(owner))
        nbytes += buf.numel() * buf.element_size()
        row = done[r] if mine else {"out": buf.to(home)}
        if stats:
            sbuf = (torch.stack([done[r][k].to(torch.float32).cpu()
                                 for k in STATS]) if mine
                    else torch.empty((len(STATS), shape[0]),
                                     dtype=torch.float32))
            dist.broadcast(sbuf, src=int(owner))
            nbytes += sbuf.numel() * sbuf.element_size()
            if not mine:
                row.update({k: sbuf[i].to(home) for i, k in enumerate(STATS)})
                row["finite"] = row["finite"] > 0.5
        out[r] = row
    return out, {"ms": (time.perf_counter() - t0) * 1e3, "bytes": nbytes}


def _run_variant(p: int, key: str, fns: dict, vparams: list,
                 ext: torch.Tensor, halo: int, chunk: int, lv: int):
    """Position ``p``'s local stage on its extended chunk ``ext``, through
    the window of variant ``key`` (the interior fn where that variant did
    not build): its chunk of the output [..., chunk]."""
    k = VARIANTS.index(key)
    if key == "l" and fns["l"] is not None:
        return fns["l"](ext[..., halo:], vparams[k])[..., :chunk]
    if key == "r" and fns["r"] is not None:
        y = fns["r"](ext[..., :halo + lv], vparams[k])[..., halo:]
        if lv < chunk:
            y = torch.cat([y, y.new_zeros(y.shape[:-1] + (chunk - lv,))],
                          dim=-1)
        return y
    if key == "r2" and fns["r2"] is not None:
        return fns["r2"](ext[..., :halo + chunk + lv],
                         vparams[k])[..., halo:halo + chunk]
    return fns["i"](ext, vparams[0])[..., halo:halo + chunk]


def sp_master(x: np.ndarray, sr: int, mesh: Mesh, **kw) -> np.ndarray:
    """Master one long [C, N] track sharded over the mesh by time.  Accepts
    the engine's v2 surface: chain_config=, pro=, target_lufs=, style=.
    On a pod mesh every rank calls it with the same track: the first dp
    row's rank masters it, and every rank returns it."""
    x = np.atleast_2d(np.asarray(x, np.float32))
    C, n = x.shape
    fn, params, n_pad = build_sp_master(sr, n, C, mesh, **kw)
    xp = np.pad(x, ((0, 0), (0, n_pad - n)))
    return fn(xp, params).cpu().numpy()[..., :n]


def sp_batch_master(xb: np.ndarray, sr: int, mesh: Mesh, **kw) -> np.ndarray:
    """Master a batch of long [B, C, N] tracks over a 2-D ``(dp, sp)`` mesh:
    the batch is data-parallel over the first mesh axis while each track is
    time-sharded over the second.  ``B`` must divide by the dp size.  On
    a pod mesh every rank calls it with the same batch, masters its own
    rows and returns the whole batch; a batch that does not divide is
    refused on every rank before any exchange."""
    xb = np.asarray(xb, np.float32)
    B, C, n = xb.shape
    dp = mesh.shape[mesh.axis_names[0]]
    if B % dp:
        raise ValueError(f"batch {B} not divisible by dp axis {dp}")
    fn, params, n_pad = build_sp_master(sr, n, C, mesh, batch=True, **kw)
    xp = np.pad(xb, ((0, 0), (0, 0), (0, n_pad - n)))
    return fn(xp, params).cpu().numpy()[..., :n]
