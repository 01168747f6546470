"""The reference service's DSP stages in NumPy and SciPy, in float64.

One track ``[C, N]`` at its own length, time on the last axis.  Each
function follows the reference op it names (backend/app/pipeline.py,
cited per function); the channel loops are vectorised over the leading
axis and the IIR filters run through ``scipy.signal.filtfilt``.  Two
departures, each exact to far below float32 rounding:

- the attack/release envelope follower runs in overlapping chunks (see
  :func:`envelope_follower`), since a loop over every sample in Python
  takes minutes for a 180 s track;
- nothing is cast to float32 between stages, so that the reference sits
  well below the program's own rounding.
"""

from __future__ import annotations

import math

import numpy as np
from scipy import signal as sg

from .constants import (DYNAMIC_EQ_MASTERING_BANDS, FINAL_TRIM_DB,
                        MAXIMIZER_MARGIN_DB, MAXIMIZER_THRESHOLD_DB,
                        MULTIBAND_CONFIG, MULTIBAND_CROSSOVERS_HZ,
                        STYLE_CONFIGS, TRUE_PEAK_LIMIT_DB)

# the envelope follower's chunks start this far back, so that their
# guessed start state has decayed below this share of the signal
ENV_FORGET = 1e-9


def db(x):
    return 10.0 ** (x / 20.0)


def _scrub(a, nan, posinf, neginf):
    """``np.nan_to_num`` with these values, without its passes where
    every value is finite already."""
    if np.isfinite(a).all():
        return a
    return np.nan_to_num(a, nan=nan, posinf=posinf, neginf=neginf)


def safe_filtfilt(b, a, x):
    """``filtfilt`` with the reference's fallbacks (pipeline.py:36-52)."""
    try:
        return sg.filtfilt(b, a, x, axis=-1)
    except (np.linalg.LinAlgError, ValueError):
        try:
            return sg.lfilter(b, a, x, axis=-1)
        except ValueError:
            return x


# --- basics (pipeline.py:134-167, 276-330, 484-492, 1904) -------------------

def remove_dc_offset(x):
    return x - np.mean(x, axis=-1, keepdims=True)


def remove_intersample_peaks(x, headroom_db=0.5):
    x = _scrub(x, 0.0, 1.0, -1.0)
    peak = np.max(np.abs(x)) if x.size else 0.0
    limit = db(-headroom_db)
    if peak > limit:
        x = x * (limit / peak)
    return np.clip(x, -1.0, 1.0)


def output_edge_fade_in(x, sr, fade_ms=6.0):
    n = x.shape[-1]
    if fade_ms <= 0 or sr <= 0 or n == 0:
        return x
    n_fade = int(round(sr * (fade_ms / 1000.0)))
    n_fade = max(2, min(n_fade, int(sr * 0.1)))
    n_fade = min(n_fade, n)
    out = np.array(x, copy=True)
    out[..., :n_fade] *= np.linspace(0.0, 1.0, n_fade)
    return out


def finalize_clip(x):
    """The end-of-chain scrub (pipeline.py:1904, chain.py:93-94)."""
    return _scrub(np.clip(x, -1.0, 1.0), 0.0, 1.0, -1.0)


def limiter(x, threshold_db=-1.0):
    lim = db(threshold_db)
    return np.clip(x, -lim, lim)


def compress_soft_knee(x, threshold_db=-18.0, ratio=2.5, knee_db=6.0,
                       max_upward_boost_db=12.0):
    if ratio <= 0.0 or ratio == 1.0:
        return x
    thresh = db(threshold_db)
    abs_x = np.abs(x)
    sign = np.sign(x)
    if ratio < 1.0:
        eps = 1e-12
        level_db = np.where(abs_x > eps,
                            20.0 * np.log10(np.maximum(abs_x, eps)), -100.0)
        boost = np.clip((threshold_db - level_db) * (1.0 - ratio),
                        0.0, max(0.1, float(max_upward_boost_db)))
        return sign * np.clip(abs_x * db(boost), 0.0, 1.0)
    knee_db = max(0.0, float(knee_db))
    if knee_db < 0.5:
        return sign * np.minimum(abs_x, thresh
                                 + np.maximum(abs_x - thresh, 0.0) / ratio)
    lower = thresh * db(-knee_db)
    upper = thresh * db(knee_db)
    slope = (thresh + (upper - thresh) / ratio - lower) / (upper - lower)
    out_abs = np.where(
        abs_x <= lower, abs_x,
        np.where(abs_x >= upper, thresh + (abs_x - thresh) / ratio,
                 lower + (abs_x - lower) * slope))
    return sign * np.clip(out_abs, 0.0, None)


def maximizer(x):
    ceiling = db(MAXIMIZER_MARGIN_DB)
    thresh = db(MAXIMIZER_THRESHOLD_DB)
    abs_x = np.abs(x)
    out_abs = np.where(abs_x <= thresh, abs_x,
                       thresh + (abs_x - thresh) * (ceiling - thresh)
                       / (1.0 - thresh))
    return np.sign(x) * np.minimum(out_abs, ceiling)


def parallel_compression(x, mix=0.3, ratio=8.0, threshold_db=-20.0):
    """New York compression (pipeline.py:1771)."""
    mix = float(np.clip(mix, 0.0, 1.0))
    if mix < 0.01:
        return x
    compressed = compress_soft_knee(x, threshold_db=threshold_db,
                                    ratio=ratio, knee_db=6.0,
                                    max_upward_boost_db=0.0)
    return np.clip(x * (1.0 - mix) + compressed * mix, -1.0, 1.0)


# --- EQ (pipeline.py:170-273, 576-607, 1401-1434, 1449-1469) ---------------

def target_curve(x, sr):
    """The studio target curve, minimum phase (pipeline.py:170-273)."""
    nyq = sr / 2.0
    b_hp, a_hp = sg.butter(2, min(40.0 / nyq, 0.99), btype="high")
    b_lp, a_lp = sg.butter(2, min(18000.0 / nyq, 0.99), btype="low")
    f_pres = min(3000.0 / nyq, 0.99)
    b_pr, a_pr = sg.butter(1, [f_pres * 0.7, f_pres * 1.3], btype="band")
    f_mud = min(300.0 / nyq, 0.99)
    b_md, a_md = sg.butter(1, [f_mud * 0.7, f_mud * 1.3], btype="band")
    y = safe_filtfilt(b_hp, a_hp, x)
    y = safe_filtfilt(b_lp, a_lp, y)
    pres = safe_filtfilt(b_pr, a_pr, y)
    mud = safe_filtfilt(b_md, a_md, y)
    return y + (db(0.35) - 1.0) * pres + (db(-0.25) - 1.0) * mud


def final_spectral_balance(x, sr):
    nyq = sr / 2.0
    f3k = min(3000.0 / nyq, 0.99)
    b3, a3 = sg.butter(1, [f3k * 0.8, f3k * 1.2], btype="band")
    b16, a16 = sg.butter(2, min(16000.0 / nyq, 0.99), btype="high")
    blo, alo = sg.butter(2, min(180.0 / nyq, 0.99), btype="low")
    f8k = min(8000.0 / nyq, 0.99)
    b8, a8 = sg.butter(1, [f8k * 0.8, f8k * 1.2], btype="band")
    y = (x + (db(-0.5) - 1.0) * safe_filtfilt(b3, a3, x) * 0.25
         + (db(-0.3) - 1.0) * safe_filtfilt(b16, a16, x) * 0.25)
    y = (y + (db(0.3) - 1.0) * safe_filtfilt(blo, alo, x) * 0.25
         + (db(0.2) - 1.0) * safe_filtfilt(b8, a8, x) * 0.25)
    return y * db(FINAL_TRIM_DB)


def style_eq(x, sr, style="standard"):
    cfg = STYLE_CONFIGS.get(style, STYLE_CONFIGS["standard"])
    nyq = sr / 2.0
    bands = [(30.0, 90.0, cfg["sub"]), (90.0, 280.0, cfg["bass"]),
             (700.0, 2800.0, cfg["mids"]), (2800.0, 9000.0, cfg["presence"]),
             (10000.0, min(sr * 0.46, 18000.0), cfg["air"])]
    out = x
    for f_lo, f_hi, gain_db in bands:
        if abs(gain_db) < 0.05:
            continue
        lo_n, hi_n = min(f_lo / nyq, 0.98), min(f_hi / nyq, 0.98)
        if lo_n >= hi_n:
            continue
        b, a = sg.butter(1, [lo_n, hi_n], btype="band")
        out = out + (db(gain_db) - 1.0) * safe_filtfilt(b, a, out)
    return out


def rumble_filter(x, sr, cutoff_hz=80.0):
    cutoff_hz = float(np.clip(cutoff_hz, 20.0, 200.0))
    b, a = sg.butter(2, min(cutoff_hz / (sr / 2.0), 0.99), btype="high")
    return safe_filtfilt(b, a, x)


# --- multiband dynamics (pipeline.py:333-481, 610-641) ---------------------

def split_bands(x, sr, crossovers_hz=MULTIBAND_CROSSOVERS_HZ):
    nyq = sr / 2.0
    f1, f2, f3 = (min(c / nyq, 0.99) for c in crossovers_hz)

    def lp(f):
        return sg.butter(2, f, btype="low")

    def hp(f):
        return sg.butter(2, f, btype="high")

    return [safe_filtfilt(*lp(f1), x),
            safe_filtfilt(*lp(f2), safe_filtfilt(*hp(f1), x)),
            safe_filtfilt(*lp(f3), safe_filtfilt(*hp(f2), x)),
            safe_filtfilt(*hp(f3), x)]


def multiband_dynamics(x, sr, knee_db=6.0, crossovers_hz=None,
                       band_ratios=None, max_upward_boost_db=12.0):
    cross = (crossovers_hz if crossovers_hz and len(crossovers_hz) == 3
             else MULTIBAND_CROSSOVERS_HZ)
    cross = tuple(float(np.clip(c, 20.0, 20000.0)) for c in cross)
    if cross[0] >= cross[1] or cross[1] >= cross[2]:
        cross = MULTIBAND_CROSSOVERS_HZ
    out = np.zeros_like(x)
    for i, band in enumerate(split_bands(x, sr, cross)):
        lim_db, comp_ratio, comp_db, gain = MULTIBAND_CONFIG[i]
        ratio = (float(band_ratios[i])
                 if band_ratios is not None and len(band_ratios) == 4
                 else comp_ratio)
        band = compress_soft_knee(band, threshold_db=comp_db, ratio=ratio,
                                  knee_db=knee_db,
                                  max_upward_boost_db=max_upward_boost_db)
        out = out + limiter(band, threshold_db=lim_db) * gain
    return out


def dynamics(x, sr, knee_db=6.0, crossovers_hz=None, band_ratios=None,
             max_upward_boost_db=12.0):
    """4-band dynamics, maximizer and brickwall (pipeline.py:610-641)."""
    y = multiband_dynamics(x, sr, knee_db, crossovers_hz, band_ratios,
                           max_upward_boost_db)
    return limiter(maximizer(y), threshold_db=TRUE_PEAK_LIMIT_DB)


# --- envelope-based stages (pipeline.py:495-573, 1200-1264, 1628-1797) -----

def envelope_follower(v, sr, attack_sec, release_sec):
    """Attack/release envelope of nonnegative ``v`` [..., N]:
    ``e[0] = v[0]``, ``e[i] = c e[i-1] + (1 - c) v[i]`` with ``c`` the
    attack coefficient where ``v[i] > e[i-1]``, else the release one.

    The recurrence is a contraction: two runs from different start states
    differ, step by step, by at most ``max(att, rel)`` times their gap
    before.  So the sequence is cut into chunks of ``C`` samples that run
    side by side, each from ``W`` samples before its start with a guessed
    state (the sample there, at most 1 from the true state of a signal
    within [0, 1]), where ``max(att, rel) ** W < ENV_FORGET``.  The first
    chunk starts exactly: ``W`` copies of ``v[0]`` ahead of the signal
    keep its state at ``v[0]``."""
    att = math.exp(-1.0 / max(1e-6, sr * attack_sec))
    rel = math.exp(-1.0 / max(1e-6, sr * release_sec))
    v = np.asarray(v, np.float64)
    n = v.shape[-1]
    flat = v.reshape(-1, n)
    rows = flat.shape[0]
    slow = max(att, rel)
    W = (int(math.ceil(math.log(ENV_FORGET) / math.log(slow)))
         if 0.0 < slow < 1.0 else n)
    W = max(1, min(W, n))
    C = max(W // 4, 4096)
    K = -(-n // C)
    padded = np.concatenate([np.repeat(flat[:, :1], W, axis=1), flat,
                             np.zeros((rows, K * C - n))], axis=1)
    # chunk k reads padded[:, k C : k C + W + C]; its step t = W is the
    # signal's sample k C
    win = np.lib.stride_tricks.sliding_window_view(
        padded, W + C, axis=1)[:, ::C][:, :K]
    e = win[:, :, 0].copy()
    out = np.empty((C, rows, K))
    d = np.empty_like(e)
    c = np.empty_like(e)
    mask = np.empty(e.shape, bool)
    for t in range(1, W + C):
        x = win[:, :, t]
        np.subtract(e, x, out=d)
        np.less(d, 0.0, out=mask)
        np.multiply(mask, att - rel, out=c)
        c += rel
        d *= c
        np.add(x, d, out=e)
        if t >= W:
            out[t - W] = e
    # out[j, r, k] is sample k C + j of row r
    return np.moveaxis(out, 0, 2).reshape(rows, K * C)[:, :n].reshape(
        v.shape)


def deesser(x, sr, threshold_db=-6.0, ratio=3.0, freq_lo=5000.0,
            freq_hi=9000.0, attack_ms=4.0, release_ms=85.0):
    """The de-esser: a band-pass sidechain, its envelope, a gain smoothed
    by a 1.5 ms box."""
    nyq = sr / 2.0
    lo_n, hi_n = min(freq_lo / nyq, 0.97), min(freq_hi / nyq, 0.97)
    if lo_n >= hi_n:
        return x
    b, a = sg.butter(2, [lo_n, hi_n], btype="band")
    thresh = db(threshold_db)
    side = safe_filtfilt(b, a, x)
    env = envelope_follower(np.abs(side), sr, attack_ms / 1000.0,
                            release_ms / 1000.0)
    reduction = np.where(env > thresh, thresh + (env - thresh) / ratio, env)
    gain = np.where(env > 1e-10, reduction / (env + 1e-12), 1.0)
    gain = np.clip(gain, 0.35, 1.0)
    k = max(3, int(sr * 0.0015))
    if k % 2 == 0:
        k += 1
    ker = np.ones(k) / float(k)
    gain = np.stack([np.convolve(g, ker, mode="same")
                     for g in np.atleast_2d(gain)])
    gain = np.clip(gain, 0.35, 1.0).reshape(env.shape)
    return x - side + side * gain


def transient_designer(x, sr, attack_gain=1.0, sustain_gain=1.0):
    attack_gain = float(np.clip(attack_gain, 0.1, 3.0))
    sustain_gain = float(np.clip(sustain_gain, 0.1, 3.0))
    if abs(attack_gain - 1.0) < 0.02 and abs(sustain_gain - 1.0) < 0.02:
        return x
    abs_x = np.abs(x)
    fast = envelope_follower(abs_x, sr, 0.0005, 0.005)
    slow = envelope_follower(abs_x, sr, 0.005, 0.1)
    transient = np.maximum(fast - slow, 0.0)
    gain = np.clip((transient * attack_gain + slow * sustain_gain)
                   / (fast + 1e-12), 0.0, 4.0)
    return np.clip(x * gain, -1.0, 1.0)


def dynamic_eq(x, sr, bands=DYNAMIC_EQ_MASTERING_BANDS):
    """The reference's dynamic EQ, with the evident intent of its bell: a
    stable ``iirpeak`` of quality ``q`` (the reference passes a bandwidth
    where SciPy takes a quality; the port and its JAX original do the
    same)."""
    nyq = sr / 2.0
    out = np.array(x, copy=True)
    orig = out.copy()
    for band in bands:
        freq = float(band.get("freq", 1000))
        q = float(band.get("q", 1.4))
        threshold_db = float(band.get("threshold_db", -12))
        ratio = float(band.get("ratio", 3.0))
        attack_ms = float(band.get("attack_ms", 5))
        release_ms = float(band.get("release_ms", 80))
        max_cut_db = float(band.get("max_cut_db", -6))
        if freq <= 0 or freq >= nyq * 0.98:
            continue
        w0 = float(np.clip(freq / nyq, 0.001, 0.98))
        b, a = sg.iirpeak(w0, max(q, 0.1))
        thresh = db(threshold_db)
        max_cut = db(max_cut_db)
        band_sig = _scrub(safe_filtfilt(b, a, out), 0.0, 0.0, 0.0)
        env = _scrub(envelope_follower(np.abs(band_sig), sr,
                                       attack_ms / 1000.0,
                                       release_ms / 1000.0), 0.0, 0.0, 0.0)
        gain = np.where(env > thresh,
                        np.clip((thresh + (env - thresh) / ratio)
                                / (env + 1e-12), max_cut, 1.0), 1.0)
        gain = np.clip(_scrub(gain, 1.0, 1.0, 1.0), 0.3, 1.0)
        out = out - band_sig + band_sig * gain
    out = np.where(np.isfinite(out), out, orig)
    return np.clip(out, -1.0, 1.0)


# --- loudness (BS.1770-4, as the reference's pyloudnorm meter) -------------

def k_weighting_ba(sr):
    """The K-weighting pair (high shelf, high pass) as pyloudnorm designs
    it (pipeline.py:658-664): RBJ biquads that give the ITU table's
    coefficients at 48 kHz."""
    fs = float(sr)
    G, Q, fc = 3.999843853973347, 0.7071752369554196, 1681.974450955533
    K = math.tan(math.pi * fc / fs)
    Vh = 10.0 ** (G / 20.0)
    Vb = Vh ** 0.4996667741545416
    a0 = 1.0 + K / Q + K * K
    shelf = (np.array([(Vh + Vb * K / Q + K * K) / a0,
                       2.0 * (K * K - Vh) / a0,
                       (Vh - Vb * K / Q + K * K) / a0]),
             np.array([1.0, 2.0 * (K * K - 1.0) / a0,
                       (1.0 - K / Q + K * K) / a0]))
    Q, fc = 0.5003270373238773, 38.13547087602444
    K = math.tan(math.pi * fc / fs)
    a0 = 1.0 + K / Q + K * K
    hp = (np.array([1.0, -2.0, 1.0]),
          np.array([1.0, 2.0 * (K * K - 1.0) / a0,
                    (1.0 - K / Q + K * K) / a0]))
    return [shelf, hp]


def gating_blocks(sr, n, block_sec=0.4, step_ratio=0.25):
    """Start and end of every 400 ms gating block at 75 % overlap."""
    T = n / sr
    n_blocks = int(round((T - block_sec) / (block_sec * step_ratio))) + 1
    if n_blocks < 1:
        raise ValueError("audio shorter than one 400 ms gating block")
    j = np.arange(n_blocks)
    lo = (block_sec * (j * step_ratio) * sr).astype(np.int64)
    hi = (block_sec * (j * step_ratio + 1) * sr).astype(np.int64)
    return lo, hi, block_sec * sr


def integrated_lufs(x, sr, q=None):
    """Gated integrated loudness (BS.1770-4) of ``x`` [C, N]; ``q``, where
    given, rounds the K-weighted signal and the block energies (the
    control's meter)."""
    q = q or (lambda a: a)
    y = np.atleast_2d(x)
    for b, a in k_weighting_ba(sr):
        y = sg.lfilter(b, a, y, axis=-1)
    y = q(y)
    lo, hi, div = gating_blocks(sr, y.shape[-1])
    C = y.shape[0]
    g = np.array([1.0, 1.0, 1.0, 1.41, 1.41][:C] if C <= 5 else [1.0] * C)
    cs = np.concatenate([np.zeros((C, 1)), np.cumsum(y * y, axis=-1)], axis=-1)
    hi_c = np.minimum(hi, y.shape[-1])
    z = q((cs[:, hi_c] - cs[:, lo]) / div)
    l_j = -0.691 + 10.0 * np.log10(np.maximum(g @ z, 1e-30))
    m1 = l_j > -70.0
    if not m1.any():
        return float("-inf")
    z1 = z[:, m1].mean(axis=1)
    gamma_r = -0.691 + 10.0 * np.log10(max(float(g @ z1), 1e-30)) - 10.0
    m2 = m1 & (l_j > gamma_r)
    if not m2.any():
        return float("-inf")
    z2 = z[:, m2].mean(axis=1)
    return float(-0.691 + 10.0 * np.log10(max(float(g @ z2), 1e-30)))


def normalize_lufs(x, sr, target_lufs, q=None):
    loud = integrated_lufs(x, sr, q)
    if not np.isfinite(loud):
        return x
    return x * db(float(np.clip(target_lufs - loud, -20.0, 20.0)))
