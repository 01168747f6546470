"""Behavioral constants of the mastering chain and the v2 job.

A copy of the values in ``amw_tpu/constants.py`` that the ported stages
read (the port imports nothing of the JAX package).  They are the
behavioral specification of the mastering service and must stay equal to
the JAX package's values so presets sound identical; the tests compare
them.
"""

# Platform loudness targets (integrated LUFS).
PRESET_LUFS = {
    "spotify": -14.0,
    "youtube": -14.0,
    "apple": -16.0,
    "club": -9.0,
    "broadcast": -24.0,
}

# Genre styles: target LUFS + 5-band EQ offsets (dB) + dynamics/exciter/imager knobs.
STYLE_CONFIGS = {
    "standard":    {"lufs": -14.0, "sub":  0.0, "bass":  0.0, "mids":  0.0, "presence":  0.0, "air":  0.0, "comp_mult": 1.0,  "exciter_db": 0.0, "imager_width": 1.0,  "parallel_mix": 0.0},
    "edm":         {"lufs":  -9.0, "sub":  1.8, "bass":  0.9, "mids": -0.3, "presence":  0.6, "air":  0.9, "comp_mult": 1.3,  "exciter_db": 0.6, "imager_width": 1.25, "parallel_mix": 0.3},
    "hiphop":      {"lufs": -13.0, "sub":  1.4, "bass":  0.7, "mids":  0.5, "presence":  0.3, "air":  0.2, "comp_mult": 1.2,  "exciter_db": 0.3, "imager_width": 1.1,  "parallel_mix": 0.35},
    "classical":   {"lufs": -18.0, "sub": -0.5, "bass":  0.0, "mids":  0.0, "presence":  0.3, "air":  0.6, "comp_mult": 0.45, "exciter_db": 0.0, "imager_width": 1.05, "parallel_mix": 0.0},
    "podcast":     {"lufs": -16.0, "sub": -1.2, "bass": -0.4, "mids":  0.9, "presence":  0.7, "air":  0.0, "comp_mult": 1.1,  "exciter_db": 0.0, "imager_width": 1.0,  "parallel_mix": 0.2},
    "lofi":        {"lufs": -18.0, "sub":  0.4, "bass":  0.6, "mids": -0.6, "presence": -1.0, "air": -1.8, "comp_mult": 0.65, "exciter_db": 0.2, "imager_width": 0.9,  "parallel_mix": 0.0},
    "house_basic": {"lufs": -10.0, "sub":  1.8, "bass":  0.9, "mids": -0.5, "presence":  0.8, "air":  1.0, "comp_mult": 1.35, "exciter_db": 0.8, "imager_width": 1.3,  "parallel_mix": 0.3},
    "dry_vocal":   {"lufs": -14.0, "sub":  0.0, "bass":  0.0, "mids":  0.0, "presence":  0.0, "air":  0.0, "comp_mult": 1.0,  "exciter_db": 0.0, "imager_width": 1.0,  "parallel_mix": 0.0},
}

# Inter-sample (true peak) safety ceiling for the brickwall limiter.
TRUE_PEAK_LIMIT_DB = -1.5

# Multiband dynamics: crossovers and per-band (limiter_db, ratio, thresh_db, gain).
MULTIBAND_CROSSOVERS_HZ = (214.0, 3500.0, 10000.0)
MULTIBAND_CONFIG = (
    (-7.2,  1.0,  -7.2,  1.5),
    (-18.5, 2.2,  -18.5, 1.8),
    (-17.0, 1.55, -17.0, 1.65),
    (-15.0, 1.35, -15.0, 1.2),
)
# Per-band compressor ballistics used by the envelope-compressor path
# (reference: pedalboard attack/release selection, pipeline.py:452-456).
MULTIBAND_ATTACK_RELEASE_MS = (
    (10.0, 80.0),
    (10.0, 80.0),
    (12.0, 130.0),
    (18.0, 180.0),
)

MAXIMIZER_THRESHOLD_DB = -2.5
MAXIMIZER_MARGIN_DB = -0.3
FINAL_TRIM_DB = 0.5

# Spectral denoiser presets: name -> (strength, noise_percentile).
DENOISE_PRESETS = {
    "vocal": (0.15, 25.0),
    "light": (0.20, 22.0),
    "medium": (0.5, 15.0),
    "aggressive": (0.75, 10.0),
    "tape_hiss": (0.25, 22.0),
    "room_tone": (0.40, 18.0),
}

# Default 8-band dynamic EQ preset for mastering.
DYNAMIC_EQ_MASTERING_BANDS = (
    {"freq":   120, "q": 1.0, "threshold_db": -14, "ratio": 2.0, "attack_ms": 10, "release_ms": 100, "max_cut_db": -4},
    {"freq":   250, "q": 1.2, "threshold_db": -12, "ratio": 2.5, "attack_ms":  8, "release_ms":  80, "max_cut_db": -5},
    {"freq":   400, "q": 1.0, "threshold_db": -12, "ratio": 2.0, "attack_ms":  8, "release_ms":  80, "max_cut_db": -4},
    {"freq":   800, "q": 1.2, "threshold_db": -12, "ratio": 2.0, "attack_ms":  5, "release_ms":  60, "max_cut_db": -4},
    {"freq":  2500, "q": 1.4, "threshold_db": -12, "ratio": 2.5, "attack_ms":  5, "release_ms":  60, "max_cut_db": -5},
    {"freq":  5000, "q": 1.4, "threshold_db": -14, "ratio": 3.0, "attack_ms":  3, "release_ms":  50, "max_cut_db": -6},
    {"freq":  8000, "q": 1.2, "threshold_db": -16, "ratio": 4.0, "attack_ms":  2, "release_ms":  40, "max_cut_db": -8},
    {"freq": 12000, "q": 0.8, "threshold_db": -18, "ratio": 2.0, "attack_ms":  5, "release_ms":  60, "max_cut_db": -4},
)

# Schroeder reverb presets:
# name -> (decay_sec, comb_delays_ms, comb_gains, allpass_delays_ms, allpass_gains)
REVERB_PRESETS = {
    "plate":     (1.2, (29, 37, 41, 53),    (0.7, 0.65, 0.6, 0.55),     (5, 7),   (0.5, 0.4)),
    "room":      (0.6, (23, 31, 43, 47),    (0.5, 0.45, 0.4, 0.35),     (3, 5),   (0.4, 0.3)),
    "hall":      (2.2, (47, 53, 61, 71),    (0.75, 0.7, 0.65, 0.6),     (8, 11),  (0.5, 0.45)),
    "theater":   (3.5, (59, 67, 73, 83),    (0.78, 0.73, 0.68, 0.63),   (10, 14), (0.52, 0.45)),
    "cathedral": (5.0, (97, 103, 109, 127), (0.82, 0.78, 0.74, 0.7),    (15, 19), (0.55, 0.48)),
}

# The high-frequency trim's crossover and high-band gain (pipeline.py:1701-1702).
HIGH_FREQ_TRIM_CROSSOVER_HZ = 5000.0
HIGH_FREQ_TRIM_GAIN = 0.9

# Crossovers used by the *default v2 chain config* (chain.py:116,121) — kept
# distinct from the v1 pipeline crossovers on purpose (documented drift).
DEFAULT_CHAIN_CROSSOVERS_HZ = (214.0, 2230.0, 10000.0)
