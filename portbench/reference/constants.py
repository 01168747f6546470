"""Behavioural constants of the reference service, frozen here so that
the benchmark's reference does not move with the program.  Citations are
into backend/app/pipeline.py and chain.py of the reference service."""

# genre styles (pipeline.py:69-86)
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

# the brickwall limiter's ceiling (pipeline.py:89)
TRUE_PEAK_LIMIT_DB = -1.5

# multiband dynamics (pipeline.py:94, :100-105): crossovers, and per band
# (limiter dB, ratio, threshold dB, make-up gain)
MULTIBAND_CROSSOVERS_HZ = (214.0, 3500.0, 10000.0)
MULTIBAND_CONFIG = (
    (-7.2,  1.0,  -7.2,  1.5),
    (-18.5, 2.2,  -18.5, 1.8),
    (-17.0, 1.55, -17.0, 1.65),
    (-15.0, 1.35, -15.0, 1.2),
)

# the maximizer and the final trim (pipeline.py:107-110)
MAXIMIZER_THRESHOLD_DB = -2.5
MAXIMIZER_MARGIN_DB = -0.3
FINAL_TRIM_DB = 0.5

# the dynamic EQ's mastering preset (pipeline.py:1616-1625)
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
