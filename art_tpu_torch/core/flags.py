"""Flag constants, presets and validation for the ART-TPU framework.

These mirror the reference library's init-time bitmask configuration
(reference: resampler.h:28-38, decimator.h:29-40, stretch.h:37-38) so that
configuration written against the C library maps 1:1, but here they are plain
ints consumed by dataclass-style configs rather than compile-time switches.

A copy of ``art_tpu/core/flags.py``, whole and unchanged, so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

# --- resampler flags (reference resampler.h:28-38) ---
SUBSAMPLE_INTERPOLATE = 0x1
BLACKMAN_HARRIS = 0x2
INCLUDE_LOWPASS = 0x4
RESAMPLE_MULTITHREADED = 0x8          # accepted, no-op: XLA schedules channels
NO_FILTER_REDUCTION = 0x10
RESAMPLE_FIXED_RATIO = 0x20           # internal
EXTRAPOLATE_ENDPOINTS = 0x40
EXTRAPOLATE_PREFILL = 0x80            # internal
EXTEND_CONVOLUTION_MATH = 0x100
RESAMPLER_FLUSHED = 0x200             # internal
RESAMPLER_SNAP_OFFSET = 0x400         # internal

# --- decimator flags (reference decimator.h:29-40) ---
DITHER_HIGHPASS = 0x1
DITHER_FLAT = 0x2
DITHER_LOWPASS = 0x4
DITHER_ENABLED = DITHER_HIGHPASS | DITHER_FLAT | DITHER_LOWPASS

SHAPING_1ST_ORDER = 0x100
SHAPING_2ND_ORDER = 0x200
SHAPING_3RD_ORDER = 0x400
SHAPING_ATH_CURVE = 0x800
SHAPING_ENABLED = (SHAPING_1ST_ORDER | SHAPING_2ND_ORDER |
                   SHAPING_3RD_ORDER | SHAPING_ATH_CURVE)

DECIMATE_MULTITHREADED = 0x1000       # accepted, no-op

# --- stretch flags (reference stretch.h:37-38) ---
STRETCH_FAST_FLAG = 0x1
STRETCH_DUAL_FLAG = 0x2

MIN_PERIOD = 24
MAX_PERIOD = 2400

# --- quality presets: (num_filters, num_taps) (reference art.c:151-166) ---
PRESETS = {
    1: (48, 48),
    2: (320, 156),
    3: (380, 380),
    4: (988, 988),
}
DEFAULT_PRESET = 3

# history length is 16x the tap count (reference resampler.c:139)
HISTORY_MULTIPLE = 16


def validate_taps_filters(num_taps: int, num_filters: int) -> None:
    """Validate like resampleInit (reference resampler.c:127-135)."""
    if (num_taps & 3) or num_taps <= 0 or num_taps > 1024:
        raise ValueError("numTaps must be 4-1024 and a multiple of 4")
    if num_filters < 1 or num_filters > 1024:
        raise ValueError("numFilters must be 1-1024")
