"""Windowed-sinc phase-bank construction and the fixed-ratio planner.

This is the init-time half of the resampler: a pure function from
(num_taps, num_filters, lowpass_ratio, window) to a dense ``[num_filters + 1,
num_taps]`` matrix of FIR phases.  On TPU this matrix lives in VMEM and every
output sample is one (possibly phase-interpolated) row dotted against a
gathered history window.

Behavioral contract follows the reference implementation:
  - phase fraction i/num_filters, sinc with the lowpass folded into its
    argument, 4-term Blackman-Harris or Hann window
    (reference resampler.c:1090-1121),
  - DC gain normalized to unity with a center-out compensated-rounding pass so
    the *stored-precision* tap sum is as close to 1.0 as possible
    (reference resampler.c:1124-1132),
  - one extra filter equal to filter 0 rotated by one tap
    (reference resampler.c:154-159),
  - outlier taps filters[0][T-1] and filters[N][0] forced to zero for
    chunk-size invariance (reference resampler.c:161-168).

The fixed-ratio planner reproduces resampleFixedRatioInit's gcd filter-count
reduction, snap-offset rule and automatic lowpass selection
(reference resampler.c:310-356).

A copy of ``art_tpu/core/filters.py``, unchanged, so that the port imports
nothing of the JAX package; the banks it builds are bitwise equal to the
JAX engines' (tests/test_torch_host.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .flags import (
    INCLUDE_LOWPASS, NO_FILTER_REDUCTION, RESAMPLE_FIXED_RATIO,
    RESAMPLER_SNAP_OFFSET, SUBSAMPLE_INTERPOLATE, validate_taps_filters,
)

# 4-term Blackman-Harris coefficients (reference resampler.c:1093-1096)
_BH_A0 = 0.35875
_BH_A1 = 0.48829
_BH_A2 = 0.14128
_BH_A3 = 0.01168


def make_filter_phase(num_taps: int, fraction: float, lowpass_ratio: float,
                      blackman_harris: bool, dtype=np.float32) -> np.ndarray:
    """Build one FIR phase at the given sub-sample ``fraction`` in [0, 1).

    Returns an array of ``dtype`` whose sum compensates storage rounding so DC
    gain is unity at stored precision (reference resampler.c:1090-1133).
    """
    half = num_taps // 2
    i = np.arange(num_taps, dtype=np.float64)
    dist = np.abs((half - 1) + fraction - i) * math.pi
    ratio = dist / half

    with np.errstate(invalid="ignore", divide="ignore"):
        value = np.sin(dist * lowpass_ratio) / (dist * lowpass_ratio)
    value = np.where(dist == 0.0, 1.0, value)

    if blackman_harris:
        window = (_BH_A0 + _BH_A1 * np.cos(ratio)
                  + _BH_A2 * np.cos(2.0 * ratio) + _BH_A3 * np.cos(3.0 * ratio))
    else:
        window = 0.5 * (1.0 + np.cos(ratio))
    value = np.where(dist == 0.0, 1.0, value * window)

    # Unity-DC normalization with compensated rounding, walking center-out in
    # the same alternating order as the reference so stored values match.
    # cumsum gives strict left-to-right float64 accumulation (same rounding
    # sequence as the reference's scalar summation loop).
    scaler = 1.0 / float(value.cumsum()[-1])
    temp = value * scaler                      # float64 "tempFilter"
    out = np.zeros(num_taps, dtype=dtype)
    error = 0.0
    i = half
    while i < num_taps:
        stored = dtype(temp[i] - error)        # rounds to storage precision
        out[i] = stored
        error += float(stored) - temp[i]
        i = num_taps - i - (1 if i >= half else 0)
    return out


def make_filter_bank(num_taps: int, num_filters: int, lowpass_ratio: float,
                     blackman_harris: bool, dtype=np.float32) -> np.ndarray:
    """Build the full ``[num_filters + 1, num_taps]`` phase bank."""
    validate_taps_filters(num_taps, num_filters)
    dt = np.dtype(dtype).type
    bank = np.zeros((num_filters + 1, num_taps), dtype=dtype)
    for fi in range(num_filters):
        bank[fi] = make_filter_phase(num_taps, fi / num_filters, lowpass_ratio,
                                     blackman_harris, dt)
    # extra filter: filter 0 rotated forward one tap
    bank[num_filters] = np.roll(bank[0], 1)
    # chunk-size-invariance outlier zeroing
    bank[0, num_taps - 1] = 0.0
    bank[num_filters, 0] = 0.0
    return bank


@dataclass(frozen=True)
class FixedRatioPlan:
    """Static configuration resolved by the fixed-ratio planner."""
    num_filters: int
    lowpass_ratio: float     # relative to *source* Nyquist as stored by init
    flags: int               # resolved flag set
    fixed_ratio: float       # destin_rate / source_rate


def plan_fixed_ratio(num_taps: int, max_filters: int, source_rate: float,
                     destin_rate: float, lowpass_freq: float,
                     flags: int) -> FixedRatioPlan:
    """Resolve the fixed-ratio configuration (reference resampler.c:310-356).

    Mirrors: gcd-based filter-count reduction (disables interpolation, arms
    snap-offset for non-power-of-two counts), automatic ~98 dB lowpass for
    downsampling, and the lowpass_ratio * resample_ratio folding.
    """
    if lowpass_freq > destin_rate / 2.0:
        raise ValueError(
            "lowpass frequency must be lower than destination Nyquist!")

    lowpass_ratio = lowpass_freq / (destin_rate / 2.0)
    resample_ratio = destin_rate / source_rate
    num_filters = max_filters

    if (source_rate == math.floor(source_rate)
            and destin_rate == math.floor(destin_rate)
            and not (flags & NO_FILTER_REDUCTION)):
        factor = int(destin_rate) // math.gcd(int(source_rate), int(destin_rate))
        if factor <= max_filters:
            flags &= ~SUBSAMPLE_INTERPOLATE
            num_filters = factor
            if num_filters & (num_filters - 1):
                flags |= RESAMPLER_SNAP_OFFSET

    if not lowpass_freq and (flags & INCLUDE_LOWPASS) and destin_rate < source_rate:
        lowpass_ratio = 1.0 - (7.5 / num_taps / resample_ratio)
        if lowpass_ratio < 0.8:
            lowpass_ratio = 0.8
        if lowpass_ratio < resample_ratio:
            lowpass_ratio = resample_ratio

    return FixedRatioPlan(
        num_filters=num_filters,
        lowpass_ratio=lowpass_ratio * resample_ratio,
        flags=flags | RESAMPLE_FIXED_RATIO,
        fixed_ratio=destin_rate / source_rate,
    )


def resolve_lowpass(lowpass_ratio: float, flags: int) -> tuple[float, int]:
    """Init-time lowpass clamping (reference resampler.c:120-125)."""
    if 0.0 < lowpass_ratio < 1.0:
        return lowpass_ratio, flags | INCLUDE_LOWPASS
    return 1.0, flags & ~INCLUDE_LOWPASS
