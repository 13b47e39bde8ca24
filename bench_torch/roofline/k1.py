"""K1, the fixed-ratio contraction (``csrc/fixed_step.cu`` ``<float,
float>``), counted as ``chip_smoke.py:634-639`` counts a chunk: each output
needs the ``taps`` taps of its phase's filter (the structural zeros of the
phase-anchor matrix P are not counted), and the bytes are the history read
and written, the input, P and the outputs of every block."""

from __future__ import annotations

from .. import peaks


def counts(*, channels: int, hist: int, inputs: int, p_rows: int, L: int,
           blocks: int, outputs: int, taps: int, itemsize: int = 4):
    """(bytes, operations) of one launch over ``inputs`` frames a channel
    that emits ``outputs`` frames in ``blocks`` blocks of L."""
    nbytes = itemsize * (2 * channels * hist + channels * inputs
                         + p_rows * L + channels * blocks * L)
    return nbytes, 2 * channels * outputs * taps


def least_s(**shape) -> float:
    return peaks.least_s(*counts(**shape), peaks.PEAK_F32)
