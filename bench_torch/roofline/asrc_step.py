"""K2, the drifting-ratio ASRC step (``csrc/asrc_step.cu`` ``<float,
false>``), counted as ``chip_smoke.py:1538-1543`` counts a call: each valid
output is the two-phase dot, 4 operations a tap; the bytes are the history
read and written, the input, the phase bank, the outputs at the call's
capacity and 20 bytes a stream of scalars."""

from __future__ import annotations

from .. import peaks


def counts(*, streams: int, hist: int, inputs: int, bank_rows: int,
           taps: int, k_max: int, valid_outputs: int, itemsize: int = 4):
    """(bytes, operations) of one call of ``inputs`` frames a stream."""
    nbytes = itemsize * (2 * streams * hist + streams * inputs
                         + bank_rows * taps + streams * k_max) + 20 * streams
    return nbytes, 4 * valid_outputs * taps


def least_s(**shape) -> float:
    return peaks.least_s(*counts(**shape), peaks.PEAK_F32)
