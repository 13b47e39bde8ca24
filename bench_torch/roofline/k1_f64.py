"""K1's float64 instance (``csrc/fixed_step.cu`` ``<double, double>``):
``k1.counts`` at 8 bytes an item (history, input, P and outputs in
float64), its operations at the plain FP64 rate of the card.

No kernel of the port issues an ``mma``: K1's float64 dots are DFMA
chains on the CUDA cores, so their peak is not ``peaks.PEAK_F64`` (the
FP64 tensor cores' 67 TFLOP/s) but ``PEAK_F64_PLAIN``: 132 SMs x 64 FP64
FMAs a clock x 2 operations x 1.98 GHz = 33.5 TFLOP/s, the H100 SXM data
sheet's 34 TFLOP/s of FP64 (``chip_smoke.py``'s FP64 probe measures the
rate a DFMA loop reaches on the card)."""

from __future__ import annotations

from .. import peaks
from . import k1

PEAK_F64_PLAIN = 132 * 64 * 2 * 1.98e9


def counts(**shape):
    """(bytes, operations) of one launch, as ``k1.counts`` at 8 bytes."""
    return k1.counts(**shape, itemsize=8)


def least_s(**shape) -> float:
    return peaks.least_s(*counts(**shape), PEAK_F64_PLAIN)
