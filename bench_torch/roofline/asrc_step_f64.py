"""K4, the drifting-ratio ASRC step's float64 instance
(``csrc/asrc_step.cu`` ``<double, false>``): ``asrc_step.counts`` at 8
bytes an item (history, input, phase bank and outputs in float64), its
operations at the plain FP64 rate of the card, ``k1_f64.PEAK_F64_PLAIN``:
K4's dots are DFMA chains on the CUDA cores, not the FP64 tensor cores'
``mma`` that ``peaks.PEAK_F64`` rates."""

from __future__ import annotations

from .. import peaks
from . import asrc_step
from .k1_f64 import PEAK_F64_PLAIN


def counts(**shape):
    """(bytes, operations) of one call, as ``asrc_step.counts`` at 8
    bytes."""
    return asrc_step.counts(**shape, itemsize=8)


def least_s(**shape) -> float:
    return peaks.least_s(*counts(**shape), PEAK_F64_PLAIN)
