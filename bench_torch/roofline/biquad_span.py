"""B1, one second-order section of art's ``-p`` cascade (``csrc/biquad.cu``
``biquad_span_kernel<T>``): each of the group's samples read once and its
output written once, in float64, plus the section's states (xh, yh in and
out, 4 x streams float64 each), at the memory's rate; its multiply-adds,
2 x (order + 1 taps forward + order taps back) operations a sample (10
for a biquad), at the plain FP64 rate take about a sixteenth of that
time.  One launch is one section."""

from __future__ import annotations

from .. import peaks
from .k1_f64 import PEAK_F64_PLAIN

ORDER = 2                   # each of the -p cascade's sections is a biquad


def counts(*, frames: int, streams: int, itemsize: int = 8):
    """(bytes, operations) of one section over ``frames`` frames of
    ``streams`` streams."""
    samples = frames * streams
    return (2 * itemsize * samples + 4 * 8 * 4 * streams,
            2 * (2 * ORDER + 1) * samples)


def least_s(**shape) -> float:
    return peaks.least_s(*counts(**shape), PEAK_F64_PLAIN)
