"""D1, the flat decimate kernel (``csrc/decimate.cu``
``decimate_flat_kernel<float>``): each sample read once and its packed
bytes written once, an elementwise pass bound by bytes at the memory's
rate (its ~35 operations a sample take less time at the card's
instruction rate)."""

from __future__ import annotations

from .. import peaks


def counts(*, samples: int, out_bytes: int = 2, itemsize: int = 4):
    """(bytes, operations counted against the peak: none) of one launch
    over ``samples`` samples."""
    return (itemsize + out_bytes) * samples, 0


def least_s(**shape) -> float:
    return peaks.least_s(*counts(**shape), peaks.PEAK_F32)
