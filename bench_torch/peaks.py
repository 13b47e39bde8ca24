"""Peaks of one NVIDIA H100 SXM and the least time a piece of work needs.

Copied from ``chip_smoke.py`` (``PEAK_BYTES, PEAK_F32, PEAK_F64`` at line
269, ``_bound_ms`` at lines 662-668), so that a later change to the
program's scripts cannot move the benchmark's yardstick.  The peaks are
NVIDIA's data sheet at 700 W: HBM3 bandwidth, float32 outside the tensor
cores (TF32 is not IEEE float32), float64 on the FP64 tensor cores.
"""

from __future__ import annotations

PEAK_BYTES, PEAK_F32, PEAK_F64 = 3.35e12, 67e12, 67e12


def least_s(nbytes: float, flops: float, peak_flops: float) -> float:
    """The least time in seconds: the larger of the bytes over the memory
    rate and the operations over the peak rate of their type."""
    return max(nbytes / PEAK_BYTES, flops / peak_flops)


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    """(the least time in ms, what bounds it), as ``_bound_ms`` returns."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")
