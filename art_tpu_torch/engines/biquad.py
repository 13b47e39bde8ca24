"""Biquad-style IIR filters, 1st through 4th order.

Port of the reference biquad library (reference biquad.[ch]): direct-form-I
sections with the gain folded into the feed-forward coefficients, Butterworth
lowpass/highpass designers (Q = sqrt(0.5), bilinear K = tan(pi*f)), and two
application orders that the reference distinguishes:

  - ``apply_sample`` sums oldest-term-first (reference biquad.c:78-102) —
    this is the exact op order the decimator's noise shaper depends on,
  - ``apply_buffer`` sums newest-term-first (reference biquad.c:106-163) —
    the order used by the ART CLI's cascaded pre/post filters.

Terms above the filter's order have zero coefficients, and adding 0.0 is
exact in IEEE arithmetic, so both paths evaluate all four taps generically
and still reproduce the reference's per-order specializations bit-for-bit.

The recurrence is sequential by nature; the scalar path here is the parity
reference.  The native runtime (art_tpu/native) provides the fast host path;
ops/biquad_kernel.py provides the device path (companion-matrix
associative_scan, O(log n) depth); and the decimator's noise-shaper runs the
same recurrence as a lax.scan with exact op order
(ops/decimate_kernel.quantize_shaped_jax).

A copy of ``art_tpu/engines/biquad.py``, unchanged, so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np


@dataclass
class BiquadCoefficients:
    a0: float = 0.0
    a1: float = 0.0
    a2: float = 0.0
    a3: float = 0.0
    a4: float = 0.0
    b1: float = 0.0
    b2: float = 0.0
    b3: float = 0.0
    b4: float = 0.0


def biquad_lowpass(frequency: float) -> BiquadCoefficients:
    """2nd-order Butterworth lowpass (reference biquad.c:18-30)."""
    q = math.sqrt(0.5)
    k = math.tan(math.pi * frequency)
    norm = 1.0 / (1.0 + k / q + k * k)
    a0 = k * k * norm
    return BiquadCoefficients(a0=a0, a1=2 * a0, a2=a0,
                              b1=2.0 * (k * k - 1.0) * norm,
                              b2=(1.0 - k / q + k * k) * norm)


def biquad_highpass(frequency: float) -> BiquadCoefficients:
    """2nd-order Butterworth highpass (reference biquad.c:34-46)."""
    q = math.sqrt(0.5)
    k = math.tan(math.pi * frequency)
    norm = 1.0 / (1.0 + k / q + k * k)
    return BiquadCoefficients(a0=norm, a1=-2.0 * norm, a2=norm,
                              b1=2.0 * (k * k - 1.0) * norm,
                              b2=(1.0 - k / q + k * k) * norm)


@dataclass
class Biquad:
    """One filter instance; ``channels`` state lanes run in lockstep."""
    a: np.ndarray = field(default=None)    # [5] feed-forward (gain folded)
    b: np.ndarray = field(default=None)    # [5] feedback (b[0] unused)
    xh: np.ndarray = field(default=None)   # [4, channels] newest-first
    yh: np.ndarray = field(default=None)
    order: int = 1

    @classmethod
    def init(cls, coeffs: BiquadCoefficients, gain: float = 1.0,
             channels: int = 1, dtype=np.float32) -> "Biquad":
        """Mirror of biquad_init: coefficients stored at data-path precision
        with gain folded into the a side (reference biquad.c:51-74)."""
        dt = np.dtype(dtype)
        # the reference stores coefficients in artsample_t, so the products
        # coeffs.aN * gain round through the storage dtype
        ca = np.array([coeffs.a0, coeffs.a1, coeffs.a2, coeffs.a3, coeffs.a4],
                      dtype=dt)
        a = (ca.astype(np.float64) * gain).astype(dt)
        b = np.array([0.0, coeffs.b1, coeffs.b2, coeffs.b3, coeffs.b4],
                     dtype=dt)
        cb = np.array([coeffs.a4, coeffs.b4, coeffs.a3, coeffs.b3,
                       coeffs.a2, coeffs.b2], dtype=dt)
        if cb[0] != 0.0 or cb[1] != 0.0:
            order = 4
        elif cb[2] != 0.0 or cb[3] != 0.0:
            order = 3
        elif cb[4] != 0.0 or cb[5] != 0.0:
            order = 2
        else:
            order = 1
        return cls(a=a, b=b, xh=np.zeros((4, channels), dtype=dt),
                   yh=np.zeros((4, channels), dtype=dt), order=order)

    def copy(self) -> "Biquad":
        return Biquad(a=self.a.copy(), b=self.b.copy(), xh=self.xh.copy(),
                      yh=self.yh.copy(), order=self.order)

    def apply_sample(self, x):
        """Single-sample path, oldest-term-first sum order
        (reference biquad.c:78-102).  x: scalar or [channels]."""
        a, b, xh, yh = self.a, self.b, self.xh, self.yh
        xv = np.broadcast_to(np.asarray(x, dtype=xh.dtype),
                             (xh.shape[1],)).copy()
        s = xv * a[0]
        s = s + (xh[3] * a[4] - b[4] * yh[3])
        s = s + (xh[2] * a[3] - b[3] * yh[2])
        s = s + (xh[1] * a[2] - b[2] * yh[1])
        s = s + (xh[0] * a[1] - b[1] * yh[0])
        self.xh = np.concatenate([xv[None], xh[:3]])
        self.yh = np.concatenate([s[None], yh[:3]])
        return s

    def apply_buffer(self, buffer: np.ndarray, *,
                     use_native: bool = True) -> np.ndarray:
        """Buffer path, newest-term-first sum order
        (reference biquad.c:106-163).  buffer: [n] or [n, channels];
        processed in place semantics — returns the filtered buffer.

        Uses the native runtime when available (bit-identical, strict IEEE
        build); the Python loop below is the fallback/parity reference."""
        if use_native:
            from .. import native
            if native.available():
                return native.biquad_buffer(
                    self, np.asarray(buffer, dtype=self.a.dtype))
        a, b = self.a, self.b
        xh, yh = self.xh, self.yh
        buf = np.asarray(buffer)
        squeeze = buf.ndim == 1
        if squeeze:
            buf = buf[:, None]
        out = np.empty_like(buf)
        for n in range(buf.shape[0]):
            x = buf[n]
            s = x * a[0]
            s = s + (xh[0] * a[1])
            s = s - (b[1] * yh[0])
            s = s + (xh[1] * a[2])
            s = s - (b[2] * yh[1])
            s = s + (xh[2] * a[3])
            s = s - (b[3] * yh[2])
            s = s + (xh[3] * a[4])
            s = s - (b[4] * yh[3])
            xh = np.concatenate([x[None], xh[:3]])
            yh = np.concatenate([s[None], yh[:3]])
            out[n] = s
        self.xh, self.yh = xh, yh
        return out[:, 0] if squeeze else out


def apply_cascade(biquads, buffer: np.ndarray, *,
                  use_native: bool = True) -> np.ndarray:
    """Apply a cascade of buffer-order biquads (the CLI's -p lowpass pair,
    reference art.c:1011-1017) in one fused native pass when available;
    bit-identical to chaining apply_buffer per stage (each stage of a sample
    reads only the finalized previous-stage output, so fusing the buffer
    passes reorders no arithmetic).  Mutates every biquad's state."""
    if use_native and len(biquads) > 1:
        from .. import native
        if native.available():
            return native.biquad_cascade(
                biquads, np.asarray(buffer, dtype=biquads[0].a.dtype))
    out = buffer
    for bq in biquads:
        out = bq.apply_buffer(out, use_native=use_native)
    return out
