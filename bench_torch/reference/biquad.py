"""Plain reference of art's ``-p`` filter: a cascade of 2nd-order
Butterworth lowpass sections (reference biquad.c:18-30; art.c:847-876 runs
two, each on the one before's output), in the precision it is given.

A section computes y_t = a0 x_t + a1 x_{t-1} + a2 x_{t-2} - b1 y_{t-1}
- b2 y_{t-2}.  From a zero state at the stream's start the cascade is
linear and time-invariant, so its output is the causal convolution of the
stream with the cascade's impulse response h.  ``impulse`` takes h from
the sections' difference equations for W samples; ``apply`` applies it as
a causal FIR of W taps (one ``conv1d`` with the flipped response) over
frames that start W before the first output wanted (zeros before the
stream's start).

The truncation at W is this reference's one departure from the
recurrence.  Both sections have their poles at radius r = sqrt(b2) (0.6813
for the lowpass at 0.4134375 of the rate, 48k -> 44.1k), so h decays as
k r^k, and the sum of |h_k| over k >= W = 256 lies below W r^W = 5.6e-41:
each output differs from the recurrence's by less than that times the
input's largest magnitude (``tests/test_torch_chain_f64.py`` holds the
bound).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

W = 256


def lowpass(frequency: float, gain: float = 1.0) -> tuple:
    """(a0, a1, a2, b1, b2) of the 2nd-order Butterworth lowpass at
    ``frequency`` of the sample rate (Q = sqrt(1/2), bilinear k = tan(pi
    f)), the gain folded into a."""
    q = math.sqrt(0.5)
    k = math.tan(math.pi * frequency)
    norm = 1.0 / (1.0 + k / q + k * k)
    a0 = k * k * norm
    return (a0 * gain, 2 * a0 * gain, a0 * gain, 2.0 * (k * k - 1.0) * norm,
            (1.0 - k / q + k * k) * norm)


def impulse(sections, taps: int = W, dtype=torch.float64,
            device="cpu") -> torch.Tensor:
    """[taps]: the cascade's response to a unit impulse at frame 0, each
    section's recurrence run in ``dtype`` on the one before's output."""
    x = torch.zeros(taps, dtype=dtype)
    x[0] = 1.0
    for a0, a1, a2, b1, b2 in sections:
        a0, a1, a2, b1, b2 = (torch.tensor(c, dtype=dtype)
                              for c in (a0, a1, a2, b1, b2))
        y = torch.zeros_like(x)
        for t in range(taps):
            s = a0 * x[t]
            if t >= 1:
                s = s + a1 * x[t - 1] - b1 * y[t - 1]
            if t >= 2:
                s = s + a2 * x[t - 2] - b2 * y[t - 2]
            y[t] = s
        x = y
    return x.to(device)


def apply(raw: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """[C, n]: the cascade's outputs at frames [a, a + n) of the stream,
    from ``raw`` [C, W + n], its frames [a - W, a + n), in h's type."""
    return F.conv1d(raw.to(h.dtype)[:, None],
                    h.flip(0)[None, None])[:, 0, 1:]
