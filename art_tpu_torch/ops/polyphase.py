"""The phase-anchor block matrix of the fixed-ratio streaming engine.

For a reduced fixed-ratio resampler (num_filters == L, ratio == L/M after
gcd reduction, reference resampler.c:310-356) with a snap-aligned offset,
output l of every L-output block uses phase (j0 + l*M) mod L and a window
shifted by carry(l) = (j0 + l*M) // L input samples, and each block consumes
exactly M inputs.  Folding the phase bank into a dense [L, M + T] matrix
turns the steady state into one contraction per block (kernel K1).  The
reference's passthrough shortcut (allpass + integer phase returns the raw
sample, reference resampler.c:1141-1142) becomes a one-hot row.

A copy of the numpy body of ``art_tpu/ops/polyphase.py::PolyphaseMatrix``
without its ``device()`` upload (which imports jax): the port uploads the
matrix itself.  The matrices are bitwise equal to the JAX engine's
(tests/test_torch_host.py).
"""

from __future__ import annotations

import numpy as np


class PolyphaseMatrix:
    """Dense block matrix for one (bank, L, M, j0) anchor."""

    def __init__(self, bank: np.ndarray, L: int, M: int, j0: int,
                 include_lowpass: bool):
        T = bank.shape[1]
        half = T // 2
        S = M + T
        P = np.zeros((L, S), dtype=bank.dtype)
        carry = ((j0 + np.arange(L) * M) // L).astype(np.int64)
        phase = ((j0 + np.arange(L) * M) % L).astype(np.int64)
        for l in range(L):
            if not include_lowpass and phase[l] == 0:
                # passthrough: one-hot at the sample under the filter center
                P[l, carry[l] + half - 1] = 1.0
            else:
                P[l, carry[l]:carry[l] + T] = bank[phase[l]]
        self.P = P
        self.L, self.M, self.S, self.T = L, M, S, T
        self.carry = carry
