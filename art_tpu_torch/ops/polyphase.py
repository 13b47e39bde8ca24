"""The phase-anchor block matrix of the fixed-ratio streaming engine.

For a reduced fixed-ratio resampler (num_filters == L, ratio == L/M after
gcd reduction, reference resampler.c:310-356) with a snap-aligned offset,
output l of every L-output block uses phase (j0 + l*M) mod L and a window
shifted by carry(l) = (j0 + l*M) // L input samples, and each block consumes
exactly M inputs.  Folding the phase bank into a dense [L, M + T] matrix
turns the steady state into one contraction per block (kernel K1).  The
reference's passthrough shortcut (allpass + integer phase returns the raw
sample, reference resampler.c:1141-1142) becomes a one-hot row.

``PolyphaseMatrix`` is a copy of the numpy body of
``art_tpu/ops/polyphase.py::PolyphaseMatrix`` without its ``device()``
upload (which imports jax): the matrices are bitwise equal to the JAX
engine's (tests/test_torch_host.py).  ``PolyphaseKernel`` is the
counterpart of JAX's, the host ``Resampler(backend="torch")``'s fast path
for reduced fixed ratios: its anchoring is JAX's, and the stride-M
convolution JAX runs as ``conv_general_dilated`` is one launch of K1
(``ops/fixed_step.py::fixed_step_window``) over P's transpose, zero-padded
to qn*M rows, on the device the caller names.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .fixed_step import fixed_step_window


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


class PolyphaseKernel:
    """Caches per-anchor matrices, and their K1 operands on the device, for
    an engine instance."""

    def __init__(self, bank: np.ndarray, num_filters: int,
                 include_lowpass: bool, ratio: float, *, device):
        self.bank = bank
        self.L = num_filters
        self.include_lowpass = include_lowpass
        # recover M from the ratio (ratio == L/M exactly by construction)
        self.M = int(round(self.L / ratio))
        self.device = torch.device(device)
        self._mats: dict[int, PolyphaseMatrix] = {}
        self._dev: dict[tuple, torch.Tensor] = {}

    def matrix(self, j0: int) -> PolyphaseMatrix:
        m = self._mats.get(j0)
        if m is None:
            m = PolyphaseMatrix(self.bank, self.L, self.M, j0,
                                self.include_lowpass)
            self._mats[j0] = m
        return m

    def eligible(self, output_offset: float, n_positions: int) -> bool:
        """Usable when the offset fraction sits on the 1/L grid (always true
        after a snap-offset call or at init) and the call is big enough to
        amortize."""
        if self.L < 2 or n_positions < 4 * self.L:
            return False
        frac = output_offset - math.floor(output_offset)
        j0 = round(frac * self.L)
        return abs(frac * self.L - j0) < 1e-9

    def operand(self, j0: int, dtype) -> torch.Tensor:
        """K1's [qn*M, L] operand of anchor j0 on the device: P.T with
        zero rows past S = M + T, qn = ceil(S / M)."""
        key = (j0, np.dtype(dtype).name)
        Pt = self._dev.get(key)
        if Pt is None:
            mat = self.matrix(j0)
            qn = -(-mat.S // mat.M)
            host = np.zeros((qn * mat.M, mat.L), dtype=dtype)
            host[:mat.S] = mat.P.T
            Pt = self._dev[key] = torch.from_numpy(host).to(self.device)
        return Pt

    def apply(self, Lbuf: np.ndarray, output_offset: float, K: int,
              dtype) -> np.ndarray:
        """Compute K outputs starting at position output_offset over Lbuf."""
        T = self.bank.shape[1]
        half = T // 2
        ipos0 = math.floor(output_offset)
        j0 = round((output_offset - ipos0) * self.L) % self.L
        if round((output_offset - ipos0) * self.L) == self.L:
            ipos0 += 1
        mat = self.matrix(j0)
        L, M, S = mat.L, mat.M, mat.S
        nb = -(-K // L)
        start = ipos0 - half + 1
        xlen = (nb - 1) * M + S
        ch = Lbuf.shape[0]
        x = np.zeros((ch, xlen), dtype=dtype)
        # defensive (reference defect #5 class, PARITY.md): a window start
        # before the buffer reads leading silence, never a Python
        # negative-index wrapped slice
        src0 = max(0, start)
        dst0 = src0 - start
        avail = min(xlen - dst0, Lbuf.shape[1] - src0)
        if avail > 0:
            x[:, dst0:dst0 + avail] = Lbuf[:, src0:src0 + avail]
        # K1 reads the window past xlen as zero, as P's padded rows are
        Pt = self.operand(j0, dtype)
        out = fixed_step_window(torch.from_numpy(x).to(self.device), Pt, 0,
                                K, M=M, L=L, nb=nb, qn=Pt.shape[0] // M)
        return out[:, :K].cpu().numpy()
