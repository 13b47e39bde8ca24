"""Plain reference of a reduced fixed-ratio configuration (L output
phases for every M input frames, L and M coprime), float64.

Output k of the stream lies at input position k*M/L (the first output at
frame 0, once the engine has been advanced by half a filter): its phase
is (M*k) mod L, and its ``taps`` taps start at floor(M*k/L) - (taps/2 - 1)
(resampler.c:1039, subsample_no_interpolate with the reduced bank).  It
is emitted once floor(k*M/L) < N - taps/2, N the frames taken in
(resampler.c:494-529)."""

from __future__ import annotations

import torch

from .bank import tf32


def emitted(N: int, *, L: int, M: int, taps: int) -> tuple[int, bool]:
    """(outputs emitted once N input frames are in, whether the next
    output lies exactly on the bound: a rounding tie of the C reference's
    float64 compare, after which either count is its)."""
    B = N - taps // 2
    if B <= 0:
        return 0, False
    return -(-(L * B) // M), (L * B) % M == 0


def phase_matrix(bank: torch.Tensor, *, L: int, M: int) -> torch.Tensor:
    """[M + taps - 1, L]: column r holds the filter of output r of a block
    of L, at the rows of its taps within the block's window."""
    taps = bank.shape[1]
    r = torch.arange(L, device=bank.device)
    rows = ((M * r) // L)[:, None] + torch.arange(taps, device=bank.device)
    Pt = torch.zeros((L, M + taps - 1), dtype=bank.dtype, device=bank.device)
    Pt.scatter_(1, rows, bank[(M * r) % L])
    return Pt.T


def window_span(k0: int, k1: int, *, L: int, M: int, taps: int):
    """Input frames [a, b) that outputs k0..k1-1 read, whole blocks of L."""
    b0, b1 = k0 // L, -(-k1 // L)
    a = M * b0 - (taps // 2 - 1)
    return a, M * (b1 - 1) - (taps // 2 - 1) + M + taps - 1


def outputs(seg: torch.Tensor, seg_start: int, k0: int, k1: int, *, L: int,
            M: int, bank: torch.Tensor, control: bool = False,
            rows: int = 1 << 15) -> torch.Tensor:
    """[C, k1 - k0] float64: outputs k0..k1-1, from ``seg`` [C, n], the
    stream's frames from ``seg_start`` on, covering ``window_span``."""
    taps = bank.shape[1]
    width = M + taps - 1
    P = phase_matrix(bank, L=L, M=M)
    if control:
        P = tf32(P)
    b0, b1 = k0 // L, -(-k1 // L)
    ys = []
    for bb in range(b0, b1, rows):
        nb = min(rows, b1 - bb)
        s = M * bb - (taps // 2 - 1) - seg_start
        if s < 0 or s + M * (nb - 1) + width > seg.shape[1]:
            raise ValueError("the segment does not cover the outputs")
        W = seg[:, s:s + M * (nb - 1) + width].unfold(1, width, M)
        y = (tf32(W) @ P).double() if control else W @ P
        ys.append(y.reshape(seg.shape[0], nb * L))
    return torch.cat(ys, dim=1)[:, k0 - b0 * L:k1 - b0 * L]
