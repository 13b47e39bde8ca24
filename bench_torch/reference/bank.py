"""The windowed-sinc phase bank of the C reference (resampler.c:1090-1132
and 154-168), in float64: filter ``i`` of ``F`` is the sinc of tap
distance ``(taps/2 - 1) + i/F - t``, folded with the lowpass ratio, times
a 4-term Blackman-Harris window, scaled to a DC gain of 1; row ``F`` is
row 0 moved one tap later; taps ``[0, taps-1]`` and ``[F, 0]`` are zero."""

from __future__ import annotations

import math

import torch

_BH = (0.35875, 0.48829, 0.14128, 0.01168)


def phase_bank(taps: int, F: int, *, lowpass: float = 1.0,
               device="cpu") -> torch.Tensor:
    """[F + 1, taps] float64."""
    half = taps // 2
    t = torch.arange(taps, dtype=torch.float64, device=device)
    frac = torch.arange(F, dtype=torch.float64, device=device)[:, None] / F
    dist = torch.abs((half - 1) + frac - t) * math.pi
    arg = dist * lowpass
    sinc = torch.where(arg == 0, torch.ones_like(arg),
                       torch.sin(arg) / torch.where(arg == 0, 1.0, arg))
    r = dist / half
    window = (_BH[0] + _BH[1] * torch.cos(r) + _BH[2] * torch.cos(2 * r)
              + _BH[3] * torch.cos(3 * r))
    h = torch.where(dist == 0, torch.ones_like(dist), sinc * window)
    h = h / h.sum(dim=1, keepdim=True)
    bank = torch.cat([h, torch.roll(h[:1], 1, dims=1)])
    bank[0, taps - 1] = 0.0
    bank[F, 0] = 0.0
    return bank


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32 (10 mantissa bits, to nearest, ties away from
    zero as the tensor cores' conversion does), as float32."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)
