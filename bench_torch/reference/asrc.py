"""Plain reference of the drifting-ratio ASRC (resampleInit with
SUBSAMPLE_INTERPOLATE, a ratio per call, resampleGetPosition), float64.

Each stream's position is kept as an integer and a fraction, I + f, in
input frames from the stream's start (the first output at frame 0 once
the engine has been advanced by half a filter).  A call of ratio r that
takes n frames emits the outputs I + f + k/r, k = 0, 1, ..., while
floor(I + f + k/r) < N - taps/2, N the frames taken in so far
(resampler.c:494-529), and then moves the position on by K/r.  Output u
is the lerp, by the fraction of frac(u)*F, of the two filters
floor(frac(u)*F) and the next, dotted with the taps from floor(u) -
(taps/2 - 1) (resampler.c:1141-1157)."""

from __future__ import annotations

import numpy as np
import torch

from .bank import tf32

TIE = 1e-9      # an output this close to the bound is a tie of the C
                # reference's float64 compare: either count is its


def replay(counts, ratios_at, n: int, *, taps: int, want=()):
    """Walk the calls' counts and positions from the stream's start.

    ``counts``: the program's [S] counts of each call; ``ratios_at(c)``:
    call c's [S] ratios; ``n``: frames a call.  Returns (the number of
    (call, stream) counts that differ from the reference's, {c: (I, f, K)}
    for each call c in ``want``: the positions at its start and the counts
    it is compared with).  Where the program's count differs from the
    reference's by one at a tie, the program's is taken."""
    half = taps // 2
    S = len(counts[0])
    I = np.zeros(S, np.int64)
    f = np.zeros(S, np.float64)
    mismatch, starts = 0, {}
    for c, Kp in enumerate(counts):
        r = ratios_at(c)
        D = (n * (c + 1) - half - I).astype(np.float64)
        k = np.maximum(np.ceil((D - f) * r), 0).astype(np.int64)
        for _ in range(8):          # the least k with f + k/r >= D
            down = (k > 0) & (f + (k - 1) / r >= D)
            up = f + k / r < D
            if not (down.any() or up.any()):
                break
            k = k - down + up
        near = (np.abs(f + k / r - D) < TIE) | \
            ((k > 0) & (np.abs(f + (k - 1) / r - D) < TIE))
        Kp = np.asarray(Kp, np.int64)
        ok = (Kp == k) | (near & (np.abs(Kp - k) == 1))
        mismatch += int((~ok).sum())
        K = np.where(ok, Kp, k)
        if c in want:
            starts[c] = (I.copy(), f.copy(), K.copy())
        t = K / r
        a = np.floor(t)
        I += a.astype(np.int64)
        f += t - a
        carry = np.floor(f)
        I += carry.astype(np.int64)
        f -= carry
    return mismatch, starts


def outputs(seg: torch.Tensor, seg_start: int, I, f, r, K, kcols: int, *,
            bank: torch.Tensor, control: bool = False,
            elems: int = 50_000_000) -> torch.Tensor:
    """[S, kcols] float64 outputs of one call from positions I + f (numpy
    [S]) at ratios r, zero from column K on; ``seg`` [S, m] holds the
    stream's frames from ``seg_start`` on."""
    dev = seg.device
    taps, F = bank.shape[1], bank.shape[0] - 1
    S = seg.shape[0]
    I = torch.as_tensor(I, device=dev)
    f = torch.as_tensor(f, device=dev)
    r = torch.as_tensor(r, device=dev)
    K = torch.as_tensor(K, device=dev)
    k = torch.arange(kcols, dtype=torch.float64, device=dev)
    out = torch.zeros((S, kcols), dtype=torch.float64, device=dev)
    blk = max(1, elems // max(kcols * taps, 1))
    bank32 = tf32(bank)
    for s0 in range(0, S, blk):
        sl = slice(s0, min(s0 + blk, S))
        q = f[sl, None] + k / r[sl, None]
        fq = torch.floor(q)
        ff = (q - fq) * F
        fi = torch.clamp(torch.floor(ff), max=F - 1)
        fr = ff - fi
        fi = fi.long()
        valid = k[None, :] < K[sl, None]
        start = I[sl, None] + fq.long() - (taps // 2 - 1) - seg_start
        start = torch.where(valid, start, torch.zeros_like(start))
        rows = seg[sl].unfold(1, taps, 1)
        W = rows[torch.arange(rows.shape[0], device=dev)[:, None], start]
        if control:
            W = tf32(W)
            d0 = (W * bank32[fi]).sum(-1)
            d1 = (W * bank32[fi + 1]).sum(-1)
            fr32 = fr.float()
            y = (d0 * (1 - fr32) + d1 * fr32).double()
        else:
            h = bank[fi] * (1 - fr)[..., None] + bank[fi + 1] * fr[..., None]
            y = (W * h).sum(-1)
        out[sl] = torch.where(valid, y, torch.zeros_like(y))
    return out
