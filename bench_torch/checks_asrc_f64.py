"""The comparison that decides ``correct`` for the float64 ASRC cell
(``entries/batched_asrc_f64.py``: config 5's drifting streams on art64's
float64 path).

The numbers are ``checks.asrc``'s, against the same plain float64
reference (``reference/asrc.py``): ``count_mismatch`` over every (call,
stream) pair from the stream's start through ``replay``, exact;
``sample_err`` over the kept calls, the largest gap between an output of
the program and the reference's, over the reference outputs' RMS.

The configuration is float64, so the control is the precision below it,
not ``checks.asrc``'s TF32: the same outputs at the same positions and
counts, with the window, the phase bank, the lerp fraction and the dots
all in float32 (TF32 off).  With ``control`` it takes the program's place
in ``sample_err``, so the run has to come out not correct.
"""

from __future__ import annotations

import torch

from .checks import _Gap, _program
from .reference import asrc as asrc_ref
from .reference.bank import phase_bank


def control_outputs(seg: torch.Tensor, seg_start: int, I, f, r, K,
                    kcols: int, *, bank: torch.Tensor,
                    elems: int = 50_000_000) -> torch.Tensor:
    """[S, kcols] outputs of one call as ``reference/asrc.outputs`` gives
    them, with its float64 positions, and its window, bank, lerp fraction
    and dots in float32; float64, zero from column K on."""
    dev = seg.device
    taps, F = bank.shape[1], bank.shape[0] - 1
    S = seg.shape[0]
    I, f, r, K = (torch.as_tensor(a, device=dev) for a in (I, f, r, K))
    k = torch.arange(kcols, dtype=torch.float64, device=dev)
    out = torch.zeros((S, kcols), dtype=torch.float64, device=dev)
    blk = max(1, elems // max(kcols * taps, 1))
    bank32 = bank.float()
    for s0 in range(0, S, blk):
        sl = slice(s0, min(s0 + blk, S))
        q = f[sl, None] + k / r[sl, None]
        fq = torch.floor(q)
        ff = (q - fq) * F
        fi = torch.clamp(torch.floor(ff), max=F - 1)
        fr = (ff - fi).float()[..., None]
        fi = fi.long()
        valid = k[None, :] < K[sl, None]
        start = I[sl, None] + fq.long() - (taps // 2 - 1) - seg_start
        start = torch.where(valid, start, torch.zeros_like(start))
        rows = seg[sl].unfold(1, taps, 1)
        W = rows[torch.arange(rows.shape[0], device=dev)[:, None],
                 start].float()
        h = bank32[fi] * (1 - fr) + bank32[fi + 1] * fr
        y = (W * h).sum(-1).double()
        out[sl] = torch.where(valid, y, torch.zeros_like(y))
    return out


def asrc_f64(entry, records, log, n: int, ratios_at, control: bool) -> dict:
    """Drifting-ratio float64 streams; ``records`` are (call, outputs [S,
    k_max]) and ``entry.counts`` each call's [S] counts."""
    cfg, dev = entry.cfg, entry.dev
    taps = cfg["num_taps"]
    mismatch, starts = asrc_ref.replay(entry.counts, ratios_at, n, taps=taps,
                                       want={r[0] for r in records})
    bank = phase_bank(taps, cfg["num_filters"],
                      lowpass=cfg["lowpass_ratio"], device=dev)
    if control:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    gap = _Gap()
    for call, out in records:
        I, f, K = starts[call]
        a = n * call - taps
        seg = log.segment(a, n * (call + 1), dev)
        args = (seg, a, I, f, ratios_at(call), K, out.shape[1])
        ref = asrc_ref.outputs(*args, bank=bank)
        got = control_outputs(*args, bank=bank) if control else \
            _program(out, dev)
        gap.add(got, ref, int(K.sum()))
        del got, ref, seg
    return gap.numbers(mismatch)
