"""The comparisons that decide ``correct``, shared by the entries.

Each compares what the window produced, at the window's sizes, with the
configuration's plain reference (``reference/``), computed on the run's
device once the program's state is freed:

- ``count_mismatch``: calls (fixed ratio) or (call, stream) pairs (ASRC)
  whose outputs differ in number from the reference's, over every call
  of the run from the stream's start; an exact comparison.
- ``sample_err``: over the kept calls (the window's last two and a
  seed-drawn pair, so the history carried between calls is compared
  too), the largest gap between an output of the program and the
  reference's, as a share of the reference outputs' RMS; padding the
  program zeroes is compared with zero.

With ``control`` the reference computed as a TF32 tensor core would takes
the program's place in ``sample_err``, at the program's positions and
counts, so the run is judged by the same limits and has to come out not
correct.
"""

from __future__ import annotations

import math

import torch

from .reference import asrc as asrc_ref
from .reference import fixed_ratio as fixed_ref
from .reference.bank import phase_bank


class _Gap:
    """The largest gap and the reference's RMS over the compared calls."""

    def __init__(self):
        self.err = 0.0
        self.sq = 0.0
        self.count = 0

    def add(self, got, ref, valid_numel):
        self.err = max(self.err, float((got - ref).abs().max()))
        self.sq += float(ref.square().sum())
        self.count += valid_numel

    def numbers(self, mismatch: int) -> dict:
        rms = (self.sq / max(self.count, 1)) ** 0.5
        return {"sample_err": self.err / rms, "count_mismatch": mismatch}


def _program(out, dev) -> torch.Tensor:
    """The program's outputs of one call, float64 on ``dev``."""
    return torch.as_tensor(out).to(device=dev, dtype=torch.float64)


def fixed_ratio(entry, records, log, control: bool) -> dict:
    """Reduced fixed-ratio streams; ``records`` are (call, first output
    index, outputs [C, >= K]) and ``entry.counts`` each call's outputs."""
    cfg, dev = entry.cfg, entry.dev
    g = math.gcd(int(cfg["source_rate"]), int(cfg["destin_rate"]))
    L, M = int(cfg["destin_rate"]) // g, int(cfg["source_rate"]) // g
    taps = cfg["num_taps"]
    geom = dict(L=L, M=M, taps=taps)
    mismatch, cum = 0, 0
    for c, K in enumerate(entry.counts):
        cum += K
        ref, tie = fixed_ref.emitted(log.starts[c] + log.calls[c][2], **geom)
        mismatch += not (cum == ref or (tie and cum == ref + 1))
    bank = phase_bank(taps, L, device=dev)
    gap = _Gap()
    for call, k0, out in records:
        K = entry.counts[call]
        a, b = fixed_ref.window_span(k0, k0 + K, **geom)
        seg = log.segment(a, b, dev)
        args = (seg, a, k0, k0 + K)
        ref = fixed_ref.outputs(*args, L=L, M=M, bank=bank)
        got = fixed_ref.outputs(*args, L=L, M=M, bank=bank, control=True) \
            if control else _program(out[:, :K], dev)
        gap.add(got, ref, ref.numel())
        del got, ref, seg
    return gap.numbers(mismatch)


def asrc(entry, records, log, n: int, ratios_at, control: bool) -> dict:
    """Drifting-ratio streams; ``records`` are (call, outputs [S, k_max])
    and ``entry.counts`` each call's [S] counts."""
    cfg, dev = entry.cfg, entry.dev
    taps = cfg["num_taps"]
    mismatch, starts = asrc_ref.replay(entry.counts, ratios_at, n, taps=taps,
                                       want={r[0] for r in records})
    bank = phase_bank(taps, cfg["num_filters"],
                      lowpass=cfg["lowpass_ratio"], device=dev)
    gap = _Gap()
    for call, out in records:
        I, f, K = starts[call]
        a = n * call - taps
        seg = log.segment(a, n * (call + 1), dev)
        args = (seg, a, I, f, ratios_at(call), K, out.shape[1])
        ref = asrc_ref.outputs(*args, bank=bank)
        got = asrc_ref.outputs(*args, bank=bank, control=True) \
            if control else _program(out, dev)
        gap.add(got, ref, int(K.sum()))
        del got, ref, seg
    return gap.numbers(mismatch)
