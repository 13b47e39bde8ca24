"""The benchmark's one traffic generator: what a cell's file asks for, made
from ``--seed``.

Copied arithmetic, so that a later change to the program cannot move it:

- ``m_multiple``: ``bench.py:86-90`` (``_mult_chunk``), the same as
  ``art_tpu_torch/roundtrip.py::m_multiple``: a chunk of whole input
  periods keeps the fixed-ratio steady state exactly periodic.
- ``drift``: BASELINE config 5's per-call ratios, ``bench.py:363-364`` and
  ``chip_smoke.py:1272-1274``: ``1 + 0.01 sin(0.1 s + 0.031 t)`` for
  stream ``s`` at call ``t``.

Every input is white noise of the cell's standard deviation, made in one
call of a seeded generator on the run's device; a cell that hands host
buffers to its engine copies the pool to the host once, in set-up.  The
seed changes the samples and the drift's phase, never the sizes or the
number of calls, so every seed gives the same work.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch


def m_multiple(target: int, M: int) -> int:
    """The multiple of the input period M nearest ``target``."""
    return max(1, round(target / M)) * M


def drift(S: int, t: int, *, depth: float, stream_step: float,
          call_step: float) -> np.ndarray:
    """[S] float64 ratios of call ``t``."""
    return 1.0 + depth * np.sin(np.arange(S) * stream_step + call_step * t)


def drift_origin(seed: int) -> int:
    """The call index a seed's drift starts from (the same work for every
    seed: a phase of the sine)."""
    return int(seed) % 997


def noise_pool(seed: int, count: int, shape: tuple, std: float,
               device) -> list[torch.Tensor]:
    """``count`` distinct float32 buffers of ``shape``, views of one
    allocation, from one generator call on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    big = torch.randn((count, *shape), generator=gen, device=device,
                      dtype=torch.float32)
    big.mul_(std)
    return list(big.unbind(0))


class StreamLog:
    """Where every call's input lies: call c took frames [start, start + n)
    of the input stream from ``pool[index][..., offset:offset + n]`` (the
    pool's last axis is frames).  ``segment`` rebuilds any stretch of the
    stream for the reference, zeros before its start."""

    def __init__(self, pool):
        self.pool = pool
        self.starts: list[int] = []
        self.calls: list[tuple] = []
        self.total = 0

    def add(self, index: int, offset: int, n: int) -> None:
        self.starts.append(self.total)
        self.calls.append((index, offset, n))
        self.total += n

    def segment(self, a: int, b: int, device, dtype=torch.float64):
        """Frames [a, b) of the stream as [rows, b - a] on ``device``."""
        rows = self.pool[0].shape[0]
        out = torch.zeros((rows, b - a), dtype=dtype, device=device)
        c = max(bisect.bisect_right(self.starts, max(a, 0)) - 1, 0)
        while c < len(self.calls) and self.starts[c] < b:
            index, offset, n = self.calls[c]
            lo, hi = max(a, self.starts[c]), min(b, self.starts[c] + n)
            if lo < hi:
                src = self.pool[index][:, offset + lo - self.starts[c]:
                                       offset + hi - self.starts[c]]
                out[:, lo - a:hi - a] = torch.as_tensor(src).to(
                    device=device, dtype=dtype)
            c += 1
        return out


class Keeper:
    """The window's calls that the check compares: its last two, and one
    pair of consecutive calls drawn from the seed (reservoir sampling over
    the window, so every pair is equally likely).  A record is whatever
    the entry keeps of a call; its first item is the call's index."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng([int(seed), 7])
        self.prev = self.last = None
        self.drawn = ()
        self.seen = 0

    def push(self, record) -> None:
        self.prev, self.last = self.last, record
        self.seen += 1
        if self.seen >= 2 and self.rng.random() * (self.seen - 1) < 1.0:
            self.drawn = (self.prev, self.last)

    def records(self) -> list:
        """The kept records, each once, in call order."""
        recs = {r[0]: r for r in (*self.drawn, self.prev, self.last)
                if r is not None}
        return [recs[i] for i in sorted(recs)]
