"""TDHS time-stretch / pitch-shift engine.

Behavioral port of the reference stretcher (reference stretch.[ch], adapted
there from dbry/audio-stretch): time-domain harmonic scaling with pitch
detection, mono/stereo, ratios 0.5-2.0 (0.25-4.0 with a cascaded dual
instance).  Block transformations are selected per detected pitch period
(2:1 merge, 1:1 copy, 2:3, 1:2) steered by a running output-count error term
so arbitrary ratios are hit on average (reference stretch.c:221-280).

This engine is inherently sequential at block granularity (each step's size
depends on the detected period), so the block assembly loop runs on the
host; the O(longest^2) period-search correlation — the hot part — is
vectorized (sum(|x|)/sum(|dx|) per candidate period, reference
stretch.c:376-460).  Audio is kept in the reference's flat interleaved
layout; "samples" counts are per channel at the API, flat internally.

A copy of ``art_tpu/engines/stretch.py``, unchanged, so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import math

import numpy as np

from ..core.flags import (MAX_PERIOD, MIN_PERIOD, STRETCH_DUAL_FLAG,
                          STRETCH_FAST_FLAG)


def _merge_blocks(in1: np.ndarray, in2: np.ndarray) -> np.ndarray:
    """Linear crossfade (reference stretch.c:560-566)."""
    n = in1.shape[0]
    i = np.arange(n, dtype=in1.dtype)
    return ((in1 * (n - i) + in2 * i) / n).astype(in1.dtype)


class Stretcher:
    def __init__(self, shortest_period: int, longest_period: int,
                 num_channels: int, flags: int, *, dtype=np.float32):
        max_periods = 3
        if flags & STRETCH_FAST_FLAG:
            longest_period = (longest_period + 1) & ~1
            shortest_period &= ~1
            max_periods = 4
        if (longest_period <= shortest_period or shortest_period < MIN_PERIOD
                or longest_period > MAX_PERIOD):
            raise ValueError("invalid stretch periods")
        if num_channels not in (1, 2):
            raise ValueError("stretch supports mono or stereo only")

        self.dtype = np.dtype(dtype)
        self.num_chans = num_channels
        self.fast_mode = bool(flags & STRETCH_FAST_FLAG)
        self.longest = longest_period * num_channels     # flat samples
        self.shortest = shortest_period * num_channels
        self.inbuff_samples = self.longest * max_periods
        self.inbuff = np.zeros(self.inbuff_samples, dtype=self.dtype)
        self.head = self.tail = self.longest
        self.outsamples_error = 0.0
        self.results = np.zeros(longest_period, dtype=self.dtype)

        self.next = None
        if flags & STRETCH_DUAL_FLAG:
            self.next = Stretcher(shortest_period, longest_period,
                                  num_channels, flags & ~STRETCH_DUAL_FLAG,
                                  dtype=dtype)

    # ------------------------------------------------------------------ api
    def reset(self) -> None:
        """Drop buffered audio (reference stretch.c:102-109; note the
        reference deliberately keeps outsamples_error across resets)."""
        self.head = self.tail = self.longest
        self.inbuff[:self.tail] = 0
        if self.next:
            self.next.reset()

    def get_output_capacity(self, max_num_samples: int,
                            max_ratio: float) -> int:
        """Worst-case per-call output frames (reference stretch.c:117-143)."""
        max_period = self.longest // self.num_chans
        next_ratio = 1.0
        if self.next:
            if max_ratio < 0.5:
                next_ratio, max_ratio = max_ratio / 0.5, 0.5
            elif max_ratio > 2.0:
                next_ratio, max_ratio = max_ratio / 2.0, 2.0
        cap = (int(math.ceil(max_num_samples * math.ceil(max_ratio * 2.0)
                             / 2.0))
               + max_period * (4 if self.fast_mode else 3))
        if self.next:
            cap = self.next.get_output_capacity(cap, next_ratio)
        return cap

    def process(self, samples: np.ndarray, num_samples: int,
                ratio: float) -> np.ndarray:
        """Stretch ``num_samples`` frames (interleaved flat [n*chans]) by
        ``ratio``; returns the flat interleaved output
        (reference stretch.c:161-326)."""
        out_chunks: list[np.ndarray] = []
        next_chunks: list[np.ndarray] = []
        next_ratio = 1.0
        if self.next:
            if ratio < 0.5:
                next_ratio, ratio = ratio / 0.5, 0.5
            elif ratio > 2.0:
                next_ratio, ratio = ratio / 2.0, 2.0
        ratio = min(max(ratio, 0.5), 2.0)

        flat = np.asarray(samples, dtype=self.dtype).reshape(-1)
        n_flat = num_samples * self.num_chans
        pos = 0

        while pos < n_flat or (pos == 0 and n_flat == 0):
            to_copy = min(n_flat - pos, self.inbuff_samples - self.head)
            if to_copy > 0:
                self.inbuff[self.head:self.head + to_copy] = \
                    flat[pos:pos + to_copy]
                pos += to_copy
                self.head += to_copy
            elif pos >= n_flat:
                break

            runner = self._native_runner()
            min_buffered = self.longest * (3 if self.fast_mode else 2)
            while (self.tail >= self.longest
                   and self.head - self.tail >= min_buffered):
                if runner is not None:
                    # the native loop runs EVERY buffered block in one call
                    # (pitch detect + transform; per-block Python overhead
                    # otherwise dominates the vectorized search).  The
                    # returned chunk is a view into the runner's scratch:
                    # next.process copies it immediately; the local append
                    # path copies explicitly.
                    chunk, self.tail, self.outsamples_error = runner.run(
                        self.head, self.tail, ratio, self.outsamples_error)
                    if self.next is None:
                        chunk = chunk.copy()
                else:
                    chunk = self._process_block(ratio)
                if self.next is not None:
                    next_chunks.append(self.next.process(
                        chunk, chunk.size // self.num_chans, next_ratio))
                else:
                    out_chunks.append(chunk)

                # left-justify, keeping one longest period of history
                move = self.inbuff_samples - self.tail + self.longest
                self.inbuff[:move] = \
                    self.inbuff[self.tail - self.longest:
                                self.tail - self.longest + move].copy()
                self.head -= self.tail - self.longest
                self.tail = self.longest
            if n_flat == 0:
                break

        # latency reduction: pass everything through at unity ratio
        if ratio == 1.0 and not self.outsamples_error and \
                self.head != self.tail:
            leftover = self.inbuff[self.tail:self.head].copy()
            if self.next is not None:
                next_chunks.append(self.next.process(
                    leftover, leftover.size // self.num_chans, next_ratio))
            else:
                out_chunks.append(leftover)
            self.inbuff[:self.longest] = \
                self.inbuff[self.head - self.longest:self.head].copy()
            self.head = self.tail = self.longest

        chunks = next_chunks if self.next is not None else out_chunks
        return np.concatenate(chunks) if chunks else \
            np.zeros(0, dtype=self.dtype)

    def flush(self) -> np.ndarray:
        """Pass leftover samples through at normal speed; call until empty
        for dual instances (reference stretch.c:335-356)."""
        leftover = self.inbuff[self.tail:self.head].copy()
        if self.next is not None:
            flushed = np.zeros(0, dtype=self.dtype)
            if leftover.size:
                flushed = self.next.process(
                    leftover, leftover.size // self.num_chans, 1.0)
            if not flushed.size:
                flushed = self.next.flush()
        else:
            flushed = leftover
        self.tail = self.head
        self.inbuff[:self.tail] = 0
        return flushed

    # ------------------------------------------------------------ internals
    def _native_runner(self):
        if not hasattr(self, "_runner"):
            from .. import native
            self._runner = native.StretchRunner(
                self.inbuff, self.longest, self.shortest, self.num_chans,
                self.fast_mode) if native.available() else None
        return self._runner

    def _process_block(self, ratio: float) -> np.ndarray:
        if ratio != 1.0 or self.outsamples_error:
            period = (self._find_period_fast() if self.fast_mode
                      else self._find_period())
        else:
            period = self.longest

        if self.outsamples_error == 0.0:
            process_ratio = math.floor(ratio * 2.0 + 0.5) / 2.0
        elif self.outsamples_error > 0.0:
            process_ratio = math.floor(ratio * 2.0) / 2.0
        else:
            process_ratio = math.ceil(ratio * 2.0) / 2.0

        buf, t = self.inbuff, self.tail
        if process_ratio == 0.5:
            out = _merge_blocks(buf[t:t + period],
                                buf[t + period:t + 2 * period])
            self.outsamples_error += period - (period * 2.0 * ratio)
            self.tail += period * 2
        elif process_ratio == 1.0:
            out = buf[t:t + 2 * period].copy()
            if ratio != 1.0:
                self.outsamples_error += (period * 2.0) - \
                    (period * 2.0 * ratio)
            else:
                self.outsamples_error = 0.0
            self.tail += period * 2
        elif process_ratio == 1.5:
            merged = _merge_blocks(buf[t + period:t + 2 * period],
                                   buf[t:t + period])
            out = np.concatenate([buf[t:t + period], merged,
                                  buf[t + period:t + 2 * period]])
            self.outsamples_error += (period * 3.0) - (period * 2.0 * ratio)
            self.tail += period * 2
        elif process_ratio == 2.0:
            out = _merge_blocks(buf[t:t + 2 * period],
                                buf[t - period:t + period])
            self.outsamples_error += (period * 2.0) - (period * ratio)
            self.tail += period
            if self.fast_mode:
                t = self.tail
                out = np.concatenate([
                    out, _merge_blocks(buf[t:t + 2 * period],
                                       buf[t - period:t + period])])
                self.outsamples_error += (period * 2.0) - (period * ratio)
                self.tail += period
        else:  # pragma: no cover
            raise RuntimeError(f"bad process_ratio {process_ratio}")
        return out

    def _calc_mono(self, decimate2: bool) -> np.ndarray:
        """Mix to mono (stereo) and optionally 2:1 decimate with the
        reference's exact float32 op order (reference stretch.c:400-487)."""
        src = self.inbuff[self.tail:self.tail + self.longest * 2]
        if not decimate2:
            if self.num_chans == 2:
                pairs = src.reshape(-1, 2)
                return ((pairs[:, 0] + pairs[:, 1]) / 2.0).astype(self.dtype)
            return src
        if self.num_chans == 2:
            # fl(fl(fl(a+b)+c)+d) / 2 (reference stretch.c:483-484)
            g = src.reshape(-1, 4)
            s = (g[:, 0] + g[:, 1]) + g[:, 2]
            return (((s + g[:, 3]).astype(np.float64) / 2.0)
                    .astype(self.dtype))
        g = src.reshape(-1, 2)
        return (((g[:, 0] + g[:, 1]).astype(np.float64) / 2.0)
                .astype(self.dtype))

    def _find_period(self) -> int:
        """Full-resolution period search (reference stretch.c:391-460)."""
        calc = self._calc_mono(decimate2=False)
        if not np.abs(calc).sum():
            return self.longest
        shortest = self.shortest // self.num_chans
        longest = self.longest // self.num_chans
        best_period, best_factor = self._search(calc, shortest, longest)
        return best_period * self.num_chans

    def _find_period_fast(self) -> int:
        """2:1 decimated search + neighbor refinement
        (reference stretch.c:472-551)."""
        calc = self._calc_mono(decimate2=True)
        if not np.abs(calc).sum():
            return self.longest
        shortest = self.shortest // (self.num_chans * 2)
        longest = self.longest // (self.num_chans * 2)
        best_period, _ = self._search(calc, shortest, longest,
                                      record=self.results)
        if best_period not in (shortest, longest):
            r = self.results
            # side diffs round at data-path precision, but the M_E compare
            # happens at double (reference stretch.c:537-543: artsample_t
            # operands promote to double against M_E) — float() here keeps
            # numpy's NEP-50 f32*scalar rule from demoting the compare
            high_side = float(r[best_period] - r[best_period + 1])
            low_side = float(r[best_period] - r[best_period - 1])
            if low_side > high_side * math.e:
                best_period = best_period * 2 + 1
            elif high_side > low_side * math.e:
                best_period = best_period * 2 - 1
            else:
                best_period *= 2
        else:
            best_period *= 2
        return best_period * self.num_chans

    @staticmethod
    def _search(calc: np.ndarray, shortest: int, longest: int,
                record: np.ndarray | None = None) -> tuple[int, float]:
        """Maximize sum(|x|)/sum(|diff|) over period candidates, with the
        reference's float32 accumulation orders so near-tie candidates
        resolve identically (reference stretch.c:417-457):

          - the running |x| sum starts as fl-chained pairs
            |c[i]| + |c[i+shortest]| and grows by |c[2p]| + |c[2p+1]|,
          - each candidate's |diff| accumulates top-down,
          - the factor compare happens at data-path precision.
        """
        dt = calc.dtype
        from .. import native
        if native.available():
            assert record is None or record.dtype == dt
            return native.stretch_search(np.ascontiguousarray(calc),
                                         shortest, longest, record)
        a = np.abs(calc)
        # initial sum for the shortest period: fl-chain over paired terms
        # |c[i]| + |c[i+shortest]| (reference stretch.c:419-420)
        init_pairs = (a[:shortest] + a[shortest:2 * shortest]).astype(dt)
        s0 = np.cumsum(init_pairs, dtype=dt)[-1]
        # running sum per candidate, grown by |c[2p]| + |c[2p+1]| *after*
        # each candidate is scored (reference stretch.c:455-456)
        idx = np.arange(shortest, longest, dtype=np.int64)
        incs = (a[2 * idx] + a[2 * idx + 1]).astype(dt)
        chain = np.cumsum(np.concatenate([[s0], incs]), dtype=dt)
        best_period, best_factor = shortest, dt.type(-1.0)
        for period in range(shortest, longest + 1):
            # top-down |diff| accumulation (reference stretch.c:429-432)
            seg = np.abs(calc[period - 1::-1]
                         - calc[2 * period - 1:period - 1:-1]).astype(dt)
            diff = np.cumsum(seg, dtype=dt)[-1]
            factor = np.finfo(np.float32).max if diff == 0.0 \
                else dt.type(chain[period - shortest] / diff)
            if record is not None:
                record[period] = factor
            if factor >= best_factor:
                best_factor = factor
                best_period = period
        return best_period, float(best_factor)
