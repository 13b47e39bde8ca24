"""Host-side consume/emit accounting for the streaming resampler.

The reference interleaves input consumption and output emission one sample at
a time inside its hot loop (reference resampler.c:494-529).  That shape is
hostile to TPUs, so this module factors the loop into a *closed form*: within
one process() call the emission positions are affine in the output index
(``pos_k = output_offset + k / ratio`` — the reference recomputes
``offset2 = k / ratio`` fresh each emission, so there is no accumulated
error), and consumption is a monotone staircase over those positions.  Given
(state, n_in, n_out, ratio) we can therefore compute, without touching any
audio data:

  - ``input_used`` / ``output_generated`` (the ResampleResult contract),
  - the float64 read position of every emitted frame in a *linear* coordinate
    system where index 0 is the oldest valid history sample,
  - the post-call (output_offset, input_index) pair, including the reference's
    ring-slide arithmetic (reference resampler.c:497-503), flush bookkeeping
    (postfillAllChannels, reference resampler.c:663-685) and snap-to-grid
    offset rounding (reference resampler.c:533-535).

The device kernel then reduces to a pure gather + matvec over the emitted
positions.  All arithmetic here is IEEE float64, the same operations the
reference performs in C doubles; the only tolerated divergence is sub-ULP
(ring slides shift both sides of the reference's comparisons by the same
exact integer, which can perturb a rounding at an exact tie).

A copy of ``art_tpu/core/accounting.py``, whole and unchanged, so that the
port imports nothing of the JAX package and its counts and positions stay
bitwise equal to the JAX engines' (tests/test_torch_host.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

from .flags import (
    EXTRAPOLATE_PREFILL, RESAMPLE_FIXED_RATIO, RESAMPLER_FLUSHED,
    RESAMPLER_SNAP_OFFSET,
)


@dataclass
class ProcessPlan:
    """Everything a process() call needs, resolved on the host."""
    input_used: int
    output_generated: int
    flush: bool                      # this call performs the flush transition
    # prefill: backwards extrapolation into leading silence at first emission.
    # (lin_first, nvalues) — extrapolate (num_taps - nvalues) samples backwards
    # from the nvalues real samples ending at linear index lin_first.
    prefill: tuple[int, int] | None = None
    # post-call engine state
    new_output_offset: float = 0.0
    new_input_index: int = 0
    new_flags: int = 0
    # how many trailing samples of the linear buffer become the new history
    # (== new_input_index), and total linear length used
    linear_len: int = 0
    # linear-coordinate read position of emission 0 (valid even when
    # positions were not materialized); emission k reads at
    # (first_position - flush_shift) + fl(k/ratio) + flush_shift
    first_position: float = 0.0
    flush_shift: int = 0


def snap_offset(offset: float, num_filters: int) -> float:
    """Round the fractional offset to the 1/num_filters grid
    (reference resampler.c:533-535)."""
    fl = math.floor(offset)
    return fl + math.floor((offset - fl) * num_filters + 0.5) / num_filters


def ring_floor(o0, q, i0: int, avail: int, num_samples: int,
               num_taps: int):
    """Linear-coordinate floor of emission position o0 + q evaluated the
    way the reference loop does: in RING coordinates current at the
    emission's compare.  Mid-call ring slides subtract the exact integer
    S = num_samples - num_taps from outputOffset (resampler.c:500-501),
    so the compared float is fl((o0 - s*S) + q) — at a rounding tie this
    keeps fraction bits the large-magnitude sum fl(o0 + q) loses, and the
    emission/consume decision can differ by one.  The slide count s
    depends on inputs consumed before the emission, which depends on the
    floored position itself; the fixpoint converges immediately except at
    sub-ulp integer crossings (same scheme as ring_positions, capped).

    Vectorized: ``o0`` and ``q`` broadcast (python floats or numpy
    arrays); every count path — scalar process planning and the batched
    ASRC bracket — shares THIS implementation so the parity-critical tie
    logic cannot silently diverge.  Returns the floor(s) in linear
    coordinates as int64."""
    half = num_taps // 2
    S = num_samples - num_taps
    o0 = np.asarray(o0, np.float64)
    q = np.asarray(q, np.float64)
    s = np.zeros(np.broadcast(o0, q).shape, dtype=np.int64)
    for _ in range(4):
        x = (o0 - s * S) + q
        ip = np.floor(x).astype(np.int64) + s * S
        m = np.clip(ip + half - i0 + 1, 0, avail)
        s_new = np.maximum(0, -((num_samples - i0 - m) // S))
        if np.array_equal(s_new, s):
            break
        s = s_new
    return np.floor((o0 - s * S) + q).astype(np.int64) + s * S


def _ring_floor(o0: float, q: float, i0: int, avail: int,
                num_samples: int, num_taps: int) -> int:
    """Scalar form of ring_floor (see there)."""
    return int(ring_floor(o0, q, i0, avail, num_samples, num_taps))


def _count_emissions(o_lin: float, ratio: float, bound: float, n_out: int,
                     *, input_index: int, avail: int, num_samples: int,
                     num_taps: int) -> int:
    """Largest prefix m <= n_out of emissions the reference loop performs:
    emission k happens iff its ring-coordinate floored position is < bound
    (enough input within the budget for its window), evaluated with the
    reference's mid-call slide re-rounding (_ring_floor).  A closed-form
    estimate is corrected by evaluating the exact float condition near the
    boundary, without materializing the position array."""
    if n_out <= 0:
        return 0

    def ok(k: int) -> bool:
        return _ring_floor(o_lin, k / ratio, input_index, avail,
                           num_samples, num_taps) < bound

    if not ok(0):                    # first emission already blocked
        return 0
    est = min(int(math.floor((bound - o_lin) * ratio)), n_out)
    lo = max(0, est - 4)
    hi = min(n_out, est + 4)

    # ensure the bracket actually brackets the boundary
    while lo > 0 and not ok(lo):
        hi = lo
        lo = max(0, lo - 64)
    while hi < n_out and ok(hi):
        lo = hi
        hi = min(n_out, hi + 64)
    m = lo
    for k in range(lo, hi):
        if not ok(k):
            break
        m = k + 1
    return min(m, n_out)


def plan_process(*, output_offset: float, input_index: int, flags: int,
                 num_taps: int, num_samples: int, num_filters: int,
                 fixed_ratio: float, n_in: int, n_out: int,
                 ratio: float) -> ProcessPlan:
    """Resolve one process()/flush call.

    ``output_offset``/``input_index`` are the engine's ring-coordinate state
    (identical numbers to the reference context fields).  ``n_in < 0``
    requests a flush.
    """
    half = num_taps // 2
    slide = num_samples - num_taps   # amount removed per ring slide

    if flags & RESAMPLE_FIXED_RATIO:
        ratio = fixed_ratio
    if flags & RESAMPLER_FLUSHED:
        n_in = 0

    flush = n_in < 0
    o_ring = output_offset
    i_ring = input_index
    flush_shift = 0

    if flush:
        # postfillAllChannels: slide if the pad would not fit, then account
        # for half-a-filter of synthetic input (reference resampler.c:663-685)
        if num_samples - i_ring < half:
            flush_shift = slide
            o_ring -= slide
            i_ring -= slide
        i_ring += half
        flags |= RESAMPLER_FLUSHED
        n_in = 0

    avail = max(n_in, 0)

    # Ring coordinates track the reference context exactly; engine-linear
    # coordinates index the caller's buffer L = history[0:entry_index]
    # (++ flush pad) ++ new_input[:used].  ring + flush_shift == linear.
    o_lin = o_ring
    i_lin0 = i_ring

    # Emission k is possible after consuming m > x_k - (i_lin0 - half) inputs,
    # where x_k = fl(o_lin + fl(k / ratio)); count emissions with the full
    # budget available, capped by output space.
    bound = i_lin0 + avail - half
    output_generated = _count_emissions(o_lin, ratio, bound, n_out,
                                        input_index=i_lin0, avail=avail,
                                        num_samples=num_samples,
                                        num_taps=num_taps)

    if n_out == 0:
        input_used = 0
    elif output_generated < n_out:
        input_used = avail
    else:
        # ring-exact floor of the last emission's position (the same
        # slide re-rounding as the count above)
        ip_last = _ring_floor(o_lin, (output_generated - 1) / ratio,
                              i_lin0, avail, num_samples, num_taps)
        m_min = ip_last + half - i_lin0 + 1
        input_used = min(avail, max(0, m_min))

    # prefill bookkeeping: fires (and disarms) at the first emission
    prefill = None
    new_flags = flags
    if (flags & EXTRAPOLATE_PREFILL) and output_generated > 0:
        new_flags &= ~EXTRAPOLATE_PREFILL
        x0 = o_lin                      # emission 0 reads at exactly o_lin
        m0 = min(avail, max(0, math.floor(x0) + half - i_lin0 + 1))
        lin_first = i_lin0 + m0 + flush_shift
        s0 = max(0, math.ceil((i_ring + m0 - num_samples)
                              / (num_samples - num_taps)))
        nvalues = (i_ring + m0 - s0 * (num_samples - num_taps)) - num_taps
        if nvalues >= 8 and num_taps - nvalues > 0:
            prefill = (lin_first, nvalues)

    # ring slides during consumption (reference resampler.c:497-503)
    n_slides = max(0, math.ceil((i_ring + input_used - num_samples) / slide))
    new_input_index = i_ring + input_used - n_slides * slide
    offset2 = output_generated / ratio if output_generated > 0 else 0.0
    new_offset = (o_ring - n_slides * slide) + offset2
    if flags & RESAMPLER_SNAP_OFFSET:
        new_offset = snap_offset(new_offset, num_filters)

    return ProcessPlan(
        input_used=input_used,
        output_generated=output_generated,
        flush=flush,
        prefill=prefill,
        new_output_offset=new_offset,
        new_input_index=new_input_index,
        new_flags=new_flags,
        linear_len=i_lin0 + flush_shift + input_used,
        first_position=o_lin + flush_shift,
        flush_shift=flush_shift,
    )


def ring_positions(*, first_position: float, flush_shift: int,
                   ratio: float, K: int, input_index: int, input_used: int,
                   num_samples: int, num_taps: int, flush: bool
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Per-emission integer positions (linear) and ring-exact fractions.

    The reference emits at fl(o_ring + fl(k/ratio)) where o_ring is slid
    DOWN by (num_samples - num_taps) at each ring slide during the call
    (reference resampler.c:500-501, 526): the slide subtraction cancels
    magnitude, so the rounded sum keeps fraction bits that the
    linear-coordinate sum fl(o_linear + fl(k/ratio)) loses at larger
    magnitude.  Nearest-filter rounding (subsample_no_interpolate) and
    interpolation fractions must use the ring-rounded value to match the
    reference bit-for-bit at phase-grid ties.

    The per-emission slide count depends on how many inputs were consumed
    before the emission, which depends on the rounded position itself; the
    fixpoint converges immediately except at sub-ulp integer crossings
    (the iteration is vectorized and capped).
    Returns (ipos int64 linear, frac float64).
    """
    o0 = first_position - flush_shift      # ring offset at call entry
    q = np.arange(K, dtype=np.float64) / ratio
    half = num_taps // 2
    S = num_samples - num_taps
    if flush or S <= 0:
        x = o0 + q                          # flush: o already slid, no input
        ip = np.floor(x)
        return ip.astype(np.int64) + flush_shift, x - ip
    i0 = input_index
    s = np.zeros(K, dtype=np.int64)
    for _ in range(4):
        x = (o0 - s * S) + q
        ip = np.floor(x).astype(np.int64) + s * S
        m = np.clip(ip + half - i0 + 1, 0, input_used)
        s_new = np.maximum(0, -((num_samples - i0 - m) // S))
        if np.array_equal(s_new, s):
            break
        s = s_new
    x = (o0 - s * S) + q
    ip = np.floor(x)
    return ip.astype(np.int64) + s * S, x - ip


def _simulate_required_samples_loop(*, output_offset: float,
                                    input_index: int, num_samples: int,
                                    num_taps: int, n_out: int,
                                    ratio: float) -> int:
    """Per-sample mirror of the reference loop (resampler.c:853-880); kept
    as the oracle for the vectorized version below."""
    half = num_taps // 2
    offset = output_offset
    idx = input_index
    used = 0
    step = 1.0 / ratio
    remaining = n_out
    while remaining > 0:
        if offset >= idx - half:
            if idx == num_samples:
                offset -= num_samples - num_taps
                idx -= num_samples - num_taps
            idx += 1
            used += 1
        else:
            offset += step
            remaining -= 1
    return used


def _check_sequential_cumsum() -> None:
    """Pin the parity-load-bearing assumption that np.cumsum accumulates
    float64 strictly left to right (fl(...fl(a0+a1)+a2...)).  True of every
    NumPy to date but not a documented guarantee — a future pairwise/SIMD
    accumulate would silently break the 'exact vs C' invariants, so fail
    loudly at import instead."""
    rng = np.random.default_rng(0x3141)
    a = rng.standard_normal(257) * rng.choice([1.0, 1e-9, 1e9], 257)
    acc, serial = 0.0, np.empty(257)
    for i, v in enumerate(a):
        acc += v
        serial[i] = acc
    if not np.array_equal(np.cumsum(a), serial):
        raise RuntimeError(
            "np.cumsum is no longer strictly sequential in float64; the "
            "vectorized accounting queries would lose bit-parity with the "
            "C reference loops — pin NumPy or revert to the loop oracles")


_check_sequential_cumsum()


def _accum_positions(offset: float, step: float, n: int) -> np.ndarray:
    """o[j] for j in 0..n = offset after j accumulated ``+= step`` rounds.

    np.add.accumulate applies fl(acc + step) strictly left to right, the
    same float64 sequence as the reference's serial loop (assumption
    verified at import by _check_sequential_cumsum)."""
    o = np.empty(n + 1, dtype=np.float64)
    o[0] = offset
    o[1:] = step
    return np.cumsum(o)


def simulate_required_samples(*, output_offset: float, input_index: int,
                              num_samples: int, num_taps: int,
                              n_out: int, ratio: float) -> int:
    """Dry-run: inputs needed for n_out outputs
    (reference resampler.c:853-880).  Faithful to the reference's accumulated
    ``offset += 1/ratio`` stepping, which rounds differently from k/ratio.

    Vectorized per ring-slide segment: within a segment the offset sequence
    is one np.cumsum (bit-identical to the serial loop), the consumption
    demand before emission j is c_j = floor(o_j) + half + 1 - input_index
    (monotone), and a slide replays the reference's exact-integer offset
    shift (the subtraction is exact in float64, so subsequent rounding
    matches the reference)."""
    half = num_taps // 2
    S = num_samples - num_taps
    step = 1.0 / ratio
    offset = float(output_offset)
    idx = int(input_index)
    used = 0
    remaining = int(n_out)
    while remaining > 0:
        cap = num_samples - idx          # consumptions before a slide fires
        est = int(min(remaining, max(1, math.ceil((cap + 2) * ratio) + 4)))
        while True:
            o = _accum_positions(offset, step, est)
            c = np.floor(o[:est]).astype(np.int64) + (half + 1 - idx)
            np.maximum(c, 0, out=c)
            over = np.nonzero(c > cap)[0]
            if over.size or est >= remaining:
                break
            est = int(min(remaining, est * 2))
        if over.size and int(over[0]) < remaining:
            jstar = int(over[0])         # slide fires while consuming for j*
            used += cap
            offset = float(o[jstar]) - S
            idx = num_samples - S
            remaining -= jstar
        else:
            used += int(c[remaining - 1])
            remaining = 0
    return used


def _simulate_expected_output_loop(*, output_offset: float, input_index: int,
                                   flags: int, num_samples: int,
                                   num_taps: int, n_in: int, ratio: float,
                                   fixed_ratio: float) -> int:
    """Per-sample mirror of the reference loop (resampler.c:882-918)."""
    half = num_taps // 2
    if flags & RESAMPLE_FIXED_RATIO:
        ratio = fixed_ratio
    offset = output_offset
    idx = input_index
    if flags & RESAMPLER_FLUSHED:
        n_in = 0
    elif n_in < 0:
        idx += half
        n_in = 0
    generated = 0
    step = 1.0 / ratio
    while True:
        if offset >= idx - half:
            if n_in > 0:
                if idx == num_samples:
                    offset -= num_samples - num_taps
                    idx -= num_samples - num_taps
                idx += 1
                n_in -= 1
            else:
                break
        else:
            offset += step
            generated += 1
    return generated


def simulate_expected_output(*, output_offset: float, input_index: int,
                             flags: int, num_samples: int, num_taps: int,
                             n_in: int, ratio: float,
                             fixed_ratio: float) -> int:
    """Dry-run: outputs generated from n_in inputs
    (reference resampler.c:882-918).  Vectorized per ring-slide segment with
    the same exact-float structure as simulate_required_samples; a slide
    only fires while inputs remain (the reference breaks first when the
    input budget is exhausted)."""
    half = num_taps // 2
    if flags & RESAMPLE_FIXED_RATIO:
        ratio = fixed_ratio
    offset = float(output_offset)
    idx = int(input_index)
    if flags & RESAMPLER_FLUSHED:
        n_in = 0
    elif n_in < 0:
        idx += half
        n_in = 0
    S = num_samples - num_taps
    step = 1.0 / ratio
    generated = 0
    n_left = int(max(n_in, 0))
    while True:
        # the reference loop never slides once the input budget is exhausted
        # (it breaks first), so cap is clamped at 0: the flush-peek case
        # (idx = input_index + half > num_samples) must keep the unslid
        # offset sequence, not take a phantom-slide branch whose re-rounded
        # offsets could flip a tie at the emit threshold
        cap = max(num_samples - idx, 0)
        avail = min(cap, n_left)
        est = int(max(1, math.ceil((idx + avail - half - offset) * ratio)
                      + 4))
        while True:
            o = _accum_positions(offset, step, est)
            c = np.floor(o[:est]).astype(np.int64) + (half + 1 - idx)
            np.maximum(c, 0, out=c)
            over = np.nonzero(c > avail)[0]
            if over.size:
                break
            est *= 2
        jstar = int(over[0])
        generated += jstar
        if n_left <= cap:                # stopped by input exhaustion
            return generated
        n_left -= cap                    # slide: consumed up to the boundary
        offset = float(o[jstar]) - S
        idx = num_samples - S
