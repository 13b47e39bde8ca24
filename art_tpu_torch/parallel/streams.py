"""Device-resident fixed-ratio streaming resampler (PyTorch port).

The counterpart of ``art_tpu/parallel/streams.py::DeviceStreamResampler``
in its single-device modes: reduced (the planner folded the phases into L
filters) and interpolated (an exact rational ratio Lp/Mp whose phases fall
between filters: two banked dots and a per-phase lerp), on float32 or
float64 data, with JAX's precision tiers.  Audio and history stay on the
engine's device; the host does only the scalar consume/emit accounting per
chunk, with the port's copy of the JAX engine's float64 code
(``core/accounting.py``), so counts and positions match it exactly.  Every chunk is one contraction of kernel K1
(``ops/fixed_step.py``) on a CUDA device, its plain version on the CPU:

- ``process`` is one chunk step (a tie-class interpolated chunk is split);
- ``process_scan`` runs G chunks of a [G, ch, n] stack in order, one chunk
  step each, after planning all G (JAX's ``lax.scan`` has no counterpart
  to port, and JAX's stacked [L, qn*M, L] anchor bank only fed its traced
  index: each chunk here takes its own matrix, so no size limit applies);
- ``process_flat`` / ``_out`` / ``_packed`` run G periodic chunks of one
  flat [ch, G*n] buffer over a single history + input buffer: the stats
  form launches K1 once per chunk and sums the power chunk by chunk, as
  ``process`` does; the delivering forms launch K1 once per group
  (``ops/fixed_step.fixed_step_group``: the G windows are consecutive
  block rows of the buffer) and the packed form
  quantizes and packs the samples in one launch of the decimate stage's
  flat kernel (``ops/decimate_device.py``).

Every form plans its chunks with ``_chunk_plan`` (both modes), and the
three flat forms share one prologue and rollback (``_run_group``).

The precision tiers run on their own instances of K1: ``precise=True``
and ``precise="int8"`` (float32 data) take each dot in float64 and round
it once, float64 data runs in float64.  Every group form is bitwise equal
to sequential ``process()`` calls in every tier.  Not ported yet, and
raising ``NotImplementedError`` (ROADMAP.md, "Modules to port"): ``mesh=``
(item 11).

``HybridStreamResampler`` is the file pipeline's engine (``art`` and
``artest -e`` with ``--backend=cuda``): this engine for the steady blocks,
the host ``Resampler`` (``engines/resampler.py``) for the prefill block,
odd tail blocks and the flush, as JAX's class of that name does.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from .._device import resolve_device, to_device, torch_dtype
from .._roadmap import _not_ported
from ..core import accounting
from ..core.filters import make_filter_bank, plan_fixed_ratio, resolve_lowpass
from ..core.flags import (BLACKMAN_HARRIS, EXTRAPOLATE_ENDPOINTS,
                          EXTRAPOLATE_PREFILL, INCLUDE_LOWPASS,
                          SUBSAMPLE_INTERPOLATE)
from ..engines.resampler import ResampleResult, Resampler
from ..ops import decimate_device as dd
from ..ops import fixed_step as k1
from ..ops.polyphase import PolyphaseMatrix
from ..utils.spans import CALL, PLAN, span, spanned, upload


def _group_buf(hist, xs_flat, G: int, n: int, hist_len: int,
               frame=(0, 0)):
    """The flat-group prologue: ONE contiguous stream [hist ++ xs_flat], so
    chunk g's window starts at g*n + start (reads past its end are zero in
    K1 and in the plain version, so JAX's zero tail is not needed), and the
    advanced history (the last hist_len columns of the stream).  ``frame``
    (``k1.window_frame``) puts (lead, tail) zeros around the stream; the
    window starts then move by lead."""
    lead, tail = frame
    parts = [hist, xs_flat]
    if lead or tail:
        ch = hist.shape[0]
        parts = [hist.new_zeros((ch, lead)), *parts,
                 hist.new_zeros((ch, tail))]
    buf = torch.cat(parts, dim=1)
    return buf, buf[:, lead + G * n:lead + G * n + hist_len].contiguous()


def _build_interp_matrix(bank, d, fi, rows: int, L: int, T: int):
    """The stacked interpolated matrices [rows, 2L] built on the bank's
    device from one period's window offsets d[L] and filter indices fi[L]:
    a pure selection from the uploaded bank, so bitwise equal to JAX's."""
    r = torch.arange(rows, device=bank.device)[:, None]
    offs = r - d[None, :]                              # [rows, L]
    valid = (offs >= 0) & (offs < T)
    oc = offs.clamp(0, T - 1)
    f = fi[None, :]
    zero = bank.new_zeros(())
    P1 = torch.where(valid, bank[f, oc], zero)
    P2 = torch.where(valid, bank[f + 1, oc], zero)
    return torch.cat([P1, P2], dim=1)


def _floor_half_up_exact(code):
    """floor(float64(code) + 0.5) from ops in code's type (JAX's rule,
    reference decimator.c:163): float64(code) + 0.5 is exact for the
    quantizer's range, so the float64 floor equals floor(code) + (code -
    floor(code) >= 0.5), whose terms are exact in float32 and float64.
    int64, so that no later step needs an unsigned shift."""
    f = torch.floor(code)
    return f.to(torch.int64) + (code - f >= 0.5).to(torch.int64)


def _quantize_pack(out, scaler: float, clips, *, highclip: int,
                   lowclip: int, output_bits: int, output_bytes: int):
    """The ditherless, unshaped quantizer and LE packer of JAX's
    ``_chunk_group_static_packed`` on samples [ch, n]: scale, round half
    up, clip (counted into ``clips``, int32), shift, offset and mask into a
    uint8/16/32 container whose little-endian bytes are the packed stream.
    A CUDA tensor launches ``decimate_flat_kernel`` (no dither, zero
    feedback, the container layout; it reads ``out`` in place), a CPU
    tensor takes ``_quantize_pack_reference``."""
    if out.device.type == "cuda":
        packed, n_clip, _ = dd.decimate_flat(
            out.T, out.shape[1], scaler=scaler, highclip=highclip,
            lowclip=lowclip, output_bits=output_bits,
            output_bytes=output_bytes, planar=True)
        return packed, clips + n_clip
    return _quantize_pack_reference(
        out, scaler, clips, highclip=highclip, lowclip=lowclip,
        output_bits=output_bits, output_bytes=output_bytes)


def _quantize_pack_reference(out, scaler: float, clips, *, highclip: int,
                             lowclip: int, output_bits: int,
                             output_bytes: int):
    """The plain version of ``_quantize_pack``, on any device.  The scaler
    takes the samples' type.  float32: a power of two multiplies in
    float32 (exact), any other in float64 rounded once to float32 (JAX's
    ``decimate_device._mul_for``); float64: one float64 multiply, as
    ``_mul_for`` does for float64 data.  Integer steps run in int64 (no
    unsigned shifts in torch) with shifts as multiplications by powers of
    two."""
    if out.dtype == torch.float64:
        code = out * float(scaler)
    elif float(scaler) > 0 and math.frexp(float(scaler))[0] == 0.5:
        code = out * torch.tensor(float(np.float32(scaler)),
                                  dtype=torch.float32, device=out.device)
    else:
        code = (out.to(torch.float64) * float(np.float32(scaler))) \
            .to(torch.float32)
    ov = _floor_half_up_exact(code)
    clips = clips + ((ov > highclip) | (ov < lowclip)).sum(dtype=torch.int32)
    ov = ov.clamp(lowclip, highclip)
    pre_zeros = output_bytes - ((output_bits + 7) // 8)
    offset = 128 if output_bits <= 8 else 0
    leftshift = (24 - output_bits) % 8
    used_mask = (1 << (8 * ((output_bits + 7) // 8))) - 1
    v = (ov * (1 << leftshift) + offset) & used_mask
    v = v * (1 << (8 * pre_zeros))
    return v.to(dd.CONTAINERS[output_bytes]), clips


def _stack_padded(outs):
    """[G, ch, max width] from per-chunk outputs, zero-padded on the
    right."""
    w = max(o.shape[1] for o in outs)
    return torch.stack([torch.nn.functional.pad(o, (0, w - o.shape[1]))
                        for o in outs])


class DeviceStreamResampler:
    """Fixed-ratio streaming resampler with device-resident state.

    Reduced configurations (the reference's fast path, filter reduction
    succeeded) or interpolated ones with an exact rational ratio of
    workable period (two banked dots and a per-phase lerp), on ``dtype``
    float32 or float64 data.  ``device``: where audio, history and the
    phase matrices live; "cuda" raises when no card is usable.  The methods
    take torch tensors (or arrays) and return device tensors, with the JAX
    engine's signatures and shapes.

    ``precise`` (float32 data; dropped for float64 data, as in JAX):
    ``True`` takes every contraction dot in float64 and rounds it once to
    float32 (interpolated: each bank's dot, then the float32 lerp);
    ``"int8"`` is JAX's int8 fixed-point (Ozaki-split) mode, whose digit
    dots land at that same single-rounding floor: here it runs the same
    float64-accumulating K1 instance as ``True``, which computes that
    function directly with no digit planes.  ``pallas_step`` selects JAX's
    Pallas body; on a card K1 is the only chunk step, so it changes
    nothing, and, as in JAX, it refuses a ``precise`` tier."""

    def __init__(self, num_channels: int, num_taps: int, max_filters: int,
                 source_rate: float, destin_rate: float, lowpass_freq: float,
                 flags: int, *, dtype=np.float32, mesh=None,
                 pallas_step: bool = False, precise: bool = False,
                 device="cuda"):
        if flags & EXTRAPOLATE_ENDPOINTS:
            raise ValueError("EXTRAPOLATE_ENDPOINTS is not modeled by the "
                             "device engine; use the host Resampler")
        self.dtype = np.dtype(dtype)
        self._tdtype = torch_dtype(self.dtype)
        # JAX's gates (art_tpu/parallel/streams.py:604-620)
        if precise == "int8":
            if self.dtype != np.float32:
                raise ValueError("precise='int8' is the f32 data path's "
                                 "fixed-point mode")
            if mesh is not None:
                raise NotImplementedError("precise='int8' is single-shard "
                                          "(use precise=True under a mesh)")
            self._precise = "int8"
        else:
            self._precise = bool(precise and self.dtype == np.float32)
        if self._precise and pallas_step:
            raise ValueError("precise modes are the XLA body only; drop "
                             "pallas_step")
        if mesh is not None:
            raise _not_ported("mesh=", 11)
        if pallas_step:
            warnings.warn("pallas_step selects JAX's Pallas chunk body; K1 "
                          "is the only chunk step here, so it has no "
                          "effect", stacklevel=2)
        self.device = resolve_device(device)
        plan = plan_fixed_ratio(num_taps, max_filters, source_rate,
                                destin_rate, lowpass_freq, flags)
        self.interp = bool(plan.flags & SUBSAMPLE_INTERPOLATE)
        if self.interp:
            # an exact rational ratio with a workable period: the phase
            # pattern then repeats every Lp outputs / Mp inputs
            if not (float(source_rate).is_integer()
                    and float(destin_rate).is_integer()):
                raise ValueError("interpolated device resampling needs "
                                 "integral rates (exact rational ratio)")
            g = math.gcd(int(source_rate), int(destin_rate))
            Lp, Mp = int(destin_rate) // g, int(source_rate) // g
            qn_i = -(-(Mp + num_taps) // Mp)
            if Lp > 1024 or qn_i * Mp * 2 * Lp > 4 << 20:
                raise ValueError("rational period too large for the device "
                                 "interpolated path")
        self.num_channels = num_channels
        self.num_taps = num_taps
        self.num_filters = plan.num_filters
        self.num_samples = num_taps * 16
        self.fixed_ratio = plan.fixed_ratio
        # mirror the host engine's resolve_lowpass both ways (reference
        # resampler.c:120-125)
        lowpass_ratio, self.flags = resolve_lowpass(plan.lowpass_ratio,
                                                    plan.flags)
        self.bank = make_filter_bank(num_taps, self.num_filters,
                                     lowpass_ratio,
                                     bool(flags & BLACKMAN_HARRIS),
                                     self.dtype.type)
        if self.interp:
            self.L, self.M = Lp, Mp
        else:
            self.L = self.num_filters
            self.M = int(round(self.L / self.fixed_ratio))
        self.qn = -(-(self.M + num_taps) // self.M)
        self._interp_cache: dict = {}
        self._pattern_safe_cache: dict = {}
        self._last_interp = None           # steady-state pattern reuse
        self._bank_dev = None
        self._flushed = False
        self.output_offset = float(num_taps // 2)
        self.input_index = num_taps
        self.hist = torch.zeros((num_channels, self.num_samples),
                                dtype=self._tdtype, device=self.device)
        self._mats: dict[int, torch.Tensor] = {}

    # ----------------------------------------------------------------- api
    def advance_position(self, delta: float) -> None:
        if delta < 0.0 or (not self.interp and math.floor(delta) != delta):
            raise ValueError("fractional advances need an interpolated "
                             "configuration (reference resampler.c:927-935)")
        self.output_offset += delta

    def get_position(self) -> float:
        return self.output_offset + self.num_taps / 2.0 - self.input_index

    def flush(self):
        """Emit the final half-filter of output by feeding zero padding
        (the reference's postfill without extrapolation, resampler.c:663-685)
        and latch FLUSHED: a second flush() or any later process() emits
        nothing and ignores its input (reference resampler.c:438-439)."""
        half = self.num_taps // 2
        zeros = torch.zeros((self.num_channels, half), dtype=self._tdtype,
                            device=self.device)
        result = self.process(zeros, half)
        self._flushed = True
        return result

    def prewarm(self) -> None:
        """Build and upload all L phase-anchor matrices, so streaming never
        pauses for a host-side matrix build.  Interpolated patterns depend
        on the streaming offset, so they are built (and cached) per chunk
        instead."""
        if self.interp:
            return
        for j in range(self.L):
            self._matrix(j)

    def _matrix(self, j0: int) -> torch.Tensor:
        """The [qn*M, L] phase-anchor matrix of anchor ``j0``, built on the
        host from the same numpy bank as the JAX engine's (bitwise equal to
        it) and uploaded once."""
        m = self._mats.get(j0)
        if m is None:
            pm = PolyphaseMatrix(self.bank, self.L, self.M, j0,
                                 bool(self.flags & INCLUDE_LOWPASS))
            P = np.zeros((self.qn * self.M, self.L), dtype=self.dtype)
            P[:pm.S, :] = pm.P.T
            m = to_device(P, self.device)
            self._mats[j0] = m
        return m

    def _plan_compute(self, n_in: int):
        """Pure consume/emit plan for a chunk: no state is mutated."""
        n_out_cap = int((n_in + self.num_taps) * self.fixed_ratio) + 64
        plan = accounting.plan_process(
            output_offset=self.output_offset, input_index=self.input_index,
            flags=self.flags, num_taps=self.num_taps,
            num_samples=self.num_samples, num_filters=self.num_filters,
            fixed_ratio=self.fixed_ratio, n_in=n_in, n_out=n_out_cap,
            ratio=0.0)
        if plan.input_used != n_in:
            raise RuntimeError("output capacity must cover input")
        K = plan.output_generated
        pos0 = plan.first_position
        ipos0 = math.floor(pos0)
        if self.interp:
            j0 = 0          # interpolated patterns are keyed by pos0 instead
        else:
            j0 = round((pos0 - ipos0) * self.L)
            if j0 >= self.L:
                ipos0 += 1
                j0 -= self.L
        half = self.num_taps // 2
        start = (ipos0 - half + 1) + (self.num_samples - self.input_index)
        return K, start, j0, pos0, plan

    def peek_output(self, n_in: int) -> int:
        """Outputs the next process(n_in) call would emit (state untouched)."""
        return self._plan_compute(n_in)[0]

    def _plan(self, n_in: int):
        K, start, j0, pos0, plan = self._plan_compute(n_in)
        self._advance(plan)
        return K, start, j0, pos0

    def _advance(self, plan) -> None:
        """Adopt ``plan``'s state advance verbatim: it reproduces the
        reference's ring-slide arithmetic exactly."""
        self.output_offset = plan.new_output_offset
        self.input_index = plan.new_input_index

    def _chunk_plan(self, n_in: int):
        """The next chunk's plan in either mode, no state advanced: (K,
        start, P, fracv, plan, safe).  P is the chunk's anchor matrix
        (reduced, fracv None) or its stacked banks with their lerp
        fractions fracv (interpolated, ``_interp_pattern``); either is
        built and uploaded once and is then the same object.  ``safe``
        False: the tiled interpolated pattern failed the float64-tie oracle
        and the chunk must be split; reduced chunks are always safe."""
        K, start, j0, pos0, plan = self._plan_compute(n_in)
        if not self.interp:
            return K, start, self._matrix(j0), None, plan, True
        nb = -(-K // self.L) if K else 1
        P, fracv, _d, _fi, _fr, safe = self._interp_pattern(pos0, plan,
                                                            n_in, K, nb)
        return K, start, P, fracv, plan, safe

    def _plan_chunks(self, n_in: int, G: int) -> list:
        """Plan and advance up to G chunks of n_in inputs: [(K, start, P,
        fracv)], cut short before the first unsafe chunk (the state then
        stands after the chunks returned)."""
        chunks = []
        for _ in range(G):
            K, start, P, fracv, plan, safe = self._chunk_plan(n_in)
            if not safe:
                break
            self._advance(plan)
            chunks.append((K, start, P, fracv))
        return chunks

    # ------------------------------------------- interpolated phase pattern
    def _pattern_vals(self, first_position: float):
        """One period's (window offset, filter index, fraction) triples,
        computed exactly from the float64 streaming offset -- the same
        per-output math as the host engine."""
        ratio = self.fixed_ratio
        j = np.arange(self.L, dtype=np.float64)
        pos = first_position + j / ratio
        ipos = np.floor(pos)
        ff = (pos - ipos) * self.num_filters
        fi = np.minimum(np.floor(ff), self.num_filters - 1).astype(np.int64)
        frac = (ff - fi)
        d = (ipos - ipos[0]).astype(np.int64)
        return d, fi, frac

    def _interp_pattern(self, pos0: float, plan, n_in: int, K: int,
                        nb: int):
        """This chunk's banked pattern WITH steady-state reuse.

        The float64 streaming offset drifts in its last ulps chunk to
        chunk, so the bitwise (d, fi, frac) pattern of an exactly periodic
        steady state flips between value-continuous representations
        (filter fi-1 at frac 1 == filter fi at frac 0).  Reuse rule: if the
        PREVIOUS pattern's phase positions are within PATTERN_TOL of this
        chunk's (per-period L-element compare, plus this chunk's own
        analytic oracle bound), the previous pattern is provably as close
        to the ring-exact oracle as the fresh one -- return it, keeping the
        cache identity that the flat group forms key on.  Sequential
        process(), process_scan and process_flat* all route through here,
        so they make identical pattern choices (the bitwise grouped ==
        sequential contract).

        Returns (P2, fracv, d, fi, frac, safe); ``safe=False`` means the
        caller must split the chunk (the ~1e-10 tie class, see
        _pattern_safe)."""
        ipos0 = math.floor(pos0)
        last = self._last_interp
        if last is not None and K:
            bound = 4.0 * np.spacing(abs(plan.first_position)
                                     + K / self.fixed_ratio)
            d, fi, frac = self._pattern_vals(pos0)
            Fn = float(self.num_filters)
            own = d.astype(np.float64) + (fi.astype(np.float64) + frac) / Fn
            dl, fil, fracl = last[2], last[3], last[4]
            prev = dl.astype(np.float64) \
                + (fil.astype(np.float64) + fracl) / Fn
            dev = float(np.abs(own - prev).max())
            if dev + bound <= self.PATTERN_TOL:
                return (*last, True)
        m = self._interp_matrix(pos0)
        safe = self._pattern_safe(plan, n_in, K, nb, ipos0, m[2], m[3],
                                  m[4])
        if safe:
            self._last_interp = m
        return (*m, safe)

    def _interp_matrix(self, first_position: float):
        """Banked interpolated matrices for this chunk's phase pattern (the
        integer pattern is tiled across the chunk's nb periods;
        _interp_pattern verifies the tiling against the ring-coordinate
        oracle before use): (P2 [qn*M, 2L], fracv [L] in the data's type, d,
        fi, frac), cached by pattern, 64 entries with one-oldest eviction."""
        d, fi, frac = self._pattern_vals(first_position)
        key = (d.tobytes(), fi.tobytes(), frac.tobytes())
        m = self._interp_cache.get(key)
        if m is None:
            if self._bank_dev is None:
                self._bank_dev = to_device(self.bank, self.device)
            P2 = _build_interp_matrix(
                self._bank_dev, to_device(d, self.device),
                to_device(fi, self.device), self.qn * self.M, self.L,
                self.num_taps)
            m = (P2, to_device(frac.astype(self.dtype), self.device), d, fi,
                 frac)
            if len(self._interp_cache) > 64:
                # evict ONE oldest entry (dict preserves insertion order):
                # clearing everything made a 65-pattern working set rebuild
                # every matrix nearly every chunk
                self._interp_cache.pop(next(iter(self._interp_cache)))
            self._interp_cache[key] = m
        return m

    # max tolerated phase-position deviation of the tiled pattern from the
    # ring-exact oracle, in input-sample units.  A deviation d perturbs the
    # output by ~|signal slope| * d, so 1e-8 stays far below the float32
    # floor; the expected worst case (ulp of fl(k/ratio) at k ~ 2^22-frame
    # chunks) is ~1e-9.  Rational-ratio configs sit systematically on
    # float64 phase-grid ties (exact positions are multiples of 1/L), so
    # bitwise (window, filter) flips with compensating fractions are the
    # norm; they are value-continuous (filter fi-1 at frac 1 == filter fi
    # at frac 0; the rotated extra filter makes the window+1/fi=0 wrap
    # continuous too, reference resampler.c:154-159).
    PATTERN_TOL = 1e-8

    def _pattern_safe(self, plan, n_in: int, K: int, nb: int,
                      ipos0: float, d: np.ndarray, fi: np.ndarray,
                      frac: np.ndarray) -> bool:
        """Exact-fi verification of the tiled interpolated pattern against
        the host oracle: the reference rounds emission positions in ring
        coordinates (fl((o - slides) + fl(k/ratio)), resampler.c:526,
        1147-1157); the device step assumes period p of this chunk reads
        the continuous phase position ipos0 + d[j] + p*M + (fi[j] +
        frac[j])/F.  Vectorized over all K emissions and cached per
        (pattern, plan scalars); a deviation beyond PATTERN_TOL makes the
        caller split the chunk into provably exact sub-chunks."""
        if nb <= 1 or not K:
            return True
        # analytic fast path: oracle and tiled pattern both approximate the
        # same exact rational position within a few roundings of their own
        # computations -- the oracle's division fl(k/ratio) dominates at
        # <= 0.5 ulp(K/ratio), the pattern's period-0 terms are at small
        # magnitudes, and the fraction's float32 quantization adds
        # 2^-24/num_filters.  A generous 4x margin on the dominant term
        # proves typical chunks safe without scanning them.
        bound = 4.0 * np.spacing(abs(plan.first_position) + K
                                 / self.fixed_ratio)
        if bound <= self.PATTERN_TOL:
            return True
        key = (plan.first_position, K, self.input_index, n_in,
               d.tobytes(), fi.tobytes())
        safe = self._pattern_safe_cache.get(key)
        if safe is None:
            ip, frac0 = accounting.ring_positions(
                first_position=plan.first_position,
                flush_shift=plan.flush_shift, ratio=self.fixed_ratio, K=K,
                input_index=self.input_index, input_used=plan.input_used,
                num_samples=self.num_samples, num_taps=self.num_taps,
                flush=plan.flush)
            pos_oracle = ip.astype(np.float64) + frac0
            pidx = np.arange(K, dtype=np.int64)
            F = float(self.num_filters)
            pos_pat = (ipos0 + np.tile(d, nb)[:K]
                       + (pidx // self.L).astype(np.float64) * self.M
                       + np.tile((fi.astype(np.float64) + frac) / F,
                                 nb)[:K])
            safe = bool(np.abs(pos_oracle - pos_pat).max()
                        <= self.PATTERN_TOL)
            if len(self._pattern_safe_cache) > 256:
                self._pattern_safe_cache.pop(
                    next(iter(self._pattern_safe_cache)))
            self._pattern_safe_cache[key] = safe
        return safe

    # ------------------------------------------------------------- process
    def _as_input(self, x):
        with upload(x, self.device):
            return torch.as_tensor(x, dtype=self._tdtype, device=self.device)

    def _step(self, x, P, fracv, start: int, K: int, acc):
        """One chunk step on the engine's history: (out [ch, nb*L] zeroed
        beyond K, acc')."""
        nb = -(-K // self.L) if K else 1
        self.hist, out, acc = k1.fixed_step(
            self.hist, x, P, start, K, acc, M=self.M, L=self.L, nb=nb,
            qn=self.qn, hist_len=self.num_samples, fracv=fracv,
            precise=bool(self._precise))
        return out, acc

    @spanned(CALL)
    def process(self, x, n_in: int, acc=None):
        """x: [ch, n_in] (wider buffers are cut to n_in).  Returns (out
        [ch, nb*L] with entries beyond K zeroed, K), or (out, K, acc') when
        a running output-power accumulator is passed.  All n_in inputs are
        consumed."""
        return self._process(x, n_in, acc)

    def _process(self, x, n_in: int, acc):
        if self._flushed:
            out = torch.zeros((self.num_channels, self.L),
                              dtype=self._tdtype, device=self.device)
            return (out, 0) if acc is None else (out, 0, acc)
        x = self._as_input(x)
        if x.shape[1] != n_in:
            if x.shape[1] < n_in:
                raise ValueError(f"x has {x.shape[1]} columns < n_in "
                                 f"{n_in}")
            x = x[:, :n_in]
        with span(PLAN):
            K, start, P, fracv, plan, safe = self._chunk_plan(n_in)
        if not safe:
            return self._process_split(x, n_in, acc)
        self._advance(plan)
        acc_in = acc if acc is not None else torch.zeros(
            (), dtype=self._tdtype, device=self.device)
        out, acc_out = self._step(x, P, fracv, start, K, acc_in)
        if acc is None:
            return out, K
        return out, K, acc_out

    def _process_split(self, x, n_in: int, acc):
        """Float64-tie chunk (the interpolated pattern does not repeat
        exactly): halve until every sub-chunk is single-period, which the
        tiled step computes exactly.  Expected ~once per 1e10 outputs."""
        if n_in <= 1:
            raise AssertionError("single-input chunk cannot be period-tied")
        n1 = n_in // 2
        r1 = self._process(x[:, :n1], n1, acc)
        acc1 = r1[2] if acc is not None else None
        r2 = self._process(x[:, n1:], n_in - n1, acc1)
        K1, K2 = r1[1], r2[1]
        K = K1 + K2
        nb = max(1, -(-K // self.L))
        out = torch.zeros((x.shape[0], nb * self.L), dtype=self._tdtype,
                          device=self.device)
        out[:, :K1] = r1[0][:, :K1]
        out[:, K1:K] = r2[0][:, :K2]
        if acc is None:
            return out, K
        return out, K, r2[2]

    # ------------------------------------------------ group-dispatch forms
    @spanned(CALL)
    def process_scan(self, xs, n_in: int, acc=None, stats: bool = False):
        """G chunks of ``xs`` [G, ch, n_in] in order, bitwise equal to G
        sequential process() calls: all G are planned first, then each runs
        one chunk step (one K1 launch) with its own anchor matrix (reduced)
        or P2/fracv (interpolated).  JAX batches them into one ``lax.scan``
        over a stacked [L, qn*M, L] anchor bank and rejects banks over 512
        MB; the port indexes no stack, so no such limit applies.  Returns
        (outs [G, ch, nb*L] with entries beyond each chunk's K zeroed, Ks
        int array [G][, acc']).

        An interpolated chunk whose tiled pattern fails the float64-tie
        oracle (_pattern_safe, expected ~once per 1e10 outputs) sends the
        whole group through sequential process() calls, with the same
        output shapes.

        ``stats=True`` (requires ``acc``): the power accumulator is the
        only consumer of the outputs (the reference harness's update_stats,
        artest.c:491) and outs comes back None.  A failing chunk step rolls
        the consume/emit state and the history back to the call's entry."""
        if stats and acc is None:
            raise ValueError("stats=True consumes outputs into the power "
                             "accumulator; pass acc")
        xs = self._as_input(xs)
        state0 = (self.output_offset, self.input_index, self.hist)
        try:
            with span(PLAN):
                steps = self._plan_chunks(n_in, len(xs))
            if len(steps) < len(xs):
                self.output_offset, self.input_index = state0[:2]
                steps = None
            return self._run_scan(xs, n_in, steps, acc, stats)
        except BaseException:
            self.output_offset, self.input_index, self.hist = state0
            raise

    def _run_scan(self, xs, n_in: int, steps, acc, stats: bool):
        """process_scan's chunk steps over the planned ``steps``, or, with
        ``steps`` None, sequential process() chunks."""
        acc_out = acc if acc is not None else torch.zeros(
            (), dtype=self._tdtype, device=self.device)
        outs, Ks = [], []
        for g, x in enumerate(xs):
            if steps is None:
                out, K, acc_out = self._process(x, n_in, acc_out)
            else:
                K, start, P, fracv = steps[g]
                out, acc_out = self._step(x, P, fracv, start, K, acc_out)
            Ks.append(K)
            if not stats:
                outs.append(out)
        Ks = np.asarray(Ks)
        if stats:
            return None, Ks, acc_out
        outs = _stack_padded(outs)
        return (outs, Ks) if acc is None else (outs, Ks, acc_out)

    @spanned(PLAN)
    def _flat_plan(self, xs_flat, n_in: int):
        """Shared flat-group plan validation: checks the group shape,
        advances the consume/emit state G chunks, and returns (G, K0,
        start0, nb, P, fracv, state0) where P/fracv are the chunk matrix and
        lerp fractions (fracv None in reduced mode) and state0 the pre-call
        (output_offset, input_index) for rollback.  The group is periodic
        when every chunk's K and start equal chunk 0's and its P and fracv
        are the same objects (one anchor, or one repeating verified phase
        pattern); raises ValueError with the state ROLLED BACK when it is
        not.  G == 0 signals the FLUSHED latch."""
        ch, total = xs_flat.shape
        if total % n_in:
            raise ValueError(f"flat buffer ({total}) must be G*n_in")
        G = total // n_in
        if self._flushed:
            # FLUSHED latch (reference resampler.c:438-439): input after
            # flush is ignored; state does not advance
            return 0, 0, 0, 1, None, None, None
        if G * n_in < self.num_samples:
            raise ValueError("group must cover at least one history length")
        state0 = (self.output_offset, self.input_index)
        chunks = self._plan_chunks(n_in, G)
        if len(chunks) < G or any(
                c[:2] != chunks[0][:2] or c[2] is not chunks[0][2]
                or c[3] is not chunks[0][3] for c in chunks):
            self.output_offset, self.input_index = state0
            raise ValueError("process_flat needs an exactly periodic "
                             "steady state (identical per-chunk plans and "
                             "phase pattern): use an M-multiple chunk size "
                             "and absorb the first chunk with process(), "
                             "or use process_scan")
        K0, start0, P, fracv = chunks[0]
        nb = max(-(-K0 // self.L), 1)
        return G, K0, start0, nb, P, fracv, state0

    def _run_group(self, xs_flat, n_in: int, body, empty):
        """The flat forms' one prologue: the group plan (``_flat_plan``);
        after the FLUSHED latch (G == 0) zero Ks and ``empty()``; otherwise
        ONE history + input buffer (``_group_buf``, framed as
        ``k1.window_frame`` asks) and ``body(buf, n_in, G, K0, start, nb, P,
        fracv)``, ``start`` chunk 0's window start in buf, after which the
        advanced history is committed.  Any exception rolls the
        consume/emit state back to the call's entry, the history
        untouched.  Returns (Ks int array [G],
        the body's or ``empty``'s result)."""
        G, K0, start0, nb, P, fracv, state0 = self._flat_plan(xs_flat, n_in)
        if G == 0:
            return np.zeros((xs_flat.shape[1] // n_in,), np.int64), empty()
        try:
            frame = k1.window_frame(
                P, start0, self.hist.shape[1] + xs_flat.shape[1], M=self.M,
                qn=self.qn, fracv=fracv, precise=bool(self._precise))
            buf, new_hist = _group_buf(self.hist, xs_flat, G, n_in,
                                       self.num_samples, frame)
            result = body(buf, n_in, G, K0, start0 + frame[0], nb, P, fracv)
        except BaseException:
            self.output_offset, self.input_index = state0
            raise
        self.hist = new_hist
        return np.full((G,), K0, np.int64), result

    @spanned(CALL)
    def process_flat(self, xs_flat, n_in: int, acc):
        """G periodic steady-state chunks of a FLAT [ch, G*n_in] buffer,
        outputs consumed by the power accumulator, summed chunk by chunk in
        chunk order exactly as process() sums them (bitwise equal to
        sequential process()).  One K1 launch per chunk over the group's
        single history + input buffer (no per-chunk concat).  Requires an
        exactly periodic plan (n_in a multiple of the input period M, the
        first non-periodic chunk absorbed by process(); the interpolated
        mode also needs one repeating verified phase pattern): raises
        ValueError otherwise, with no state consumed.  Returns (Ks int
        array [G], acc')."""
        xs_flat = self._as_input(xs_flat)
        with upload(acc, self.device):
            acc = torch.as_tensor(acc, dtype=self._tdtype, device=self.device)

        def chunks(buf, n_in, G, K0, start0, nb, P, fracv):
            total = acc
            for g in range(G):
                out = k1.fixed_step_window(
                    buf, P, start0 + g * n_in, K0, M=self.M, L=self.L,
                    nb=nb, qn=self.qn, fracv=fracv,
                    precise=bool(self._precise))
                total = total + torch.sum(out * out)
            return total

        return self._run_group(xs_flat, n_in, chunks, lambda: acc)

    @spanned(CALL)
    def process_flat_out(self, xs_flat, n_in: int):
        """Flat-group steady state DELIVERING the audio: the plan contract
        of process_flat; the result is the valid output samples [ch, G*K0]
        (the reference hands callers real output buffers,
        resampler.c:523-527), bitwise equal to sequential process()'s valid
        prefixes.  One K1 launch per call on a card.  Returns (out [ch,
        G*K0], Ks int array [G])."""
        xs_flat = self._as_input(xs_flat)
        Ks, out = self._run_group(
            xs_flat, n_in, self._group_samples,
            lambda: torch.zeros((xs_flat.shape[0], 0), dtype=self._tdtype,
                                device=self.device))
        return out, Ks

    def _group_samples(self, buf, n_in: int, G: int, K0: int, start0: int,
                       nb: int, P, fracv):
        """The delivering forms' group body: the group's valid samples
        [ch, G*K0] (``k1.fixed_step_group``)."""
        return k1.fixed_step_group(
            buf, P, start0, K0, G=G, n_in=n_in, M=self.M, L=self.L, nb=nb,
            qn=self.qn, fracv=fracv, precise=bool(self._precise))

    @spanned(CALL)
    def process_flat_packed(self, xs_flat, n_in: int, clips, *,
                            scaler: float, highclip: int, lowclip: int,
                            output_bits: int = 16, output_bytes: int = 2):
        """Flat-group steady state through the ditherless, unshaped
        quantizer and little-endian packing (reference decimateProcessLE,
        decimator.c:112-199 with dither and shaping off): process_flat_out's
        samples, then _quantize_pack (bit-exact to the reference's double
        rounding).  Returns (packed [ch, G*K0] uint8/16/32 container whose
        little-endian byte view is the packed stream, Ks int array [G],
        clips' int32 with the clipped samples added).  output_bytes must
        be 1, 2 or 4 (3-byte packing has no dense container)."""
        if output_bytes not in (1, 2, 4):
            raise ValueError("process_flat_packed: output_bytes must be "
                             "1, 2 or 4 (dense LE containers); 3-byte "
                             "packing goes through the decimator path")
        xs_flat = self._as_input(xs_flat)
        with upload(clips, self.device):
            clips = torch.as_tensor(clips, dtype=torch.int32,
                                    device=self.device)
        Ks, (packed, clips) = self._run_group(
            xs_flat, n_in,
            lambda *group: _quantize_pack(
                self._group_samples(*group), scaler, clips, highclip=highclip,
                lowclip=lowclip, output_bits=output_bits,
                output_bytes=output_bytes),
            lambda: (torch.zeros((xs_flat.shape[0], 0),
                                 dtype=dd.CONTAINERS[output_bytes],
                                 device=self.device), clips))
        return packed, Ks, clips

    # ----------------------------------------------------- streaming state
    def state_dict(self) -> dict:
        """Streaming state as plain host values: history [ch, num_samples]
        in the engine's dtype, output_offset, input_index and the FLUSHED
        latch."""
        return {"history": self.hist.cpu().numpy().copy(),
                "output_offset": float(self.output_offset),
                "input_index": int(self.input_index),
                "flushed": bool(self._flushed)}

    def load_state(self, state: dict) -> None:
        hist = np.asarray(state["history"], dtype=self.dtype)
        if hist.shape != (self.num_channels, self.num_samples):
            raise ValueError(f"history shape {hist.shape}, expected "
                             f"{(self.num_channels, self.num_samples)}")
        self.hist = torch.from_numpy(hist.copy()).to(self.device)
        self.output_offset = float(state["output_offset"])
        self.input_index = int(state["input_index"])
        self._flushed = bool(state["flushed"])


class HybridStreamResampler:
    """File-pipeline engine: device steady state, host edges.

    The port of ``art_tpu/parallel/streams.py::HybridStreamResampler``.
    Drives ``DeviceStreamResampler`` for the repeated full-size blocks of a
    file conversion and hands everything the device engine does not model
    -- the endpoint extrapolation prefill (reference resampler.c:691-698),
    odd-sized tail blocks and the flush with its extrapolated postfill
    (reference resampler.c:663-685) -- to the host ``Resampler``, moving
    the streaming state between the two exactly: the host keeps its
    history left-aligned in ``history[:, :input_index]`` and its latch in
    ``flags``; the device engine keeps the same samples right-aligned in a
    ``[num_channels, num_samples]`` ring and its own ``flushed`` latch,
    which stays clear because the flush always runs on the host.  Both run
    the same float64 accounting, so offsets and indices carry over as they
    are.

    Exposes the host engine's ``process_interleaved`` contract, so callers
    (the CLIs) need not know which engine ran a block.  Counts and
    positions are exact; samples are within the float32 class of the host
    path.  ``device``: where the steady blocks run; "cuda" raises when no
    card is usable (nothing falls back to the host engine for that)."""

    def __init__(self, num_channels: int, num_taps: int, max_filters: int,
                 source_rate: float, destin_rate: float, lowpass_freq: float,
                 flags: int, *, dtype=np.float32, mesh=None,
                 precise: bool = False, device="cuda"):
        self.host = Resampler.fixed_ratio(
            num_channels, num_taps, max_filters, source_rate, destin_rate,
            lowpass_freq, flags, dtype=dtype)
        self.dev = DeviceStreamResampler(
            num_channels, num_taps, max_filters, source_rate, destin_rate,
            lowpass_freq, flags & ~EXTRAPOLATE_ENDPOINTS, dtype=dtype,
            mesh=mesh, precise=precise, device=device)
        self.dev.prewarm()
        self._on_device = False
        self._steady_n = None

    # --------------------------------------------------------- state moves
    def _push(self) -> None:
        """Host state -> device engine: the left-aligned history becomes
        the right end of the device ring."""
        st = self.host.state_dict()
        ns, ii = self.dev.num_samples, int(st["input_index"])
        hist = np.zeros((self.dev.num_channels, ns), self.dev.dtype)
        hist[:, ns - ii:] = st["history"][:, :ii]
        self.dev.load_state({"history": hist,
                             "output_offset": st["output_offset"],
                             "input_index": ii, "flushed": False})
        self._on_device = True

    def _pull(self) -> None:
        """Device engine state -> host: the right end of the ring becomes
        the host's left-aligned history; the host's ``flags`` and the
        history past ``input_index`` (which it never reads) stay as they
        were, so ``_pull`` undoes ``_push`` bitwise."""
        ds = self.dev.state_dict()
        ns, ii = self.dev.num_samples, ds["input_index"]
        st = self.host.state_dict()
        st["history"][:, :ii] = ds["history"][:, ns - ii:]
        st["output_offset"] = ds["output_offset"]
        st["input_index"] = ii
        self.host.load_state(st)
        self._on_device = False

    # ----------------------------------------------------------------- api
    def advance_position(self, delta: float) -> None:
        # a mid-stream advance (legal in the reference, resampler.c:927-935)
        # must reach the live state: while steady blocks run on the device
        # the host copy is stale and the next _pull() would overwrite an
        # advance applied there
        if self._on_device:
            self._pull()
        self.host.advance_position(delta)

    def get_position(self) -> float:
        if self._on_device:
            return self.dev.get_position()
        return self.host.get_position()

    def get_lowpass_ratio(self) -> float:
        return self.host.get_lowpass_ratio()

    def get_num_filters(self) -> int:
        return self.host.get_num_filters()

    def interpolation_used(self) -> int:
        return self.host.interpolation_used()

    def get_expected_output(self, n_in: int, ratio: float = 0.0) -> int:
        if self._on_device:
            # the dry run needs only the two scalar state fields, which
            # live on the host: no need to fetch the device history
            return accounting.simulate_expected_output(
                output_offset=self.dev.output_offset,
                input_index=int(self.dev.input_index),
                flags=self.host.flags, num_samples=self.dev.num_samples,
                num_taps=self.dev.num_taps, n_in=n_in, ratio=ratio,
                fixed_ratio=self.host.fixed_ratio)
        return self.host.get_expected_output(n_in, ratio)

    def process_interleaved(self, data, n_in: int, n_out: int,
                            ratio: float = 0.0):
        out, res, dev = self.process_interleaved_device(data, n_in, n_out,
                                                        ratio)
        if dev is not None:
            out = np.ascontiguousarray(
                dev[:, :res.output_generated].cpu().numpy().T)
        return out, res

    def process(self, data, n_in: int, n_out: int, ratio: float = 0.0):
        """Planar process (host-engine contract: inputs [ch, n] -> output
        [ch, K]), routed through the interleaved path."""
        inter = None if data is None else \
            np.ascontiguousarray(np.asarray(data).T)
        out, res = self.process_interleaved(inter, n_in, n_out, ratio)
        return np.ascontiguousarray(out.T), res

    def process_and_flush_interleaved(self, data, n_in: int, n_out: int,
                                      ratio: float = 0.0):
        """Process the final block then flush in one call (reference
        resampleProcessAndFlushInterleaved, resampler.c:741-758)."""
        out1, res = self.process_interleaved(data, n_in, n_out, ratio)
        if res.input_used != n_in or res.output_generated == n_out:
            return out1, res
        out2, fres = self.process_interleaved(
            None, -1, n_out - res.output_generated, ratio)
        res.output_generated += fres.output_generated
        return np.concatenate([out1, out2], axis=0), res

    def process_and_flush(self, data, n_in: int, n_out: int,
                          ratio: float = 0.0):
        inter = None if data is None else \
            np.ascontiguousarray(np.asarray(data).T)
        out, res = self.process_and_flush_interleaved(inter, n_in, n_out,
                                                      ratio)
        return np.ascontiguousarray(out.T), res

    def process_interleaved_device(self, data, n_in: int, n_out: int,
                                   ratio: float = 0.0):
        """process_interleaved that leaves a steady block's output on the
        device.

        Returns (host_out | None, ResampleResult, dev_out | None): when the
        device engine ran the block, dev_out is its [channels, capacity]
        tensor (the first output_generated columns valid) and host_out is
        None."""
        prefill_pending = bool(self.host.flags & EXTRAPOLATE_PREFILL)
        if n_in < 0 or data is None:
            # flush: the host engine (extrapolated postfill, FLUSHED latch)
            if self._on_device:
                self._pull()
            return (*self.host.process_interleaved(data, n_in, n_out,
                                                   ratio), None)
        if self._steady_n is None:
            self._steady_n = n_in
        if n_in != self._steady_n or prefill_pending:
            # the first block (prefill) and tail blocks run on the host
            if self._on_device:
                self._pull()
            return (*self.host.process_interleaved(data, n_in, n_out,
                                                   ratio), None)
        if not self._on_device:
            self._push()
        if self.dev.peek_output(n_in) > n_out:
            # undersized caller buffer: route to the host engine, which has
            # the partial-consumption semantics, before any state moves
            self._pull()
            return (*self.host.process_interleaved(data, n_in, n_out,
                                                   ratio), None)
        out_dev, K = self.dev.process(
            np.ascontiguousarray(np.asarray(data).T), n_in)
        return None, ResampleResult(input_used=n_in, output_generated=K), \
            out_dev
