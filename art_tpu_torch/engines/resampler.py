"""Streaming windowed-sinc resampler engine.

The public surface mirrors the reference's 14 entry points
(reference resampler.h:64-78): init / fixed-ratio init, process /
process_interleaved (+ *_and_flush), dry-run queries, position advance/query,
reset, and config queries.  State is explicit and serializable: a
``[channels, 16*num_taps]`` history, a float64 fractional read offset and an
integer write index — the exact (buffers, outputOffset, inputIndex, flags)
tuple of the reference context (reference resampler.h:44-58), so
checkpoint/resume is a trivial save of this object's arrays.

Architecture (TPU-first, not a C translation):
  - all per-call control flow is resolved on the host by
    core.accounting.plan_process — the data-dependent consume/emit loop of
    the reference collapses to a closed form,
  - the device sees only a pure gather + batched matvec over precomputed
    positions (ops/resample_kernel), or the strided-conv polyphase kernel for
    fixed-ratio steady state (ops/polyphase),
  - channels are a vectorized batch axis (the reference's worker-thread pool,
    workers.c, has no equivalent here: XLA schedules the channel axis).

Flush semantics (RESAMPLER_FLUSHED latch), LPC endpoint extrapolation
(EXTRAPOLATE_ENDPOINTS / prefill), and the snap-to-grid offset rule for
reduced non-power-of-two filter banks all follow the reference
(reference resampler.c:383-397, 663-698, 533-535).

A copy of ``art_tpu/engines/resampler.py`` but for its accelerator
backend: ``backend="torch"`` takes the place of JAX's ``backend="jax"``,
on the same branches (the polyphase fast path on kernel K1, every other
call on the ASRC apply kernel K5 through ``apply_torch``), with a
``device=`` keyword (None: "cuda", which raises when no card is usable; a
CPU device runs the kernels' plain versions).  The phase bank is uploaded
once, at construction; counts, positions, flush, extrapolation and the
state stay the host's, so a ``state_dict`` resumes under either backend.
``backend="jax"`` raises a ValueError naming "torch".
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import accounting
from ..core.filters import make_filter_bank, plan_fixed_ratio, resolve_lowpass
from ..core.flags import (
    BLACKMAN_HARRIS, EXTRAPOLATE_ENDPOINTS, EXTRAPOLATE_PREFILL, HISTORY_MULTIPLE,
    INCLUDE_LOWPASS, RESAMPLE_FIXED_RATIO, RESAMPLER_FLUSHED,
    SUBSAMPLE_INTERPOLATE, validate_taps_filters,
)
from .._device import resolve_device
from ..ops import resample_kernel
from . import extrapolator


@dataclass
class ResampleResult:
    input_used: int
    output_generated: int


class Resampler:
    """Streaming resampler; one instance per independent stream."""

    def __init__(self, num_channels: int, num_taps: int, num_filters: int,
                 lowpass_ratio: float, flags: int, *, dtype=np.float32,
                 backend: str = "numpy", device=None):
        if backend == "jax":
            raise ValueError("backend='jax' is the JAX package's; the "
                             "port's accelerator backend is "
                             "backend='torch'")
        validate_taps_filters(num_taps, num_filters)
        lowpass_ratio, flags = resolve_lowpass(lowpass_ratio, flags)

        self.num_channels = num_channels
        self.num_taps = num_taps
        self.num_filters = num_filters
        self.num_samples = num_taps * HISTORY_MULTIPLE
        self.lowpass_ratio = lowpass_ratio
        self.flags = flags
        self.fixed_ratio = 0.0
        self.dtype = np.dtype(dtype)
        self.backend = backend

        if flags & EXTRAPOLATE_ENDPOINTS:
            self.flags |= EXTRAPOLATE_PREFILL

        self.bank = make_filter_bank(num_taps, num_filters, lowpass_ratio,
                                     bool(flags & BLACKMAN_HARRIS),
                                     self.dtype.type)

        self.history = np.zeros((num_channels, self.num_samples),
                                dtype=self.dtype)
        self.output_offset = float(num_taps // 2)
        self.input_index = num_taps
        self._period = None        # (Lp, Mp) exact rational period, if any
        self._bank_dev = None
        self._poly = None
        if backend == "torch":
            self.device = resolve_device("cuda" if device is None
                                         else device)
            self._bank_dev = torch.from_numpy(self.bank).to(self.device)

    # ------------------------------------------------------------------ init
    @classmethod
    def fixed_ratio(cls, num_channels: int, num_taps: int, max_filters: int,
                    source_rate: float, destin_rate: float,
                    lowpass_freq: float, flags: int, *, dtype=np.float32,
                    backend: str = "numpy", device=None) -> "Resampler":
        """Fixed-ratio constructor (reference resampler.c:310-356)."""
        plan = plan_fixed_ratio(num_taps, max_filters, source_rate,
                                destin_rate, lowpass_freq, flags)
        self = cls(num_channels, num_taps, plan.num_filters,
                   plan.lowpass_ratio, plan.flags, dtype=dtype,
                   backend=backend, device=device)
        self.fixed_ratio = plan.fixed_ratio
        if float(source_rate).is_integer() and float(destin_rate).is_integer():
            import math as _math
            g = _math.gcd(int(source_rate), int(destin_rate))
            if g:
                self._period = (int(destin_rate) // g, int(source_rate) // g)
        return self

    # --------------------------------------------------------------- queries
    def get_lowpass_ratio(self) -> float:
        return self.lowpass_ratio

    def get_num_filters(self) -> int:
        return self.num_filters

    def interpolation_used(self) -> int:
        return self.flags & SUBSAMPLE_INTERPOLATE

    def extended_math_used(self) -> bool:
        """Whether convolution accumulates above the data-path width.

        The reference's EXTEND_CONVOLUTION_MATH (resampler.c:84-88,
        1159-1181) selects a double-accumulating apply_filter on the f32
        path; here every backend already does so (the host path sums in
        float64, the device path runs full-f32 MXU dots validated against a
        float64 oracle), so the flag is permanently satisfied and this
        query always returns True."""
        return True

    def get_position(self) -> float:
        """ASRC phase query (reference resampler.c:965-968)."""
        return self.output_offset + (self.num_taps / 2.0) - self.input_index

    def advance_position(self, delta: float) -> None:
        """Skip output forward (reference resampler.c:927-935)."""
        if delta < 0.0:
            raise ValueError("can only advance forward")
        if not (self.flags & SUBSAMPLE_INTERPOLATE) and \
                np.floor(delta) != delta:
            raise ValueError("cannot advance partial samples without "
                             "interpolation")
        self.output_offset += delta

    def reset(self) -> None:
        """Discard history, re-arm prefill (reference resampler.c:383-397)."""
        self.history[:] = 0
        self.output_offset = float(self.num_taps // 2)
        self.input_index = self.num_taps
        if self.flags & EXTRAPOLATE_ENDPOINTS:
            self.flags |= EXTRAPOLATE_PREFILL
        self.flags &= ~RESAMPLER_FLUSHED

    def state_dict(self) -> dict:
        """Full streaming state (the reference context's buffers /
        outputOffset / inputIndex / flags tuple) as plain arrays — the
        checkpoint/resume story."""
        return dict(history=self.history.copy(),
                    output_offset=self.output_offset,
                    input_index=self.input_index, flags=self.flags)

    def load_state(self, state: dict) -> None:
        self.history = state["history"].copy()
        self.output_offset = state["output_offset"]
        self.input_index = state["input_index"]
        self.flags = state["flags"]

    def get_required_samples(self, n_out: int, ratio: float) -> int:
        if self.flags & RESAMPLE_FIXED_RATIO:
            ratio = self.fixed_ratio
        return accounting.simulate_required_samples(
            output_offset=self.output_offset, input_index=self.input_index,
            num_samples=self.num_samples, num_taps=self.num_taps,
            n_out=n_out, ratio=ratio)

    def get_expected_output(self, n_in: int, ratio: float) -> int:
        return accounting.simulate_expected_output(
            output_offset=self.output_offset, input_index=self.input_index,
            flags=self.flags, num_samples=self.num_samples,
            num_taps=self.num_taps, n_in=n_in, ratio=ratio,
            fixed_ratio=self.fixed_ratio)

    # --------------------------------------------------------------- process
    def process(self, inputs, n_in: int, n_out: int,
                ratio: float) -> tuple[np.ndarray, ResampleResult]:
        """Planar process: inputs is [channels, n] (or None for flush).

        Returns (output [channels, output_generated], ResampleResult).
        n_in = -1 requests the flush (reference resampler.c:415-421).
        """
        half = self.num_taps // 2
        plan = accounting.plan_process(
            output_offset=self.output_offset, input_index=self.input_index,
            flags=self.flags, num_taps=self.num_taps,
            num_samples=self.num_samples, num_filters=self.num_filters,
            fixed_ratio=self.fixed_ratio, n_in=n_in, n_out=n_out,
            ratio=ratio)

        entry_index = self.input_index
        parts_len = entry_index + (half if plan.flush else 0) + plan.input_used
        L = np.zeros((self.num_channels, parts_len), dtype=self.dtype)
        L[:, :entry_index] = self.history[:, :entry_index]
        if plan.flush:
            if self.flags & EXTRAPOLATE_ENDPOINTS:
                for c in range(self.num_channels):
                    L[c, entry_index:entry_index + half] = \
                        extrapolator.extrapolate_forward(
                            L[c, entry_index - half:entry_index], half)
        elif plan.input_used:
            L[:, entry_index:] = np.asarray(
                inputs, dtype=self.dtype)[:, :plan.input_used]

        if plan.prefill is not None:
            lin_first, nvalues = plan.prefill
            n_extrap = min(self.num_taps - nvalues, lin_first - nvalues)
            for c in range(self.num_channels):
                real = L[c, lin_first - nvalues:lin_first]
                L[c, lin_first - nvalues - n_extrap:lin_first - nvalues] = \
                    extrapolator.extrapolate_reverse(real, n_extrap)

        out = self._compute(L, plan, ratio)

        # persist state
        new_index = plan.new_input_index
        self.history[:, :new_index] = L[:, parts_len - new_index:]
        self.output_offset = plan.new_output_offset
        self.input_index = new_index
        self.flags = plan.new_flags

        return out, ResampleResult(plan.input_used, plan.output_generated)

    def _compute(self, L: np.ndarray, plan, ratio: float) -> np.ndarray:
        interp = bool(self.flags & SUBSAMPLE_INTERPOLATE)
        K = plan.output_generated
        if (self.backend == "torch" and not interp
                and (self.flags & RESAMPLE_FIXED_RATIO) and K):
            poly = self._polyphase()
            if poly is not None and poly.eligible(plan.first_position, K):
                return poly.apply(L, plan.first_position, K, self.dtype)
        # reconstruct the emission positions with the reference's exact
        # ring-coordinate rounding (fl((o - slides) + fl(k/ratio)); see
        # accounting.ring_positions — the linear sum loses sub-ulp fraction
        # bits and can flip phase ties)
        if self.flags & RESAMPLE_FIXED_RATIO:
            ratio = self.fixed_ratio
        if K:
            ipos, frac0 = accounting.ring_positions(
                first_position=plan.first_position,
                flush_shift=plan.flush_shift, ratio=ratio, K=K,
                input_index=self.input_index, input_used=plan.input_used,
                num_samples=self.num_samples, num_taps=self.num_taps,
                flush=plan.flush)
        else:
            ipos = np.zeros(0, dtype=np.int64)
            frac0 = np.zeros(0, dtype=np.float64)
        parts = resample_kernel.decompose_indexed(
            ipos, frac0, self.num_filters, self.num_taps, interp,
            bool(self.flags & INCLUDE_LOWPASS))
        # Window underrun guard (reference defect #5, PARITY.md): the
        # reference's flush-path ring slide (resampler.c:775-779) can
        # leave its output cursor with less than half a filter of
        # retained ring history; its emission then reads before the ring
        # (heap garbage; ASan-verified via subsample_interpolate
        # resampler.c:1155 -> apply_filter:1039).  Our linear buffer L
        # retains the FULL pre-flush history, so those same emissions
        # normally map to real in-bounds samples here.  Defensively, any
        # index that still falls before L (conceivable only via extreme
        # un-drained cursor states) reads leading silence: numpy fancy
        # indexing would otherwise WRAP negative bases to the buffer
        # tail while the jax gather clamps -- both silently wrong.
        lo = int(parts["base"].min(initial=0))
        if parts["pass_mask"].any():
            lo = min(lo, int(parts["pass_idx"][parts["pass_mask"]].min()))
        if lo < 0:
            L = np.concatenate(
                [np.zeros((self.num_channels, -lo), dtype=L.dtype), L],
                axis=1)
            parts["base"] = parts["base"] - lo
            parts["pass_idx"] = parts["pass_idx"] - lo
        if self.backend == "torch":
            return resample_kernel.apply_torch(L, self._bank_dev, parts,
                                               interp, self.dtype)
        if (self.flags & RESAMPLE_FIXED_RATIO) and self._period is not None:
            out = resample_kernel.apply_numpy_periodic(
                L, self.bank, parts, interp, self.dtype, *self._period)
            if out is not None:
                return out
        return resample_kernel.apply_numpy(L, self.bank, parts, interp,
                                           self.dtype)

    def _polyphase(self):
        """Lazy K1 fast path (ops/polyphase.py) for reduced fixed ratios."""
        if self._poly is None and self.fixed_ratio:
            from ..ops.polyphase import PolyphaseKernel
            M = self.num_filters / self.fixed_ratio
            if abs(M - round(M)) < 1e-9 and round(M) >= 1:
                self._poly = PolyphaseKernel(
                    self.bank, self.num_filters,
                    bool(self.flags & INCLUDE_LOWPASS), self.fixed_ratio,
                    device=self.device)
        return self._poly

    def process_interleaved(self, inputs, n_in: int, n_out: int,
                            ratio: float) -> tuple[np.ndarray, ResampleResult]:
        """Interleaved process: inputs [n, channels] -> output [K, channels]."""
        planar = None if inputs is None else \
            np.ascontiguousarray(np.asarray(inputs).T)
        out, res = self.process(planar, n_in, n_out, ratio)
        return np.ascontiguousarray(out.T), res

    def process_and_flush(self, inputs, n_in: int, n_out: int, ratio: float
                          ) -> tuple[np.ndarray, ResampleResult]:
        """Process the final block then flush (reference resampler.c:712-739)."""
        out1, res = self.process(inputs, n_in, n_out, ratio)
        if res.input_used != n_in or res.output_generated == n_out:
            return out1, res
        out2, fres = self.process(None, -1, n_out - res.output_generated,
                                  ratio)
        res.output_generated += fres.output_generated
        return np.concatenate([out1, out2], axis=1), res

    def process_and_flush_interleaved(self, inputs, n_in: int, n_out: int,
                                      ratio: float
                                      ) -> tuple[np.ndarray, ResampleResult]:
        planar = None if inputs is None else \
            np.ascontiguousarray(np.asarray(inputs).T)
        out, res = self.process_and_flush(planar, n_in, n_out, ratio)
        return np.ascontiguousarray(out.T), res
