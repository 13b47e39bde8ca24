"""Batched asynchronous sample-rate conversion (ASRC), PyTorch port.

The counterpart of ``art_tpu/parallel/asrc.py`` (BASELINE config 5):
hundreds of concurrent streams, each with a continuously drifting ratio and
an exactly recoverable phase position (reference resampler.c:937-968), all
advanced in one batched device step per call.

- The per-call accounting is the JAX engine's host float64 code, verbatim:
  emission counts (with the ring-coordinate slide re-rounding at ties,
  ``core.accounting.ring_floor``), offsets, the FLUSHED latch and the
  phase-position query match it exactly.
- Audio, history and the phase bank stay on the engine's device.  Each call
  is one launch of the ASRC step kernel (``ops/asrc_step.py``: float32 or
  float64), or, with ``kernel="pallas"``, the device prologue and one launch
  of the two-phase apply kernel.  On the CPU the same calls take the
  kernels' plain versions.

The TPU engine's per-call choice among the Hankel, dense and XLA
formulations existed because of Mosaic's tile geometry; one Hopper kernel
takes any stream count and any positive ratio, so ``"auto"``, ``"hankel"``
and ``"dense"`` all run it.  ``dense_kb``/``hankel_kb`` still set the output
capacity buckets, so output shapes equal the JAX engine's.

Not ported yet, and raising ``NotImplementedError`` (ROADMAP.md, "Modules to
port"): ``mesh=`` (item 11).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from .._device import resolve_device, to_device, torch_dtype
from .._roadmap import _not_ported
from ..core.accounting import ring_floor
from ..core.filters import make_filter_bank, resolve_lowpass
from ..core.flags import (BLACKMAN_HARRIS, EXTRAPOLATE_ENDPOINTS,
                          HISTORY_MULTIPLE, SUBSAMPLE_INTERPOLATE,
                          validate_taps_filters)
from ..engines.resampler import ResampleResult
from ..ops.asrc_step import apply_prologue, asrc_apply, asrc_step
from ..utils.spans import CALL, PLAN, build, span, spanned, upload

KERNELS = ("auto", "hankel", "dense", "pallas", "xla")


class BatchedASRC:
    """S independent drifting-ratio resampler streams, device-resident."""

    def __init__(self, num_streams: int, num_taps: int, num_filters: int,
                 *, dtype=np.float32, blackman_harris: bool = True,
                 kernel: str = "auto", mesh=None, dense_kb: int = 128,
                 hankel_kb: int = 128, hankel_smax: int = 4,
                 hankel_smax_wide: int = 64, lowpass_ratio: float = 1.0,
                 device="cuda"):
        """The JAX engine's signature plus ``device`` ("cuda" raises when
        no card is usable).

        ``kernel``: "auto", "hankel" and "dense" run the ASRC step kernel;
        "pallas" runs the device prologue and the two-phase apply kernel
        (float32 only on a card); "xla" names the plain PyTorch step and is
        accepted only on the CPU, since nothing on the card's path may run
        it.  ``dense_kb``/``hankel_kb`` are validated and bucket the output
        capacity as in JAX; ``hankel_smax``/``hankel_smax_wide`` were the
        TPU Hankel tiers' ratio bounds and are accepted for the signature
        only: the Hopper kernel has no such bound, so a value other than
        the default warns that it changes nothing."""
        validate_taps_filters(num_taps, num_filters)
        if (hankel_smax, hankel_smax_wide) != (4, 64):
            warnings.warn("hankel_smax/hankel_smax_wide bound the TPU "
                          "Hankel tiers and have no effect here",
                          stacklevel=2)
        if mesh is not None:
            raise _not_ported("mesh=", 11)
        if kernel not in KERNELS:
            raise ValueError(f"kernel must be one of {KERNELS}, got "
                             f"{kernel!r}")
        self.dtype = np.dtype(dtype)
        self._tdtype = torch_dtype(self.dtype)
        self.device = resolve_device(device)
        if self.device.type == "cuda" and (
                kernel == "xla"
                or (kernel == "pallas" and self.dtype == np.float64)):
            raise ValueError(
                f"kernel={kernel!r} with {self.dtype} has no kernel on the "
                "card: 'xla' is the plain CPU step and the 'pallas' apply "
                "kernel is float32; use kernel='auto'")
        self.S = num_streams
        self.num_taps = num_taps
        self.num_filters = num_filters
        self.num_samples = num_taps * HISTORY_MULTIPLE
        self.kernel = kernel
        # lowpass folds into the sinc argument exactly like the fixed
        # engines (reference init_filter, resampler.c:1111); 1.0 = none
        self.lowpass_ratio = float(lowpass_ratio)
        with build("bank"):
            self.bank = make_filter_bank(num_taps, num_filters,
                                         self.lowpass_ratio, blackman_harris,
                                         self.dtype.type)
            self._bank_dev = torch.from_numpy(self.bank).to(self.device)
        if kernel in ("auto", "dense", "hankel"):
            if dense_kb & (dense_kb - 1) or dense_kb < 128:
                raise ValueError("dense_kb must be a power of two >= 128")
            if hankel_kb % 128 or hankel_kb < 128:
                raise ValueError("hankel_kb must be a multiple of 128")
            self._kb = dense_kb
            self._hkb = hankel_kb
        self.offsets = np.full(num_streams, float(num_taps // 2),
                               dtype=np.float64)
        self.input_index = num_taps
        self.flushed = np.zeros(num_streams, dtype=bool)
        self._flushed_pos = np.zeros(num_streams, dtype=np.float64)
        self.hist = torch.zeros((num_streams, self.num_samples),
                                dtype=self._tdtype, device=self.device)

    def state_dict(self) -> dict:
        """Full streaming state with the JAX engine's keys: (buffers,
        offsets, index) exactly like the reference context
        (resampler.h:44-58), plus the FLUSHED latch."""
        return {
            "offsets": self.offsets.copy(),
            "input_index": int(self.input_index),
            "hist": self.hist.cpu().numpy().copy(),
            "flushed": self.flushed.copy(),
            "flushed_pos": self._flushed_pos.copy(),
        }

    def load_state(self, state: dict) -> None:
        hist = np.asarray(state["hist"], self.dtype)
        if hist.shape != (self.S, self.num_samples):
            raise ValueError(f"history shape {hist.shape}, expected "
                             f"{(self.S, self.num_samples)}")
        self.offsets = np.asarray(state["offsets"], np.float64).copy()
        self.input_index = int(state["input_index"])
        self.flushed = np.asarray(
            state.get("flushed", np.zeros(self.S, bool))).copy()
        self._flushed_pos = np.asarray(
            state.get("flushed_pos", np.zeros(self.S))).copy()
        self.hist = torch.from_numpy(hist.copy()).to(self.device)

    def advance_position(self, delta) -> None:
        self.offsets += np.asarray(delta, dtype=np.float64)

    def get_position(self) -> np.ndarray:
        """Exact per-stream phase (reference resampler.c:965-968); frozen
        at flush time for FLUSHED streams (their context index stopped
        advancing with the batch)."""
        live = self.offsets + (self.num_taps / 2.0) - self.input_index
        return np.where(self.flushed, self._flushed_pos, live)

    def _ring_ok(self, ratios, k, n):
        """Emission-k feasibility with the reference's ring-coordinate
        slide re-rounding (resampler.c:500-501, 526): the loop compares
        fl((offset - s*S) + fl(k/ratio)) < bound - s*S, where s is the
        slide count at the emission's consume boundary (the scalar form
        and full analysis: core.accounting.ring_floor).  ``k``: int array
        broadcastable against ratios; returns a bool array of that shape."""
        offs = self.offsets
        q = np.asarray(k, np.int64) / ratios
        if q.ndim == 2:
            offs = offs[:, None]
        ip = ring_floor(offs, q, self.input_index, n, self.num_samples,
                        self.num_taps)
        return ip < (self.input_index + n - self.num_taps // 2)

    def _bucketed_k_max(self, req_k_max, estimate: int) -> int:
        """Output capacity, bucketed as the JAX engine buckets its static
        kernel capacity (so output shapes match it).  An explicitly
        requested capacity buckets STRICTLY above itself so the host count
        at req_k_max is never clipped (an exactly-full request is legal);
        the bucket then coarsens geometrically (~1/16 granularity)."""
        pallas_family = self.kernel in ("auto", "dense", "hankel")
        bucket = max(self._kb, self._hkb) if pallas_family else 128
        want = estimate if req_k_max is None else req_k_max + 1
        kp = -(-want // bucket) * bucket
        g = max(bucket, (kp >> 4) // bucket * bucket)
        return -(-kp // g) * g

    @staticmethod
    def _check_capacity(kmx: int, k_max: int, req_k_max, what: str) -> None:
        """Counts saturating the padded capacity are ambiguous (the
        estimate was clipped there); an EXACTLY-full requested capacity is
        not -- the host count is exact and k_max > req_k_max by
        construction, so kmx == req_k_max is legal."""
        if kmx >= k_max or (req_k_max is not None and kmx > req_k_max):
            raise ValueError(f"k_max too small for {what}")

    def _input(self, x) -> torch.Tensor:
        with upload(x, self.device):
            x = torch.as_tensor(x, dtype=self._tdtype, device=self.device)
        if x.ndim != 2 or x.shape[0] != self.S:
            raise ValueError(f"x must be [{self.S}, n], got "
                             f"{tuple(x.shape)}")
        return x.contiguous()

    @spanned(CALL)
    def process(self, x, ratios, k_max: int | None = None):
        """x: [S, n] (a tensor on the engine's device, or anything
        torch.as_tensor takes); ratios: [S] per-call drifting ratios.

        Consumes all n inputs on every stream; emits K_s <= k_max outputs
        per stream (outputs beyond K_s zeroed).  Returns (out [S, k_max]
        on the device, Ks int32 [S] on the host)."""
        x = self._input(x)
        n = x.shape[1]
        with span(PLAN):
            ratios, Ks, k_max, req_k_max = self._plan(n, ratios, k_max)
        new_hist, out = self._run_step(x, ratios, Ks, k_max, req_k_max)
        self.hist = new_hist

        # advance per-stream offsets with the reference ring-slide
        # arithmetic (all streams consume the same count, so the write index
        # stays shared); exact-integer shifts preserve float-tie behavior
        slide = self.num_samples - self.num_taps
        n_slides = max(0, math.ceil(
            (self.input_index + n - self.num_samples) / slide))
        self.input_index = self.input_index + n - n_slides * slide
        self.offsets = (self.offsets - n_slides * slide) + Ks / ratios
        return out, Ks

    def _plan(self, n: int, ratios, k_max: int | None):
        """The host half of process(n): (effective ratios, Ks int32 [S],
        bucketed capacity, requested capacity); no state is mutated."""
        half = self.num_taps // 2
        ratios = np.asarray(ratios, dtype=np.float64)
        # a latched stream's caller-supplied ratio is dead weight: it must
        # not inflate the capacity estimate; its Ks is zeroed below and its
        # offsets stay frozen via get_position, so 1.0 is inert
        ratios = np.where(self.flushed, 1.0, ratios)
        req_k_max = k_max
        k_max = self._bucketed_k_max(
            req_k_max, int(np.ceil((n + 2) * ratios.max())) + 2)

        # per-stream emission counts: pos_k = offset + k/ratio is strictly
        # increasing, so a closed-form estimate bracket-corrected at the
        # boundary reproduces the exact per-k comparison (including the
        # ring-coordinate slide re-rounding at ties) in O(S)
        bound = self.input_index + n - half
        est = np.floor((bound - self.offsets) * ratios).astype(np.int64)
        est = np.clip(est, 0, k_max)
        for _ in range(64):     # ok(est-1) and not ok(est) exactly
            over = (est > 0) & ~self._ring_ok(ratios, est - 1, n)
            under = (est < k_max) & self._ring_ok(ratios, est, n)
            if not (over.any() or under.any()):
                break
            est = est - over + under
        else:   # estimate off by >64: fall back to the exact grid --
            # counted as the reference's PREFIX (the loop ends at the
            # first blocked emission), not the total of feasible ks
            ks = np.arange(k_max, dtype=np.int64)
            okg = self._ring_ok(ratios[:, None], ks[None, :], n)
            est = np.where(okg.all(axis=1), k_max,
                           np.argmin(okg, axis=1))
        Ks = est.astype(np.int32)
        Ks[self.flushed] = 0            # latched streams ignore input
        kmx = int(Ks.max(initial=0))
        self._check_capacity(kmx, k_max, req_k_max, "requested chunk")
        return ratios, Ks, k_max, req_k_max

    @spanned(CALL)
    def flush(self, ratios, mask=None, k_max: int | None = None):
        """End the masked streams: emit their final half-filter of output
        from a zero postfill and latch them FLUSHED (reference
        postfillAllChannels + RESAMPLER_FLUSHED, resampler.c:663-698,
        438-439; the zero-postfill mode).  Streams NOT in ``mask`` are
        untouched: the zero postfill never enters the shared history, so
        live streams keep serving.  Flushed streams return 0 outputs from
        later calls and their phase position freezes.

        Returns (out [S, k_max], Ks [S]) with rows outside ``mask`` zero.
        """
        half = self.num_taps // 2
        with span(PLAN):
            ratios, mask, Ks, k_max, req_k_max, shift = self._plan_flush(
                ratios, mask, k_max)
        if Ks.max(initial=0) == 0:
            # nothing to emit (empty/already-flushed mask): no launch
            out_cols = req_k_max if req_k_max is not None else k_max
            out = torch.zeros((self.S, out_cols), dtype=self._tdtype,
                              device=self.device)
        else:
            x = torch.zeros((self.S, half), dtype=self._tdtype,
                            device=self.device)
            _discard_hist, out = self._run_step(x, ratios, Ks, k_max,
                                                req_k_max)

        # the reference accumulates outputOffset in the slid coordinates
        # (oo_ring + offset2 rounds there); position = oo_f + half - idx_f
        final_ring = (self.offsets - shift) + Ks / ratios
        self._flushed_pos = np.where(
            mask, final_ring - (self.input_index - shift),
            self._flushed_pos)
        self.offsets = np.where(mask, final_ring + shift, self.offsets)
        self.flushed = self.flushed | mask
        return out, Ks

    def _plan_flush(self, ratios, mask, k_max: int | None):
        """The host half of flush(): (effective ratios, effective mask, Ks
        int32 [S], bucketed capacity, requested capacity, ring shift); no
        state is mutated."""
        half = self.num_taps // 2
        ratios = np.asarray(ratios, dtype=np.float64)
        if mask is None:
            mask = np.ones(self.S, dtype=bool)
        mask = np.asarray(mask, bool) & ~self.flushed

        # only masked streams emit; other streams' ratios must not steer
        # the capacity (see process())
        ratios = np.where(mask, ratios, 1.0)
        req_k_max = k_max
        k_max = self._bucketed_k_max(
            req_k_max, int(np.ceil((half + 2) * ratios.max())) + 2)

        # final emission counts: the zero postfill raises the input bound
        # by half and emission stops at idx_f - half = input_index
        # (reference resampler.c:882-918 flush simulation).  If the pad
        # would not fit, postfill slides the ring FIRST (resampler.c:667-
        # 672) and the emission compare then runs in slid coordinates --
        # an integer shift of both sides that re-rounds the float compare
        # at ties (no further slides occur during flush, so one static
        # shift suffices)
        shift = (self.num_samples - self.num_taps
                 if self.num_samples - self.input_index < half else 0)
        bound = self.input_index - shift
        ks = np.arange(k_max, dtype=np.float64)
        Ks = (((self.offsets - shift)[:, None] + ks[None, :]
               / ratios[:, None]) < bound).sum(axis=1).astype(np.int32)
        Ks[~mask] = 0
        self._check_capacity(int(Ks.max(initial=0)), k_max, req_k_max,
                             "flush")
        return ratios, mask, Ks, k_max, req_k_max, shift

    def _run_step(self, x, ratios, Ks, k_max, req_k_max):
        """One batched chunk on the device: (new_hist, out [S, k_max], cut
        to req_k_max columns when one was requested) without committing any
        engine state."""
        dev = self.device
        offsets = to_device(self.offsets, dev)
        ratios_t = to_device(ratios, dev)
        Ks_t = to_device(Ks, dev)
        shift = self.num_samples - self.input_index
        geometry = dict(num_taps=self.num_taps,
                        num_filters=self.num_filters, k_max=k_max,
                        hist_len=self.num_samples)
        if self.kernel == "pallas":
            buf, base, fi, frac, new_hist = apply_prologue(
                self.hist, x, offsets, ratios_t, shift, **geometry)
            out = asrc_apply(buf, self._bank_dev, base, fi, frac)
            valid = torch.arange(k_max, device=dev)[None, :] < Ks_t[:, None]
            out = out * valid.to(out.dtype)
        else:
            new_hist, out = asrc_step(self.hist, x, self._bank_dev, offsets,
                                      ratios_t, Ks_t, shift, **geometry)
        if req_k_max is not None and req_k_max != k_max:
            out = out[:, :req_k_max]
        return new_hist, out


class ASRCStreamResampler:
    """artest/host-API adapter over BatchedASRC: the runtime-ratio
    interpolated resampler on the device, channels riding as streams.

    The device form of the reference's plain ``resampleInit`` +
    per-call-ratio ``resampleProcess`` contract (reference
    resampler.c:433-541 with SUBSAMPLE_INTERPOLATE) -- the path ``artest``
    takes WITHOUT ``-e`` (reference artest.c:380-437).  Exposes the host
    engine's ``process_interleaved`` / ``process_and_flush_interleaved``
    surface.  Counts and positions are exact against the C semantics (the
    engine's ring-tie bracket).  Each channel is one stream: the kernel
    takes any stream count, so the rows are not padded to the Pallas
    geometry's 8 as in JAX."""

    def __init__(self, num_channels: int, num_taps: int, num_filters: int,
                 lowpass_ratio: float, flags: int, *, dtype=np.float32,
                 kernel: str | None = None, device="cuda"):
        if kernel is None:
            # JAX's default picks its TPU kernels on a TPU and its XLA step
            # elsewhere; here the kernel path is "auto" on either device
            kernel = "auto"
        if not (flags & SUBSAMPLE_INTERPOLATE):
            raise ValueError("ASRCStreamResampler is the interpolated "
                             "runtime-ratio engine; pass "
                             "SUBSAMPLE_INTERPOLATE (use the fixed-ratio "
                             "device engines otherwise)")
        if flags & EXTRAPOLATE_ENDPOINTS:
            raise ValueError("EXTRAPOLATE_ENDPOINTS is not modeled by the "
                             "device ASRC engine; use the host Resampler")
        lowpass_ratio, flags = resolve_lowpass(lowpass_ratio, flags)
        self._ch = num_channels
        self.flags = flags
        self.lowpass_ratio = lowpass_ratio
        self.num_taps = num_taps
        self.asrc = BatchedASRC(num_channels, num_taps, num_filters,
                                dtype=dtype,
                                blackman_harris=bool(flags
                                                     & BLACKMAN_HARRIS),
                                kernel=kernel, lowpass_ratio=lowpass_ratio,
                                device=device)
        self.dtype = self.asrc.dtype

    # ------------------------------------------------------------- queries
    def advance_position(self, delta: float) -> None:
        self.asrc.advance_position(float(delta))

    def get_position(self) -> float:
        return float(self.asrc.get_position()[0])

    def get_lowpass_ratio(self) -> float:
        return self.lowpass_ratio

    def get_num_filters(self) -> int:
        return self.asrc.num_filters

    def interpolation_used(self) -> int:
        return 1

    # ------------------------------------------------------------- process
    def _ratios(self, ratio: float) -> np.ndarray:
        if not ratio or ratio <= 0.0:
            raise ValueError("the runtime-ratio engine needs a positive "
                             "per-call ratio (reference resampleProcess "
                             "ratio argument)")
        return np.full(self._ch, float(ratio), np.float64)

    def _deliver(self, out, Ks) -> tuple[np.ndarray, int]:
        K = int(Ks[0])
        if not (Ks == K).all():
            raise RuntimeError(f"channels emitted different counts {Ks}")
        buf = np.ascontiguousarray(
            out[:, :K].cpu().numpy().T.astype(self.dtype))
        return buf, K

    def process_interleaved(self, data, n_in: int, n_out: int,
                            ratio: float = 0.0):
        """Reference resampleProcessInterleaved semantics for the artest
        harness shape: consumes all n_in frames (the harness sizes n_out
        to worst case and treats saturation as fatal, artest.c:486-489);
        flush via n_in < 0.  Returns ([K, ch] host array,
        ResampleResult)."""
        if n_in is not None and n_in < 0:
            return self._flush(n_out, ratio)
        host = np.ascontiguousarray(
            np.asarray(data, self.dtype)[:n_in].T)
        out, Ks = self.asrc.process(host, self._ratios(ratio), k_max=n_out)
        buf, K = self._deliver(out, Ks)
        return buf, ResampleResult(n_in, K)

    def _flush(self, n_out: int, ratio: float):
        out, Ks = self.asrc.flush(self._ratios(ratio), k_max=n_out)
        buf, K = self._deliver(out, Ks)
        return buf, ResampleResult(0, K)

    def process(self, data, n_in: int, n_out: int, ratio: float = 0.0):
        """Planar form (host-engine contract: [ch, n] in, [ch, K] out)."""
        inter = None if data is None else \
            np.ascontiguousarray(np.asarray(data).T)
        out, res = self.process_interleaved(inter, n_in, n_out, ratio)
        return np.ascontiguousarray(out.T), res

    def process_and_flush_interleaved(self, data, n_in: int, n_out: int,
                                      ratio: float = 0.0):
        """Process the final block then flush in one call (reference
        resampleProcessAndFlushInterleaved, resampler.c:741-758)."""
        out1, res = self.process_interleaved(data, n_in, n_out, ratio)
        out2, fres = self._flush(n_out - res.output_generated, ratio)
        res.output_generated += fres.output_generated
        return np.concatenate([out1, out2], axis=0), res

    def process_and_flush(self, data, n_in: int, n_out: int,
                          ratio: float = 0.0):
        inter = None if data is None else \
            np.ascontiguousarray(np.asarray(data).T)
        out, res = self.process_and_flush_interleaved(inter, n_in, n_out,
                                                      ratio)
        return np.ascontiguousarray(out.T), res
