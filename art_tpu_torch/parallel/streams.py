"""Device-resident fixed-ratio streaming resampler (PyTorch port).

The counterpart of ``art_tpu/parallel/streams.py::DeviceStreamResampler`` in
its reduced float32 mode.  Audio and history stay on the engine's device;
the host does only the scalar consume/emit accounting per chunk, with the
port's copy of the JAX engine's float64 code (``core/accounting.py``), so
counts and positions match it exactly.  Each chunk is one call of
``ops.fixed_step.fixed_step``: kernel K1 on a CUDA device, its plain version
on the CPU.

Not ported yet, and raising ``NotImplementedError`` (ROADMAP.md, "Modules to
port"): the interpolated fixed-rational mode (item 4), the group-dispatch
forms ``process_scan``/``process_flat*`` (item 3), float64 data and the
``precise`` tiers (item 5), and ``mesh=`` (item 11).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device
from ..core import accounting
from ..core.filters import make_filter_bank, plan_fixed_ratio, resolve_lowpass
from ..core.flags import (BLACKMAN_HARRIS, EXTRAPOLATE_ENDPOINTS,
                          INCLUDE_LOWPASS, SUBSAMPLE_INTERPOLATE)
from ..ops.fixed_step import fixed_step
from ..ops.polyphase import PolyphaseMatrix


def _not_ported(what: str, item: int) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported to art_tpu_torch yet "
                               f"(ROADMAP.md, 'Modules to port', item "
                               f"{item})")


class DeviceStreamResampler:
    """Fixed-ratio streaming resampler with device-resident state.

    Reduced float32 configurations only (the reference's fast path, filter
    reduction succeeded).  ``device``: where audio, history and the
    phase-anchor matrices live; "cuda" raises when no card is usable.
    ``process`` takes torch tensors (or arrays) [ch, n_in] and returns
    device tensors, with the JAX engine's signatures and shapes."""

    def __init__(self, num_channels: int, num_taps: int, max_filters: int,
                 source_rate: float, destin_rate: float, lowpass_freq: float,
                 flags: int, *, dtype=np.float32, mesh=None,
                 precise: bool = False, device="cuda"):
        if flags & EXTRAPOLATE_ENDPOINTS:
            raise ValueError("EXTRAPOLATE_ENDPOINTS is not modeled by the "
                             "device engine; use the host Resampler")
        if np.dtype(dtype) != np.float32:
            raise _not_ported("dtype=float64 data", 5)
        if precise:
            raise _not_ported(f"precise={precise!r}", 5)
        if mesh is not None:
            raise _not_ported("mesh=", 11)
        self.device = resolve_device(device)
        plan = plan_fixed_ratio(num_taps, max_filters, source_rate,
                                destin_rate, lowpass_freq, flags)
        if plan.flags & SUBSAMPLE_INTERPOLATE:
            raise _not_ported("the interpolated fixed-rational mode", 4)
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
                                     np.float32)
        self.L = self.num_filters
        self.M = int(round(self.L / self.fixed_ratio))
        self.qn = -(-(self.M + num_taps) // self.M)
        self._flushed = False
        self.output_offset = float(num_taps // 2)
        self.input_index = num_taps
        self.hist = torch.zeros((num_channels, self.num_samples),
                                dtype=torch.float32, device=self.device)
        self._mats: dict[int, torch.Tensor] = {}

    # ----------------------------------------------------------------- api
    def advance_position(self, delta: float) -> None:
        if delta < 0.0 or math.floor(delta) != delta:
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
        zeros = torch.zeros((self.num_channels, half), dtype=torch.float32,
                            device=self.device)
        result = self.process(zeros, half)
        self._flushed = True
        return result

    def prewarm(self) -> None:
        """Build and upload all L phase-anchor matrices, so streaming never
        pauses for a host-side matrix build."""
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
            P = np.zeros((self.qn * self.M, self.L), dtype=np.float32)
            P[:pm.S, :] = pm.P.T
            m = torch.from_numpy(P).to(self.device)
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
        # adopt the plan's state advance verbatim: it reproduces the
        # reference's ring-slide arithmetic exactly
        self.output_offset = plan.new_output_offset
        self.input_index = plan.new_input_index
        return K, start, j0, pos0

    def process(self, x, n_in: int, acc=None):
        """x: [ch, n_in] (wider buffers are cut to n_in).  Returns (out
        [ch, nb*L] with entries beyond K zeroed, K), or (out, K, acc') when
        a running output-power accumulator is passed.  All n_in inputs are
        consumed."""
        if self._flushed:
            out = torch.zeros((self.num_channels, self.L),
                              dtype=torch.float32, device=self.device)
            return (out, 0) if acc is None else (out, 0, acc)
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.shape[1] != n_in:
            if x.shape[1] < n_in:
                raise ValueError(f"x has {x.shape[1]} columns < n_in "
                                 f"{n_in}")
            x = x[:, :n_in]
        K, start, j0, _ = self._plan(n_in)
        nb = -(-K // self.L) if K else 1
        acc_in = acc if acc is not None else torch.zeros(
            (), dtype=torch.float32, device=self.device)
        self.hist, out, acc_out = fixed_step(
            self.hist, x, self._matrix(j0), start, K, acc_in, M=self.M,
            L=self.L, nb=nb, qn=self.qn, hist_len=self.num_samples)
        if acc is None:
            return out, K
        return out, K, acc_out

    # ----------------------------------------------------- streaming state
    def state_dict(self) -> dict:
        """Streaming state as plain host values, with the host engine's keys
        (engines/resampler.py state_dict): history [ch, num_samples] float32,
        output_offset, input_index and the FLUSHED latch."""
        return {"history": self.hist.cpu().numpy().copy(),
                "output_offset": float(self.output_offset),
                "input_index": int(self.input_index),
                "flushed": bool(self._flushed)}

    def load_state(self, state: dict) -> None:
        hist = np.asarray(state["history"], dtype=np.float32)
        if hist.shape != (self.num_channels, self.num_samples):
            raise ValueError(f"history shape {hist.shape}, expected "
                             f"{(self.num_channels, self.num_samples)}")
        self.hist = torch.from_numpy(hist.copy()).to(self.device)
        self.output_offset = float(state["output_offset"])
        self.input_index = int(state["input_index"])
        self._flushed = bool(state["flushed"])

    # ------------------------------------------------ not in this slice yet
    def process_scan(self, xs, n_in: int, acc=None, stats: bool = False):
        raise _not_ported("process_scan", 3)

    def process_flat(self, xs_flat, n_in: int, acc):
        raise _not_ported("process_flat", 3)

    def process_flat_out(self, xs_flat, n_in: int):
        raise _not_ported("process_flat_out", 3)

    def process_flat_packed(self, xs_flat, n_in: int, clips, **kwargs):
        raise _not_ported("process_flat_packed", 3)
