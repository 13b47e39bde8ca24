"""Float->integer decimation with TPDF dither and noise-shaped error feedback.

Engine-level port of the reference decimator (reference decimator.[ch]):
``Decimator`` carries per-channel state (error feedback, dither LCG states,
noise-shaper biquads — reference decimator.h:42-60) and quantizes float
streams to 4..24-bit little-endian packed bytes, returning the clipped-sample
count.  The stateless inverse helper ``float_integers`` mirrors
floatIntegersLE.

Noise-shaping curves (reference decimator.c:62-89): the Gesemann/Lame ATH
4th-order coefficient sets for the five standard rates, binomial
(1-z^-1)^n generic shapers, and the direct-form N(z) -> decoupled H(z)
refactor a[k] = b[k+1] - a[k+1] (reference decimator.c:389-409).

Compute paths: the dither sequence is always precomputed in closed form
(bit-exact, vectorized); shaped quantization runs as a channels-vectorized
scan (host numpy for parity / lax.scan on device); unshaped quantization is
one fused elementwise pass.

A copy of ``art_tpu/engines/decimator.py`` but for its device halves:
``DeviceDecimator`` and its fused step ``_device_decimate_step`` run on
the port's CUDA kernels (``ops/decimate_device.py``), and
``backend="torch"`` (with ``device=``: None is "cuda", which raises when
no card is usable; a CPU device runs the plain version) takes the place
of JAX's ``backend="jax"``: its shaped modes dither, quantize, count clips
and pack in one launch of the shaped decimate kernel, where JAX dithers on
the host and scans on the device; the flat modes stay the host's, as in
JAX.  ``backend="jax"`` raises a ValueError naming "torch"; the ``numpy``
and ``native`` backends are the original's.

``DeviceDecimator(..., tracks=F)`` quantizes F files at once, each of
``num_channels / F`` channels, channels [t*c, (t+1)*c) being file t's:
every file's channels get the dither seeds of a decimator built for that
file alone (the reference seeds each decimator from the same LCG stream,
decimator.c:40-52), so each file's bytes are those its own decimator
gives.  ``tracks=None`` seeds the channels as one file.
"""

from __future__ import annotations

from contextlib import nullcontext

import numpy as np
import torch

from .._device import resolve_device, torch_dtype
from ..core.flags import (DITHER_ENABLED, DITHER_FLAT, DITHER_HIGHPASS,
                          DITHER_LOWPASS, SHAPING_1ST_ORDER,
                          SHAPING_2ND_ORDER, SHAPING_3RD_ORDER,
                          SHAPING_ATH_CURVE, SHAPING_ENABLED)
from ..ops import decimate_device as dd
from ..ops import decimate_kernel as dk
from ..utils.spans import DECIMATE, span, spanned
from .biquad import Biquad, BiquadCoefficients

# ATH noise-shaping N(z) coefficient sets (reference decimator.c:70-78):
# rate -> (a1..a4, b1..b4) with a0 == 1.
_ATH_CURVES = {
    32000: (-0.780459, +0.569358, -0.348221, +0.466316,
            +0.950797, +0.282052, +0.004337, +1.76209e-5),
    44100: (-1.1474, 0.5383, -0.3530, 0.3475,
            1.0587, 0.0676, -0.6054, -0.2738),
    48000: (-1.3344, 0.7455, -0.4602, 0.4363,
            0.9030, 0.0116, -0.5853, -0.2571),
    88200: (-2.150679, +2.1402057, -1.042712, +0.206838,
            +0.67433, +1.017047, +0.4028633, +0.098656),
    96000: (-2.16994, +2.01986, -0.894857, +0.1557738,
            +0.517789, +1.1062189, +0.4825786, +0.244994),
}
_FIRST_ORDER = (-1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
_SECOND_ORDER = (-2.0, +1.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
_THIRD_ORDER = (-3.0, +3.0, -1.0, 0.0, 0.0, 0.0, 0.0, 0.0)


def _shaper_coeffs(a1, a2, a3, a4, b1, b2, b3, b4) -> BiquadCoefficients:
    """N(z) -> decoupled H(z) (reference decimator.c:389-409)."""
    return BiquadCoefficients(a0=b1 - a1, a1=b2 - a2, a2=b3 - a3, a3=b4 - a4,
                              b1=b1, b2=b2, b3=b3, b4=b4)


def _track_seeds(num_channels: int, tracks) -> np.ndarray:
    """The dither LCG's initial states of ``tracks`` decimators of
    ``num_channels / tracks`` channels each, side by side."""
    tracks = int(tracks)
    if tracks < 1 or num_channels % tracks:
        raise ValueError(f"tracks={tracks} does not divide "
                         f"{num_channels} channels")
    return np.tile(dk.seed_generators(num_channels // tracks), tracks)


class Decimator:
    """Streaming quantizer; one instance per stream."""

    def __init__(self, num_channels: int, output_bits: int, output_bytes: int,
                 output_gain: float, sample_rate: int, flags: int, *,
                 dtype=np.float32, backend: str = "numpy", device=None):
        if backend == "jax":
            raise ValueError("backend='jax' is the JAX package's; the "
                             "port's accelerator backend is "
                             "backend='torch'")
        if backend == "torch":
            self.device = resolve_device("cuda" if device is None
                                         else device)
        self.num_channels = num_channels
        self.output_bits = output_bits
        self.output_bytes = output_bytes
        self.output_gain = output_gain
        self.sample_rate = sample_rate
        self.flags = flags
        self.dtype = np.dtype(dtype)
        self.backend = backend

        self.feedback = np.zeros(num_channels, dtype=self.dtype)
        self.tpdf_generators = None
        self.dither_type = 0
        if flags & DITHER_ENABLED:
            self.tpdf_generators = dk.seed_generators(num_channels)
            if flags & DITHER_HIGHPASS:
                self.dither_type = -1
            elif flags & DITHER_LOWPASS:
                self.dither_type = 1
            elif flags & DITHER_FLAT:
                self.dither_type = 0

        self.noise_shaper = None
        if flags & SHAPING_ENABLED:
            if flags & SHAPING_ATH_CURVE:
                curve = _ATH_CURVES.get(sample_rate, _FIRST_ORDER)
            elif flags & SHAPING_1ST_ORDER:
                curve = _FIRST_ORDER
            elif flags & SHAPING_2ND_ORDER:
                curve = _SECOND_ORDER
            else:
                curve = _THIRD_ORDER
            self.noise_shaper = Biquad.init(_shaper_coeffs(*curve), 1.0,
                                            channels=num_channels,
                                            dtype=self.dtype)

        # quantization constants (reference decimator.c:152-157)
        self.scaler = self.dtype.type((1 << output_bits) / 2.0 * output_gain)
        self.highclip = (1 << (output_bits - 1)) - 1
        self.lowclip = ~self.highclip

    # ----------------------------------------------------------------- state
    def state_dict(self) -> dict:
        return dict(feedback=self.feedback.copy(),
                    tpdf=None if self.tpdf_generators is None
                    else self.tpdf_generators.copy(),
                    shaper=None if self.noise_shaper is None
                    else self.noise_shaper.copy())

    def load_state(self, state: dict) -> None:
        self.feedback = state["feedback"].copy()
        if state["tpdf"] is not None:
            self.tpdf_generators = state["tpdf"].copy()
        if state["shaper"] is not None:
            self.noise_shaper = state["shaper"].copy()

    # --------------------------------------------------------------- process
    def process(self, inputs: np.ndarray) -> tuple[np.ndarray, int]:
        """Planar quantize: inputs [channels, n] -> (bytes [n, ch*bytes],
        clipped count).  Mirrors decimateProcessLE semantics."""
        return self._run(np.ascontiguousarray(np.asarray(inputs).T))

    def process_interleaved(self, inputs: np.ndarray) -> tuple[np.ndarray, int]:
        """Interleaved quantize: inputs [n, channels]
        (decimateProcessInterleavedLE)."""
        return self._run(np.asarray(inputs))

    def _run(self, frames: np.ndarray) -> tuple[np.ndarray, int]:
        with span(DECIMATE) if self.backend == "torch" else nullcontext():
            return self._quantize(frames)

    def _quantize(self, frames: np.ndarray) -> tuple[np.ndarray, int]:
        n = frames.shape[0]
        frames = frames.astype(self.dtype, copy=False)

        if self.backend == "native" and n:
            from .. import native
            if native.available():
                gens = self.tpdf_generators \
                    if self.flags & DITHER_ENABLED else None
                fused = native.quantize_pack(
                    np.ascontiguousarray(frames), self.scaler, self.feedback,
                    gens, self.dither_type, self.noise_shaper,
                    self.highclip, self.lowclip, self.output_bits,
                    self.output_bytes)
                if fused is not None:
                    return fused
                outv, clipped = native.quantize(
                    np.ascontiguousarray(frames), self.scaler, self.feedback,
                    gens, self.dither_type, self.noise_shaper,
                    self.highclip, self.lowclip)
                packed = native.pack_le(outv, self.output_bits,
                                        self.output_bytes)
                return packed.reshape(n, -1), clipped

        if self.backend == "torch" and self.noise_shaper is not None and n:
            return self._run_shaped_torch(frames)

        dither = None
        if self.flags & DITHER_ENABLED and n:
            dither, self.tpdf_generators = dk.tpdf_dither_block(
                self.tpdf_generators, self.dither_type, n)
        if self.noise_shaper is not None and n:
            outv, clipped, self.feedback = dk.quantize_shaped_numpy(
                frames, dither, self.scaler, self.feedback,
                self.noise_shaper, self.highclip, self.lowclip)
        else:
            outv, clipped, self.feedback = dk.quantize_flat(
                frames, dither, self.scaler, self.feedback,
                self.highclip, self.lowclip)
        packed = dk.pack_bytes(outv, self.output_bits, self.output_bytes)
        return packed, clipped

    def _run_shaped_torch(self, frames: np.ndarray) -> tuple[np.ndarray, int]:
        """The shaped modes on one launch of the shaped decimate kernel
        (``ops/decimate_device.decimate_shaped``): the LCG steps, the
        error-feedback loop, the clip count and the packing; the new
        generators, feedback and shaper histories come back to the host
        state."""
        dev = self.device
        sh = self.noise_shaper
        dithered = bool(self.flags & DITHER_ENABLED)
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
        packed, clips, gens, fb, xh, yh = dd.decimate_shaped(
            x, x.shape[0], scaler=self.scaler, a=sh.a, b=sh.b, xh=sh.xh,
            yh=sh.yh, feedback=self.feedback, highclip=self.highclip,
            lowclip=self.lowclip, output_bits=self.output_bits,
            output_bytes=self.output_bytes,
            gens=dd.states_tensor(self.tpdf_generators, dev)
            if dithered else None,
            dither_type=self.dither_type if dithered else None)
        if dithered:
            self.tpdf_generators = dd.states_numpy(gens)
        self.feedback = fb.cpu().numpy()
        sh.xh, sh.yh = xh.cpu().numpy(), yh.cpu().numpy()
        return packed.cpu().numpy(), int(clips)


def float_integers(data, gain: float, input_bits: int, input_bytes: int,
                   dtype=np.float32) -> np.ndarray:
    """Stateless int->float conversion (floatIntegersLE,
    reference decimator.c:416-450)."""
    return dk.unpack_bytes(np.asarray(data, dtype=np.uint8), gain,
                           input_bits, input_bytes, dtype)


class DeviceDecimator:
    """Device-resident decimator: dither + (shaped) quantization + LE byte
    pack in one kernel launch per chunk; only the packed bytes and the
    clip count cross to the host (at 16-bit half the traffic of fetching
    float32 samples).

    The port of ``art_tpu/engines/decimator.py::DeviceDecimator``, with a
    ``device=`` keyword ("cuda" raises when no card is usable; a CPU device
    runs the kernels' plain versions).  Bit-exact vs the host ``Decimator``
    for identical input samples; ragged chunks advance the LCG / shaper
    state by exactly K frames.  Mirrors decimateProcessInterleavedLE
    (reference decimator.c:205-291); per-channel state layout per reference
    decimator.h:42-60.  The flat modes launch ``decimate_flat_kernel``, the
    shaped ones ``decimate_shaped_kernel`` (``ops/decimate_device.py``),
    once per chunk.  ``tracks=F``: F files of ``num_channels / F`` channels
    each, seeded as F decimators (see the module's docstring)."""

    def __init__(self, num_channels: int, output_bits: int,
                 output_bytes: int, output_gain: float, sample_rate: int,
                 flags: int, *, dtype=np.float32, device="cuda",
                 tracks=None):
        self.device = resolve_device(device)
        host = Decimator(num_channels, output_bits, output_bytes,
                         output_gain, sample_rate, flags, dtype=dtype)
        if tracks is not None:
            seeds = _track_seeds(num_channels, tracks)
            if host.tpdf_generators is not None:
                host.tpdf_generators = seeds
        self.num_channels = num_channels
        self.output_bits = output_bits
        self.output_bytes = output_bytes
        self.dtype = np.dtype(dtype)
        self._tdtype = torch_dtype(self.dtype)
        self.scaler = host.scaler
        self.highclip, self.lowclip = host.highclip, host.lowclip
        self.dithered = bool(flags & DITHER_ENABLED)
        self.dither_type = host.dither_type
        self.shaped = host.noise_shaper is not None
        sh = host.noise_shaper
        self.load_state({
            "gens": host.tpdf_generators if self.dithered
            else np.zeros(num_channels, np.uint32),
            "feedback": host.feedback,
            "xh": sh.xh if self.shaped else np.zeros((4, num_channels)),
            "yh": sh.yh if self.shaped else np.zeros((4, num_channels))})
        coeffs = (sh.a, sh.b) if self.shaped else (np.zeros(5),) * 2
        self._a, self._b = (self._on_device(c) for c in coeffs)

    def _on_device(self, a):
        return torch.as_tensor(np.array(a, self.dtype), device=self.device)

    def state_dict(self) -> dict:
        """Streaming state (reference decimator.h:42-60 analog): LCG
        states, error feedback, shaper histories -- host arrays, so a
        checkpoint is portable across backends (JAX's DeviceDecimator's
        loads here and the reverse)."""
        return {
            "gens": dd.states_numpy(self.gens),
            "feedback": self.fb.cpu().numpy(),
            "xh": self.xh.cpu().numpy(),
            "yh": self.yh.cpu().numpy(),
        }

    def load_state(self, state: dict) -> None:
        self.gens = dd.states_tensor(state["gens"], self.device)
        self.fb = self._on_device(state["feedback"])
        self.xh = self._on_device(state["xh"])
        self.yh = self._on_device(state["yh"])

    def process_chunk(self, samples, K: int):
        """samples: [n, channels] array or tensor (host or device); the
        first K frames are quantized and the state advances by exactly K.
        Returns (packed uint8 [K, channels*output_bytes] numpy, clipped
        count)."""
        with span(DECIMATE):
            dev = self._step(samples, K)
            if dev is None:
                return np.zeros((0, self.num_channels * self.output_bytes),
                                np.uint8), 0
            packed, clipped = dev
            return packed[:K].cpu().numpy(), int(clipped)

    @spanned(DECIMATE)
    def process_chunk_async(self, samples, K: int):
        """process_chunk without the device->host fetch: returns
        (packed uint8 [n, channels*output_bytes], clipped int32 0-d) still
        on the device, rows at and past K packing 0 (None for an empty
        chunk).  The engine state has already advanced, so the caller may
        dispatch the next chunk and fetch this one's bytes concurrently.
        A tensor of the engine's dtype and device is read in place, at any
        strides."""
        return self._step(samples, K)

    def _step(self, samples, K: int):
        n = int(samples.shape[0])
        if n == 0 or K == 0:
            return None
        x = torch.as_tensor(samples, dtype=self._tdtype, device=self.device)
        packed, clipped, self.gens, self.fb, self.xh, self.yh = \
            _device_decimate_step(
                x, int(K), self.gens, self.fb, self._a, self._b, self.xh,
                self.yh, None, None, None, self.scaler, n,
                self.dither_type if self.dithered else None,
                self.output_bits, self.output_bytes, self.highclip,
                self.lowclip, self.shaped)
        return packed, clipped


def _device_decimate_step(y, K, gens, fb, a, b, xh, yh, A, V0, V1, scaler,
                          n, dither_type, bits, nbytes, highclip, lowclip,
                          shaped):
    """The fused step with JAX's arguments: dither -> flat or shaped
    quantize -> pack -> clip sum (flat clips counted for i < K only), on
    one kernel launch.  ``y`` [n, S] tensor; ``gens`` int32 state bits.
    The kernels step the LCG themselves, so the tables (A, V0, V1) are not
    read.  Returns (packed, clipped, new_gens, fb, xh, yh)."""
    del A, V0, V1
    if int(y.shape[0]) != n:
        raise ValueError(f"y has {y.shape[0]} rows, n={n}")
    kw = dict(scaler=scaler, highclip=highclip, lowclip=lowclip,
              output_bits=bits, output_bytes=nbytes, gens=gens,
              dither_type=dither_type)
    if shaped:
        return dd.decimate_shaped(y, K, a=a, b=b, xh=xh, yh=yh, feedback=fb,
                                  **kw)
    packed, clipped, new_gens = dd.decimate_flat(y, K, feedback=fb, **kw)
    return packed, clipped, new_gens, fb, xh, yh
