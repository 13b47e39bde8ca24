"""The device decimate stage: dither, quantize and pack on CUDA kernels.

The counterpart of ``art_tpu/ops/decimate_device.py``, which JAX runs as
XLA code (there is no Pallas in it).  The functions with JAX's names are
the plain PyTorch versions, on the same arguments:

- ``dither_tables`` is a verbatim numpy copy;
- ``tpdf_dither_dev``, ``advance_states``, ``_mul_for``,
  ``quantize_flat_dev``, ``quantize_shaped_dev`` and ``pack_bytes_dev``
  take tensors.  torch has no uint32 arithmetic on many builds, so LCG
  states and tables enter them as int64 tensors holding uint32 values, and
  every product is taken mod 2^32 exactly (``_mul32``).

Two entry points chain them as ``engines/decimator.py::
_device_decimate_step`` and ``parallel/pipeline.py::pipeline_chunk`` do:
``decimate_flat`` (dither, flat quantize, clip count, pack) and
``decimate_shaped`` (dither, the error-feedback scan, clip count, pack).
A CUDA tensor launches ``decimate_flat_kernel`` / ``decimate_shaped_kernel``
of ``csrc/decimate.cu`` (see its header for what they compute, what bounds
them and how they are laid out) or raises; a CPU tensor takes the plain
versions (``decimate_flat_reference``, ``decimate_shaped_reference``).
At these entry points LCG states are int32 tensors holding the uint32 bits
(``states_tensor`` / ``states_numpy`` convert).  ``launches`` counts each
kernel's launches.

``library_geometry`` and ``lcg_pair_map`` read the kernels' launch
geometry and the LCG's stride map from the host code their launches use
(``csrc/decimate_geometry.h``, built for the host); ``chain_probe``
launches ``decimate_chain_probe_kernel``, the shaped kernel's per-frame
chain alone in one thread, whose time is that kernel's latency bound, and
``chain_probe_reference`` is its plain version.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..utils.spans import LAUNCH, span
from . import _build
from .decimate_kernel import _INV15_32, _M32

launches = {"decimate_flat": 0, "decimate_shaped": 0}

_MASK = 0xFFFFFFFF
# the per-channel containers of 1, 2 and 4 packed bytes
CONTAINERS = {1: torch.uint8, 2: torch.uint16, 4: torch.uint32}
_KINDS = {torch.float32: 0, torch.float64: 1}


@functools.lru_cache(maxsize=8)
def dither_tables(n: int):
    """(A, V0, V1) uint32 [5n] with state_k = A_k*s0 + V{parity0}_k
    for k = 1..5n (see decimate_kernel.lcg32_states)."""
    nsteps = 5 * n
    j = np.arange(nsteps, dtype=np.uint32)
    with np.errstate(over="ignore"):
        B = np.cumprod(np.full(nsteps, _INV15_32, dtype=np.uint32),
                       dtype=np.uint32)
        A = np.cumprod(np.full(nsteps, 15, dtype=np.uint32), dtype=np.uint32)
        out = [A]
        for parity0 in (0, 1):
            parity = np.uint32(parity0) ^ (j & np.uint32(1))
            c = np.where(parity == 0, np.uint32(1), _M32)
            V = np.cumsum(c * B, dtype=np.uint32)
            out.append(A * V)
    return tuple(out)


# ------------------------------------------------------------ uint32 states
def states_tensor(states, device) -> torch.Tensor:
    """uint32 LCG states (numpy, or an int32 tensor of their bits) as an
    int32 tensor of their bits on ``device``."""
    if isinstance(states, torch.Tensor):
        return states.to(device=device, dtype=torch.int32)
    bits = np.ascontiguousarray(np.asarray(states, np.uint32)).view(np.int32)
    return torch.from_numpy(bits.copy()).to(device)


def states_numpy(states: torch.Tensor) -> np.ndarray:
    """The uint32 values of an int32 tensor of LCG state bits."""
    return states.cpu().numpy().view(np.uint32).copy()


def _values(bits: torch.Tensor) -> torch.Tensor:
    """int32 state bits -> int64 uint32 values."""
    return bits.to(torch.int64) & _MASK


def _bits(values: torch.Tensor) -> torch.Tensor:
    """int64 uint32 values -> int32 bits."""
    return torch.where(values >= 1 << 31, values - (1 << 32),
                       values).to(torch.int32)


def _mul32(a, b):
    """a * b mod 2^32 of int64 tensors holding uint32 values, exact (a is
    split into 16-bit halves, so no product reaches 2^63)."""
    return ((a & 0xFFFF) * b + (((a >> 16) * b & 0xFFFF) << 16)) & _MASK


def _table_tensors(n: int, device):
    return tuple(torch.from_numpy(t.astype(np.int64)).to(device)
                 for t in dither_tables(n))


# ------------------------------------------------------- the plain versions
def tpdf_dither_dev(states, A, V0, V1, dither_type: int, n: int):
    """Vectorized TPDF dither (reference decimator.c:370-382).

    states: int64 [S] of uint32 values; A/V0/V1: int64 [5n] of
    dither_tables(n).  Returns (dither f64 [S, n], seq int64 [S, 5n]), the
    states after 1..5n steps -- the caller advances its states from ``seq``
    (at 5*K-1 for a K-valid chunk)."""
    parity0 = (states & 1)[:, None]
    V = torch.where(parity0 == 0, V0[None, :], V1[None, :])
    seq = (_mul32(A[None, :], states[:, None]) + V) & _MASK     # [S, 5n]
    g0 = torch.cat([states[:, None], seq[:, 4:5 * n - 1:5]], dim=1)
    r2 = seq[:, 1::5]
    r5 = seq[:, 4::5]
    if dither_type == -1:
        first = ~g0 & _MASK
    elif dither_type == 1:
        first = g0
    else:
        first = ~r2 & _MASK
    d = (((first >> 1).to(torch.float64) + (r5 >> 1).to(torch.float64))
         / 2147483648.0) - 1.0
    return d, seq


def advance_states(states, seq, K: int):
    """LCG states after exactly K quantized samples (K may be 0)."""
    return seq[:, 5 * K - 1] if K > 0 else states


def _mul_for(dtype):
    """Product at data-path precision: for float32 operands the product
    rounded once to float32.  JAX takes it as a float64 product rounded to
    float32, its only barrier against XLA contracting it into an FMA; an
    eager PyTorch multiply is that correctly rounded product (separate ops
    are never contracted), in float32 and float64 alike."""
    del dtype
    return torch.mul


def quantize_flat_dev(samples, dither, scaler, feedback, highclip: int,
                      lowclip: int):
    """Shaping-free quantization, elementwise (reference
    decimator.c:152-194 with no shaper).

    samples [n, S] data dtype; dither [n, S] f64 or None; feedback [S].
    Returns (outv i32 [n, S], clip flags bool [n, S])."""
    dt = samples.dtype
    mul = _mul_for(dt)
    code = mul(samples, torch.tensor(scaler, dtype=dt)) - feedback[None, :]
    d = dither.to(dt) if dither is not None else torch.zeros((), dtype=dt)
    f = torch.floor((code + d).to(torch.float64) + 0.5)
    clipf = (f > highclip) | (f < lowclip)
    return f.clamp(lowclip, highclip).to(torch.int32), clipf


def quantize_shaped_dev(samples, dither, scaler, feedback, a, b, xh, yh,
                        K: int, highclip: int, lowclip: int):
    """Shaped quantization scan over the first K frames (reference
    decimator.c:152-194 + the biquad's apply_sample op order); frames at
    and past K give 0 and leave the state as it was.

    samples [n, S]; dither [n, S] f64 or None; feedback [S]; a/b [5] shaper
    coefficients; xh/yh [4, S] (row 0 the newest).
    Returns (outv i32 [n, S], clip flags [n, S], feedback', xh', yh')."""
    n, S = samples.shape
    dt = samples.dtype
    mul = _mul_for(dt)
    a = [torch.tensor(float(v), dtype=dt) for v in a]
    b = [torch.tensor(float(v), dtype=dt) for v in b]
    scaled = mul(samples[:K], torch.tensor(scaler, dtype=dt))
    d = (dither[:K].to(dt) if dither is not None
         else torch.zeros((K, S), dtype=dt, device=samples.device))
    fb = feedback.clone()
    xs, ys = list(xh.clone()), list(yh.clone())
    floors = []
    for i in range(K):
        code = scaled[i] - fb
        f = torch.floor((code + d[i]).to(torch.float64) + 0.5)
        floors.append(f)
        err = f.to(dt) - code
        s = mul(err, a[0])
        s = s + (mul(xs[3], a[4]) - mul(b[4], ys[3]))
        s = s + (mul(xs[2], a[3]) - mul(b[3], ys[2]))
        s = s + (mul(xs[1], a[2]) - mul(b[2], ys[1]))
        s = s + (mul(xs[0], a[1]) - mul(b[1], ys[0]))
        xs = [err, *xs[:3]]
        ys = [s, *ys[:3]]
        fb = s
    f = torch.zeros((n, S), dtype=torch.float64, device=samples.device)
    if K:
        f[:K] = torch.stack(floors)
    clipf = (f > highclip) | (f < lowclip)
    return (f.clamp(lowclip, highclip).to(torch.int32), clipf, fb,
            torch.stack(xs), torch.stack(ys))


def pack_bytes_dev(outv, output_bits: int, output_bytes: int):
    """Vectorized LE byte packing (reference decimator.c:152-191).

    outv i32 [n, S] -> uint8 [n, S * output_bytes]."""
    n, S = outv.shape
    pre_zeros = output_bytes - ((output_bits + 7) // 8)
    offset = 128 if output_bits <= 8 else 0
    leftshift = (24 - output_bits) % 8
    v = (outv.to(torch.int64) * (1 << leftshift) + offset) & _MASK
    zero = torch.zeros((n, S), dtype=torch.int64, device=outv.device)
    planes = [zero] * pre_zeros
    planes.append(v & 0xFF)
    if output_bits > 8:
        planes.append((v >> 8) & 0xFF)
        if output_bits > 16:
            planes.append((v >> 16) & 0xFF)
    planes += [zero] * (output_bytes - len(planes))
    return torch.stack(planes, dim=2).to(torch.uint8) \
        .reshape(n, S * output_bytes)


def _planar(packed, n: int, S: int, output_bytes: int):
    """Interleaved bytes [n, S*nbytes] -> the per-channel container [S, n]
    of uint8/16/32 whose little-endian bytes they are."""
    return packed.reshape(n, S, output_bytes).transpose(0, 1).contiguous() \
        .reshape(S, n * output_bytes).view(CONTAINERS[output_bytes])


def _dither_plain(gens, dither_type, n: int, K: int):
    """(dither [n, S] f64 or None, the new state bits) on the plain
    versions."""
    if dither_type is None:
        return None, gens
    states = _values(gens)
    d, seq = tpdf_dither_dev(states, *_table_tensors(n, gens.device),
                             dither_type, n)
    return d.T, _bits(advance_states(states, seq, K))


def decimate_flat_reference(samples, K: int, *, scaler: float,
                            highclip: int, lowclip: int, output_bits: int,
                            output_bytes: int, gens=None, dither_type=None,
                            feedback=None, planar: bool = False):
    """The plain version of ``decimate_flat`` on any device: JAX's chain
    (tpdf_dither_dev, advance_states, quantize_flat_dev, codes and clips
    masked at K, pack_bytes_dev)."""
    n, S = _layout(samples, K, output_bits, output_bytes)
    dither, new_gens = _dither_plain(gens, dither_type, n, K)
    fb = feedback if feedback is not None else torch.zeros(
        S, dtype=samples.dtype, device=samples.device)
    outv, clipf = quantize_flat_dev(samples, dither, scaler, fb, highclip,
                                    lowclip)
    kmask = (torch.arange(n, device=samples.device) < K)[:, None]
    outv = torch.where(kmask, outv, 0)
    clips = (clipf & kmask).sum(dtype=torch.int32)
    packed = pack_bytes_dev(outv, output_bits, output_bytes)
    if planar:
        packed = _planar(packed, n, S, output_bytes)
    return packed, clips, new_gens


def decimate_shaped_reference(samples, K: int, *, scaler: float, a, b, xh,
                              yh, feedback, highclip: int, lowclip: int,
                              output_bits: int, output_bytes: int,
                              gens=None, dither_type=None):
    """The plain version of ``decimate_shaped`` on any device: JAX's chain
    (tpdf_dither_dev, advance_states, quantize_shaped_dev,
    pack_bytes_dev); one torch step per frame, so slow."""
    _layout(samples, K, output_bits, output_bytes)
    dt, dev = samples.dtype, samples.device
    a, b, xh, yh, feedback = (torch.as_tensor(t, dtype=dt, device=dev)
                              for t in (a, b, xh, yh, feedback))
    dither, new_gens = _dither_plain(gens, dither_type, samples.shape[0], K)
    outv, clipf, fb, xh, yh = quantize_shaped_dev(
        samples, dither, scaler, feedback, a, b, xh, yh, K, highclip,
        lowclip)
    return (pack_bytes_dev(outv, output_bits, output_bytes),
            clipf.sum(dtype=torch.int32), new_gens, fb, xh, yh)


# ------------------------------------------------------------ entry points
def _layout(samples, K: int, output_bits: int, output_bytes: int):
    n, S = samples.shape
    if samples.dtype not in _KINDS:
        raise ValueError(f"the decimator takes float32 or float64 samples, "
                         f"got {samples.dtype}")
    if not 0 <= K <= n:
        raise ValueError(f"K={K} outside [0, {n}]")
    if not (4 <= output_bits <= 24
            and (output_bits + 7) // 8 <= output_bytes):
        raise ValueError(f"{output_bits} bits in {output_bytes} bytes")
    return n, S


def _check_on(dev, **tensors):
    for name, t in tensors.items():
        if t is not None and t.device != dev:
            raise ValueError(f"{name} is on {t.device}, the samples on "
                             f"{dev}")


def _out(dev, n: int, S: int, output_bytes: int, planar: bool):
    """The packed output and its (frame, channel) byte strides."""
    if planar:
        if output_bytes not in CONTAINERS:
            raise ValueError("the per-channel container takes 1, 2 or 4 "
                             f"bytes, not {output_bytes}")
        out = torch.empty((S, n), dtype=CONTAINERS[output_bytes],
                          device=dev)
        return out, output_bytes, n * output_bytes
    out = torch.empty((n, S * output_bytes), dtype=torch.uint8, device=dev)
    return out, S * output_bytes, output_bytes


def _raise_on(rc: int, name: str, n: int, S: int, dtype):
    if rc != 0:
        raise RuntimeError(f"art_{name} launch failed: cudaError {rc} "
                           f"(n={n}, S={S}, {dtype})")


def decimate_flat(samples, K: int, *, scaler: float, highclip: int,
                  lowclip: int, output_bits: int, output_bytes: int,
                  gens=None, dither_type=None, feedback=None,
                  planar: bool = False):
    """Dither (when ``dither_type`` is not None), flat quantization, clip
    count and packing of ``samples`` [n, S] (float32 or float64, any
    strides: K1's output [S, capacity] is passed as its transpose).  Frames
    at and past K pack 0 and are not counted.  ``gens``: int32 state bits
    [S] (read only when dithered); ``feedback`` [S] of the samples' type or
    None (zero); ``scaler`` is rounded to the samples' type.

    Returns (packed, clips int32 0-d, new gens): packed is uint8 [n,
    S*output_bytes] interleaved, or with ``planar`` the [S, n] uint8/16/32
    container whose little-endian bytes are each channel's stream; new gens
    are the states after 5K steps (``gens`` itself when not dithered)."""
    n, S = _layout(samples, K, output_bits, output_bytes)
    dev = samples.device
    _check_on(dev, gens=gens, feedback=feedback)
    dt = samples.dtype
    if dev.type == "cpu":
        return decimate_flat_reference(
            samples, K, scaler=scaler, highclip=highclip, lowclip=lowclip,
            output_bits=output_bits, output_bytes=output_bytes, gens=gens,
            dither_type=dither_type, feedback=feedback, planar=planar)
    with span(LAUNCH + "decimate_flat"):
        if dev.type != "cuda":
            raise ValueError(f"decimate_flat runs on CPU or CUDA tensors, "
                             f"got {dev}")
        dithered = dither_type is not None
        if dithered and (gens is None or gens.dtype != torch.int32
                         or tuple(gens.shape) != (S,)):
            raise ValueError("gens: needs int32 state bits [S]")
        if feedback is not None:
            feedback = feedback.to(dt).contiguous()
        out, osi, osc = _out(dev, n, S, output_bytes, planar)
        clips = torch.zeros((), dtype=torch.int32, device=dev)
        new_gens = torch.empty_like(gens) if dithered else gens
        if n:
            gens = gens.contiguous() if dithered else None
            lib = _build.library()
            with torch.cuda.device(dev):
                stream = torch.cuda.current_stream(dev).cuda_stream
                rc = lib.art_decimate_flat(
                    samples.data_ptr(), n, S, samples.stride(0),
                    samples.stride(1), _KINDS[dt], int(K),
                    float(torch.tensor(scaler, dtype=dt)),
                    None if feedback is None else feedback.data_ptr(),
                    None if gens is None else gens.data_ptr(), int(dithered),
                    int(dither_type or 0),
                    new_gens.data_ptr() if dithered else None, highclip,
                    lowclip, output_bits, output_bytes, out.data_ptr(), osi,
                    osc, clips.data_ptr(), stream)
            _raise_on(rc, "decimate_flat", n, S, dt)
            launches["decimate_flat"] += 1
        return out, clips, new_gens


def decimate_shaped(samples, K: int, *, scaler: float, a, b, xh, yh,
                    feedback, highclip: int, lowclip: int, output_bits: int,
                    output_bytes: int, gens=None, dither_type=None):
    """Dither (when ``dither_type`` is not None), the noise-shaped
    quantization scan over the first K frames, clip count and interleaved
    packing of ``samples`` [n, S] (any strides); frames at and past K pack
    0 and leave the state as it was.  ``a``/``b`` [5] shaper coefficients,
    ``xh``/``yh`` [4, S] and ``feedback`` [S], all of the samples' type.

    Returns (packed uint8 [n, S*output_bytes], clips int32 0-d, new gens,
    feedback', xh', yh')."""
    n, S = _layout(samples, K, output_bits, output_bytes)
    dev = samples.device
    _check_on(dev, gens=gens)
    if dev.type == "cpu":
        return decimate_shaped_reference(
            samples, K, scaler=scaler, a=a, b=b, xh=xh, yh=yh,
            feedback=feedback, highclip=highclip, lowclip=lowclip,
            output_bits=output_bits, output_bytes=output_bytes, gens=gens,
            dither_type=dither_type)
    with span(LAUNCH + "decimate_shaped"):
        if dev.type != "cuda":
            raise ValueError(f"decimate_shaped runs on CPU or CUDA tensors, "
                             f"got {dev}")
        dithered = dither_type is not None
        if dithered and (gens is None or gens.dtype != torch.int32
                         or tuple(gens.shape) != (S,)):
            raise ValueError("gens: needs int32 state bits [S]")
        dt = samples.dtype
        a, b, xh, yh, feedback = (torch.as_tensor(t, dtype=dt, device=dev)
                                  for t in (a, b, xh, yh, feedback))
        if tuple(a.shape) != (5,) or tuple(b.shape) != (5,) or \
                tuple(xh.shape) != (4, S) or tuple(yh.shape) != (4, S) or \
                tuple(feedback.shape) != (S,):
            raise ValueError("shaper: a, b [5], xh, yh [4, S], feedback [S]")
        ab = torch.cat([a, b])
        xh, yh = xh.contiguous(), yh.contiguous()
        feedback = feedback.contiguous()
        out, osi, osc = _out(dev, n, S, output_bytes, False)
        clips = torch.zeros((), dtype=torch.int32, device=dev)
        new_fb, new_xh, new_yh = (torch.empty_like(t)
                                  for t in (feedback, xh, yh))
        new_gens = torch.empty_like(gens) if dithered else gens
        if not n:
            return out, clips, gens, feedback, xh, yh
        gens = gens.contiguous() if dithered else None
        lib = _build.library()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.art_decimate_shaped(
                samples.data_ptr(), n, S, samples.stride(0),
                samples.stride(1), _KINDS[dt], int(K),
                float(torch.tensor(scaler, dtype=dt)), feedback.data_ptr(),
                ab.data_ptr(), xh.data_ptr(), yh.data_ptr(),
                None if gens is None else gens.data_ptr(), int(dithered),
                int(dither_type or 0),
                new_gens.data_ptr() if dithered else None,
                new_fb.data_ptr(), new_xh.data_ptr(), new_yh.data_ptr(),
                highclip, lowclip, output_bits, output_bytes, out.data_ptr(),
                osi, osc, clips.data_ptr(), stream)
        _raise_on(rc, "decimate_shaped", n, S, dt)
        launches["decimate_shaped"] += 1
        return out, clips, new_gens, new_fb, new_xh, new_yh


# ------------------------------------------------- the kernels' geometry
def lcg_pair_map(pairs: int) -> tuple[int, int]:
    """(a, b): 2*pairs steps of the dither LCG take an even state g to a*g
    + b and an odd one to a*g - b (mod 2^32), the powers of the two-step
    maps 225 g + 14 and 225 g - 14: csrc/decimate_geometry.h's pair_power,
    which the kernels' lanes and producers jump with (built for the host,
    no card needed)."""
    out = (ctypes.c_uint * 2)()
    _build.geometry_library().art_decimate_pair_power(0, pairs, out)
    return out[0], out[1]


def library_geometry(n: int, S: int, K: int, dtype, sms: int) -> dict:
    """The decimate kernels' launches for n frames of S channels of
    ``dtype``, K of them quantized, on ``sms`` SMs, from
    csrc/decimate_geometry.h (the code the launches run, built for the
    host, no card needed): {"flat": {ctas, threads, run (elements a lane
    takes at once), frames (the lanes' stride, 0 for one run a lane or a
    jump a run), a, b (the LCG map of 5 * frames steps, as
    lcg_pair_map)}, "shaped": {groups (CTAs of 32 channels), zero (CTAs
    packing the zero tail), tile (frames), stages, threads, smem (dynamic
    shared memory bytes)}}."""
    lib = _build.geometry_library()
    fo = (ctypes.c_longlong * 6)()
    so = (ctypes.c_longlong * 6)()
    rc = lib.art_decimate_flat_geometry(n, S, _KINDS[dtype], sms, fo) or \
        lib.art_decimate_shaped_geometry(n, S, K, _KINDS[dtype], so)
    if rc:
        raise ValueError(f"the decimate kernels take no n={n}, S={S}, "
                         f"K={K}, sms={sms}")
    return dict(flat=dict(zip(("ctas", "threads", "run", "frames", "a", "b"),
                              fo)),
                shaped=dict(zip(("groups", "zero", "tile", "stages",
                                 "threads", "smem"), so)))


# ------------------------------------------------ the shaped chain's probe
def _probe_values(values, dtype) -> np.ndarray:
    """The probe's inputs [21]: a0..a4, b0..b4, xs, d, f, xh0..3, yh0..3."""
    v = np.asarray(values, dtype=np.float64).astype(
        np.float32 if dtype == torch.float32 else np.float64)
    if v.shape != (21,):
        raise ValueError(f"the chain probe takes 21 values, got {v.shape}")
    return v


def chain_probe(values, K: int, dtype, device):
    """One launch of decimate_chain_probe_kernel on ``device`` (a card):
    the shaped kernel's dithered per-frame chain K times on the constant
    xs and d of ``values`` (see _probe_values; a tensor of them on the
    device is used as it is); returns its final state [f, xh0..3, yh0..3]
    as a tensor.  Not on any path, so not counted in ``launches``."""
    v = values if isinstance(values, torch.Tensor) else \
        torch.from_numpy(_probe_values(values, dtype)).to(device)
    if v.dtype != dtype or v.device.type != "cuda" or \
            tuple(v.shape) != (21,):
        raise ValueError(f"the chain probe takes [21] {dtype} on a card")
    state = torch.empty(9, dtype=dtype, device=device)
    lib = _build.library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.art_decimate_chain_probe(v.data_ptr(), int(K), _KINDS[dtype],
                                          state.data_ptr(), stream)
    _raise_on(rc, "decimate_chain_probe", K, 1, dtype)
    return state


def chain_probe_reference(values, K: int, dtype) -> np.ndarray:
    """The plain version of ``chain_probe``: quantize_shaped_dev's
    per-frame arithmetic on numpy scalars of the data type."""
    v = _probe_values(values, dtype)
    t = v.dtype.type
    a, b, xs, d = v[0:5], v[5:10], v[10], v[11]
    f, xh, yh = v[12], list(v[13:17]), list(v[17:21])
    for _ in range(K):
        code = t(xs - f)
        fl = np.floor(np.float64(t(code + d)) + 0.5)
        err = t(t(fl) - code)
        s = t(err * a[0])
        for k in (3, 2, 1, 0):
            s = t(s + t(t(xh[k] * a[k + 1]) - t(b[k + 1] * yh[k])))
        xh = [err, *xh[:3]]
        yh = [s, *yh[:3]]
        f = s
    return np.array([f, *xh, *yh], dtype=v.dtype)
