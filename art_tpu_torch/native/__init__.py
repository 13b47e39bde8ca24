"""ctypes bindings for the artnative host runtime.

Builds the shared library on first use (gcc with strict IEEE flags) into the
package directory; every entry point has a pure-Python fallback, so the
package works without a compiler — just slower on the host file path.

A copy of ``art_tpu/native/__init__.py``, unchanged, so that the port
imports nothing of the JAX package; it builds the port's copy of
``artnative.cpp`` into this directory (tests/test_torch_host.py holds its
entry points against the original's).
"""

from __future__ import annotations

import ctypes
import hashlib
import subprocess
from pathlib import Path

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "artnative.cpp"
_LIB = _HERE / "libartnative.so"
# -O3 is IEEE-safe here (no -ffast-math/-fassociative-math; contraction off):
# it buys loop unswitching of the dither/shaper branches without changing
# any rounding, so bit-parity with the reference data paths is preserved.
_CXXFLAGS = ["-O3", "-ffp-contract=off", "-fPIC", "-shared", "-std=c++17"]


def _isa_flags() -> list[str]:
    """-mavx2 matches the reference build's ISA (reference Makefile:10);
    VEX 3-operand encoding shaves register moves without touching FP
    semantics (-ffp-contract=off still forbids FMA contraction).  The lib
    builds itself on whatever host imports it, so only emit AVX2 when the
    CPU actually has it — an unconditional flag would SIGILL elsewhere."""
    try:
        with open("/proc/cpuinfo") as f:
            if " avx2" in f.read():
                return ["-mavx2"]
    except OSError:
        pass
    return []

_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    # rebuild keyed on a source digest, not mtimes: a cached/copied .so with
    # a newer mtime than an updated artnative.cpp would otherwise be loaded
    # stale and raise AttributeError on newly added symbols
    stamp = _HERE / ".libartnative.hash"
    try:
        # the ISA flags are part of the digest: a .so built with -mavx2 on
        # one host must not be loaded on a host without AVX2 (SIGILL is not
        # catchable below), and vice versa a non-AVX2 build should upgrade
        isa = _isa_flags()
        digest = hashlib.sha256(
            _SRC.read_bytes()
            + " ".join(_CXXFLAGS + isa).encode()).hexdigest()
        if (not _LIB.exists() or not stamp.exists()
                or stamp.read_text().strip() != digest):
            subprocess.run(["g++", *_CXXFLAGS, *isa, str(_SRC),
                            "-o", str(_LIB)],
                           check=True, capture_output=True)
            stamp.write_text(digest)
        lib = ctypes.CDLL(str(_LIB))
        _bind(lib)
    except (OSError, subprocess.CalledProcessError, AttributeError):
        # AttributeError: a stale library missing a symbol — fall back to
        # the pure-Python paths rather than crash consumers
        return None
    _lib = lib
    return _lib


def _bind(lib):
    i8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    ll = ctypes.c_longlong

    lib.art_quantize_f32.restype = ll
    lib.art_quantize_f32.argtypes = [
        f32p, ll, ctypes.c_int, ctypes.c_float, f32p, u32p, ctypes.c_int,
        f32p, f32p, f32p, f32p, ctypes.c_int32, ctypes.c_int32, i32p]
    lib.art_quantize_f64.restype = ll
    lib.art_quantize_f64.argtypes = [
        f64p, ll, ctypes.c_int, ctypes.c_double, f64p, u32p, ctypes.c_int,
        f64p, f64p, f64p, f64p, ctypes.c_int32, ctypes.c_int32, i32p]
    lib.art_quantize_pack_f32.restype = ll
    lib.art_quantize_pack_f32.argtypes = [
        f32p, ll, ctypes.c_int, ctypes.c_float, f32p, u32p, ctypes.c_int,
        f32p, f32p, f32p, f32p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int, ctypes.c_int, i8p]
    lib.art_quantize_pack_f64.restype = ll
    lib.art_quantize_pack_f64.argtypes = [
        f64p, ll, ctypes.c_int, ctypes.c_double, f64p, u32p, ctypes.c_int,
        f64p, f64p, f64p, f64p, ctypes.c_int32, ctypes.c_int32,
        ctypes.c_int, ctypes.c_int, i8p]
    lib.art_biquad_buffer_f32.restype = None
    lib.art_biquad_buffer_f32.argtypes = [f32p, ll, ctypes.c_int, f32p, f32p,
                                          f32p, f32p]
    lib.art_biquad_buffer_f64.restype = None
    lib.art_biquad_buffer_f64.argtypes = [f64p, ll, ctypes.c_int, f64p, f64p,
                                          f64p, f64p]
    lib.art_biquad_cascade_f32.restype = None
    lib.art_biquad_cascade_f32.argtypes = [f32p, ll, ctypes.c_int,
                                           ctypes.c_int, f32p, f32p, f32p,
                                           f32p]
    lib.art_biquad_cascade_f64.restype = None
    lib.art_biquad_cascade_f64.argtypes = [f64p, ll, ctypes.c_int,
                                           ctypes.c_int, f64p, f64p, f64p,
                                           f64p]
    lib.art_stretch_search_f32.restype = ctypes.c_int
    lib.art_stretch_search_f32.argtypes = [f32p, ctypes.c_int, ctypes.c_int,
                                           f32p, f32p]
    lib.art_stretch_search_f64.restype = ctypes.c_int
    lib.art_stretch_search_f64.argtypes = [f64p, ctypes.c_int, ctypes.c_int,
                                           f64p, f64p]
    llp = ctypes.POINTER(ll)
    lib.art_stretch_run_f32.restype = ll
    lib.art_stretch_run_f32.argtypes = [
        f32p, ll, llp, ll, ll, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        f64p, f32p, f32p, f32p]
    lib.art_stretch_run_f64.restype = ll
    lib.art_stretch_run_f64.argtypes = [
        f64p, ll, llp, ll, ll, ctypes.c_int, ctypes.c_int, ctypes.c_double,
        f64p, f64p, f64p, f64p]
    lib.art_pack_le.restype = None
    lib.art_pack_le.argtypes = [i32p, ll, ctypes.c_int, ctypes.c_int, i8p]
    lib.art_unpack_le_f32.restype = None
    lib.art_unpack_le_f32.argtypes = [i8p, ctypes.c_double, ctypes.c_int,
                                      ctypes.c_int, f32p, ll]
    lib.art_unpack_le_f64.restype = None
    lib.art_unpack_le_f64.argtypes = [i8p, ctypes.c_double, ctypes.c_int,
                                      ctypes.c_int, f64p, ll]
    lib.art_extrapolate_f32.restype = ctypes.c_double
    lib.art_extrapolate_f32.argtypes = [f32p, ll, ll, ll, f32p]
    lib.art_extrapolate_f64.restype = ctypes.c_double
    lib.art_extrapolate_f64.argtypes = [f64p, ll, ll, ll, f64p]
    lib.art_extrap_fit_f32.restype = ctypes.c_double
    lib.art_extrap_fit_f32.argtypes = [f32p, ll, ll, f32p]
    lib.art_extrap_fit_f64.restype = ctypes.c_double
    lib.art_extrap_fit_f64.argtypes = [f64p, ll, ll, f32p]


def available() -> bool:
    return _load() is not None


def _ptr(arr, ct):
    return arr.ctypes.data_as(ctypes.POINTER(ct))


def quantize(frames: np.ndarray, scaler, feedback: np.ndarray,
             gens: np.ndarray | None, dither_type: int, shaper,
             highclip: int, lowclip: int):
    """Native shaped/dithered quantization.  Mutates feedback/gens/shaper
    state in place.  Returns (outvalues int32 [n, ch], clipped count)."""
    lib = _load()
    n, ch = frames.shape
    dt = frames.dtype
    outv = np.empty((n, ch), dtype=np.int32)
    frames = np.ascontiguousarray(frames)
    if shaper is not None:
        a = np.ascontiguousarray(shaper.a, dtype=dt)
        b = np.ascontiguousarray(shaper.b, dtype=dt)
        xh = np.ascontiguousarray(shaper.xh, dtype=dt)
        yh = np.ascontiguousarray(shaper.yh, dtype=dt)
    fb = np.ascontiguousarray(feedback, dtype=dt)

    if dt == np.float32:
        fn, ct = lib.art_quantize_f32, ctypes.c_float
    else:
        fn, ct = lib.art_quantize_f64, ctypes.c_double
    null = ctypes.POINTER(ct)()
    clipped = fn(
        _ptr(frames, ct), n, ch, dt.type(scaler), _ptr(fb, ct),
        _ptr(gens, ctypes.c_uint32) if gens is not None
        else ctypes.POINTER(ctypes.c_uint32)(),
        dither_type,
        _ptr(a, ct) if shaper is not None else null,
        _ptr(b, ct) if shaper is not None else null,
        _ptr(xh, ct) if shaper is not None else null,
        _ptr(yh, ct) if shaper is not None else null,
        highclip, lowclip, _ptr(outv, ctypes.c_int32))
    feedback[:] = fb
    if shaper is not None:
        shaper.xh, shaper.yh = xh, yh
    return outv, int(clipped)


def quantize_pack(frames: np.ndarray, scaler, feedback: np.ndarray,
                  gens: np.ndarray | None, dither_type: int, shaper,
                  highclip: int, lowclip: int, output_bits: int,
                  output_bytes: int):
    """Fused shaped/dithered quantization + LE byte pack (single pass).
    Mutates feedback/gens/shaper state in place.  Returns (packed uint8
    [n, ch*output_bytes], clipped count), or None for unspecialized channel
    counts (caller should use quantize + pack_le)."""
    lib = _load()
    n, ch = frames.shape
    if ch not in (1, 2, 6):
        return None
    dt = frames.dtype
    out = np.empty(n * ch * output_bytes, dtype=np.uint8)
    frames = np.ascontiguousarray(frames)
    if shaper is not None:
        a = np.ascontiguousarray(shaper.a, dtype=dt)
        b = np.ascontiguousarray(shaper.b, dtype=dt)
        xh = np.ascontiguousarray(shaper.xh, dtype=dt)
        yh = np.ascontiguousarray(shaper.yh, dtype=dt)
    fb = np.ascontiguousarray(feedback, dtype=dt)

    if dt == np.float32:
        fn, ct = lib.art_quantize_pack_f32, ctypes.c_float
    else:
        fn, ct = lib.art_quantize_pack_f64, ctypes.c_double
    null = ctypes.POINTER(ct)()
    clipped = fn(
        _ptr(frames, ct), n, ch, dt.type(scaler), _ptr(fb, ct),
        _ptr(gens, ctypes.c_uint32) if gens is not None
        else ctypes.POINTER(ctypes.c_uint32)(),
        dither_type,
        _ptr(a, ct) if shaper is not None else null,
        _ptr(b, ct) if shaper is not None else null,
        _ptr(xh, ct) if shaper is not None else null,
        _ptr(yh, ct) if shaper is not None else null,
        highclip, lowclip, output_bits, output_bytes,
        _ptr(out, ctypes.c_uint8))
    if clipped < 0:
        return None
    feedback[:] = fb
    if shaper is not None:
        shaper.xh, shaper.yh = xh, yh
    return out.reshape(n, ch * output_bytes), int(clipped)


def biquad_buffer(biquad, buffer: np.ndarray) -> np.ndarray:
    """Native buffer-order biquad; mutates biquad state, returns filtered."""
    lib = _load()
    buf = np.array(buffer, copy=True, order="C")  # non-mutating API
    squeeze = buf.ndim == 1
    if squeeze:
        buf = buf[:, None]
    n, ch = buf.shape
    dt = buf.dtype
    a = np.ascontiguousarray(biquad.a, dtype=dt)
    b = np.ascontiguousarray(biquad.b, dtype=dt)
    xh = np.ascontiguousarray(biquad.xh, dtype=dt)
    yh = np.ascontiguousarray(biquad.yh, dtype=dt)
    if dt == np.float32:
        fn, ct = lib.art_biquad_buffer_f32, ctypes.c_float
    else:
        fn, ct = lib.art_biquad_buffer_f64, ctypes.c_double
    fn(_ptr(buf, ct), n, ch, _ptr(a, ct), _ptr(b, ct), _ptr(xh, ct),
       _ptr(yh, ct))
    biquad.xh, biquad.yh = xh, yh
    return buf[:, 0] if squeeze else buf


def biquad_cascade(biquads, buffer: np.ndarray) -> np.ndarray:
    """Fused native biquad cascade: one buffer pass for all stages.

    Bit-identical to chaining ``biquad_buffer`` per stage (the reference
    applies its -p lowpass pair as two whole-buffer passes, art.c:1011-1017;
    stage s+1 of a sample only reads finalized stage-s output, so fusing the
    passes reorders no arithmetic).  Mutates every biquad's state.
    """
    lib = _load()
    buf = np.array(buffer, copy=True, order="C")  # non-mutating API
    squeeze = buf.ndim == 1
    if squeeze:
        buf = buf[:, None]
    n, ch = buf.shape
    dt = buf.dtype
    a = np.ascontiguousarray(np.stack([q.a for q in biquads]), dtype=dt)
    b = np.ascontiguousarray(np.stack([q.b for q in biquads]), dtype=dt)
    xh = np.ascontiguousarray(np.stack([q.xh for q in biquads]), dtype=dt)
    yh = np.ascontiguousarray(np.stack([q.yh for q in biquads]), dtype=dt)
    if dt == np.float32:
        fn, ct = lib.art_biquad_cascade_f32, ctypes.c_float
    else:
        fn, ct = lib.art_biquad_cascade_f64, ctypes.c_double
    fn(_ptr(buf, ct), n, ch, len(biquads), _ptr(a, ct), _ptr(b, ct),
       _ptr(xh, ct), _ptr(yh, ct))
    for s, q in enumerate(biquads):
        q.xh, q.yh = xh[s].copy(), yh[s].copy()
    return buf[:, 0] if squeeze else buf


def pack_le(vals: np.ndarray, bits: int, nbytes: int) -> np.ndarray:
    lib = _load()
    vals = np.ascontiguousarray(vals, dtype=np.int32)
    out = np.empty(vals.size * nbytes, dtype=np.uint8)
    lib.art_pack_le(_ptr(vals, ctypes.c_int32), vals.size, bits, nbytes,
                    _ptr(out, ctypes.c_uint8))
    return out


def unpack_le(raw: np.ndarray, gain: float, bits: int, nbytes: int,
              dtype=np.float32) -> np.ndarray:
    lib = _load()
    raw = np.ascontiguousarray(raw, dtype=np.uint8)
    count = raw.size // nbytes
    dt = np.dtype(dtype)
    out = np.empty(count, dtype=dt)
    if dt == np.float32:
        lib.art_unpack_le_f32(_ptr(raw, ctypes.c_uint8), gain, bits, nbytes,
                              _ptr(out, ctypes.c_float), count)
    else:
        lib.art_unpack_le_f64(_ptr(raw, ctypes.c_uint8), gain, bits, nbytes,
                              _ptr(out, ctypes.c_double), count)
    return out


class StretchRunner:
    """Cached-pointer driver for the native TDHS block loop: the engine
    calls run() once per buffered region (thousands of times per file), so
    argument marshalling and scratch allocation happen once here.  run()
    returns a VIEW into the shared out scratch — consume or copy before
    the next call."""

    def __init__(self, inbuff: np.ndarray, longest: int, shortest: int,
                 num_chans: int, fast_mode: bool):
        lib = _load()
        dt = inbuff.dtype
        self.out = np.empty(int(2 * inbuff.size + 8 * longest + 64),
                            dtype=dt)
        self._calc = np.empty(2 * longest, dtype=dt)
        self._results = np.empty(longest + 2, dtype=dt)
        ct = ctypes.c_float if dt == np.float32 else ctypes.c_double
        self._fn = lib.art_stretch_run_f32 if dt == np.float32 \
            else lib.art_stretch_run_f64
        self._p_in = _ptr(inbuff, ct)
        self._p_out = _ptr(self.out, ct)
        self._p_calc = _ptr(self._calc, ct)
        self._p_res = _ptr(self._results, ct)
        self._longest, self._shortest = longest, shortest
        self._nc, self._fast = num_chans, int(fast_mode)
        self._tail_c = ctypes.c_longlong(0)
        self._err_c = ctypes.c_double(0.0)

    def run(self, head: int, tail: int, ratio: float, error: float):
        self._tail_c.value = tail
        self._err_c.value = error
        outn = self._fn(self._p_in, head, ctypes.byref(self._tail_c),
                        self._longest, self._shortest, self._nc, self._fast,
                        ratio, ctypes.byref(self._err_c), self._p_out,
                        self._p_calc, self._p_res)
        return (self.out[:outn], int(self._tail_c.value),
                float(self._err_c.value))


def stretch_run(inbuff: np.ndarray, head: int, tail: int, longest: int,
                shortest: int, num_chans: int, fast_mode: bool,
                ratio: float, error: float):
    """One-shot wrapper around StretchRunner (tests/ad-hoc use)."""
    r = StretchRunner(inbuff, longest, shortest, num_chans, fast_mode)
    out, new_tail, new_err = r.run(head, tail, ratio, error)
    return out.copy(), new_tail, new_err


def stretch_search(calc: np.ndarray, shortest: int, longest: int,
                   record: np.ndarray | None = None) -> tuple[int, float]:
    """TDHS period search (reference stretch.c:391-460 orders); returns
    (best_period, best_factor)."""
    lib = _load()
    dt = calc.dtype
    calc = np.ascontiguousarray(calc)
    best = np.zeros(1, dtype=dt)
    if dt == np.float32:
        rec = _ptr(record, ctypes.c_float) if record is not None else None
        p = lib.art_stretch_search_f32(_ptr(calc, ctypes.c_float), shortest,
                                       longest, rec,
                                       _ptr(best, ctypes.c_float))
    else:
        rec = _ptr(record, ctypes.c_double) if record is not None else None
        p = lib.art_stretch_search_f64(_ptr(calc, ctypes.c_double), shortest,
                                       longest, rec,
                                       _ptr(best, ctypes.c_double))
    return int(p), float(best[0])


def extrapolate(values: np.ndarray, num_to_extrapolate: int,
                maxloops: int) -> np.ndarray:
    """Native LPC endpoint extrapolation (forward); bit-exact vs the
    numpy path in engines.extrapolator (reference extrapolator.c:22-43).
    Raises FloatingPointError on a degenerate fit like the reference's
    hard exit (extrapolator.c:224-227)."""
    lib = _load()
    dt = values.dtype
    values = np.ascontiguousarray(values)
    out = np.empty(num_to_extrapolate, dtype=dt)
    if dt == np.float32:
        fn, ct = lib.art_extrapolate_f32, ctypes.c_float
    else:
        fn, ct = lib.art_extrapolate_f64, ctypes.c_double
    q = fn(_ptr(values, ct), values.size, num_to_extrapolate, maxloops,
           _ptr(out, ct))
    if q < 0.0 or q != q:
        raise FloatingPointError(f"extrapolator quality factor = {q}")
    return out


def extrap_fit(values: np.ndarray, maxloops: int
               ) -> tuple[np.ndarray, float]:
    """Native coordinate-descent LPC fit; returns (coeffs f32[4], quality)."""
    lib = _load()
    dt = values.dtype
    values = np.ascontiguousarray(values)
    coeffs = np.zeros(4, dtype=np.float32)
    fn = lib.art_extrap_fit_f32 if dt == np.float32 else lib.art_extrap_fit_f64
    ct = ctypes.c_float if dt == np.float32 else ctypes.c_double
    q = fn(_ptr(values, ct), values.size, maxloops,
           _ptr(coeffs, ctypes.c_float))
    return coeffs, float(q)
