"""Deterministic test signals and checksums (ARTEST-compatible).

The reference benchmark harness generates white noise with a 64-bit LCG
(``s = ((s<<4) - s) ^ 1`` stepped 3x per sample, reference artest.c:744-754),
sine tones with an accumulated phase (reference artest.c:758-774), raised
cosine fades (reference artest.c:776-798), and an order-sensitive
multiplicative checksum over raw sample bits (reference artest.c:90-104).

Every generator here reproduces the reference *bit-exactly* but is fully
vectorized.  The LCG looks sequential but is actually affine with a
deterministic sign pattern: ``(15*s)^1 == 15*s + 1 - 2*(s&1)`` and the parity
of the state flips every step, so the whole sequence has the closed form
``s_k = 15^k * (s_0 + sum_j c_j * 15^{-(j+1)})`` over Z/2^64 — computed with
cumulative products/sums and the modular inverse of 15.

A copy of ``art_tpu/utils/testsig.py``, whole and unchanged, so that the
port imports nothing of the JAX package; its signals, stats and checksums
are bitwise equal to the original's (tests/test_torch_host.py).
"""

from __future__ import annotations

import numpy as np

LCG_SEED = 0x3141592653589793
_INV15 = pow(15, -1, 1 << 64)


class NoiseLCG:
    """Bit-exact, vectorized ARTEST noise source (+/-0.5 white noise)."""

    def __init__(self, seed: int = LCG_SEED):
        self.state = seed & 0xFFFFFFFFFFFFFFFF

    def _raw_states(self, nsteps: int) -> np.ndarray:
        """States after steps 1..nsteps of s -> (15*s)^1 (mod 2^64)."""
        s0 = np.uint64(self.state)
        j = np.arange(nsteps, dtype=np.uint64)
        parity = (np.uint64(self.state & 1) ^ (j & np.uint64(1)))
        c = np.where(parity == 0, np.uint64(1), np.uint64(0xFFFFFFFFFFFFFFFF))
        with np.errstate(over="ignore"):
            B = np.cumprod(np.full(nsteps, _INV15, dtype=np.uint64))
            V = np.cumsum(c * B)
            A = np.cumprod(np.full(nsteps, 15, dtype=np.uint64))
            states = A * s0 + A * V
        return states

    def fill(self, count: int, dtype=np.float32) -> np.ndarray:
        states = self._raw_states(3 * count)
        picks = states[2::3]
        self.state = int(picks[-1]) if count else self.state
        vals = (picks >> np.uint64(32)).astype(np.int64)
        vals = np.where(vals >= 1 << 31, vals - (1 << 32), vals)
        return (vals.astype(np.float64) / 4294967296.0).astype(dtype)


def _libm_fn(name):
    """glibc's sin/cos differ from numpy's vectorized versions in the last
    ulp; checksum parity with the C harness needs the same libm."""
    import ctypes
    import ctypes.util
    try:
        lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
        fn = getattr(lib, name)
        fn.restype = ctypes.c_double
        fn.argtypes = [ctypes.c_double]
        return np.frompyfunc(fn, 1, 1)
    except OSError:  # pragma: no cover
        return None


_LIBM_SIN = _libm_fn("sin")
_LIBM_COS = _libm_fn("cos")


def _sin64(x: np.ndarray) -> np.ndarray:
    if _LIBM_SIN is not None:
        return _LIBM_SIN(x).astype(np.float64)
    return np.sin(x)


def _cos64(x: np.ndarray) -> np.ndarray:
    if _LIBM_COS is not None:
        return _LIBM_COS(x).astype(np.float64)
    return np.cos(x)


class ToneGenerator:
    """Bit-exact ARTEST tone source (reference artest.c:758-774)."""

    def __init__(self):
        self.phase_angle = 0.0

    def fill(self, count: int, chans: int, freq: float,
             dtype=np.float32) -> np.ndarray:
        chan_offset = 2.0 * np.pi / chans if chans > 2 else np.pi / 2.0
        # cumsum with the carried angle as element 0 reproduces the
        # reference's running `phase += 2*pi*f` rounding chain exactly
        steps = np.empty(count + 1, dtype=np.float64)
        steps[0] = self.phase_angle
        steps[1:] = 2.0 * np.pi * freq
        phases = np.cumsum(steps)[1:]
        self.phase_angle = float(phases[-1]) if count else self.phase_angle
        out = np.empty((count, chans), dtype=np.float64)
        out[:, 0] = _sin64(phases) * 0.5
        for c in range(1, chans):
            out[:, c] = _sin64(phases + chan_offset * c) * 0.5
        return out.astype(dtype)


def fade_in(data: np.ndarray) -> None:
    """In-place raised-cosine fade-in over a flat buffer
    (reference artest.c:776-786)."""
    count = data.size
    zcount = count // 4
    fcount = count - zcount
    flat = data.reshape(-1)
    flat[:zcount] = 0.0
    i = np.arange(fcount, dtype=np.float64)
    flat[zcount:] = (flat[zcount:].astype(np.float64)
                     * (_cos64((fcount - i) * np.pi / fcount) + 1.0) / 2.0
                     ).astype(data.dtype)


def fade_out(data: np.ndarray) -> None:
    """In-place raised-cosine fade-out (reference artest.c:788-798)."""
    count = data.size
    zcount = count // 4
    fcount = count - zcount
    flat = data.reshape(-1)
    i = np.arange(fcount, dtype=np.float64)
    flat[:fcount] = (flat[:fcount].astype(np.float64)
                     * (_cos64(i * np.pi / fcount) + 1.0) / 2.0
                     ).astype(data.dtype)
    flat[fcount:] = 0.0


class Stats:
    """Running stream statistics (reference artest.c:83-114)."""

    def __init__(self, chans: int, dtype=np.float32):
        self.count = 0
        self.checksum = 0
        # the reference stores min/max in artsample_t, so the 1e20
        # sentinel rounds to float32 (1.00000002e20) on the f32 build —
        # visible verbatim in the stats line of an empty stream
        self.min = float(np.dtype(dtype).type(1e20))
        self.max = -self.min
        self.rms = 0.0
        self.chans = chans

    def update(self, data: np.ndarray) -> None:
        flat = np.ascontiguousarray(data).reshape(-1)
        self.count += flat.size
        if flat.size == 0:
            return
        self.checksum = checksum_bits(flat, self.checksum)
        self.min = min(self.min, float(flat.min()))
        self.max = max(self.max, float(flat.max()))
        self.rms += float((flat.astype(np.float64) ** 2).sum())

    def rms_db(self) -> float:
        # mirror the C expression log10(rms/count*2)*10 exactly, including
        # its edge values: count==0 gives nan (0/0), an all-zero stream
        # gives -inf — printed, never raised/warned (reference artest.c:111)
        with np.errstate(divide="ignore", invalid="ignore"):
            q = np.divide(self.rms, float(self.count))
            return float(np.log10(q * 2.0) * 10.0)

    def display(self) -> str:
        rms = self.rms_db()
        # glibc printf renders the 0/0 quiet NaN as "-nan" (sign bit set);
        # match the reference binary's degenerate empty-stream line
        rms_s = "-nan" if np.isnan(rms) else f"{rms:.2f}"
        return (f"count = {self.count // self.chans:9d}, "
                f"checksum = {self.checksum:016x}, "
                f"range = {self.min:.7f} to {self.max:.7f}, "
                f"RMS = {rms_s} dB")


def checksum_bits(data: np.ndarray, initial: int = 0) -> int:
    """Order-sensitive checksum ``c = c*3 + bits`` over the low 32 bits of
    each sample's storage (reference artest.c:98).  Vectorized via
    ``c_N = c_0*3^N + sum_i b_i*3^(N-1-i)`` mod 2^64."""
    flat = np.ascontiguousarray(data).reshape(-1)
    if flat.dtype == np.float32:
        bits = flat.view(np.uint32).astype(np.uint64)
    elif flat.dtype == np.float64:
        # the reference reads a uint32 through the sample pointer: low word
        bits = (flat.view(np.uint64) & np.uint64(0xFFFFFFFF))
    else:
        bits = flat.astype(np.uint64)
    n = bits.size
    if n == 0:
        return initial
    # c_N = c0*3^N + sum_i b_i * 3^(N-1-i), all mod 2^64
    with np.errstate(over="ignore"):
        pows = np.cumprod(np.full(n, 3, dtype=np.uint64))  # 3^1..3^n
        weights = np.empty(n, dtype=np.uint64)
        weights[-1] = 1
        if n > 1:
            weights[:-1] = pows[:n - 1][::-1]
        out = np.uint64(initial) * pows[-1] + (bits * weights).sum()
    return int(out)


def checksum_bytes(data: np.ndarray, initial: int = 0) -> int:
    """Byte-stream checksum (reference artest.c:587-588)."""
    return checksum_bits(np.ascontiguousarray(data).reshape(-1).view(np.uint8),
                         initial)
