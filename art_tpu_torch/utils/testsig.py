"""Deterministic test signals (ARTEST-compatible).

The reference benchmark harness generates white noise with a 64-bit LCG
(``s = ((s<<4) - s) ^ 1`` stepped 3x per sample, reference artest.c:744-754)
and raised cosine fades (reference artest.c:776-798).

Every generator here reproduces the reference *bit-exactly* but is fully
vectorized.  The LCG looks sequential but is actually affine with a
deterministic sign pattern: ``(15*s)^1 == 15*s + 1 - 2*(s&1)`` and the parity
of the state flips every step, so the whole sequence has the closed form
``s_k = 15^k * (s_0 + sum_j c_j * 15^{-(j+1)})`` over Z/2^64 — computed with
cumulative products/sums and the modular inverse of 15.

A copy of ``NoiseLCG``, ``fade_in`` and ``fade_out`` (with the libm cosine
they use) from ``art_tpu/utils/testsig.py``, unchanged, so that the port
imports nothing of the JAX package; ``NoiseLCG.fill`` is bitwise equal to
the original (tests/test_torch_host.py).
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


_LIBM_COS = _libm_fn("cos")


def _cos64(x: np.ndarray) -> np.ndarray:
    if _LIBM_COS is not None:
        return _LIBM_COS(x).astype(np.float64)
    return np.cos(x)


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
