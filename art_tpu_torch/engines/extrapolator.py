"""LPC endpoint extrapolation for gapless stream starts/ends.

Behavioral port of the reference extrapolator (reference extrapolator.c):
a 4-coefficient LPC fit by iterative coordinate descent with halving step
size (reference extrapolator.c:85-230), PARCOR stability clamping
(reference extrapolator.c:234-283), and fallbacks to a delta predictor or the
zero filter when those beat the fit.

This runs on the host: it executes at most once per stream endpoint, on at
most half-a-filter of samples, and its data-dependent early-exit loop has no
useful device mapping.  The trial-error sums are vectorized with strictly
sequential (cumsum) accumulation so the descent takes the same path the
reference's scalar loops take, up to float-association noise.

Coefficients are kept in float32 and products with the sample history round
through float32 exactly as the reference's ``float coeffs[]`` arithmetic does,
so the predicted endpoint samples track the C output closely on the 32-bit
path.

A copy of ``art_tpu/engines/extrapolator.py``, unchanged, so that the
port imports nothing of the JAX package.
"""

from __future__ import annotations

import math

import numpy as np

NCOEFFS = 4
MAXLOOPS = 100000


def _seq_sum(a: np.ndarray) -> float:
    """Strict left-to-right float64 summation."""
    if a.size == 0:
        return 0.0
    return float(np.cumsum(a, dtype=np.float64)[-1])


def _prediction_sums(values: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """sums[k] = sum_c coeffs[N-1-c]*values[k+c] (f32 products) + values[k+N]."""
    nevals = values.size - NCOEFFS
    acc = np.zeros(nevals, dtype=np.float64)
    for c in range(NCOEFFS):
        term = (coeffs[NCOEFFS - 1 - c] * values[c:c + nevals]).astype(np.float32) \
            if values.dtype == np.float32 else coeffs[NCOEFFS - 1 - c] * values[c:c + nevals]
        acc += term.astype(np.float64)
    return acc + values[NCOEFFS:NCOEFFS + nevals].astype(np.float64)


def lpc_to_parcor(lpc: np.ndarray) -> np.ndarray:
    """LPC -> reflection coefficients (reference extrapolator.c:234-264)."""
    n = lpc.size
    temp = lpc.astype(np.float64).copy()
    parcor = np.zeros(n, dtype=np.float64)
    for m in range(n - 1, -1, -1):
        parcor[m] = temp[m]
        denom = 1.0 - parcor[m] * parcor[m]
        if abs(denom) < 1e-6:
            parcor[m] = -0.9999995 if parcor[m] < 0.0 else 0.9999995
            denom = 1.0 - parcor[m] * parcor[m]
        if m > 0:
            nxt = (temp[:m] - parcor[m] * temp[m - 1::-1]) / denom
            temp[:m] = nxt
    return parcor


def parcor_to_lpc(parcor: np.ndarray) -> np.ndarray:
    """Reflection coefficients -> LPC (reference extrapolator.c:268-283)."""
    n = parcor.size
    lpc = np.zeros(n, dtype=np.float64)
    for i in range(n):
        lpc[i] = parcor[i]
        for j in range(i // 2):
            tmp = lpc[j]
            lpc[j] += parcor[i] * lpc[i - 1 - j]
            lpc[i - 1 - j] += parcor[i] * tmp
        if i & 1:
            lpc[i >> 1] += lpc[i >> 1] * parcor[i]
    return lpc


def calc_lpc_coeffs(values: np.ndarray, maxloops: int = MAXLOOPS
                    ) -> tuple[np.ndarray, float]:
    """Coordinate-descent LPC fit (reference extrapolator.c:85-230).

    Returns (coeffs float32[NCOEFFS], quality in bits).
    """
    nvalues = values.size
    nevals = nvalues - NCOEFFS
    coeffs = np.zeros(NCOEFFS, dtype=np.float32)
    step = 3.0 / (1 << 4)
    quality = 20.0

    # the reference squares in the DATA type before the double
    # accumulation (float*float stays float in C): on the f32 path an
    # fl32-rounded values_rms can exceed the descent's double-exact trial
    # error, which is what lets the first trial "improve" on spike
    # windows (reference extrapolator.c:95-107 vs 128-147)
    tail = values[NCOEFFS:NCOEFFS + nevals]
    prev = values[NCOEFFS - 1:NCOEFFS - 1 + nevals]
    deltas_rms = _seq_sum(((tail - prev) * (tail - prev)).astype(np.float64))
    values_rms = _seq_sum((tail * tail).astype(np.float64))
    if values_rms == 0.0:
        return coeffs, quality

    filter_rms_error = values_rms
    loops = 0
    changes = 0

    while filter_rms_error > 0.0 and (not maxloops or loops < maxloops):
        sums = _prediction_sums(values, coeffs)
        improved = False
        for tcoeff in range(NCOEFFS):
            loops += 1
            delta = values[NCOEFFS - tcoeff - 1:
                           NCOEFFS - tcoeff - 1 + nevals].astype(np.float64) * step
            low = _seq_sum((sums - delta) ** 2)
            hi = _seq_sum((sums + delta) ** 2)
            if low < filter_rms_error or hi < filter_rms_error:
                if low < hi:
                    filter_rms_error = low
                    coeffs[tcoeff] = np.float32(coeffs[tcoeff] - step)
                else:
                    filter_rms_error = hi
                    coeffs[tcoeff] = np.float32(coeffs[tcoeff] + step)
                changes += 1
                improved = True
                break
        else:
            loops += 1  # the reference also bumps the counter on the exit test
        if not improved:
            if step > 3.0 / (1 << 22):
                step *= 0.5
            else:
                break

    # stability check via PARCOR clamping
    if changes:
        parcor = lpc_to_parcor(coeffs.astype(np.float64))
        outliers = np.abs(parcor) > 0.9999
        if outliers.any():
            parcor = np.clip(parcor, -0.9999, 0.9999)
            coeffs = parcor_to_lpc(parcor).astype(np.float32)

    # re-evaluate, possibly fall back to delta predictor or zero filter
    sums = _prediction_sums(values, coeffs)
    filter_rms_error = _seq_sum(sums * sums)

    if deltas_rms < filter_rms_error and deltas_rms < values_rms:
        coeffs = np.zeros(NCOEFFS, dtype=np.float32)
        coeffs[0] = -1.0
        filter_rms_error = deltas_rms
    elif values_rms <= filter_rms_error:
        coeffs = np.zeros(NCOEFFS, dtype=np.float32)
        filter_rms_error = values_rms

    if filter_rms_error != 0.0:
        quality = (math.log(values_rms / filter_rms_error) * 0.5) / math.log(2.0)
    quality = min(quality, 20.0)
    if quality < 0.0 or quality != quality:
        raise FloatingPointError(f"extrapolator quality factor = {quality}")
    return coeffs, quality


def extrapolate_forward(values: np.ndarray, num_to_extrapolate: int,
                        maxloops: int = MAXLOOPS) -> np.ndarray:
    """Predict ``num_to_extrapolate`` samples following ``values``
    (reference extrapolator.c:22-43).  Returns the predicted samples.

    Dispatches to the native runtime when available: the descent is a
    strictly serial trial loop (up to 100k trials), 30-300x faster native
    and bit-identical (tests/test_extrapolator_golden.py A/Bs the two)."""
    from .. import native
    if native.available():
        return native.extrapolate(values, num_to_extrapolate, maxloops)
    return extrapolate_forward_host(values, num_to_extrapolate, maxloops)


def extrapolate_forward_host(values: np.ndarray, num_to_extrapolate: int,
                             maxloops: int = MAXLOOPS) -> np.ndarray:
    """Pure-numpy fallback path of :func:`extrapolate_forward`."""
    dtype = values.dtype
    coeffs, _ = calc_lpc_coeffs(values, maxloops)
    rev = coeffs[::-1].copy()      # coeffs[N-1-c] ordering
    # fewer than NCOEFFS history samples: the fit degenerates to the zero
    # filter (values_rms accumulates over nvalues-NCOEFFS <= 0 terms in the
    # reference, extrapolator.c:96-107), so the left padding is never
    # weighted; predictions become -0.0 exactly like the reference's
    # ``*dst++ = -sum`` with sum == 0
    head = values[-NCOEFFS:].astype(dtype)
    if head.size < NCOEFFS:
        head = np.concatenate([np.zeros(NCOEFFS - head.size, dtype=dtype),
                               head])
    src = np.concatenate([head, np.zeros(num_to_extrapolate, dtype=dtype)])
    for i in range(num_to_extrapolate):
        window = src[i:i + NCOEFFS]
        if dtype == np.float32:
            prods = (window * rev).astype(np.float32)
        else:
            prods = window.astype(np.float64) * rev.astype(np.float64)
        src[NCOEFFS + i] = dtype.type(-_seq_sum(prods))
    return src[NCOEFFS:]


def extrapolate_reverse(values: np.ndarray, num_to_extrapolate: int,
                        maxloops: int = MAXLOOPS) -> np.ndarray:
    """Predict ``num_to_extrapolate`` samples *preceding* ``values``
    (reference extrapolator.c:49-65).  Returns them oldest-first, ready to be
    placed directly before ``values``."""
    rev = extrapolate_forward(values[::-1].copy(), num_to_extrapolate, maxloops)
    return rev[::-1].copy()
