"""Device kernels for the windowed-sinc resampler.

The host accounting (core/accounting.py) reduces every process() call to a
batch of float64 read positions over a linear sample buffer.  This module
turns those positions into audio:

  - ``decompose_positions``: float64 host math splitting each position into
    (window base, filter index, interpolation fraction, passthrough) exactly
    the way the reference subsample functions do
    (reference resampler.c:1135-1157),
  - a numpy backend used as the bit-careful parity reference (float64
    accumulation, lerp of the two filter outputs in float64 like the
    reference's double-precision interpolation arithmetic),
  - a torch backend (``apply_torch``): the two-phase windowed dot of all
    K positions in one launch of the ASRC apply kernel (K5,
    ``ops/asrc_step.py::asrc_apply``) over the channels as its streams.

The fixed-ratio steady-state path has a dedicated formulation in
``polyphase.py`` (the phase-anchor contraction on kernel K1); this module
is the fully-general path that also serves drifting-ratio ASRC.

A copy of ``art_tpu/ops/resample_kernel.py`` but for its JAX half:
``_jitted_apply`` and ``apply_jax`` (a jitted gather + lerp + dot, with
shapes bucketed for XLA's compile cache and the output tiled for the
TPU's gather intermediate) give way to ``apply_torch``, which needs
neither.
"""

from __future__ import annotations

import numpy as np
import torch

from .asrc_step import asrc_apply


def decompose_positions(positions: np.ndarray, num_filters: int,
                        num_taps: int, interpolate: bool,
                        include_lowpass: bool) -> dict:
    """Split emission positions into gather/filter indices (host, float64)."""
    ipos = np.floor(positions)
    return decompose_indexed(ipos.astype(np.int64), positions - ipos,
                             num_filters, num_taps, interpolate,
                             include_lowpass)


def decompose_indexed(ipos: np.ndarray, frac0: np.ndarray, num_filters: int,
                      num_taps: int, interpolate: bool,
                      include_lowpass: bool) -> dict:
    """Like decompose_positions, from precomputed integer positions and
    ring-exact fractions (see core.accounting.ring_positions — the
    reference rounds positions in ring coordinates, which carries more
    fraction precision than the linear sum)."""
    half = num_taps // 2
    base = ipos.astype(np.int64) - half + 1
    if interpolate:
        ff = frac0 * num_filters
        fi = np.floor(ff)
        frac = ff - fi
        fi = fi.astype(np.int64)
        # guard the (half-ulp) case where frac0*F rounds up to exactly F
        over = fi >= num_filters
        fi = np.where(over, num_filters - 1, fi)
        frac = np.where(over, 1.0, frac)
        return dict(base=base, fi=fi, frac=frac,
                    pass_mask=np.zeros(len(ipos), dtype=bool),
                    pass_idx=np.zeros(len(ipos), dtype=np.int64))
    fi = np.floor(frac0 * num_filters + 0.5).astype(np.int64)
    pass_mask = (not include_lowpass) & (fi % num_filters == 0)
    pass_idx = ipos.astype(np.int64) + fi // num_filters
    return dict(base=base, fi=fi, frac=np.zeros_like(frac0),
                pass_mask=pass_mask, pass_idx=pass_idx)



def apply_numpy(L: np.ndarray, bank: np.ndarray, parts: dict,
                interpolate: bool, dtype) -> np.ndarray:
    """Parity backend: float64-accumulated windowed dot per position.

    L: [ch, S] linear buffer; bank: [F+1, T]; returns [ch, K] in ``dtype``.
    """
    ch, _ = L.shape
    T = bank.shape[1]
    K = parts["base"].shape[0]
    if K == 0:
        return np.zeros((ch, 0), dtype=dtype)
    win = np.lib.stride_tricks.sliding_window_view(L, T, axis=1)
    win = win[:, parts["base"], :]                     # [ch, K, T]
    f1 = bank[parts["fi"]]                             # [K, T]
    if interpolate:
        f2 = bank[parts["fi"] + 1]
        d1 = np.einsum("ckt,kt->ck", win, f1, dtype=np.float64)
        d2 = np.einsum("ckt,kt->ck", win, f2, dtype=np.float64)
        frac = parts["frac"][None, :]
        out = d1 * (1.0 - frac) + d2 * frac
    else:
        out = np.einsum("ckt,kt->ck", win, f1, dtype=np.float64)
        if parts["pass_mask"].any():
            passthrough = L[:, parts["pass_idx"]]
            out = np.where(parts["pass_mask"][None, :], passthrough, out)
    return out.astype(dtype, copy=False)


def apply_torch(L: np.ndarray, bank_dev: torch.Tensor, parts: dict,
                interpolate: bool, dtype) -> np.ndarray:
    """The counterpart of JAX's ``apply_jax``: L [ch, S] numpy, bank_dev
    [F + 1, T] of the data's type on the device that runs it, parts from
    ``decompose_indexed``; returns [ch, K] numpy in ``dtype``.

    One ``asrc_apply`` over the channels as streams, every stream with the
    same positions: out = (1 - frac) <win, bank[fi]> + frac <win,
    bank[fi + 1]>, win = L[c, base : base + T] (reads past S are zero, as
    JAX's padded buffer gives).  The kernel reads rows fi and fi + 1, so
    the non-interpolated mode, whose fi reaches F (the rotated extra
    filter, row F), takes that row as the second phase of fi = F - 1 with
    frac = 1: (1 - 1) d(F - 1) + 1 d(F) is d(F) exactly, as frac = 0 gives
    d(fi) for the other rows.  The passthrough outputs then take their
    sample.  A CPU bank runs the plain version, a CUDA bank the kernel."""
    ch, S = L.shape
    K = parts["base"].shape[0]
    if K == 0:
        return np.zeros((ch, 0), dtype=dtype)
    dev = bank_dev.device
    F, T = bank_dev.shape[0] - 1, bank_dev.shape[1]
    buf = torch.zeros((ch, S + T), dtype=bank_dev.dtype, device=dev)
    buf[:, :S] = torch.from_numpy(np.ascontiguousarray(L, dtype=dtype))
    fi = np.asarray(parts["fi"], np.int64)
    frac = np.asarray(parts["frac"], np.float64)
    if not interpolate:
        top = fi == F
        fi = np.where(top, F - 1, fi)
        frac = np.where(top, 1.0, frac)

    def rows(a, t):
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            dev, t).expand(ch, K).contiguous()

    out = asrc_apply(buf, bank_dev, rows(parts["base"], torch.int32),
                     rows(fi, torch.int32), rows(frac, bank_dev.dtype))
    if parts["pass_mask"].any():
        mask = torch.from_numpy(parts["pass_mask"]).to(dev)
        idx = torch.from_numpy(np.asarray(parts["pass_idx"], np.int64)) \
            .to(dev).clamp_(0, S - 1)
        out = torch.where(mask[None, :], buf[:, idx], out)
    return out.cpu().numpy().astype(dtype, copy=False)


def apply_numpy_periodic(L: np.ndarray, bank: np.ndarray, parts: dict,
                         interpolate: bool, dtype, Lp: int, Mp: int
                         ) -> np.ndarray | None:
    """Block-GEMM fast path for fixed rational ratios (reduced or not).

    Within one call the emission positions advance by exactly Mp inputs per
    Lp outputs, so the phase pattern (window offset, filter index, fraction)
    repeats with period Lp and the whole windowed dot factors into one
    [groups, Mp+T] x [Mp+T, Lp] matrix product per filter row — the same
    math as the reference's per-sample loop (reference resampler.c:1147-1157)
    at BLAS speed instead of a gather.  No periodicity is *assumed*: the
    exact per-output (base, fi, frac) arrays are checked column-by-column,
    and any column whose pattern varies across groups (float64 ties at the
    phase-grid edges) plus the non-periodic tail fall back to the gather
    path.  float64 accumulation and the reference's dot-then-lerp order are
    preserved.  Returns None when the layout does not pay off.
    """
    base, fi, frac = parts["base"], parts["fi"], parts["frac"]
    K = base.shape[0]
    T = bank.shape[1]
    G = K // Lp
    if G < 2:
        return None
    Kfast = G * Lp
    pred = base[0] + np.arange(G, dtype=np.int64)[:, None] * Mp
    b2 = base[:Kfast].reshape(G, Lp)
    f2 = fi[:Kfast].reshape(G, Lp)
    r2 = frac[:Kfast].reshape(G, Lp)
    # only the integer pattern (window offset, filter index) must repeat:
    # the float64 fraction enters as a per-output lerp weight after the
    # dots, so its last-ulp wobble across groups costs nothing
    d = b2 - pred
    ok = (np.all(d == d[0], axis=0) & np.all(f2 == f2[0], axis=0)
          & (d[0] >= 0))
    if interpolate is False and parts["pass_mask"].any():
        ok &= ~parts["pass_mask"][:Kfast].reshape(G, Lp).any(axis=0)
    n_ok = int(ok.sum())
    if n_ok == 0 or n_ok < Lp // 2:
        # n_ok == 0 matters at Lp == 1 (e.g. integer-factor allpass
        # downsample: the single slot is the passthrough shortcut), where
        # the Lp//2 bound is vacuous and dj would be an empty reduction
        return None
    dj = d[0, ok].astype(np.int64)
    span = int(dj.max()) + T
    A0 = int(base[0])
    ch, S = L.shape
    if A0 < 0 or A0 + (G - 1) * Mp + span > S:
        return None

    # overlapping group windows as a strided view, flattened to one 2D
    # dgemm (batched 3D matmuls and offset-binned sub-gemms both measured
    # slower than a single banded gemm at these shapes)
    s0, s1 = L.strides
    X = np.lib.stride_tricks.as_strided(
        L[:, A0:], shape=(ch, G, span), strides=(s0, Mp * s1, s1))
    X64 = np.ascontiguousarray(X, dtype=np.float64).reshape(ch * G, span)

    fj = f2[0, ok]
    if interpolate:
        P = np.zeros((span, 2 * n_ok), dtype=np.float64)
        for c, (off, p) in enumerate(zip(dj, fj)):
            P[off:off + T, c] = bank[p]
            P[off:off + T, n_ok + c] = bank[p + 1]
        dd = (X64 @ P).reshape(ch, G, 2 * n_ok)
        rj = r2[:, ok][None, :, :]                    # exact per-output frac
        vals = dd[:, :, :n_ok] * (1.0 - rj) + dd[:, :, n_ok:] * rj
    else:
        P = np.zeros((span, n_ok), dtype=np.float64)
        for c, (off, p) in enumerate(zip(dj, fj)):
            P[off:off + T, c] = bank[p]
        vals = (X64 @ P).reshape(ch, G, n_ok)

    out = np.empty((ch, K), dtype=np.float64)
    cols = np.flatnonzero(ok)
    idx = (np.arange(G)[:, None] * Lp + cols[None, :]).ravel()
    out[:, idx] = vals.reshape(ch, -1)

    # residual: tie-flipped columns and the non-periodic tail via the
    # gather parity path
    rest = np.ones(K, dtype=bool)
    rest[idx] = False
    if rest.any():
        sub = {k: v[rest] for k, v in parts.items()}
        out[:, rest] = apply_numpy(L, bank, sub, interpolate, np.float64)
    return out.astype(dtype, copy=False)
