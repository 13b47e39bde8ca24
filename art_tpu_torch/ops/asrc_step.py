"""K2-K5: the batched drifting-ratio ASRC step, on CUDA kernels.

The counterpart of ``art_tpu/parallel/asrc.py::_asrc_step`` (the function
that the Pallas kernels ``asrc_step_hankel``, ``asrc_step_dense`` and
``asrc_step_hankel_ds`` of ``art_tpu/ops/pallas_kernels.py`` compute) and of
``pallas_kernels.asrc_apply_pallas`` with its prologue
``asrc.py::_pallas_prologue``.  The kernels live in ``csrc/asrc_step.cu``
(see its header for what they compute, what bounds them and how they are
laid out):

- ``asrc_step``: positions, phases and the masked two-phase windowed dot in
  one launch; float32 (K2, K3) and float64 (K4) instances;
- ``asrc_apply``: the unmasked two-phase dot from precomputed base/fi/frac
  (K5): float32 (the ASRC engine's ``kernel="pallas"``) and float64 (the
  float64 host ``Resampler(backend="torch")``,
  ``ops/resample_kernel.py::apply_torch``) instances; its prologue
  ``apply_prologue`` is plain PyTorch on the device, as
  ``_pallas_prologue`` is XLA code outside the ``pallas_call``.

A CPU tensor takes the plain version (``asrc_step_reference``,
``asrc_apply_reference``); a CUDA tensor launches the kernel or raises.
``launches`` counts kernel launches per kernel name.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.spans import LAUNCH, span
from . import _build

launches = {"asrc_step": 0, "asrc_step_f64": 0, "asrc_apply": 0,
            "asrc_apply_f64": 0}

TILE = 128      # outputs per gather tile of the plain versions


def decompose_positions(offsets, ratios, k_max: int, *, num_taps: int,
                        num_filters: int, shift: int, dtype):
    """[S, k_max] window bases (int64), phase indices (int64) and lerp
    fractions (``dtype``) of the emissions pos = offsets + k / ratios, in
    float64 with the JAX step's operations (division, not a reciprocal
    product)."""
    k = torch.arange(k_max, dtype=torch.float64, device=offsets.device)
    pos = offsets[:, None] + k[None, :] / ratios[:, None]
    ipos = torch.floor(pos)
    ff = (pos - ipos) * num_filters
    fi = torch.clamp(torch.floor(ff), max=num_filters - 1).to(torch.int64)
    frac = (ff - fi).to(dtype)
    base = ipos.to(torch.int64) - num_taps // 2 + 1 + shift
    return base, fi, frac


def _gather_windows(buf, base, num_taps: int):
    """[S, t, T] windows buf[s, base[s, k] + tap], indices clamped to the
    buffer (as JAX's take_along_axis clip)."""
    S, t = base.shape
    idx = base[:, :, None] + torch.arange(num_taps, device=buf.device)
    idx = idx.clamp_(0, buf.shape[1] - 1).reshape(S, t * num_taps)
    return torch.gather(buf, 1, idx).reshape(S, t, num_taps)


def asrc_step_reference(hist, x, bank, offsets, ratios, Ks, shift: int, *,
                        num_taps: int, num_filters: int, k_max: int,
                        hist_len: int):
    """The plain PyTorch ASRC step, tiled over outputs so that the
    [S, tile, T] gather stays bounded.  hist [S, H], x [S, n], bank
    [F + 1, T] (float32 or float64, one type); offsets, ratios float64 [S];
    Ks int [S].  Returns (new_hist = (hist ++ x)[:, -hist_len:],
    out [S, k_max] with k >= Ks zeroed)."""
    buf = torch.cat([hist, x], dim=1)
    base, fi, frac = decompose_positions(
        offsets, ratios, k_max, num_taps=num_taps, num_filters=num_filters,
        shift=shift, dtype=bank.dtype)
    out = torch.empty((x.shape[0], k_max), dtype=buf.dtype,
                      device=buf.device)
    for k0 in range(0, k_max, TILE):
        sl = slice(k0, min(k0 + TILE, k_max))
        win = _gather_windows(buf, base[:, sl], num_taps)
        fr = frac[:, sl, None]
        w = bank[fi[:, sl]] * (1.0 - fr) + bank[fi[:, sl] + 1] * fr
        out[:, sl] = torch.sum(win * w, dim=2)
    valid = torch.arange(k_max, device=buf.device)[None, :] < Ks[:, None]
    return (buf[:, buf.shape[1] - hist_len:].contiguous(),
            out * valid.to(out.dtype))


def asrc_apply_reference(buf, bank, base, fi, frac):
    """The plain two-phase windowed dot (the K5 body): out[s, k] =
    (1 - frac) * <win, bank[fi]> + frac * <win, bank[fi + 1]>, with win =
    buf[s, base : base + T], unmasked."""
    num_taps = bank.shape[1]
    out = torch.empty(base.shape, dtype=buf.dtype, device=buf.device)
    for k0 in range(0, base.shape[1], TILE):
        sl = slice(k0, k0 + TILE)
        win = _gather_windows(buf, base[:, sl].long(), num_taps)
        f = fi[:, sl].long()
        d1 = torch.sum(win * bank[f], dim=2)
        d2 = torch.sum(win * bank[f + 1], dim=2)
        out[:, sl] = d1 * (1.0 - frac[:, sl]) + d2 * frac[:, sl]
    return out


def apply_prologue(hist, x, offsets, ratios, shift: int, *, num_taps: int,
                   num_filters: int, k_max: int, hist_len: int):
    """The positions of ``asrc_apply``, decomposed on the device (the
    counterpart of ``_pallas_prologue`` without the TPU's lane padding).
    Returns (buf, base, fi int32 [S, k_max], frac [S, k_max], new_hist);
    bases are clamped so every window, the masked ones too, lies in buf."""
    buf = torch.cat([hist, x], dim=1)
    base, fi, frac = decompose_positions(
        offsets, ratios, k_max, num_taps=num_taps, num_filters=num_filters,
        shift=shift, dtype=buf.dtype)
    base = base.clamp_(0, buf.shape[1] - num_taps)
    return (buf, base.to(torch.int32), fi.to(torch.int32), frac,
            buf[:, buf.shape[1] - hist_len:].contiguous())


SMEM_BYTES = 232448     # dynamic shared memory a block may use (H100)
# csrc/asrc_step.cu kStepThreads, kStepSlots<T>: threads per block and
# outputs per thread
STEP_THREADS = 384
STEP_SLOTS = {torch.float32: 8, torch.float64: 6}


class StepGeometry(NamedTuple):
    piece_taps: int         # P: taps per staged bank piece
    lane_span: int          # X: taps a staged row holds past its piece's P
    pieces: int             # ceil(taps / P); the last may be shorter
    outputs_per_block: int
    threads: int
    bank_bytes: int         # two piece buffers of (F + 1) x (P + X) values
    window_capacity: int    # values of a run's window staged in the rest


def step_geometry(num_taps: int, num_filters: int,
                  dtype: torch.dtype) -> StepGeometry:
    """The ASRC step kernel's launch geometry for (taps, F, dtype).  A
    block takes all ``SMEM_BYTES`` of shared memory.  The bank passes
    through it in pieces, double-buffered: all F + 1 rows over the piece's
    P taps and the X that follow, the lane with offset o reading entries
    o .. o + P - 1 of a row, four at a time.  With X a wavefront of values
    (32 float32, 16 float64) and P + X a multiple of it, the 8 lanes of a
    quarter-warp meet 8 different bank columns whatever their phase rows
    (csrc/asrc_step.cu header); that takes the largest such P whose two
    buffers fit, else the largest P and X (multiples of 4) that fit.  A
    run's window is staged in the rest when it fits there.  Raises
    ValueError naming a shape that resampleInit refuses or a type the
    kernel has no instance for."""
    if (num_taps % 4 or not 4 <= num_taps <= 1024
            or not 1 <= num_filters <= 1024
            or dtype not in (torch.float32, torch.float64)):
        raise ValueError(f"the ASRC step kernel has no geometry for "
                         f"taps={num_taps}, F={num_filters}, {dtype}: it "
                         f"takes taps 4-1024 in steps of 4, F 1-1024, "
                         f"float32 or float64")
    width = torch.finfo(dtype).bits // 8
    lanes = 128 // width            # one 128-byte wavefront of values
    # entries per staged row: two of them fit, and one pass of the threads'
    # 16-byte copies covers a row
    row = min(SMEM_BYTES // (2 * (num_filters + 1) * width),
              16 * STEP_THREADS // width) // 4 * 4
    if row >= 2 * lanes:
        X = lanes
        P = min((row - X) // lanes, -(-num_taps // lanes)) * lanes
    else:
        X = max(4, row // 2 // 4 * 4)
        P = max(4, (row - X) // 4 * 4)
    X = min(X, num_taps)
    bank = 2 * (num_filters + 1) * (P + X) * width
    return StepGeometry(P, X, -(-num_taps // P),
                        STEP_THREADS * STEP_SLOTS[dtype], STEP_THREADS, bank,
                        (SMEM_BYTES - bank) // width)


def _check(name, t, dev, dtype, shape):
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous {dtype} tensor on "
                         f"{dev}, got a {'' if t.is_contiguous() else 'non-'}"
                         f"contiguous {t.dtype} on {t.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _check_bank(bank, num_taps: int):
    # the kernels read bank rows in 16-byte loads
    if num_taps % 4 or bank.data_ptr() % 16:
        raise ValueError(f"bank: needs taps % 4 == 0 and a 16-byte aligned "
                         f"start, got {num_taps} taps at "
                         f"{bank.data_ptr():#x}")


def asrc_step_kernel(hist, x, bank, offsets, ratios, Ks, shift: int, *,
                     num_taps: int, num_filters: int, k_max: int):
    """Launch the ASRC step kernel (float32 or float64 by ``hist``'s type)
    over buf = hist ++ x, read in place.  Returns out [S, k_max] with
    k >= Ks zeroed."""
    f64 = hist.dtype == torch.float64
    name = "asrc_step_f64" if f64 else "asrc_step"
    with span(LAUNCH + name):
        dev = hist.device
        if dev.type != "cuda":
            raise ValueError(f"the ASRC step kernel runs on CUDA tensors, "
                             f"got {dev}")
        if hist.dtype not in (torch.float32, torch.float64):
            raise ValueError(f"the ASRC step kernel takes float32 or "
                             f"float64, got {hist.dtype}")
        S, H = hist.shape
        n = x.shape[1]
        _check("hist", hist, dev, hist.dtype, (S, H))
        _check("x", x, dev, hist.dtype, (S, n))
        _check("bank", bank, dev, hist.dtype, (num_filters + 1, num_taps))
        _check_bank(bank, num_taps)
        _check("offsets", offsets, dev, torch.float64, (S,))
        _check("ratios", ratios, dev, torch.float64, (S,))
        _check("Ks", Ks, dev, torch.int32, (S,))
        if k_max <= 0 or not 1 <= H + n < 2**31:
            raise ValueError(f"bad step: k_max={k_max}, H={H}, n={n} (the "
                             f"kernel takes 1 <= H + n < 2**31 per stream)")
        geo = step_geometry(num_taps, num_filters, hist.dtype)
        lib = _build.library()
        fn = lib.art_asrc_step_f64 if f64 else lib.art_asrc_step_f32
        out = torch.empty((S, k_max), dtype=hist.dtype, device=dev)
        with torch.cuda.device(dev):
            rc = fn(hist.data_ptr(), H, x.data_ptr(), n, S,
                    bank.data_ptr(), num_taps, num_filters, geo.piece_taps,
                    geo.lane_span, geo.outputs_per_block, geo.threads,
                    offsets.data_ptr(), ratios.data_ptr(), Ks.data_ptr(),
                    int(shift), int(k_max), out.data_ptr(), _stream(dev))
        if rc != 0:
            raise RuntimeError(f"art_{name} launch failed: cudaError {rc}")
        launches[name] += 1
        return out


def asrc_step(hist, x, bank, offsets, ratios, Ks, shift: int, *,
              num_taps: int, num_filters: int, k_max: int, hist_len: int):
    """One batched ASRC chunk: (new_hist, out [S, k_max] with k >= Ks
    zeroed).  CPU tensors take asrc_step_reference; CUDA tensors launch
    the kernel."""
    if hist.device.type == "cpu":
        return asrc_step_reference(hist, x, bank, offsets, ratios, Ks, shift,
                                   num_taps=num_taps,
                                   num_filters=num_filters, k_max=k_max,
                                   hist_len=hist_len)
    out = asrc_step_kernel(hist, x, bank, offsets, ratios, Ks, shift,
                           num_taps=num_taps, num_filters=num_filters,
                           k_max=k_max)
    n = x.shape[1]
    if n >= hist_len:
        new_hist = x[:, n - hist_len:].contiguous()
    else:
        new_hist = torch.cat([hist[:, n:], x], dim=1)
    return new_hist, out


def asrc_apply_kernel(buf, bank, base, fi, frac):
    """Launch the two-phase apply kernel (the step kernel's template with
    given positions, on ``step_geometry``'s bank pieces and runs for its
    type), float32 or float64 by ``buf``'s type: out [S, K], unmasked.
    Phase rows are read at fi and fi + 1, so fi must lie in [0, F - 1]
    for a bank of F + 1 rows."""
    dt = buf.dtype
    f64 = dt == torch.float64
    name = "asrc_apply_f64" if f64 else "asrc_apply"
    with span(LAUNCH + name):
        dev = buf.device
        if dev.type != "cuda":
            raise ValueError(f"the ASRC apply kernel runs on CUDA tensors, "
                             f"got {dev}")
        if dt not in (torch.float32, torch.float64):
            raise ValueError(f"the ASRC apply kernel takes float32 or "
                             f"float64, got {dt}")
        S, B = buf.shape
        K = base.shape[1]
        num_taps = bank.shape[1]
        _check("buf", buf, dev, dt, (S, B))
        _check("bank", bank, dev, dt, (bank.shape[0], num_taps))
        _check_bank(bank, num_taps)
        _check("base", base, dev, torch.int32, (S, K))
        _check("fi", fi, dev, torch.int32, (S, K))
        _check("frac", frac, dev, dt, (S, K))
        if K <= 0 or not num_taps <= B < 2**31:
            raise ValueError(f"bad apply: K={K}, B={B}, bank "
                             f"{tuple(bank.shape)} (the kernel takes taps "
                             f"<= B < 2**31)")
        # the step's bank pieces and runs of this type
        geo = step_geometry(num_taps, bank.shape[0] - 1, dt)
        lib = _build.library()
        fn = lib.art_asrc_apply_f64 if f64 else lib.art_asrc_apply_f32
        out = torch.empty((S, K), dtype=dt, device=dev)
        with torch.cuda.device(dev):
            rc = fn(buf.data_ptr(), S, B, bank.data_ptr(), num_taps,
                    bank.shape[0] - 1, geo.piece_taps, geo.lane_span,
                    geo.outputs_per_block, geo.threads, base.data_ptr(),
                    fi.data_ptr(), frac.data_ptr(), K, out.data_ptr(),
                    _stream(dev))
        if rc != 0:
            raise RuntimeError(f"art_asrc_apply_{'f64' if f64 else 'f32'} "
                               f"launch failed: cudaError {rc}")
        launches[name] += 1
        return out


def asrc_apply(buf, bank, base, fi, frac):
    """The two-phase windowed dot from precomputed indices (unmasked).  CPU
    tensors take asrc_apply_reference; CUDA tensors launch the kernel."""
    if buf.device.type == "cpu":
        return asrc_apply_reference(buf, bank, base, fi, frac)
    return asrc_apply_kernel(buf, bank, base, fi, frac)
