"""K1: the fixed-ratio streaming chunk step, on a CUDA kernel; K6 as an
entry point of the same kernel.

The counterpart of ``art_tpu/ops/fixed_pallas.py::fixed_step_pallas``: same
arguments, same ``(new_hist, out [ch, nb*L], acc + sum(out**2))`` results.
The contraction runs in ``csrc/fixed_step.cu`` (see its header for what it
computes, what bounds it and how it is laid out); the history concat, the
power sum and the history advance stay plain PyTorch around the launch, as
they sit outside the ``pallas_call`` in JAX.  ``fixed_step_window`` is the
contraction alone over a window buffer that already holds the history (the
group forms' shared buffer).

Three instances of the kernel serve the engine's precision tiers, chosen by
the data's type and ``precise``: float32 (``"f32"``), float32 data with each
dot accumulated in float64 and rounded once (``precise=True``,
``"f32_acc64"``; JAX's ``precise=True`` and ``precise="int8"``), and float64
data (``"f64"``, where ``precise`` changes nothing).

``polyphase_apply`` is the counterpart of
``art_tpu/ops/pallas_kernels.py::polyphase_apply_pallas`` (K6): the same
contraction with ``start = 0``, nothing masked and an arbitrary dense P.

A CPU tensor takes the plain version (``*_reference``); a CUDA tensor
launches the kernel or raises.  ``launches`` counts K1's launches through
its chunk-step entry points, every instance, and ``instance_launches`` each
instance's; ``polyphase_launches`` counts those through ``polyphase_apply``.
"""

from __future__ import annotations

import ctypes

import torch

from ..parallel.pipeline import resample_block, window_at, window_dots
from ..utils.spans import LAUNCH, span
from . import _build

launches = 0
instance_launches = {"f32": 0, "f32_acc64": 0, "f64": 0}
polyphase_launches = 0

# art_fixed_step's ``kind`` of each instance
_KINDS = {"f32": 0, "f32_acc64": 1, "f64": 2}


def instance(dtype, precise: bool = False) -> str:
    """The K1 instance that runs data of ``dtype``: "f32", "f32_acc64"
    (float32 with ``precise``) or "f64"."""
    if dtype == torch.float64:
        return "f64"
    if dtype == torch.float32:
        return "f32_acc64" if precise else "f32"
    raise ValueError(f"K1 takes float32 or float64 data, got {dtype}")


def fixed_step_reference(hist, x, P, start: int, K: int, acc, *, M: int,
                         L: int, nb: int, qn: int, hist_len: int,
                         fracv=None, precise: bool = False):
    """The plain PyTorch chunk step (unfold + matmul + mask); ``precise``
    accumulates float32 data's dots in float64 and rounds each once."""
    out, new_hist = resample_block(x, hist, P, start, K, M=M, L=L, nb=nb,
                                   qn=qn, hist_len=hist_len, fracv=fracv,
                                   precise=precise)
    return new_hist, out, acc + torch.sum(out * out)


def _check(name, t, dev, dtype, shape=None):
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous {dtype} tensor on "
                         f"{dev}, got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def kernel_tile(M: int, qn: int, interp: bool, *, dtype=torch.float32,
                precise: bool = False):
    """(blocks per CTA, P rows per staged piece, shared-memory bytes) of
    K1's launch for this shape and instance.  Every M fits: where the
    whole window tile does not, the window comes in column pieces beside
    P's.  Raises ValueError for a shape no launch takes (M or qn < 1)."""
    bm, pr, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_longlong()
    rc = _build.library().art_fixed_step_tile(
        M, qn, int(interp), _KINDS[instance(dtype, precise)],
        ctypes.byref(bm), ctypes.byref(pr), ctypes.byref(smem))
    if rc != 0:
        raise ValueError(f"K1 has no tile for M={M}, qn={qn}"
                         f"{', interpolated' if interp else ''}: M and qn "
                         "must be positive")
    return bm.value, pr.value, smem.value


def _launch(buf, P, start: int, K: int, *, M: int, L: int, nb: int,
            qn: int, fracv=None, precise: bool = False):
    """One launch of art_fixed_step (uncounted) on the instance for buf's
    type and ``precise``: out [ch, nb*L] of buf's type, block i = buf[:,
    start + i*M : +qn*M] @ P (reads past W are zero), zeroed at and beyond
    K.  Returns (out, instance)."""
    with span(LAUNCH + "fixed_step"):
        dev = buf.device
        if dev.type != "cuda":
            raise ValueError(f"K1 runs on CUDA tensors, got {dev}")
        ch, W = buf.shape
        L2 = 2 * L if fracv is not None else L
        inst = instance(buf.dtype, precise)
        _check("buf", buf, dev, buf.dtype)
        _check("P", P, dev, buf.dtype, (qn * M, L2))
        if fracv is not None:
            _check("fracv", fracv, dev, buf.dtype, (L,))
        if not (0 <= start <= W and 0 <= K <= nb * L and nb >= 1):
            raise ValueError(f"bad plan: start={start} W={W} K={K} nb={nb} "
                             f"L={L}")
        lib = _build.library()
        out = torch.empty((ch, nb * L), dtype=buf.dtype, device=dev)
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.art_fixed_step(
                buf.data_ptr(), ch, W, int(start), int(K), P.data_ptr(),
                qn * M, L2, fracv.data_ptr() if fracv is not None else None,
                M, L, qn, int(nb), out.data_ptr(), _KINDS[inst], stream)
        if rc != 0:
            raise RuntimeError(f"art_fixed_step launch failed: cudaError "
                               f"{rc} ({inst}, ch={ch}, M={M}, L={L}, "
                               f"qn={qn}, nb={nb})")
        return out, inst


def fixed_step_kernel(buf, P, start: int, K: int, *, M: int, L: int,
                      nb: int, qn: int, fracv=None, precise: bool = False):
    """Launch K1 over the window buffer ``buf`` [ch, W] (history already
    in front): returns out [ch, nb*L], block i = buf[:, start + i*M :
    +qn*M] @ P (reads past W are zero), zeroed at and beyond K."""
    global launches
    out, inst = _launch(buf, P, start, K, M=M, L=L, nb=nb, qn=qn,
                        fracv=fracv, precise=precise)
    launches += 1
    instance_launches[inst] += 1
    return out


def fixed_step_window(buf, P, start: int, K: int, *, M: int, L: int,
                      nb: int, qn: int, fracv=None, precise: bool = False):
    """The contraction of one chunk whose window starts at ``start`` in
    ``buf`` (out [ch, nb*L] zeroed at and beyond K).  CPU tensors take the
    plain version, CUDA tensors launch K1."""
    if buf.device.type == "cpu":
        win = window_at(buf, start, (nb - 1) * M + qn * M)
        return window_dots(win, P, K, M=M, L=L, nb=nb, qn=qn, fracv=fracv,
                           precise=precise)
    return fixed_step_kernel(buf, P, start, K, M=M, L=L, nb=nb, qn=qn,
                             fracv=fracv, precise=precise)


def fixed_step(hist, x, P, start: int, K: int, acc, *, M: int, L: int,
               nb: int, qn: int, hist_len: int, fracv=None,
               precise: bool = False):
    """One streaming chunk: (new_hist, out [ch, nb*L] zeroed beyond K,
    acc + sum(out**2)).  CPU tensors take fixed_step_reference; CUDA
    tensors launch K1."""
    if hist.device.type == "cpu":
        return fixed_step_reference(hist, x, P, start, K, acc, M=M, L=L,
                                    nb=nb, qn=qn, hist_len=hist_len,
                                    fracv=fracv, precise=precise)
    if (hist.shape[1] != hist_len or x.shape[0] != hist.shape[0]
            or x.device != hist.device or x.dtype != hist.dtype):
        raise ValueError(f"hist {tuple(hist.shape)} {hist.dtype} and x "
                         f"{tuple(x.shape)} {x.dtype} on {x.device} do not "
                         f"match hist_len={hist_len}")
    buf = torch.cat([hist, x], dim=1)
    out = fixed_step_kernel(buf, P, start, K, M=M, L=L, nb=nb, qn=qn,
                            fracv=fracv, precise=precise)
    new_hist = buf[:, buf.shape[1] - hist_len:].contiguous()
    return new_hist, out, acc + torch.sum(out * out)


# ---------------------------------------------------------------- K6
def _poly_shape(win, P, M: int, qn: int, L: int) -> int:
    ch, wlen = win.shape
    nb_pad = wlen // M - 512
    if wlen % M or nb_pad < 1 or tuple(P.shape) != (qn * M, L):
        raise ValueError(f"polyphase_apply: win {tuple(win.shape)} must be "
                         f"[ch, (nb_pad + 512)*M] with nb_pad >= 1 and P "
                         f"{tuple(P.shape)} [qn*M, L] for M={M}, qn={qn}, "
                         f"L={L}")
    return nb_pad


def polyphase_apply_reference(win, P, *, M: int, qn: int, L: int):
    """The plain version of K6: out[c, i, :] = win[c, i*M : i*M + qn*M] @ P
    for i < nb_pad = W // M - 512 (unfold + matmul)."""
    nb_pad = _poly_shape(win, P, M, qn, L)
    return win[:, :(nb_pad - 1) * M + qn * M].unfold(1, qn * M, M) @ P


def polyphase_apply(win, P, *, M: int, qn: int, L: int):
    """Fixed-ratio steady-state resample of a pre-aligned window buffer,
    with JAX's arguments: ``win`` [ch, (nb_pad + 512)*M] float32 (the last
    512 block rows are JAX's zero halo tile), ``P`` [qn*M, L] any dense
    matrix.  Returns out [ch, nb_pad, L].  On a CUDA tensor: one launch of
    K1 with start 0, K = nb_pad*L, nb = nb_pad; on a CPU tensor the plain
    version.  (JAX's ``nb_pad % 512 == 0`` is a Mosaic tiling rule and is
    not required here.)"""
    global polyphase_launches
    if win.device.type == "cpu":
        return polyphase_apply_reference(win, P, M=M, qn=qn, L=L)
    nb_pad = _poly_shape(win, P, M, qn, L)
    out = _launch(win, P, 0, nb_pad * L, M=M, L=L, nb=nb_pad, qn=qn)[0]
    polyphase_launches += 1
    return out.view(win.shape[0], nb_pad, L)
