"""K1: the fixed-ratio streaming chunk step, on a CUDA kernel.

The counterpart of ``art_tpu/ops/fixed_pallas.py::fixed_step_pallas``: same
arguments, same ``(new_hist, out [ch, nb*L], acc + sum(out**2))`` results.
The contraction runs in ``csrc/fixed_step.cu`` (see its header for what it
computes, what bounds it and how it is laid out); the history concat, the
power sum and the history advance stay plain PyTorch around the launch, as
they sit outside the ``pallas_call`` in JAX.

A CPU tensor takes the plain version (``fixed_step_reference``); a CUDA
tensor launches the kernel or raises.  ``launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from ..parallel.pipeline import resample_block
from . import _build

launches = 0


def fixed_step_reference(hist, x, P, start: int, K: int, acc, *, M: int,
                         L: int, nb: int, qn: int, hist_len: int,
                         fracv=None):
    """The plain PyTorch chunk step (unfold + matmul + mask)."""
    out, new_hist = resample_block(x, hist, P, start, K, M=M, L=L, nb=nb,
                                   qn=qn, hist_len=hist_len, fracv=fracv)
    return new_hist, out, acc + torch.sum(out * out)


def _check(name, t, dev, shape=None):
    if t.device != dev or t.dtype != torch.float32 or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous float32 tensor on "
                         f"{dev}, got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def fixed_step_kernel(buf, P, start: int, K: int, *, M: int, L: int,
                      nb: int, qn: int, fracv=None):
    """Launch K1 over the window buffer ``buf = cat(hist, x)`` [ch, W]:
    returns out [ch, nb*L], block i = buf[:, start + i*M : +qn*M] @ P
    (reads past W are zero), zeroed at and beyond K."""
    global launches
    dev = buf.device
    if dev.type != "cuda":
        raise ValueError(f"K1 runs on CUDA tensors, got {dev}")
    ch, W = buf.shape
    L2 = 2 * L if fracv is not None else L
    _check("buf", buf, dev)
    _check("P", P, dev, (qn * M, L2))
    if fracv is not None:
        _check("fracv", fracv, dev, (L,))
    if not (0 <= start <= W and 0 <= K <= nb * L and nb >= 1):
        raise ValueError(f"bad plan: start={start} W={W} K={K} nb={nb} "
                         f"L={L}")
    lib = _build.library()
    out = torch.empty((ch, nb * L), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.art_fixed_step(
            buf.data_ptr(), ch, W, int(start), int(K), P.data_ptr(), qn * M,
            L2, fracv.data_ptr() if fracv is not None else None, M, L, qn,
            int(nb), out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"art_fixed_step launch failed: cudaError {rc}")
    launches += 1
    return out


def fixed_step(hist, x, P, start: int, K: int, acc, *, M: int, L: int,
               nb: int, qn: int, hist_len: int, fracv=None):
    """One streaming chunk: (new_hist, out [ch, nb*L] zeroed beyond K,
    acc + sum(out**2)).  CPU tensors take fixed_step_reference; CUDA
    tensors launch K1."""
    if hist.device.type == "cpu":
        return fixed_step_reference(hist, x, P, start, K, acc, M=M, L=L,
                                    nb=nb, qn=qn, hist_len=hist_len,
                                    fracv=fracv)
    if (hist.shape[1] != hist_len or x.shape[0] != hist.shape[0]
            or x.device != hist.device or x.dtype != hist.dtype):
        raise ValueError(f"hist {tuple(hist.shape)} {hist.dtype} and x "
                         f"{tuple(x.shape)} {x.dtype} on {x.device} do not "
                         f"match hist_len={hist_len}")
    buf = torch.cat([hist, x], dim=1)
    out = fixed_step_kernel(buf, P, start, K, M=M, L=L, nb=nb, qn=qn,
                            fracv=fracv)
    new_hist = buf[:, buf.shape[1] - hist_len:].contiguous()
    return new_hist, out, acc + torch.sum(out * out)
