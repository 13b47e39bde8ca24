"""The fixed-ratio chunk math as plain PyTorch (single shard).

The counterpart of ``art_tpu/parallel/pipeline.py``'s ``_window_and_hist``,
``_mask_outputs`` and ``_resample_block`` with the contraction of
``residue_window_dots``.  On the TPU the residue split exists to avoid a
gather: here ``Tensor.unfold(1, qn*M, M)`` is exactly the overlapping
``[ch, nb, qn*M]`` window view, so one matmul does the contraction.  This is
the plain version kernel K1 (``ops/fixed_step.py``) is held against, and the
step a CPU tensor takes.  float64 data runs in float64 throughout;
``precise`` (float32 data) accumulates each dot in float64 and rounds it
once, as ``residue_window_dots(precise=True)`` does.
"""

from __future__ import annotations

import torch


def window_at(buf, start: int, xlen: int):
    """``xlen`` samples of ``buf`` [S, W] from column ``start``, reads past
    the end zero.  ``jax.lax.dynamic_slice`` clamps an out-of-range start;
    here it raises instead, since the accounting never produces one."""
    W = buf.shape[1]
    if not 0 <= start <= W:
        raise ValueError(f"window start {start} outside [0, {W}]")
    win = buf[:, start:start + xlen]
    if win.shape[1] < xlen:
        win = torch.nn.functional.pad(win, (0, xlen - win.shape[1]))
    return win


def window_and_hist(x, hist, start: int, xlen: int, hist_len: int):
    """History concat -> window of ``xlen`` samples at ``start`` (reads past
    the end are zero) and the advanced history (the last ``hist_len``
    columns of history + input)."""
    buf = torch.cat([hist, x], dim=1)
    return (window_at(buf, start, xlen),
            buf[:, buf.shape[1] - hist_len:].contiguous())


def mask_outputs(out, K: int, nb: int, L: int):
    """Flatten [S, nb, L] output blocks and zero the entries at and beyond
    K."""
    out = out.reshape(out.shape[0], nb * L)
    valid = torch.arange(nb * L, device=out.device) < K
    return out * valid.to(out.dtype)


def window_dots(win, P, K: int, *, M: int, L: int, nb: int, qn: int,
                fracv=None, precise: bool = False):
    """The contraction over a window: output block i < nb is
    ``win[i*M : i*M + qn*M] @ P``; with ``fracv`` P stacks two phase banks
    [qn*M, 2L] whose dots are lerped per phase.  ``precise`` (float32
    data): each dot is taken in float64 and rounded once to float32, then
    the banks are lerped in float32 with one rounding of the sum, as JAX's
    graph does.  Returns out [S, nb*L] zeroed at and beyond K."""
    u = win[:, :(nb - 1) * M + qn * M].unfold(1, qn * M, M)
    if precise and win.dtype == torch.float32:
        d = (u.double() @ P.double()).float()
        if fracv is not None:
            # JAX's graph lerps the rounded dots as fma(d1, 1 - f, d2 * f):
            # XLA contracts it (measured on XLA:CPU, bitwise); d1 * (1 - f)
            # is exact in float64, so the float64 sum rounded to float32 is
            # that fma (but where the float64 sum itself rounds onto a
            # float32 tie)
            d = (d[:, :, :L].double() * (1.0 - fracv).double()
                 + (d[:, :, L:] * fracv).double()).float()
            return mask_outputs(d, K, nb, L)
    else:
        d = u @ P
    if fracv is not None:
        d = d[:, :, :L] * (1.0 - fracv) + d[:, :, L:] * fracv
    return mask_outputs(d, K, nb, L)


def resample_block(x, hist, P, start: int, K: int, *, M: int, L: int,
                   nb: int, qn: int, hist_len: int, fracv=None,
                   precise: bool = False):
    """One chunk's contraction (``window_dots`` over the window of
    history + x at ``start``).  Returns (out [S, nb*L] zeroed beyond K,
    new_hist)."""
    win, new_hist = window_and_hist(x, hist, start, (nb - 1) * M + qn * M,
                                    hist_len)
    return window_dots(win, P, K, M=M, L=L, nb=nb, qn=qn, fracv=fracv,
                       precise=precise), new_hist
