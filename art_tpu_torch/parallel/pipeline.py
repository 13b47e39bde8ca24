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

``pipeline_chunk`` is the single-device production chunk of
``art_tpu/parallel/pipeline.py``: the resample on K1, the optional post
filter cascade on the biquad kernel (``ops/biquad_kernel.py``), then
dither, quantize and pack on the decimate kernels
(``ops/decimate_device.py``).
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


def pipeline_chunk(x, hist, P_local, start, K, gens, fb, xh, yh,
                   A=None, V0=None, V1=None, *, M: int, L: int, nb: int,
                   qn_pad: int, qn_local: int, hist_len: int, scaler: float,
                   highclip: int, lowclip: int, dither_type,
                   shaper_a, shaper_b, output_bits: int, output_bytes: int,
                   streams_axis: str | None = None,
                   taps_axis: str | None = None,
                   post_bq=None, bq_state=None, post_bq_tables=None,
                   post_bq_tables32=None, bq_sp_mult: int = 1):
    """One full production chunk with JAX's arguments: resample ->
    [biquad post-filter cascade] -> dither -> (shaped) quantize -> pack,
    state flowing through.  The resample is one K1 step
    (``ops/fixed_step.fixed_step``: the masked [S, nb*L] block and the new
    history) over ``P_local`` [qn_pad*M, L]; ``post_bq`` ((a1, b1), (a2,
    b2)) with ``bq_state`` (xh1, yh1, xh2, yh2), each [4, S], filters K1's
    output, read in place, through two sections of the biquad kernel
    (masked at K; one host call, one launch a section;
    ``post_bq_tables``: iir_tables for the plain version, the kernel
    building its own), and the power is taken after the filter; the rest is
    one launch of ``decimate_flat_kernel`` (``shaper_a`` None) or
    ``decimate_shaped_kernel``.  ``gens``: int32 LCG state bits [S] (or
    uint32 numpy); the dither tables (A, V0, V1) are not read, since the
    kernels step the LCG themselves; ``post_bq_tables32`` and
    ``bq_sp_mult`` change nothing (the solve is exact and needs no lane
    padding).  A CPU tensor takes the plain versions.  Returns (packed u8
    [nb*L, S*output_bytes], new_hist, new_gens, fb', xh', yh', clips i32,
    power[, bq_state']); packed rows at and past K hold code 0.  The mesh
    axes (ROADMAP item 11) are not ported."""
    from .._roadmap import _not_ported
    from ..ops import biquad_kernel as bk
    from ..ops import decimate_device as dd
    from ..ops import fixed_step as k1
    if streams_axis is not None or taps_axis is not None:
        raise _not_ported("pipeline_chunk over a mesh (streams_axis, "
                          "taps_axis)", 11)
    del A, V0, V1, qn_local, post_bq_tables32, bq_sp_mult
    dev = x.device
    new_hist, out, power = k1.fixed_step(
        hist, x, P_local, int(start), int(K),
        torch.zeros((), dtype=x.dtype, device=dev), M=M, L=L, nb=nb,
        qn=qn_pad, hist_len=hist_len)
    if post_bq is not None:
        (a1, b1), (a2, b2) = post_bq
        t1, t2 = post_bq_tables or (None, None)
        out, *new_bq_state = bk._cascade2_step_T(
            out, a1, b1, bq_state[0], bq_state[1], a2, b2, bq_state[2],
            bq_state[3], int(K), t1, t2)
        power = torch.sum(out * out)
    gens = dd.states_tensor(gens, dev)
    fb, xh, yh = (torch.as_tensor(t, dtype=x.dtype, device=dev)
                  for t in (fb, xh, yh))
    kw = dict(scaler=scaler, highclip=highclip, lowclip=lowclip,
              output_bits=output_bits, output_bytes=output_bytes, gens=gens,
              dither_type=dither_type)
    samples = out.T                                         # [nb*L, S]
    if shaper_a is not None:
        packed, clips, new_gens, fb, xh, yh = dd.decimate_shaped(
            samples, int(K), a=shaper_a, b=shaper_b, xh=xh, yh=yh,
            feedback=fb, **kw)
    else:
        packed, clips, new_gens = dd.decimate_flat(
            samples, int(K), feedback=fb, **kw)
    if post_bq is not None:
        return (packed, new_hist, new_gens, fb, xh, yh, clips, power,
                tuple(new_bq_state))
    return packed, new_hist, new_gens, fb, xh, yh, clips, power
