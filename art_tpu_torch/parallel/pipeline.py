"""The single-device production chunk (PyTorch port).

``pipeline_chunk`` is the single-device production chunk of
``art_tpu/parallel/pipeline.py``: the resample on K1
(``ops/fixed_step.py``), the optional post filter cascade on the biquad
kernel (``ops/biquad_kernel.py``), then dither, quantize and pack on the
decimate kernels (``ops/decimate_device.py``).

The fixed-ratio chunk math as plain PyTorch (``window_at``,
``window_and_hist``, ``mask_outputs``, ``window_dots``,
``resample_block``), the plain version K1 is held against, lives beside
its kernel in ``ops/fixed_step.py``; this module re-exports the window
functions under their JAX counterparts' module.
"""

from __future__ import annotations

import torch

from .._roadmap import _not_ported
from ..ops import biquad_kernel as bk
from ..ops import decimate_device as dd
from ..ops import fixed_step as k1
from ..ops.fixed_step import (window_and_hist, window_at,  # noqa: F401
                              window_dots)


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
