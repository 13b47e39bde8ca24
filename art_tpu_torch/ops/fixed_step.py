"""K1: the fixed-ratio streaming chunk step, on a CUDA kernel; K6 as an
entry point of the same kernel.

The counterpart of ``art_tpu/ops/fixed_pallas.py::fixed_step_pallas``: same
arguments, same ``(new_hist, out [ch, nb*L], acc + sum(out**2))`` results.
The contraction runs in ``csrc/fixed_step.cu`` (see its header for what it
computes, what bounds it and how it is laid out); the history concat, the
power sum and the history advance stay plain PyTorch around the launch, as
they sit outside the ``pallas_call`` in JAX.  ``fixed_step_window`` is the
contraction alone over a window buffer that already holds the history (the
group forms' shared buffer), and ``fixed_step_group`` the delivering group
forms' G periodic chunks of one such buffer.

Three instances of the kernel serve the engine's precision tiers, chosen by
the data's type and ``precise``: float32 (``"f32"``), float32 data with each
dot accumulated in float64 and rounded once (``precise=True``,
``"f32_acc64"``; JAX's ``precise=True`` and ``precise="int8"``), and float64
data (``"f64"``, where ``precise`` changes nothing).

``polyphase_apply`` is the counterpart of
``art_tpu/ops/pallas_kernels.py::polyphase_apply_pallas`` (K6): the same
contraction with ``start = 0``, nothing masked and an arbitrary dense P.

The plain version is the counterpart of ``art_tpu/parallel/pipeline.py``'s
``_window_and_hist``, ``_mask_outputs`` and ``_resample_block`` with the
contraction of ``residue_window_dots`` (``window_at`` .. ``resample_block``
below).  On the TPU the residue split exists to avoid a gather: here
``Tensor.unfold(1, qn*M, M)`` is exactly the overlapping ``[ch, nb, qn*M]``
window view, so one matmul does the contraction.  float64 data runs in
float64 throughout; ``precise`` (float32 data) accumulates each dot in
float64 and rounds it once, as ``residue_window_dots(precise=True)`` does.

A CPU tensor takes the plain version (``*_reference``); a CUDA tensor
launches the kernel or raises.  ``launches`` counts K1's launches through
its chunk-step entry points, every instance, and ``instance_launches`` each
instance's; ``polyphase_launches`` counts those through ``polyphase_apply``.
``path_launches`` counts every launch (both entry points) by the design it
took, as the launch reports it: "resident" (float32 summed in float32 at
shapes whose P and window ring fit a CTA's shared memory, the main path),
"hull" (float32 reduced shapes where they do not, but P's hull rows and
two buffers of each block's hull span of the window do: the hulls of P's
column groups, found on P's first launch and kept beside it),
"persistent_f64" (float64 reduced shapes whose 128-block window and two
pieces of P's hull rows fit, on those hulls: config 4's 5.1 chain) or
"template" (the rest); ``kernel_tile`` says which a shape takes, and
``launch_tile`` which the launches on a given P take.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.utils.weak import WeakIdKeyDictionary

from ..utils.spans import LAUNCH, build, first_launch, span
from . import _build

launches = 0
instance_launches = {"f32": 0, "f32_acc64": 0, "f64": 0}
polyphase_launches = 0
path_launches = {"resident": 0, "hull": 0, "persistent_f64": 0,
                 "template": 0}
# art_fixed_step's *design
_DESIGNS = ("template", "resident", "hull", "persistent_f64")

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


# ------------------------------------------------------- plain version
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


def fixed_step_reference(hist, x, P, start: int, K: int, acc, *, M: int,
                         L: int, nb: int, qn: int, hist_len: int,
                         fracv=None, precise: bool = False):
    """The plain PyTorch chunk step (unfold + matmul + mask); ``precise``
    accumulates float32 data's dots in float64 and rounds each once."""
    out, new_hist = resample_block(x, hist, P, start, K, M=M, L=L, nb=nb,
                                   qn=qn, hist_len=hist_len, fracv=fracv,
                                   precise=precise)
    return new_hist, out, acc + torch.sum(out * out)


# ------------------------------------------------------- P's hulls
# P -> [P's version counter when its hulls were found, the hulls of each
# 32-phase column group's two 16-phase halves [2 ceil(L / 32), 2] int32 on
# P's device, the widest column group's hull rounded out to 4-row groups,
# (M, P's hull rows packed for the persistent float64 design, their rows a
# group) once a launch of that design asked for them, else None]
_kept_hulls = WeakIdKeyDictionary()


def column_hulls(P, cols: int = 32):
    """The hull of each group of ``cols`` phases of P [KQ, L]: int32
    [ceil(L / cols), 2] on P's device, rows [klo, khi), the first and one
    past the last row in which any of the group's columns is nonzero;
    (0, 0) for a group that is zero."""
    KQ, L = P.shape
    groups = -(-L // cols)
    nz = P != 0
    nz = torch.cat([nz, nz.new_zeros((KQ, groups * cols - L))], dim=1)
    rows = nz.view(KQ, groups, cols).any(dim=2).to(torch.int32)
    lo = rows.argmax(dim=0)
    hi = KQ - rows.flip(0).argmax(dim=0)
    return (torch.stack([lo, hi], dim=1)
            * rows.any(dim=0)[:, None]).to(torch.int32)


def hull_rows(hulls) -> int:
    """The widest hull of ``column_hulls`` rounded out to 4-row groups
    (the rows the hull design stages a column group), 0 if all are
    empty."""
    h = torch.as_tensor(hulls).to(torch.int64)
    width = ((h[:, 1] + 3) & ~3) - (h[:, 0] & ~3)
    return int(torch.where(h[:, 1] > h[:, 0], width, 0).max())


@functools.lru_cache(maxsize=None)
def _takes_hulls(M: int, qn: int, interp: bool, inst: str) -> bool:
    """Whether the launches of this shape and instance take a design
    that needs P's hulls (the hull design, the persistent float64 one) on
    some P."""
    return _geometry(M, qn, interp, _KINDS[inst], 4)[0] in (
        "hull", "persistent_f64")


def _kept_of(P):
    """P's entry in ``_kept_hulls``, made on P's first launch and again
    after P changes in place (its version counter moves); one small copy
    to the host each time."""
    kept = _kept_hulls.get(P)
    if kept is None or kept[0] != P._version:
        with build("hulls"):
            halves = torch.zeros((2 * -(-P.shape[1] // 32), 2),
                                 dtype=torch.int32, device=P.device)
            h = column_hulls(P, cols=16)
            halves[:len(h)] = h
            kept = [P._version, halves, hull_rows(column_hulls(P)), None]
        _kept_hulls[P] = kept
    return kept


def _hulls_of(P):
    """(P's column-group halves' hulls, hull_rows of its column groups),
    kept beside P."""
    kept = _kept_of(P)
    return kept[1], kept[2]


def p64_group_rows(halves, M: int):
    """The padded rows [a, b) the persistent float64 design runs for each
    column group, from its two 16-phase halves' hulls (``halves`` [2G, 2],
    as ``_hulls_of`` keeps them): the union of the halves in padded rows,
    rounded out to 4-row groups (csrc/fixed_step_geometry.h::p64_rows, the
    code the kernel runs).  Returns [(a, b), ...]."""
    lib = _build.geometry_library()
    out = (ctypes.c_int * 2)()
    h = torch.as_tensor(halves).tolist()
    rows = []
    for g in range(len(h) // 2):
        if lib.art_fixed_step_p64_rows(M, *h[2 * g], *h[2 * g + 1], out):
            raise ValueError(f"no padded rows for M={M}")
        rows.append((out[0], out[1]))
    return rows


def p64_sources(M: int, a: int, b: int):
    """The row of P that each padded row of [a, b) holds, -1 for a pad
    row (csrc/fixed_step_geometry.h::p64_source_row)."""
    out = (ctypes.c_int * max(b - a, 1))()
    if _build.geometry_library().art_fixed_step_p64_sources(M, a, b, out):
        raise ValueError(f"no padded rows [{a}, {b}) for M={M}")
    return list(out[:b - a])


def _packed_of(P, M: int):
    """(P's hull rows packed for the persistent float64 design, R): for
    column group g, row j of ``packed[g]`` [R, 32] is padded row a_g + j
    (``p64_group_rows``) of P over the group's 32 phases (zero for a pad
    row and for phases past L), R the most rows of a group, so that each
    piece the kernel stages is one contiguous copy.  Built on P's first
    launch of the design from its kept hulls, and kept with them."""
    kept = _kept_of(P)
    if kept[3] is None or kept[3][0] != M:
        with build("hulls"):
            rows = p64_group_rows(kept[1].cpu(), M)
            R = max(b - a for a, b in rows)
            L = P.shape[1]
            packed = P.new_zeros((len(rows), max(R, 1), 32))
            for g, (a, b) in enumerate(rows):
                src = torch.tensor(p64_sources(M, a, b), dtype=torch.int64,
                                   device=P.device)
                keep = src >= 0
                c0, c1 = 32 * g, min(32 * g + 32, L)
                packed[g, :b - a, :c1 - c0][keep] = P[src[keep], c0:c1]
            kept[3] = (M, packed, R)
    return kept[3][1], kept[3][2]


def launch_tile(P, *, M: int, qn: int, fracv=None, precise: bool = False):
    """``kernel_tile`` of K1's launches on P [qn*M, L] (float32 or
    float64, L2 columns with ``fracv``): with P's hulls where the shape
    may take a design that reads them."""
    interp, inst = fracv is not None, instance(P.dtype, precise)
    rows = _hulls_of(P)[1] if _takes_hulls(M, qn, interp, inst) else 0
    return kernel_tile(M, qn, interp, dtype=P.dtype, precise=precise,
                       hull=rows)


def window_frame(P, start: int, W: int, *, M: int, qn: int, fracv=None,
                 precise: bool = False):
    """The zeros (lead, tail) a caller puts before and after a window
    buffer of width ``W`` whose first window starts at ``start``, for K1's
    launches on P: where they take the hull design (a CUDA P), enough that
    start + lead and the framed width are multiples of 4, so the design
    copies its rows in 16-byte pieces; else (0, 0), since the other
    designs' copies do not depend on it and the zeros would cost the
    buffer's concat its vectorized form.  No window reads the zeros in
    front; those behind read as the zeros past the end would."""
    if P.device.type != "cuda" or launch_tile(
            P, M=M, qn=qn, fracv=fracv, precise=precise)[0] != "hull":
        return 0, 0
    lead = -start % 4
    return lead, -(lead + W) % 4


def _check(name, t, dev, dtype, shape=None):
    if t.device != dev or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(f"{name}: needs a contiguous {dtype} tensor on "
                         f"{dev}, got {t.dtype} on {t.device}")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def kernel_tile(M: int, qn: int, interp: bool, *, dtype=torch.float32,
                precise: bool = False, hull: int = 0):
    """(design, blocks a row tile, P rows a staged piece, shared-memory
    bytes) of K1's launch for this shape and instance on a P whose widest
    column-group hull, rounded out to 4-row groups, is ``hull`` rows
    (``hull_rows``; 0: no hull known), from ``csrc/fixed_step_geometry.h``
    (the code the launch runs, built for the host: no card needed).  The
    design is "resident" (the whole P of a CTA's columns held, all qn*M
    rows a piece), "hull" (P's hull rows held, ``hull`` rows a piece),
    "persistent_f64" (float64: P's hull rows streamed through two buffers
    of that many rows each) or "template".  Every M fits: where the whole
    window tile does not, the template brings the window in column pieces
    beside P's.  Raises ValueError for a shape no launch takes (M or qn <
    1)."""
    return _geometry(M, qn, interp, _KINDS[instance(dtype, precise)], hull)


def _geometry(M: int, qn: int, interp: bool, kind: int, hull: int):
    """``kernel_tile`` for art_fixed_step's ``kind`` of the instance."""
    geo = (ctypes.c_longlong * 4)()
    rc = _build.geometry_library().art_fixed_step_geometry(
        M, qn, int(interp), kind, hull, geo)
    if rc != 0:
        raise ValueError(f"K1 has no tile for M={M}, qn={qn}"
                         f"{', interpolated' if interp else ''}: M and qn "
                         "must be positive")
    return (_DESIGNS[geo[0]], geo[1], geo[2], geo[3])


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
        hulls, rows, packed, R = None, 0, None, 0
        if _takes_hulls(M, qn, fracv is not None, inst):
            hulls, rows = _hulls_of(P)
            if inst == "f64" and hulls is not None:
                packed, R = _packed_of(P, M)
        out = torch.empty((ch, nb * L), dtype=buf.dtype, device=dev)
        design = ctypes.c_int()
        with torch.cuda.device(dev), \
                first_launch(("fixed_step", inst, fracv is None, M, qn)):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.art_fixed_step(
                buf.data_ptr(), ch, W, int(start), int(K), P.data_ptr(),
                qn * M, L2, fracv.data_ptr() if fracv is not None else None,
                M, L, qn, int(nb), out.data_ptr(), _KINDS[inst],
                hulls.data_ptr() if hulls is not None else None, rows,
                packed.data_ptr() if packed is not None else None, R,
                ctypes.byref(design), stream)
        if rc != 0:
            raise RuntimeError(f"art_fixed_step launch failed: cudaError "
                               f"{rc} ({inst}, ch={ch}, M={M}, L={L}, "
                               f"qn={qn}, nb={nb})")
        path_launches[_DESIGNS[design.value]] += 1
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


def fixed_step_group(buf, P, start0: int, K0: int, *, G: int, n_in: int,
                     M: int, L: int, nb: int, qn: int, fracv=None,
                     precise: bool = False):
    """The valid outputs of G periodic chunks of ``n_in`` inputs each,
    [ch, G*K0], chunk g's window starting at ``start0 + g*n_in`` in
    ``buf``.  On the CPU the plain version chunk by chunk, at a chunk
    step's shapes.  On a card one K1 launch over G*nb blocks: a periodic
    plan has n_in = nb*M and K0 = nb*L, so chunk g's blocks are block rows
    g*nb.. of ``buf`` and nothing inside the group is masked."""
    kw = dict(M=M, L=L, qn=qn, fracv=fracv, precise=precise)
    if buf.device.type == "cpu":
        return torch.cat([
            fixed_step_window(buf, P, start0 + g * n_in, K0, nb=nb,
                              **kw)[:, :K0] for g in range(G)], dim=1)
    if K0 != nb * L or n_in != nb * M:
        raise RuntimeError(f"periodic plan with K0={K0}, n_in={n_in} is "
                           f"not nb={nb} whole periods")
    return fixed_step_kernel(buf, P, start0, G * K0, nb=G * nb, **kw)


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
