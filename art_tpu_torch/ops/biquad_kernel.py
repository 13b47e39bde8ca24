"""Device biquad filtering: the block IIR of an order-4 section on a CUDA
kernel.

The counterpart of ``art_tpu/ops/biquad_kernel.py``, which JAX runs as XLA
code (there is no Pallas in it).  An order-4 section
y_n = sum_i a_i x_{n-i} - sum_j b_j y_{n-j} splits into a feed-forward FIR
part f_n and the recurrence y_n = f_n - sum_j b_j y_{n-j}, whose state is
a 4-vector moved by the constant companion matrix A.  Per block of B
frames y_t = G[t] @ e + sum_{j<=t} h[t-j] f_j, with e the state entering
the block, and across blocks e' = A^B e + v, v the block's zero-state end.

- ``_carry_power_tables``, ``iir_tables`` (its numpy body; the tables come
  back as torch tensors on ``device``) and ``combine_biquads`` are verbatim
  copies.
- The plain versions run JAX's exact solve in plain PyTorch, float64
  throughout: the 5-tap FIR over the carried ``xh``, the mask at K, the one
  ``[B, B+4] @ [B+4, nb*S]`` Toeplitz product (``_iir_core_F2``, with the
  two-level carry through the tables' powers of A^B) and the state after K
  frames (``assoc_core_masked_reference``, ``_iir_y``, ``_assoc_run``).
  JAX's F2 lane layout and its ``sp`` lane padding fill the TPU's 128
  lanes and are not ported: ``sp`` is accepted and ignored.
- The entry points with JAX's names (``assoc_core_masked``,
  ``assoc_core_full`` and their ``_T`` forms on channel-major [S, n] data,
  the ``_cascade2_step*`` and ``_comb4_step*`` wrappers,
  ``biquad_apply_buffer_assoc`` and ``DeviceBiquadCascade``) launch
  ``csrc/biquad.cu`` on a CUDA tensor, one kernel a section, and a
  two-section cascade (``_cascade2_step*``, ``DeviceBiquadCascade``) from
  one host call (see its header for what it computes, what bounds it and
  how it is laid out), or raise; a CPU tensor takes the plain versions.
- The kernel reads its own tables (``kernel_tables``, ``packed_tables``:
  powers of A^32 and of a span's transition A^8192, built by the host once
  a section and kept for later calls); a caller's ``tables`` (iir_tables,
  JAX's or at ``KERNEL_BLOCK``) feed only the plain version.

``refine`` and ``tables32``: JAX's default solve is a mixed-precision
iterative refinement (float32 block solves, float64 residuals), a
workaround for the TPU's emulated float64 matmul.  The port accepts both
keywords and computes the exact float64 solve for every value of them; the
tests hold it against JAX's refined path at JAX's own refined-vs-exact
bound.

``launches`` counts the kernel launches (one a section); ``host_calls``
the calls into the kernel's C entry point (one a cascade); ``plain_calls``
the sections the plain version solved through an entry point (on the
CPU).  Under a profiler ``DeviceBiquadCascade.process`` records one
``art.engine.biquad`` span a call and the kernel's wrapper one
``art.launch.biquad`` span a cascade (``utils/spans.py``).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..utils.spans import BIQUAD, LAUNCH, build, first_launch, span, spanned
from . import _build

launches = {"biquad": 0}
host_calls = {"biquad": 0}
plain_calls = {"biquad": 0}

_IIR_BLOCK = 256
_IIR_SUPER = 64          # carry-recurrence blocks per outer-scan step
# the block of the plain version's tables where no caller gives them
KERNEL_BLOCK = 64

_KINDS = {torch.float32: 0, torch.float64: 1}


# ------------------------------------------------------ the verbatim copies
def _carry_power_tables(AB: np.ndarray, Q: int):
    """Closed-form carry tables from the per-block transition AB = A^B:
    PW [Q,4,4] with PW[d] = AB^d, the masked inner window W [Q,Q,4,4]
    with W[q,j] = AB^(q-1-j) for j < q (else 0), WQ [Q,4,4] with
    WQ[j] = AB^(Q-1-j), and ABQ = AB^Q."""
    PW = np.zeros((Q, 4, 4))
    p = np.eye(4)
    for d in range(Q):
        PW[d] = p
        p = p @ AB
    W = np.zeros((Q, Q, 4, 4))
    for q in range(1, Q):
        W[q, :q] = PW[:q][::-1]
    return PW, W, PW[::-1].copy(), p


def iir_tables(b, B: int = _IIR_BLOCK, Q: int = _IIR_SUPER,
               dtype=np.float64, device="cpu"):
    """Host-precomputed block-IIR tables for feedback taps ``b`` (numpy
    float64): (T [B,B] lower-triangular Toeplitz impulse response,
    G [B,4] boundary rows e0^T A^(t+1), Wv [4,B] / AB [4,4] the carry
    recurrence rows, and the _carry_power_tables bundle), as tensors on
    ``device``.  ``dtype``: table precision -- the tables are always
    built in float64 and rounded once.  They feed the plain version; the
    CUDA kernel builds its own (``kernel_tables``)."""
    b = np.asarray(b, np.float64)
    A = np.zeros((4, 4))
    A[0] = [-b[1], -b[2], -b[3], -b[4]]
    A[1, 0] = A[2, 1] = A[3, 2] = 1.0
    G = np.zeros((B, 4))
    r = A[0].copy()
    for t in range(B):
        G[t] = r
        r = r @ A
    h = np.concatenate([[1.0], G[:B - 1, 0]])
    d = np.arange(B)[:, None] - np.arange(B)[None, :]
    T = np.where(d >= 0, h[np.clip(d, 0, B - 1)], 0.0)
    AB = G[B - 4:][::-1].copy()
    PW, W, WQ, ABQ = _carry_power_tables(AB, Q)
    return tuple(torch.from_numpy(np.ascontiguousarray(t.astype(dtype)))
                 .to(device) for t in
                 (T, G, T[B - 4:][::-1].copy(), AB, PW, W, WQ, ABQ))


def combine_biquads(bq1, bq2):
    """Combine a 2-section biquad cascade into ONE order-4 section.

    The companion-matrix block-IIR kernel is already order-4, so the
    ART -p cascade (reference art.c:847-876, always two biquads) can run
    as a single section with the polynomial products
    a_c = a1 * a2 (feed-forward) and b_c = b1 * b2 (feedback): half the
    FIR and recurrence work.

    Parity class: mathematically identical transfer function; the
    rounded coefficient products and the reassociated order-4 recurrence
    differ from the sequential cascade at the float64 rounding class
    (PARITY.md).  The combined state is (input history, FINAL output
    history); the cascade's internal section-1 output history is not
    represented, so a combined engine cannot hand state back to a host
    Biquad PAIR mid-stream (DeviceBiquadCascade.pull_to raises).
    """
    a1, b1 = np.asarray(bq1.a, np.float64), np.asarray(bq1.b, np.float64)
    a2, b2 = np.asarray(bq2.a, np.float64), np.asarray(bq2.b, np.float64)
    # the product of two order<=2 sections is the order-4 ceiling of the
    # companion kernel; an order-3/4 input section would be silently
    # truncated by the [:3] slices below, so refuse it
    for a, b in ((a1, b1), (a2, b2)):
        if np.any(a[3:] != 0.0) or np.any(b[3:] != 0.0):
            raise ValueError(
                "combine_biquads needs order<=2 sections (their product "
                "is order 4, the block-IIR kernel's ceiling); got an "
                "order-3/4 section — run it as a separate cascade stage")
    ac = np.convolve(a1[:3], a2[:3])
    bc = np.convolve(np.concatenate([[1.0], b1[1:3]]),
                     np.concatenate([[1.0], b2[1:3]]))
    bc[0] = 0.0                                        # b[0] unused
    return ac, bc


# ------------------------------------------------------- the plain versions
def _f64(t, device):
    """``t`` (a tensor, numpy array or sequence) as float64 on ``device``."""
    if not isinstance(t, torch.Tensor):
        t = np.ascontiguousarray(t, np.float64)
    return torch.as_tensor(t, dtype=torch.float64, device=device)


def _tables_for(b, tables, device):
    """``tables`` on ``device``, or iir_tables(b) at KERNEL_BLOCK built
    there (the plain version's tables)."""
    if tables is None:
        bn = b.cpu().numpy() if isinstance(b, torch.Tensor) else b
        return iir_tables(bn, B=KERNEL_BLOCK, device=device)
    return tuple(_f64(t, device) for t in tables)


def _iir_core_F2(F2, yh, tables, nb: int, Sp: int):
    """The block-IIR solve on the forcing F2 [B, nb*Sp] float64 (row =
    time in its block, column = block*stream): per block the one product
    [T | G] @ [F2; e], e the state entering each block from the two-level
    carry e_{bQ+q} = AB^q E_b + sum_{j<q} AB^(q-1-j) v_{bQ+j}, E_{b+1} =
    AB^Q E_b + u_b.  yh [4, Sp] newest first.  Returns Y2 [B, nb*Sp]."""
    T, G, Wv, AB, PW, W, WQ, ABQ = tables
    v = (Wv @ F2).reshape(4, nb, Sp).permute(1, 0, 2)          # [nb, 4, Sp]
    Q = W.shape[0]
    nsb = -(-nb // Q)
    if nsb * Q != nb:
        v = torch.cat([v, v.new_zeros((nsb * Q - nb, 4, Sp))])
    vsb = v.reshape(nsb, Q, 4, Sp)
    inner = torch.einsum("qjab,kjbs->kqas", W, vsb)
    u = torch.einsum("jab,kjbs->kas", WQ, vsb)
    E, e = [], yh
    for k in range(nsb):
        E.append(e)
        e = ABQ @ e + u[k]
    sks = (torch.einsum("qab,kbs->kqas", PW, torch.stack(E))
           + inner).reshape(nsb * Q, 4, Sp)[:nb]               # [nb, 4, Sp]
    S2 = sks.permute(1, 0, 2).reshape(4, nb * Sp)
    return torch.cat([T, G], dim=1) @ torch.cat([F2, S2], dim=0)


def _iir_y(f, b, yh, tables=None, sp=None):
    """Solve y_t = f_t - sum_j b[j] y_{t-j} block-parallel, exactly, in
    float64: f [n, S] (the forcing, masked as needed), yh [4, S] newest
    first.  Returns y [n, S].  Each stream is solved on its own, so that
    its result is bitwise independent of S whatever shapes the matrix
    products pick their summation order by."""
    del sp
    n, S = f.shape
    if n == 0:
        return f.clone()
    tables = _tables_for(b, tables, f.device)
    B = tables[0].shape[0]
    nb = -(-n // B)
    fp = torch.cat([f, f.new_zeros((nb * B - n, S))])
    cols = [_iir_core_F2(fp[:, s].reshape(nb, B).T, yh[:, s:s + 1], tables,
                         nb, 1).T.reshape(nb * B) for s in range(S)]
    return torch.stack(cols, dim=1)[:n]


def _fir(xm, a, xh):
    """f_t = sum_i a[i] x_{t-i} over xm [n, S] with the history xh [4, S]
    (newest first) before it."""
    xpad = torch.cat([xh.flip(0), xm])
    return (a[0] * xpad[4:] + a[1] * xpad[3:-1] + a[2] * xpad[2:-2]
            + a[3] * xpad[1:-3] + a[4] * xpad[:-4])


def assoc_core_masked_reference(x, a, b, xh, yh, K: int, tables=None):
    """The plain masked section: x [n, S] (rows at and past K never
    read), a/b [5], xh/yh [4, S] newest first.  Returns (y [n, S] in x's
    type, zero at and past K, and the float64 xh'/yh' after K frames)."""
    n, S = x.shape
    dev = x.device
    a, b, xh, yh = (_f64(t, dev) for t in (a, b, xh, yh))
    active = (torch.arange(n, device=dev) < K)[:, None]
    xm = torch.where(active, x, torch.zeros((), dtype=x.dtype,
                                            device=dev)).double()
    f = torch.where(active, _fir(xm, a, xh), 0.0)
    y = torch.where(active, _iir_y(f, b, yh, tables), 0.0)
    jx = torch.cat([xh.flip(0), xm])                   # oldest .. newest
    jy = torch.cat([yh.flip(0), y])
    return y.to(x.dtype), jx[K:K + 4].flip(0), jy[K:K + 4].flip(0)


def _assoc_run(x, a, b, xh, yh):
    """The unmasked section of biquad_apply_buffer_assoc, in x's type."""
    dev = x.device
    a, b, xh, yh = (_f64(t, dev) for t in (a, b, xh, yh))
    f = _fir(x.double(), a, xh)
    return _iir_y(f, b, yh).to(x.dtype)


# ----------------------------------------------------- the kernel's tables
# csrc/biquad_geometry.h's span and table layout (tests/test_torch_biquad.py
# holds this copy to the header through library_geometry)
SPAN_THREADS, SPAN_FRAMES, WINDOW = 256, 32, 16
SPAN = SPAN_THREADS * SPAN_FRAMES
REC_WORDS = 16
_TAB_WINDOW, _TAB_CARRY, _TAB_FREE, _TAB_M = 10, 11, 12, 16
_TAB_MW = _TAB_M + 16 * 32
_TAB_P = _TAB_MW + 16 * (SPAN_THREADS // 32)
TAB_DOUBLES = _TAB_P + 16 * (WINDOW + 1)


def _companion(b) -> np.ndarray:
    b = np.asarray(b, np.float64)
    A = np.zeros((4, 4))
    A[0] = [-b[1], -b[2], -b[3], -b[4]]
    A[1, 0] = A[2, 1] = A[3, 2] = 1.0
    return A


def _powers(M: np.ndarray, count: int) -> np.ndarray:
    """[count, 4, 4]: M^0 .. M^(count-1) by repeated products."""
    out = np.empty((count, 4, 4))
    p = np.eye(4)
    for d in range(count):
        out[d] = p
        p = p @ M
    return out


def kernel_tables(b, threads: int = SPAN_THREADS,
                  frames: int = SPAN_FRAMES, window: int = WINDOW) -> dict:
    """The kernel's own tables for feedback taps ``b`` at a span of
    ``threads`` x ``frames`` frames, float64 numpy: with A the companion
    matrix, M = A^frames and P = M^threads (a span's transition), "M":
    M^d for d < 32 (a warp's lanes), "Mw": M^(32 w) for w < threads / 32
    (the warps), "P": P^d for d <= window; "window": the least d <=
    ``window`` with P^d exactly zero, else ``window``; "carry": whether
    P^window is not zero (only then does a span's entering state reach
    past the window); "free": the least w >= 1 with M^(32 w) exactly zero,
    else threads / 32 (warps from it on start from their scan state alone,
    without E).  Built once a section, by the host."""
    M = np.linalg.matrix_power(_companion(b), frames)
    Mp = _powers(M, 32)
    M32 = Mp[31] @ M
    Mw = _powers(M32, threads // 32)
    Pp = _powers(Mw[-1] @ M32, window + 1)
    zero = [d for d in range(1, window + 1) if not Pp[d].any()]
    free = [w for w in range(1, threads // 32) if not Mw[w].any()]
    return {"M": Mp, "Mw": Mw, "P": Pp,
            "window": zero[0] if zero else window, "carry": not zero,
            "free": free[0] if free else threads // 32}


def packed_tables(a, b) -> np.ndarray:
    """kernel_tables at the kernel's geometry in csrc/biquad_geometry.h's
    layout: [TAB_DOUBLES] float64, a|b first."""
    t = kernel_tables(b)
    out = np.zeros(TAB_DOUBLES)
    out[:5] = np.asarray(a, np.float64).reshape(5)
    out[5:10] = np.asarray(b, np.float64).reshape(5)
    out[_TAB_WINDOW] = t["window"]
    out[_TAB_CARRY] = float(t["carry"])
    out[_TAB_FREE] = t["free"]
    for off, m in ((_TAB_M, t["M"]), (_TAB_MW, t["Mw"]), (_TAB_P, t["P"])):
        out[off:off + m.size] = m.reshape(-1)
    return out


_ktab_cache: dict = {}


def _kernel_tab(a: np.ndarray, b: np.ndarray, dev) -> torch.Tensor:
    """packed_tables(a, b) on ``dev``, kept for later calls with the same
    coefficients."""
    key = (a.tobytes(), b.tobytes(), str(dev))
    tab = _ktab_cache.get(key)
    if tab is None:
        if len(_ktab_cache) >= 64:
            _ktab_cache.clear()
        tab = torch.from_numpy(packed_tables(a, b)).to(dev)
        _ktab_cache[key] = tab
    return tab


def library_geometry(n: int, S: int, K: int, dtype) -> dict:
    """The kernel's constants and its launch for one section over n frames
    of S streams of ``dtype``, K valid, from csrc/biquad_geometry.h (the
    code the launch runs, built for the host, no card needed):
    {"constants": {threads, frames, span, window, pad, min_blocks,
    tab_doubles, tab_ab, tab_window, tab_carry, tab_free, tab_m, tab_mw,
    tab_p, rec_words, rec_u, rec_e}, "launch":
    {spans, active, ctas, smem, scratch}}."""
    lib = _build.geometry_library()
    co = (ctypes.c_longlong * 17)()
    go = (ctypes.c_longlong * 5)()
    lib.art_biquad_constants(co)
    if lib.art_biquad_geometry(n, S, K, _KINDS[dtype], go):
        raise ValueError(f"the biquad kernel takes no n={n}, S={S}, K={K}")
    names = ("threads", "frames", "span", "window", "pad", "min_blocks",
             "tab_doubles", "tab_ab", "tab_window", "tab_carry", "tab_free",
             "tab_m", "tab_mw", "tab_p", "rec_words", "rec_u", "rec_e")
    return {"constants": dict(zip(names, co)),
            "launch": dict(zip(("spans", "active", "ctas", "smem",
                                "scratch"), go))}


def _scratch_words(n: int, S: int) -> int:
    """biquad_geometry's scratch words for n frames of S streams."""
    return (1 + max(1, -(-n // SPAN)) * S) * REC_WORDS


# ------------------------------------------------------------ entry points
class _Section(NamedTuple):
    """One section: a, b [5] (numpy float64), the plain version's
    iir_tables on its device (a caller's, else built at KERNEL_BLOCK; None
    on a card when the caller gave none) and, on a card, the kernel's
    packed_tables ``ktab``."""
    a: np.ndarray
    b: np.ndarray
    tables: tuple | None
    ktab: torch.Tensor | None


def _np64(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu().numpy()
    return np.asarray(t, np.float64).reshape(5)


def _prepare(a, b, tables, dev) -> _Section:
    dev = torch.device(dev)
    a, b = _np64(a), _np64(b)
    cuda = dev.type == "cuda"
    if tables is not None or not cuda:
        tables = _tables_for(b, tables, dev)
    return _Section(a, b, tables, _kernel_tab(a, b, dev) if cuda else None)


_scratch: dict = {}     # (device, stream) -> int64 scratch, zero at first
_epoch = [0]            # the launches' epochs: one number each, ever


def _scratch_for(dev, stream: int, words: int) -> torch.Tensor:
    """The scratch of ``stream``'s calls, at least ``words`` long: zeroed
    when allocated (or grown), then kept; every value the kernel publishes
    in it carries its launch's epoch, which no later launch takes, so it
    is never cleared again.  Each stream has its own."""
    key = (dev.index, stream)
    buf = _scratch.get(key)
    if buf is None or buf.numel() < words:
        buf = torch.zeros(max(words, 2 * (0 if buf is None else buf.numel())),
                          dtype=torch.int64, device=dev)
        _scratch[key] = buf
    return buf


def _pack(states, dev) -> torch.Tensor:
    """States (xh1, yh1[, xh2, yh2]), each [4, S], as one contiguous
    float64 tensor [len, 4, S] on ``dev``."""
    return torch.stack([_f64(t, dev) for t in states])


def _run(x_ns, secs, hist, K: int, out_sn: bool):
    """Sections ``secs`` (one or two) in cascade over x_ns [n, S] (any
    strides), from the packed states ``hist`` [2 * len(secs), 4, S] float64
    (xh, yh of each section, newest first; see _pack): (y, the packed
    states after K frames), y [S, n] when ``out_sn`` else [n, S], in x's
    type.  On a card one host call and one launch a section; on the CPU the
    plain version, a section at a time."""
    n, S = x_ns.shape
    dev = x_ns.device
    ns = len(secs)
    if x_ns.dtype not in _KINDS:
        raise ValueError(f"the biquad section takes float32 or float64 "
                         f"data, got {x_ns.dtype}")
    if not 0 <= K <= n:
        raise ValueError(f"K={K} outside [0, {n}]")
    if tuple(hist.shape) != (2 * ns, 4, S) or hist.dtype != torch.float64:
        raise ValueError(f"xh, yh: {ns} pairs of float64 [4, {S}] expected, "
                         f"got {hist.dtype} {tuple(hist.shape)}")
    if dev.type == "cpu":
        y, out = x_ns, []
        for i, sec in enumerate(secs):
            plain_calls["biquad"] += 1
            y, xh_n, yh_n = assoc_core_masked_reference(
                y, sec.a, sec.b, hist[2 * i], hist[2 * i + 1], K, sec.tables)
            out += [xh_n, yh_n]
        return (y.T.contiguous() if out_sn else y), torch.stack(out)
    with span(LAUNCH + "biquad"):
        if dev.type != "cuda":
            raise ValueError(f"the biquad section runs on CPU or CUDA "
                             f"tensors, got {dev}")
        hist = hist.to(dev).contiguous()
        new = torch.empty((2 * ns, 4, S), dtype=torch.float64, device=dev)
        y = torch.empty((S, n) if out_sn else (n, S), dtype=x_ns.dtype,
                        device=dev)
        ysi, ysc = (1, n) if out_sn else (S, 1)     # y as [n, S]
        mid, msi, msc = y, ysi, ysc
        if ns == 2:     # section 1's output, [S, n] in rows padded to 16 B
            ld = -(-n // 4) * 4
            mid, msi, msc = torch.empty((S, ld), dtype=x_ns.dtype,
                                        device=dev), 1, ld
        row = 4 * S * 8                         # bytes of one [4, S] state
        ptrs = []
        for i in range(2):
            if i < ns:
                h = hist.data_ptr() + 2 * i * row
                w = new.data_ptr() + 2 * i * row
                ptrs += [secs[i].ktab.data_ptr(), h, h + row, w, w + row]
            else:
                ptrs += [None] * 5
        lib = _build.library()
        cur = torch.cuda.current_device()
        idx = cur if dev.index is None else dev.index
        with contextlib.nullcontext() if idx == cur else \
                torch.cuda.device(idx):
            # the current stream's handle, without the Stream object that
            # torch.cuda.current_stream builds (a call's largest host cost)
            stream = torch._C._cuda_getCurrentRawStream(idx)
            scratch = _scratch_for(dev, stream, _scratch_words(n, S))
            epoch = _epoch[0] + 1
            _epoch[0] += ns
            with first_launch(("biquad", x_ns.dtype)):
                rc = lib.art_biquad_cascade(
                    ns, x_ns.data_ptr(), n, S, x_ns.stride(0),
                    x_ns.stride(1), _KINDS[x_ns.dtype], int(K), *ptrs,
                    mid.data_ptr(), msi, msc, y.data_ptr(), ysi, ysc,
                    scratch.data_ptr(), epoch, stream)
        host_calls["biquad"] += 1
        if rc != 0:
            raise RuntimeError(f"art_biquad_cascade launch failed: "
                               f"cudaError {rc} (sections={ns}, n={n}, "
                               f"S={S}, {x_ns.dtype})")
        launches["biquad"] += ns
        return y, new


def _solve(x_ns, sec: _Section, xh, yh, K: int, out_sn: bool):
    """One section over x_ns [n, S] (any strides): (y, xh', yh'), y [S, n]
    when ``out_sn`` else [n, S]."""
    y, new = _run(x_ns, (sec,), _pack((xh, yh), x_ns.device), K, out_sn)
    return y, new[0], new[1]


def _section(x_ns, a, b, xh, yh, K: int, tables, out_sn: bool):
    return _solve(x_ns, _prepare(a, b, tables, x_ns.device), xh, yh, K,
                  out_sn)


def assoc_core_masked(x, a, b, xh, yh, K, tables=None, sp=None,
                      tables32=None):
    """Masked block-IIR section for the fused device pipeline.

    x [n, S] (rows at k >= K ignored); a/b [5]; xh/yh [4, S] newest-first;
    ``tables`` optional iir_tables(b), which feed the plain version only
    (the kernel reads its own, built once from b: kernel_tables).  Forcing
    beyond K is zeroed, so y below K is exact and the state extraction at
    K advances the filter by exactly K samples on ragged chunks.  Runs in float64 internally; returns (y [n, S] in
    x.dtype, zeroed beyond K, and the newest-first float64 xh'/yh' after
    K samples).  ``sp`` and ``tables32`` change nothing (module
    docstring)."""
    del sp, tables32
    return _section(x, a, b, xh, yh, int(K), tables, out_sn=False)


def assoc_core_full(x, a, b, xh, yh, tables=None, sp=None, tables32=None):
    """assoc_core_masked for the K == n (whole-chunk-valid) case."""
    del sp, tables32
    return _section(x, a, b, xh, yh, x.shape[0], tables, out_sn=False)


def assoc_core_masked_T(x_sn, a, b, xh, yh, K, tables=None, sp=None,
                        tables32=None):
    """assoc_core_masked on channel-major [S, n] input and output (read
    and written in place by the kernel)."""
    del sp, tables32
    return _section(x_sn.T, a, b, xh, yh, int(K), tables, out_sn=True)


def assoc_core_full_T(x_sn, a, b, xh, yh, tables=None, sp=None,
                      tables32=None):
    """assoc_core_full on channel-major [S, n] input and output."""
    del sp, tables32
    return _section(x_sn.T, a, b, xh, yh, x_sn.shape[1], tables,
                    out_sn=True)


def _cascade2(x_ns, a1, b1, xh1, yh1, a2, b2, xh2, yh2, K: int, t1, t2,
              out_sn: bool):
    dev = x_ns.device
    secs = (_prepare(a1, b1, t1, dev), _prepare(a2, b2, t2, dev))
    y, new = _run(x_ns, secs, _pack((xh1, yh1, xh2, yh2), dev), K, out_sn)
    return (y, *new)


def _cascade2_step(x, a1, b1, xh1, yh1, a2, b2, xh2, yh2, K, t1, t2,
                   sp=None, t1_32=None, t2_32=None):
    """Two cascaded masked sections (the ART CLI's pre/post filter is
    always a 2-section cascade, reference art.c:847-876); section 2 reads
    section 1's output in x's type.  On a card one host call, two
    launches."""
    return _cascade2(x, a1, b1, xh1, yh1, a2, b2, xh2, yh2, int(K), t1, t2,
                     out_sn=False)


def _cascade2_step_full(x, a1, b1, xh1, yh1, a2, b2, xh2, yh2, t1, t2,
                        sp=None, t1_32=None, t2_32=None):
    """_cascade2_step for full-chunk calls (K == n)."""
    return _cascade2_step(x, a1, b1, xh1, yh1, a2, b2, xh2, yh2,
                          x.shape[0], t1, t2)


def _comb4_step(x, a, b, xh, yh, K, t, sp=None, t32=None):
    """One combined order-4 section, masked (see combine_biquads)."""
    return assoc_core_masked(x, a, b, xh, yh, K, t)


def _comb4_step_full(x, a, b, xh, yh, t, sp=None, t32=None):
    """One combined order-4 section, full-chunk."""
    return assoc_core_full(x, a, b, xh, yh, t)


def _cascade2_step_T(x_sn, a1, b1, xh1, yh1, a2, b2, xh2, yh2, K, t1,
                     t2, sp=None, t1_32=None, t2_32=None):
    """_cascade2_step on channel-major [S, n] data."""
    return _cascade2(x_sn.T, a1, b1, xh1, yh1, a2, b2, xh2, yh2, int(K), t1,
                     t2, out_sn=True)


def _comb4_step_T(x_sn, a, b, xh, yh, K, t, sp=None, t32=None):
    """One combined order-4 section, masked, channel-major [S, n]."""
    return assoc_core_masked_T(x_sn, a, b, xh, yh, K, t)


def _cascade2_step_full_T(x_sn, a1, b1, xh1, yh1, a2, b2, xh2, yh2, t1,
                          t2, sp=None, t1_32=None, t2_32=None):
    """_cascade2_step_full on channel-major [S, n] data."""
    return _cascade2_step_T(x_sn, a1, b1, xh1, yh1, a2, b2, xh2, yh2,
                            x_sn.shape[1], t1, t2)


def _comb4_step_full_T(x_sn, a, b, xh, yh, t, sp=None, t32=None):
    """One combined order-4 section, full-chunk, channel-major [S, n]."""
    return assoc_core_full_T(x_sn, a, b, xh, yh, t)


def biquad_apply_buffer_assoc(biquad, buffer, device="cuda"):
    """Filter [n] or [n, channels] through a Biquad state (engines.biquad)
    on ``device``.  Mutates the biquad history like apply_buffer and
    returns the filtered numpy buffer in its type."""
    buf = np.asarray(buffer)
    squeeze = buf.ndim == 1
    if squeeze:
        buf = buf[:, None]
    x = torch.from_numpy(np.ascontiguousarray(buf)).to(device)
    y, xh, yh = assoc_core_full(x, biquad.a, biquad.b, biquad.xh, biquad.yh)
    biquad.xh = xh.cpu().numpy().astype(biquad.xh.dtype)
    biquad.yh = yh.cpu().numpy().astype(biquad.yh.dtype)
    out = y.cpu().numpy()
    return out[:, 0] if squeeze else out


class DeviceBiquadCascade:
    """Two cascaded biquad sections applied on the card, with the
    streaming filter state carried there and exact state interchange with
    the host ``engines.biquad.Biquad`` pair (the CLI's -p post filter
    between the device resample and decimate stages; reference
    art.c:1052-1058).

    Parity class: the kernel computes in float64 and rounds each output
    once to the data dtype, while the host path rounds every intermediate
    at dtype -- outputs agree at the dtype rounding floor (PARITY.md),
    counts exactly.

    ``combined=True`` runs the cascade as ONE order-4 section (see
    combine_biquads); its state cannot be handed back to a host PAIR
    mid-stream (pull_to raises).  ``refine`` is accepted and changes
    nothing: the port solves exactly (module docstring).  ``device``: the
    torch device the state and tables live on."""

    def __init__(self, bq1, bq2, combined: bool = False,
                 refine: bool = True, device="cuda"):
        del refine
        self.device = torch.device(device)
        self._combined = bool(combined)

        def section(a, b):
            return _prepare(a, b, iir_tables(np.asarray(b, np.float64),
                                             B=KERNEL_BLOCK,
                                             device=self.device),
                            self.device)

        with build("bank"):
            if combined:
                self._sections = (section(*combine_biquads(bq1, bq2)),)
            else:
                self._sections = (section(bq1.a, bq1.b),
                                  section(bq2.a, bq2.b))
        self._state = None          # [xh1, yh1, xh2, yh2] on the device

    def push_from(self, bq1, bq2) -> None:
        """Adopt the host pair's streaming state (the device takes over).
        Combined form: the order-4 state is (cascade input history,
        final output history) = (bq1.xh, bq2.yh)."""
        src = (bq1.xh, bq2.yh) if self._combined else (bq1.xh, bq1.yh,
                                                       bq2.xh, bq2.yh)
        self._state = _pack([np.asarray(v, np.float64) for v in src],
                            self.device)

    def pull_to(self, bq1, bq2) -> None:
        """Hand the streaming state back to the host pair."""
        if self._combined:
            raise NotImplementedError(
                "the combined order-4 form does not carry the cascade's "
                "internal section-1 output history; use "
                "DeviceBiquadCascade(combined=False) where mid-stream "
                "host handoff is needed")
        xh1, yh1, xh2, yh2 = self._state.cpu().numpy()
        bq1.xh = xh1.astype(bq1.xh.dtype)
        bq1.yh = yh1.astype(bq1.yh.dtype)
        bq2.xh = xh2.astype(bq2.xh.dtype)
        bq2.yh = yh2.astype(bq2.yh.dtype)
        self._state = None

    @spanned(BIQUAD)
    def process(self, dev_out, K: int):
        """Filter dev_out [ch, cap] (first K columns valid) through both
        sections (the combined one); returns the filtered [ch, cap] tensor
        (zero past K): on a card one host call, one launch a section."""
        y, self._state = _run(dev_out.T, self._sections, self._state,
                              int(K), out_sn=True)
        return y
