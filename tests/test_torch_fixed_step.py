"""K1's plain version (art_tpu_torch.ops.fixed_step) held against the JAX
chunk step: the XLA body (streams._chunk_step / _chunk_step_interp) and the
Pallas kernel fixed_step_pallas in interpret mode, on the same numpy inputs.

Tolerances: samples within 1e-5 abs on std-0.5 noise (the three float32
contractions sum in different orders; their measured spread is 1.3-1.7e-6),
the new history bitwise (it is a copy), the power accumulator within rel
1e-5, and the tail past K exactly zero."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from art_tpu.core.flags import (BLACKMAN_HARRIS, INCLUDE_LOWPASS,
                                SUBSAMPLE_INTERPOLATE)
from art_tpu.ops.fixed_pallas import fixed_step_pallas
from art_tpu.parallel import streams as jstreams
from art_tpu_torch.ops import fixed_step as k1
from art_tpu_torch.parallel import pipeline

IB = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS | INCLUDE_LOWPASS
CONFIGS = {
    "fwd": (44100, 48000, 380, 380),     # main path: M=147, L=160, qn=4
    "inv": (48000, 44100, 380, 380),     # inverse leg: M=160, L=147, qn=4
    "interp": (44100, 48000, 48, 48),    # 48 filters cannot reduce: fracv
}


def _chunk_inputs(config, n, kmode, seed):
    """(hist, x, P, fracv, start, K, nb, kw) for one chunk of n inputs on
    a JAX engine's first plan; kmode 'full', 'mid' (K inside a block) or
    'zero'."""
    src, dst, taps, filters = CONFIGS[config]
    eng = jstreams.DeviceStreamResampler(2, taps, filters, src, dst, 0, IB)
    eng.advance_position(taps // 2)
    K, start, j0, pos0, _ = eng._plan_compute(n)
    if config == "interp":
        P, fracv = (np.asarray(a) for a in eng._interp_matrix(pos0)[:2])
    else:
        P, fracv = np.asarray(eng._matrix(j0)), None
    K = {"full": K, "mid": K - eng.L - eng.L // 3, "zero": 0}[kmode]
    nb = -(-K // eng.L) if K else 1
    rng = np.random.default_rng(seed)
    hist = rng.normal(0, 0.5, (2, eng.num_samples)).astype(np.float32)
    x = rng.normal(0, 0.5, (2, n)).astype(np.float32)
    kw = dict(M=eng.M, L=eng.L, nb=nb, qn=eng.qn, hist_len=eng.num_samples)
    return hist, x, P, fracv, start, K, nb, kw


def _torch_step(hist, x, P, fracv, start, K, kw):
    t = torch.tensor
    h, o, a = k1.fixed_step(t(hist), t(x), t(P), start, K,
                            torch.zeros((), dtype=torch.float32),
                            fracv=None if fracv is None else t(fracv), **kw)
    return h.numpy(), o.numpy(), float(a)


def _jax_steps(hist, x, P, fracv, start, K, kw):
    args = (jnp.asarray(hist), jnp.asarray(x), jnp.asarray(P))
    acc, s, k = jnp.zeros((), jnp.float32), jnp.int32(start), jnp.int32(K)
    if fracv is None:
        xla = jstreams._chunk_step(*args, s, k, acc, **kw)
    else:
        xla = jstreams._chunk_step_interp(*args, jnp.asarray(fracv), s, k,
                                          acc, **kw)
    pallas = fixed_step_pallas(*args, s, k, acc, jb=8, interpret=True,
                               fracv=None if fracv is None
                               else jnp.asarray(fracv), **kw)
    return {name: (np.asarray(h), np.asarray(o), float(a))
            for name, (h, o, a) in (("xla", xla), ("pallas", pallas))}


@pytest.mark.parametrize("kmode", ["full", "mid", "zero"])
@pytest.mark.parametrize("config", list(CONFIGS))
def test_fixed_step_matches_jax(config, kmode):
    hist, x, P, fracv, start, K, nb, kw = _chunk_inputs(config, 4096, kmode,
                                                        seed=11)
    h, o, a = _torch_step(hist, x, P, fracv, start, K, kw)
    assert o.shape == (2, nb * kw["L"])
    assert not o[:, K:].any()
    for name, (hj, oj, aj) in _jax_steps(hist, x, P, fracv, start, K,
                                         kw).items():
        assert oj.shape == o.shape, name
        np.testing.assert_array_equal(h, hj, err_msg=name)
        assert np.abs(o - oj).max() <= 1e-5, name
        assert a == pytest.approx(aj, rel=1e-5, abs=1e-12), name


@pytest.mark.parametrize("n", [1, 1000, 40 * 147])
def test_fixed_step_short_and_long_chunks(n):
    """n_in < hist_len (the new history spans old history and x) and a
    longer chunk, against the XLA body."""
    hist, x, P, fracv, start, K, nb, kw = _chunk_inputs("fwd", n, "full",
                                                        seed=n)
    h, o, a = _torch_step(hist, x, P, fracv, start, K, kw)
    hj, oj, aj = _jax_steps(hist, x, P, fracv, start, K, kw)["xla"]
    np.testing.assert_array_equal(h, hj)
    assert np.abs(o - oj).max() <= 1e-5
    assert a == pytest.approx(aj, rel=1e-5, abs=1e-12)


def test_window_start_out_of_range_raises():
    """jax.lax.dynamic_slice would clamp; the port refuses."""
    hist = torch.zeros((2, 10))
    x = torch.zeros((2, 5))
    with pytest.raises(ValueError, match="window start"):
        pipeline.window_and_hist(x, hist, 16, 4, 10)
    with pytest.raises(ValueError, match="window start"):
        pipeline.window_and_hist(x, hist, -1, 4, 10)


def test_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA launch never runs the plain version in its place."""
    launches = k1.launches
    with pytest.raises(ValueError, match="CUDA"):
        k1.fixed_step_kernel(torch.zeros((2, 700)), torch.zeros((588, 160)),
                             0, 0, M=147, L=160, nb=1, qn=4)
    assert k1.launches == launches


def _poly_inputs(nb_pad, M=147, qn=4, L=160, ch=2, seed=0):
    """K6's inputs as tests/test_pallas.py makes them: data over the first
    nb_pad*M + qn*M samples, then zeros to (nb_pad + 512)*M; dense P."""
    rng = np.random.default_rng(seed)
    win = np.zeros((ch, (nb_pad + 512) * M), np.float32)
    win[:, :nb_pad * M + qn * M] = rng.standard_normal(
        (ch, nb_pad * M + qn * M)).astype(np.float32)
    P = rng.standard_normal((qn * M, L)).astype(np.float32) * 0.05
    return win, P


def test_polyphase_apply_matches_pallas_interpret():
    """K6's plain version against polyphase_apply_pallas in interpret mode
    at tests/test_pallas.py's shapes (atol 2e-5, its bound)."""
    from art_tpu.ops.pallas_kernels import _TB, polyphase_apply_pallas
    M, qn, L = 147, 4, 160
    win, P = _poly_inputs(2 * _TB, M, qn, L)
    ref = np.asarray(polyphase_apply_pallas(jnp.asarray(win), jnp.asarray(P),
                                            M=M, qn=qn, L=L, interpret=True))
    launches = k1.polyphase_launches
    out = k1.polyphase_apply(torch.from_numpy(win), torch.from_numpy(P),
                             M=M, qn=qn, L=L)
    assert k1.polyphase_launches == launches     # the CPU takes the plain
    assert tuple(out.shape) == ref.shape == (2, 2 * _TB, L)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-5)


def test_polyphase_apply_shapes():
    """Any nb_pad >= 1 (Mosaic's multiple of 512 is not carried over); a
    buffer that is not (nb_pad + 512) whole periods, or a P of the wrong
    shape, raises."""
    M, qn, L = 147, 4, 160
    win, P = _poly_inputs(37, M, qn, L, seed=1)
    out = k1.polyphase_apply(torch.from_numpy(win), torch.from_numpy(P),
                             M=M, qn=qn, L=L).numpy()
    want = np.stack([win[:, i * M:i * M + qn * M] @ P for i in range(37)],
                    axis=1)
    assert np.abs(out - want).max() <= 1e-5
    for w, p in ((win[:, :-1], P), (win[:, :512 * M], P), (win, P[:, :-1])):
        with pytest.raises(ValueError, match="polyphase_apply"):
            k1.polyphase_apply(torch.from_numpy(np.ascontiguousarray(w)),
                               torch.from_numpy(np.ascontiguousarray(p)),
                               M=M, qn=qn, L=L)


# The launch each shape of csrc/fixed_step.cu's table takes, as
# kernel_tile reads it from csrc/fixed_step_geometry.h built for the host:
# (M, qn, interpolated, dtype, precise, hull) -> (design, blocks a tile, P
# rows a piece, shared-memory bytes), ``hull`` the rows of the hulls of
# the engine's matrices at that shape (k1.hull_rows: preset -3 at M = 147,
# 160, 640 and 2560, preset -2 at M = 320; 0 where no hull is known, as
# for the interpolated mode, whose launches take none; M = 320 also
# without one, the template).  The resident design holds
# its CTA's whole P (qn * M rows) and a window buffer for each of its two
# warp groups; the hull design P's hull rows and, in each of two buffers,
# each block's hull span of its window; the persistent float64 design a
# 128-block window at an even stride and two pieces of P's hull rows.
LAUNCHES = [
    ((147, 4, False, torch.float32, False, 412),
     ("resident", 128, 588, 230944)),
    ((147, 2, True, torch.float32, False, 0), ("resident", 64, 294, 152800)),
    ((160, 4, False, torch.float32, False, 420),
     ("template", 128, 160, 104912)),
    ((320, 2, False, torch.float32, False, 228), ("hull", 96, 228, 204288)),
    ((320, 2, False, torch.float32, False, 0), ("template", 128, 320, 206672)),
    ((320, 2, True, torch.float32, False, 0), ("template", 64, 320, 165456)),
    ((640, 2, False, torch.float32, False, 520),
     ("template", 32, 640, 166608)),
    ((640, 2, True, torch.float32, False, 0), ("template", 64, 256, 232272)),
    ((2560, 2, False, torch.float32, False, 924),
     ("template", 128, 352, 225856)),
    ((2560, 2, True, torch.float32, False, 0),
     ("template", 128, 288, 221760)),
    ((147, 4, False, torch.float32, True, 412),
     ("template", 128, 147, 114736)),
    ((160, 4, False, torch.float64, False, 420),
     ("persistent_f64", 128, 120, 231248)),
    ((160, 4, False, torch.float64, False, 0),
     ("template", 128, 160, 209760)),
    ((147, 4, False, torch.float64, False, 412),
     ("persistent_f64", 128, 144, 230960)),
    ((147, 4, True, torch.float64, False, 0),
     ("template", 128, 147, 229408)),
    ((320, 2, False, torch.float64, False, 228),
     ("template", 32, 320, 166752)),
    ((160, 4, False, torch.float32, True, 420),
     ("template", 128, 160, 104912)),
]


@pytest.mark.parametrize("shape,launch", LAUNCHES,
                         ids=[f"M{s[0]}-qn{s[1]}{'-interp' if s[2] else ''}-"
                              f"{k1.instance(s[3], s[4])}"
                              f"{'-no-hull' if not (s[2] or s[5]) else ''}"
                              for s, _ in LAUNCHES])
def test_kernel_tile_picks_the_design_of_each_shape(shape, launch):
    M, qn, interp, dtype, precise, hull = shape
    assert k1.kernel_tile(M, qn, interp, dtype=dtype, precise=precise,
                          hull=hull) == launch


def test_kernel_tile_keeps_small_M_and_the_double_sums_on_the_template():
    """The resident design takes float32 summed in float32 from M = 32 up,
    and nothing whose P and window buffers outgrow a block's shared
    memory: qn = 5 at M = 147 does not fit beside two 128-block buffers."""
    assert k1.kernel_tile(32, 8, False)[0] == "resident"
    for M, qn in ((31, 8), (1, 380), (2, 200), (147, 5)):
        assert k1.kernel_tile(M, qn, False)[0] == "template"
    assert k1.kernel_tile(32, 8, False, precise=True)[0] == "template"
    assert k1.kernel_tile(32, 8, False, dtype=torch.float64)[0] == "template"
    with pytest.raises(ValueError, match="M=0, qn=2"):
        k1.kernel_tile(0, 2, False)


@pytest.mark.parametrize("shape", [(320, 2), (200, 2), (256, 3), (160, 4),
                                   (640, 2), (2560, 2), (32, 8), (36, 20)])
def test_hull_geometry_fits_two_buffers(shape):
    """Every launch the hull design takes, at any hull, holds P's hull
    rows (32 floats each) and two buffers of 96 blocks' hull spans at the
    stride hull_stride (a multiple of 4, not of 16) in the 232,448 B of a
    block; it takes only float32 reduced shapes summed in float32, M of at
    least 32 and of 4, hulls of whole 4-row groups, and never a shape the
    resident design takes."""
    M, qn = shape
    resident = k1.kernel_tile(M, qn, False)
    taken = []
    for hull in range(0, qn * M + 8, 4):
        design, bm, pr, smem = k1.kernel_tile(M, qn, False, hull=hull)
        if resident[0] == "resident":
            assert (design, bm, pr, smem) == resident
            continue
        if design != "hull":
            assert (design, bm, pr, smem) == resident
            continue
        taken.append(hull)
        stride = hull if hull % 16 else hull + 4
        assert (bm, pr) == (96, hull) and 0 < hull <= qn * M
        assert smem == 4 * (32 * hull + 2 * 96 * stride) <= 232448
        assert k1.kernel_tile(M, qn, False, hull=hull,
                              precise=True)[0] == "template"
        # float64 takes its own design or the template, at any hull
        f64 = k1.kernel_tile(M, qn, False, hull=hull, dtype=torch.float64)
        assert f64[0] in ("persistent_f64", "template")
        assert f64 == k1.kernel_tile(M, qn, False, hull=4,
                                     dtype=torch.float64)
        assert k1.kernel_tile(M, qn, True, hull=hull)[0] != "hull"
        assert k1.kernel_tile(M, qn, False, hull=hull + 2)[0] == "template"
    if resident[0] == "template" and M % 4 == 0:
        assert taken == list(range(4, min(qn * M, 256) + 1, 4))
    else:
        assert not taken


@pytest.mark.parametrize("shape,launch", [
    ((147, 4, False), ("resident", 128, 588, 230944)),
    ((147, 2, True), ("resident", 64, 294, 152800))])
def test_resident_shapes_keep_their_launch_at_any_hull(shape, launch):
    """The M = 147 shapes keep the resident design's launch exactly, with
    or without hulls kept."""
    M, qn, interp = shape
    for hull in (0, 4, 228, 252, 412, qn * M):
        assert k1.kernel_tile(M, qn, interp, hull=hull) == launch


@pytest.mark.parametrize("shape", [(160, 4), (147, 4), (200, 2), (32, 8),
                                   (36, 20), (204, 4), (205, 4), (320, 2),
                                   (256, 3), (31, 8), (147, 5)])
def test_persistent_f64_geometry_fits_its_buffers(shape):
    """The persistent float64 design, on a P whose hulls are known (any
    hull of 1 to qn*M rows), takes float64 reduced shapes of M >= 32 whose
    128-block window (the 128 + qn - 1 rows a tile reads, at a stride of M
    rounded up to a multiple of 4, +2), two pieces of at least 32 rows of
    32 doubles and four mbarriers fit 232,448 B: each piece the most 4-row groups that
    fit, no more than qn padded slices.  With no hull known,
    interpolated, float32 or summed in float64 from float32, the shape
    keeps its other launch."""
    M, qn = shape
    mp = -(-M // 4) * 4
    stride = mp + 2
    win = (128 + qn - 1) * stride * 8
    pr = min((232448 - win - 32) // (2 * 32 * 8), qn * mp) & ~3
    fits = M >= 32 and win < 232448 and pr >= 32
    template = k1.kernel_tile(M, qn, False, dtype=torch.float64)
    assert template[0] == "template"
    for hull in (1, 4, 228, qn * M):
        got = k1.kernel_tile(M, qn, False, dtype=torch.float64, hull=hull)
        if not fits:
            assert got == template
            continue
        assert stride % 4 == 2 and pr % 4 == 0 and 32 <= pr <= qn * mp
        smem = win + 2 * pr * 32 * 8 + 32
        assert got == ("persistent_f64", 128, pr, smem)
        assert smem <= 232448
    assert k1.kernel_tile(M, qn, False, dtype=torch.float64,
                          hull=qn * M + 1) == template
    assert k1.kernel_tile(M, qn, True, dtype=torch.float64,
                          hull=4)[0] == "template"
    for kw in (dict(), dict(precise=True)):
        assert k1.kernel_tile(M, qn, False, hull=4, **kw)[0] != \
            "persistent_f64"


# The launches K1 makes on the engines' own matrices (k1.launch_tile: with
# P's hulls where the shape may take a design that reads them): config 4's
# float64 5.1 chain (48k->44.1k, M = 160) the persistent float64 design;
# the main path (float32, M = 147) the resident design, the batch cell's
# preset -2 (M = 320) the hull design on its 228 hull rows, float32 at M
# = 160 the template; float32 summed in float64, interpolated float64 and
# float64 at M = 320 (its window outgrows the design) the template.
ENGINE_LAUNCHES = {
    "config4-f64": ((6, 380, 380, 48000, 44100, 0, IB), np.float64, False,
                    ("persistent_f64", 128, 120, 231248)),
    "main-path-f32": ((2, 380, 380, 44100, 48000, 0, IB), np.float32, False,
                      ("resident", 128, 588, 230944)),
    "preset-2-f32": ((2, 156, 320, 96000, 44100, 0, IB), np.float32, False,
                     ("hull", 96, 228, 204288)),
    "48k-44k1-f32": ((2, 380, 380, 48000, 44100, 0, IB), np.float32, False,
                     ("template", 128, 160, 104912)),
    "main-path-precise": ((2, 380, 380, 44100, 48000, 0, IB), np.float32,
                          True, ("template", 128, 147, 114736)),
    "config1-interp-f64": ((1, 48, 48, 44100, 48000, 0,
                            SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS),
                           np.float64, False, ("template", 128, 147, 227040)),
    "preset-2-f64": ((2, 156, 320, 96000, 44100, 0, IB), np.float64, False,
                     ("template", 32, 320, 166752)),
}


@pytest.mark.parametrize("case", list(ENGINE_LAUNCHES))
def test_launch_tile_on_the_engines_matrices(case):
    from art_tpu_torch import DeviceStreamResampler
    ctor, dtype, precise, launch = ENGINE_LAUNCHES[case]
    eng = DeviceStreamResampler(*ctor, dtype=dtype, precise=precise,
                                device="cpu")
    if eng.interp:
        P, fracv = eng._interp_matrix(0.25)[:2]
    else:
        P, fracv = eng._matrix(0), None
    assert P.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
    assert k1.launch_tile(P, M=eng.M, qn=eng.qn, fracv=fracv,
                          precise=precise) == launch
    assert launch[3] <= 232448


def _padded(k, M, Mp):
    return k // M * Mp + k % M


def _synthetic_p(M, qn, L, rows):
    """A float64 P [qn*M, L] of zeros but for (row, phase, value) ``rows``."""
    P = torch.zeros((qn * M, L), dtype=torch.float64)
    for k, l, v in rows:
        P[k, l] = v
    return P


# P's of the persistent float64 design: the engines' own (config 4's 5.1
# chain, art64's 44.1k->48k) and synthetic ones (M = 41, 3 slices, 70
# phases: a group on the first row, an empty group, one on the last row;
# M = 40, no pad rows; M = 37, each group a single row mid-slice; M = 33,
# a group spanning every slice)
PACKED_CASES = {
    "config4": None,
    "art64": None,
    "synthetic": (41, 3, 70, [(0, 3, 1.0), (122, 66, -2.0)]),
    "no-pad-rows": (40, 4, 64, [(5, 1, 0.5), (70, 20, 1.5), (159, 40, -1.0)]),
    "single-rows": (37, 2, 96, [(17, 0, 1.0), (40, 33, 2.0), (73, 95, 3.0)]),
    "every-slice": (33, 4, 32, [(2, 7, 1.0), (131, 30, -1.0)]),
}


@pytest.mark.parametrize("case", list(PACKED_CASES))
def test_packed_rows_hold_each_groups_padded_hull(case):
    """The persistent float64 design's packed P (k1._packed_of): column
    group g's padded rows [a, b) (k1.p64_group_rows) are 4-row groups of
    padded rows (row k = q*M + m at q*Mp + m, Mp = M rounded up to a
    multiple of 4; k1.p64_sources maps them back) that hold the group's
    hull (its halves' union), (0, 0) for a zero group; row j of packed[g]
    is padded row a + j of P over the group's 32 phases, zero on pad
    rows, past b and past L; R the widest group; kept beside P with its
    hulls and packed again once P changes in place."""
    from art_tpu_torch import DeviceStreamResampler
    if PACKED_CASES[case] is not None:
        M, qn, L, nonzero = PACKED_CASES[case]
        P = _synthetic_p(M, qn, L, nonzero)
    else:
        src, dst = (48000, 44100) if case == "config4" else (44100, 48000)
        eng = DeviceStreamResampler(6, 380, 380, src, dst, 0, IB,
                                    dtype=np.float64, device="cpu")
        M, qn, L, P = eng.M, eng.qn, eng.L, eng._matrix(0)
    Mp = -(-M // 4) * 4
    halves = k1._hulls_of(P)[0]
    rows = k1.p64_group_rows(halves, M)
    packed, R = k1._packed_of(P, M)
    assert len(rows) == -(-L // 32)
    assert R == max(b - a for a, b in rows)
    assert packed.shape == (len(rows), R, 32) and packed.is_contiguous()
    for g, ((a, b), hull) in enumerate(zip(rows, k1.column_hulls(P).tolist())):
        if hull[1] <= hull[0]:
            assert (a, b) == (0, 0) and not packed[g].any()
            continue
        assert a % 4 == 0 and b % 4 == 0
        assert a <= _padded(hull[0], M, Mp)
        assert b > _padded(hull[1] - 1, M, Mp)
        want = torch.zeros((R, 32), dtype=P.dtype)
        c1 = min(32 * g + 32, L) - 32 * g
        sources = k1.p64_sources(M, a, b)
        for j, k in enumerate(range(a, b)):
            q, m = divmod(k, Mp)
            assert sources[j] == (q * M + m if m < M else -1)
            if m < M:
                want[j, :c1] = P[q * M + m, 32 * g:32 * g + c1]
        assert torch.equal(packed[g], want)
    assert k1._packed_of(P, M)[0] is packed
    P[hull[0], 32 * g] += 1.0           # in place: packed again
    again = k1._packed_of(P, M)[0]
    assert again is not packed and not torch.equal(again, packed)


@pytest.mark.parametrize("M,qn", [(160, 4), (147, 4), (41, 3), (33, 4)])
def test_padded_rows_hold_every_row_of_p_once(M, qn):
    """The padded rows of qn slices (k1.p64_sources over [0, qn*Mp)) hold
    P's rows 0 .. qn*M - 1 once each, in order, each slice followed by its
    Mp - M pad rows (-1)."""
    Mp = -(-M // 4) * 4
    sources = k1.p64_sources(M, 0, qn * Mp)
    want = []
    for q in range(qn):
        want += list(range(q * M, q * M + M)) + [-1] * (Mp - M)
    assert sources == want
    assert k1.p64_sources(M, Mp - 4, Mp + 4) == want[Mp - 4:Mp + 4]


def _plain_hulls(P, cols=32):
    """Each group of ``cols`` phases' [first, last + 1) nonzero row of P,
    (0, 0) where it has none, by torch."""
    nz = torch.as_tensor(P) != 0
    out = []
    for n0 in range(0, nz.shape[1], cols):
        rows = nz[:, n0:n0 + cols].any(dim=1).nonzero().flatten()
        out.append((int(rows[0]), int(rows[-1]) + 1) if len(rows) else (0, 0))
    return out


@pytest.mark.parametrize("ctor", [
    (2, 156, 320, 96000, 44100, 0, IB),        # preset -2, M = 320
    (2, 380, 380, 44100, 48000, 0, IB),        # preset -3, M = 147
    (1, 48, 48, 44100, 48000, 0, SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS)],
    ids=["preset-2", "preset-3", "config-1"])
def test_column_hulls_equal_the_plain_hulls(ctor):
    """The per-group hulls (k1.column_hulls, of 32-phase groups and of
    their 16-phase halves) equal the plain hulls of P for every anchor j0
    of the reduced engines, and of each bank of config 1's interpolated
    matrices at 40 first positions; hull_rows is the widest rounded out to
    4-row groups; the hulls a launch finds on P (found once, kept beside
    P) are those, and are found again once P changes in place."""
    from art_tpu_torch import DeviceStreamResampler
    eng = DeviceStreamResampler(*ctor, device="cpu")
    if eng.interp:
        mats = [eng._interp_matrix(p / 40)[0] for p in range(40)]
        banks = [b for P in mats for b in (P[:, :eng.L], P[:, eng.L:])]
    else:
        mats = banks = [eng._matrix(j) for j in range(eng.L)]
    for P in banks:
        hulls = k1.column_hulls(P)
        plain = _plain_hulls(P)
        assert [tuple(h) for h in hulls.tolist()] == plain
        halves = k1.column_hulls(P, cols=16)
        assert [tuple(h) for h in halves.tolist()] == _plain_hulls(P, 16)
        rows = max(((hi + 3) & ~3) - (lo & ~3) for lo, hi in plain if hi)
        assert k1.hull_rows(hulls) == rows
        if not eng.interp:
            kept, kept_rows = k1._hulls_of(P)
            assert kept_rows == rows
            assert kept[:len(halves)].tolist() == halves.tolist()
            assert not kept[len(halves):].any()
    if not eng.interp:
        P = mats[0]
        P[-1, 0] = 1.0              # in place: the version counter moves
        assert k1._hulls_of(P)[1] == k1.hull_rows(k1.column_hulls(P)) \
            == eng.qn * eng.M


def test_column_hulls_of_zero_groups_and_edges():
    """A zero group is (0, 0) and no part of hull_rows; hulls on the first
    and last row and across the slice edge."""
    P = torch.zeros((640, 70))
    P[0, 3] = 1.0                   # group 0: row 0 only
    P[639, 40] = -2.0               # group 1: the last row only
    P[317:323, 66] = 0.5            # group 2 (6 phases), across row 320
    assert k1.column_hulls(P).tolist() == [[0, 1], [639, 640], [317, 323]]
    assert k1.hull_rows(k1.column_hulls(P)) == 8
    assert k1.column_hulls(P, cols=16).tolist() == [
        [0, 1], [0, 0], [639, 640], [0, 0], [317, 323]]
    P[:, 32:64] = 0
    assert k1.column_hulls(P).tolist()[1] == [0, 0]
    assert k1.hull_rows(np.zeros((3, 2), np.int32)) == 0


@pytest.mark.parametrize("lead", [0, 1, 2, 3])
def test_group_buf_framing_keeps_every_window(lead):
    """The engine's group buffer framed as k1.window_frame asks for K1's
    hull design (streams._group_buf with (lead, tail) zeros around the
    stream, the width then a multiple of 4): the stream unchanged at
    +lead, zeros around it, the advanced history that of the unframed
    buffer, and every window the plain version reads the same at start +
    lead."""
    from art_tpu_torch.parallel import streams
    rng = np.random.default_rng(lead)
    G, n, H, start = 3, 640, 250, 5 + lead
    hist = torch.from_numpy(rng.normal(0, 1, (2, H)).astype(np.float32))
    xs = torch.from_numpy(rng.normal(0, 1, (2, G * n)).astype(np.float32))
    plain, hist0 = streams._group_buf(hist, xs, G, n, H)
    tail = -(lead + H + G * n) % 4 if lead else 0
    buf, hist1 = streams._group_buf(hist, xs, G, n, H, (lead, tail))
    assert torch.equal(hist0, hist1)
    assert torch.equal(buf[:, lead:lead + plain.shape[1]], plain)
    assert not buf[:, :lead].any() and not buf[:, lead + plain.shape[1]:].any()
    assert buf.shape[1] % 4 == 0 if lead else buf.shape[1] == H + G * n
    for g in range(G):
        for xlen in (n, n + 400):
            assert torch.equal(
                k1.window_at(buf, start + lead + g * n, xlen),
                k1.window_at(plain, start + g * n, xlen))


def test_hull_lead_frames_only_for_the_hull_design():
    """window_frame asks for zeros only for a CUDA P whose launches take
    the hull design: never on the CPU (the plain version), where
    launch_tile still reads the launch a card would make (the hull design
    at the batch shape, the resident design on the main path)."""
    from art_tpu_torch import DeviceStreamResampler
    eng = DeviceStreamResampler(2, 156, 320, 96000, 44100, 0, IB,
                                device="cpu")
    P = eng._matrix(0)
    assert k1.launch_tile(P, M=eng.M, qn=eng.qn) == ("hull", 96, 228,
                                                     204288)
    main = DeviceStreamResampler(2, 380, 380, 44100, 48000, 0, IB,
                                 device="cpu")
    assert k1.launch_tile(main._matrix(0), M=main.M, qn=main.qn)[0] == \
        "resident"
    for start in range(8):
        assert k1.window_frame(P, start, 1001 + start, M=eng.M,
                               qn=eng.qn) == (0, 0)


@pytest.mark.parametrize("G,units,slots", [(5, 7134, 132), (5, 1, 132),
                                           (5, 2, 132), (3, 10, 7),
                                           (80, 3, 132), (200, 4, 132),
                                           (1, 49170, 132), (1, 7, 132)])
def test_resident_grid_covers_every_tile_once(G, units, slots):
    """The resident grid: never more CTAs than the card holds or than
    there are tiles; every (column group, tile) taken by exactly one CTA;
    a group's tiles split in runs that differ by at most one tile."""
    import ctypes

    from art_tpu_torch.ops import _build
    lib = _build.geometry_library()
    out = (ctypes.c_longlong * 5)()
    assert lib.art_fixed_step_grid(G, units, slots, 0, out) == 0
    ctas, per_group = out[0], out[1]
    assert 1 <= ctas <= min(slots, G * units)
    taken = np.zeros((G, units), np.int64)
    runs = []
    for cta in range(ctas):
        assert lib.art_fixed_step_grid(G, units, slots, cta, out) == 0
        first, t0, t1 = out[2], out[3], out[4]
        runs.append(t1 - t0)
        for g in range(first, G, ctas // per_group):
            taken[g, t0:t1] += 1
    assert (taken == 1).all()
    assert max(runs) - min(runs) <= 1
    assert lib.art_fixed_step_grid(G, units, slots, ctas, out) == 1
