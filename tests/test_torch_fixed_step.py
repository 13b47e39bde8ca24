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
# (M, qn, interpolated, dtype, precise) -> (design, blocks a tile, P rows a
# piece, shared-memory bytes).  The resident design holds its CTA's whole
# P (qn * M rows) and a window buffer for each of its two warp groups.
LAUNCHES = [
    ((147, 4, False, torch.float32, False), ("resident", 128, 588, 230944)),
    ((147, 2, True, torch.float32, False), ("resident", 64, 294, 152800)),
    ((160, 4, False, torch.float32, False), ("template", 128, 160, 104912)),
    ((320, 2, False, torch.float32, False), ("template", 128, 320, 206672)),
    ((320, 2, True, torch.float32, False), ("template", 64, 320, 165456)),
    ((640, 2, False, torch.float32, False), ("template", 32, 640, 166608)),
    ((640, 2, True, torch.float32, False), ("template", 64, 256, 232272)),
    ((2560, 2, False, torch.float32, False), ("template", 128, 352, 225856)),
    ((2560, 2, True, torch.float32, False), ("template", 128, 288, 221760)),
    ((147, 4, False, torch.float32, True), ("template", 128, 147, 114736)),
    ((160, 4, False, torch.float64, False), ("template", 128, 160, 209760)),
]


@pytest.mark.parametrize("shape,launch", LAUNCHES,
                         ids=[f"M{s[0]}-qn{s[1]}{'-interp' if s[2] else ''}-"
                              f"{k1.instance(s[3], s[4])}"
                              for s, _ in LAUNCHES])
def test_kernel_tile_picks_the_design_of_each_shape(shape, launch):
    M, qn, interp, dtype, precise = shape
    assert k1.kernel_tile(M, qn, interp, dtype=dtype,
                          precise=precise) == launch


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


@pytest.mark.parametrize("G,units,slots", [(5, 7134, 132), (5, 1, 132),
                                           (5, 2, 132), (3, 10, 7),
                                           (80, 3, 132), (200, 4, 132)])
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
