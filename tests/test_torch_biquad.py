"""The port's biquad cascade against JAX's, on the CPU.

``art_tpu_torch/ops/biquad_kernel.py``'s entry points on CPU tensors (the
plain versions) against ``art_tpu/ops/biquad_kernel.py`` on the same
inputs, made with numpy seeds:

- JAX's exact solve (no ``tables32``): every masked, full and channel-major
  form at K across the block edges, within JAX's own masked-vs-tables
  bound (rtol 1e-12, atol 1e-14); the new input history bitwise (it is a
  copy) and the rows past K exactly zero; float32 data within 1e-6 (a
  sample may round to its float32 neighbour);
- JAX's default ``DeviceBiquadCascade`` (the refined solve) streamed over
  ragged chunks, cascade and combined, within JAX's refined-vs-exact bound
  (md / scale < 1e-12, states within 1e-12); the combined form against the
  cascade within JAX's 1e-11;
- the state handoff to the host Biquad pair, the refusals, and the
  per-stream output bitwise independent of the batch width."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from art_tpu.engines.biquad import Biquad as JBiquad
from art_tpu.ops import biquad_kernel as jbk
from art_tpu_torch.engines.biquad import (Biquad, apply_cascade,
                                          biquad_lowpass)
from art_tpu_torch.ops import biquad_kernel as bk

# the -p post filter of BASELINE config 4 (bench.py:281)
COEFFS = biquad_lowpass(0.45 * 44100 / 48000)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _section(combined, S):
    """(a, b) of one section: the lowpass biquad or the combined order-4
    pair."""
    q = Biquad.init(COEFFS, 1.0, S, np.float64)
    if combined:
        return bk.combine_biquads(q, Biquad.init(COEFFS, 1.0, S, np.float64))
    return np.asarray(q.a, np.float64), np.asarray(q.b, np.float64)


def _inputs(S, n, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((n, S)) * 0.5).astype(dtype)
    xh = rng.standard_normal((4, S)) * 0.1
    yh = rng.standard_normal((4, S)) * 0.1
    return x, xh, yh


def _jax_exact(form, x, a, b, xh, yh, K, tabs):
    """JAX's exact solve: (y [n, S], xh', yh') as numpy."""
    args = (jnp.asarray(a), jnp.asarray(b), jnp.asarray(xh), jnp.asarray(yh))
    if form == "masked":
        out = jbk.assoc_core_masked(jnp.asarray(x), *args, jnp.int32(K),
                                    tabs)
    elif form == "masked_T":
        out = jbk.assoc_core_masked_T(jnp.asarray(x.T), *args, jnp.int32(K),
                                      tabs)
    elif form == "full":
        out = jbk.assoc_core_full(jnp.asarray(x), *args, tabs)
    else:
        out = jbk.assoc_core_full_T(jnp.asarray(x.T), *args, tabs)
    y, xh_n, yh_n = (np.asarray(o) for o in out)
    return (y.T if form.endswith("_T") else y), xh_n, yh_n


def _port(form, x, a, b, xh, yh, K, tabs):
    fn = getattr(bk, f"assoc_core_{form}")
    xt = _t(x.T) if form.endswith("_T") else _t(x)
    if form.startswith("masked"):
        y, xh_n, yh_n = fn(xt, a, b, xh, yh, K, tabs)
    else:
        y, xh_n, yh_n = fn(xt, a, b, xh, yh, tabs)
    y = y.numpy()
    return (y.T if form.endswith("_T") else y), xh_n.numpy(), yh_n.numpy()


N = 1000
KS = [0, 1, 3, 4, 255, 256, 257, N - 1, N]


@pytest.mark.parametrize("form", ["masked", "masked_T"])
@pytest.mark.parametrize("S", [1, 3, 6])
@pytest.mark.parametrize("K", KS)
def test_masked_matches_jax_exact(K, S, form):
    a, b = _section(True, S)
    x, xh, yh = _inputs(S, N, 10 * S + K % 7)
    x[K:] = np.nan                    # never read past K
    want = _jax_exact(form, np.nan_to_num(x), a, b, xh, yh, K,
                      jbk.iir_tables(b))
    got = _port(form, x, a, b, xh, yh, K,
                bk.iir_tables(b, B=bk.KERNEL_BLOCK))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=1e-14)
    assert not np.any(got[0][K:])
    assert got[1].tobytes() == want[1].tobytes()
    np.testing.assert_allclose(got[2], want[2], rtol=1e-12, atol=1e-14)


def _long_double_section(x, a, b, xh, yh):
    """The section's recurrence in extended precision: the truth both
    float64 solves are held to."""
    L = np.longdouble
    a, b = a.astype(L), b.astype(L)
    n = x.shape[0]
    xs = np.concatenate([xh[::-1].astype(L), x.astype(L)])
    ys = np.concatenate([yh[::-1].astype(L), np.zeros(x.shape, L)])
    for t in range(4, n + 4):
        ys[t] = (sum(a[i] * xs[t - i] for i in range(5))
                 - sum(b[j] * ys[t - j] for j in range(1, 5)))
    return ys[4:]


@pytest.mark.parametrize("form", ["full", "full_T"])
@pytest.mark.parametrize("combined", [False, True])
@pytest.mark.parametrize("S", [1, 3, 6])
def test_full_matches_jax_exact(S, combined, form):
    """A whole 4096-frame chunk.  The biquad section at JAX's bound.  The
    combined order-4 section carries a larger float64 error: at this
    length both JAX's solve and the port's sit ~2e-14 from the
    extended-precision recurrence (max |y| ~1.9), so there the two are
    held to each other at JAX's scale-relative refined-vs-exact bound
    (md / scale < 1e-12), and the port is no further from the truth than
    twice JAX's distance."""
    a, b = _section(combined, S)
    x, xh, yh = _inputs(S, 4096, S + 40 * combined)
    want = _jax_exact(form, x, a, b, xh, yh, 4096, jbk.iir_tables(b))
    got = _port(form, x, a, b, xh, yh, 4096, bk.iir_tables(b))
    assert got[1].tobytes() == want[1].tobytes()
    if not combined:
        np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(got[2], want[2], rtol=1e-12, atol=1e-14)
        return
    scale = np.abs(want[0]).max()
    assert np.abs(got[0] - want[0]).max() / scale < 1e-12
    assert np.abs(got[2] - want[2]).max() / scale < 1e-12
    truth = _long_double_section(x, a, b, xh, yh)
    assert (np.abs(got[0] - truth).max()
            <= 2 * np.abs(want[0] - truth).max())


@pytest.mark.parametrize("K", [0, 3, 700, N])
def test_float32_data_matches_jax_exact(K):
    """float32 in and out: one rounding of the float64 output each; the
    float64 solves agree at 1e-15, so a sample may land on the other
    float32 neighbour."""
    S = 3
    a, b = _section(False, S)
    x, xh, yh = _inputs(S, N, 5 + K, np.float32)
    want = _jax_exact("masked_T", x, a, b, xh, yh, K, jbk.iir_tables(b))
    got = _port("masked_T", x, a, b, xh, yh, K,
                bk.iir_tables(b, B=bk.KERNEL_BLOCK))
    assert got[0].dtype == want[0].dtype == np.float32
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    assert got[1].tobytes() == want[1].tobytes()
    np.testing.assert_allclose(got[2], want[2], rtol=1e-12, atol=1e-14)


def test_cascade2_steps_match_jax_exact():
    """The two-section wrappers: section 2 reads section 1's output in
    the data's type, as JAX's does."""
    S, K = 6, 777
    q = Biquad.init(COEFFS, 1.0, S, np.float64)
    a, b = np.asarray(q.a, np.float64), np.asarray(q.b, np.float64)
    x, xh, yh = _inputs(S, N, 3, np.float32)
    jt = jbk.iir_tables(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    jst = [jnp.asarray(v) for v in (xh, yh, xh * 0.5, yh * 0.5)]
    want = jbk._cascade2_step_T(jnp.asarray(x.T), ja, jb, jst[0], jst[1], ja,
                                jb, jst[2], jst[3], jnp.int32(K), jt, jt)
    t = bk.iir_tables(b, B=bk.KERNEL_BLOCK)
    got = bk._cascade2_step_T(_t(x.T), a, b, xh, yh, a, b, xh * 0.5,
                              yh * 0.5, K, t, t)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0,
                               atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)
    got_full = bk._cascade2_step_full_T(_t(x.T), a, b, xh, yh, a, b,
                                        xh * 0.5, yh * 0.5, t, t)
    got_n = bk._cascade2_step_T(_t(x.T), a, b, xh, yh, a, b, xh * 0.5,
                                yh * 0.5, N, t, t)
    for g, w in zip(got_full, got_n):
        assert torch.equal(g, w)


def _pair(S, dtype=np.float64, mod=None):
    cls = mod or Biquad
    return (cls.init(COEFFS, 1.0, S, dtype), cls.init(COEFFS, 1.0, S, dtype))


CHUNKS = ((4096, 4096), (1000, 700), (2048, 2048), (4096, 4096))


@pytest.mark.parametrize("combined", [False, True])
def test_cascade_streamed_matches_jax_refined(combined):
    """JAX's default cascade (refine=True) and the port (exact solve)
    streamed over ragged chunks, JAX's refined-vs-exact bound."""
    S = 6
    jc = jbk.DeviceBiquadCascade(*_pair(S, mod=JBiquad), combined=combined)
    tc = bk.DeviceBiquadCascade(*_pair(S), combined=combined,
                                device="cpu")
    jc.push_from(*_pair(S, mod=JBiquad))
    tc.push_from(*_pair(S))
    rng = np.random.default_rng(13)
    md, scale = 0.0, 0.0
    for n, K in CHUNKS:
        x = rng.standard_normal((S, n)) * 0.5
        ya = np.asarray(jc.process(jnp.asarray(x), K))
        yb = tc.process(_t(x), K).numpy()
        assert not np.any(yb[:, K:])
        md = max(md, float(np.abs(ya - yb)[:, :K].max()))
        scale = max(scale, float(np.abs(ya).max()))
    assert md / scale < 1e-12, (md, scale)
    for sa, sb in zip(jc._state, tc._state):
        np.testing.assert_allclose(sb.numpy(), np.asarray(sa), atol=1e-12)


def test_combined_matches_cascade():
    S = 6
    casc = bk.DeviceBiquadCascade(*_pair(S), device="cpu")
    comb = bk.DeviceBiquadCascade(*_pair(S), combined=True, device="cpu")
    casc.push_from(*_pair(S))
    comb.push_from(*_pair(S))
    rng = np.random.default_rng(7)
    md = 0.0
    for n, K in CHUNKS[:3]:
        x = _t(rng.standard_normal((S, n)) * 0.5)
        md = max(md, float((casc.process(x, K) - comb.process(x, K))[:, :K]
                           .abs().max()))
    assert md < 1e-11, md
    np.testing.assert_allclose(comb._state[0].numpy(),
                               casc._state[0].numpy(), atol=1e-11)
    np.testing.assert_allclose(comb._state[1].numpy(),
                               casc._state[3].numpy(), atol=1e-11)
    with pytest.raises(NotImplementedError, match="combined"):
        comb.pull_to(*_pair(S))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_handoff_to_host_pair_continues_the_stream(dtype):
    """Host blocks, push_from, three blocks on the cascade (one ragged),
    pull_to, host blocks again: the same stream as the host pair alone,
    within the dtype's rounding floor.  The cascade rounds each output
    once and the host every intermediate, so in float32 the mixed stream
    is held to be no further from the float64 host stream than the
    float32 host stream itself is; in float64 within 1e-13."""
    S = 2
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((9000, S)) * 0.5).astype(dtype)
    host = list(_pair(S, dtype))
    want = apply_cascade(host, x)
    mixed = list(_pair(S, dtype))
    dev = bk.DeviceBiquadCascade(*mixed, device="cpu")
    out = [apply_cascade(mixed, x[:1500])]
    dev.push_from(*mixed)
    for lo, hi, cap in ((1500, 4000, 2600), (4000, 5000, 1000),
                        (5000, 7000, 2000)):
        blk = np.zeros((S, cap), dtype)
        blk[:, :hi - lo] = x[lo:hi].T
        y = dev.process(_t(blk), hi - lo)
        assert y.dtype == _t(blk).dtype
        out.append(y[:, :hi - lo].T.numpy())
    dev.pull_to(*mixed)
    out.append(apply_cascade(mixed, x[7000:]))
    got = np.concatenate(out)
    assert got.dtype == want.dtype
    if dtype == np.float64:
        assert np.abs(got - want).max() < 1e-13
        return
    exact = apply_cascade(list(_pair(S)), x.astype(np.float64))
    assert np.abs(got - exact).max() <= np.abs(want - exact).max()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_assoc_run_matches_jax(dtype):
    """The unmasked section in the data's type, JAX's exact solve."""
    a, b = _section(False, 3)
    x, xh, yh = _inputs(3, 700, 6, dtype)
    want = np.asarray(jbk._assoc_run(jnp.asarray(x), jnp.asarray(a),
                                     jnp.asarray(b), jnp.asarray(xh),
                                     jnp.asarray(yh)))
    got = bk._assoc_run(_t(x), a, b, xh, yh).numpy()
    assert got.dtype == want.dtype == dtype
    if dtype == np.float64:
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_biquad_apply_buffer_assoc_matches_jax():
    q = Biquad.init(COEFFS, 1.0, 2)
    jq = JBiquad.init(COEFFS, 1.0, 2)
    x = (np.random.default_rng(4).standard_normal((3000, 2)) * 0.5).astype(
        np.float32)
    for lo, hi in ((0, 1000), (1000, 1002), (1002, 3000)):
        got = bk.biquad_apply_buffer_assoc(q, x[lo:hi], device="cpu")
        want = jbk.biquad_apply_buffer_assoc(jq, x[lo:hi])
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(q.yh, jq.yh, rtol=0, atol=1e-6)
        assert q.xh.tobytes() == jq.xh.tobytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_output_bitwise_independent_of_batch_width(dtype):
    a, b = _section(True, 6)
    x, xh, yh = _inputs(6, N, 2)
    t = bk.iir_tables(b, B=bk.KERNEL_BLOCK)
    xs = _t(x.T).to(dtype)
    y6, xh6, yh6 = bk.assoc_core_masked_T(xs, a, b, xh, yh, 901, t)
    for s in (0, 5):
        y1, xh1, yh1 = bk.assoc_core_masked_T(xs[s:s + 1], a, b,
                                              xh[:, s:s + 1], yh[:, s:s + 1],
                                              901, t)
        assert torch.equal(y1[0], y6[s])
        assert torch.equal(yh1[:, 0], yh6[:, s])
        assert torch.equal(xh1[:, 0], xh6[:, s])


def test_entry_points_count_plain_sections_and_refuse():
    a, b = _section(False, 2)
    x = torch.zeros((100, 2))
    before = bk.plain_calls["biquad"]
    bk._cascade2_step(x, a, b, np.zeros((4, 2)), np.zeros((4, 2)), a, b,
                      np.zeros((4, 2)), np.zeros((4, 2)), 50, None, None)
    assert bk.plain_calls["biquad"] == before + 2
    with pytest.raises(ValueError, match="outside"):
        bk.assoc_core_masked(x, a, b, np.zeros((4, 2)), np.zeros((4, 2)),
                             101)
    with pytest.raises(ValueError, match="float32 or float64"):
        bk.assoc_core_full(x.half(), a, b, np.zeros((4, 2)),
                           np.zeros((4, 2)))


# ------------------------------------------------- the kernel's geometry
def test_geometry_header_matches_the_module():
    """csrc/biquad_geometry.h (built for the host) and the module's copy
    of its layout agree: the span, the window, the table offsets
    packed_tables writes, the scratch records."""
    c = bk.library_geometry(1, 1, 1, torch.float64)["constants"]
    assert (c["threads"], c["frames"], c["span"], c["window"]) == (
        bk.SPAN_THREADS, bk.SPAN_FRAMES, bk.SPAN, bk.WINDOW)
    assert c["pad"] == bk.SPAN_FRAMES + 1
    assert (c["tab_doubles"], c["tab_ab"], c["tab_window"], c["tab_carry"],
            c["tab_free"], c["tab_m"], c["tab_mw"], c["tab_p"]) == (
        bk.TAB_DOUBLES, 0, bk._TAB_WINDOW, bk._TAB_CARRY, bk._TAB_FREE,
        bk._TAB_M, bk._TAB_MW, bk._TAB_P)
    assert c["rec_words"] == bk.REC_WORDS
    assert (c["rec_u"], c["rec_e"]) == (0, 8)
    # min_blocks CTAs an SM fit the H100's 228 KB of shared memory a SM,
    # each with 1 KB reserved and the kernel's 6,160 bytes of static
    # shared memory (ptxas -v, sm_90a)
    smem = bk.library_geometry(1, 1, 1, torch.float64)["launch"]["smem"]
    assert c["min_blocks"] * (smem + 6160 + 1024) <= 233472


# (n, S, K, dtype, spans, active): config 4b's chunk, art -3 -r96k -p's
# steady block, and edge shapes
GEOMETRY_CASES = [
    (524320, 6, 524320, torch.float64, 65, 65),
    (524320, 6, 524320 - 777, torch.float64, 65, 64),
    (35664, 2, 35664, torch.float32, 5, 5),
    (0, 3, 0, torch.float32, 1, 0),
    (1, 1, 1, torch.float64, 1, 1),
    (1, 2, 0, torch.float32, 1, 0),
    (8192, 2, 8192, torch.float64, 1, 1),
    (8193, 2, 8192, torch.float64, 2, 1),
    (8193, 2, 8193, torch.float32, 2, 2),
    ((1 << 22) + 5, 2, (1 << 22) + 2, torch.float64, 513, 513),
]


@pytest.mark.parametrize("n,S,K,dtype,spans,active", GEOMETRY_CASES)
def test_launch_geometry(n, S, K, dtype, spans, active):
    g = bk.library_geometry(n, S, K, dtype)["launch"]
    assert (g["spans"], g["active"]) == (spans, active)
    assert g["ctas"] == spans * S
    # staged in float64 whatever the data's type
    assert g["smem"] == bk.SPAN_THREADS * (bk.SPAN_FRAMES + 1) * 8
    assert g["scratch"] == bk._scratch_words(n, S)


def test_geometry_refuses_what_the_kernel_does_not_take():
    for n, S, K in ((-1, 1, 0), (10, 0, 0), (10, 1, 11), (10, 1, -1)):
        with pytest.raises(ValueError, match="takes no"):
            bk.library_geometry(n, S, K, torch.float32)


def test_packed_tables_layout():
    """packed_tables: a|b, W, the carry flag and the first E-free warp,
    then M^d (M = A^32), M^(32 w) and P^d (P = A^8192), each against
    numpy's matrix_power of the companion matrix (a resonator's: its
    powers are well scaled and P^W does not vanish)."""
    a, b = _resonator(0.995, 0.7)
    t = bk.packed_tables(a, b)
    assert t.shape == (bk.TAB_DOUBLES,)
    assert t[:5].tobytes() == a.tobytes() and t[5:10].tobytes() == b.tobytes()
    assert t[bk._TAB_WINDOW] == bk.WINDOW and t[bk._TAB_CARRY] == 1.0
    assert t[bk._TAB_FREE] == bk.SPAN_THREADS // 32
    A = bk._companion(b)
    mp = np.linalg.matrix_power
    for off, count, step in ((bk._TAB_M, 32, 32), (bk._TAB_MW, 8, 1024),
                             (bk._TAB_P, bk.WINDOW + 1, bk.SPAN)):
        for d in range(count):
            want = mp(A, step * d)
            got = t[off + 16 * d:off + 16 * d + 16].reshape(4, 4)
            np.testing.assert_allclose(got, want, rtol=1e-12,
                                       atol=1e-12 * np.abs(want).max())


@pytest.mark.parametrize("freq,combined,window,carry,free", [
    (0.45 * 44100 / 48000, True, 1, False, 2),
    (0.45 * 44100 / 48000, False, 1, False, 2),
    (44100 * 0.45 / 96000, True, 1, False, 1),
    (44100 * 0.45 / 96000, False, 1, False, 1),
    (1e-3, False, bk.WINDOW, True, 8)])
def test_window_is_where_the_span_transition_vanishes(freq, combined,
                                                      window, carry, free):
    """The -p lowpasses' span transition P = A^8192 is exactly zero in
    float64 (W = 1: no span waits on another's entering state), and so is
    A^(1024 w) from warp ``free`` on (those warps never wait for E); a
    biquad lowpass at 1e-3 of the rate keeps P^W nonzero (W = 16 and the
    carry) and every warp's factor."""
    q = Biquad.init(biquad_lowpass(freq), 1.0, 1, np.float64)
    b = bk.combine_biquads(q, q)[1] if combined else q.b
    t = bk.kernel_tables(b)
    assert (t["window"], t["carry"], t["free"]) == (window, carry, free)


# ------------------------------------- a numpy model of the kernel's arithmetic
def _run_blocks(f, st, b):
    """Each row of f [threads, frames] through the recurrence from its
    state st [threads, 4] (newest first): (outputs, end states)."""
    st = st.copy()
    out = np.empty_like(f)
    for t in range(f.shape[1]):
        y = (f[:, t] - b[1] * st[:, 0] - b[2] * st[:, 1] - b[3] * st[:, 2]
             - b[4] * st[:, 3])
        st = np.column_stack([y, st[:, :3]])
        out[:, t] = y
    return out, st


def _hillis_steele(z, powers, width):
    """Inclusive scans of z [groups, width, 4]: z_l = sum_{k<=l}
    M^(l-k) z_k, with powers[d] = M^d, in log2(width) steps."""
    d = 1
    while d < width:
        nz = z.copy()
        nz[:, d:] += np.einsum("ab,glb->gla", powers[d], z[:, :-d])
        z, d = nz, 2 * d
    return z


def span_model(x, a, b, xh, yh, K, threads, frames, window):
    """csrc/biquad.cu's arithmetic in numpy, at a span of threads x frames
    and a look-back window: per span the threads' zero-state runs, the
    warps' and the warps' totals' scans, the span's u_j, the windowed
    E_j formula, each warp's entering state (C_w alone from the first
    warp whose M^(32w) is exactly zero) and each thread's, and its rerun.
    Returns (y
    [n, S] in x's type, xh', yh')."""
    t = bk.kernel_tables(b, threads, frames, window)
    M, Mw, P, W, carry = t["M"], t["Mw"], t["P"], t["window"], t["carry"]
    n, S = x.shape
    span, warps = threads * frames, threads // 32
    nsp = max(1, -(-n // span))
    live = np.arange(nsp * span) < K
    xm = np.zeros((nsp * span, S))
    xm[:K] = x[:K]
    xs = np.concatenate([xh[::-1], xm])
    f = sum(a[i] * xs[4 - i:4 - i + nsp * span] for i in range(5))
    f = np.where(live[:, None], f, 0.0)
    y = np.zeros((nsp * span, S))
    lane = np.arange(threads) % 32
    for s in range(S):
        u, E = {}, {}
        for j in range(-(-K // span)):
            fb = f[j * span:(j + 1) * span, s].reshape(threads, frames)
            _, v = _run_blocks(fb, np.zeros((threads, 4)), b)
            z = _hillis_steele(v.reshape(warps, 32, 4), M, 32)
            xw = np.concatenate([np.zeros((warps, 1, 4)), z[:, :-1]], 1)
            c = _hillis_steele(z[None, :, 31], Mw, warps)[0]
            u[j] = c[-1]
            cw = np.concatenate([np.zeros((1, 4)), c[:-1]])
            Ej = sum((P[i] @ u[j - 1 - i] for i in range(min(W, j))),
                     np.zeros(4))
            if j < W:
                Ej = Ej + P[j] @ yh[:, s]
            elif carry:
                Ej = Ej + P[W] @ E[j - W]
            E[j] = Ej
            D = cw + np.einsum("wab,b->wa", Mw, Ej)
            D[t["free"]:] = cw[t["free"]:]      # M^(32w) exactly zero
            e = (np.einsum("tab,tb->ta", M[lane], D[np.arange(threads) // 32])
                 + xw.reshape(threads, 4))
            out, _ = _run_blocks(fb, e, b)
            y[j * span:(j + 1) * span, s] = out.reshape(-1)
    y = np.where(live[:, None], y, 0.0)[:n]
    ys = np.concatenate([yh[::-1], y])
    return (y.astype(x.dtype), xs[K:K + 4][::-1].copy(),
            ys[K:K + 4][::-1].copy())


def _resonator(r, theta):
    """A unit-gain two-pole resonator at radius r and angle theta: poles
    near the unit circle away from DC, so the companion matrix's powers
    stay well scaled while a span's transition does not vanish."""
    b = np.array([0.0, -2 * r * np.cos(theta), r * r, 0.0, 0.0])
    return np.array([1 - r, 0.0, 0.0, 0.0, 0.0]), b


MODEL_N = 1500
MODEL_KS = [0, 1, 3, 4, 5, 252, 253, 255, 256, 257, 258, 259, 260, 511,
            512, 513, 1000, MODEL_N - 1, MODEL_N]


def _model_case(filt, S, n, K, seed, dtype=np.float64):
    if filt == "resonator":
        a, b = _resonator(0.995, 0.7)
    else:
        a, b = _section(filt == "combined", S)
    x, xh, yh = _inputs(S, n, seed, dtype)
    x[K:] = np.nan                    # never read past K
    return a, b, x, xh, yh


def _model_vs_reference(a, b, x, xh, yh, K, geometry):
    got = span_model(x, a, b, xh, yh, K, *geometry)
    want = [o.numpy() for o in bk.assoc_core_masked_reference(
        _t(x), a, b, xh, yh, K, bk.iir_tables(b, B=bk.KERNEL_BLOCK))]
    scale = max(np.abs(want[0]).max(initial=0), np.abs(want[2]).max(),
                1e-300)
    assert got[0].dtype == want[0].dtype and got[0].shape == want[0].shape
    assert (np.abs(got[0].astype(np.float64) - want[0]).max(initial=0)
            <= 1e-12 * scale)
    assert not np.any(got[0][K:])
    assert got[1].tobytes() == want[1].tobytes()
    assert np.abs(got[2] - want[2]).max() <= 1e-12 * scale


@pytest.mark.parametrize("K", MODEL_KS)
@pytest.mark.parametrize("filt", ["biquad", "combined", "resonator"])
def test_span_model_matches_plain(filt, K):
    """Spans of 64 x 4 = 256 frames, W = 4: six spans a stream, so the
    look-back reaches past its window (P^W is not zero at this span for
    any of the three sections) and hops; K at and around span edges and
    inside a span's first four frames."""
    a, b, x, xh, yh = _model_case(filt, 2, MODEL_N, K, K + 3)
    assert bk.kernel_tables(b, 64, 4, 4)["carry"]
    _model_vs_reference(a, b, x, xh, yh, K, (64, 4, 4))


@pytest.mark.parametrize("n,K", [(600, 600), (600, 257), (100, 97),
                                 (3, 3), (0, 0)])
def test_span_model_window_covers_every_span(n, K):
    """Fewer spans than the window (W >= spans): every entering state is
    P^j yh plus the aggregates before it."""
    a, b, x, xh, yh = _model_case("resonator", 3, n, K, n + K)
    _model_vs_reference(a, b, x, xh, yh, K, (64, 4, 4))


@pytest.mark.parametrize("filt", ["biquad", "combined"])
@pytest.mark.parametrize("K", [0, 4, 2047, 2048, 2049, 2052, 5000, 6000])
def test_span_model_vanishing_transition(filt, K):
    """Spans of 64 x 32 = 2048 frames: the -p lowpass's span transition is
    exactly zero (W = 1, no carry), so E_j is u_{j-1} alone."""
    a, b, x, xh, yh = _model_case(filt, 2, 6000, K, K)
    t = bk.kernel_tables(b, 64, 32, 4)
    assert (t["window"], t["carry"]) == (1, False)
    _model_vs_reference(a, b, x, xh, yh, K, (64, 32, 4))


def test_span_model_float32_rounds_once():
    """float32 data: the model's float64 outputs rounded once, within one
    float32 ulp of the plain version's."""
    a, b, x, xh, yh = _model_case("biquad", 2, MODEL_N, 1400, 9, np.float32)
    got = span_model(x, a, b, xh, yh, 1400, 64, 4, 4)[0]
    want = bk.assoc_core_masked_reference(_t(x), a, b, xh, yh, 1400)[0]
    want = want.numpy()
    assert got.dtype == want.dtype == np.float32
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    assert np.all(np.abs(got.astype(np.float64) - want) <= ulp)
