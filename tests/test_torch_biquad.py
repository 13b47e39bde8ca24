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
