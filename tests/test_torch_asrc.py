"""The port's batched drifting-ratio ASRC (``art_tpu_torch.BatchedASRC`` on
device="cpu", i.e. the ASRC kernels' plain versions) held against the JAX
engine (``art_tpu.parallel.asrc``) on the same numpy inputs, at the JAX
tests' shapes: 8 streams, 48 taps, 64 filters, 512-frame chunks.

- Counts (Ks per stream and call) and ``get_position()`` must be exactly
  equal: both engines run the same float64 host accounting.
- float32 samples within 2e-6: the JAX tests hold each of their legs to
  1e-6 of the per-stream host oracle, so two engines held to it lie within
  twice that.
- float64 samples within 1e-12 of JAX's float64 XLA step (the same float64
  arithmetic summed in another order).
- Positions (window base, phase, fraction) bitwise equal to JAX's.

The JAX legs "hankel", "dense" and "pallas" run their Pallas kernels in
interpret mode, as the JAX package's own tests run them on the CPU."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from art_tpu.core.flags import (BLACKMAN_HARRIS, EXTRAPOLATE_ENDPOINTS,
                                SUBSAMPLE_INTERPOLATE)
from art_tpu.ops.pallas_kernels import asrc_apply_pallas, pad_bank_for_pallas
from art_tpu.parallel import asrc as jasrc
from art_tpu.utils.testsig import NoiseLCG
from art_tpu_torch import ASRCStreamResampler, BatchedASRC
from art_tpu_torch.ops import asrc_step as kasrc

S, TAPS, FILTERS, N = 8, 48, 64, 512
IB = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS
# tests/test_asrc.py test_batched_asrc_kernel_chain_matches_host_oracle
LEGS = [
    1.0 + 0.0005 * np.arange(S),                        # hankel narrow
    1.0 / (1.0 + 0.15 * np.sin(np.arange(S) + 1.0)),    # hankel wide tier
    np.full(S, 0.5) + 0.01 * np.arange(S),              # dense
    np.full(S, 0.2),                                    # xla
    1.0 - 0.0005 * np.arange(S),                        # back to hankel
]


def _pair(jkernel="xla", tkernel="auto", dtype=np.float32, s=S, taps=TAPS,
          filters=FILTERS, **kw):
    j = jasrc.BatchedASRC(s, taps, filters, kernel=jkernel, dtype=dtype,
                          **kw)
    t = BatchedASRC(s, taps, filters, kernel=tkernel, dtype=dtype,
                    device="cpu", **kw)
    return j, t


def _check_call(j_res, t_res, j, t, tol):
    """Exact counts, positions and shapes; returns the max sample diff."""
    (oj, Kj), (ot, Kt) = j_res, t_res
    assert isinstance(Kt, np.ndarray) and np.array_equal(Kj, Kt)
    assert np.array_equal(j.get_position(), t.get_position())
    oj, ot = np.asarray(oj), ot.numpy()
    assert oj.shape == ot.shape and oj.dtype == ot.dtype
    for s in range(ot.shape[0]):
        assert not ot[s, Kt[s]:].any()
    err = float(np.abs(oj - ot).max()) if ot.size else 0.0
    assert err <= tol
    return err


@pytest.mark.parametrize("kernel", ["xla", "hankel", "dense", "pallas"])
def test_engine_matches_jax_on_each_leg(kernel):
    """Every JAX leg against the port, over the kernel-chain ratio legs and
    a final flush."""
    j, t = _pair(jkernel=kernel, tkernel=kernel)
    for e in (j, t):
        e.advance_position(24.0)
    lcg = NoiseLCG()
    for ratios in LEGS:
        x = lcg.fill(S * N).reshape(S, N)
        _check_call(j.process(jnp.asarray(x), ratios),
                    t.process(torch.from_numpy(x), ratios), j, t, 2e-6)
    fr = 1.0 + 0.003 * np.arange(S)
    _check_call(j.flush(fr), t.flush(fr), j, t, 2e-6)
    assert np.array_equal(np.asarray(j.hist), t.hist.numpy())


def test_float64_matches_jax_xla_step():
    j, t = _pair(dtype=np.float64)
    for e in (j, t):
        e.advance_position(24.0)
    lcg = NoiseLCG()
    rng = np.random.default_rng(5)
    for i in range(4):
        x = lcg.fill(S * N).reshape(S, N).astype(np.float64)
        ratios = LEGS[i] if i < 3 else 1.0 + rng.uniform(-0.01, 0.01, S)
        _check_call(j.process(jnp.asarray(x), ratios),
                    t.process(torch.from_numpy(x), ratios), j, t, 1e-12)
    assert t.hist.dtype == torch.float64
    mask = np.zeros(S, bool)
    mask[[1, 4, 6]] = True
    fr = 1.0 + rng.uniform(-0.01, 0.01, S)
    _check_call(j.flush(fr, mask), t.flush(fr, mask), j, t, 1e-12)


def _step_inputs(rng, dtype, s, n, k_max, Ks_mode):
    bank = jasrc.make_filter_bank(TAPS, FILTERS, 1.0, True, dtype)
    H = TAPS * 16
    hist = rng.normal(0, 0.5, (s, H)).astype(dtype)
    x = rng.normal(0, 0.5, (s, n)).astype(dtype)
    # a full ring (input_index = H, so shift = 0): emission 0 sits just
    # below the newest history sample
    offsets = H - TAPS // 2 - 2 + rng.uniform(0, 1, s)
    ratios = rng.choice([0.5, 0.99, 1.0, 1.01, 2.0], s)
    Ks = np.minimum(np.floor((H - TAPS // 2 + n - offsets) * ratios) - 1,
                    k_max).astype(np.int32)
    if Ks_mode == "mid":
        Ks = np.minimum(Ks, 77 + np.arange(s, dtype=np.int32))
    elif Ks_mode == "zero":
        Ks[::2] = 0
    return bank, hist, x, offsets, ratios, Ks, 0


@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-6),
                                       (np.float64, 1e-12)])
@pytest.mark.parametrize("s,Ks_mode", [(8, "full"), (8, "mid"), (8, "zero"),
                                       (3, "full")])
def test_step_reference_matches_jax_step(dtype, tol, s, Ks_mode):
    """asrc_step_reference against JAX's _asrc_step (XLA) on one chunk:
    mid-tile Ks, Ks = 0 rows and S = 3; new history bitwise."""
    rng = np.random.default_rng(11 + s)
    n, k_max = N, 1280
    bank, hist, x, offsets, ratios, Ks, shift = _step_inputs(
        rng, dtype, s, n, k_max, Ks_mode)
    geom = dict(num_taps=TAPS, num_filters=FILTERS, k_max=k_max,
                hist_len=hist.shape[1])
    jh, jo = jasrc._asrc_step(jnp.asarray(hist), jnp.asarray(x),
                              jnp.asarray(bank), jnp.asarray(offsets),
                              jnp.asarray(ratios), jnp.asarray(Ks),
                              jnp.int32(shift), **geom)
    t = torch.from_numpy
    th, to = kasrc.asrc_step(t(hist), t(x), t(bank), t(offsets), t(ratios),
                             t(Ks), shift, **geom)
    assert np.array_equal(np.asarray(jh), th.numpy())
    assert to.shape == (s, k_max) and to.dtype == th.dtype
    assert float(np.abs(np.asarray(jo) - to.numpy()).max()) <= tol
    for r in range(s):
        assert not to[r, Ks[r]:].any()


def test_positions_bitwise_equal_to_jax_prologue():
    rng = np.random.default_rng(3)
    bank, hist, x, offsets, ratios, Ks, shift = _step_inputs(
        rng, np.float32, S, N, 1000, "full")
    k_max, kp, tp = 1000, 1024, 128
    _, jbase, jfi, jfrac, _ = jasrc._pallas_prologue(
        jnp.asarray(hist), jnp.asarray(x), jnp.asarray(offsets),
        jnp.asarray(ratios), jnp.int32(shift), TAPS, FILTERS, k_max, kp,
        hist.shape[1], tp)
    base, fi, frac = kasrc.decompose_positions(
        torch.from_numpy(offsets), torch.from_numpy(ratios), k_max,
        num_taps=TAPS, num_filters=FILTERS, shift=shift,
        dtype=torch.float32)
    jbase, jfi, jfrac = (np.asarray(a)[:, :k_max] for a in (jbase, jfi,
                                                             jfrac))
    assert np.array_equal(jfi, fi.numpy())
    assert np.array_equal(jfrac.view(np.uint32), frac.numpy().view(np.uint32))
    # the valid emissions' windows lie in the buffer, where JAX's clip of
    # the bases is the identity
    valid = np.arange(k_max)[None, :] < Ks[:, None]
    tbase = base.numpy()[valid]
    assert tbase.min() >= 0 and tbase.max() + TAPS <= hist.shape[1] + N
    assert np.array_equal(jbase[valid], tbase)


def test_apply_reference_matches_pallas_interpret():
    """asrc_apply_reference against asrc_apply_pallas (interpret mode) on
    the Pallas kernel's padded geometry."""
    rng = np.random.default_rng(9)
    s, B, K, kb = 8, 1024, 256, 128
    bank = jasrc.make_filter_bank(TAPS, FILTERS, 1.0, True, np.float32)
    bankp = pad_bank_for_pallas(bank)
    buf = rng.normal(0, 0.5, (s, B)).astype(np.float32)
    base = rng.integers(0, B - bankp.shape[1] - 128, (s, K)).astype(np.int32)
    fi = rng.integers(0, FILTERS, (s, K)).astype(np.int32)
    frac = rng.random((s, K)).astype(np.float32)
    jo = asrc_apply_pallas(jnp.asarray(buf), jnp.asarray(bankp),
                           jnp.asarray(base), jnp.asarray(fi),
                           jnp.asarray(frac), kb=kb, interpret=True)
    t = torch.from_numpy
    to = kasrc.asrc_apply(t(buf), t(bank), t(base), t(fi), t(frac))
    assert to.shape == (s, K)
    assert float(np.abs(np.asarray(jo) - to.numpy()).max()) <= 2e-6


def test_kernel_wrappers_refuse_cpu_tensors():
    z = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="CUDA"):
        kasrc.asrc_step_kernel(z, z, z, z[0].double(), z[0].double(),
                               z[0].int(), 0, num_taps=4, num_filters=1,
                               k_max=4)
    with pytest.raises(ValueError, match="CUDA"):
        kasrc.asrc_apply_kernel(z, z, z.int(), z.int(), z)


def test_staggered_flush_matches_jax():
    """tests/test_asrc.py staggered flush, engine against engine: streams
    end at staggered times, flushed streams emit nothing afterwards and
    their positions freeze, live streams keep serving."""
    j, t = _pair()
    for e in (j, t):
        e.advance_position(24.0)
    lcg = NoiseLCG()
    rng = np.random.default_rng(3)
    flush_at = {1: [6, 3], 3: [0, 2], 5: [4, 7], 7: [1, 5]}
    for step in range(8):
        x = lcg.fill(S * N).reshape(S, N)
        ratios = 1.0 + rng.uniform(-0.01, 0.01, S)
        _check_call(j.process(jnp.asarray(x), ratios),
                    t.process(torch.from_numpy(x), ratios), j, t, 2e-6)
        if step in flush_at:
            fmask = np.zeros(S, bool)
            fmask[flush_at[step]] = True
            fr = 1.0 + rng.uniform(-0.01, 0.01, S)
            _check_call(j.flush(fr, fmask), t.flush(fr, fmask), j, t, 2e-6)
    assert np.array_equal(t.flushed, j.flushed) and t.flushed.all()
    _, Ks = t.flush(np.ones(S), np.ones(S, bool))      # double flush: no-op
    assert not Ks.any()


def test_slide_tie_boundary_counts_match_jax():
    """Fuzz seed 5113's float64 tie (tests/test_asrc.py): the second call
    must emit 1395 on every stream, as JAX does."""
    taps, filters, ratio = 88, 67, 48000 / 44100
    j, t = _pair(taps=taps, filters=filters)
    for e in (j, t):
        e.advance_position(taps // 2 + 26.25)
    lcg = NoiseLCG()
    seen = []
    for _ in range(3):
        x = lcg.fill(1281).reshape(1, 1281)
        xs = np.ascontiguousarray(np.broadcast_to(x, (S, 1281)))
        r = np.full(S, ratio)
        res = t.process(torch.from_numpy(xs), r)
        _check_call(j.process(jnp.asarray(xs), r), res, j, t, 2e-6)
        assert (res[1] == res[1][0]).all()
        seen.append(int(res[1][0]))
    assert seen[1] == 1395      # the tie call (1394 = regression)


def test_exactly_full_requested_capacity():
    t = BatchedASRC(4, 48, 48, device="cpu")
    t.advance_position(24)
    x = torch.zeros((4, 500))
    r = np.full(4, 1.0)
    t.process(x, r, k_max=1000)               # prime past startup latency
    _, Ks = t.process(x, r, k_max=1000)
    steady = int(Ks.max())
    assert steady > 0
    out, Ks = t.process(x, r, k_max=steady)   # exactly full: legal
    assert int(Ks.max()) == steady and out.shape[1] == steady
    with pytest.raises(ValueError):
        t.process(x, r, k_max=steady - 1)

    def primed():
        e = BatchedASRC(4, 48, 48, device="cpu")
        e.advance_position(24)
        e.process(x, r)
        return e

    need = int(primed().flush(r)[1].max())
    out, Ks = primed().flush(r, k_max=need)   # exactly full: legal
    assert int(Ks.max()) == need and out.shape == (4, need)
    with pytest.raises(ValueError):
        primed().flush(r, k_max=need - 1)


def test_latched_stream_ratio_is_inert():
    """A flushed stream's stale ratio must not inflate the capacity nor
    change any live stream's output (tests/test_asrc.py)."""
    s = 4
    lcg = NoiseLCG()
    x = lcg.fill(s * N).reshape(s, N)
    x2 = lcg.fill(s * N).reshape(s, N)
    engines = []
    for _ in range(2):
        e = BatchedASRC(s, 48, 48, device="cpu")
        e.advance_position(24.0)
        out0, _ = e.process(x, np.full(s, 1.001))
        mask = np.zeros(s, bool)
        mask[0] = True
        e.flush(np.ones(s), mask=mask)
        engines.append(e)
    b, ref = engines
    bad = np.full(s, 1.001)
    bad[0] = 50.0
    out_bad, Ks_bad = b.process(x2, bad)
    out_ref, Ks_ref = ref.process(x2, np.full(s, 1.001))
    assert out_bad.shape[1] == out_ref.shape[1] == out0.shape[1]
    assert Ks_bad[0] == 0 and np.array_equal(Ks_bad, Ks_ref)
    assert torch.equal(out_bad, out_ref)
    assert np.array_equal(b.get_position(), ref.get_position())
    fbad = np.full(s, 50.0)
    fmask = np.zeros(s, bool)
    fmask[1] = True
    fbad[1] = 1.001
    fout, fKs = b.flush(fbad, mask=fmask)
    rout, rKs = ref.flush(np.where(fmask, 1.001, 1.0), mask=fmask)
    assert fout.shape == rout.shape and np.array_equal(fKs, rKs)
    assert torch.equal(fout, rout)


def test_flush_with_nothing_to_emit_skips_the_step():
    t = BatchedASRC(4, 48, 48, device="cpu")
    t.advance_position(24.0)
    t.process(torch.zeros((4, 256)), np.ones(4))
    calls = []
    orig = t._run_step
    t._run_step = lambda *a, **k: (calls.append(1), orig(*a, **k))[1]
    fout, fKs = t.flush(np.ones(4), mask=np.zeros(4, bool))
    assert not calls and not fKs.any() and not fout.any()
    fout, _ = t.flush(np.ones(4), mask=np.zeros(4, bool), k_max=37)
    assert not calls and fout.shape == (4, 37)
    t.flush(np.ones(4))                       # a real flush: one step
    assert len(calls) == 1
    _, fKs = t.flush(np.ones(4))
    assert len(calls) == 1 and not fKs.any()


def test_jax_state_continues_identically():
    """A JAX engine's state_dict loaded into the port continues as the JAX
    engine does; the port's own checkpoint resumes bitwise."""
    j, t = _pair()
    j.advance_position(24.0)
    lcg = NoiseLCG()
    rng = np.random.default_rng(4)
    for _ in range(3):
        j.process(jnp.asarray(lcg.fill(S * N).reshape(S, N)),
                  1.0 + rng.uniform(-0.01, 0.01, S))
    j.flush(np.ones(S), np.arange(S) == 2)
    t.load_state(j.state_dict())
    assert np.array_equal(t.get_position(), j.get_position())
    snap = t.state_dict()
    assert set(snap) == set(j.state_dict())
    x = lcg.fill(S * N).reshape(S, N)
    ratios = 1.0 + rng.uniform(-0.01, 0.01, S)
    _check_call(j.process(jnp.asarray(x), ratios),
                t.process(torch.from_numpy(x), ratios), j, t, 2e-6)
    o1, K1 = t.process(x, ratios)
    # resume from the snapshot taken before the last two calls
    r2 = BatchedASRC(S, TAPS, FILTERS, device="cpu")
    r2.load_state(snap)
    r2.process(x, ratios)
    o3, K3 = r2.process(x, ratios)
    assert np.array_equal(K1, K3) and torch.equal(o1, o3)
    assert np.array_equal(r2.get_position(), t.get_position())


def test_stream_adapter_matches_jax():
    """ASRCStreamResampler (artest's runtime-ratio path) against JAX's over
    drifting ratios and uneven chunks, the planar form, flush and the
    FLUSHED latch."""
    rng = np.random.default_rng(5)
    ch, taps, filters = 2, 64, 128
    j = jasrc.ASRCStreamResampler(ch, taps, filters, 0.0, IB)
    t = ASRCStreamResampler(ch, taps, filters, 0.0, IB, device="cpu")
    for e in (j, t):
        e.advance_position(taps / 2)
    assert (t.get_num_filters(), t.interpolation_used(),
            t.get_lowpass_ratio()) == (j.get_num_filters(),
                                       j.interpolation_used(),
                                       j.get_lowpass_ratio())
    ratio = 48000 / 44100
    for i in range(8):
        n = 1000 + (i % 3) * 137
        r = ratio * (1.0 + 0.003 * np.sin(i))
        data = (rng.standard_normal((n, ch)) * 0.25).astype(np.float32)
        cap = int(n * r) + taps + 16
        if i % 4 == 3:
            (oj, rj), (ot, rt) = (e.process(np.ascontiguousarray(data.T), n,
                                            cap, r) for e in (j, t))
            oj, ot = oj.T, ot.T
        else:
            (oj, rj), (ot, rt) = (e.process_interleaved(data, n, cap, r)
                                  for e in (j, t))
        assert (rj.input_used, rj.output_generated) == (rt.input_used,
                                                        rt.output_generated)
        assert j.get_position() == t.get_position()
        assert ot.shape == oj.shape and ot.dtype == oj.dtype
        assert float(np.abs(oj - ot).max()) <= 2e-6
    fd = (rng.standard_normal((500, ch)) * 0.25).astype(np.float32)
    (oj, rj), (ot, rt) = (e.process_and_flush_interleaved(fd, 500, 2000,
                                                          ratio)
                          for e in (j, t))
    assert rj.output_generated == rt.output_generated
    assert float(np.abs(oj - ot).max()) <= 2e-6
    _, rt2 = t.process_interleaved(fd, 500, 2000, ratio)
    assert rt2.output_generated == 0


def test_lowpass_ratio_bank_matches_jax():
    j = jasrc.ASRCStreamResampler(1, 48, 64, 0.7, IB)
    t = ASRCStreamResampler(1, 48, 64, 0.7, IB, device="cpu")
    assert np.array_equal(j.asrc.bank, t.asrc.bank)
    for e in (j, t):
        e.advance_position(24.0)
    data = NoiseLCG().fill(2048).reshape(2048, 1)
    (oj, rj), (ot, rt) = (e.process_interleaved(data, 2048, 4096,
                                                44100 / 48000)
                          for e in (j, t))
    assert rj.output_generated == rt.output_generated
    assert float(np.abs(oj - ot).max()) <= 2e-6


def test_adapter_guards():
    with pytest.raises(ValueError, match="SUBSAMPLE_INTERPOLATE"):
        ASRCStreamResampler(2, 64, 128, 0.0, BLACKMAN_HARRIS, device="cpu")
    with pytest.raises(ValueError, match="EXTRAPOLATE"):
        ASRCStreamResampler(2, 64, 128, 0.0, IB | EXTRAPOLATE_ENDPOINTS,
                            device="cpu")
    eng = ASRCStreamResampler(2, 64, 128, 0.0, IB, device="cpu")
    with pytest.raises(ValueError, match="positive per-call ratio"):
        eng.process_interleaved(np.zeros((16, 2), np.float32), 16, 64, 0.0)


@pytest.mark.parametrize("kwargs,exc,match", [
    (dict(mesh=object()), NotImplementedError, "ROADMAP"),
    (dict(kernel="mosaic"), ValueError, "kernel"),
    (dict(dense_kb=100), ValueError, "dense_kb"),
    (dict(hankel_kb=200), ValueError, "hankel_kb"),
    (dict(dtype=np.float16), ValueError, "dtype"),
    (dict(device="meta"), ValueError, "device type")])
def test_engine_options_raise(kwargs, exc, match):
    with pytest.raises(exc, match=match):
        BatchedASRC(S, TAPS, FILTERS, **{"device": "cpu", **kwargs})


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        BatchedASRC(S, TAPS, FILTERS, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        ASRCStreamResampler(2, 64, 128, 0.0, IB)


@pytest.mark.parametrize("kwargs", [dict(hankel_smax=6),
                                    dict(hankel_smax_wide=0)])
def test_tpu_tier_bounds_warn_that_they_change_nothing(kwargs):
    with pytest.warns(UserWarning, match="no effect"):
        BatchedASRC(S, TAPS, FILTERS, device="cpu", **kwargs)
