"""The port's interpolated fixed-rational mode (DeviceStreamResampler with
device="cpu", the plain chunk step) held against the JAX engine on the same
numpy inputs.

Counts (K per call), peek_output and get_position are exactly equal: both
engines run the same float64 accounting.  The banked matrices P2, the lerp
fractions and the pattern-reuse choices are bitwise equal: they are a pure
selection from the same bank, driven by the same float64 pattern code.
Samples sit within 1e-5 abs (float32 contractions summed in different
orders on std-0.5 noise)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from art_tpu.core.flags import (BLACKMAN_HARRIS, INCLUDE_LOWPASS,
                                NO_FILTER_REDUCTION, SUBSAMPLE_INTERPOLATE)
from art_tpu.parallel import streams as jstreams
from art_tpu_torch import DeviceStreamResampler

IB = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS | INCLUDE_LOWPASS
CONFIGS = {
    # preset -1 mono: 48 filters cannot carry 160 phases
    "preset1": (1, 48, 48, 44100, 48000, IB),
    # preset -3 stereo with the planner's reduction switched off
    "preset3_nfr": (2, 380, 380, 44100, 48000, IB | NO_FILTER_REDUCTION),
}


def _pair(config):
    ch, taps, filt, src, dst, flags = CONFIGS[config]
    j = jstreams.DeviceStreamResampler(ch, taps, filt, src, dst, 0, flags)
    t = DeviceStreamResampler(ch, taps, filt, src, dst, 0, flags,
                              device="cpu")
    assert j.interp and t.interp
    assert (t.L, t.M, t.qn) == (j.L, j.M, j.qn)
    return j, t


def _step_both(j, t, n, rng, flush=False):
    """One process(n) (or flush()) on both engines; checks the exact
    contracts and returns the max sample difference."""
    if flush:
        (oj, Kj), (ot, Kt) = j.flush(), t.flush()
    else:
        assert t.peek_output(n) == j.peek_output(n)
        x = rng.normal(0, 0.5, (t.num_channels, n)).astype(np.float32)
        oj, Kj, aj = j.process(jnp.asarray(x), n, jnp.zeros((), jnp.float32))
        ot, Kt, at = t.process(torch.from_numpy(x), n, torch.zeros(()))
        assert float(at) == pytest.approx(float(aj), rel=1e-5, abs=1e-12)
    assert Kt == Kj
    assert t.get_position() == j.get_position()
    oj, ot = np.asarray(oj), ot.numpy()
    assert ot.shape == oj.shape and not ot[:, Kt:].any()
    return float(np.abs(ot - oj).max()) if ot.size else 0.0


@pytest.mark.parametrize("config", list(CONFIGS))
def test_interp_process_matches_jax_over_uneven_chunks(config):
    j, t = _pair(config)
    for e in (j, t):
        e.advance_position(t.num_taps // 2 + 0.3)     # fractional: allowed
    rng = np.random.default_rng(3)
    worst = 0.0
    for i, n in enumerate([1, 3, 1000, 4096, 40 * t.M, 64 * t.M, 9000,
                           333]):
        worst = max(worst, _step_both(j, t, n, rng))
        if i == 3:
            for e in (j, t):
                e.advance_position(2.75)
    worst = max(worst, _step_both(j, t, 0, rng, flush=True))
    assert worst <= 1e-5
    # FLUSHED latch: a second flush and any later process emit nothing
    _step_both(j, t, 0, rng, flush=True)
    _step_both(j, t, 500, rng)
    np.testing.assert_array_equal(t.state_dict()["history"],
                                  np.asarray(j.hist))


@pytest.mark.parametrize("n_in", [10 * 147, 1000, 64 * 147 + 5])
def test_interp_patterns_bitwise_and_same_reuse_over_200_chunks(n_in):
    """Chunk by chunk over 200 chunks, both engines' _interp_pattern return
    bitwise the same P2, fracv and (d, fi, frac), make the same reuse
    choice (the previous chunk's pattern or a fresh one) and the same
    safety verdict."""
    j, t = _pair("preset1")
    for e in (j, t):
        e.advance_position(24)
    reused = 0
    prev_j = prev_t = None
    for _ in range(200):
        planned = []
        for e in (j, t):
            K, start, _j0, pos0, plan = e._plan_compute(n_in)
            nb = -(-K // e.L) if K else 1
            planned.append((K, start, e._interp_pattern(pos0, plan, n_in,
                                                        K, nb), plan))
        (Kj, sj, mj, pj), (Kt, st, mt, pt) = planned
        assert (Kj, sj) == (Kt, st)
        np.testing.assert_array_equal(mt[0].numpy(), np.asarray(mj[0]))
        np.testing.assert_array_equal(mt[1].numpy(), np.asarray(mj[1]))
        assert mt[1].dtype == torch.float32
        for a, b in zip(mt[2:5], mj[2:5]):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        assert mt[5] == mj[5]
        assert (mj[0] is prev_j) == (mt[0] is prev_t)
        reused += mt[0] is prev_t
        prev_j, prev_t = mj[0], mt[0]
        for e, p in ((j, pj), (t, pt)):
            e.output_offset, e.input_index = (p.new_output_offset,
                                              p.new_input_index)
    if n_in % t.M == 0:
        assert reused >= 190        # the periodic steady state reuses


def _force_one_split(eng):
    """Make the engine's next multi-period chunk fail the tie oracle once
    (a deviating pattern also fails the reuse compare, so the reuse state
    is cleared too); returns the list that records the trip."""
    eng._last_interp = None
    orig = eng._pattern_safe
    tripped = []

    def fake(plan, n_in, K, nb, *a):
        if nb > 1 and not tripped:
            tripped.append(1)
            return False
        return orig(plan, n_in, K, nb, *a)

    eng._pattern_safe = fake
    return tripped


def test_interp_split_path_matches_jax():
    """A chunk flagged unsafe is halved into exact sub-chunks: the port's
    split (forced) against JAX's forced split and against JAX unforced."""
    j, t = _pair("preset1")
    ju = jstreams.DeviceStreamResampler(*CONFIGS["preset1"][:5], 0,
                                        CONFIGS["preset1"][5])
    for e in (j, t, ju):
        e.advance_position(24)
    rng = np.random.default_rng(11)
    for it in range(4):
        x = rng.normal(0, 0.5, (1, 1470)).astype(np.float32)
        if it == 2:
            trips = [_force_one_split(e) for e in (j, t)]
        oj, Kj = j.process(jnp.asarray(x), 1470)
        ot, Kt = t.process(torch.from_numpy(x), 1470)
        ou, Ku = ju.process(jnp.asarray(x), 1470)
        if it == 2:
            assert all(trips)
            for e in (j, t):
                del e._pattern_safe
        assert Kt == Kj == Ku
        assert t.get_position() == j.get_position() == ju.get_position()
        assert ot.shape == np.asarray(oj).shape
        for o in (oj, ou):
            assert np.abs(ot.numpy()[:, :Kt] - np.asarray(o)[:, :Kt]) \
                .max() <= 1e-5


@pytest.mark.parametrize("src,dst,taps,flags", [
    (44100, 48000, 48, IB), (96000, 44100, 48, IB), (44100.5, 48000, 48, IB),
    (44100, 48001, 48, IB), (48000, 44100, 380, IB | NO_FILTER_REDUCTION),
    (44100, 48000, 380, IB), (5000, 256000, 48, IB)])
def test_accepts_and_rejects_like_jax(src, dst, taps, flags):
    """The constructor accepts the interpolated configurations JAX accepts
    (same L, M, qn, mode) and rejects those it rejects, with ValueError."""
    outcomes = []
    for ctor in (jstreams.DeviceStreamResampler,
                 lambda *a: DeviceStreamResampler(*a, device="cpu")):
        try:
            e = ctor(1, taps, taps, src, dst, 0, flags)
            outcomes.append((e.interp, e.L, e.M, e.qn))
        except ValueError as err:
            outcomes.append(("ValueError", str(err)))
    assert outcomes[0] == outcomes[1]


def test_fractional_advance_needs_interpolated_mode():
    t = DeviceStreamResampler(1, 48, 48, 44100, 48000, 0, IB, device="cpu")
    t.advance_position(0.5)
    assert t.get_position() == 0.5
    r = DeviceStreamResampler(2, 380, 380, 44100, 48000, 0, IB,
                              device="cpu")
    assert not r.interp
    with pytest.raises(ValueError, match="fractional"):
        r.advance_position(0.5)
