"""The port's DeviceStreamResampler (device="cpu", the plain chunk step)
held against the JAX engine on the same numpy inputs.

Counts (K per call), peek_output and get_position must be exactly equal:
both engines run the same float64 accounting code.  Samples sit within
1e-5 abs (float32 contractions summed in different orders; measured spread
~1.4e-6 on std-0.5 noise).  The phase-anchor matrices -- the weights of this
system -- must be bitwise equal."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from art_tpu.core.flags import (BLACKMAN_HARRIS, EXTRAPOLATE_ENDPOINTS,
                                INCLUDE_LOWPASS, SUBSAMPLE_INTERPOLATE)
from art_tpu.parallel import streams as jstreams
from art_tpu_torch import DeviceStreamResampler
from art_tpu_torch import roundtrip

REPO = Path(__file__).resolve().parent.parent
IB = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS | INCLUDE_LOWPASS
DIRECTIONS = {"fwd": (44100, 48000), "inv": (48000, 44100)}


def jax_state(eng) -> dict:
    """A JAX DeviceStreamResampler's streaming state in the port's
    state_dict layout."""
    return {"history": np.asarray(eng.hist),
            "output_offset": eng.output_offset,
            "input_index": eng.input_index, "flushed": eng._flushed}


def _pair(direction, taps=380, flags=IB):
    src, dst = DIRECTIONS[direction]
    j = jstreams.DeviceStreamResampler(2, taps, taps, src, dst, 0, flags)
    t = DeviceStreamResampler(2, taps, taps, src, dst, 0, flags,
                              device="cpu")
    return j, t


def _noise(n, seed):
    return np.random.default_rng(seed).normal(0, 0.5, (2, n)) \
        .astype(np.float32)


def _step_both(j, t, n, seed, flush=False):
    """One process(n) (or flush()) call on both engines; checks the exact
    contracts and returns the max sample difference."""
    if not flush:
        assert t.peek_output(n) == j.peek_output(n)
        x = _noise(n, seed)
        oj, Kj, aj = j.process(jnp.asarray(x), n, jnp.zeros((), jnp.float32))
        ot, Kt, at = t.process(torch.from_numpy(x), n, torch.zeros(()))
        assert float(at) == pytest.approx(float(aj), rel=1e-5, abs=1e-12)
    else:
        oj, Kj = j.flush()
        ot, Kt = t.flush()
    assert Kt == Kj
    assert t.get_position() == j.get_position()
    oj, ot = np.asarray(oj), ot.numpy()
    assert ot.shape == oj.shape
    assert not ot[:, Kt:].any()
    return float(np.abs(ot - oj).max()) if ot.size else 0.0


@pytest.mark.parametrize("direction", list(DIRECTIONS))
def test_engine_matches_jax_over_uneven_chunks(direction):
    j, t = _pair(direction)
    assert (t.L, t.M, t.qn) == (j.L, j.M, j.qn)
    for e in (j, t):
        e.advance_position(190)
    worst = 0.0
    for i, n in enumerate([1, 3, 1000, 4096, 40 * t.M, 64 * t.M]):
        worst = max(worst, _step_both(j, t, n, seed=i))
        if i == 2:
            for e in (j, t):
                e.advance_position(7)
    worst = max(worst, _step_both(j, t, 0, 0, flush=True))
    assert worst <= 1e-5
    # FLUSHED latch: a second flush and any later process emit nothing
    _step_both(j, t, 0, 0, flush=True)
    _step_both(j, t, 500, seed=9)
    np.testing.assert_allclose(t.state_dict()["history"], np.asarray(j.hist),
                               atol=0, rtol=0)


@pytest.mark.parametrize("direction", list(DIRECTIONS))
def test_anchor_matrices_bitwise_equal(direction):
    j, t = _pair(direction)
    for j0 in (0, 1, t.L // 2, t.L - 1):
        P = t._matrix(j0).numpy()
        assert P.shape == (t.qn * t.M, t.L)
        np.testing.assert_array_equal(P, np.asarray(j._matrix(j0)))


@pytest.mark.parametrize("direction", list(DIRECTIONS))
def test_load_state_from_jax_continues_identically(direction):
    j, t = _pair(direction)
    j.advance_position(190)
    for i, n in enumerate([1000, 4096]):
        j.process(jnp.asarray(_noise(n, seed=20 + i)), n)
    state = jax_state(j)
    t.load_state(state)
    got = t.state_dict()
    assert set(got) == {"history", "output_offset", "input_index", "flushed"}
    np.testing.assert_array_equal(got["history"], state["history"])
    assert (got["output_offset"], got["input_index"], got["flushed"]) == \
        (state["output_offset"], state["input_index"], False)
    worst = 0.0
    for i, n in enumerate([40 * t.M, 333]):
        worst = max(worst, _step_both(j, t, n, seed=30 + i))
    worst = max(worst, _step_both(j, t, 0, 0, flush=True))
    assert worst <= 1e-5
    assert t.state_dict()["flushed"] and j._flushed


def _jax_stream(eng, x, chunk):
    """bench._stream_flat_out's path on the JAX engine: the first chunk
    through process(), the whole chunks after it as one process_flat_out
    group, the tail through process(), then flush()."""
    n = x.shape[1]
    pos = min(chunk, n)
    o, K = eng.process(jnp.asarray(x[:, :pos]), pos)
    outs = [np.asarray(o)[:, :K]]
    g = (n - pos) // chunk
    if g:
        o, _ = eng.process_flat_out(jnp.asarray(x[:, pos:pos + g * chunk]),
                                    chunk)
        outs.append(np.asarray(o))
        pos += g * chunk
    if pos < n:
        o, K = eng.process(jnp.asarray(x[:, pos:]), n - pos)
        outs.append(np.asarray(o)[:, :K])
    o, K = eng.flush()
    outs.append(np.asarray(o)[:, :K])
    return np.concatenate(outs, axis=1)


def test_roundtrip_matches_jax_within_1db():
    """2 s of the artest round trip (preset -3) through the headline code
    path on both engines: the port on the CPU lands within 1 dB of the JAX
    engine and under the -130 dB gate."""
    chunk_target = 1 << 15
    rt = roundtrip.roundtrip_diff_db(2, "cpu", chunk_target)
    x = roundtrip.artest_noise(2)
    ys = x
    for src, dst in ((44100, 48000), (48000, 44100)):
        eng = jstreams.DeviceStreamResampler(2, 380, 380, src, dst, 0,
                                             roundtrip.FLAGS)
        eng.advance_position(190)
        ys = _jax_stream(eng, ys, roundtrip.m_multiple(chunk_target, eng.M))
    m = min(x.shape[1], ys.shape[1])
    diff = (ys[:, :m] - x[:, :m]).astype(np.float64)
    db_j = 10.0 * np.log10(np.sum(diff * diff) / (m * 2) * 2.0)
    assert rt["diff_db"] <= -130.0
    assert abs(rt["diff_db"] - db_j) <= 1.0
    # each leg: first chunk, one flat group, the tail, flush
    assert rt["calls"] == 2 * 4
    assert rt["frames"][1] == ys.shape[1]


def test_import_leaves_jax_out():
    code = ("import pkgutil, sys, importlib, art_tpu_torch\n"
            "for m in pkgutil.walk_packages(art_tpu_torch.__path__, "
            "'art_tpu_torch.'):\n"
            # the native runtime's ctypes library, once built, sits in its
            # package with a .so suffix: it is no Python module
            "    if not m.name.endswith('.libartnative'):\n"
            "        importlib.import_module(m.name)\n"
            "sys.exit(3 if 'jax' in sys.modules else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_cuda.py runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        DeviceStreamResampler(2, 380, 380, 44100, 48000, 0, IB,
                              device="cuda")


@pytest.mark.parametrize("kwargs,exc,match", [
    pytest.param(dict(dtype=np.float64, precise="int8"), ValueError, "f32",
                 id="kwargs0"),
    pytest.param(dict(precise=True, pallas_step=True), ValueError, "precise",
                 id="kwargs1"),
    pytest.param(dict(precise="int8", mesh=object()), NotImplementedError,
                 "single-shard", id="kwargs2"),
    pytest.param(dict(mesh=object()), NotImplementedError, "ROADMAP",
                 id="kwargs3")])
def test_out_of_slice_options_raise(kwargs, exc, match):
    """The options the engine refuses: the precision tiers' gates, copied
    from JAX (int8 is float32-only and single-shard, no tier with the
    Pallas body), and mesh= (ROADMAP item 11)."""
    with pytest.raises(exc, match=match):
        DeviceStreamResampler(2, 380, 380, 44100, 48000, 0, IB,
                              device="cpu", **kwargs)


def test_extrapolate_endpoints_raises_value_error():
    with pytest.raises(ValueError, match="EXTRAPOLATE_ENDPOINTS"):
        DeviceStreamResampler(2, 380, 380, 44100, 48000, 0,
                              IB | EXTRAPOLATE_ENDPOINTS, device="cpu")


def test_fractional_advance_raises():
    t = DeviceStreamResampler(2, 380, 380, 44100, 48000, 0, IB, device="cpu")
    with pytest.raises(ValueError, match="fractional"):
        t.advance_position(0.5)
