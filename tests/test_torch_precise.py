"""The precision tiers of the port's fixed-ratio engine (device="cpu", the
plain chunk step) held against JAX's engine in the same tier on the same
inputs, and against the port's own sequential process().

Tiers: ``precise=True`` (each dot accumulated in float64, rounded once to
float32), ``precise="int8"`` (JAX's Ozaki-split int8 dots; the port runs
the precise=True function, the same single-rounding floor) and float64
data.  Against JAX: Ks and positions exactly equal; samples within 1
float32 ulp of JAX's precise=True (both round a float64 dot once; the two
float64 sums differ in order, so a sum that lands within ~1e-16 of a
rounding boundary may round the other way); within 3e-7 of JAX's int8
(JAX's own bound between int8 and precise=True, test_parallel.py:1108) and
2e-6 of its float32 default; within 1e-12 of JAX's float64 engine; packed
bytes and clip counts of float64 data equal.  Against the port's sequential
process(): every group form bitwise equal in every tier."""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import bench
from art_tpu.core.flags import (BLACKMAN_HARRIS, INCLUDE_LOWPASS,
                                SUBSAMPLE_INTERPOLATE)
from art_tpu.parallel import streams as jstreams
from art_tpu.parallel.sharding import make_mesh
from art_tpu_torch import DeviceStreamResampler, roundtrip
from art_tpu_torch.parallel import streams as tstreams

IB = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS
IBL = IB | INCLUDE_LOWPASS
# the ctors of JAX's own tier tests (test_parallel.py:991-1095)
REDUCED = (2, 64, 380, 44100, 48000, 0, IBL)     # L=160, M=147, qn=2
PRESET1 = (1, 48, 48, 44100, 48000, 0, IB)       # interpolated, Lp/Mp 160/147
DYADIC = (1, 48, 48, 5000, 256000, 0, IB)        # interpolated, period exact
CTORS = [pytest.param(REDUCED, id="reduced"),
         pytest.param(PRESET1, id="interp"),
         pytest.param(DYADIC, id="interp-dyadic")]
TIERS = {"precise": dict(precise=True), "int8": dict(precise="int8"),
         "f64": dict(dtype=np.float64)}
G = 3
PACK = dict(scaler=32768.0, highclip=32767, lowclip=-32768)


def _dtype(tier):
    return np.float64 if tier == "f64" else np.float32


def _engine(ctor, tier=None, jax=False):
    opts = TIERS[tier] if tier else {}
    if jax:
        eng = jstreams.DeviceStreamResampler(*ctor, **opts)
    else:
        eng = DeviceStreamResampler(*ctor, device="cpu", **opts)
    eng.advance_position(ctor[1] // 2)
    return eng


def _chunk(eng):
    """An M-multiple chunk of 8 periods or more, G of them covering the
    history."""
    return max(8, -(-eng.num_samples // (G * eng.M))) * eng.M


def _inputs(ctor, tier, n, seed):
    """+-0.5 white noise from a numpy seed (NoiseLCG's range): the first
    chunk [ch, n] and G chunks [G, ch, n]."""
    rng = np.random.default_rng(seed)
    ch = ctor[0]
    first = rng.uniform(-0.5, 0.5, (ch, n)).astype(_dtype(tier))
    xs = rng.uniform(-0.5, 0.5, (G, ch, n)).astype(_dtype(tier))
    return first, xs


def _ulps(out, ref):
    """|out - ref| in float32 ulps of ref, and how many samples differ."""
    ref = np.asarray(ref, np.float32)
    ulp = np.spacing(np.abs(ref)).astype(np.float64)
    d = np.abs(np.asarray(out, np.float64) - ref.astype(np.float64))
    return float((d / ulp).max()), int((np.asarray(out) != ref).sum())


def _sequential(t, first, xs, n):
    """The first chunk, then G chunks by process() with a power
    accumulator: (outs, Ks, acc)."""
    t.process(torch.from_numpy(first), n)
    acc = torch.zeros((), dtype=t.hist.dtype)
    outs, Ks = [], []
    for x in xs:
        o, K, acc = t.process(torch.from_numpy(x), n, acc)
        outs.append(o)
        Ks.append(K)
    return outs, Ks, acc


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("ctor", CTORS)
def test_tier_matches_jax(ctor, tier):
    """process() in each tier against JAX's engine in the same tier: Ks
    and positions exact, samples within the tier's bound."""
    j, t = _engine(ctor, tier, jax=True), _engine(ctor, tier)
    n = _chunk(t)
    first, xs = _inputs(ctor, tier, n, 11)
    if tier == "int8":
        jd = _engine(ctor, jax=True)                 # JAX's float32 default
        jd.process(jnp.asarray(first), n)
    j.process(jnp.asarray(first), n)
    t.process(torch.from_numpy(first), n)
    worst, ndiff, total = 0.0, 0, 0
    for g, x in enumerate(list(xs) + [xs[0][:, :1000]]):
        m = x.shape[1]
        oj, Kj = j.process(jnp.asarray(x), m)
        ot, Kt = t.process(torch.from_numpy(x), m)
        assert Kt == Kj, g
        assert t.get_position() == j.get_position(), g
        oj, ot = np.asarray(oj)[:, :Kj], ot.numpy()[:, :Kt]
        assert ot.dtype == _dtype(tier)
        if tier == "f64":
            worst = max(worst, float(np.abs(ot - oj).max()))
        elif tier == "precise":
            u, d = _ulps(ot, oj)
            worst, ndiff, total = max(worst, u), ndiff + d, total + ot.size
        else:
            od, Kd = jd.process(jnp.asarray(x), m)
            assert Kd == Kt
            assert np.abs(ot - oj).max() <= 3e-7, g
            assert np.abs(ot - np.asarray(od)[:, :Kd]).max() <= 2e-6, g
    if tier == "f64":
        assert worst <= 1e-12
    elif tier == "precise":
        print(f"precise=True vs JAX: {ndiff} of {total} samples differ, "
              f"at most {worst:.2f} ulp")
        assert worst <= 1.0


def _group_runs(ctor, tier, method, n, xs):
    """One port engine, the first chunk absorbed, then ``method`` over
    the G chunks."""
    t = _engine(ctor, tier)
    first = xs[-1]
    t.process(torch.from_numpy(first), n)
    flat = torch.from_numpy(np.concatenate(list(xs[:G]), axis=1))
    dt = t.hist.dtype
    if method == "process_scan":
        r = t.process_scan(torch.from_numpy(xs[:G]), n,
                           torch.zeros((), dtype=dt))
    elif method == "process_flat":
        r = t.process_flat(flat, n, torch.zeros((), dtype=dt))
    elif method == "process_flat_out":
        r = t.process_flat_out(flat, n)
    else:
        r = t.process_flat_packed(flat, n, torch.zeros((), dtype=torch.int32),
                                  **PACK)
    return t, r


@pytest.mark.parametrize("method", ["process_scan", "process_flat",
                                    "process_flat_out",
                                    "process_flat_packed"])
@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("ctor", CTORS)
def test_tier_group_forms_bitwise_sequential(ctor, tier, method):
    """Every group form in every tier is bitwise equal to sequential
    process(): samples (packed: the host quantization of them), Ks,
    history, power and position."""
    s = _engine(ctor, tier)
    n = _chunk(s)
    first, xs = _inputs(ctor, tier, n, 12)
    xs = np.concatenate([xs, first[None]], axis=0)      # first chunk last
    outs, Ks, acc = _sequential(s, xs[-1], xs[:G], n)
    t, r = _group_runs(ctor, tier, method, n, xs)
    valid = torch.cat([o[:, :K] for o, K in zip(outs, Ks)], dim=1)
    assert list(r[0] if method == "process_flat" else r[1]) == Ks
    assert t.get_position() == s.get_position()
    assert torch.equal(t.hist, s.hist)
    if method == "process_scan":
        assert torch.equal(r[2], acc)
        for g, K in enumerate(Ks):
            assert torch.equal(r[0][g, :, :outs[g].shape[1]], outs[g])
    elif method == "process_flat":
        assert torch.equal(r[1], acc)
    elif method == "process_flat_out":
        assert r[0].dtype == s.hist.dtype and torch.equal(r[0], valid)
    else:
        x = valid.numpy()
        if x.dtype == np.float64:
            code = x * PACK["scaler"]
        else:
            code = (x.astype(np.float64) * np.float32(PACK["scaler"])) \
                .astype(np.float32).astype(np.float64)
        f = np.floor(code)
        ov = f + (code - f >= 0.5)
        nclip = int(((ov > 32767) | (ov < -32768)).sum())
        ov = np.clip(ov, -32768, 32767).astype(np.int64)
        assert np.array_equal(r[0].numpy().view(np.uint8),
                              ov.astype("<i2").view(np.uint8))
        assert int(r[2]) == nclip


@pytest.mark.parametrize("scaler", [32768.0, 32768.0 * 1.37],
                         ids=["pow2", "gain1.37"])
@pytest.mark.parametrize("ctor", [pytest.param(REDUCED, id="reduced"),
                                  pytest.param(DYADIC, id="interp-dyadic")])
def test_f64_packed_bytes_match_jax(ctor, scaler):
    """process_flat_packed on float64 data: packed bytes and clip counts
    equal to JAX's float64 engine's (a float64 scaler and one float64
    multiply, then the exact half-up rule on float64 codes)."""
    j, t = _engine(ctor, "f64", jax=True), _engine(ctor, "f64")
    n = _chunk(t)
    first, xs = _inputs(ctor, "f64", n, 13)
    xs = 1.5 * xs                                       # drive clipping
    flat = np.concatenate(list(xs), axis=1)
    j.process(jnp.asarray(first), n)
    t.process(torch.from_numpy(first), n)
    kw = dict(scaler=scaler, highclip=32767, lowclip=-32768)
    pj, Kj, cj = j.process_flat_packed(jnp.asarray(flat), n,
                                       jnp.zeros((), jnp.int32), **kw)
    pt, Kt, ct = t.process_flat_packed(torch.from_numpy(flat), n,
                                       torch.zeros((), dtype=torch.int32), **kw)
    assert list(Kt) == list(Kj)
    assert t.get_position() == j.get_position()
    pj = np.asarray(pj)
    assert pt.numpy().dtype == pj.dtype
    assert np.array_equal(pt.numpy(), pj)
    assert int(ct) == int(cj) > 0


@pytest.mark.parametrize("bits,nbytes,scaler,hi,lo", [
    (8, 1, 128.0, 127, -128), (16, 2, 32768.0 * 1.37, 32767, -32768),
    (24, 4, 8388608.0, 8388607, -8388608),
    (20, 4, 524288.0 * 0.9, 524287, -524288)])
def test_f64_packing_epilogue_bitwise_vs_jax(monkeypatch, bits, nbytes,
                                             scaler, hi, lo):
    """The port's quantize + pack epilogue and JAX's on the same float64
    samples (JAX's _chunk_group_static_packed run eagerly with its group
    outputs replaced): bitwise the same container and clip count,
    including codes on the half-way points."""
    rng = np.random.default_rng(bits)
    ch, K = 2, 700
    samples = 1.2 * rng.standard_normal((ch, G * K))
    samples[:, :8] = [0.5 / scaler, -0.5 / scaler, 1.5 / scaler, 0.0,
                      -0.0, 2.5 / scaler, -1.5 / scaler, 1.0]
    monkeypatch.setattr(jstreams, "_group_chunk_out",
                        lambda buf, P2, fracv, g, **kw:
                        jnp.asarray(samples[:, g * K:(g + 1) * K]))
    n, hist_len = 10, 4
    packed_j, clips_j, _ = jstreams._chunk_group_static_packed.__wrapped__(
        jnp.zeros((ch, hist_len), jnp.float64),
        jnp.zeros((ch, G * n), jnp.float64), None, None,
        scaler, jnp.zeros((), jnp.int32), start=0, K=K, G=G, n=n, M=1, L=1,
        nb=1, qn=1, hist_len=hist_len, highclip=hi, lowclip=lo,
        output_bits=bits, output_bytes=nbytes)
    packed_t, clips_t = tstreams._quantize_pack(
        torch.from_numpy(samples), scaler,
        torch.zeros((), dtype=torch.int32), highclip=hi, lowclip=lo,
        output_bits=bits, output_bytes=nbytes)
    packed_j = np.asarray(packed_j)
    assert packed_t.numpy().dtype == packed_j.dtype
    assert np.array_equal(packed_t.numpy(), packed_j)
    assert int(clips_t) == int(clips_j) > 0


@pytest.mark.parametrize("tier", list(TIERS))
def test_tier_state_dict_round_trip(tier):
    """state_dict/load_state carry a tier's stream (history in the engine's
    dtype): an engine resumed from the state continues bitwise as the
    original."""
    a = _engine(PRESET1, tier)
    n = _chunk(a)
    first, xs = _inputs(PRESET1, tier, n, 14)
    a.process(torch.from_numpy(first), n)
    st = a.state_dict()
    assert st["history"].dtype == _dtype(tier)
    b = _engine(PRESET1, tier)
    b.load_state(st)
    for x in xs:
        oa, Ka = a.process(torch.from_numpy(x), n)
        ob, Kb = b.process(torch.from_numpy(x), n)
        assert Ka == Kb and torch.equal(oa, ob)
    assert a.get_position() == b.get_position()
    assert torch.equal(a.hist, b.hist)


@pytest.mark.parametrize("kwargs,exc,match", [
    (dict(precise="int8", dtype=np.float64), ValueError, "f32"),
    (dict(precise="int8", mesh="mesh"), NotImplementedError, "single-shard"),
    (dict(precise="int8", pallas_step=True), ValueError, "precise"),
    (dict(precise=True, pallas_step=True), ValueError, "precise")],
    ids=["int8-f64", "int8-mesh", "int8-pallas", "precise-pallas"])
def test_tier_gates_match_jax(kwargs, exc, match):
    """The tiers' gates raise JAX's exceptions on JAX's call lines
    (test_parallel.py:1059-1063, 1164-1175)."""
    if kwargs.get("mesh") == "mesh":
        kwargs = dict(kwargs, mesh=make_mesh(2, 1))
    for make in (jstreams.DeviceStreamResampler,
                 lambda *a, **k: DeviceStreamResampler(*a, device="cpu",
                                                       **k)):
        with pytest.raises(exc, match=match):
            make(2, 64, 380, 44100, 48000, 0, IBL, **kwargs)


def test_precise_is_dropped_for_float64_data():
    """precise=True on float64 data is the float64 engine, as in JAX
    (streams.py:616): the same samples, bitwise."""
    a = _engine(REDUCED, "f64")
    b = DeviceStreamResampler(*REDUCED, dtype=np.float64, precise=True,
                              device="cpu")
    b.advance_position(REDUCED[1] // 2)
    assert not b._precise
    n = _chunk(a)
    first, xs = _inputs(REDUCED, "f64", n, 15)
    for x in (first, *xs):
        oa, Ka = a.process(torch.from_numpy(x), n)
        ob, Kb = b.process(torch.from_numpy(x), n)
        assert Ka == Kb and torch.equal(oa, ob)


@pytest.mark.parametrize("precise", [True, "int8"], ids=["precise", "int8"])
def test_roundtrip_precise_matches_jax(precise):
    """roundtrip.roundtrip_diff_db(precise=...) against JAX's
    bench._measure_roundtrip_snr(seconds, precise) at a short length: the
    same signal through the same tier reads the same diff RMS (each dot
    is rounded once on both sides), here through small process_flat_out
    groups."""
    seconds = 1
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        ref = bench._measure_roundtrip_snr(seconds, precise)
    rt = roundtrip.roundtrip_diff_db(seconds, "cpu", chunk_target=1 << 13,
                                     precise=precise)
    f32 = roundtrip.roundtrip_diff_db(seconds, "cpu", chunk_target=1 << 13)
    assert rt["frames"] == f32["frames"]
    assert rt["calls"] > 4                              # groups ran
    assert abs(rt["diff_db"] - ref) <= 0.01
    assert rt["diff_db"] < f32["diff_db"] <= -130.0
