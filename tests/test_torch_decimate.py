"""The port's device decimate stage against JAX's, on the CPU.

``art_tpu_torch/ops/decimate_device.py``'s plain versions against
``art_tpu/ops/decimate_device.py`` function by function, the port's
``DeviceDecimator(device="cpu")`` against JAX's ``DeviceDecimator`` and the
host ``Decimator``, ``pipeline_chunk`` against JAX's (single device; with
the post filter cascade at its own bounds), and
the packed group form's container layout against its int64 plain version.
Inputs come from numpy seeds and go to both sides.  Every comparison is
bitwise -- dither, LCG states, codes, clip flags and counts, shaper states
and packed bytes are exact contracts -- but one: JAX's float64 shaped scan,
whose state XLA:CPU computes with FMAs; there the port is held bitwise to
the host decimator instead (test_quantize_shaped_equal)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from art_tpu.core import flags as JF
from art_tpu.engines.decimator import DeviceDecimator as JDeviceDecimator
from art_tpu.ops import decimate_device as jdd
from art_tpu.parallel.pipeline import pipeline_chunk as jpipeline_chunk
from art_tpu_torch.engines.decimator import Decimator as TDecimator
from art_tpu_torch.engines.decimator import DeviceDecimator
from art_tpu_torch.ops import decimate_device as dd
from art_tpu_torch.ops import decimate_kernel as dk
from art_tpu_torch.parallel import streams
from art_tpu_torch.parallel.pipeline import pipeline_chunk

def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _tables(n):
    return [_t(t.astype(np.int64)) for t in dd.dither_tables(n)]


def _gens(S, seed):
    """S uint32 states, both parities."""
    g = np.random.default_rng(seed).integers(0, 1 << 32, S, dtype=np.uint64)
    g[0] &= ~np.uint64(1)
    g[-1] |= np.uint64(1)
    return g.astype(np.uint32)


# ------------------------------------------------ the plain versions, bitwise
@pytest.mark.parametrize("n", [1, 7, 700, 4096])
def test_dither_tables_equal(n):
    for a, b in zip(dd.dither_tables(n), jdd.dither_tables(n)):
        assert a.dtype == b.dtype == np.uint32
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dither_type", [-1, 0, 1])
@pytest.mark.parametrize("n", [1, 7, 700])
def test_tpdf_dither_and_advance_equal(n, dither_type):
    gens = _gens(5, n + dither_type)
    jd, jseq = jdd.tpdf_dither_dev(jnp.asarray(gens), *map(
        jnp.asarray, jdd.dither_tables(n)), dither_type, n)
    d, seq = dd.tpdf_dither_dev(_t(gens.astype(np.int64)), *_tables(n),
                                dither_type, n)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(seq.numpy(), np.asarray(jseq))
    for K in sorted({0, 1, n}):
        want = jdd.advance_states(jnp.asarray(gens), jseq, jnp.int32(K))
        got = dd.advance_states(_t(gens.astype(np.int64)), seq, K)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _frames(n, S, seed, dtype, scale=0.7):
    rng = np.random.default_rng(seed)
    return np.clip(rng.standard_normal((n, S)) * scale, -1.3,
                   1.3).astype(dtype)


def _dither(n, S, seed):
    gens = _gens(S, seed)
    return np.asarray(jdd.tpdf_dither_dev(jnp.asarray(gens), *map(
        jnp.asarray, jdd.dither_tables(n)), -1, n)[0]).T


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("scaler", [32768.0, 32768.0 * 1.37])
@pytest.mark.parametrize("dithered", [False, True], ids=["plain", "dither"])
def test_quantize_flat_equal(dtype, scaler, dithered):
    n, S = 500, 3
    x = _frames(n, S, 1, dtype)
    d = _dither(n, S, 2) if dithered else None
    fb = (np.random.default_rng(3).standard_normal(S) * 0.3).astype(dtype)
    s = dtype(scaler)
    jo, jc = jdd.quantize_flat_dev(jnp.asarray(x), None if d is None else
                                   jnp.asarray(d), s, jnp.asarray(fb),
                                   32767, -32768)
    o, c = dd.quantize_flat_dev(_t(x), None if d is None else _t(d), s,
                                _t(fb), 32767, -32768)
    np.testing.assert_array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    assert c.any()


def _shaper(flags, rate, dtype):
    """A host shaper (engines.biquad.Biquad) with seeded histories."""
    sh = TDecimator(3, 16, 2, 1.0, rate, flags, dtype=dtype).noise_shaper
    rng = np.random.default_rng(rate)
    sh.xh = (rng.standard_normal((4, 3)) * 0.4).astype(dtype)
    sh.yh = (rng.standard_normal((4, 3)) * 0.4).astype(dtype)
    return sh


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("curve", ["ath", "2nd"])
@pytest.mark.parametrize("K", [0, 1, 157, 300])
def test_quantize_shaped_equal(dtype, curve, K):
    """float32: bitwise JAX's scan.  float64: bitwise the host decimator's
    scan (the reference's op order); JAX's float64 scan differs from both
    by an ulp in its state (XLA:CPU contracts float64 products into FMAs:
    ``_mul_for``'s barrier covers float32 only), so against JAX the codes
    and clip flags are exact and the state within 1e-9 (code units: the
    ulp grows through the resonant ATH shaper, ~8e-12 after 157 frames)."""
    n, S = 300, 3
    flags = (JF.SHAPING_ENABLED | JF.SHAPING_ATH_CURVE if curve == "ath"
             else JF.SHAPING_ENABLED | JF.SHAPING_2ND_ORDER)
    sh = _shaper(flags, 44100, dtype)
    a, b = np.asarray(sh.a, dtype), np.asarray(sh.b, dtype)
    xh, yh = sh.xh.copy(), sh.yh.copy()
    x = _frames(n, S, 4, dtype)
    x[K:] = np.nan
    d = _dither(n, S, 5)
    fb = (np.random.default_rng(6).standard_normal(S) * 0.2).astype(dtype)
    s = dtype(32768.0 * 1.37)
    want = jdd.quantize_shaped_dev(jnp.asarray(x), jnp.asarray(d), s,
                                   jnp.asarray(fb), a, b, jnp.asarray(xh),
                                   jnp.asarray(yh), jnp.int32(K), 32767,
                                   -32768)
    got = dd.quantize_shaped_dev(_t(x), _t(d), s, _t(fb), _t(a), _t(b),
                                 _t(xh), _t(yh), K, 32767, -32768)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    if dtype == np.float32:
        for g, w in zip(got[2:], want[2:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        return
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-9)
    if K:
        outv, clipped, hfb = dk.quantize_shaped_numpy(
            x[:K], d[:K], s, fb, sh, 32767, -32768)
        np.testing.assert_array_equal(got[0][:K].numpy(), outv)
        assert int(got[1].sum()) == clipped
        for g, w in zip(got[2:], (hfb, sh.xh, sh.yh)):
            np.testing.assert_array_equal(g.numpy(), w)


PACKS = [(bits, nb) for bits in range(4, 25)
         for nb in range((bits + 7) // 8, 5)]


@pytest.mark.parametrize("bits,nbytes", PACKS,
                         ids=[f"{b}in{n}" for b, n in PACKS])
def test_pack_bytes_equal(bits, nbytes):
    hi = (1 << (bits - 1)) - 1
    outv = np.random.default_rng(bits).integers(~hi, hi + 1, (64, 3)) \
        .astype(np.int32)
    outv[0] = [~hi, hi, 0]
    want = jdd.pack_bytes_dev(jnp.asarray(outv), bits, nbytes)
    got = dd.pack_bytes_dev(_t(outv), bits, nbytes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------------------- DeviceDecimator
CASES = [
    (JF.DITHER_HIGHPASS | JF.SHAPING_ATH_CURVE, 16, 2, 44100),
    (JF.DITHER_FLAT, 16, 2, 48000),
    (JF.DITHER_LOWPASS | JF.SHAPING_2ND_ORDER, 8, 1, 32000),
    (0, 24, 3, 96000),
    (JF.DITHER_HIGHPASS, 20, 4, 44100),
]


@pytest.mark.parametrize("flags,bits,nbytes,rate", CASES,
                         ids=["hp-ath16", "flat16", "lp-2nd8", "none24",
                              "hp20in4"])
def test_device_decimator_equals_jax_and_host(flags, bits, nbytes, rate):
    """JAX's test_device_decimator_engine_bit_exact, with JAX's engine as
    a third leg; the ragged tails hold NaN past K."""
    rng = np.random.default_rng(3)
    ch = 2
    host = TDecimator(ch, bits, nbytes, 1.0, rate, flags, backend="numpy")
    jdev = JDeviceDecimator(ch, bits, nbytes, 1.0, rate, flags)
    dev = DeviceDecimator(ch, bits, nbytes, 1.0, rate, flags, device="cpu")
    for n, K in [(256, 256), (256, 100), (64, 64), (64, 0), (300, 1)]:
        x = (rng.random((n, ch)).astype(np.float32) - 0.5) * 1.7
        x[K:] = np.nan
        ph, hc = host.process_interleaved(x[:K])
        pj, jc = jdev.process_chunk(x, K)
        pd, tc = dev.process_chunk(x, K)
        assert tc == jc == hc, (n, K)
        np.testing.assert_array_equal(pd, pj)
        np.testing.assert_array_equal(pd, ph.reshape(K, ch * nbytes))
        for key, v in dev.state_dict().items():
            np.testing.assert_array_equal(v, jdev.state_dict()[key])


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_device_decimator_ragged_chunks_freeze_state(dtype):
    """JAX's test_device_quantize_ragged_chunks_freeze_state on the
    engine: two ragged chunks with NaN past K equal one host run over the
    valid frames."""
    rng = np.random.default_rng(11)
    flags = JF.DITHER_HIGHPASS | JF.SHAPING_ATH_CURVE
    k1, k2, pad = 333, 250, 77
    x1 = (rng.standard_normal((k1 + pad, 2)) * 0.5).astype(dtype)
    x2 = (rng.standard_normal((k2 + pad, 2)) * 0.5).astype(dtype)
    x1[k1:] = np.nan
    x2[k2:] = np.nan
    host = TDecimator(2, 16, 2, 1.0, 48000, flags, dtype=dtype)
    ph, hc = host.process_interleaved(np.concatenate([x1[:k1], x2[:k2]]))
    dev = DeviceDecimator(2, 16, 2, 1.0, 48000, flags, dtype=dtype,
                          device="cpu")
    p1, c1 = dev.process_chunk(_t(x1), k1)
    p2, c2 = dev.process_chunk(x2, k2)
    np.testing.assert_array_equal(np.concatenate([p1, p2]), ph)
    assert c1 + c2 == hc


def test_device_decimator_async_reads_a_strided_view():
    """process_chunk_async takes K1's [ch, capacity] output as its
    transpose, in place; rows past K pack code 0."""
    flags = JF.DITHER_HIGHPASS
    out = _t(_frames(2, 600, 8, np.float32).copy())          # [ch, cap]
    dev = DeviceDecimator(2, 16, 2, 1.0, 44100, flags, device="cpu")
    ref = DeviceDecimator(2, 16, 2, 1.0, 44100, flags, device="cpu")
    packed, clips = dev.process_chunk_async(out.T, 500)
    want, wc = ref.process_chunk(out.T.contiguous().numpy(), 500)
    np.testing.assert_array_equal(packed[:500].numpy(), want)
    assert int(clips) == wc
    assert not packed[500:].any()


@pytest.mark.parametrize("flags", [
    JF.DITHER_HIGHPASS | JF.SHAPING_ATH_CURVE, JF.DITHER_LOWPASS, 0],
    ids=["hp-ath", "lp", "none"])
def test_state_carried_across_both_ways(flags):
    """A JAX DeviceDecimator's state_dict loads into the port's and the
    stream continues bitwise, and the reverse."""
    rng = np.random.default_rng(9)
    xs = [(rng.random((256, 2)).astype(np.float32) - 0.5) * 1.5
          for _ in range(3)]
    ref = JDeviceDecimator(2, 16, 2, 1.0, 44100, flags)
    want = [ref.process_chunk(x, 200) for x in xs]
    for first, second in ((JDeviceDecimator, DeviceDecimator),
                          (DeviceDecimator, JDeviceDecimator)):
        a = first(2, 16, 2, 1.0, 44100, flags, **(
            {"device": "cpu"} if first is DeviceDecimator else {}))
        pa, ca = a.process_chunk(xs[0], 200)
        b = second(2, 16, 2, 1.0, 44100, flags, **(
            {"device": "cpu"} if second is DeviceDecimator else {}))
        b.load_state(a.state_dict())
        got = [(pa, ca)] + [b.process_chunk(x, 200) for x in xs[1:]]
        for (pg, cg), (pw, cw) in zip(got, want):
            assert cg == cw
            np.testing.assert_array_equal(pg, pw)


def test_device_decimator_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        DeviceDecimator(2, 16, 2, 1.0, 44100, JF.DITHER_HIGHPASS)


# ----------------------------------------------------------- pipeline_chunk
def _pipeline_inputs(S=8, M=3, L=2, nb=16, qn=4, hist_len=32, onehot=True,
                     seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((S, nb * M)) * 0.5).astype(np.float32)
    hist = (rng.standard_normal((S, hist_len)) * 0.5).astype(np.float32)
    if onehot:      # JAX's passthrough matrix: the resample is exact
        P = np.zeros((qn * M, L), np.float32)
        P[2, 0] = 1.0
        P[5, 1] = 1.0
    else:
        P = (rng.standard_normal((qn * M, L)) * 0.3).astype(np.float32)
    return x, hist, P


def _pipeline_kw(dec, M=3, L=2, nb=16, qn=4, hist_len=32):
    sh = dec.noise_shaper
    return dict(M=M, L=L, nb=nb, qn_pad=qn, qn_local=qn, hist_len=hist_len,
                scaler=float(dec.scaler), highclip=dec.highclip,
                lowclip=dec.lowclip,
                dither_type=dec.dither_type if dec.tpdf_generators is not None
                else None,
                shaper_a=None if sh is None else sh.a,
                shaper_b=None if sh is None else sh.b, output_bits=16,
                output_bytes=2)


PIPE = [JF.DITHER_HIGHPASS | JF.SHAPING_ATH_CURVE, JF.DITHER_FLAT,
        JF.SHAPING_2ND_ORDER | JF.SHAPING_ENABLED, 0]


@pytest.mark.parametrize("flags", PIPE, ids=["hp-ath", "flat", "2nd", "none"])
@pytest.mark.parametrize("K", [32, 23, 0])
def test_pipeline_chunk_equals_jax(flags, K):
    """The passthrough matrix (the resample exact on both sides): every
    output of the chunk bitwise, JAX's tuple order, power to the float32
    summation class."""
    S, nK = 8, 32
    dec = TDecimator(S, 16, 2, 1.0, 44100, flags)
    kw = _pipeline_kw(dec)
    x, hist, P = _pipeline_inputs(S)
    gens = dk.seed_generators(S)
    fb = np.zeros(S, np.float32)
    xh = yh = np.zeros((4, S), np.float32)
    want = jpipeline_chunk(
        jnp.asarray(x), jnp.asarray(hist), jnp.asarray(P), jnp.int32(8),
        jnp.int32(K), jnp.asarray(gens), jnp.asarray(fb), jnp.asarray(xh),
        jnp.asarray(yh), *map(jnp.asarray, jdd.dither_tables(nK)), **kw)
    got = pipeline_chunk(_t(x), _t(hist), _t(P), 8, K, gens, _t(fb),
                         _t(xh), _t(yh), **kw)
    names = ["packed", "hist", "gens", "fb", "xh", "yh", "clips"]
    for name, g, w in zip(names, got, want):
        g = dd.states_numpy(g) if name == "gens" else g.numpy()
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    np.testing.assert_allclose(float(got[7]), float(want[7]), rtol=1e-6)


def test_pipeline_chunk_decimate_stage_equals_jax_chain():
    """A dense random matrix: the resampled samples differ from JAX's at
    the float32 contraction floor, so the new history and LCG states are
    held bitwise against JAX's chunk, and the decimate stage bitwise
    against JAX's stages run on the port's own resampled samples."""
    from art_tpu_torch.ops import fixed_step as k1
    S, nK, K = 8, 32, 29
    flags = JF.DITHER_HIGHPASS | JF.SHAPING_ATH_CURVE
    dec = TDecimator(S, 16, 2, 1.0, 44100, flags)
    kw = _pipeline_kw(dec)
    x, hist, P = _pipeline_inputs(S, onehot=False, seed=4)
    gens = dk.seed_generators(S)
    z = np.zeros((4, S), np.float32)
    want = jpipeline_chunk(
        jnp.asarray(x), jnp.asarray(hist), jnp.asarray(P), jnp.int32(5),
        jnp.int32(K), jnp.asarray(gens), jnp.zeros(S, jnp.float32),
        jnp.asarray(z), jnp.asarray(z),
        *map(jnp.asarray, jdd.dither_tables(nK)), **kw)
    got = pipeline_chunk(_t(x), _t(hist), _t(P), 5, K, gens,
                         torch.zeros(S), _t(z), _t(z), **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(dd.states_numpy(got[2]),
                                  np.asarray(want[2]))
    out = k1.fixed_step(_t(hist), _t(x), _t(P), 5, K, torch.zeros(()),
                        M=3, L=2, nb=16, qn=4, hist_len=32)[1]
    samples = jnp.asarray(out.T.numpy())
    d, seq = jdd.tpdf_dither_dev(jnp.asarray(gens), *map(
        jnp.asarray, jdd.dither_tables(nK)), -1, nK)
    sh = dec.noise_shaper
    outv, clipf, fb, xh, yh = jdd.quantize_shaped_dev(
        samples, d.T, kw["scaler"], jnp.zeros(S, jnp.float32), sh.a, sh.b,
        jnp.asarray(z), jnp.asarray(z), jnp.int32(K), 32767, -32768)
    np.testing.assert_array_equal(
        got[0].numpy(), np.asarray(jdd.pack_bytes_dev(outv, 16, 2)))
    assert int(got[6]) == int(jnp.sum(clipf))
    for g, w in zip(got[3:6], (fb, xh, yh)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pipeline_chunk_refuses_what_is_not_ported():
    S = 8
    dec = TDecimator(S, 16, 2, 1.0, 44100, 0)
    x, hist, P = _pipeline_inputs(S)
    args = (_t(x), _t(hist), _t(P), 8, 32, dk.seed_generators(S),
            torch.zeros(S), torch.zeros(4, S), torch.zeros(4, S))
    with pytest.raises(NotImplementedError, match="item 11"):
        pipeline_chunk(*args, **_pipeline_kw(dec), taps_axis="taps")
    with pytest.raises(NotImplementedError, match="item 11"):
        pipeline_chunk(*args, **_pipeline_kw(dec), streams_axis="streams")


@pytest.mark.parametrize("flags", [JF.DITHER_HIGHPASS,
                                   JF.DITHER_HIGHPASS | JF.SHAPING_ATH_CURVE],
                         ids=["hp", "hp-ath"])
@pytest.mark.parametrize("K", [1024, 700, 3, 0])
def test_pipeline_chunk_post_filter_matches_jax(flags, K):
    """The -p post filter between the resample and the decimate stage
    (the passthrough matrix, so both sides filter the same samples): the
    history and LCG states bitwise, the 16-bit codes within the
    shaped-noise floor of the port's other device tests (the two float64
    solves round a sample to its other float32 neighbour now and then),
    clip counts equal, the filter state within 1e-12 and the power taken
    after the filter."""
    from art_tpu.ops import biquad_kernel as jbk
    from art_tpu_torch.engines.biquad import Biquad, biquad_lowpass
    from art_tpu_torch.ops import biquad_kernel as bk
    S, M, L, nb = 6, 3, 2, 512
    nK = nb * L
    dec = TDecimator(S, 16, 2, 1.0, 48000, flags)
    kw = _pipeline_kw(dec, M=M, L=L, nb=nb)
    x, hist, P = _pipeline_inputs(S, M=M, L=L, nb=nb, seed=9)
    x *= 2.2                                  # some frames clip
    q = Biquad.init(biquad_lowpass(0.45 * 44100 / 48000), 1.0, S)
    a, b = np.asarray(q.a, np.float64), np.asarray(q.b, np.float64)
    rng = np.random.default_rng(10)
    state = tuple(rng.standard_normal((4, S)) * 0.1 for _ in range(4))
    gens = dk.seed_generators(S)
    sh = dec.noise_shaper
    z = np.zeros((4, S), np.float32)
    xh, yh = (z, z) if sh is None else (sh.xh, sh.yh)
    fb = np.zeros(S, np.float32)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    jt = jbk.iir_tables(b)
    want = jpipeline_chunk(
        jnp.asarray(x), jnp.asarray(hist), jnp.asarray(P), jnp.int32(8),
        jnp.int32(K), jnp.asarray(gens), jnp.asarray(fb), jnp.asarray(xh),
        jnp.asarray(yh), *map(jnp.asarray, jdd.dither_tables(nK)),
        post_bq=((ja, jb), (ja, jb)),
        bq_state=tuple(jnp.asarray(v) for v in state),
        post_bq_tables=(jt, jt), **kw)
    got = pipeline_chunk(_t(x), _t(hist), _t(P), 8, K, gens, _t(fb), _t(xh),
                         _t(yh), post_bq=((a, b), (a, b)), bq_state=state,
                         **kw)
    assert len(got) == len(want) == 9
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(dd.states_numpy(got[2]),
                                  np.asarray(want[2]))
    codes = [np.asarray(p).view("<i2").astype(np.int32)
             for p in (got[0].numpy(), want[0])]
    diff = np.abs(codes[0] - codes[1])
    assert diff.max() <= 12 and diff.mean() < 2.0
    assert not codes[0][K:].any()
    assert int(got[6]) == int(want[6])
    assert K < 700 or int(got[6]) > 0
    for g, w in zip(got[8], want[8]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-12)
    np.testing.assert_allclose(float(got[7]), float(want[7]), rtol=1e-6)
    # the power of the filtered samples, not of the resampled ones
    from art_tpu_torch.ops import fixed_step as k1
    out = k1.fixed_step(_t(hist), _t(x), _t(P), 8, K, torch.zeros(()), M=M,
                        L=L, nb=nb, qn=4, hist_len=32)[1]
    t = bk.iir_tables(b, B=bk.KERNEL_BLOCK)
    y = bk._cascade2_step_T(out, a, b, *state[:2], a, b, *state[2:], K, t,
                            t)[0]
    assert torch.equal(got[7], torch.sum(y * y))


# ------------------------------------------- the packed group form's layout
def _int64_quantize_pack(out, scaler, bits, nbytes):
    hi = (1 << (bits - 1)) - 1
    return streams._quantize_pack(
        out, scaler, torch.zeros((), dtype=torch.int32), highclip=hi,
        lowclip=~hi, output_bits=bits, output_bytes=nbytes)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("gain", [1.0, 1.37], ids=["pow2", "other"])
@pytest.mark.parametrize("bits,nbytes", [(16, 2), (8, 1), (24, 4), (12, 2)])
def test_container_layout_equals_int64_quantize_pack(dtype, gain, bits,
                                                     nbytes):
    """decimate_flat's per-channel container (what process_flat_packed's
    kernel writes on a card) against _quantize_pack's int64 plain version,
    bytes and clip counts, with a power-of-two scaler and another."""
    scaler = gain * (1 << (bits - 1))
    out = _t(_frames(1000, 3, bits, dtype, 0.8).T.copy())        # [ch, n]
    want, wc = _int64_quantize_pack(out, scaler, bits, nbytes)
    hi = (1 << (bits - 1)) - 1
    got, gc, _ = dd.decimate_flat(out.T, out.shape[1], scaler=scaler,
                                  highclip=hi, lowclip=~hi, output_bits=bits,
                                  output_bytes=nbytes, planar=True)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    assert int(gc) == int(wc) > 0
    # and the interleaved layout is the same bytes frame by frame
    inter, ic, _ = dd.decimate_flat(out.T, out.shape[1], scaler=scaler,
                                    highclip=hi, lowclip=~hi,
                                    output_bits=bits, output_bytes=nbytes)
    assert torch.equal(inter.view(-1, 3, nbytes).transpose(0, 1)
                       .reshape(3, -1), got.view(torch.uint8))


# ------------------------------------------- the kernels' host-side geometry
def _lcg_steps(g: int, steps: int) -> int:
    """The dither LCG stepped ``steps`` times in plain Python."""
    for _ in range(steps):
        g = (((g << 4) - g) ^ 1) & 0xFFFFFFFF
    return g


@pytest.mark.parametrize("pairs", [0, 1, 2, 5, 80, 999, 4097])
def test_lcg_pair_map_equals_stepping(pairs):
    """2*pairs steps take an even state to a*g + b and an odd one to a*g -
    b: the map (decimate_geometry.h's pair_power) the flat kernel's lanes
    and the shaped kernel's producers take instead of stepping."""
    a, b = dd.lcg_pair_map(pairs)
    for g in _gens(6, pairs).tolist():
        want = _lcg_steps(g, 2 * pairs)
        sign = -1 if g & 1 else 1
        assert (a * g + sign * b) & 0xFFFFFFFF == want


@pytest.mark.parametrize("n,S,sms,itemsize", [
    (1 << 22, 2, 132, 4), (1 << 22, 2, 132, 8), (4565280 * 8, 2, 132, 4),
    (17760, 2, 132, 4), (100_003, 6, 132, 4), (1 << 20, 33, 132, 8),
    (300, 4097, 132, 4), (100_003, 1, 1, 4), (50_000, 6, 1, 8),
    (50_001, 3, 2, 4), (3, 1, 132, 4)])
def test_flat_geometry_strides_keep_channel_and_parity(n, S, sms, itemsize):
    """The flat kernel's grid (decimate_geometry.h, the code its launch
    runs): every element is some lane's; a lane's stride of frames*S
    elements keeps each of its slots on its channel and moves it an even
    number of frames, whose 5*frames LCG steps are the map (a, b) (checked
    against plain stepping where that is short).  The design: runs of 8
    elements in CTAs of 256, at least 4 CTAs an SM for float32 and 3 for
    float64 once the lanes stride."""
    dtype = torch.float32 if itemsize == 4 else torch.float64
    geo = dd.library_geometry(n, S, n, dtype, sms)["flat"]
    assert (geo["threads"], geo["run"]) == (256, 8)
    lanes = geo["ctas"] * geo["threads"]
    runs = -(-n * S // geo["run"])
    per_sm = {4: 4, 8: 3}[itemsize]
    if geo["frames"] == 0:
        # one run a lane, or lanes that find each run's states by jumping
        assert lanes >= runs or geo["ctas"] == sms * per_sm
        return
    assert geo["ctas"] >= sms * per_sm and lanes < runs
    assert lanes * geo["run"] == geo["frames"] * S
    assert geo["frames"] % 2 == 0
    assert (geo["a"], geo["b"]) == dd.lcg_pair_map(5 * geo["frames"] // 2)
    if 5 * geo["frames"] <= 200_000:
        for g in _gens(4, S).tolist():
            sign = -1 if g & 1 else 1
            assert (geo["a"] * g + sign * geo["b"]) & 0xFFFFFFFF == \
                _lcg_steps(g, 5 * geo["frames"])


def _producer_share(cb: int, producers: int) -> int:
    """The shaped kernel's producer threads a channel in a CTA of ``cb``
    channels (decimate.cu's tpc)."""
    tpc = 1
    while 2 * tpc * cb <= producers:
        tpc *= 2
    return tpc


def _unsplit_geometry(n, S, K, itemsize):
    """The shaped kernel's launch at S <= 8 channels, as it was before the
    many-channel split: one CTA of 128 threads (64 producers), the largest
    power-of-two tile in [64, 2048] whose 3 ring stages of xs and d and 3
    copy stages fit 200 KB, zero-tail CTAs of 8 x 128 slots (at most
    64)."""
    per_frame = 9 * S * itemsize
    tile = 2048
    while tile > 64 and 128 + tile * per_frame > 200 * 1024:
        tile //= 2
    covered = -(-K // tile) * tile
    rest = (n - covered) * S if covered < n else 0
    return dict(groups=1, zero=min(-(-rest // 1024), 64), tile=tile,
                stages=3, threads=128, smem=128 + tile * per_frame,
                chans=S, producers=64, split=0)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("S", [1, 2, 6, 16, 17, 32, 33, 64, 2048, 4097])
def test_shaped_geometry_fits(S, itemsize):
    """The shaped kernel's launch (decimate_geometry.h) on 132 SMs: up to
    8 channels exactly the one-CTA launch it had before the split; above,
    CTAs of 8 or 16 channels in quads of 4 warps (one a chain or idle,
    three workers), every channel with at least 8 producer threads and 4
    consumer threads, an SM holding at least one CTA within its 228 KB of
    shared memory (1 KB a CTA the runtime's) and its 2,048 threads, and
    the channel groups in one wave of those up to 2,112 channels; always a
    power-of-two tile that is a
    multiple of every channel's producer share, shared memory within the
    200 KB budget, and zero-tail CTAs only where frames past the last tile
    holding a frame < K exist."""
    dtype = torch.float32 if itemsize == 4 else torch.float64
    sms = 132
    for n, K in ((17760, 17760), (1 << 22, 1 << 22), (200_000, 1000),
                 (5000, 0), (0, 0)):
        geo = dd.library_geometry(n, S, K, dtype, sms)["shaped"]
        tile, chans, producers = geo["tile"], geo["chans"], geo["producers"]
        if S <= 8:
            assert geo == _unsplit_geometry(n, S, K, itemsize)
            continue
        threads = geo["threads"]
        consumers = threads // 4 * 3 - producers
        assert threads % 128 == 0 and threads <= 256 and geo["split"] == 1
        assert producers >= 8 * chans and consumers >= 4 * chans
        assert producers % 32 == 0 and consumers % 32 == 0
        assert geo["groups"] == -(-S // chans) and chans in (8, 16)
        assert tile & (tile - 1) == 0 and 64 <= tile <= 2048
        assert geo["smem"] == 128 + tile * min(S, chans) * itemsize * (
            2 * geo["stages"] + 3) <= 200 * 1024
        last = S - (geo["groups"] - 1) * chans
        for cb in {chans, last}:
            tpc = _producer_share(cb, producers)
            assert tpc >= 8 and tile % tpc == 0
        fits = min(228 * 1024 // (geo["smem"] + 1024), 2048 // threads)
        assert fits >= 1
        if S <= 16 * sms:
            assert geo["groups"] <= fits * sms
        covered = -(-K // tile) * tile
        assert (geo["zero"] > 0) == (covered < n) and geo["zero"] <= 64


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_shaped_split_starts_where_the_counter_says(dtype):
    """``launches["decimate_shaped_split"]`` counts a launch where the
    geometry reports ``split``: exactly the launches whose geometry is not
    the one-CTA launch, on any SM count and at any length."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    for sms in (1, 132):
        for S in [*range(1, 41), 1055, 1056, 1057, 2112, 2113, 4097]:
            geo = dd.library_geometry(3000, S, 1000, dtype, sms)["shaped"]
            unsplit = _unsplit_geometry(3000, S, 1000, itemsize)
            split = geo.pop("split")
            assert split == dd._splits(S)
            assert split == (geo != {k: v for k, v in unsplit.items()
                                     if k != "split"})


def test_geometry_refuses_what_the_kernels_do_not_take():
    """The geometry's C interface returns an error, which library_geometry
    raises, for what the kernels' entry points refuse."""
    for n, S, K in ((-1, 2, 0), (10, 0, 0), (10, 2, 11), (10, 2, -1)):
        with pytest.raises(ValueError):
            dd.library_geometry(n, S, K, torch.float32, 132)
    with pytest.raises(ValueError):
        dd.library_geometry(10, 2, 10, torch.float32, 0)


def test_float32_round_half_up_reformulation():
    """The kernels' float32 round half up, fv + (v - fv >= 0.5) with fv =
    floorf(v) and err = fl - code, against the quantizer's floor(float64(v)
    + 0.5): the same integer for every float32 v (halves, their
    neighbours, large, tiny, signed zeros, infinities), and the same error
    term bit for bit."""
    f32 = np.float32
    rng = np.random.default_rng(11)
    halves = np.arange(-70000, 70000, dtype=np.float64) + 0.5
    v = np.concatenate([
        rng.standard_normal(200_000) * 40000, halves,
        np.nextafter(halves.astype(f32), f32(np.inf)),
        np.nextafter(halves.astype(f32), f32(-np.inf)),
        [0.0, -0.0, 1e-30, -1e-30, 2 ** -25, -2 ** -25, 0.49999997,
         -0.49999997, 8388607.5, -8388608.5, 2 ** 23, 2 ** 24 - 1, 2 ** 24,
         3e38, -3e38, np.inf, -np.inf]]).astype(f32)
    with np.errstate(invalid="ignore"):
        fv = np.floor(v)
        up = (v - fv) >= f32(0.5)
        fl = np.where(up, fv + f32(1), fv)
    want = np.floor(v.astype(np.float64) + 0.5).astype(f32)
    assert fl.dtype == want.dtype == f32
    np.testing.assert_array_equal(fl, want)           # as numbers: -0 == 0
    code = (v - rng.uniform(-1, 1, v.size).astype(f32)).astype(f32)
    with np.errstate(invalid="ignore"):
        err = np.where(up, (fv + f32(1)) - code, fv - code).astype(f32)
        err_want = (want - code).astype(f32)
    finite = np.isfinite(err_want)
    np.testing.assert_array_equal(err[finite].view(np.int32),
                                  err_want[finite].view(np.int32))


@pytest.mark.parametrize("dither_type", [-1, 0, 1])
def test_dither_reformulation_equals_plain_draw(dither_type):
    """The kernels' dither, T(m) * 2^-31 with m the int32 of (first >> 1)
    + (r5 >> 1) - 2^31, equals tpdf_dither_dev's float64 draw rounded to
    float32 and its float64 draw, bit for bit."""
    n, S = 500, 6
    gens = _gens(S, 7 + dither_type)
    d, seq = dd.tpdf_dither_dev(_t(gens.astype(np.int64)), *_tables(n),
                                dither_type, n)
    seq = seq.numpy().astype(np.uint32)
    g0 = np.concatenate([gens[:, None], seq[:, 4:5 * n - 1:5]], axis=1)
    r2, r5 = seq[:, 1::5], seq[:, 4::5]
    first = {-1: ~g0, 1: g0}.get(dither_type, ~r2)
    total = (first >> np.uint32(1)) + (r5 >> np.uint32(1))     # < 2^32
    m = (total ^ np.uint32(1 << 31)).view(np.int32)
    got32 = m.astype(np.float32) * np.float32(2.0 ** -31)
    got64 = m.astype(np.float64) * 2.0 ** -31
    np.testing.assert_array_equal(got32.view(np.int32),
                                  d.numpy().astype(np.float32).view(np.int32))
    np.testing.assert_array_equal(got64.view(np.int64),
                                  d.numpy().view(np.int64))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_chain_probe_reference_is_the_shaped_quantizer(dtype):
    """The chain probe's plain version (what the probe kernel must equal on
    a card) is quantize_shaped_dev's scan on a constant scaled sample and
    dither, state bitwise."""
    sh = _shaper(JF.SHAPING_ENABLED | JF.SHAPING_ATH_CURVE, 48000,
                 np.float32 if dtype == torch.float32 else np.float64)
    npt = np.float32 if dtype == torch.float32 else np.float64
    xs, d, f = npt(1234.567), npt(0.3), npt(0.01)
    values = [*sh.a, *sh.b, xs, d, f, *sh.xh[:, 0], *sh.yh[:, 0]]
    K = 300
    got = dd.chain_probe_reference(values, K, dtype)
    v = dd._probe_values(values, dtype)
    t = lambda a: torch.from_numpy(np.asarray(a, npt))
    _, _, fb, xh, yh = dd.quantize_shaped_dev(
        torch.full((K, 1), float(v[10]), dtype=dtype),
        torch.full((K, 1), float(v[11]), dtype=torch.float64), 1.0,
        t(v[12:13]), t(v[0:5]), t(v[5:10]), t(v[13:17, None]),
        t(v[17:21, None]), K, 1 << 30, -(1 << 30))
    want = np.concatenate([fb.numpy(), xh.numpy()[:, 0], yh.numpy()[:, 0]])
    np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8))
