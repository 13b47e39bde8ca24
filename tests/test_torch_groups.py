"""The port's group-dispatch forms (process_scan, process_flat,
process_flat_out, process_flat_packed; device="cpu", the plain chunk step)
held against the JAX engine's and against the port's own sequential
process() on the same numpy inputs.

Against JAX: Ks and positions exactly equal, samples within 1e-5 abs
(float32 contractions in different orders), packed bytes and clip counts
exactly equal when both quantize the same float32 samples.  Against the
port's sequential process(): outputs, history, power accumulator and
positions bitwise equal (the group forms run the same per-chunk
contraction at the same shapes and sum the power chunk by chunk)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from art_tpu.core.flags import (BLACKMAN_HARRIS, INCLUDE_LOWPASS,
                                SUBSAMPLE_INTERPOLATE)
from art_tpu.parallel import streams as jstreams
from art_tpu_torch import DeviceStreamResampler
from art_tpu_torch.ops import fixed_step as k1
from art_tpu_torch.parallel import streams as tstreams

IB = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS
IBL = IB | INCLUDE_LOWPASS
REDUCED = (2, 64, 380, 44100, 48000, 0, IBL)     # L=160, M=147, qn=2
PRESET1 = (1, 48, 48, 44100, 48000, 0, IB)       # interpolated, Lp/Mp 160/147
DYADIC = (1, 48, 48, 5000, 256000, 0, IB)        # interpolated, period exact
G = 3


def _engines(ctor, count=2):
    """(jax engine, port engines...), all advanced by half the taps."""
    engs = [jstreams.DeviceStreamResampler(*ctor)] + [
        DeviceStreamResampler(*ctor, device="cpu") for _ in range(count)]
    for e in engs:
        e.advance_position(ctor[1] // 2)
    return engs


def _chunk(eng):
    """An M-multiple chunk of 40 periods or more, G of them covering the
    history."""
    return max(40, -(-eng.num_samples // (G * eng.M))) * eng.M


def _noise(rng, *shape):
    return rng.normal(0, 0.5, shape).astype(np.float32)


def _sequential(t, xs, acc):
    """G process() calls on the port: (outs, Ks, acc)."""
    outs, Ks = [], []
    for x in xs:
        o, K, acc = t.process(torch.from_numpy(x), x.shape[1], acc)
        outs.append(o)
        Ks.append(K)
    return outs, Ks, acc


def _same_state(a, b):
    assert a.get_position() == b.get_position()
    assert (a.output_offset, a.input_index) == (b.output_offset,
                                                b.input_index)
    np.testing.assert_array_equal(np.asarray(a.hist), np.asarray(b.hist))


@pytest.mark.parametrize("stats", [False, True])
@pytest.mark.parametrize("ctor,n", [
    (REDUCED, "M"),          # static plan in JAX
    (REDUCED, 2000),         # mixed plans: JAX's stacked-bank scan
    (PRESET1, "M"),          # interpolated, repeating pattern
    (PRESET1, 1000),         # interpolated, per-chunk patterns
], ids=["reduced-static", "reduced-mixed", "interp-static", "interp-mixed"])
def test_process_scan_matches_jax_and_sequential(ctor, n, stats):
    j, t, s = _engines(ctor)
    n = _chunk(t) if n == "M" else n
    rng = np.random.default_rng(7)
    ch = ctor[0]
    xs = _noise(rng, G, ch, n)
    outs_j, Ks_j, acc_j = j.process_scan(jnp.asarray(xs), n,
                                         jnp.zeros((), jnp.float32))
    outs_t, Ks_t, acc_t = t.process_scan(torch.from_numpy(xs), n,
                                         torch.zeros(()), stats=stats)
    outs_s, Ks_s, acc_s = _sequential(s, xs, torch.zeros(()))
    assert isinstance(Ks_t, np.ndarray)
    assert list(Ks_t) == list(Ks_j) == Ks_s
    assert t.get_position() == j.get_position()
    assert float(acc_t) == pytest.approx(float(acc_j), rel=1e-5)
    _same_state(t, s)
    assert torch.equal(acc_t, acc_s)
    if stats:
        assert outs_t is None
        return
    outs_j = np.asarray(outs_j)
    assert tuple(outs_t.shape) == outs_j.shape
    for g, K in enumerate(Ks_s):
        assert np.abs(outs_t[g, :, :K].numpy() - outs_j[g, :, :K]).max() \
            <= 1e-5
        assert torch.equal(outs_t[g, :, :outs_s[g].shape[1]], outs_s[g])
        assert not outs_t[g, :, K:].any()


def test_process_scan_without_acc_and_stats_guard():
    j, t = _engines(REDUCED, 1)
    xs = _noise(np.random.default_rng(8), G, 2, 1000)
    outs_j, Ks_j = j.process_scan(jnp.asarray(xs), 1000)
    outs_t, Ks_t = t.process_scan(xs, 1000)
    assert list(Ks_t) == list(Ks_j)
    assert np.abs(outs_t.numpy() - np.asarray(outs_j)).max() <= 1e-5
    with pytest.raises(ValueError, match="stats=True"):
        t.process_scan(xs, 1000, stats=True)


def test_process_scan_interp_tie_fallback_matches_sequential(monkeypatch):
    """A chunk failing the float64-tie oracle sends the whole scan through
    sequential process() (which splits that chunk): same Ks, samples and
    state as an engine that met the same forced tie chunk by chunk."""
    _, a, b = _engines(PRESET1)
    xs = _noise(np.random.default_rng(9), G, 1, 1500)
    orig = DeviceStreamResampler._pattern_safe
    fired = {}

    def flaky(self, *args, **kw):
        if fired.get(id(self), 0) < 1:
            fired[id(self)] = 1
            return False
        return orig(self, *args, **kw)

    monkeypatch.setattr(DeviceStreamResampler, "_pattern_safe", flaky)
    outs_a, Ks_a, acc_a = _sequential(a, xs, torch.zeros(()))
    outs_b, Ks_b, acc_b = b.process_scan(xs, 1500, torch.zeros(()))
    assert list(Ks_b) == Ks_a
    for g in range(G):
        assert torch.equal(outs_b[g, :, :outs_a[g].shape[1]], outs_a[g])
    assert torch.equal(acc_a, acc_b)
    _same_state(a, b)


def _absorb_first(engs, rng, ch, n):
    """Push the non-periodic first chunk through every engine."""
    x = _noise(rng, ch, n)
    for e in engs:
        if isinstance(e, DeviceStreamResampler):
            e.process(torch.from_numpy(x), n)
        else:
            e.process(jnp.asarray(x), n)


@pytest.mark.parametrize("ctor", [REDUCED, DYADIC, PRESET1],
                         ids=["reduced", "interp-dyadic", "interp-preset1"])
def test_process_flat_matches_jax_and_sequential(ctor):
    """Two groups: the port's process_flat against JAX's (both accept the
    same groups, or both reject them with the state unchanged) and against
    sequential process(), bitwise in history, acc and position."""
    j, t, s = _engines(ctor)
    ch, n = ctor[0], _chunk(t)
    rng = np.random.default_rng(10)
    _absorb_first((j, t, s), rng, ch, n)
    acc_j, acc_t = jnp.zeros((), jnp.float32), torch.zeros(())
    acc_s = torch.zeros(())
    for _ in range(2):
        xs = _noise(rng, G, ch, n)
        flat = np.concatenate(list(xs), axis=1)
        state = [(e.output_offset, e.input_index) for e in (j, t)]
        try:
            Ks_j, acc_j = j.process_flat(jnp.asarray(flat), n, acc_j)
        except ValueError:
            Ks_j = None
            assert (j.output_offset, j.input_index) == state[0]
        if Ks_j is None:
            with pytest.raises(ValueError, match="periodic"):
                t.process_flat(torch.from_numpy(flat), n, acc_t)
            assert (t.output_offset, t.input_index) == state[1]
            _, Ks_j, acc_j = j.process_scan(jnp.asarray(xs), n, acc_j,
                                            stats=True)
            _, Ks_t, acc_t = t.process_scan(xs, n, acc_t, stats=True)
        else:
            Ks_t, acc_t = t.process_flat(torch.from_numpy(flat), n, acc_t)
        _, Ks_s, acc_s = _sequential(s, xs, acc_s)
        assert list(Ks_t) == list(Ks_j) == Ks_s
        assert t.get_position() == j.get_position()
        assert float(acc_t) == pytest.approx(float(acc_j), rel=1e-5)
        assert torch.equal(acc_t, acc_s)
        _same_state(t, s)
    if ctor is not PRESET1:
        assert all(K == Ks_s[0] for K in Ks_s)


@pytest.mark.parametrize("ctor", [REDUCED, DYADIC],
                         ids=["reduced", "interp-dyadic"])
def test_process_flat_out_matches_jax_and_sequential(ctor):
    j, t, s = _engines(ctor)
    ch, n = ctor[0], _chunk(t)
    rng = np.random.default_rng(12)
    _absorb_first((j, t, s), rng, ch, n)
    xs = _noise(rng, G, ch, n)
    flat = np.concatenate(list(xs), axis=1)
    out_j, Ks_j = j.process_flat_out(jnp.asarray(flat), n)
    out_t, Ks_t = t.process_flat_out(torch.from_numpy(flat), n)
    outs_s, Ks_s, _ = _sequential(s, xs, torch.zeros(()))
    assert list(Ks_t) == list(Ks_j) == Ks_s
    assert tuple(out_t.shape) == np.asarray(out_j).shape == (ch, sum(Ks_s))
    assert np.abs(out_t.numpy() - np.asarray(out_j)).max() <= 1e-5
    assert torch.equal(out_t, torch.cat([o[:, :K] for o, K in
                                         zip(outs_s, Ks_s)], dim=1))
    _same_state(t, s)
    assert t.get_position() == j.get_position()


def _host_quantize(x, scaler, hi, lo):
    """The reference's double rounding on the host: code = fl32(x * fl32(
    scaler)), floor(float64(code) + 0.5), clip."""
    code = (x.astype(np.float64) * np.float64(np.float32(scaler))) \
        .astype(np.float32)
    ov = np.floor(code.astype(np.float64) + 0.5).astype(np.int64)
    return np.clip(ov, lo, hi), int(((ov > hi) | (ov < lo)).sum())


@pytest.mark.parametrize("scaler", [32768.0, 32768.0 * 1.5],
                         ids=["pow2", "gain1.5"])
def test_process_flat_packed_matches_sequential(scaler):
    """The packed bytes are the host quantization of sequential process()'s
    samples, packed little-endian 16-bit; the clip counts agree and the
    gain drives real clipping."""
    _, t, s = _engines(REDUCED)
    ch, n = 2, _chunk(t)
    rng = np.random.default_rng(13)
    _absorb_first((t, s), rng, ch, n)
    xs = 2.0 * _noise(rng, G, ch, n)
    flat = np.concatenate(list(xs), axis=1)
    packed, Ks, clips = t.process_flat_packed(
        torch.from_numpy(flat), n, torch.zeros((), dtype=torch.int32),
        scaler=scaler, highclip=32767, lowclip=-32768)
    outs_s, Ks_s, _ = _sequential(s, xs, torch.zeros(()))
    assert list(Ks) == Ks_s
    _same_state(t, s)
    samples = torch.cat([o[:, :K] for o, K in zip(outs_s, Ks_s)], 1).numpy()
    ov, nclip = _host_quantize(samples, scaler, 32767, -32768)
    assert packed.dtype == torch.uint16 and clips.dtype == torch.int32
    assert np.array_equal(packed.numpy().view(np.uint8),
                          ov.astype("<i2").view(np.uint8))
    assert int(clips) == nclip > 0


@pytest.mark.parametrize("bits,nbytes,scaler,hi,lo", [
    (8, 1, 128.0, 127, -128), (16, 2, 32768.0, 32767, -32768),
    (16, 2, 32768.0 * 1.37, 32767, -32768), (24, 4, 8388608.0, 8388607,
                                              -8388608),
    (20, 4, 524288.0 * 0.9, 524287, -524288), (12, 2, 2048.0, 2047, -2048)])
def test_packing_epilogue_bitwise_vs_jax(monkeypatch, bits, nbytes, scaler,
                                         hi, lo):
    """The port's quantize + pack epilogue and JAX's (the body of
    _chunk_group_static_packed, run eagerly with its group outputs replaced
    by the same float32 samples) give bitwise the same container and clip
    count, for 8-, 16- and 32-bit containers and scalers that are and are
    not powers of two."""
    rng = np.random.default_rng(bits + nbytes)
    ch, K = 2, 700
    samples = (1.2 * rng.standard_normal((ch, G * K))).astype(np.float32)
    samples[:, :8] = [0.5 / scaler, -0.5 / scaler, 1.5 / scaler, 0.0,
                      -0.0, 2.5 / scaler, -1.5 / scaler, 1.0]
    monkeypatch.setattr(jstreams, "_group_chunk_out",
                        lambda buf, P2, fracv, g, **kw:
                        jnp.asarray(samples[:, g * K:(g + 1) * K]))
    n, hist_len = 10, 4
    packed_j, clips_j, _ = jstreams._chunk_group_static_packed.__wrapped__(
        jnp.zeros((ch, hist_len), jnp.float32),
        jnp.zeros((ch, G * n), jnp.float32), None, None,
        scaler, jnp.zeros((), jnp.int32), start=0, K=K, G=G, n=n, M=1, L=1,
        nb=1, qn=1, hist_len=hist_len, highclip=hi, lowclip=lo,
        output_bits=bits, output_bytes=nbytes)
    packed_t, clips_t = tstreams._quantize_pack(
        torch.from_numpy(samples), scaler, torch.zeros((), dtype=torch.int32),
        highclip=hi, lowclip=lo, output_bits=bits, output_bytes=nbytes)
    packed_j = np.asarray(packed_j)
    assert packed_t.numpy().dtype == packed_j.dtype
    assert np.array_equal(packed_t.numpy(), packed_j)
    assert int(clips_t) == int(clips_j) > 0


def _group_args(method, n):
    return {"process_scan": lambda xs, flat: (xs, n, torch.zeros(())),
            "process_flat": lambda xs, flat: (flat, n, torch.zeros(())),
            "process_flat_out": lambda xs, flat: (flat, n),
            "process_flat_packed": lambda xs, flat: (
                flat, n, torch.zeros((), dtype=torch.int32))}[method]


GROUP_FORMS = ["process_scan", "process_flat", "process_flat_out",
               "process_flat_packed"]
PACK = dict(scaler=32768.0, highclip=32767, lowclip=-32768)


@pytest.mark.parametrize("method", GROUP_FORMS)
@pytest.mark.parametrize("ctor", [REDUCED, DYADIC],
                         ids=["reduced", "interp-dyadic"])
def test_failing_dispatch_rolls_state_back(monkeypatch, ctor, method):
    """A contraction that raises mid-group leaves position, history and
    consume/emit state as they were at the call's entry."""
    _, t = _engines(ctor, 1)
    ch, n = ctor[0], _chunk(t)
    rng = np.random.default_rng(14)
    _absorb_first((t,), rng, ch, n)
    xs = torch.from_numpy(_noise(rng, G, ch, n))
    flat = torch.cat(list(xs), dim=1)
    before = (t.output_offset, t.input_index, t.hist.clone())
    calls = []

    def boom(*a, **kw):
        calls.append(1)
        if len(calls) == 2 or method in ("process_flat_out",
                                         "process_flat_packed"):
            raise RuntimeError("dispatch failed")
        return orig(*a, **kw)

    name = "fixed_step" if method == "process_scan" else "fixed_step_window"
    orig = getattr(k1, name)
    monkeypatch.setattr(k1, name, boom)
    kwargs = PACK if method == "process_flat_packed" else {}
    with pytest.raises(RuntimeError, match="dispatch failed"):
        getattr(t, method)(*_group_args(method, n)(xs, flat), **kwargs)
    assert (t.output_offset, t.input_index) == before[:2]
    assert torch.equal(t.hist, before[2])


@pytest.mark.parametrize("method", GROUP_FORMS[1:])
def test_flat_forms_after_flush_emit_nothing(method):
    """FLUSHED latch (G == 0): no audio, zero Ks, no state advance."""
    _, t = _engines(REDUCED, 1)
    n = _chunk(t)
    t.process(torch.zeros((2, n)), n)
    t.flush()
    pos, hist = t.get_position(), t.hist.clone()
    flat = torch.ones((2, G * n))
    kwargs = PACK if method == "process_flat_packed" else {}
    r = getattr(t, method)(*_group_args(method, n)(None, flat), **kwargs)
    Ks = r[0] if method == "process_flat" else r[1]
    assert list(Ks) == [0] * G
    if method != "process_flat":
        assert r[0].shape == (2, 0)
    if method == "process_flat_packed":
        assert r[0].dtype == torch.uint16 and int(r[2]) == 0
    assert t.get_position() == pos and torch.equal(t.hist, hist)


@pytest.mark.parametrize("method", GROUP_FORMS[1:])
@pytest.mark.parametrize("ctor", [REDUCED, DYADIC],
                         ids=["reduced", "interp-dyadic"])
def test_non_periodic_group_raises_with_state_unchanged(ctor, method):
    _, t = _engines(ctor, 1)
    ch, n = ctor[0], _chunk(t)
    _absorb_first((t,), np.random.default_rng(15), ch, n)
    state = (t.output_offset, t.input_index, t.hist.clone())
    kwargs = PACK if method == "process_flat_packed" else {}
    flat = torch.zeros((ch, G * (n - 1)))
    with pytest.raises(ValueError, match="periodic"):
        getattr(t, method)(*_group_args(method, n - 1)(None, flat), **kwargs)
    assert (t.output_offset, t.input_index) == state[:2]
    assert torch.equal(t.hist, state[2])
    with pytest.raises(ValueError, match="history length"):
        getattr(t, method)(*_group_args(method, 16)(None, flat[:, :32]),
                           **kwargs)
    with pytest.raises(ValueError, match="G\\*n_in"):
        getattr(t, method)(*_group_args(method, n)(None, flat[:, :n + 1]),
                           **kwargs)
    assert (t.output_offset, t.input_index) == state[:2]
