"""Repairs of the port against the JAX package, on the CPU: JAX's keywords
the port refused (``DeviceStreamResampler(pallas_step=...)``,
``ASRCStreamResampler(kernel=None)``) through JAX's own call lines, and the
input periods above ~1700 that K1 refused on a card (192k->11.025k,
M=2560, reduced and interpolated) through the port's plain path against
JAX's engine: Ks and positions exactly equal, samples within 1e-5 (float32
contractions in different orders; 2e-6 for the ASRC adapter, as in
test_torch_asrc.py)."""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from art_tpu.core.flags import (BLACKMAN_HARRIS, INCLUDE_LOWPASS,
                                SUBSAMPLE_INTERPOLATE)
from art_tpu.parallel import asrc as jasrc
from art_tpu.parallel import streams as jstreams
from art_tpu_torch import ASRCStreamResampler, DeviceStreamResampler

IB = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS
IBL = IB | INCLUDE_LOWPASS


@pytest.mark.parametrize("src,dst,taps,filters", [
    (44100, 48000, 380, 380), (96000, 44100, 156, 320),
    (44100, 48000, 48, 48)], ids=["headline", "config3", "config1-interp"])
def test_pallas_step_keyword_accepted(src, dst, taps, filters):
    """JAX's call line (test_pallas.py:290-292) builds the port's engine:
    pallas_step=True warns that it changes nothing and the engine streams
    bitwise as the default one; pallas_step=False is silent."""
    a = DeviceStreamResampler(2, taps, filters, src, dst, 0, IBL,
                              device="cpu")
    with pytest.warns(UserWarning, match="pallas_step"):
        b = DeviceStreamResampler(2, taps, filters, src, dst, 0, IBL,
                                  pallas_step=True, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        DeviceStreamResampler(2, taps, filters, src, dst, 0, IBL,
                              pallas_step=False, device="cpu")
    j = jstreams.DeviceStreamResampler(2, taps, filters, src, dst, 0, IBL)
    for e in (a, b, j):
        e.advance_position(taps // 2)
    rng = np.random.default_rng(3)
    for n in [1000, 4096, 37, 2049]:
        x = rng.uniform(-0.5, 0.5, (2, n)).astype(np.float32)
        oa, Ka = a.process(torch.from_numpy(x), n)
        ob, Kb = b.process(torch.from_numpy(x), n)
        oj, Kj = j.process(jnp.asarray(x), n)
        assert Ka == Kb == Kj
        assert torch.equal(oa, ob)
        assert np.abs(ob.numpy()[:, :Kb] - np.asarray(oj)[:, :Kj]).max() \
            <= 1e-5
    assert b.get_position() == j.get_position()


def test_asrc_kernel_none_selects_auto():
    """JAX's default ``kernel=None`` (asrc.py:678, artest's call line
    cli/artest.py:266-268 with it spelled out) selects "auto": the same
    counts, positions and samples as kernel="auto", and JAX's within
    2e-6."""
    ch, taps, filters = 2, 64, 128
    j = jasrc.ASRCStreamResampler(ch, taps, filters, 0.0, IB,
                                  dtype=np.float32, kernel=None)
    t = ASRCStreamResampler(ch, taps, filters, 0.0, IB, dtype=np.float32,
                            kernel=None, device="cpu")
    u = ASRCStreamResampler(ch, taps, filters, 0.0, IB, dtype=np.float32,
                            kernel="auto", device="cpu")
    assert t.asrc.kernel == "auto"
    for e in (j, t, u):
        e.advance_position(taps / 2)
    rng = np.random.default_rng(9)
    ratio = 48000 / 44100
    for i in range(4):
        n = 1000 + 137 * i
        r = ratio * (1.0 + 0.003 * np.sin(i))
        data = (rng.standard_normal((n, ch)) * 0.25).astype(np.float32)
        cap = int(n * r) + taps + 16
        (oj, rj), (ot, rt), (ou, ru) = (
            e.process_interleaved(data, n, cap, r) for e in (j, t, u))
        assert (rt.input_used, rt.output_generated) == (
            rj.input_used, rj.output_generated) == (ru.input_used,
                                                    ru.output_generated)
        assert np.array_equal(np.asarray(ot), np.asarray(ou))
        k = rt.output_generated
        assert np.abs(np.asarray(ot)[:k] - np.asarray(oj)[:k]).max() <= 2e-6
        assert t.get_position() == j.get_position() == u.get_position()


@pytest.mark.parametrize("ctor", [
    pytest.param((2, 380, 380, 192000, 11025, 0, IBL), id="p3-reduced"),
    pytest.param((2, 48, 48, 192000, 11025, 0, IBL), id="p1-interp")])
def test_input_period_2560_matches_jax(ctor):
    """192k->11.025k (preset -3 reduced to L=147, M=2560, qn=2; preset -1
    interpolated with Lp/Mp 147/2560), the shapes K1 refused on a card
    before its window came in column pieces: the port's plain path against
    JAX's engine, a non-periodic first chunk, M-multiple chunks and a short
    one."""
    t = DeviceStreamResampler(*ctor, device="cpu")
    j = jstreams.DeviceStreamResampler(*ctor)
    assert (t.L, t.M, t.qn, t.interp) == (147, 2560, 2, ctor[1] == 48)
    for e in (t, j):
        e.advance_position(ctor[1] // 2)
    rng = np.random.default_rng(2560)
    for n in (5000, 4 * 2560, 4 * 2560, 777):
        x = rng.uniform(-0.5, 0.5, (2, n)).astype(np.float32)
        ot, Kt = t.process(torch.from_numpy(x), n)
        oj, Kj = j.process(jnp.asarray(x), n)
        assert Kt == Kj
        assert t.get_position() == j.get_position()
        assert np.abs(ot.numpy()[:, :Kt] - np.asarray(oj)[:, :Kj]).max() \
            <= 1e-5
    np.testing.assert_array_equal(t.hist.numpy(), np.asarray(j.hist))
