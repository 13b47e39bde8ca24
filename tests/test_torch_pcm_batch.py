"""Batch delivery of 16-bit PCM on the port, at a few tracks of preset -2
96k->44.1k, on the CPU (the kernels' plain versions):

- K1's plain version, through ``DeviceStreamResampler``'s first chunk and
  delivering group form, is in the float32 class of the benchmark's
  float64 reference (``bench_torch/reference/fixed_ratio.py``) at the
  reference's own lowpass for downsampling;
- ``DeviceDecimator(tracks=F)`` gives, byte for byte and clip for clip,
  what F of the JAX package's host decimators, one a file, give;
  ``tracks=None`` (and ``tracks=1``) gives what one such decimator of all
  the channels gives; one call of 2n frames equals two calls of n;
- the benchmark's plain decimator (``bench_torch/reference/pcm.py``),
  seeded a file at a time, gives the bytes, clips and state of the JAX
  package's host decimators, one a file, for every dither type with the
  ATH curve at 44.1 kHz, and without shaping.

    python -m pytest tests/test_torch_pcm_batch.py -q
"""

import numpy as np
import pytest
import torch
from art_tpu.engines.decimator import Decimator as JDecimator

from art_tpu_torch import (BLACKMAN_HARRIS, INCLUDE_LOWPASS,
                           SUBSAMPLE_INTERPOLATE, DeviceStreamResampler)
from art_tpu_torch.core.flags import (DITHER_FLAT, DITHER_HIGHPASS,
                                      DITHER_LOWPASS, SHAPING_ATH_CURVE)
from art_tpu_torch.engines.decimator import DeviceDecimator
from art_tpu_torch.ops import decimate_kernel as dk

TRACKS = 4
CH = 2 * TRACKS
PRESET2 = dict(num_taps=156, max_filters=320, source_rate=96000,
               destin_rate=44100, lowpass_freq=0,
               flags=["SUBSAMPLE_INTERPOLATE", "BLACKMAN_HARRIS",
                      "INCLUDE_LOWPASS"])
CD = (16, 2, 1.0, 44100)
HP_ATH = DITHER_HIGHPASS | SHAPING_ATH_CURVE
DITHERS = {"highpass": DITHER_HIGHPASS, "lowpass": DITHER_LOWPASS,
           "flat": DITHER_FLAT, "none": 0}


def _noise(shape, seed, std=0.25):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * std).astype(np.float32)


def test_k1_plain_within_float32_class_of_the_reference():
    from bench_torch import checks_pcm
    from bench_torch.reference import fixed_ratio as ref
    from bench_torch.reference.bank import phase_bank
    eng = DeviceStreamResampler(
        CH, 156, 320, 96000, 44100, 0,
        SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS | INCLUDE_LOWPASS,
        device="cpu")
    eng.advance_position(78)
    assert (eng.L, eng.M, eng.qn) == (147, 320, 2)
    n = 10 * eng.M
    x = _noise((CH, 3 * n), 16)
    first, K0 = eng.process(torch.from_numpy(x[:, :n]), n)
    group, Ks = eng.process_flat_out(torch.from_numpy(x[:, n:]), n)
    got = torch.cat([first[:, :K0], group], dim=1).double()
    K = K0 + int(Ks.sum())
    assert K == ref.emitted(3 * n, L=147, M=320, taps=156)[0]
    bank = phase_bank(156, 147, lowpass=checks_pcm.lowpass_ratio(PRESET2))
    a, b = ref.window_span(0, K, L=147, M=320, taps=156)
    seg = torch.zeros((CH, b - a), dtype=torch.float64)
    seg[:, -a:-a + min(3 * n, b)] = torch.from_numpy(x[:, :b]).double()
    want = ref.outputs(seg, a, 0, K, L=147, M=320, bank=bank)
    rms = float(want.square().mean().sqrt())
    assert float((got - want).abs().max()) / rms < 2e-5


def _jax_tracks(flags):
    """The JAX package's host decimators, one a 2-channel file."""
    return [JDecimator(2, *CD, flags) for _ in range(TRACKS)]


def _host_tracks(decs, x):
    """Bytes [K, CH*2] and clips of ``decs``, one a 2-channel file, on
    frames x [K, CH]."""
    K = x.shape[0]
    outs, clips = [], 0
    for t, dec in enumerate(decs):
        out, c = dec.process(x[:, 2 * t:2 * t + 2].T)
        outs.append(out.reshape(K, 2, 2))
        clips += c
    return np.concatenate(outs, axis=1).reshape(K, CH * 2), clips


@pytest.mark.parametrize("dither", ["highpass", "lowpass", "flat"])
@pytest.mark.parametrize("shaped", [True, False], ids=["ath", "unshaped"])
def test_tracks_give_one_host_decimator_a_file(dither, shaped):
    flags = DITHERS[dither] | (SHAPING_ATH_CURVE if shaped else 0)
    x = _noise((700, CH), 3, std=0.4)
    dev = DeviceDecimator(CH, *CD, flags, tracks=TRACKS, device="cpu")
    got, clips = dev.process_chunk(torch.from_numpy(x), 650)
    want, want_clips = _host_tracks(_jax_tracks(flags), x[:650])
    assert np.array_equal(got, want)
    assert clips == want_clips > 0


def test_tracks_none_is_the_one_file_seeding():
    x = torch.from_numpy(_noise((400, CH), 5))
    host = JDecimator(CH, *CD, HP_ATH)
    assert np.array_equal(
        DeviceDecimator(CH, *CD, HP_ATH, device="cpu").state_dict()["gens"],
        dk.seed_generators(CH))
    want, want_clips = host.process(x.numpy().T)
    for tracks in (None, 1):
        dev = DeviceDecimator(CH, *CD, HP_ATH, tracks=tracks, device="cpu")
        got, clips = dev.process_chunk(x, 400)
        assert np.array_equal(got, want) and clips == want_clips
    four = DeviceDecimator(CH, *CD, HP_ATH, tracks=4, device="cpu")
    assert not np.array_equal(four.process_chunk(x, 400)[0], want)


def test_one_call_of_2n_is_two_of_n():
    x = torch.from_numpy(_noise((600, CH), 7))
    one = DeviceDecimator(CH, *CD, HP_ATH, tracks=TRACKS, device="cpu")
    two = DeviceDecimator(CH, *CD, HP_ATH, tracks=TRACKS, device="cpu")
    whole, c = one.process_chunk(x, 600)
    a, ca = two.process_chunk(x[:300], 300)
    b, cb = two.process_chunk(x[300:], 300)
    assert np.array_equal(whole, np.concatenate([a, b]))
    assert c == ca + cb
    for k, v in one.state_dict().items():
        assert np.array_equal(v, two.state_dict()[k]), k


def test_tracks_must_divide_the_channels():
    for tracks in (0, 3, -2):
        with pytest.raises(ValueError, match="tracks"):
            DeviceDecimator(CH, *CD, HP_ATH, tracks=tracks, device="cpu")


@pytest.mark.parametrize("shaped", [True, False], ids=["ath", "unshaped"])
@pytest.mark.parametrize("dither", DITHERS)
def test_reference_decimator_is_the_host_decimator(dither, shaped):
    from bench_torch.reference import pcm
    flags = DITHERS[dither] | (SHAPING_ATH_CURVE if shaped else 0)
    kind = dict(pcm.DITHER_TYPES)
    dither_type = {"highpass": kind["DITHER_HIGHPASS"],
                   "lowpass": kind["DITHER_LOWPASS"],
                   "flat": kind["DITHER_FLAT"], "none": None}[dither]
    ref = pcm.Decimator(output_bits=16, output_bytes=2, output_gain=1.0,
                        sample_rate=44100, dither_type=dither_type,
                        ath=shaped, block=64)
    hosts = _jax_tracks(flags)
    x = _noise((300, CH), 11, std=0.45)
    gens = torch.from_numpy(pcm.track_seeds(TRACKS, 2).astype(np.int64))
    zeros = torch.zeros(CH)
    state = (gens if dither_type is not None else None, zeros,
             torch.zeros(4, CH), torch.zeros(4, CH))
    for lo, hi in ((0, 130), (130, 300)):
        want, want_clips = _host_tracks(hosts, x[lo:hi])
        ov, clipped, state = ref.run(torch.from_numpy(x[lo:hi]), *state)
        assert np.array_equal(ref.pack(ov).numpy(), want)
        assert np.array_equal(ref.unpack(torch.from_numpy(want)).numpy(),
                              ov.numpy())
        assert int(clipped.sum()) == want_clips
    gens, fb, xh, yh = state
    side = lambda f: np.concatenate([f(h) for h in hosts], axis=-1)
    if dither_type is not None:
        want_gens = side(lambda h: h.tpdf_generators)
        assert np.array_equal(gens.numpy().astype(np.uint32), want_gens)
        assert np.array_equal(pcm.jump(pcm.track_seeds(TRACKS, 2), 5 * 300),
                              want_gens)
    if shaped:
        assert np.array_equal(fb.numpy(), side(lambda h: h.feedback))
        assert np.array_equal(xh.numpy(), side(lambda h: h.noise_shaper.xh))
        assert np.array_equal(yh.numpy(), side(lambda h: h.noise_shaper.yh))
