"""The 5.1 float64 chain on the port (art ``-p``'s cascaded-biquad
pre-filter into preset -3's float64 downsampler, 48k -> 44.1k), at a small
size on the CPU (6 channels, groups of 4 chunks of 1,600 frames, the
fewest that cover the engine's 6,080-frame history; the kernels' plain
versions), against the benchmark's plain reference
(``bench_torch/reference/biquad.py`` then ``reference/fixed_ratio.py``,
``bench_torch/checks_chain.py``):

- ``DeviceBiquadCascade`` (two sections, carried across calls) then
  ``DeviceStreamResampler``'s first chunk and ``process_flat_out`` groups:
  counts exact, samples within the cell's ``sample_err`` limit of the
  float64 reference chain;
- the group form on the filtered groups equals sequential ``process()``
  a chunk, bitwise;
- the reference's FIR truncation at W = 256 taps leaves less than W r^W
  of the impulse response's magnitude out;
- the same reference chain computed in float32 lies more than 10x the
  limit away, so the cell's check refuses the precision below float64.

    python -m pytest tests/test_torch_chain_f64.py -q
"""

import json
import math

import numpy as np
import pytest
import torch

from art_tpu_torch import DeviceStreamResampler
from art_tpu_torch.core import flags
from art_tpu_torch.engines import biquad
from art_tpu_torch.ops.biquad_kernel import DeviceBiquadCascade
from bench_torch import checks_chain, checks_pcm, harness, traffic
from bench_torch.reference import biquad as biquad_ref
from bench_torch.reference import fixed_ratio as fixed_ref
from bench_torch.reference.bank import phase_bank

CFG = json.loads((harness.HERE / "configs" /
                  "preset3_6ch_48k_to_44k1_f64_prefilter.json").read_text())
LIMIT = json.loads((harness.HERE / "cells" / "c4b_chain_f64.json")
                   .read_text())["limits"]["sample_err"]
CH, N, G, GROUPS = CFG["channels"], 1600, 4, 2


def _engine():
    c = CFG
    eng = DeviceStreamResampler(
        c["channels"], c["num_taps"], c["max_filters"], c["source_rate"],
        c["destin_rate"], c["lowpass_freq"],
        sum(getattr(flags, name) for name in c["flags"]),
        dtype=np.float64, device="cpu")
    eng.advance_position(c["advance"])
    return eng


def _cascade():
    pf = CFG["prefilter"]
    coeffs = biquad.biquad_lowpass(pf["frequency"])
    secs = [biquad.Biquad.init(coeffs, pf["gain"], channels=CH,
                               dtype=np.float64) for _ in range(2)]
    casc = DeviceBiquadCascade(*secs, device="cpu")
    casc.push_from(*secs)
    return casc


def _stream(seed=20):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((CH, N * (1 + G * GROUPS)), generator=g,
                       dtype=torch.float64) * 0.25


def _chain(x):
    """(the chain's outputs [CH, K], each call's count) over x: the first
    chunk through process(), then GROUPS groups of G chunks."""
    eng, casc = _engine(), _cascade()
    first, K0 = eng.process(casc.process(x[:, :N], N), N)
    outs, counts = [first[:, :K0]], [K0]
    for j in range(GROUPS):
        grp = x[:, N + j * G * N:N + (j + 1) * G * N]
        out, Ks = eng.process_flat_out(casc.process(grp, G * N), N)
        outs.append(out)
        counts.append(int(Ks.sum()))
    return torch.cat(outs, dim=1), counts


def _reference(x, K, dtype=torch.float64):
    """The reference chain's outputs 0..K-1 in ``dtype``, by the cell's
    check (``checks_chain._outputs``) over a log of the stream x."""
    log = traffic.StreamLog([x])
    log.add(0, 0, x.shape[1])
    geom = checks_pcm._geometry(CFG)
    h = biquad_ref.impulse(checks_chain.sections(CFG), dtype=dtype)
    bank = phase_bank(geom["taps"], geom["L"],
                      lowpass=checks_pcm.lowpass_ratio(CFG)).to(dtype)
    return checks_chain._outputs(log, 0, K, h, bank, geom, "cpu").double()


def _sample_err(got, want):
    return float((got - want).abs().max()) / float(want.square().mean()
                                                   .sqrt())


@pytest.fixture(scope="module")
def chained():
    """(x, the chain's outputs, each call's count, the float64 reference
    chain's outputs) on one seeded stream, shared by the tests below."""
    x = _stream()
    got, counts = _chain(x)
    return x, got, counts, _reference(x, sum(counts))


def test_chain_counts_exact_and_samples_within_the_limit(chained):
    x, got, counts, want = chained
    eng = _engine()
    assert (eng.L, eng.M, eng.qn) == (147, 160, 4)
    geom = checks_pcm._geometry(CFG)
    cum = np.cumsum(counts)
    ends = N * (1 + G * np.arange(GROUPS + 1))
    for total, end in zip(cum, ends):
        ref, tie = fixed_ref.emitted(int(end), **geom)
        assert total == ref or (tie and total == ref + 1)
    assert _sample_err(got, want) * 10 < LIMIT


def test_group_form_equals_sequential_process_bitwise():
    x = _stream(21)
    casc = _cascade()
    first = casc.process(x[:, :N], N)
    groups = [casc.process(x[:, N + j * G * N:N + (j + 1) * G * N], G * N)
              for j in range(GROUPS)]
    flat, seq = _engine(), _engine()
    a, Ka = flat.process(first, N)
    b, Kb = seq.process(first, N)
    assert Ka == Kb and torch.equal(a[:, :Ka], b[:, :Kb])
    for y in groups:
        out, Ks = flat.process_flat_out(y, N)
        parts = []
        for g in range(G):
            o, K = seq.process(y[:, g * N:(g + 1) * N], N)
            assert K == Ks[g]
            parts.append(o[:, :K])
        assert torch.equal(out, torch.cat(parts, dim=1))
    assert torch.equal(flat.hist, seq.hist)


def test_fir_truncation_bound_at_256_taps():
    secs = checks_chain.sections(CFG)
    h = biquad_ref.impulse(secs, taps=4 * biquad_ref.W)
    r = math.sqrt(secs[0][4])
    assert r == pytest.approx(0.6813, abs=1e-4)
    tail = float(h[biquad_ref.W:].abs().sum())
    bound = biquad_ref.W * r ** biquad_ref.W
    assert 0 < tail < bound < 1e-40
    assert torch.equal(biquad_ref.impulse(secs), h[:biquad_ref.W])


def test_float32_reference_fails_the_limit(chained):
    x, _, counts, want = chained
    assert _sample_err(_reference(x, sum(counts), torch.float32),
                       want) > 10 * LIMIT
