"""Kernel K1 (art_tpu_torch/csrc/fixed_step.cu) held against its plain
version on an NVIDIA card.  These tests need a CUDA device and nvcc; without
them they skip.  Run them on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-5 abs against the plain version evaluated in float64 on the
same float32 inputs (std-0.5 noise); the kernel's float32 FMA order differs
from any other, so the bound is the float32 contraction class, not a bit
pattern.  The new history is a copy and must be bitwise equal."""

import numpy as np
import pytest
import torch

from art_tpu_torch import DeviceStreamResampler
from art_tpu_torch import INCLUDE_LOWPASS, SUBSAMPLE_INTERPOLATE, BLACKMAN_HARRIS
from art_tpu_torch.ops import fixed_step as k1

pytestmark = pytest.mark.cuda
IB = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS | INCLUDE_LOWPASS


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False); K1 has no CPU form, its plain version is "
                    "covered by test_torch_fixed_step.py")
    return torch.device("cuda")


def _case(kind, n, kmode, seed, dev):
    rng = np.random.default_rng(seed)
    if kind == "interp":
        M, L, qn, hist_len = 147, 160, 2, 768
        P = rng.normal(0, 0.05, (qn * M, 2 * L)).astype(np.float32)
        fracv = rng.random(L).astype(np.float32)
        K, start = (n * L) // M, 100
    else:
        src, dst = (44100, 48000) if kind == "fwd" else (48000, 44100)
        eng = DeviceStreamResampler(2, 380, 380, src, dst, 0, IB, device=dev)
        eng.advance_position(190)
        K, start, j0, _, _ = eng._plan_compute(n)
        M, L, qn, hist_len = eng.M, eng.L, eng.qn, eng.num_samples
        P, fracv = eng._matrix(j0).cpu().numpy(), None
    K = {"full": K, "mid": K - L - L // 3, "zero": 0}[kmode]
    t = lambda a: torch.from_numpy(a).to(dev)
    hist = t(rng.normal(0, 0.5, (2, hist_len)).astype(np.float32))
    x = t(rng.normal(0, 0.5, (2, n)).astype(np.float32))
    kw = dict(M=M, L=L, nb=-(-K // L) if K else 1, qn=qn, hist_len=hist_len)
    return hist, x, t(P), None if fracv is None else t(fracv), start, K, kw


@pytest.mark.parametrize("kmode", ["full", "mid", "zero"])
@pytest.mark.parametrize("kind,n", [("fwd", 40 * 147), ("fwd", 1000),
                                    ("inv", 40 * 160), ("interp", 40 * 147)])
def test_kernel_matches_plain(kind, n, kmode):
    dev = _card()
    hist, x, P, fracv, start, K, kw = _case(kind, n, kmode, seed=n, dev=dev)
    acc = torch.zeros((), device=dev)
    launches = k1.launches
    h, o, a = k1.fixed_step(hist, x, P, start, K, acc, fracv=fracv, **kw)
    torch.cuda.synchronize()
    assert k1.launches == launches + 1
    d = lambda v: None if v is None else v.double()
    hr, orf, ar = k1.fixed_step_reference(d(hist), d(x), d(P), start, K,
                                          acc.double(), fracv=d(fracv), **kw)
    assert o.shape == orf.shape
    assert float((o.double() - orf).abs().max()) <= 1e-5
    assert not o[:, K:].any()
    assert torch.equal(h, hr.float())
    assert float(a) == pytest.approx(float(ar), rel=1e-5, abs=1e-12)


def test_engine_on_card_matches_cpu_engine():
    dev = _card()
    engines = [DeviceStreamResampler(2, 380, 380, 44100, 48000, 0, IB,
                                     device=d) for d in (dev, "cpu")]
    for e in engines:
        e.advance_position(190)
    rng = np.random.default_rng(5)
    launches = k1.launches
    calls = 0
    for n in [1, 1000, 4096, 64 * 147, 333]:
        x = rng.normal(0, 0.5, (2, n)).astype(np.float32)
        (og, Kg), (oc, Kc) = (e.process(x, n) for e in engines)
        calls += 1
        assert Kg == Kc
        assert engines[0].get_position() == engines[1].get_position()
        assert float((og.cpu() - oc).abs().max()) <= 1e-5
    (og, Kg), (oc, Kc) = (e.flush() for e in engines)
    calls += 1
    assert Kg == Kc and float((og.cpu() - oc).abs().max()) <= 1e-5
    assert k1.launches == launches + calls
    assert torch.equal(engines[0].hist.cpu(), engines[1].hist)
