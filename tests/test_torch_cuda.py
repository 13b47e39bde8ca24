"""Kernel K1 (art_tpu_torch/csrc/fixed_step.cu) and the ASRC kernels
(art_tpu_torch/csrc/asrc_step.cu) held against their plain versions on an
NVIDIA card.  These tests need a CUDA device and nvcc; without
them they skip.  Run them on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-5 abs against the plain version evaluated in float64 on the
same float32 inputs (std-0.5 noise); the kernel's float32 FMA order differs
from any other, so the bound is the float32 contraction class, not a bit
pattern.  The new history is a copy and must be bitwise equal."""

import numpy as np
import pytest
import torch

from art_tpu_torch import BatchedASRC, DeviceStreamResampler
from art_tpu_torch import INCLUDE_LOWPASS, SUBSAMPLE_INTERPOLATE, BLACKMAN_HARRIS
from art_tpu_torch.ops import asrc_step as kasrc
from art_tpu_torch.ops import fixed_step as k1

pytestmark = pytest.mark.cuda
IB = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS | INCLUDE_LOWPASS


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False); the CUDA kernels have no CPU form, their plain "
                    "versions are covered by test_torch_fixed_step.py and "
                    "test_torch_asrc.py")
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


# ---------------------------------------------------------------- ASRC
# The ASRC kernels (art_tpu_torch/csrc/asrc_step.cu) against their plain
# versions evaluated in float64 on the same inputs: float32 within 1e-5 abs
# (std-0.5 noise, 48- and 380-tap dots summed in another order), float64
# within 1e-12; the new history is a copy and must be bitwise equal.

def _asrc_engine(dev, s, taps, dtype=np.float32, kernel="auto"):
    eng = BatchedASRC(s, taps, taps, dtype=dtype, kernel=kernel,
                      hankel_kb=256, device=dev)
    eng.advance_position(taps // 2)
    return eng


def _asrc_case(case, dev, seed):
    """(eng, hist, x, ratios, Ks, k_max) for one step at small shapes."""
    rng = np.random.default_rng(seed)
    s, taps, n = (3, 380, 4096) if case == "S3" else (8, 48, 512)
    eng = _asrc_engine("cpu", s, taps)
    eng.process(np.zeros((s, n), np.float32), np.ones(s))  # fill the ring
    ratios = {"S3": np.array([0.99, 1.0, 1.01]), "r0.5": np.full(s, 0.5),
              "r0.2": np.full(s, 0.2), "r2.0": np.full(s, 2.0)}.get(
                  case, 1.0 + 0.01 * np.sin(0.1 * np.arange(s) + 0.3))
    if case == "flush":
        x = np.zeros((s, taps // 2))
        _, _, Ks, k_max, _, _ = eng._plan_flush(ratios, None, None)
    else:
        x = rng.normal(0, 0.5, (s, n))
        _, Ks, k_max, _ = eng._plan(n, ratios, None)
    if case == "mid":
        Ks = np.minimum(Ks, 77 + 130 * np.arange(s)).astype(np.int32)
    if case == "Ks0":
        Ks[::2] = 0
    hist = rng.normal(0, 0.5, (s, eng.num_samples))
    return eng, hist, x, ratios, Ks, k_max


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["near1", "r0.5", "r0.2", "r2.0", "mid",
                                  "Ks0", "flush", "S3"])
def test_asrc_step_kernel_matches_plain(case, dtype):
    dev = _card()
    eng, hist, x, ratios, Ks, k_max = _asrc_case(case, dev, seed=len(case))
    t = lambda a, dt=dtype: torch.as_tensor(a, dtype=dt, device=dev)
    bank = t(eng.bank)
    args = (t(hist), t(x), bank, t(eng.offsets, torch.float64),
            t(ratios, torch.float64), t(Ks, torch.int32),
            eng.num_samples - eng.input_index)
    geom = dict(num_taps=eng.num_taps, num_filters=eng.num_filters,
                k_max=k_max, hist_len=eng.num_samples)
    name = "asrc_step_f64" if dtype == torch.float64 else "asrc_step"
    before = dict(kasrc.launches)
    h, o = kasrc.asrc_step(*args, **geom)
    torch.cuda.synchronize()
    assert kasrc.launches[name] == before[name] + 1
    hr, _ = kasrc.asrc_step_reference(*args, **geom)
    d = lambda v: v.double() if v.is_floating_point() else v
    _, o64 = kasrc.asrc_step_reference(*(d(a) if torch.is_tensor(a) else a
                                         for a in args), **geom)
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    assert o.shape == (eng.S, k_max) and o.dtype == dtype
    assert float((o.double() - o64).abs().max()) <= tol
    for r in range(eng.S):
        assert not o[r, int(Ks[r]):].any()
    assert torch.equal(h, hr)


def test_asrc_apply_kernel_matches_plain():
    dev = _card()
    eng, hist, x, ratios, _, k_max = _asrc_case("near1", dev, seed=3)
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    buf, base, fi, frac, _ = kasrc.apply_prologue(
        t(hist), t(x), t(eng.offsets, torch.float64),
        t(ratios, torch.float64), eng.num_samples - eng.input_index,
        num_taps=eng.num_taps, num_filters=eng.num_filters, k_max=k_max,
        hist_len=eng.num_samples)
    bank = t(eng.bank)
    before = kasrc.launches["asrc_apply"]
    o = kasrc.asrc_apply(buf, bank, base, fi, frac)
    torch.cuda.synchronize()
    assert kasrc.launches["asrc_apply"] == before + 1
    o64 = kasrc.asrc_apply_reference(buf.double(), bank.double(), base, fi,
                                     frac.double())
    assert float((o.double() - o64).abs().max()) <= 1e-5


@pytest.mark.parametrize("dtype,kernel,tol", [
    (np.float32, "auto", 1e-5), (np.float64, "auto", 1e-12),
    (np.float32, "pallas", 1e-5)])
def test_asrc_engine_on_card_matches_cpu_engine(dtype, kernel, tol):
    dev = _card()
    s = 8
    engines = [_asrc_engine(d, s, 48, dtype, kernel) for d in (dev, "cpu")]
    rng = np.random.default_rng(6)
    name = {"pallas": "asrc_apply"}.get(
        kernel, "asrc_step_f64" if dtype == np.float64 else "asrc_step")
    before = kasrc.launches[name]
    calls = 0
    for i, n in enumerate([512, 1, 1000, 4096, 333]):
        x = rng.normal(0, 0.5, (s, n)).astype(dtype)
        ratios = 1.0 + 0.01 * np.sin(0.1 * np.arange(s) + 0.031 * i)
        (og, Kg), (oc, Kc) = (e.process(x, ratios) for e in engines)
        calls += 1
        assert np.array_equal(Kg, Kc)
        assert np.array_equal(engines[0].get_position(),
                              engines[1].get_position())
        assert float((og.cpu() - oc).abs().max()) <= tol
    for mask in (np.arange(s) % 3 == 0, np.ones(s, bool), np.ones(s, bool)):
        fr = 1.0 + 0.002 * np.arange(s)
        (og, Kg), (oc, Kc) = (e.flush(fr, mask) for e in engines)
        calls += int(Kc.max() > 0)
        assert np.array_equal(Kg, Kc)
        assert np.array_equal(engines[0].get_position(),
                              engines[1].get_position())
        assert float((og.cpu() - oc).abs().max()) <= tol
    assert kasrc.launches[name] == before + calls
    assert torch.equal(engines[0].hist.cpu(), engines[1].hist)
