"""Kernel K1 (art_tpu_torch/csrc/fixed_step.cu, also at large input
periods and as K6's polyphase_apply), the ASRC kernels
(art_tpu_torch/csrc/asrc_step.cu) and the fixed-ratio group forms held
against their plain versions, or sequential process(), on an NVIDIA
card.  These tests need a CUDA device and nvcc; without
them they skip.  Run them on the card with

    python -m pytest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-5 abs against the plain version evaluated in float64 on the
same float32 inputs (std-0.5 noise); the kernel's float32 FMA order differs
from any other, so the bound is the float32 contraction class, not a bit
pattern.  The precision tiers' instances: the precise one within 1 float32
ulp of the float64 dots rounded once, the float64 one within 1e-12.  The
new history is a copy and must be bitwise equal."""

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


# case: (streams, taps, filters, frames per call).  The kernel stages the
# bank in pieces of P taps (ops/asrc_step.py::step_geometry) and gives each
# block a run of outputs (3072 float32, 2304 float64): "taps36" and
# "taps100" end on a shorter piece, "F1024" has the most rows per piece
# (float64: P = 8), "midrun" ends Ks inside a run, "seam" moves the
# positions 1500 samples back so that one run reads windows in hist,
# across the seam and in x.  A run's windows are staged in shared memory
# where they fit; at ratio 0.2 and 380 filters ("r0.2wide") they do not,
# and the pieces read hist and x in place.
ASRC_CASES = {"S3": (3, 380, 380, 4096), "taps36": (4, 36, 36, 2000),
              "taps100": (4, 100, 100, 2000), "F1024": (2, 64, 1024, 5000),
              "midrun": (3, 48, 48, 12000), "seam": (2, 380, 380, 6000),
              "r0.2wide": (2, 380, 380, 30000)}


def _asrc_case(case, dev, seed):
    """(eng, hist, x, ratios, Ks, k_max) for one step at small shapes."""
    rng = np.random.default_rng(seed)
    s, taps, filters, n = ASRC_CASES.get(case, (8, 48, 48, 512))
    eng = BatchedASRC(s, taps, filters, hankel_kb=256, device="cpu")
    eng.advance_position(taps // 2)
    eng.process(np.zeros((s, n), np.float32), np.ones(s))  # fill the ring
    ratios = {"S3": np.array([0.99, 1.0, 1.01]), "r0.5": np.full(s, 0.5),
              "r0.2": np.full(s, 0.2), "r0.2wide": np.full(s, 0.2),
              "r2.0": np.full(s, 2.0)}.get(
                  case, 1.0 + 0.01 * np.sin(0.1 * np.arange(s) + 0.3))
    if case == "flush":
        x = np.zeros((s, taps // 2))
        _, _, Ks, k_max, _, _ = eng._plan_flush(ratios, None, None)
    else:
        x = rng.normal(0, 0.5, (s, n))
        _, Ks, k_max, _ = eng._plan(n, ratios, None)
    if case == "mid":
        Ks = np.minimum(Ks, 77 + 130 * np.arange(s)).astype(np.int32)
    if case == "midrun":
        Ks = np.minimum(Ks, [5096, 8209, k_max]).astype(np.int32)
    if case == "Ks0":
        Ks[::2] = 0
    if case == "seam":
        eng.offsets = eng.offsets - 1500.0
    hist = rng.normal(0, 0.5, (s, eng.num_samples))
    return eng, hist, x, ratios, Ks, k_max


def _seam_inside_a_run(eng, ratios, Ks, k_max, run):
    """True when some stream's valid windows cross from hist into x inside
    one run of ``run`` outputs, with outputs of that run on both sides."""
    base, _, _ = kasrc.decompose_positions(
        torch.from_numpy(eng.offsets), torch.from_numpy(ratios), k_max,
        num_taps=eng.num_taps, num_filters=eng.num_filters,
        shift=eng.num_samples - eng.input_index, dtype=torch.float64)
    H = eng.num_samples
    for s in range(eng.S):
        b = base[s, :int(Ks[s])]
        cross = ((b < H) & (b + eng.num_taps > H)).nonzero()
        if len(cross):
            r = int(cross[0]) // run
            seg = b[r * run:(r + 1) * run]
            if bool((seg + eng.num_taps <= H).any()) and bool(
                    (seg >= H).any()):
                return True
    return False


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["near1", "r0.5", "r0.2", "r2.0", "mid",
                                  "Ks0", "flush", "S3", "taps36", "taps100",
                                  "F1024", "midrun", "seam", "r0.2wide"])
def test_asrc_step_kernel_matches_plain(case, dtype):
    dev = _card()
    eng, hist, x, ratios, Ks, k_max = _asrc_case(case, dev, seed=len(case))
    run = kasrc.step_geometry(eng.num_taps, eng.num_filters,
                              dtype).outputs_per_block
    if case == "seam":
        assert _seam_inside_a_run(eng, ratios, Ks, k_max, run)
    if case == "midrun":
        assert k_max > 2 * run and Ks[0] % run and Ks[1] % run
    if case == "r0.2wide":      # the first run's windows exceed the stage
        geo = kasrc.step_geometry(eng.num_taps, eng.num_filters, dtype)
        assert run * 5 > geo.window_capacity and k_max > run
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


# The apply (the step kernel's template with given positions) on the same
# shapes: "r0.2wide"'s runs span more window than the stage holds, so they
# read buf in place; "shuffled" permutes the outputs inside each run, so
# the bases do not grow with k and the run's span comes from its block
# reduction; "midrun" cuts K inside a run.
APPLY_CASES = ["near1", "r0.5", "r0.2wide", "r2.0", "shuffled", "F1024",
               "taps36", "taps100", "midrun", "S3"]


@pytest.mark.parametrize("case", APPLY_CASES)
def test_asrc_apply_kernel_cases_match_plain(case):
    dev = _card()
    eng, hist, x, ratios, _, k_max = _asrc_case(
        "near1" if case == "shuffled" else case, dev, seed=len(case))
    t = lambda a, dt=torch.float32: torch.as_tensor(a, dtype=dt, device=dev)
    buf, base, fi, frac, _ = kasrc.apply_prologue(
        t(hist), t(x), t(eng.offsets, torch.float64),
        t(ratios, torch.float64), eng.num_samples - eng.input_index,
        num_taps=eng.num_taps, num_filters=eng.num_filters, k_max=k_max,
        hist_len=eng.num_samples)
    run = kasrc.step_geometry(eng.num_taps, eng.num_filters,
                              torch.float32).outputs_per_block
    if case == "shuffled":
        gen = torch.Generator().manual_seed(7)
        perm = torch.cat([k + torch.randperm(min(run, k_max - k),
                                             generator=gen)
                          for k in range(0, k_max, run)]).to(dev)
        base, fi, frac = (a[:, perm].contiguous() for a in (base, fi, frac))
        assert not bool((base[:, 1:] >= base[:, :-1]).all())
    if case == "midrun":        # the apply takes any K: end inside a run
        k_max -= 1077
        base, fi, frac = (a[:, :k_max].contiguous() for a in (base, fi, frac))
        assert k_max > run and k_max % run
    bank = t(eng.bank)
    before = kasrc.launches["asrc_apply"]
    o = kasrc.asrc_apply(buf, bank, base, fi, frac)
    torch.cuda.synchronize()
    assert kasrc.launches["asrc_apply"] == before + 1
    o64 = kasrc.asrc_apply_reference(buf.double(), bank.double(), base, fi,
                                     frac.double())
    assert o.shape == (eng.S, k_max)
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


# ------------------------------------------------ K1 at large M, K6, groups
# K1 picks a smaller row tile and stages P in pieces where the 128-block
# tile does not fit 227 KB of shared memory, and the window in column
# pieces where no whole window tile fits (csrc/fixed_step.cu header).
WIDE = {   # (taps, filters, src, dst, flags): M, mode
    "p2-96k-44k": (156, 320, 96000, 44100, IB),          # 320, reduced
    "p3-192k-44k": (380, 380, 192000, 44100, IB),        # 640, reduced
    "p1-96k-44k": (48, 48, 96000, 44100, IB),            # 320, interpolated
    "p1-192k-44k": (48, 48, 192000, 44100, IB),          # 640, interpolated
    "p3-192k-11k": (380, 380, 192000, 11025, IB),        # 2560, reduced
    "p1-192k-11k": (48, 48, 192000, 11025, IB),          # 2560, interpolated
}


def _wide_case(name, dev, n_periods=40, seed=0, dtype=np.float32):
    """A steady chunk of a real engine plan: (hist, x, P, fracv, start, K,
    kw) on ``dev``; the plan and matrices come from a CPU engine."""
    taps, filt, src, dst, flags = WIDE[name]
    eng = DeviceStreamResampler(2, taps, filt, src, dst, 0, flags,
                                dtype=dtype, device="cpu")
    eng.advance_position(taps // 2)
    n = n_periods * eng.M
    eng._plan(n)
    K, start, j0, pos0, plan = eng._plan_compute(n)
    nb = -(-K // eng.L)
    if eng.interp:
        P, fracv = eng._interp_pattern(pos0, plan, n, K, nb)[:2]
    else:
        P, fracv = eng._matrix(j0), None
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(a.astype(dtype)).to(dev)
    hist = t(rng.normal(0, 0.5, (2, eng.num_samples)))
    x = t(rng.normal(0, 0.5, (2, n)))
    kw = dict(M=eng.M, L=eng.L, nb=nb, qn=eng.qn, hist_len=eng.num_samples)
    return (hist, x, P.to(dev), None if fracv is None else fracv.to(dev),
            start, K, kw)


@pytest.mark.parametrize("name", list(WIDE))
def test_kernel_large_M_matches_plain(name):
    dev = _card()
    hist, x, P, fracv, start, K, kw = _wide_case(name, dev)
    assert kw["M"] in (320, 640, 2560)
    bm, pr, smem = k1.kernel_tile(kw["M"], kw["qn"], fracv is not None)
    assert bm in (32, 64, 128) and 0 < pr <= kw["M"] and smem <= 227 * 1024
    acc = torch.zeros((), device=dev)
    h, o, a = k1.fixed_step(hist, x, P, start, K, acc, fracv=fracv, **kw)
    torch.cuda.synchronize()
    d = lambda v: None if v is None else v.double()
    _, orf, _ = k1.fixed_step_reference(d(hist), d(x), d(P), start, K,
                                        acc.double(), fracv=d(fracv), **kw)
    assert float((o.double() - orf).abs().max()) <= 1e-5
    assert not o[:, K:].any()


def test_kernel_tile_refuses_and_names_a_shape_too_large():
    """Every M fits: where no whole window tile does, the window comes in
    column pieces beside P's (M = 2560 at 192k->11.025k, M = 4000), so
    kernel_tile refuses, naming it, only a shape no launch takes."""
    _card()
    with pytest.raises(ValueError, match="M=0, qn=2"):
        k1.kernel_tile(0, 2, False)
    for M, interp in ((4000, False), (2560, False), (2560, True)):
        for dtype, precise in ((torch.float32, False), (torch.float32, True),
                               (torch.float64, False)):
            bm, pr, smem = k1.kernel_tile(M, 2, interp, dtype=dtype,
                                          precise=precise)
            assert bm in (32, 64, 128) and pr % 32 == 0 and 0 < pr < M
            assert smem <= 227 * 1024
    # 128 window rows x (352 | 1) + 352 x 32 floats and the reduction
    assert k1.kernel_tile(2560, 2, False) == (128, 352, 225856)
    # the main path keeps the 128-block tile and whole P slices, two
    # buffers of them: (131 rows x 147 + pad) + 2 x 147 x 32 floats and
    # the hull's 64-byte reduction; the precise instance stages the same
    assert k1.kernel_tile(147, 4, False) == (128, 147, 114736)
    assert k1.kernel_tile(147, 4, False, precise=True) == (128, 147, 114736)
    # config 4's float64 shape: one buffer of a whole 160-row slice
    assert k1.kernel_tile(160, 4, False, dtype=torch.float64) == (
        128, 160, 209760)


# the precision tiers' instances: (dtype, precise, name)
TIER_INSTANCES = {"f32_acc64": (np.float32, True),
                  "f64": (np.float64, False)}


@pytest.mark.parametrize("name", ["p3-192k-11k", "p1-192k-11k",
                                  "p2-96k-44k", "p1-96k-44k"])
@pytest.mark.parametrize("inst", list(TIER_INSTANCES))
def test_kernel_instances_match_plain(inst, name):
    """The precise instance within 1 float32 ulp of the float64 dots
    rounded once (its plain version), the float64 one within 1e-12 of its
    plain version; one launch of that instance, a zero tail past K, the
    new history bitwise."""
    dev = _card()
    dtype, precise = TIER_INSTANCES[inst]
    hist, x, P, fracv, start, K, kw = _wide_case(name, dev, dtype=dtype)
    acc = torch.zeros((), dtype=hist.dtype, device=dev)
    before = dict(k1.instance_launches)
    h, o, _ = k1.fixed_step(hist, x, P, start, K, acc, fracv=fracv,
                            precise=precise, **kw)
    torch.cuda.synchronize()
    assert k1.instance_launches[inst] == before[inst] + 1
    assert o.dtype == hist.dtype
    hr, orf, _ = k1.fixed_step_reference(hist, x, P, start, K, acc,
                                         fracv=fracv, precise=precise, **kw)
    if precise:
        ulp = (torch.nextafter(orf.abs(), torch.full_like(orf, np.inf))
               - orf.abs()).double()
        assert float(((o.double() - orf.double()).abs() / ulp).max()) <= 1
    else:
        assert float((o - orf).abs().max()) <= 1e-12
    assert not o[:, K:].any()
    assert torch.equal(h, hr)


@pytest.mark.parametrize("method", ["process_scan", "process_flat",
                                    "process_flat_out",
                                    "process_flat_packed"])
@pytest.mark.parametrize("tier", ["int8", "f64"])
@pytest.mark.parametrize("mode", ["reduced", "interp"])
def test_tier_group_forms_bitwise_equal_sequential_on_card(mode, tier,
                                                           method):
    """On the card, each group form of a precision tier against sequential
    process(): Ks, position and history equal, outputs and the power sum
    bitwise, packed bytes equal to quantizing the sequential samples on
    the host; the tier's instance launched, no other."""
    dev = _card()
    ctor = GROUP_CTORS[mode]
    opts = dict(precise="int8") if tier == "int8" else dict(dtype=np.float64)
    inst = "f32_acc64" if tier == "int8" else "f64"
    a, b = (DeviceStreamResampler(*ctor, device=dev, **opts)
            for _ in range(2))
    for e in (a, b):
        e.advance_position(ctor[1] // 2)
    G, ch, n = 3, ctor[0], 50 * a.M
    rng = np.random.default_rng(22)
    xs = torch.from_numpy(rng.normal(0, 0.7, (G + 1, ch, n))).to(
        a.hist.dtype).to(dev)
    for e in (a, b):
        e.process(xs[0], n)
    zero = torch.zeros((), dtype=a.hist.dtype, device=dev)
    acc_a, outs, Ks = zero, [], []
    for x in xs[1:]:
        o, K, acc_a = a.process(x, n, acc_a)
        outs.append(o)
        Ks.append(K)
    flat = torch.cat(list(xs[1:]), dim=1)
    before = dict(k1.instance_launches)
    if method == "process_scan":
        o_b, Ks_b, acc_b = b.process_scan(xs[1:], n, zero)
        assert torch.equal(acc_b, acc_a)
        for g in range(G):
            assert torch.equal(o_b[g], outs[g])
        want = G
    elif method == "process_flat":
        Ks_b, acc_b = b.process_flat(flat, n, zero)
        assert torch.equal(acc_b, acc_a)
        want = G
    else:
        valid = torch.cat([o[:, :K] for o, K in zip(outs, Ks)], dim=1)
        if method == "process_flat_out":
            o_b, Ks_b = b.process_flat_out(flat, n)
            assert torch.equal(o_b, valid)
        else:
            sc = 32768.0 * 1.37
            packed, Ks_b, clips = b.process_flat_packed(
                flat, n, torch.zeros((), dtype=torch.int32, device=dev),
                scaler=sc, highclip=32767, lowclip=-32768)
            v = valid.cpu().numpy()
            code = v * sc if v.dtype == np.float64 else (
                v.astype(np.float64) * np.float64(np.float32(sc))).astype(
                np.float32).astype(np.float64)
            f = np.floor(code)
            ov = f + (code - f >= 0.5)
            want_b = np.clip(ov, -32768, 32767).astype("<i2")
            assert np.array_equal(packed.cpu().numpy().view(np.uint8),
                                  want_b.view(np.uint8))
            assert int(clips) == int(((ov > 32767) | (ov < -32768)).sum())
        want = 1
    torch.cuda.synchronize()
    after = {k: v - before[k] for k, v in k1.instance_launches.items()}
    assert after == {k: want if k == inst else 0 for k in after}
    assert list(Ks_b) == Ks
    assert b.get_position() == a.get_position()
    assert torch.equal(b.hist, a.hist)


@pytest.mark.parametrize("nb_pad", [1024, 37])
def test_polyphase_apply_matches_plain(nb_pad):
    dev = _card()
    M, qn, L = 147, 4, 160
    rng = np.random.default_rng(nb_pad)
    win = np.zeros((2, (nb_pad + 512) * M), np.float32)
    win[:, :nb_pad * M + qn * M] = rng.standard_normal(
        (2, nb_pad * M + qn * M))
    P = (rng.standard_normal((qn * M, L)) * 0.05).astype(np.float32)
    w, p = torch.from_numpy(win).to(dev), torch.from_numpy(P).to(dev)
    before = k1.polyphase_launches, k1.launches
    out = k1.polyphase_apply(w, p, M=M, qn=qn, L=L)
    torch.cuda.synchronize()
    assert (k1.polyphase_launches, k1.launches) == (before[0] + 1, before[1])
    ref = k1.polyphase_apply_reference(w.double(), p.double(), M=M, qn=qn,
                                       L=L)
    assert out.shape == (2, nb_pad, L)
    assert float((out.double() - ref).abs().max()) <= 1e-5


GROUP_CTORS = {"reduced": (2, 380, 380, 44100, 48000, 0, IB),
               "interp": (1, 48, 48, 44100, 48000, 0,
                          SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS)}


@pytest.mark.parametrize("method", ["process_scan", "process_flat",
                                    "process_flat_out",
                                    "process_flat_packed"])
@pytest.mark.parametrize("mode", list(GROUP_CTORS))
def test_group_forms_bitwise_equal_sequential_on_card(mode, method):
    """On the card, each group form against sequential process(): Ks,
    position and history equal, outputs and the power sum bitwise, packed
    bytes equal to quantizing the sequential samples on the host."""
    dev = _card()
    ctor = GROUP_CTORS[mode]
    a, b = (DeviceStreamResampler(*ctor, device=dev) for _ in range(2))
    for e in (a, b):
        e.advance_position(ctor[1] // 2)
    G, ch, n = 3, ctor[0], 50 * a.M
    rng = np.random.default_rng(21)
    xs = torch.from_numpy(rng.normal(0, 0.7, (G + 1, ch, n))
                          .astype(np.float32)).to(dev)
    for e in (a, b):
        e.process(xs[0], n)
    acc_a, outs, Ks = torch.zeros((), device=dev), [], []
    for x in xs[1:]:
        o, K, acc_a = a.process(x, n, acc_a)
        outs.append(o)
        Ks.append(K)
    flat = torch.cat(list(xs[1:]), dim=1)
    zero = torch.zeros((), device=dev)
    launches = k1.launches
    if method == "process_scan":
        o_b, Ks_b, acc_b = b.process_scan(xs[1:], n, zero)
        assert torch.equal(acc_b, acc_a)
        for g in range(G):
            assert torch.equal(o_b[g], outs[g])
        want_launches = G
    elif method == "process_flat":
        Ks_b, acc_b = b.process_flat(flat, n, zero)
        assert torch.equal(acc_b, acc_a)
        want_launches = G
    else:
        valid = torch.cat([o[:, :K] for o, K in zip(outs, Ks)], dim=1)
        if method == "process_flat_out":
            o_b, Ks_b = b.process_flat_out(flat, n)
            assert torch.equal(o_b, valid)
        else:
            packed, Ks_b, clips = b.process_flat_packed(
                flat, n, torch.zeros((), dtype=torch.int32, device=dev),
                scaler=32768.0 * 1.37, highclip=32767, lowclip=-32768)
            v = valid.cpu().numpy().astype(np.float64)
            code = (v * np.float64(np.float32(32768.0 * 1.37))) \
                .astype(np.float32)
            ov = np.floor(code.astype(np.float64) + 0.5)
            want = np.clip(ov, -32768, 32767).astype("<i2")
            assert np.array_equal(packed.cpu().numpy().view(np.uint8),
                                  want.view(np.uint8))
            assert int(clips) == int(((ov > 32767) | (ov < -32768)).sum())
        want_launches = 1
    torch.cuda.synchronize()
    assert k1.launches == launches + want_launches
    assert list(Ks_b) == Ks
    assert b.get_position() == a.get_position()
    assert torch.equal(b.hist, a.hist)


# K1 skips the rows of P outside each CTA's hull (the first to the last
# row holding a nonzero in its 32 phases, both banks' when interpolated),
# found from P's values, and keeps each output's blocks of 32 terms at
# m = 0, 32, ... of every slice.  Synthetic P with the hull's edges on
# and off those block edges, an all-zero 32-phase group, a P whose only
# nonzero row is the last of a slice, interpolated banks whose bands
# differ, and the large periods whose P passes in pieces.
HULL_CASES = {   # M, qn, L, interpolated
    "band-on-edges": (147, 4, 160, False),
    "band-off-edges": (147, 4, 160, False),
    "zero-group": (147, 4, 160, False),
    "last-row-of-slice": (147, 4, 160, False),
    "interp": (147, 2, 160, True),
    "M320": (320, 2, 147, False),
    "M640-interp": (640, 2, 147, True),
}


def _banded(rng, KQ, L, edges):
    """[KQ, L] with each 32-column group nonzero on one band of rows: its
    first column starts the band at lo, its last ends it at hi, the others
    lie inside; on ``edges`` lo and hi are 32-row block edges."""
    P = np.zeros((KQ, L), np.float32)
    for n0 in range(0, L, 32):
        if edges is not None:
            lo, hi = np.sort(rng.choice(edges, 2, replace=False))
        else:
            lo = int(rng.integers(1, KQ // 3))
            hi = int(rng.integers(2 * KQ // 3, KQ))
        for l in range(n0, min(n0 + 32, L)):
            a = lo if l == n0 else lo + int(rng.integers(0, 9))
            b = hi if l == min(n0 + 32, L) - 1 else hi - int(rng.integers(0, 9))
            P[a:b, l] = rng.normal(0, 0.05, max(b - a, 0))
    return P


@pytest.mark.parametrize("case", list(HULL_CASES))
def test_kernel_hull_matches_plain(case):
    dev = _card()
    M, qn, L, interp = HULL_CASES[case]
    KQ = qn * M
    rng = np.random.default_rng(len(case))
    edges = [q * M + b for q in range(qn) for b in range(0, M, 32)] + [KQ]
    if case == "zero-group":
        P = rng.normal(0, 0.05, (KQ, L)).astype(np.float32)
        P[:, 32:64] = 0
    elif case == "last-row-of-slice":
        P = np.zeros((KQ, L), np.float32)
        P[2 * M - 1] = rng.normal(0, 0.05, L)
    else:
        P = _banded(rng, KQ, L, edges if case in ("band-on-edges", "M320")
                    else None)
    fracv = None
    if interp:      # bank 2's bands reach 3 rows further on both sides
        P2 = np.zeros_like(P)
        for l in range(L):
            rows = np.flatnonzero(P[:, l])
            if not len(rows):
                continue
            lo, hi = max(rows[0] - 3, 0), min(rows[-1] + 4, KQ)
            P2[lo:hi, l] = rng.normal(0, 0.05, hi - lo)
        P = np.concatenate([P, P2], axis=1)
        fracv = torch.from_numpy(rng.random(L).astype(np.float32)).to(dev)
    nb, start = 40, 3
    K = nb * L - L // 3
    t = lambda a: torch.from_numpy(a.astype(np.float32)).to(dev)
    hist = t(rng.normal(0, 0.5, (2, KQ)))
    x = t(rng.normal(0, 0.5, (2, nb * M)))
    kw = dict(M=M, L=L, nb=nb, qn=qn, hist_len=KQ)
    acc = torch.zeros((), device=dev)
    h, o, _ = k1.fixed_step(hist, x, t(P), start, K, acc, fracv=fracv, **kw)
    torch.cuda.synchronize()
    d = lambda v: None if v is None else v.double()
    hr, orf, _ = k1.fixed_step_reference(d(hist), d(x), d(t(P)), start, K,
                                         acc.double(), fracv=d(fracv), **kw)
    assert float((o.double() - orf).abs().max()) <= 1e-5
    assert not o[:, K:].any()
    assert torch.equal(h, hr.float())
    if case == "zero-group":
        assert not o.view(2, nb, L)[:, :, 32:64].any()


# ----------------------------------------------------- the decimate kernels
# bitwise: the packed bytes, clip counts and states are exact contracts
DEC_FLAT = [  # (dither type, bits, bytes, dtype, planar, layout, K cut)
    (-1, 16, 2, torch.float32, False, "k1", 0),
    (1, 8, 1, torch.float32, False, "interleaved", 777),
    (0, 24, 3, torch.float32, False, "k1", 777),
    (2, 24, 4, torch.float32, False, "interleaved", 0),
    (None, 16, 2, torch.float32, True, "k1", 0),
    (None, 12, 2, torch.float64, True, "k1", 0),
    (-1, 20, 3, torch.float64, False, "k1", 31),
]


def _dec_samples(dev, n, dtype, layout, cut, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal((2, n)) * 0.6)).to(dev, dtype)
    samples = x.T if layout == "k1" else x.T.contiguous()
    K = n - cut
    if cut:
        samples = samples.clone()
        samples[K:] = float("nan")
    return samples, K


def _dec_kw(dev, bits, nbytes, dither_type, seed):
    from art_tpu_torch.ops import decimate_device as dd
    hi = (1 << (bits - 1)) - 1
    gens = np.random.default_rng(seed).integers(0, 1 << 32, 2,
                                                dtype=np.uint64)
    return dict(scaler=(hi + 1) * 1.07, highclip=hi, lowclip=~hi,
                output_bits=bits, output_bytes=nbytes,
                gens=dd.states_tensor(gens.astype(np.uint32), dev),
                dither_type=dither_type)


def _bits_equal(a, b):
    if a.is_floating_point():
        a, b = a.double(), b.double()
    return a.shape == b.shape and torch.equal(a, b)


@pytest.mark.parametrize("case", DEC_FLAT, ids=[
    f"{c[0]}-{c[1]}in{c[2]}-{str(c[3])[6:]}-{'planar' if c[4] else c[5]}"
    f"-cut{c[6]}" for c in DEC_FLAT])
def test_decimate_flat_kernel_matches_plain(case):
    from art_tpu_torch.ops import decimate_device as dd
    dev = _card()
    dither_type, bits, nbytes, dtype, planar, layout, cut = case
    samples, K = _dec_samples(dev, 100_003, dtype, layout, cut, bits)
    kw = _dec_kw(dev, bits, nbytes, dither_type, bits + 1)
    kw["feedback"] = torch.tensor([0.25, -0.5], dtype=dtype, device=dev)
    kw["planar"] = planar
    got = dd.decimate_flat(samples, K, **kw)
    want = dd.decimate_flat_reference(samples, K, **kw)
    torch.cuda.synchronize()
    assert int(got[1]) == int(want[1]) > 0
    for g, w in zip(got, want):
        assert _bits_equal(g, w)


DEC_SHAPED = [("ath", -1, 16, torch.float32, 0),
              ("2nd", 0, 8, torch.float32, 333),
              ("ath", None, 24, torch.float32, 0),
              ("ath", 1, 16, torch.float64, 333)]


@pytest.mark.parametrize("case", DEC_SHAPED, ids=[
    f"{c[0]}-{c[1]}-{c[2]}-{str(c[3])[6:]}-cut{c[4]}" for c in DEC_SHAPED])
def test_decimate_shaped_kernel_matches_plain(case):
    from art_tpu_torch.core import flags as F
    from art_tpu_torch.engines.decimator import Decimator
    from art_tpu_torch.ops import decimate_device as dd
    dev = _card()
    curve, dither_type, bits, dtype, cut = case
    flags = F.SHAPING_ATH_CURVE if curve == "ath" else F.SHAPING_2ND_ORDER
    sh = Decimator(2, bits, 3, 1.0, 48000, flags,
                   dtype=np.float64 if dtype == torch.float64
                   else np.float32).noise_shaper
    samples, K = _dec_samples(dev, 3001, dtype, "k1", cut, bits)
    kw = _dec_kw(dev, bits, (bits + 7) // 8, dither_type, bits)
    kw.update(a=sh.a, b=sh.b, xh=sh.xh + 0.1, yh=sh.yh - 0.1,
              feedback=np.array([0.3, -0.2]))
    got = dd.decimate_shaped(samples, K, **kw)
    want = dd.decimate_shaped_reference(samples, K, **kw)
    torch.cuda.synchronize()
    assert int(got[1]) == int(want[1])
    for g, w in zip(got, want):
        assert _bits_equal(g, w)


# the redesigned geometry: (S, dtype, dither type, shaper, n, K) with K
# named by where it falls in the shaped kernel's tiles ("first": inside
# the first tile, "last": inside the ring's last stage, "zero", "n")
DEC_SHAPED_GEO = [(1, torch.float32, 0, "ath", 6000, "last"),
                  (2, torch.float32, -1, "ath", 6000, "first"),
                  (2, torch.float32, 1, "2nd", 6000, "last"),
                  (2, torch.float32, None, "ath", 5000, "n"),
                  (2, torch.float64, 0, "ath", 3500, "last"),
                  (2, torch.float32, 0, "ath", 200_000, 1000),
                  (2, torch.float32, 0, "ath", 3000, "zero"),
                  (6, torch.float32, -1, "2nd", 2000, "last"),
                  (33, torch.float32, None, "ath", 1000, 700),
                  (33, torch.float64, 1, "2nd", 800, "last")]


def _shaped_kw(dev, S, dtype, dither_type, curve, seed):
    from art_tpu_torch.core import flags as F
    from art_tpu_torch.engines.decimator import Decimator
    from art_tpu_torch.ops import decimate_device as dd
    flags = F.SHAPING_ATH_CURVE if curve == "ath" else F.SHAPING_2ND_ORDER
    sh = Decimator(1, 16, 2, 1.0, 48000, flags,
                   dtype=np.float64 if dtype == torch.float64
                   else np.float32).noise_shaper
    rng = np.random.default_rng(seed)
    gens = rng.integers(0, 1 << 32, S, dtype=np.uint64).astype(np.uint32)
    return dict(scaler=32768.0 * 1.07, highclip=32767, lowclip=-32768,
                output_bits=16, output_bytes=2,
                gens=dd.states_tensor(gens, dev), dither_type=dither_type,
                a=sh.a, b=sh.b, xh=np.tile(sh.xh, (1, S)) + 0.1,
                yh=np.tile(sh.yh, (1, S)) - 0.1,
                feedback=rng.uniform(-0.3, 0.3, S))


@pytest.mark.parametrize("case", DEC_SHAPED_GEO, ids=[
    f"S{c[0]}-{str(c[1])[6:]}-{c[2]}-{c[3]}-n{c[4]}-K{c[5]}"
    for c in DEC_SHAPED_GEO])
def test_decimate_shaped_kernel_geometry(case):
    """The warp-specialised shaped kernel against its plain version,
    bitwise, across its geometry: one and two chain warps (S = 33), K = 0,
    K inside the first tile and inside the ring's last stage, n >> K (the
    zero-tail CTAs), float64, dither types -1, 0 and 1 and none, ATH and
    2nd-order shapers."""
    from art_tpu_torch.ops import decimate_device as dd
    dev = _card()
    S, dtype, dither_type, curve, n, where = case
    tile = dd.library_geometry(n, S, n, dtype, 1)["shaped"]["tile"]
    K = {"first": tile // 2 + 3, "last": 2 * tile + tile // 3, "zero": 0,
         "n": n}.get(where, where)
    assert K <= n
    rng = np.random.default_rng(S + n)
    x = torch.from_numpy(rng.standard_normal((S, n)) * 0.6).to(dev, dtype).T
    kw = _shaped_kw(dev, S, dtype, dither_type, curve, S)
    got = dd.decimate_shaped(x, K, **kw)
    want = dd.decimate_shaped_reference(x, K, **kw)
    torch.cuda.synchronize()
    assert int(got[1]) == int(want[1])
    for g, w in zip(got, want):
        assert _bits_equal(g, w)


def test_decimate_shaped_stream_in_three_calls_equals_one():
    """A stream cut into 3 calls (cuts inside tiles) gives the bytes, clip
    count and final state of one call over it."""
    from art_tpu_torch.ops import decimate_device as dd
    dev = _card()
    n = 9000
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (n, 2)) * 0.7).to(dev, torch.float32)
    kw = _shaped_kw(dev, 2, torch.float32, 0, "ath", 3)
    whole = dd.decimate_shaped(x, n, **kw)
    state = {k: kw[k] for k in ("gens", "feedback", "xh", "yh")}
    parts, clips = [], 0
    for lo, hi in ((0, 1500), (1500, 5333), (5333, n)):
        p, c, g, f, xh, yh = dd.decimate_shaped(x[lo:hi], hi - lo,
                                                **{**kw, **state})
        parts.append(p)
        clips += int(c)
        state = dict(gens=g, feedback=f, xh=xh, yh=yh)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat(parts), whole[0]) and clips == int(whole[1])
    for g, w in zip((state["gens"], state["feedback"], state["xh"],
                     state["yh"]), whole[2:]):
        assert _bits_equal(g, w)


# (S, input layout, bits, bytes, planar, dither type, n, K cut)
DEC_FLAT_GEO = [(1, "k1", 16, 2, False, 0, 100_003, 3),
                (1, "interleaved", 8, 1, True, -1, 100_003, 0),
                (1, "k1", 24, 4, True, 1, 1 << 20, 0),
                (2, "k1", 24, 3, False, 0, 100_003, 5),
                (2, "k1", 16, 2, True, None, 100_004, 0),
                (2, "k1", 8, 1, True, 0, 100_004, 2),
                (2, "k1", 24, 4, True, 1, 1 << 20, 3),
                (2, "misaligned", 16, 2, False, 0, 100_003, 3),
                (2, "interleaved", 16, 2, False, 0, (1 << 21) + 5, 4),
                (6, "k1", 16, 2, False, 0, 100_003, 3),
                (6, "interleaved", 24, 3, False, -1, 1_500_001, 0),
                (8, "k1", 12, 2, True, 0, 100_003, 3),
                (8, "interleaved", 8, 1, False, 1, 100_003, 6),
                (4097, "k1", 16, 2, False, 0, 300, 1)]


@pytest.mark.parametrize("case", DEC_FLAT_GEO, ids=[
    f"S{c[0]}-{c[1]}-{c[2]}in{c[3]}-{'planar' if c[4] else 'inter'}"
    f"-d{c[5]}-n{c[6]}-cut{c[7]}" for c in DEC_FLAT_GEO])
def test_decimate_flat_kernel_geometry(case):
    """The persistent flat kernel against its plain version, bitwise,
    across its paths: S = 1, 2 (the 16-byte fast path), 6, 8 and 4097
    (lanes that jump per run); n not a multiple of the run, K inside a run,
    a misaligned view, 24-bit, every container width, strides long enough
    for lanes to loop."""
    from art_tpu_torch.ops import decimate_device as dd
    dev = _card()
    S, layout, bits, nbytes, planar, dither_type, n, cut = case
    rng = np.random.default_rng(S + n)
    buf = torch.from_numpy(rng.standard_normal((S, n + 1)) * 0.6).to(
        dev, torch.float32)
    x = {"k1": buf[:, :n].T, "misaligned": buf[:, 1:].T,
         "interleaved": buf[:, :n].T.contiguous()}[layout]
    K = n - cut
    if cut:
        x = x.clone()
        x[K:] = float("nan")
    kw = _dec_kw(dev, bits, nbytes, dither_type, S)
    kw["gens"] = dd.states_tensor(rng.integers(
        0, 1 << 32, S, dtype=np.uint64).astype(np.uint32), dev)
    kw["feedback"] = torch.from_numpy(rng.uniform(-0.3, 0.3, S)).to(
        dev, torch.float32)
    kw["planar"] = planar
    got = dd.decimate_flat(x, K, **kw)
    want = dd.decimate_flat_reference(x, K, **kw)
    torch.cuda.synchronize()
    assert int(got[1]) == int(want[1]) > 0
    for g, w in zip(got, want):
        assert _bits_equal(g, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_decimate_chain_probe_matches_plain(dtype):
    """The chain probe (the shaped kernel's latency bound) computes the
    shaped quantizer's chain: its final state bitwise its plain version's."""
    from art_tpu_torch.engines.decimator import Decimator
    from art_tpu_torch.core import flags as F
    from art_tpu_torch.ops import decimate_device as dd
    dev = _card()
    sh = Decimator(1, 16, 2, 1.0, 48000, F.SHAPING_ATH_CURVE).noise_shaper
    values = [*sh.a, *sh.b, 1234.567, 0.3, 0.01, *sh.xh[:, 0],
              *sh.yh[:, 0]]
    got = dd.chain_probe(values, 5000, dtype, dev)
    torch.cuda.synchronize()
    want = dd.chain_probe_reference(values, 5000, dtype)
    assert np.array_equal(got.cpu().numpy().view(np.uint8),
                          want.view(np.uint8))


@pytest.mark.parametrize("flags", ["hp", "hp-ath", "lp-2nd"])
def test_device_decimator_on_card_matches_host(flags):
    from art_tpu_torch.core import flags as F
    from art_tpu_torch.engines.decimator import Decimator, DeviceDecimator
    dev = _card()
    fl = {"hp": F.DITHER_HIGHPASS,
          "hp-ath": F.DITHER_HIGHPASS | F.SHAPING_ATH_CURVE,
          "lp-2nd": F.DITHER_LOWPASS | F.SHAPING_2ND_ORDER}[flags]
    host = Decimator(2, 16, 2, 1.0, 48000, fl, backend="numpy")
    engine = DeviceDecimator(2, 16, 2, 1.0, 48000, fl, device=dev)
    rng = np.random.default_rng(5)
    for n, K in ((4096, 4096), (4096, 1000), (777, 777)):
        x = (rng.standard_normal((n, 2)) * 0.7).astype(np.float32)
        x[K:] = np.nan
        want, wc = host.process_interleaved(x[:K])
        got, gc = engine.process_chunk(torch.from_numpy(x).to(dev), K)
        assert gc == wc and np.array_equal(got, want)
    assert np.array_equal(engine.state_dict()["gens"], host.tpdf_generators)


def test_packed_epilogue_on_card_matches_plain():
    """process_flat_packed's epilogue: the flat kernel's container
    against the int64 plain version, on the card."""
    from art_tpu_torch.parallel import streams
    dev = _card()
    out = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (2, 50_000)).astype(np.float32) * 0.6).to(dev)
    zi = torch.zeros((), dtype=torch.int32, device=dev)
    for scaler, bits, nbytes in ((32768.0, 16, 2), (32768.0 * 1.37, 16, 2),
                                 (128.0, 8, 1), (8388608.0, 24, 4)):
        hi = (1 << (bits - 1)) - 1
        kw = dict(highclip=hi, lowclip=~hi, output_bits=bits,
                  output_bytes=nbytes)
        got, gc = streams._quantize_pack(out, scaler, zi, **kw)
        want, wc = streams._quantize_pack_reference(out, scaler, zi, **kw)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and int(gc) == int(wc) > 0
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


@pytest.mark.parametrize("multi", [False, True], ids=["", "-m"])
def test_art_device_decimator_on_card(multi, tmp_path):
    """art -r48k -o16 -n0 --backend=cuda on the card (the fetches on the
    write pool with -m): lengths and clip warnings equal to the numpy
    backend's, codes within the resample-then-decimate floor."""
    import io
    from contextlib import redirect_stderr

    from art_tpu_torch.cli import art
    from art_tpu_torch.io import wavfile
    _card()
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((88200, 2)) * 0.4).astype("<f4")
    src = tmp_path / "in.wav"
    with open(src, "wb") as f:
        wavfile.write_wav_header(f, bits=32, num_channels=2,
                                 num_frames=x.shape[0], sample_rate=44100,
                                 channel_mask=0x3)
        f.write(x.tobytes())
    got = {}
    for be in ("cuda", "numpy"):
        dst = tmp_path / f"{be}.wav"
        err = io.StringIO()
        with redirect_stderr(err):
            rc = art.main(["-q", "-y", f"--backend={be}", "-r48k", "-o16",
                           "-n0", *(["-m"] if multi else []), str(src),
                           str(dst)])
        assert rc == 0, err.getvalue()
        data = dst.read_bytes()
        got[be] = (data, err.getvalue())
    (a, ea), (b, eb) = got["cuda"], got["numpy"]
    assert len(a) == len(b) and ea == eb and "clipped" in ea
    diff = np.abs(np.frombuffer(a[-40000:], "<i2").astype(np.int32)
                  - np.frombuffer(b[-40000:], "<i2").astype(np.int32))
    assert diff.max() <= 12 and diff.mean() < 2.0


# --------------------------------------------- the biquad cascade's kernel
BQ_CASES = [  # (dtype, layout, combined, K)
    (torch.float64, "sn", True, "n"), (torch.float64, "ns", False, "n"),
    (torch.float64, "sn", False, "cut"), (torch.float32, "sn", False, "n"),
    (torch.float32, "ns", True, "cut"), (torch.float32, "sn", True, 0),
    (torch.float64, "sn", True, 3), (torch.float64, "ns", True, 256),
    (torch.float32, "sn", False, 4097)]


def _bq_section(combined):
    from art_tpu_torch.engines.biquad import Biquad, biquad_lowpass
    from art_tpu_torch.ops import biquad_kernel as bk
    q = Biquad.init(biquad_lowpass(0.45 * 44100 / 48000), 1.0, 1)
    if combined:
        return bk.combine_biquads(q, q)
    return np.asarray(q.a, np.float64), np.asarray(q.b, np.float64)


def _bq_case(dev, dtype, layout, K, S=6, n=100_003, seed=0):
    """x [n, S] in the layout given ("sn": a transposed [S, n] tensor, as
    K1 writes it; "ns": contiguous [n, S]), NaN past a ragged K."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((S, n)) * 0.5).to(dev, dtype)
    x = x.T if layout == "sn" else x.T.contiguous()
    K = {"n": n, "cut": n - 777}.get(K, K)
    if K < n:
        x = x.clone()
        x[K:] = float("nan")
    xh = torch.from_numpy(rng.standard_normal((4, S)) * 0.1).to(dev)
    yh = torch.from_numpy(rng.standard_normal((4, S)) * 0.1).to(dev)
    return x, K, xh, yh


def _within_class(got, want):
    """float64 within 1e-12 of the plain version's scale; float32 within
    one float32 ulp of it (both round a float64 solve once)."""
    g, w = got.double().cpu().numpy(), want.double().cpu().numpy()
    if got.dtype == torch.float64:
        return np.abs(g - w).max() <= 1e-12 * max(np.abs(w).max(), 1e-300)
    ulp = np.spacing(np.maximum(np.abs(g), np.abs(w)).astype(np.float32))
    return bool(np.all(np.abs(g - w) <= ulp))


@pytest.mark.parametrize("case", BQ_CASES, ids=[
    f"{str(c[0])[6:]}-{c[1]}-{'comb' if c[2] else 'biquad'}-K{c[3]}"
    for c in BQ_CASES])
def test_biquad_kernel_matches_plain(case):
    from art_tpu_torch.ops import biquad_kernel as bk
    dev = _card()
    dtype, layout, combined, K = case
    a, b = _bq_section(combined)
    x, K, xh, yh = _bq_case(dev, dtype, layout, K)
    t = bk.iir_tables(b, B=bk.KERNEL_BLOCK, device=dev)
    before = bk.launches["biquad"]
    got = bk.assoc_core_masked(x, a, b, xh, yh, K, t)
    assert bk.launches["biquad"] == before + 1
    _bq_check(got, bk.assoc_core_masked_reference(x, a, b, xh, yh, K, t),
              K, dtype)


def _bq_check(got, want, K, dtype):
    """The kernel's (y, xh', yh') against the plain version's: y within
    the class, zero past K and finite, xh' bitwise, yh' within 1e-12."""
    torch.cuda.synchronize()
    assert got[0].dtype == dtype and _within_class(got[0], want[0])
    assert not got[0][K:].any() and torch.isfinite(got[0]).all()
    assert torch.equal(got[1], want[1])                 # xh' is a copy
    assert np.abs((got[2] - want[2]).cpu().numpy()).max() <= 1e-12


# (dtype, layout, n, K): K at and around the 8192-frame span edges and
# inside a span's first four frames, and streams shorter than one span
BQ_EDGES = [
    (torch.float64, "sn", 20_000, 8191), (torch.float64, "sn", 20_000, 8192),
    (torch.float64, "ns", 20_000, 8193), (torch.float32, "sn", 20_000, 8194),
    (torch.float32, "sn", 20_000, 8195), (torch.float64, "sn", 20_000, 8196),
    (torch.float64, "sn", 20_000, 16_380), (torch.float32, "sn", 20_000, 16_384),
    (torch.float64, "sn", 16_384, 16_384), (torch.float32, "sn", 5_000, 5_000),
    (torch.float64, "ns", 5_000, 4_999), (torch.float64, "sn", 3, 2),
    (torch.float32, "sn", 8_191, 1)]


@pytest.mark.parametrize("case", BQ_EDGES, ids=[
    f"{str(c[0])[6:]}-{c[1]}-n{c[2]}-K{c[3]}" for c in BQ_EDGES])
def test_biquad_kernel_span_edges(case):
    from art_tpu_torch.ops import biquad_kernel as bk
    dev = _card()
    dtype, layout, n, K = case
    a, b = _bq_section(True)
    x, K, xh, yh = _bq_case(dev, dtype, layout, K, n=n, seed=K)
    t = bk.iir_tables(b, B=bk.KERNEL_BLOCK, device=dev)
    before = bk.launches["biquad"]
    got = bk.assoc_core_masked(x, a, b, xh, yh, K, t)
    assert bk.launches["biquad"] == before + 1
    _bq_check(got, bk.assoc_core_masked_reference(x, a, b, xh, yh, K, t),
              K, dtype)


def _resonator(r=0.99985, theta=0.7):
    """A unit-gain two-pole resonator whose 8192-frame span transition P
    keeps ~0.29 of the state (P^16 ~ 3e-9): the kernel's look-back waits on
    E_{j-16} and the carry changes the outputs; its poles lie away from DC,
    so the companion matrix's powers stay well scaled."""
    b = np.array([0.0, -2 * r * np.cos(theta), r * r, 0.0, 0.0])
    return np.array([1 - r, 0.0, 0.0, 0.0, 0.0]), b


def test_biquad_kernel_look_back_hops():
    """2^22 + 5 frames at S = 2 (513 spans a stream) through the
    resonator: the look-back carries E over 16 spans at a time, 32 hops a
    stream; within the class of the plain version."""
    from art_tpu_torch.ops import biquad_kernel as bk
    dev = _card()
    a, b = _resonator()
    t = bk.kernel_tables(b)
    assert (t["window"], t["carry"]) == (bk.WINDOW, True)
    n = (1 << 22) + 5
    x, K, xh, yh = _bq_case(dev, torch.float64, "sn", n - 3, S=2, n=n)
    got = bk.assoc_core_masked(x, a, b, xh, yh, K)
    _bq_check(got, bk.assoc_core_masked_reference(x, a, b, xh, yh, K),
              K, torch.float64)


def test_biquad_kernel_bitwise_run_to_run():
    """Two calls on the same input give equal tensors: the span formula
    never depends on which CTA finished first (the resonator, whose
    carry reaches across spans, and the -p section)."""
    from art_tpu_torch.ops import biquad_kernel as bk
    dev = _card()
    for (a, b), dtype in ((_resonator(), torch.float64),
                          (_bq_section(True), torch.float32),
                          (_bq_section(False), torch.float64)):
        x, K, xh, yh = _bq_case(dev, dtype, "sn", "cut", n=300_001)
        one = bk.assoc_core_masked(x, a, b, xh, yh, K)
        for _ in range(3):
            two = bk.assoc_core_masked(x, a, b, xh, yh, K)
            for g, w in zip(one, two):
                assert torch.equal(g, w)


def test_biquad_cascade_is_one_host_call():
    """_cascade2_step_T on the card: one call into the C entry point, two
    launches; section 2 reads section 1's output in the data's type, as
    the plain cascade does."""
    from art_tpu_torch.ops import biquad_kernel as bk
    dev = _card()
    a, b = _bq_section(False)
    for dtype in (torch.float32, torch.float64):
        x, K, xh, yh = _bq_case(dev, dtype, "sn", "cut", n=40_001)
        x_sn = x.T
        calls, before = bk.host_calls["biquad"], bk.launches["biquad"]
        got = bk._cascade2_step_T(x_sn, a, b, xh, yh, a, b, yh, xh, K, None,
                                  None)
        assert bk.host_calls["biquad"] == calls + 1
        assert bk.launches["biquad"] == before + 2
        y1, xh1, yh1 = bk.assoc_core_masked_reference(x, a, b, xh, yh, K)
        y2, xh2, yh2 = bk.assoc_core_masked_reference(y1, a, b, yh, xh, K)
        torch.cuda.synchronize()
        assert got[0].dtype == dtype and _within_class(got[0].T, y2)
        assert not got[0][:, K:].any() and torch.isfinite(got[0]).all()
        assert torch.equal(got[1], xh1)                 # x's rows: a copy
        # section 2's xh' holds section 1's outputs: within their class
        assert _within_class(got[3].to(dtype), xh2.to(dtype))
        for g, w in ((got[2], yh1), (got[4], yh2)):
            assert np.abs((g - w).cpu().numpy()).max() <= 1e-12


def test_biquad_kernel_bitwise_independent_of_batch_width():
    from art_tpu_torch.ops import biquad_kernel as bk
    dev = _card()
    a, b = _bq_section(True)
    t = bk.iir_tables(b, B=bk.KERNEL_BLOCK, device=dev)
    for dtype in (torch.float32, torch.float64):
        x, K, xh, yh = _bq_case(dev, dtype, "sn", "cut")
        y6, xh6, yh6 = bk.assoc_core_masked(x, a, b, xh, yh, K, t)
        for s in range(6):
            y1, xh1, yh1 = bk.assoc_core_masked(x[:, s:s + 1], a, b,
                                                xh[:, s:s + 1],
                                                yh[:, s:s + 1], K, t)
            assert torch.equal(y1[:, 0], y6[:, s])
            assert torch.equal(xh1[:, 0], xh6[:, s])
            assert torch.equal(yh1[:, 0], yh6[:, s])


def test_device_biquad_cascade_on_card_matches_host_pair():
    """push_from, ragged blocks on the card, pull_to, the host again: the
    float64 stream of the host pair alone within 1e-13."""
    from art_tpu_torch.engines.biquad import (Biquad, apply_cascade,
                                              biquad_lowpass)
    from art_tpu_torch.ops import biquad_kernel as bk
    dev = _card()
    c = biquad_lowpass(0.45 * 44100 / 48000)

    def pair():
        return [Biquad.init(c, 1.0, 6, np.float64) for _ in range(2)]

    x = np.random.default_rng(3).standard_normal((300_000, 6)) * 0.5
    want = apply_cascade(pair(), x)
    mixed = pair()
    cas = bk.DeviceBiquadCascade(*mixed, device=dev)
    out = [apply_cascade(mixed, x[:1000])]
    cas.push_from(*mixed)
    for lo, hi, cap in ((1000, 150_000, 150_000), (150_000, 200_001,
                                                   60_000)):
        blk = torch.zeros((6, cap), dtype=torch.float64, device=dev)
        blk[:, :hi - lo] = torch.from_numpy(x[lo:hi].T).to(dev)
        calls, before = bk.host_calls["biquad"], bk.launches["biquad"]
        out.append(cas.process(blk, hi - lo)[:, :hi - lo].T.cpu().numpy())
        assert bk.host_calls["biquad"] == calls + 1
        assert bk.launches["biquad"] == before + 2
    cas.pull_to(*mixed)
    out.append(apply_cascade(mixed, x[200_001:]))
    assert np.abs(np.concatenate(out) - want).max() < 1e-13


# ------------------------------------------------ the host engines' backend
@pytest.mark.parametrize("case", ["near1", "r2.0", "F1024", "taps36",
                                  "r0.2wide", "S3"])
def test_asrc_apply_f64_kernel_matches_plain(case):
    """K5's float64 instance against its plain version: within 1e-12."""
    dev = _card()
    eng, hist, x, ratios, _, k_max = _asrc_case(case, dev, seed=len(case))
    t = lambda a, dt=torch.float64: torch.as_tensor(a, dtype=dt, device=dev)
    buf, base, fi, frac, _ = kasrc.apply_prologue(
        t(hist), t(x), t(eng.offsets), t(ratios),
        eng.num_samples - eng.input_index, num_taps=eng.num_taps,
        num_filters=eng.num_filters, k_max=k_max, hist_len=eng.num_samples)
    bank = t(eng.bank)
    before = kasrc.launches["asrc_apply_f64"]
    o = kasrc.asrc_apply(buf, bank, base, fi, frac)
    torch.cuda.synchronize()
    assert kasrc.launches["asrc_apply_f64"] == before + 1
    assert o.dtype == torch.float64 and o.shape == (eng.S, k_max)
    ref = kasrc.asrc_apply_reference(buf, bank, base, fi, frac)
    assert float((o - ref).abs().max()) <= 1e-12


@pytest.mark.parametrize("F,taps,interpolate,lowpass,dtype,tol", [
    (48, 48, True, True, np.float32, 1e-5),
    (1024, 64, False, True, np.float32, 1e-5),
    (160, 48, False, False, np.float32, 1e-5),
    (1024, 32, False, False, np.float64, 1e-12),
    (64, 48, True, True, np.float64, 1e-12)],
    ids=["interp", "exact F1024", "exact allpass", "exact F1024 allpass f64",
         "interp f64"])
def test_apply_torch_on_card_matches_plain(F, taps, interpolate, lowpass,
                                           dtype, tol):
    """apply_torch on the card (one K5 launch) against its plain version
    on the CPU; the non-interpolated phase index reaches F."""
    from art_tpu_torch.core.filters import make_filter_bank
    from art_tpu_torch.ops import resample_kernel as rk
    dev = _card()
    rng = np.random.default_rng(F + taps)
    pos = np.sort(rng.uniform(taps, 3000 - taps - 1, 1500))
    pos[::4] = np.floor(pos[::4])
    pos[1::4] = np.floor(pos[1::4]) + 1.0 - 0.2 / F
    parts = rk.decompose_positions(pos, F, taps, interpolate, lowpass)
    assert interpolate or (parts["fi"] == F).any()
    bank = make_filter_bank(taps, F, 0.9 if lowpass else 1.0, True, dtype)
    L = rng.normal(0, 0.5, (2, 3000)).astype(dtype)
    name = "asrc_apply_f64" if dtype == np.float64 else "asrc_apply"
    before = kasrc.launches[name]
    got = rk.apply_torch(L, torch.from_numpy(bank).to(dev), parts,
                         interpolate, dtype)
    assert kasrc.launches[name] == before + 1
    want = rk.apply_torch(L, torch.from_numpy(bank), parts, interpolate,
                          dtype)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.abs(got.astype(np.float64) - want).max() <= tol


@pytest.mark.parametrize("dtype,tol", [(np.float32, 1e-5),
                                       (np.float64, 1e-12)])
@pytest.mark.parametrize("mode", ["reduced", "interpolated", "drift"])
def test_resampler_torch_on_card_matches_cpu(mode, dtype, tol):
    """Resampler(backend="torch") on the card against the same engine on
    the CPU's plain versions: counts and positions equal, samples within
    the bound; the polyphase calls launch K1, the others K5."""
    from art_tpu_torch import Resampler
    dev = _card()
    ctor = {"reduced": (2, 64, 380, 44100, 48000, 0, IB),
            "interpolated": (2, 64, 64, 44100, 47999, 0, IB),
            "drift": (2, 64, 64, 0.9, IB)}[mode]
    make = Resampler if mode == "drift" else Resampler.fixed_ratio
    engines = [make(*ctor, dtype=dtype, backend="torch", device=d)
               for d in (dev, "cpu")]
    for e in engines:
        e.advance_position(32.0)
    sig = (np.random.default_rng(3).standard_normal((2, 20000))
           * 0.4).astype(dtype)
    k1_before, k5_before = k1.launches, dict(kasrc.launches)
    for j, i in enumerate(list(range(0, 20000, 4000)) + [-1]):
        blk = None if i < 0 else sig[:, i:i + 4000]
        ratio = 1.0884 + 0.002 * np.sin(j) if mode == "drift" else 0.0
        (a, ra), (b, rb) = (e.process(blk, -1 if blk is None else 4000,
                                      5000, ratio) for e in engines)
        assert (ra.input_used, ra.output_generated) == (
            rb.input_used, rb.output_generated)
        assert engines[0].get_position() == engines[1].get_position()
        assert np.abs(a.astype(np.float64) - b).max(initial=0) <= tol
    name = "asrc_apply_f64" if dtype == np.float64 else "asrc_apply"
    assert (k1.launches > k1_before) == (mode == "reduced")
    assert kasrc.launches[name] > k5_before[name]


def test_decimator_torch_on_card_matches_native():
    """Decimator(backend="torch") on the card (one shaped decimate launch
    a call) against the native host decimator, bitwise in bytes, clips,
    feedback, shaper state and generators."""
    from art_tpu_torch import Decimator
    from art_tpu_torch.core import flags as F
    from art_tpu_torch.ops import decimate_device as dd
    dev = _card()
    fl = F.DITHER_HIGHPASS | F.SHAPING_ATH_CURVE
    host = Decimator(2, 16, 2, 1.0, 44100, fl, backend="native")
    card = Decimator(2, 16, 2, 1.0, 44100, fl, backend="torch", device=dev)
    rng = np.random.default_rng(9)
    before = dd.launches["decimate_shaped"]
    for n in (4096, 1, 3000):
        x = (rng.standard_normal((n, 2)) * 0.7).astype(np.float32)
        (pa, ca), (pb, cb) = (e.process_interleaved(x) for e in (host, card))
        assert ca == cb and np.array_equal(pa, pb)
    assert dd.launches["decimate_shaped"] == before + 3
    sa, sb = host.state_dict(), card.state_dict()
    assert np.array_equal(sa["feedback"], sb["feedback"])
    assert np.array_equal(sa["tpdf"], sb["tpdf"])
    for h in ("xh", "yh"):
        assert np.array_equal(getattr(sa["shaper"], h),
                              getattr(sb["shaper"], h))
