"""The host engines' accelerator backend against JAX's, on the CPU.

The port's ``backend="torch"`` takes the place of JAX's ``backend="jax"``.
Here it runs with ``device="cpu"``, so every kernel takes its plain
version; the same seeded numpy inputs go through both packages:

- ``ops/polyphase.PolyphaseKernel.apply`` (K1's contraction) against JAX's
  (a stride-M ``conv_general_dilated``), over several (L, M, j0, lowpass),
  in float32 and float64;
- ``ops/resample_kernel.apply_torch`` (K5's two-phase dot) against
  ``apply_jax``, interpolated and not, with passthrough, and at F = 1024
  non-interpolated, whose phase index reaches F;
- ``Resampler(backend="torch")`` against JAX's ``Resampler(backend="jax")``
  in 777-frame blocks plus the flush, in four modes, each call on the
  branch JAX takes; ``state_dict`` resumes across backends;
- ``Decimator(backend="torch")`` against JAX's ``backend="jax"`` (bitwise
  in float32) and the host decimator (float64, where JAX's scan is
  FMA-contracted by XLA:CPU);
- the port's top level exports what ``art_tpu``'s does, and the torch
  backend raises without a card.

Tolerances: counts and positions exact; samples within 2e-6 in float32
(JAX's own bound between its backends, tests/test_resampler_api.py) and
1e-12 in float64; the decimator bitwise.
"""

import ast
import importlib
import math
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import art_tpu
from art_tpu.core import flags as JF
from art_tpu.engines.decimator import Decimator as JDecimator
from art_tpu.engines.resampler import Resampler as JResampler
from art_tpu.ops import polyphase as jpoly
from art_tpu.ops import resample_kernel as jrk
import art_tpu_torch
from art_tpu_torch.core.filters import make_filter_bank
from art_tpu_torch.engines.decimator import Decimator as TDecimator
from art_tpu_torch.engines.resampler import Resampler as TResampler
from art_tpu_torch.ops import polyphase as tpoly
from art_tpu_torch.ops import resample_kernel as trk

IBL = JF.SUBSAMPLE_INTERPOLATE | JF.BLACKMAN_HARRIS | JF.INCLUDE_LOWPASS
TOL = {np.float32: 2e-6, np.float64: 1e-12}


def _close(a, b, dtype):
    assert a.dtype == b.dtype == np.dtype(dtype) and a.shape == b.shape
    assert np.abs(a.astype(np.float64) - b).max(initial=0.0) <= TOL[dtype]


# ------------------------------------------------------------ the two ops
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("L,M,j0,lowpass,taps", [
    (160, 147, 0, True, 64), (160, 147, 37, True, 64),
    (147, 160, 100, True, 48), (2, 1, 1, False, 32), (160, 147, 5, False,
                                                      48)])
def test_polyphase_kernel_matches_jax(L, M, j0, lowpass, taps, dtype):
    bank = make_filter_bank(taps, L, 0.9 if lowpass else 1.0, True, dtype)
    ratio = L / M
    a = jpoly.PolyphaseKernel(bank, L, lowpass, ratio)
    b = tpoly.PolyphaseKernel(bank, L, lowpass, ratio, device="cpu")
    rng = np.random.default_rng(L + j0)
    buf = rng.normal(0, 0.5, (2, 40 * M + 3 * taps)).astype(dtype)
    for offset, K in ((taps // 2 + j0 / L, 30 * L + 7),
                      (taps + 3 + j0 / L, 4 * L),
                      # the anchor rounds up to the next sample
                      (taps + 2 + (L - 1e-12) / L, 5 * L + 1)):
        assert a.eligible(offset, K) == b.eligible(offset, K)
        _close(a.apply(buf, offset, K, dtype), b.apply(buf, offset, K,
                                                       dtype), dtype)
    np.testing.assert_array_equal(a.matrix(j0).P, b.matrix(j0).P)


def _parts(F, taps, interpolate, lowpass, n_buf, K, seed):
    """decompose_positions of K seeded positions over a buffer of n_buf,
    a quarter of them on integer samples and a quarter a hair below the
    next one (the non-interpolated phase index reaches F there)."""
    rng = np.random.default_rng(seed)
    pos = np.sort(rng.uniform(taps, n_buf - taps - 1, K))
    pos[::4] = np.floor(pos[::4])
    pos[1::4] = np.floor(pos[1::4]) + 1.0 - 0.2 / F
    return trk.decompose_positions(pos, F, taps, interpolate, lowpass)


@pytest.mark.parametrize("F,taps,interpolate,lowpass,dtype", [
    (48, 48, True, True, np.float32),
    (380, 64, False, True, np.float32),
    (160, 48, False, False, np.float32),
    (1024, 64, False, True, np.float32),
    (1024, 32, False, False, np.float64),
    (64, 48, True, True, np.float64)],
    ids=["interp", "exact", "exact allpass", "exact F1024",
         "exact F1024 allpass f64", "interp f64"])
def test_apply_torch_matches_apply_jax(F, taps, interpolate, lowpass, dtype):
    bank = make_filter_bank(taps, F, 0.9 if lowpass else 1.0, True, dtype)
    n_buf, K = 3000, 1500
    parts = _parts(F, taps, interpolate, lowpass, n_buf, K, F + taps)
    if not interpolate:
        assert (parts["fi"] == F).any()
        assert parts["pass_mask"].any() == (not lowpass)
    L = np.random.default_rng(F).normal(0, 0.5, (2, n_buf)).astype(dtype)
    a = jrk.apply_jax(L, jnp.asarray(bank), parts, interpolate, dtype)
    b = trk.apply_torch(L, torch.from_numpy(bank), parts, interpolate, dtype)
    _close(a, b, dtype)
    c = trk.apply_numpy(L, bank, parts, interpolate, dtype)
    _close(c, b, dtype)
    if not lowpass:             # the passthrough samples, exactly
        m = parts["pass_mask"]
        np.testing.assert_array_equal(b[:, m], L[:, parts["pass_idx"][m]])


# ------------------------------------------------------------ the engines
MODES = {
    # fixed ratio, reduced: the polyphase path (K1) and the apply (K5)
    "fixed reduced": ((2, 48, 380, 44100, 48000, 0, IBL), np.float32,
                      None),
    # fixed ratio at an irrational ratio: interpolated, the apply
    "fixed interpolated": ((2, 48, 48, 44100, 47999, 0, IBL), np.float32,
                           None),
    # the runtime ratio drifting per call (artest without -e)
    "runtime drift": ((2, 48, 48, 0.9, IBL), np.float32,
                      lambda j: 1.0884 + 0.002 * math.sin(0.7 * j)),
    "float64 extrapolated": ((2, 64, 380, 48000, 44100, 0,
                              IBL | JF.EXTRAPOLATE_ENDPOINTS), np.float64,
                             None),
}


def _make(cls, mode, backend, **kw):
    ctor, dtype, drift = MODES[mode]
    make = cls if drift else cls.fixed_ratio
    eng = make(*ctor, dtype=dtype, backend=backend, **kw)
    eng.advance_position(ctor[1] / 2.0)
    return eng


def _stream(eng, mode, sig, blocks):
    """The blocks of ``sig`` from ``blocks[0]`` to ``blocks[1]`` (777
    frames each, the flush after the last one when it is None): (outputs,
    [(input used, output generated, position)])."""
    drift = MODES[mode][2]
    outs, res = [], []
    b0, b1 = blocks
    for j in range(b0, b1 if b1 is not None else -(-sig.shape[1] // 777)):
        blk = sig[:, j * 777:(j + 1) * 777]
        o, r = eng.process(blk, blk.shape[1], 4 * 777 + 64,
                           drift(j) if drift else 0.0)
        outs.append(o[:, :r.output_generated])
        res.append((r.input_used, r.output_generated, eng.get_position()))
    if b1 is None:
        o, r = eng.process(None, -1, 4096, drift(999) if drift else 0.0)
        outs.append(o[:, :r.output_generated])
        res.append((r.input_used, r.output_generated, eng.get_position()))
    return np.concatenate(outs, axis=1), res


def _signal(mode, n=9000):
    dtype = MODES[mode][1]
    return (np.random.default_rng(42).standard_normal((2, n))
            * 0.4).astype(dtype)


def _count_branches(monkeypatch, poly_mod, rk_mod, apply_name):
    counts = {"poly": 0, "apply": 0}
    orig_poly = poly_mod.PolyphaseKernel.apply
    orig_apply = getattr(rk_mod, apply_name)

    def poly(self, *a, **k):
        counts["poly"] += 1
        return orig_poly(self, *a, **k)

    def apply(*a, **k):
        counts["apply"] += 1
        return orig_apply(*a, **k)

    monkeypatch.setattr(poly_mod.PolyphaseKernel, "apply", poly)
    monkeypatch.setattr(rk_mod, apply_name, apply)
    return counts


@pytest.mark.parametrize("mode", list(MODES))
def test_resampler_torch_matches_jax(mode, monkeypatch):
    sig = _signal(mode)
    jc = _count_branches(monkeypatch, jpoly, jrk, "apply_jax")
    tc = _count_branches(monkeypatch, tpoly, trk, "apply_torch")
    a, ra = _stream(_make(JResampler, mode, "jax"), mode, sig, (0, None))
    b, rb = _stream(_make(TResampler, mode, "torch", device="cpu"), mode,
                    sig, (0, None))
    assert ra == rb
    _close(a, b, MODES[mode][1])
    assert jc == tc and tc["apply"] > 0
    assert (tc["poly"] > 0) == (mode in ("fixed reduced",
                                         "float64 extrapolated"))


@pytest.mark.parametrize("first,then", [("numpy", "torch"),
                                        ("torch", "numpy")])
def test_state_dict_resumes_across_backends(first, then):
    """A state_dict taken under one backend resumes under the other: the
    resumed stream's counts and positions equal one backend's run through,
    its samples within the float32 class."""
    mode = "fixed reduced"
    sig = _signal(mode)
    kw = {"device": "cpu"}
    a = _make(TResampler, mode, first, **kw)
    head, rh = _stream(a, mode, sig, (0, 5))
    b = _make(TResampler, mode, then, **kw)
    b.load_state(a.state_dict())
    tail, rt = _stream(b, mode, sig, (5, None))
    ref, rr = _stream(_make(TResampler, mode, "numpy"), mode, sig,
                      (0, None))
    assert rh + rt == rr
    _close(ref, np.concatenate([head, tail], axis=1), np.float32)


DECIMATORS = [
    (2, 16, JF.DITHER_HIGHPASS | JF.SHAPING_ATH_CURVE, 44100, np.float32),
    (1, 24, JF.DITHER_FLAT | JF.SHAPING_2ND_ORDER, 48000, np.float32),
    (3, 12, JF.SHAPING_3RD_ORDER, 96000, np.float32),
    (2, 8, JF.DITHER_LOWPASS, 44100, np.float32),
    (2, 16, JF.DITHER_LOWPASS | JF.SHAPING_ATH_CURVE, 48000, np.float64),
]


@pytest.mark.parametrize("ch,bits,flags,rate,dtype", DECIMATORS)
def test_decimator_torch_matches_jax(ch, bits, flags, rate, dtype):
    """Bytes, clip counts, feedback, shaper histories and generators
    bitwise, over ragged blocks, interleaved and planar; float64 against
    the host decimator (JAX's float64 scan is FMA-contracted on XLA:CPU,
    ROADMAP.md section 3)."""
    nbytes = (bits + 7) // 8
    ref = JDecimator(ch, bits, nbytes, 1.0, rate, flags, dtype=dtype,
                     backend="jax" if dtype == np.float32 else "numpy")
    got = TDecimator(ch, bits, nbytes, 1.0, rate, flags, dtype=dtype,
                     backend="torch", device="cpu")
    rng = np.random.default_rng(bits)
    for n in (600, 1, 0, 1100):
        x = (rng.standard_normal((n, ch)) * 0.45).astype(dtype)
        (pa, ca), (pb, cb) = (e.process_interleaved(x) for e in (ref, got))
        assert pa.dtype == pb.dtype and np.array_equal(pa, pb) and ca == cb
    (pa, ca), (pb, cb) = (e.process(np.ascontiguousarray(x.T))
                          for e in (ref, got))
    assert np.array_equal(pa, pb) and ca == cb
    assert ca > 0 or bits > 8
    sa, sb = ref.state_dict(), got.state_dict()
    for key in ("feedback", "tpdf"):
        assert (sa[key] is None) == (sb[key] is None)
        if sa[key] is not None:
            assert sa[key].dtype == sb[key].dtype
            np.testing.assert_array_equal(sa[key], sb[key])
    if sa["shaper"] is not None:
        for h in ("xh", "yh"):
            np.testing.assert_array_equal(getattr(sa["shaper"], h),
                                          getattr(sb["shaper"], h))


# ------------------------------------------------------ surface and refusals
def _jax_top_level_names():
    """The public names ``art_tpu/__init__.py`` binds by its imports (not
    ``dir(art_tpu)``, which also lists any submodule another test
    imported)."""
    names = set()
    for node in ast.parse(Path(art_tpu.__file__).read_text()).body:
        if isinstance(node, ast.ImportFrom):
            for alias in node.names:
                if alias.name == "*":
                    mod = importlib.import_module(
                        "." * node.level + node.module, "art_tpu")
                    names |= set(vars(mod))
                else:
                    names.add(alias.asname or alias.name)
    return {n for n in names if not n.startswith("_")}


def test_top_level_exports_match_jax():
    public = _jax_top_level_names()
    assert {"Resampler", "Decimator", "Stretcher", "flags",
            "BLACKMAN_HARRIS"} <= public
    missing = sorted(n for n in public if not hasattr(art_tpu_torch, n))
    assert not missing
    assert art_tpu_torch.Resampler is TResampler
    assert art_tpu_torch.Decimator is TDecimator


@pytest.mark.parametrize("make", [
    lambda **kw: TResampler(2, 48, 48, 0.9, IBL, **kw),
    lambda **kw: TResampler.fixed_ratio(2, 48, 380, 44100, 48000, 0, IBL,
                                        **kw),
    lambda **kw: TDecimator(2, 16, 2, 1.0, 44100,
                            JF.DITHER_HIGHPASS | JF.SHAPING_ATH_CURVE, **kw)],
    ids=["Resampler", "Resampler.fixed_ratio", "Decimator"])
def test_torch_backend_refusals(make, monkeypatch):
    """Without a card the torch backend raises (device None means "cuda"),
    also when asked for cuda by name; backend="jax" names "torch"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="is_available"):
            make(backend="torch", **kw)
    with pytest.raises(ValueError, match="backend='torch'"):
        make(backend="jax")
