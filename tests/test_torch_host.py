"""The port keeps its own host layer: it imports nothing of the JAX package,
and its copies of the host modules equal the originals bit for bit.

- A fresh interpreter that imports every module of ``art_tpu_torch`` and
  ``chip_smoke`` has neither ``jax`` nor any ``art_tpu`` module loaded.
- No file of ``art_tpu_torch/`` and not ``chip_smoke.py`` names ``art_tpu``
  in an import statement.
- Filter banks, fixed-ratio plans, consume/emit plans and ring floors, the
  artest noise and fades, and the phase-anchor matrices of the copies
  (``art_tpu_torch/core``, ``ops/polyphase.py``, ``utils/testsig.py``) are
  bitwise equal to the originals' on a seeded sweep."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from art_tpu.core import accounting as j_acc
from art_tpu.core import filters as j_filters
from art_tpu.core import flags as j_flags
from art_tpu.ops.polyphase import PolyphaseMatrix as JPolyphaseMatrix
from art_tpu.utils import testsig as j_testsig
from art_tpu_torch.core import accounting as t_acc
from art_tpu_torch.core import filters as t_filters
from art_tpu_torch.core import flags as t_flags
from art_tpu_torch.ops.polyphase import PolyphaseMatrix as TPolyphaseMatrix
from art_tpu_torch.utils import testsig as t_testsig

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "art_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def test_import_loads_neither_jax_nor_art_tpu():
    code = ("import importlib, pkgutil, sys\n"
            "import art_tpu_torch, art_tpu_torch.parallel.asrc, chip_smoke\n"
            "for m in pkgutil.walk_packages(art_tpu_torch.__path__, "
            "'art_tpu_torch.'):\n"
            "    importlib.import_module(m.name)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'art_tpu' or "
            "m.startswith('art_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(3 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_modules(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_art_tpu(path):
    bad = [m for m in _imported_modules(path)
           if m == "art_tpu" or m.startswith("art_tpu.")]
    assert not bad, f"{path.name} imports {bad}"


def test_flags_equal():
    names = [n for n in dir(j_flags) if n.isupper()]
    assert names and names == [n for n in dir(t_flags) if n.isupper()]
    for n in names:
        assert getattr(t_flags, n) == getattr(j_flags, n), n
    for taps, filters in ((48, 64), (3, 8), (380, 0), (2048, 8)):
        outcomes = []
        for mod in (j_flags, t_flags):
            try:
                mod.validate_taps_filters(taps, filters)
                outcomes.append(None)
            except ValueError as e:
                outcomes.append(str(e))
        assert outcomes[0] == outcomes[1]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("taps,filters,lowpass,bh", [
    (48, 64, 1.0, True), (380, 380, 1.0, True), (64, 128, 0.7, True),
    (88, 67, 0.93, False), (380, 160, 0.9521, True), (156, 320, 1.0, False)])
def test_filter_bank_bitwise(taps, filters, lowpass, bh, dtype):
    a = j_filters.make_filter_bank(taps, filters, lowpass, bh, dtype)
    b = t_filters.make_filter_bank(taps, filters, lowpass, bh, dtype)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("src,dst,lp,flags", [
    (44100, 48000, 0, 0x7), (48000, 44100, 0, 0x7), (44100, 48000, 0, 0x3),
    (44100, 96000, 20000, 0x5), (44100.5, 48000, 0, 0x7),
    (48000, 44100, 0, 0x17)])
def test_fixed_ratio_plan_equal(src, dst, lp, flags):
    a = j_filters.plan_fixed_ratio(380, 380, src, dst, lp, flags)
    b = t_filters.plan_fixed_ratio(380, 380, src, dst, lp, flags)
    assert dataclasses.astuple(a) == dataclasses.astuple(b)
    assert (j_filters.resolve_lowpass(a.lowpass_ratio, a.flags)
            == t_filters.resolve_lowpass(b.lowpass_ratio, b.flags))


def _plan_kwargs(rng, taps):
    flags = int(rng.choice([j_flags.SUBSAMPLE_INTERPOLATE,
                            j_flags.RESAMPLE_FIXED_RATIO
                            | j_flags.RESAMPLER_SNAP_OFFSET,
                            j_flags.SUBSAMPLE_INTERPOLATE
                            | j_flags.EXTRAPOLATE_PREFILL,
                            j_flags.RESAMPLER_FLUSHED]))
    num_samples = taps * 16
    input_index = int(rng.integers(taps, num_samples + 1))
    return dict(output_offset=float(input_index - taps // 2
                                    + rng.uniform(-3.0, 2.0)),
                input_index=input_index, flags=flags, num_taps=taps,
                num_samples=num_samples, num_filters=int(rng.integers(1, 400)),
                fixed_ratio=float(rng.uniform(0.5, 2.0)),
                n_in=int(rng.choice([-1, 0, 1, 37, 1281, 4096, 9000])),
                n_out=int(rng.choice([0, 1, 50, 5000, 20000])),
                ratio=float(rng.uniform(0.4, 2.5)))


def test_plan_process_equal_on_seeded_sweep():
    rng = np.random.default_rng(20261016)
    for _ in range(400):
        kw = _plan_kwargs(rng, int(rng.choice([48, 88, 380])))
        a = j_acc.plan_process(**kw)
        b = t_acc.plan_process(**kw)
        assert dataclasses.astuple(a) == dataclasses.astuple(b), kw
    assert t_acc.snap_offset(123.4567, 147) == j_acc.snap_offset(123.4567,
                                                                  147)


def test_plan_process_equal_through_the_slide_tie():
    """The fuzz seed 5113 float64 tie (tests/test_asrc.py
    test_asrc_slide_tie_boundary_counts), chained over three calls: the
    second call emits 1395 (1394 would be the entry-coordinate count)."""
    taps, ratio = 88, 48000 / 44100
    state = dict(output_offset=float(taps // 2 + 26.25), input_index=taps)
    seen = []
    for _ in range(3):
        kw = dict(state, flags=j_flags.SUBSAMPLE_INTERPOLATE, num_taps=taps,
                  num_samples=taps * 16, num_filters=67, fixed_ratio=0.0,
                  n_in=1281, n_out=4000, ratio=ratio)
        a, b = j_acc.plan_process(**kw), t_acc.plan_process(**kw)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        seen.append(b.output_generated)
        state = dict(output_offset=b.new_output_offset,
                     input_index=b.new_input_index)
    assert seen[1] == 1395


def test_ring_floor_equal_on_seeded_sweep():
    rng = np.random.default_rng(7)
    for taps in (48, 88, 380):
        ns = taps * 16
        for _ in range(50):
            i0 = int(rng.integers(taps, ns + 1))
            o0 = i0 - taps // 2 + rng.uniform(-2.0, 1.0, 64)
            q = np.arange(64) / rng.uniform(0.3, 3.0, 64)
            avail = int(rng.integers(0, 5000))
            a = j_acc.ring_floor(o0, q, i0, avail, ns, taps)
            b = t_acc.ring_floor(o0, q, i0, avail, ns, taps)
            assert a.dtype == b.dtype and np.array_equal(a, b)
            assert (j_acc._ring_floor(float(o0[0]), float(q[5]), i0, avail,
                                      ns, taps)
                    == t_acc._ring_floor(float(o0[0]), float(q[5]), i0,
                                         avail, ns, taps))


def test_ring_positions_equal_on_seeded_sweep():
    """Chained real plans (slides, flush calls, the flush shift) through
    both copies: integer positions and fractions bitwise equal."""
    rng = np.random.default_rng(20261017)
    for taps in (48, 88, 380):
        ns = taps * 16
        state = dict(output_offset=float(taps // 2) + rng.uniform(0, 1),
                     input_index=taps)
        ratio = float(rng.uniform(0.4, 2.5))
        for n_in in (37, 1281, 4096, 9000, -1):
            plan = j_acc.plan_process(
                **state, flags=j_flags.SUBSAMPLE_INTERPOLATE, num_taps=taps,
                num_samples=ns, num_filters=64, fixed_ratio=0.0, n_in=n_in,
                n_out=20000, ratio=ratio)
            kw = dict(first_position=plan.first_position,
                      flush_shift=plan.flush_shift, ratio=ratio,
                      K=plan.output_generated,
                      input_index=state["input_index"],
                      input_used=plan.input_used, num_samples=ns,
                      num_taps=taps, flush=plan.flush)
            (ia, fa), (ib, fb) = (j_acc.ring_positions(**kw),
                                  t_acc.ring_positions(**kw))
            assert ia.dtype == ib.dtype and np.array_equal(ia, ib)
            assert np.array_equal(fa.view(np.uint64), fb.view(np.uint64))
            state = dict(output_offset=plan.new_output_offset,
                         input_index=plan.new_input_index)


@pytest.mark.parametrize("seed", [j_testsig.LCG_SEED, 1, 0xDEADBEEF])
def test_noise_and_fades_bitwise(seed):
    a, b = j_testsig.NoiseLCG(seed), t_testsig.NoiseLCG(seed)
    for count, dtype in ((1, np.float32), (4097, np.float32),
                         (1000, np.float64), (0, np.float32)):
        xa, xb = a.fill(count, dtype), b.fill(count, dtype)
        assert xa.dtype == xb.dtype and np.array_equal(xa, xb)
        assert a.state == b.state
    sig = j_testsig.NoiseLCG(seed).fill(2 * 4096).reshape(4096, 2)
    for fade in ("fade_in", "fade_out"):
        xa, xb = sig.copy(), sig.copy()
        getattr(j_testsig, fade)(xa)
        getattr(t_testsig, fade)(xb)
        assert np.array_equal(xa.view(np.uint32), xb.view(np.uint32))


@pytest.mark.parametrize("L,M,j0,lowpass", [
    (160, 147, 0, True), (160, 147, 77, False), (147, 160, 3, True),
    (147, 160, 0, False)])
def test_polyphase_matrix_bitwise(L, M, j0, lowpass):
    bank = j_filters.make_filter_bank(380, L, 1.0, True, np.float32)
    a = JPolyphaseMatrix(bank, L, M, j0, lowpass)
    b = TPolyphaseMatrix(bank, L, M, j0, lowpass)
    assert a.P.dtype == b.P.dtype and np.array_equal(a.P, b.P)
    assert np.array_equal(a.carry, b.carry)
    assert (a.L, a.M, a.S, a.T) == (b.L, b.M, b.S, b.T)
