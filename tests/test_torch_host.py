"""The port keeps its own host layer: it imports nothing of the JAX package,
and its copies of the host modules equal the originals bit for bit.

- A fresh interpreter that imports every module of ``art_tpu_torch`` and
  ``chip_smoke`` has neither ``jax`` nor any ``art_tpu`` module loaded.
- No file of ``art_tpu_torch/`` and not ``chip_smoke.py`` names ``art_tpu``
  in an import statement, and no module under ``ops/`` imports the engine
  layer (``parallel/``, ``engines/``).
- Filter banks, fixed-ratio plans, consume/emit plans and ring floors, the
  artest noise and fades, and the phase-anchor matrices of the copies
  (``art_tpu_torch/core``, ``ops/polyphase.py``, ``utils/testsig.py``) are
  bitwise equal to the originals' on a seeded sweep.
- So are the copied host engines and their I/O (``engines/``, ``io/``,
  ``native/``, the dry-run accounting, tones, stats and checksums): the
  host ``Resampler``'s outputs and state, ``Decimator`` bytes and clip
  counts on both backends, biquad cascades, the extrapolator, the
  stretcher, WAV headers and decoding, and the port's own build of the
  native library, entry point by entry point.
- So are the numpy parts of ``ops/biquad_kernel.py``: the block-IIR tables
  and ``combine_biquads`` with its refusal of order-3/4 sections."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import art_tpu.native as j_native
import art_tpu_torch.native as t_native
from art_tpu.core import accounting as j_acc
from art_tpu.core import filters as j_filters
from art_tpu.core import flags as j_flags
from art_tpu.engines import biquad as j_biquad
from art_tpu.engines import extrapolator as j_extrap
from art_tpu.engines.decimator import Decimator as JDecimator
from art_tpu.engines.resampler import Resampler as JResampler
from art_tpu.engines.stretch import Stretcher as JStretcher
from art_tpu.io import wavfile as j_wav
from art_tpu.ops.polyphase import PolyphaseMatrix as JPolyphaseMatrix
from art_tpu.utils import testsig as j_testsig
from art_tpu_torch.core import accounting as t_acc
from art_tpu_torch.core import filters as t_filters
from art_tpu_torch.core import flags as t_flags
from art_tpu_torch.engines import biquad as t_biquad
from art_tpu_torch.engines import extrapolator as t_extrap
from art_tpu_torch.engines.decimator import Decimator as TDecimator
from art_tpu_torch.engines.resampler import Resampler as TResampler
from art_tpu_torch.engines.stretch import Stretcher as TStretcher
from art_tpu_torch.io import wavfile as t_wav
from art_tpu_torch.ops.polyphase import PolyphaseMatrix as TPolyphaseMatrix
from art_tpu_torch.utils import testsig as t_testsig

REPO = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((REPO / "art_tpu_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def test_import_loads_neither_jax_nor_art_tpu():
    code = ("import importlib, pkgutil, sys\n"
            "import art_tpu_torch, art_tpu_torch.parallel.asrc, chip_smoke\n"
            "import art_tpu_torch.cli.art, art_tpu_torch.cli.artest\n"
            "for m in pkgutil.walk_packages(art_tpu_torch.__path__, "
            "'art_tpu_torch.'):\n"
            # the native runtime's ctypes library, once built, sits in its
            # package with a .so suffix: it is no Python module
            "    if not m.name.endswith('.libartnative'):\n"
            "        importlib.import_module(m.name)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'art_tpu' or "
            "m.startswith('art_tpu.'))\n"
            "print(bad)\n"
            "sys.exit(3 if bad else 0)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


def _imported_modules(path: Path):
    """Every module ``path`` imports, relative imports resolved against
    its package."""
    package = path.parent.relative_to(REPO).parts
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.ImportFrom):
            base = ".".join(package[:len(package) - node.level + 1])
            if node.module:
                yield f"{base}.{node.module}"
            else:
                yield from (f"{base}.{alias.name}" for alias in node.names)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_import_of_art_tpu(path):
    bad = [m for m in _imported_modules(path)
           if m == "art_tpu" or m.startswith("art_tpu.")]
    assert not bad, f"{path.name} imports {bad}"


@pytest.mark.parametrize("path", sorted(
    (REPO / "art_tpu_torch" / "ops").glob("*.py")), ids=lambda p: p.name)
def test_ops_import_no_engine(path):
    """The step wrappers and their plain versions sit below the engines:
    no module under ``ops/`` imports ``parallel/`` or ``engines/``."""
    bad = [m for m in _imported_modules(path)
           if m.split(".")[:2] in (["art_tpu_torch", "parallel"],
                                   ["art_tpu_torch", "engines"])]
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


def _bitwise(a, b):
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


IBL = (j_flags.SUBSAMPLE_INTERPOLATE | j_flags.BLACKMAN_HARRIS
       | j_flags.INCLUDE_LOWPASS)


@pytest.mark.parametrize("ctor,dtype", [
    ((2, 48, 380, 44100, 48000, 0, IBL), np.float32),
    ((2, 48, 380, 44100, 48000, 0, IBL | j_flags.EXTRAPOLATE_ENDPOINTS),
     np.float32),
    ((1, 48, 48, 44100, 48000, 0, IBL), np.float32),
    ((2, 64, 128, 48000, 44100, 20000, IBL), np.float64),
    ((2, 48, 64, 44100, 47999, 0, IBL | j_flags.NO_FILTER_REDUCTION),
     np.float32)])
def test_host_resampler_bitwise(ctor, dtype):
    """Fixed-ratio host engines over odd blocks, a planar call, an advance
    and the flush: outputs, results and state_dict equal."""
    a = JResampler.fixed_ratio(*ctor, dtype=dtype)
    b = TResampler.fixed_ratio(*ctor, dtype=dtype)
    rng = np.random.default_rng(11)
    for eng in (a, b):
        eng.advance_position(ctor[1] / 2.0)
    for n in (1000, 37, 4096, 1, 999, -1):
        x = None if n < 0 else rng.standard_normal((n, ctor[0])).astype(dtype)
        oa, ra = a.process_interleaved(x, n, 6000, 0.0)
        ob, rb = b.process_interleaved(x, n, 6000, 0.0)
        _bitwise(oa, ob)
        assert (ra.input_used, ra.output_generated) == (rb.input_used,
                                                        rb.output_generated)
        assert a.get_position() == b.get_position()
        sa, sb = a.state_dict(), b.state_dict()
        _bitwise(sa["history"], sb["history"])
        assert (sa["output_offset"], sa["input_index"], sa["flags"]) == (
            sb["output_offset"], sb["input_index"], sb["flags"])
    # the runtime-ratio engine (artest without -e), planar
    a = JResampler(2, 48, 48, 1.0, IBL & ~j_flags.INCLUDE_LOWPASS)
    b = TResampler(2, 48, 48, 1.0, IBL & ~j_flags.INCLUDE_LOWPASS)
    x = rng.standard_normal((2, 2000)).astype(np.float32)
    (oa, ra), (ob, rb) = (e.process_and_flush(x, 2000, 4000, 1.0884)
                          for e in (a, b))
    _bitwise(oa, ob)
    assert ra.output_generated == rb.output_generated


@pytest.mark.parametrize("backend", ["numpy", "native"])
@pytest.mark.parametrize("ch,bits,flags,rate,dtype", [
    (2, 16, j_flags.DITHER_HIGHPASS | j_flags.SHAPING_ATH_CURVE, 48000,
     np.float32),
    (1, 24, j_flags.DITHER_FLAT | j_flags.SHAPING_2ND_ORDER, 44100,
     np.float32),
    (3, 8, j_flags.DITHER_LOWPASS, 32000, np.float32),
    (6, 16, 0, 48000, np.float64),
    (2, 12, j_flags.DITHER_HIGHPASS | j_flags.SHAPING_ATH_CURVE, 96000,
     np.float64)])
def test_decimator_bitwise(ch, bits, flags, rate, dtype, backend):
    a = JDecimator(ch, bits, (bits + 7) // 8, 1.0, rate, flags, dtype=dtype,
                   backend=backend)
    b = TDecimator(ch, bits, (bits + 7) // 8, 1.0, rate, flags, dtype=dtype,
                   backend=backend)
    rng = np.random.default_rng(bits)
    for n in (1000, 1, 4097):
        x = (rng.standard_normal((n, ch)) * 0.45).astype(dtype)
        (pa, ca), (pb, cb) = (e.process_interleaved(x) for e in (a, b))
        _bitwise(pa, pb)
        assert ca == cb
    assert ca > 0 or bits > 8
    (pa, ca), (pb, cb) = (e.process(np.ascontiguousarray(x.T)) for e in (a, b))
    _bitwise(pa, pb)
    assert ca == cb


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_biquad_cascade_bitwise(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3000, 2)).astype(dtype)
    for design, freq in ((j_biquad.biquad_lowpass, 0.2),
                         (j_biquad.biquad_highpass, 0.05)):
        tdesign = getattr(t_biquad, design.__name__)
        assert design(freq) == j_biquad.BiquadCoefficients(
            **vars(tdesign(freq)))
        outs = []
        for mod, d in ((j_biquad, design), (t_biquad, tdesign)):
            c = d(freq)
            q1 = mod.Biquad.init(c, 1.0, 2, dtype)
            q2 = mod.Biquad.init(c, 1.0, 2, dtype)
            y = mod.apply_cascade([q1, q2], x[:1000])
            y2 = q1.apply_buffer(x[1000:], use_native=False)
            outs.append((y, y2, q1.xh, q1.yh))
        for u, v in zip(*outs):
            _bitwise(u, v)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("B,Q", [(256, 64), (64, 64), (16, 8)])
@pytest.mark.parametrize("design,freq", [("lowpass", 0.41), ("lowpass", 0.2),
                                         ("highpass", 0.05)])
def test_biquad_iir_tables_bitwise(design, freq, B, Q, dtype):
    """The block-IIR tables of ops/biquad_kernel.py (iir_tables' numpy body
    and _carry_power_tables), for a biquad and the combined order-4 pair."""
    import art_tpu.ops.biquad_kernel as j_bk
    import art_tpu_torch.ops.biquad_kernel as t_bk
    c = getattr(j_biquad, f"biquad_{design}")(freq)
    q = j_biquad.Biquad.init(c, 1.0, 2)
    for b in (q.b, j_bk.combine_biquads(q, q)[1]):
        AB = np.asarray(j_bk.iir_tables(b, B=B, Q=Q)[3], np.float64)
        for u, v in zip(j_bk._carry_power_tables(AB, Q),
                        t_bk._carry_power_tables(AB, Q)):
            _bitwise(u, v)
        for u, v in zip(j_bk.iir_tables(b, B=B, Q=Q, dtype=dtype),
                        t_bk.iir_tables(b, B=B, Q=Q, dtype=dtype)):
            _bitwise(np.asarray(u), v.numpy())


def test_combine_biquads_bitwise_and_refusal():
    import art_tpu.ops.biquad_kernel as j_bk
    import art_tpu_torch.ops.biquad_kernel as t_bk
    pairs = [(j_biquad.biquad_lowpass(0.41), j_biquad.biquad_lowpass(0.41)),
             (j_biquad.biquad_lowpass(0.2), j_biquad.biquad_highpass(0.05))]
    for c1, c2 in pairs:
        q1, q2 = (j_biquad.Biquad.init(c, 1.0, 2) for c in (c1, c2))
        for u, v in zip(j_bk.combine_biquads(q1, q2),
                        t_bk.combine_biquads(q1, q2)):
            _bitwise(u, v)
    order4 = j_biquad.Biquad.init(j_biquad.BiquadCoefficients(
        a0=2.2061, a1=0.606, a2=-0.2524, a3=-0.0737, b1=1.0587, b2=0.0676,
        b3=-0.6054, b4=-0.2738), 1.0, 1)
    q = j_biquad.Biquad.init(j_biquad.biquad_lowpass(0.3), 1.0, 1)
    for mod in (j_bk, t_bk):
        with pytest.raises(ValueError, match="order<=2"):
            mod.combine_biquads(q, order4)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_extrapolator_bitwise(dtype):
    rng = np.random.default_rng(4)
    sig = np.cumsum(rng.standard_normal(400)).astype(dtype) * dtype(0.01)
    for n_values, n_out in ((400, 24), (190, 190), (10, 5)):
        v = sig[:n_values]
        _bitwise(j_extrap.extrapolate_reverse(v, n_out),
                 t_extrap.extrapolate_reverse(v, n_out))
        _bitwise(j_extrap.extrapolate_forward(v, n_out),
                 t_extrap.extrapolate_forward(v, n_out))
        _bitwise(j_extrap.extrapolate_forward_host(v, n_out),
                 t_extrap.extrapolate_forward_host(v, n_out))


@pytest.mark.parametrize("ch,flags,ratio", [
    (2, 0, 1.25), (1, j_flags.STRETCH_DUAL_FLAG, 3.0),
    (2, j_flags.STRETCH_FAST_FLAG, 0.7)])
def test_stretcher_bitwise(ch, flags, ratio):
    x = j_testsig.NoiseLCG().fill(20000 * ch)
    a = JStretcher(44100 // 350, 44100 // 50, ch, flags)
    b = TStretcher(44100 // 350, 44100 // 50, ch, flags)
    for lo, hi in ((0, 7000), (7000, 20000)):
        blk = x[lo * ch:hi * ch]
        _bitwise(a.process(blk, hi - lo, ratio), b.process(blk, hi - lo,
                                                           ratio))
    _bitwise(a.flush(), b.flush())


@pytest.mark.parametrize("bits,ch,mask,is_float", [
    (16, 2, 3, False), (24, 6, 0x3F, False), (8, 3, 7, False),
    (32, 1, 4, False), (32, 2, 3, True), (64, 2, 3, True)])
def test_wav_header_and_decode_bitwise(bits, ch, mask, is_float):
    import io
    n, nbytes = 777, (bits + 7) // 8
    raw = np.random.default_rng(bits).integers(
        0, 256, n * ch * nbytes, dtype=np.uint8)
    if is_float:
        raw = (np.random.default_rng(bits).standard_normal(n * ch) * 0.5
               ).astype("<f4" if bits == 32 else "<f8").view(np.uint8)
    files = []
    for mod in (j_wav, t_wav):
        f = io.BytesIO()
        mod.write_wav_header(f, bits=bits, num_channels=ch, num_frames=n,
                             sample_rate=44100, channel_mask=mask)
        f.write(raw.tobytes())
        files.append(f.getvalue())
    assert files[0] == files[1]
    infos = [mod.read_wav_header(io.BytesIO(files[0]))
             for mod in (j_wav, t_wav)]
    assert dataclasses.astuple(infos[0]) == dataclasses.astuple(infos[1])
    for gain, dtype in ((1.0, np.float32), (0.7, np.float32),
                        (1.0, np.float64)):
        _bitwise(j_wav.decode_frames(raw.tobytes(), infos[0], gain, dtype),
                 t_wav.decode_frames(raw.tobytes(), infos[1], gain, dtype))
    frames = t_wav.decode_frames(raw.tobytes(), infos[1], 1.0, np.float32)
    for out_bits in (32, 64):
        assert (j_wav.encode_float_frames(frames, out_bits)
                == t_wav.encode_float_frames(frames, out_bits))


def test_simulate_accounting_equal_on_seeded_sweep():
    rng = np.random.default_rng(20261018)
    for _ in range(300):
        taps = int(rng.choice([48, 88, 380]))
        ns = taps * 16
        ii = int(rng.integers(taps, ns + 1))
        state = dict(output_offset=float(ii - taps // 2
                                         + rng.uniform(-3.0, 2.0)),
                     input_index=ii, num_samples=ns, num_taps=taps)
        ratio = float(rng.uniform(0.3, 3.0))
        n_out = int(rng.choice([0, 1, 50, 5000, 20000]))
        assert (j_acc.simulate_required_samples(**state, n_out=n_out,
                                                ratio=ratio)
                == t_acc.simulate_required_samples(**state, n_out=n_out,
                                                   ratio=ratio))
        flags = int(rng.choice([0, j_flags.RESAMPLE_FIXED_RATIO,
                                j_flags.RESAMPLER_FLUSHED]))
        n_in = int(rng.choice([-1, 0, 1, 37, 4096, 9000]))
        kw = dict(state, flags=flags, n_in=n_in, ratio=ratio,
                  fixed_ratio=float(rng.uniform(0.5, 2.0)))
        assert (j_acc.simulate_expected_output(**kw)
                == t_acc.simulate_expected_output(**kw))


def test_tones_stats_and_checksums_bitwise():
    for chans, freq in ((1, 1000 / 44100), (2, 0.1), (5, 3000 / 48000)):
        ta, tb = j_testsig.ToneGenerator(), t_testsig.ToneGenerator()
        for count in (4096, 1, 333):
            _bitwise(ta.fill(count, chans, freq), tb.fill(count, chans,
                                                          freq))
            assert ta.phase_angle == tb.phase_angle
    x = j_testsig.NoiseLCG().fill(3 * 5000).reshape(5000, 3)
    for dtype in (np.float32, np.float64):
        sa, sb = j_testsig.Stats(3, dtype), t_testsig.Stats(3, dtype)
        assert sa.display() == sb.display()        # the empty stream
        for blk in (x[:100], x[100:], x[:0]):
            sa.update(blk.astype(dtype))
            sb.update(blk.astype(dtype))
        assert sa.display() == sb.display()
    packed = (x.reshape(-1).view(np.uint8))[:9999]
    assert (j_testsig.checksum_bytes(packed, 7)
            == t_testsig.checksum_bytes(packed, 7))
    assert (j_testsig.checksum_bits(x.reshape(-1))
            == t_testsig.checksum_bits(x.reshape(-1)))


def test_native_library_is_the_ports_and_matches(monkeypatch):
    """The port builds its own copy of the native runtime (g++ is here)
    into its package directory and loads it; its entry points give the
    original library's results.  The load is made here, after any build a
    concurrent test process may have started has finished writing."""
    monkeypatch.setattr(t_native, "_lib", None)
    monkeypatch.setattr(t_native, "_tried", False)
    assert t_native.available() and j_native.available()
    assert t_native._LIB.parent == REPO / "art_tpu_torch" / "native"
    assert t_native._LIB != j_native._LIB
    rng = np.random.default_rng(9)
    vals = rng.integers(-(1 << 23), 1 << 23, (500, 2), dtype=np.int32)
    pa = j_native.pack_le(vals, 24, 3)
    _bitwise(pa, t_native.pack_le(vals, 24, 3))
    for dtype in (np.float32, np.float64):
        _bitwise(j_native.unpack_le(pa.reshape(-1), 0.5, 24, 3, dtype),
                 t_native.unpack_le(pa.reshape(-1), 0.5, 24, 3, dtype))
    x = (rng.standard_normal((700, 2)) * 0.6).astype(np.float32)
    gens_a = j_testsig.NoiseLCG().fill(2).view(np.uint32).copy()
    gens_b = gens_a.copy()
    fa, fb = np.zeros(2, np.float32), np.zeros(2, np.float32)
    ra = j_native.quantize(x, np.float32(32768), fa, gens_a, -1, None,
                           32767, -32768)
    rb = t_native.quantize(x, np.float32(32768), fb, gens_b, -1, None,
                           32767, -32768)
    _bitwise(ra[0], rb[0])
    assert ra[1] == rb[1] and ra[1] > 0
    _bitwise(fa, fb)
    _bitwise(gens_a, gens_b)
    v = np.cumsum(rng.standard_normal(300)).astype(np.float32) * 0.01
    _bitwise(j_native.extrapolate(v, 40, 1000),
             t_native.extrapolate(v, 40, 1000))
