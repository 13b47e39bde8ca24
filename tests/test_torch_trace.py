"""The port's spans (``art_tpu_torch/utils/spans.py``) as a profiler
records them.

On the CPU: each public engine call gives one ``art.engine.call`` span,
holding one ``art.engine.plan`` span and an ``art.engine.upload`` span for
each host-to-device copy, all inside a span the test opens around the
call (so they sit on the profiler's one clock); plan spans never nest;
with no profiler a span is one shared null context; the benchmark's
readers (``bench_torch/spans.py``, ``metrics/decimate_host_ms.bulk.py``,
``metrics/biquad_host_ms.bulk.py``) spell the names the program emits,
and the biquad reader sums its spans' union less the CUDA runtime calls
inside over a synthetic trace; each public decimator call
(``DeviceDecimator.process_chunk`` / ``process_chunk_async``,
``Decimator(backend="torch")``) gives one ``art.engine.decimate`` span,
and each ``DeviceBiquadCascade.process`` one ``art.engine.biquad`` span;
each piece of one-time host work is one build in the tally
(``spans.builds``) and, while a profiler records, one ``art.build.*``
span: a bank at an engine's construction, a phase matrix or P's hulls on
a miss and none on a hit, a library's load; an entry point's first launch
is one build and every later one the shared null context; while a
profiler records, every span name, the plan's too, is the bare record
scope and reads no host clock.

Marked ``cuda`` (skip without a card): a launch of the ASRC step kernel
gives one ``art.launch.asrc_step`` span and one count in ``launches``, and
the kernel's device event starts after its launch span starts (in a
profiler session whose probe kernels find its device clock aligned with
its host clock); a
``DeviceDecimator`` call on the card holds its one launch span inside its
``art.engine.decimate`` span, and a ``DeviceBiquadCascade`` call its one
``art.launch.biquad`` span (two launches) inside its
``art.engine.biquad`` span.

    python -m pytest tests/test_torch_trace.py -q
    python -m pytest --noconftest -q -m cuda tests/test_torch_trace.py
"""

import contextlib
import time

import numpy as np
import pytest
import torch

from art_tpu_torch import (BLACKMAN_HARRIS, INCLUDE_LOWPASS,
                           SUBSAMPLE_INTERPOLATE, BatchedASRC,
                           DeviceStreamResampler)
from art_tpu_torch.core.flags import DITHER_HIGHPASS, SHAPING_ATH_CURVE
from art_tpu_torch.engines.biquad import Biquad, biquad_lowpass
from art_tpu_torch.engines.decimator import Decimator, DeviceDecimator
from art_tpu_torch.ops import _build
from art_tpu_torch.ops import asrc_step as kasrc
from art_tpu_torch.ops import biquad_kernel as bk
from art_tpu_torch.ops import decimate_device as dd
from art_tpu_torch.ops import fixed_step as k1
from art_tpu_torch.utils import spans

CPU = torch.profiler.ProfilerActivity.CPU
OUTER = "test.outer"
IB = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS
REDUCED = (2, 64, 380, 44100, 48000, 0, IB | INCLUDE_LOWPASS)  # M = 147
PRESET1 = (1, 48, 48, 44100, 48000, 0, IB)      # interpolated, M = 147


def _profiled(fn):
    """(fn's result, [(name, start ns, end ns)] of every host event), with
    fn run inside a span named OUTER."""
    with torch.profiler.profile(activities=[CPU]) as prof:
        with torch.profiler.record_function(OUTER):
            result = fn()
    evs = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CPU]
    return result, evs


def _named(evs, name):
    return [e for e in evs if e[0] == name]


def _inside(e, outer):
    return outer[1] <= e[1] and e[2] <= outer[2]


def _check_call(evs, uploads: int):
    """One call span inside OUTER, holding one plan span and ``uploads``
    upload spans; no plan span inside another."""
    (outer,) = _named(evs, OUTER)
    (call,) = _named(evs, spans.CALL)
    assert _inside(call, outer)
    plans = _named(evs, spans.PLAN)
    assert len(plans) == 1 and _inside(plans[0], call)
    ups = _named(evs, spans.UPLOAD)
    assert len(ups) == uploads
    assert all(_inside(u, call) for u in ups)


def _asrc(s=4):
    eng = BatchedASRC(s, 48, 48, device="cpu")
    eng.advance_position(24)
    ratios = 1.0 + 0.01 * np.sin(0.1 * np.arange(s) + 0.3)
    return eng, ratios


@pytest.mark.parametrize("host", [True, False], ids=["numpy", "tensor"])
def test_batched_asrc_process_and_flush_spans(host):
    """process: its input's upload when it comes from the host, then the
    plan's offsets, ratios and counts; flush: the plan's three."""
    eng, ratios = _asrc()
    x = np.random.default_rng(1).normal(0, 0.5, (4, 512)).astype(np.float32)
    x = x if host else torch.from_numpy(x)
    (out, Ks), evs = _profiled(lambda: eng.process(x, ratios))
    _check_call(evs, uploads=4 if host else 3)
    assert Ks.sum() > 0 and out.shape[0] == 4
    (_, Ks), evs = _profiled(lambda: eng.flush(ratios))
    assert Ks.max() > 0
    _check_call(evs, uploads=3)


def _stream(ctor):
    eng = DeviceStreamResampler(*ctor, device="cpu")
    eng.advance_position(ctor[1] // 2)
    return eng


def _matrix_uploads(eng) -> int:
    """The host-to-device copies the engine has made for its phase
    matrices: one a reduced anchor matrix; the bank once, then three an
    interpolated pattern."""
    if eng.interp:
        return 3 * len(eng._interp_cache) + (eng._bank_dev is not None)
    return len(eng._mats)


@pytest.mark.parametrize("ctor", [REDUCED, PRESET1],
                         ids=["reduced", "interp"])
def test_device_stream_process_and_flat_out_spans(ctor):
    """process and process_flat_out on host input: one upload for the
    input, and, inside the plan, the uploads of the phase matrices the
    call builds."""
    eng = _stream(ctor)
    rng = np.random.default_rng(2)
    n = 40 * eng.M
    for call in (lambda: eng.process(x, n),
                 lambda: eng.process_flat_out(x, n)):
        x = rng.normal(0, 0.5, (ctor[0], 2 * n)).astype(np.float32)
        before = _matrix_uploads(eng)
        (_, K), evs = _profiled(call)
        assert np.sum(K) > 0
        _check_call(evs, uploads=1 + _matrix_uploads(eng) - before)
        (plan,) = _named(evs, spans.PLAN)
        ups = _named(evs, spans.UPLOAD)
        assert sum(_inside(u, plan) for u in ups) == len(ups) - 1


def test_split_and_scan_fallback_keep_one_call_and_flat_plans(monkeypatch):
    """A chunk that fails the float64-tie oracle: process() splits it and
    process_scan() falls back to sequential chunks, each still one call
    span whose plan spans do not nest."""
    orig = DeviceStreamResampler._pattern_safe
    fired = {}

    def flaky(self, *args, **kw):
        if fired.get(id(self), 0) < 1:
            fired[id(self)] = 1
            return False
        return orig(self, *args, **kw)

    monkeypatch.setattr(DeviceStreamResampler, "_pattern_safe", flaky)
    rng = np.random.default_rng(3)
    xs = rng.normal(0, 0.5, (3, 1, 1500)).astype(np.float32)
    for call in (lambda e: e.process(xs[0], 1500),
                 lambda e: e.process_scan(torch.from_numpy(xs), 1500)):
        eng = _stream(PRESET1)
        fired.clear()
        _, evs = _profiled(lambda: call(eng))
        assert fired
        (call_span,) = _named(evs, spans.CALL)
        plans = _named(evs, spans.PLAN)
        assert plans and all(_inside(p, call_span) for p in plans)
        assert not any(_inside(p, q) for p in plans for q in plans
                       if p is not q)


def test_span_without_a_profiler_is_the_shared_null_context():
    assert not torch.autograd._profiler_enabled()
    off = spans.span(spans.CALL)
    assert isinstance(off, contextlib.nullcontext)
    assert spans.span("another") is off
    assert spans.span(spans.PLAN) is off
    cpu = torch.device("cpu")
    assert spans.upload(np.zeros(2), cpu) is off
    with torch.profiler.profile(activities=[CPU]):
        assert spans.span(spans.CALL) is not off
        assert spans.upload(torch.zeros(2), cpu) is off
        assert spans.upload(np.zeros(2), cpu) is not off


def test_benchmark_readers_spell_the_names_the_program_emits(monkeypatch):
    from bench_torch import spans as readers
    eng, ratios = _asrc()
    _, evs = _profiled(lambda: eng.process(np.zeros((4, 256), np.float32),
                                           ratios))
    flat = _stream(REDUCED)
    n = 21 * flat.M
    flat.process(np.zeros((2, n), np.float32), n)
    _, more = _profiled(lambda: flat.process_flat_out(
        np.zeros((2, 2 * n), np.float32), n))
    emitted = {e[0] for e in evs + more}
    assert {readers.CALL, readers.PLAN, readers.UPLOAD} <= emitted
    assert (readers.CALL, readers.PLAN, readers.UPLOAD, readers.LAUNCH) == \
        (spans.CALL, spans.PLAN, spans.UPLOAD, spans.LAUNCH)
    # the host clocks' reader: the build spans and the kinds it sums
    from bench_torch import host_clocks as clocks
    assert clocks.BUILD == spans.BUILD
    eng, built = _profiled(lambda: _stream(REDUCED))
    assert clocks.BUILD + "bank" in {e[0] for e in built}
    eng._matrix(1)
    k1._hulls_of(eng._matrix(1))
    with spans.first_launch(("test.readers", id(eng))):
        pass
    monkeypatch.setattr(_build, "_geometry_lib", None)
    _build.geometry_library()
    kinds = {what for what, _ in spans.builds}
    assert {*clocks.LIBRARY, *clocks.FIRST_LAUNCH, *clocks.SETUP_BUILDS} \
        <= kinds


def _builds(what: str) -> tuple[int, int]:
    """(builds of kind ``what`` tallied with no profiler recording, those
    tallied while one recorded)."""
    return tuple(spans.builds.get((what, rec), [0, 0])[0]
                 for rec in (False, True))


@pytest.mark.parametrize("make", ["stream", "interp", "asrc", "biquad"])
def test_an_engine_tallies_its_bank_at_construction(make):
    ctor = {"stream": lambda: _stream(REDUCED),
            "interp": lambda: _stream(PRESET1),
            "asrc": lambda: _asrc()[0],
            "biquad": lambda: _biquad_cascade("cpu")}[make]
    before = _builds("bank")
    ctor()
    assert _builds("bank") == (before[0] + 1, before[1])
    _, evs = _profiled(ctor)
    assert _builds("bank") == (before[0] + 1, before[1] + 1)
    assert len(_named(evs, spans.BUILD + "bank")) == 1


def _lookups():
    """(kind, a lookup to make twice) for each cache the program builds
    on a miss."""
    reduced, interp = _stream(REDUCED), _stream(PRESET1)
    P = torch.zeros((4 * 147, 160))
    P[100:300] = 1.0
    return {"matrix": ("matrix", lambda: reduced._matrix(5)),
            "interp_matrix": ("matrix",
                              lambda: interp._interp_matrix(24.25)),
            "hulls": ("hulls", lambda: k1._hulls_of(P))}


@pytest.mark.parametrize("case", ["matrix", "interp_matrix", "hulls"])
def test_a_miss_is_one_build_and_a_hit_none(case):
    """The first lookup builds, in one build span while a profiler
    records (the matrix's upload inside it); the second builds nothing."""
    what, lookup = _lookups()[case]
    before = _builds(what)
    first, evs = _profiled(lookup)
    (built,) = _named(evs, spans.BUILD + what)
    if what == "matrix":
        assert [u for u in _named(evs, spans.UPLOAD) if _inside(u, built)]
    assert _builds(what) == (before[0], before[1] + 1)
    again, evs = _profiled(lookup)
    assert not _named(evs, spans.BUILD + what)
    assert _builds(what) == (before[0], before[1] + 1)
    assert (again is first) if what == "matrix" else \
        all(a is b for a, b in zip(again, first))


def test_a_library_load_is_one_build(monkeypatch):
    monkeypatch.setattr(_build, "_geometry_lib", None)
    before = _builds("library")
    lib = _build.geometry_library()
    assert _build.geometry_library() is lib
    assert _builds("library") == (before[0] + 1, before[1])


def test_a_first_launch_is_one_build_then_the_shared_null_context():
    """What a launch wrapper adds with no profiler recording: one set
    lookup, and after the first launch the shared null context."""
    key = ("test.entry", object())
    before = _builds("first_launch")
    with spans.first_launch(key):
        pass
    assert _builds("first_launch") == (before[0] + 1, before[1])
    assert spans.first_launch(key) is spans.span(spans.CALL)
    with spans.first_launch(key):
        pass
    assert _builds("first_launch") == (before[0] + 1, before[1])


def test_nested_builds_each_tally_their_own_time():
    """A build inside another is the inner one's alone, so the tally's
    times add up to no more than the wall time."""
    before = {w: spans.builds.get((w, False), [0, 0])[1]
              for w in ("test.outer", "test.inner")}
    t0 = time.perf_counter_ns()
    with spans.build("test.outer"):
        with spans.build("test.inner"):
            time.sleep(0.02)
    wall = time.perf_counter_ns() - t0
    own = {w: spans.builds[(w, False)][1] - before[w] for w in before}
    assert own["test.inner"] >= 20_000_000 > own["test.outer"] >= 0
    assert own["test.outer"] + own["test.inner"] <= wall


@pytest.mark.parametrize("name", ["CALL", "PLAN", "UPLOAD", "DECIMATE",
                                  "BIQUAD"])
def test_a_recorded_span_is_the_bare_scope_and_reads_no_clock(name,
                                                               monkeypatch):
    """While a profiler records, ``span()`` gives the record scope and
    nothing around it: no host clock is read inside a span, so a span's
    wall time is its body's."""
    reads = []
    with torch.profiler.profile(activities=[CPU]):
        for clock in ("perf_counter_ns", "thread_time_ns", "monotonic_ns"):
            monkeypatch.setattr(time, clock, lambda c=getattr(time, clock):
                                reads.append(1) or c())
        scope = spans.span(getattr(spans, name))
        with scope:
            pass
        monkeypatch.undo()
    assert type(scope) is spans._scope
    assert not reads


HP_ATH = DITHER_HIGHPASS | SHAPING_ATH_CURVE


def _one_decimate_span(evs):
    (outer,) = _named(evs, OUTER)
    (dec,) = _named(evs, spans.DECIMATE)
    assert _inside(dec, outer)
    return dec


@pytest.mark.parametrize("call", ["process_chunk", "process_chunk_async"])
def test_device_decimator_call_gives_one_span(call):
    dec = DeviceDecimator(8, 16, 2, 1.0, 44100, HP_ATH, tracks=4,
                          device="cpu")
    x = torch.zeros((96, 8), dtype=torch.float32)
    _, evs = _profiled(lambda: getattr(dec, call)(x, 90))
    _one_decimate_span(evs)


def test_torch_decimator_call_gives_one_span():
    dec = Decimator(2, 16, 2, 1.0, 44100, HP_ATH, backend="torch",
                    device="cpu")
    _, evs = _profiled(lambda: dec.process(np.zeros((2, 50), np.float32)))
    _one_decimate_span(evs)
    host = Decimator(2, 16, 2, 1.0, 44100, HP_ATH)
    _, evs = _profiled(lambda: host.process(np.zeros((2, 50), np.float32)))
    assert not _named(evs, spans.DECIMATE)


def _reader(name):
    """The benchmark's reader of metric ``name``
    (``bench_torch/metrics/<name>.py``)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "bench_torch" / \
        "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_decimate_reader_spells_the_program_span():
    assert _reader("decimate_host_ms.bulk").DECIMATE == spans.DECIMATE


def _biquad_cascade(device, ch=6):
    """The art -p pre-filter at 48k -> 44.1k, two sections from zero
    state, on ``device``."""
    coeffs = biquad_lowpass(0.45 * 44100 / 48000)
    secs = [Biquad.init(coeffs, 1.0, channels=ch, dtype=np.float64)
            for _ in range(2)]
    casc = bk.DeviceBiquadCascade(*secs, device=device)
    casc.push_from(*secs)
    return casc


def test_biquad_cascade_call_gives_one_span():
    casc = _biquad_cascade("cpu")
    x = torch.zeros((6, 300), dtype=torch.float64)
    solved, launched = bk.plain_calls["biquad"], bk.launches["biquad"]
    _, evs = _profiled(lambda: casc.process(x, 300))
    (outer,) = _named(evs, OUTER)
    (call,) = _named(evs, spans.BIQUAD)
    assert _inside(call, outer)
    assert bk.plain_calls["biquad"] == solved + 2
    assert bk.launches["biquad"] == launched


def test_biquad_reader_reads_the_program_span():
    import functools
    from types import SimpleNamespace

    from bench_torch.trace import Trace
    mod = _reader("biquad_host_ms.bulk")
    assert mod.BIQUAD == spans.BIQUAD
    # two calls over [0, 1000) ns; three biquad spans, two of them
    # overlapping, with 50 + 20 ns of CUDA runtime calls inside them
    ops = [(100, 300, spans.BIQUAD), (250, 400, spans.BIQUAD),
           (600, 700, spans.BIQUAD), (150, 200, "cudaLaunchKernel"),
           (640, 660, "cudaLaunchKernel"), (800, 900, spans.DECIMATE)]
    trace = SimpleNamespace(
        window=(0, 1000), calls=np.array([[0, 500], [500, 1000]]),
        ops=sorted(ops), busy=np.zeros((0, 2), np.int64),
        runtime=np.array([[150, 200], [640, 660]], np.int64))
    trace.covered = functools.partial(Trace.covered, trace)
    ms = mod.read(SimpleNamespace(trace=trace))
    assert ms == pytest.approx((300 + 100 - 70) / 2 * 1e-6)
    assert mod.read(SimpleNamespace(trace=None)) is None
    trace.ops = [o for o in trace.ops if o[2] != spans.BIQUAD]
    assert mod.read(SimpleNamespace(trace=trace)) is None


# ------------------------------------------------------------- on a card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False); the launch spans sit in the kernels' CUDA "
                    "paths, which have no CPU form")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_asrc_step_launch_gives_one_span_and_one_count():
    dev = _card()
    eng, ratios = _asrc()
    eng.process(np.zeros((4, 512), np.float32), ratios)
    x = torch.zeros((4, 512), dtype=torch.float32, device=dev)
    _, Ks, k_max, _ = eng._plan(512, ratios, None)
    t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=dev)
    args = (t(eng.hist, torch.float32), x,
            t(eng.bank, torch.float32), t(eng.offsets, torch.float64),
            t(ratios, torch.float64), t(Ks, torch.int32),
            eng.num_samples - eng.input_index)
    before = kasrc.launches["asrc_step"]
    _, evs = _profiled(lambda: kasrc.asrc_step_kernel(
        *args, num_taps=eng.num_taps, num_filters=eng.num_filters,
        k_max=k_max))
    torch.cuda.synchronize()
    assert kasrc.launches["asrc_step"] == before + 1
    assert len(_named(evs, spans.LAUNCH + "asrc_step")) == 1


PROBE = "test.probe"


def _launch_order(eng, x, ratios, calls: int):
    """One profiler session of ``calls`` engine calls between two probe
    kernels: (the launch spans' starts, the step kernels' starts, whether
    the session's device clock agrees with its host clock).  The profiler
    puts each session's device events on the host's clock by an alignment
    of its own, which now and then lands hundreds of us off for the whole
    session; a probe kernel launched on an idle device then reads as
    starting before the runtime call that launched it (matched by
    correlation id), and the session cannot order a kernel against its
    span."""
    cuda = torch.profiler.ProfilerActivity.CUDA
    probe = torch.zeros(1, device=eng.device)

    def probe_launch():
        torch.cuda.synchronize()
        with torch.profiler.record_function(PROBE):
            probe.add_(1.0)
        torch.cuda.synchronize()

    with torch.profiler.profile(activities=[CPU, cuda]) as prof:
        probe_launch()
        for _ in range(calls):
            eng.process(x, ratios)
        torch.cuda.synchronize()
        probe_launch()
    host, device, probes, launched, kernels = [], [], [], {}, {}
    for e in prof.profiler.kineto_results.events():
        name, start = e.name(), e.start_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation():
                kernels[e.correlation_id()] = start
                if "asrc_step_kernel" in name:
                    device.append(start)
        elif name == spans.LAUNCH + "asrc_step":
            host.append(start)
        elif name == PROBE:
            probes.append((start, start + e.duration_ns()))
        elif name.startswith("cudaLaunchKernel"):
            launched[e.correlation_id()] = start
    probed = [(t, kernels.get(c)) for c, t in launched.items()
              if any(a <= t <= b for a, b in probes)]
    aligned = len(probed) == 2 and all(k is not None and k > t
                                       for t, k in probed)
    return sorted(host), sorted(device), aligned


@pytest.mark.cuda
def test_step_kernel_starts_after_its_launch_span():
    dev = _card()
    eng = BatchedASRC(4, 48, 48, device=dev)
    eng.advance_position(24)
    ratios = 1.0 + 0.01 * np.sin(0.1 * np.arange(4) + 0.3)
    x = np.random.default_rng(4).normal(0, 0.5, (4, 512)).astype(np.float32)
    eng.process(x, ratios)
    torch.cuda.synchronize()
    calls, sessions = 3, 10
    for _ in range(sessions):
        host, device, aligned = _launch_order(eng, x, ratios, calls)
        if aligned:
            break
    assert aligned, f"no session of {sessions} aligned its device clock"
    # a dropped device event leaves the i-th kernel one of a later call,
    # which starts later still
    assert len(host) == calls and 1 <= len(device) <= calls, (host, device)
    assert all(d > h for h, d in zip(host, device)), (host, device)


@pytest.mark.cuda
def test_device_decimator_launch_sits_in_its_decimate_span():
    dev = _card()
    dec = DeviceDecimator(64, 16, 2, 1.0, 44100, HP_ATH, tracks=32,
                          device=dev)
    out = torch.randn((64, 3000), device=dev) * 0.25   # K1's layout
    dec.process_chunk_async(out.T, 2990)
    torch.cuda.synchronize()
    launched = dd.launches["decimate_shaped"]
    _, evs = _profiled(lambda: dec.process_chunk_async(out.T, 2990))
    torch.cuda.synchronize()
    span = _one_decimate_span(evs)
    (launch,) = _named(evs, spans.LAUNCH + "decimate_shaped")
    assert _inside(launch, span)
    assert dd.launches["decimate_shaped"] == launched + 1


@pytest.mark.cuda
def test_biquad_cascade_launch_sits_in_its_biquad_span():
    dev = _card()
    casc = _biquad_cascade(dev)
    x = torch.randn((6, 20000), dtype=torch.float64, device=dev) * 0.25
    casc.process(x, 20000)
    torch.cuda.synchronize()
    launched = bk.launches["biquad"]
    _, evs = _profiled(lambda: casc.process(x, 20000))
    torch.cuda.synchronize()
    (outer,) = _named(evs, OUTER)
    (call,) = _named(evs, spans.BIQUAD)
    (launch,) = _named(evs, spans.LAUNCH + "biquad")
    assert _inside(call, outer) and _inside(launch, call)
    assert bk.launches["biquad"] == launched + 2
