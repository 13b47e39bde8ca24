"""The port's spans (``art_tpu_torch/utils/spans.py``) as a profiler
records them.

On the CPU: each public engine call gives one ``art.engine.call`` span,
holding one ``art.engine.plan`` span and an ``art.engine.upload`` span for
each host-to-device copy, all inside a span the test opens around the
call (so they sit on the profiler's one clock); plan spans never nest;
with no profiler a span is one shared null context; the benchmark's
readers (``bench_torch/spans.py``) spell the names the program emits.

Marked ``cuda`` (skip without a card): a launch of the ASRC step kernel
gives one ``art.launch.asrc_step`` span and one count in ``launches``, and
the kernel's device event starts after its launch span starts.

    python -m pytest tests/test_torch_trace.py -q
    python -m pytest --noconftest -q -m cuda tests/test_torch_trace.py
"""

import contextlib

import numpy as np
import pytest
import torch

from art_tpu_torch import (BLACKMAN_HARRIS, INCLUDE_LOWPASS,
                           SUBSAMPLE_INTERPOLATE, BatchedASRC,
                           DeviceStreamResampler)
from art_tpu_torch.ops import asrc_step as kasrc
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
    cpu = torch.device("cpu")
    assert spans.upload(np.zeros(2), cpu) is off
    with torch.profiler.profile(activities=[CPU]):
        assert spans.span(spans.CALL) is not off
        assert spans.upload(torch.zeros(2), cpu) is off
        assert spans.upload(np.zeros(2), cpu) is not off


def test_benchmark_readers_spell_the_names_the_program_emits():
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


@pytest.mark.cuda
def test_step_kernel_starts_after_its_launch_span():
    dev = _card()
    eng = BatchedASRC(4, 48, 48, device=dev)
    eng.advance_position(24)
    ratios = 1.0 + 0.01 * np.sin(0.1 * np.arange(4) + 0.3)
    x = np.random.default_rng(4).normal(0, 0.5, (4, 512)).astype(np.float32)
    eng.process(x, ratios)
    torch.cuda.synchronize()
    cuda = torch.profiler.ProfilerActivity.CUDA
    calls = 3
    with torch.profiler.profile(activities=[CPU, cuda]) as prof:
        for _ in range(calls):
            eng.process(x, ratios)
        torch.cuda.synchronize()
    host, device = [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if "asrc_step_kernel" in e.name() and not e.is_user_annotation():
                device.append(e.start_ns())
        elif e.name() == spans.LAUNCH + "asrc_step":
            host.append(e.start_ns())
    host.sort()
    device.sort()
    # the profiler drops a device event now and then, never a host span; a
    # kernel of a later call starts later still, so the i-th kernel starts
    # after the i-th launch span whichever events were dropped
    assert len(host) == calls and 1 <= len(device) <= calls, (host, device)
    assert all(d > h for h, d in zip(host, device)), (host, device)
