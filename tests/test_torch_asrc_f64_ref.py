"""Config 5's drifting streams on art64's float64 path
(``BatchedASRC(dtype=float64)``), at a small size on the CPU (4 streams,
380 taps and 380 filters, 2,048-frame calls from the stream's start, the
ratios drifting every call as the ``asrc5_bulk_f64`` cell drifts them; the
kernels' plain versions), against the benchmark's plain float64 reference
(``bench_torch/reference/asrc.py``):

- counts: exact, through the reference's ``replay``;
- positions: each call's starting position (``get_position()``) within
  1e-11 frames of the replay's I + f.  Both add the same float64 K/r; the
  engine adds it to an offset kept in its input buffer's coordinates
  (hundreds to thousands of frames, as the C reference keeps
  ``outputOffset``), which rounds at ~1e-12 frames at this call size;
- samples at the program's positions (the replay's call geometry, the
  engine's offset as the fraction): within 1e-12 of the reference's RMS,
  float64 windows, bank and dots; the float32 engine fails that bound;
- samples at the replay's I + f: within 1e-10 of the RMS, the class that
  the positions' rounding (offset + k/r summed at another magnitude) sets.

Marked ``cuda`` (skip without a card): N calls of the float64 engine make
N launches of K4 (``launches["asrc_step_f64"]``), and a profiled call
holds exactly one ``art.launch.asrc_step_f64`` span.

    python -m pytest tests/test_torch_asrc_f64_ref.py -q
    python -m pytest --noconftest -q -m cuda tests/test_torch_asrc_f64_ref.py
"""

import json

import numpy as np
import pytest
import torch

from art_tpu_torch import BatchedASRC
from art_tpu_torch.ops import asrc_step as kasrc
from art_tpu_torch.utils import spans
from bench_torch import harness, traffic
from bench_torch.reference import asrc as asrc_ref
from bench_torch.reference.bank import phase_bank

CFG = json.loads((harness.HERE / "configs" /
                  "asrc_config5_256x380_f64.json").read_text())
S, N, CALLS, T0 = 4, 2048, 8, 417
BOUND = 1e-12       # float64 windows, bank and dots at the same positions
TAPS = CFG["num_taps"]


def _engine(dtype, device="cpu"):
    c = CFG
    eng = BatchedASRC(S, c["num_taps"], c["num_filters"], dtype=dtype,
                      blackman_harris=c["blackman_harris"], hankel_kb=256,
                      lowpass_ratio=c["lowpass_ratio"], kernel="auto",
                      device=device)
    eng.advance_position(c["advance"])
    return eng


def _ratios(c):
    return traffic.drift(S, T0 + c, **CFG["drift"])


def _inputs(seed=22):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((S, N * CALLS), generator=g,
                       dtype=torch.float64) * 0.5


def _run(x, dtype):
    """Each call's (outputs [S, k_max] float64, counts [S], the engine's
    offsets and input index at the call's start)."""
    eng = _engine(dtype)
    calls = []
    for c in range(CALLS):
        o, idx = eng.offsets.copy(), eng.input_index
        out, Ks = eng.process(x[:, c * N:(c + 1) * N].to(
            torch.float64 if dtype == np.float64 else torch.float32),
            _ratios(c))
        calls.append((out.double(), Ks.copy(), o, idx))
    return calls


def _gaps(x, calls, starts, at_program: bool):
    """The largest gap of the program's outputs from the reference's over
    the reference outputs' RMS, over every call."""
    bank = phase_bank(TAPS, CFG["num_filters"],
                      lowpass=CFG["lowpass_ratio"])
    log = traffic.StreamLog([x])
    for c in range(CALLS):
        log.add(0, c * N, N)
    err, sq, count = 0.0, 0.0, 0
    for c, (out, _, o, idx) in enumerate(calls):
        I, f, K = starts[c]
        if at_program:      # the same position, split as the engine keeps it
            I, f = np.full(S, N * c - idx, np.int64), o
        a = N * c - TAPS
        seg = log.segment(a, N * (c + 1), "cpu")
        ref = asrc_ref.outputs(seg, a, I, f, _ratios(c), K, out.shape[1],
                               bank=bank)
        err = max(err, float((out - ref).abs().max()))
        sq += float(ref.square().sum())
        count += int(K.sum())
    return err / (sq / count) ** 0.5


@pytest.fixture(scope="module")
def streams():
    x = _inputs()
    calls = _run(x, np.float64)
    mismatch, starts = asrc_ref.replay([c[1] for c in calls], _ratios, N,
                                       taps=TAPS, want=range(CALLS))
    return x, calls, mismatch, starts


def test_counts_exact_and_positions_within_their_rounding(streams):
    _, calls, mismatch, starts = streams
    assert mismatch == 0
    assert all(c[1].sum() > 0 for c in calls)
    for c, (_, _, o, idx) in enumerate(calls):
        I, f, _ = starts[c]
        # the engine's position of its next output, from the stream's start
        gap = (o - idx + N * c) - (I + f)
        assert np.abs(gap).max() < 1e-11, (c, gap)


def test_float64_samples_at_the_program_positions_within_1e_12(streams):
    x, calls, _, starts = streams
    assert _gaps(x, calls, starts, at_program=True) < BOUND


def test_float64_samples_at_the_replay_positions_within_their_class(streams):
    x, calls, _, starts = streams
    assert _gaps(x, calls, starts, at_program=False) < 1e-10


def test_float32_engine_fails_the_float64_bound(streams):
    x, _, _, starts = streams
    calls = _run(x, np.float32)
    assert [c[1].tolist() for c in calls] == \
        [c[1].tolist() for c in streams[1]]
    assert _gaps(x, calls, starts, at_program=True) > BOUND


# ------------------------------------------------------------- on a card
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is "
                    "False): K4 is a CUDA kernel with no CPU form")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_float64_calls_launch_k4_once_each_with_one_span():
    dev = _card()
    eng = _engine(np.float64, device=dev)
    x = _inputs().to(dev)
    before = kasrc.launches["asrc_step_f64"]
    for c in range(CALLS - 1):
        eng.process(x[:, c * N:(c + 1) * N], _ratios(c))
    assert kasrc.launches["asrc_step_f64"] == before + CALLS - 1
    cpu = torch.profiler.ProfilerActivity.CPU
    with torch.profiler.profile(activities=[cpu]) as prof:
        eng.process(x[:, (CALLS - 1) * N:], _ratios(CALLS - 1))
    torch.cuda.synchronize(dev)
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count(spans.LAUNCH + "asrc_step_f64") == 1
    assert names.count(spans.LAUNCH + "asrc_step") == 0
    assert kasrc.launches["asrc_step_f64"] == before + CALLS
