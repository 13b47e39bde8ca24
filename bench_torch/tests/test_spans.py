"""The per-layer metrics that read the program's own spans
(``bench_torch/spans.py``, ``metrics/{plan,upload,step_host,engine_idle}_ms
.*.py``):

- a traced rehearsal of each cell on the CPU prints every such metric that
  its cell lists and that finds its spans there: the plan and the uploads;
  the launch spans sit in the kernels' CUDA paths and the CPU trace holds
  no device activity, so ``step_host_ms.*`` and ``engine_idle_ms.*`` are
  left out of the line;
- their ``BENCHMARK.json`` entries name only cells that exist;
- the readers merge nested spans before summing, take off what the given
  intervals cover, and give nothing where the spans are absent.

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import functools
import json
from types import SimpleNamespace

import numpy as np
import pytest

from bench_torch import harness, run, spans
from bench_torch.trace import Trace

SPAN_METRICS = ("plan_ms", "upload_ms", "step_host_ms", "engine_idle_ms")
ON_CPU = ("plan_ms", "upload_ms")


def _bench():
    return json.loads((harness.HERE.parent / "BENCHMARK.json").read_text())


def _span_metrics(bench):
    return [m for m in bench["per_layer"]
            if m["name"].split(".")[0] in SPAN_METRICS]


def test_span_metrics_name_only_cells_that_exist():
    bench = _bench()
    cells = {w["name"] for w in bench["workloads"]}
    metrics = _span_metrics(bench)
    assert len(metrics) == 8
    for m in metrics:
        assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]


@pytest.mark.parametrize("cell", ("p3_flat_bulk", "asrc5_bulk_32k",
                                  "asrc5_live_1k"))
def test_traced_rehearsal_prints_the_span_metrics_of_its_cell(capsys, cell):
    code = run.main(["--rehearse", "--workload", cell, "--seed",
                     "3000000019", "--seconds", "0.3", "--trace", "1"])
    assert code == 0
    result = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert result["correct"] is True
    for m in _span_metrics(_bench()):
        if cell not in m["workloads"]:
            assert m["name"] not in result["metrics"]
        elif m["name"].split(".")[0] in ON_CPU:
            assert result["metrics"][m["name"]]["value"] > 0, m["name"]
        else:
            assert m["name"] not in result["metrics"], m["name"]


def _run(ops, busy=(), runtime=()):
    """A run whose trace holds two calls over [0, 1000) ns, the host
    events ``ops`` and the device intervals ``busy``."""
    trace = SimpleNamespace(
        window=(0, 1000), calls=np.array([[0, 500], [500, 1000]]),
        ops=sorted(ops), busy=np.array(busy, np.int64).reshape(-1, 2),
        runtime=np.array(runtime, np.int64).reshape(-1, 2))
    trace.covered = functools.partial(Trace.covered, trace)
    return SimpleNamespace(trace=trace)


def test_readers_merge_nesting_and_take_off_what_is_covered():
    ops = [(100, 300, spans.PLAN), (150, 250, spans.PLAN),
           (200, 400, spans.PLAN), (600, 700, spans.UPLOAD),
           (650, 680, "aten::copy_"), (800, 1200, spans.CALL),
           (50, 120, spans.LAUNCH + "asrc_step"),
           (100, 200, spans.LAUNCH + "fixed_step")]
    r = _run(ops, busy=[(850, 900)], runtime=[(60, 80), (190, 260)])
    ms = lambda *a, **k: spans.ms_per_call(r, *a, **k) * 1e6
    assert ms(spans.PLAN) == pytest.approx(150.0)      # 300 ns over 2 calls
    assert ms(spans.UPLOAD) == pytest.approx(50.0)
    assert ms(spans.CALL) == pytest.approx(100.0)      # clipped at 1000
    assert ms(spans.CALL, less=lambda t: t.busy) == pytest.approx(75.0)
    # launches: [50, 200) less the runtime's 20 + 10 ns inside it
    assert ms(spans.LAUNCH, less=lambda t: t.runtime) == pytest.approx(60.0)
    assert spans.ms_per_call(_run([(0, 10, "aten::add")]), spans.PLAN) \
        is None
    assert spans.ms_per_call(SimpleNamespace(trace=None), spans.PLAN) is None


def test_engine_idle_needs_device_activity():
    r = _run([(0, 400, spans.CALL)])
    assert harness.read_metric("engine_idle_ms.stream", r) is None
    r = _run([(0, 400, spans.CALL)], busy=[(100, 200)])
    assert harness.read_metric("engine_idle_ms.stream", r) == \
        pytest.approx(150e-6)
    assert harness.read_metric("engine_idle_ms.bulk", r) == \
        pytest.approx(150e-6)
