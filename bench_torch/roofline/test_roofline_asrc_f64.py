"""K4's roofline at a config-5 call (``roofline/asrc_step_f64.py``): the
float32 call's operations at the plain FP64 rate bound it, 0.381 ms; and
``metrics/asrc_step_f64_roofline_pct.py`` times K4 alone, by its typed
name, among K2's and K5's launches.  Runs on the CPU:
python -m pytest bench_torch/roofline -q"""

import importlib.util
from types import SimpleNamespace

import pytest

from bench_torch import harness, peaks, trace
from bench_torch.roofline import asrc_step, asrc_step_f64, k1_f64

# 256 streams of 32,768 frames at ratios averaging 1: 256 x 32,768 valid
# outputs, a 380-tap bank of 381 rows
SHAPE = dict(streams=256, hist=6080, inputs=32768, bank_rows=381,
             taps=380, k_max=33280)
VALID = 256 * 32768


def test_k4_config5_call_is_bound_by_its_dfmas():
    nbytes, ops = asrc_step_f64.counts(**SHAPE, valid_outputs=VALID)
    nbytes32, ops32 = asrc_step.counts(**SHAPE, valid_outputs=VALID)
    assert ops == ops32 and nbytes == 2 * nbytes32 - 20 * 256
    ms, what = peaks.bound_ms(nbytes, ops, k1_f64.PEAK_F64_PLAIN)
    assert (round(ms, 3), what) == (0.381, "operations")
    assert asrc_step_f64.least_s(**SHAPE, valid_outputs=VALID) * 1e3 == ms


class _Trace:
    kernel = trace.Trace.kernel

    def __init__(self, ops):
        self.device_ops = ops


def test_metric_reads_k4_alone():
    spec = importlib.util.spec_from_file_location(
        "m", harness.HERE / "metrics" / "asrc_step_f64_roofline_pct.py")
    metric = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(metric)
    fixed = {k: v for k, v in SHAPE.items() if k != "k_max"}
    entry = SimpleNamespace(roofline={"asrc_step_f64": dict(
        fixed, calls=[(SHAPE["k_max"], VALID)] * 2)})
    ms = 1e6     # ns
    ops = [(0, 3 * ms, "void asrc_step_kernel<double, false>(double*)"),
           (0, 1 * ms, "void asrc_step_kernel<float, false>(float*)"),
           (0, 5 * ms, "void asrc_step_kernel<float, true>(float*)"),
           (0, 3 * ms, "void asrc_step_kernel<double, false>(double*)")]
    run = SimpleNamespace(entry=entry, trace=_Trace(ops))
    least = asrc_step_f64.least_s(**SHAPE, valid_outputs=VALID)
    assert metric.read(run) == pytest.approx(100 * least / 3e-3)
    run.trace = _Trace(ops[1:3])
    assert metric.read(run) is None
    run.trace = None
    assert metric.read(run) is None
