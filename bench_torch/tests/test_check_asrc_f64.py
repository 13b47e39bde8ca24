"""The check of the float64 ASRC cell (``checks_asrc_f64.py``), driven
through a whole run of ``asrc5_bulk_f64`` at its ``rehearse`` size on the
CPU (the kernels' plain versions):

- a sound run is correct, and a run with the float32 control in the
  program's place (``--control 1``) is not: it fails ``sample_err``;
- with the float64 path broken underneath, the run is not correct: the
  program's dots rounded through float32; the history reset on every
  call; the positions advanced by K/r in float32; one output off by 1e-7
  (above the limit that float64's position rounding leaves room for, and
  below the float32 control).

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from bench_torch import run

CELL = "asrc5_bulk_f64"


def _run(capsys, *extra):
    code = run.main(["--rehearse", "--workload", CELL, "--seed",
                     "3000000019", "--seconds", "0.3", *extra])
    assert code == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_run_correct_and_control_fails(capsys):
    result = _run(capsys)
    checks = result["checks"]
    assert result["correct"] is True, checks
    assert result["device"]["platform"] == "cpu"
    assert checks["count_mismatch"]["value"] == 0
    assert checks["sample_err"]["value"] * 10 < checks["sample_err"]["limit"]
    control = _run(capsys, "--control", "1")
    assert control["correct"] is False, control["checks"]
    assert control["checks"]["sample_err"]["value"] > \
        10 * control["checks"]["sample_err"]["limit"]


def _engine():
    from art_tpu_torch.parallel import asrc
    return asrc, asrc.BatchedASRC


def _dots_f32(mp):
    asrc, _ = _engine()
    step = asrc.asrc_step

    def f32(hist, x, bank, *a, **k):
        new_hist, _ = step(hist, x, bank, *a, **k)
        _, out = step(hist.float(), x.float(), bank.float(), *a, **k)
        return new_hist, out.to(hist.dtype)
    mp.setattr(asrc, "asrc_step", f32)


def _history_reset(mp):
    _, eng = _engine()
    process = eng.process

    def reset(self, *a, **k):
        self.hist.zero_()
        return process(self, *a, **k)
    mp.setattr(eng, "process", reset)


def _positions_f32(mp):
    _, eng = _engine()
    process = eng.process

    def f32(self, x, ratios, *a, **k):
        out, Ks = process(self, x, ratios, *a, **k)
        r = np.asarray(ratios, np.float64)
        step32 = (Ks.astype(np.float32) / r.astype(np.float32))
        self.offsets = self.offsets - Ks / r + step32.astype(np.float64)
        return out, Ks
    mp.setattr(eng, "process", f32)


def _output_off(mp):
    _, eng = _engine()
    process = eng.process

    def off(self, *a, **k):
        out, Ks = process(self, *a, **k)
        out = out.clone()
        out[0, 3] += 1e-7
        return out, Ks
    mp.setattr(eng, "process", off)


FAULTS = {"dots_f32": _dots_f32,
          "history_reset": _history_reset,
          "positions_f32": _positions_f32,
          "output_off_1e-7": _output_off}


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_fails(capsys, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    result = _run(capsys)
    assert result["correct"] is False, result["checks"]
