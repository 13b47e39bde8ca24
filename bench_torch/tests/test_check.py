"""The check that decides ``correct``, driven through a whole run of each
cell at its ``rehearse`` size on the CPU (the kernels' plain versions):

- a sound run is correct, and a run with the TF32 control put in the
  program's place (``--control 1``) is not: it fails ``sample_err``;
- with the timed path broken underneath, the run is not correct: a step
  that leaves the engine's state unchanged, half of the batch (channels
  or streams) left out, an output altered where it is produced.  The
  cells run on one card, so no exchange between cards can be left out.

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from bench_torch import run

CELLS = ("p3_flat_bulk", "asrc5_bulk_32k", "asrc5_live_1k")


def _run(capsys, cell, *extra):
    code = run.main(["--rehearse", "--workload", cell, "--seed",
                     "3000000019", "--seconds", "0.3", *extra])
    assert code == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_correct_and_control_fails(capsys, cell):
    result = _run(capsys, cell)
    checks = result["checks"]
    assert result["correct"] is True
    assert result["device"]["platform"] == "cpu"
    assert checks["count_mismatch"]["value"] == 0
    assert checks["sample_err"]["value"] < checks["sample_err"]["limit"]
    control = _run(capsys, cell, "--control", "1")
    assert control["correct"] is False, control["checks"]
    assert control["checks"]["sample_err"]["value"] > \
        control["checks"]["sample_err"]["limit"]


def _state_unchanged(mp):
    from art_tpu_torch.parallel import asrc, streams

    group_buf = streams._group_buf
    mp.setattr(streams, "_group_buf", lambda hist, *a: (
        group_buf(hist, *a)[0], hist))
    step = asrc.BatchedASRC._run_step
    mp.setattr(asrc.BatchedASRC, "_run_step", lambda self, *a: (
        self.hist, step(self, *a)[1]))


def _half_left_out(mp):
    """The second half of the rows (channels or streams) is not computed:
    its outputs are zeros."""
    def halve(out):
        out = out.clone() if torch.is_tensor(out) else out.copy()
        out[out.shape[0] // 2:] = 0
        return out
    _wrap_outputs(mp, halve)


def _answer_altered(mp):
    """One output of every call is off by a thousandth."""
    def alter(out):
        out = out.clone() if torch.is_tensor(out) else out.copy()
        out[0, 3] += 1e-3
        return out
    _wrap_outputs(mp, alter)


def _wrap_outputs(mp, edit):
    """``edit`` applied to the [rows, frames] outputs of every engine call
    the cells make."""
    from art_tpu_torch.parallel import asrc, streams

    flat = streams.DeviceStreamResampler.process_flat_out
    mp.setattr(streams.DeviceStreamResampler, "process_flat_out",
               lambda self, *a: _edit_first(flat(self, *a), edit))
    step = asrc.BatchedASRC.process
    mp.setattr(asrc.BatchedASRC, "process",
               lambda self, *a, **k: _edit_first(step(self, *a, **k), edit))


def _edit_first(result, edit):
    return (edit(result[0]), *result[1:])


FAULTS = {"state_unchanged": _state_unchanged,
          "half_left_out": _half_left_out,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", CELLS)
def test_fault_fails(capsys, monkeypatch, cell, fault):
    FAULTS[fault](monkeypatch)
    result = _run(capsys, cell)
    assert result["correct"] is False, result["checks"]


def test_tf32_rounds_to_ten_bits():
    from bench_torch.reference.bank import tf32
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -10, -(1 + 3 * 2 ** -12)])
    assert tf32(x).tolist() == [1 + 2 ** -10, 1 + 2 ** -10, -(1 + 2 ** -10)]
    assert np.all(np.isfinite(tf32(torch.randn(100)).numpy()))
