"""The check of the float64 chain cell (``checks_chain.py``), driven
through a whole run of ``c4b_chain_f64`` at its ``rehearse`` size on the
CPU (the kernels' plain versions):

- a sound run is correct, and a run with the float32 reference chain in
  the program's place (``--control 1``) is not: it fails ``sample_err``;
- with the chain broken underneath, the run is not correct: the
  cascade's state reset to zero at every call; the biquad coefficients
  rounded to float32; one section left out; K1's dots taken in float32;
  one output off by 1e-9.

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from bench_torch import run

CELL = "c4b_chain_f64"


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


def _cascade():
    from art_tpu_torch.ops import biquad_kernel
    return biquad_kernel, biquad_kernel.DeviceBiquadCascade


def _state_reset(mp):
    _, casc = _cascade()
    process = casc.process

    def reset(self, *a):
        self._state = torch.zeros_like(self._state)
        return process(self, *a)
    mp.setattr(casc, "process", reset)


def _coefficients_f32(mp):
    from art_tpu_torch.engines import biquad
    init = biquad.Biquad.init.__func__

    def rounded(cls, *a, **k):
        bq = init(cls, *a, **k)
        bq.a = bq.a.astype(np.float32).astype(bq.a.dtype)
        bq.b = bq.b.astype(np.float32).astype(bq.b.dtype)
        return bq
    mp.setattr(biquad.Biquad, "init", classmethod(rounded))


def _section_left_out(mp):
    bk, casc = _cascade()

    def first_only(self, dev_out, K):
        y, head = bk._run(dev_out.T, self._sections[:1], self._state[:2],
                          int(K), out_sn=True)
        self._state = torch.cat([head, self._state[2:]])
        return y
    mp.setattr(casc, "process", first_only)


def _k1_dots_f32(mp):
    from art_tpu_torch.ops import fixed_step
    dots = fixed_step.window_dots

    def f32(win, P, *a, **k):
        return dots(win.float(), P.float(), *a, **k).to(win.dtype)
    mp.setattr(fixed_step, "window_dots", f32)


def _output_off(mp):
    from art_tpu_torch.parallel import streams
    flat = streams.DeviceStreamResampler.process_flat_out

    def off(self, *a):
        out, Ks = flat(self, *a)
        out = out.clone()
        out[0, 3] += 1e-9
        return out, Ks
    mp.setattr(streams.DeviceStreamResampler, "process_flat_out", off)


FAULTS = {"state_reset": _state_reset,
          "coefficients_f32": _coefficients_f32,
          "section_left_out": _section_left_out,
          "k1_dots_f32": _k1_dots_f32,
          "output_off_1e-9": _output_off}


@pytest.mark.parametrize("fault", FAULTS)
def test_fault_fails(capsys, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    result = _run(capsys)
    assert result["correct"] is False, result["checks"]
    assert result["checks"]["count_mismatch"]["value"] == 0
