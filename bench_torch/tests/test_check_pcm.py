"""The checks of the integer-PCM cells (``checks_pcm.py``), driven through a
whole run of each cell at its ``rehearse`` size on the CPU (the kernels'
plain versions):

- a sound run is correct, and a run with the TF32 control in the program's
  place (``--control 1``) is not;
- with the delivery path broken underneath, the run is not correct: one
  packed byte off; the highpass dither read as flat; the shaper's state
  left at what entered the call before; the shaper run in float64; the
  clips left uncounted; the lowest bit of a few codes flipped (one LSB
  off); the quantizer truncating instead of rounding; the high clip bound
  one code low.

    python -m pytest bench_torch/tests -q
"""

from __future__ import annotations

import json

import pytest
import torch

from bench_torch import run

BATCH, PACKED = "p2_cd16_1024trk", "p3_flat_int16"


def _run(capsys, cell, *extra, seconds="0.3"):
    code = run.main(["--rehearse", "--workload", cell, "--seed",
                     "3000000019", "--seconds", seconds, *extra])
    assert code == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("cell", (BATCH, PACKED))
def test_sound_run_correct_and_control_fails(capsys, cell):
    result = _run(capsys, cell)
    assert result["correct"] is True, result["checks"]
    assert result["device"]["platform"] == "cpu"
    control = _run(capsys, cell, "--control", "1")
    assert control["correct"] is False, control["checks"]
    name = "sample_err" if cell == BATCH else "code_mismatch"
    assert control["checks"][name]["value"] > \
        control["checks"][name]["limit"]


def _decimator_call(mp, edit):
    """``edit(self, result, entered)`` applied to what every
    ``DeviceDecimator.process_chunk_async`` call returns; ``entered`` is
    the state (fb, xh, yh) the call found."""
    from art_tpu_torch.engines.decimator import DeviceDecimator
    call = DeviceDecimator.process_chunk_async

    def wrapped(self, *a, **k):
        entered = (self.fb, self.xh, self.yh)
        return edit(self, call(self, *a, **k), entered)
    mp.setattr(DeviceDecimator, "process_chunk_async", wrapped)


def _byte_off_batch(mp):
    def edit(_self, result, _entered):
        packed = result[0].clone()
        packed[0, 3] += 1
        return packed, result[1]
    _decimator_call(mp, edit)


def _byte_off_packed(mp):
    from art_tpu_torch.parallel import streams
    call = streams.DeviceStreamResampler.process_flat_packed

    def wrapped(self, *a, **k):
        packed, Ks, clips = call(self, *a, **k)
        packed = packed.clone()
        packed.view(torch.uint8)[0, 5] ^= 0x40
        return packed, Ks, clips
    mp.setattr(streams.DeviceStreamResampler, "process_flat_packed",
               wrapped)


def _flat_dither(mp):
    from art_tpu_torch.engines.decimator import DeviceDecimator
    init = DeviceDecimator.__init__

    def wrapped(self, *a, **k):
        init(self, *a, **k)
        self.dither_type = 0
    mp.setattr(DeviceDecimator, "__init__", wrapped)


def _stale_shaper(mp):
    def edit(self, result, entered):
        self.fb, self.xh, self.yh = entered
        return result
    _decimator_call(mp, edit)


def _shaper_f64(mp):
    from art_tpu_torch.ops import decimate_device as dd
    shaped = dd.decimate_shaped

    def wrapped(samples, K, *, a, b, xh, yh, feedback, **kw):
        f64 = lambda t: torch.as_tensor(t).to(torch.float64)
        out = shaped(f64(samples), K, a=f64(a), b=f64(b), xh=f64(xh),
                     yh=f64(yh), feedback=f64(feedback), **kw)
        dt = samples.dtype
        return (*out[:3], *(t.to(dt) for t in out[3:]))
    mp.setattr(dd, "decimate_shaped", wrapped)


def _clips_dropped(mp):
    from art_tpu_torch.parallel import streams
    call = streams.DeviceStreamResampler.process_flat_packed

    def wrapped(self, *a, **k):
        packed, Ks, clips = call(self, *a, **k)
        return packed, Ks, torch.zeros_like(clips)
    mp.setattr(streams.DeviceStreamResampler, "process_flat_packed",
               wrapped)


def _lsb_off(mp):
    from art_tpu_torch.parallel import streams
    call = streams.DeviceStreamResampler.process_flat_packed

    def wrapped(self, *a, **k):
        packed, Ks, clips = call(self, *a, **k)
        packed = packed.clone()
        packed.view(torch.uint8)[0, 0:16:2] ^= 1     # low bytes, 8 codes
        return packed, Ks, clips
    mp.setattr(streams.DeviceStreamResampler, "process_flat_packed",
               wrapped)


def _truncating(mp):
    from art_tpu_torch.parallel import streams
    mp.setattr(streams, "_floor_half_up_exact",
               lambda code: torch.floor(code).to(torch.int64))


def _highclip_low(mp):
    from art_tpu_torch.parallel import streams
    call = streams.DeviceStreamResampler.process_flat_packed

    def wrapped(self, *a, highclip, **k):
        return call(self, *a, highclip=highclip - 1, **k)
    mp.setattr(streams.DeviceStreamResampler, "process_flat_packed",
               wrapped)


FAULTS = {(BATCH, "byte_off"): _byte_off_batch,
          (BATCH, "flat_dither"): _flat_dither,
          (BATCH, "stale_shaper"): _stale_shaper,
          (BATCH, "shaper_f64"): _shaper_f64,
          (PACKED, "byte_off"): _byte_off_packed,
          (PACKED, "clips_dropped"): _clips_dropped,
          (PACKED, "lsb_off"): _lsb_off,
          (PACKED, "truncating"): _truncating,
          (PACKED, "highclip_low"): _highclip_low}


@pytest.mark.parametrize("cell, fault", FAULTS)
def test_fault_fails(capsys, monkeypatch, cell, fault):
    FAULTS[cell, fault](monkeypatch)
    # the shaper's state is held across calls where two consecutive calls
    # are kept: a window of several calls
    result = _run(capsys, cell, seconds="3" if fault == "stale_shaper"
                  else "0.3")
    if fault == "stale_shaper":
        assert result["attempted"] >= 2
    assert result["correct"] is False, result["checks"]


def test_jump_is_the_lcg_stepped():
    from bench_torch.reference import pcm
    seeds = pcm.seed_generators(6)
    for steps in (0, 1, 2, 5, 7, 150675):
        g = [int(s) for s in seeds]
        for _ in range(steps):
            g = [(((x << 4) - x) ^ 1) & pcm.MASK for x in g]
        assert pcm.jump(seeds, steps).tolist() == g


def test_reference_lowpass_for_downsampling():
    from bench_torch import checks_pcm
    cfg = json.loads((run.HERE / "configs" /
                      "preset2_96k_to_44k1_cd16_1024trk.json").read_text())
    ratio = 44100 / 96000
    assert checks_pcm.lowpass_ratio(cfg) == pytest.approx(
        (1 - 7.5 / 156 / ratio) * ratio)
    up = json.loads((run.HERE / "configs" /
                     "preset3_stereo_44k1_to_48k.json").read_text())
    assert checks_pcm.lowpass_ratio(up) == 1.0
