"""The counts give chip_smoke.py's bounds at PERF.md §6's shapes: 0.1036 ms
for K1's preset -3 chunk and 0.1903 ms for a config-5 ASRC call.  Runs on
the CPU: python -m pytest bench_torch/roofline -q"""

from bench_torch import peaks
from bench_torch.roofline import asrc_step, k1


def test_k1_preset3_chunk():
    # 4,194,351 = 28,533 periods of M = 147 frames in, 28,533 blocks of
    # L = 160 out, a history of 16 x 380 frames, P of qn*M = 588 rows
    shape = dict(channels=2, hist=6080, inputs=4194351, p_rows=588, L=160,
                 blocks=28533, outputs=28533 * 160, taps=380)
    ms, what = peaks.bound_ms(*k1.counts(**shape), peaks.PEAK_F32)
    assert (round(ms, 4), what) == (0.1036, "operations")
    assert k1.least_s(**shape) * 1e3 == ms


def test_asrc_step_config5_call():
    # 256 streams of 32,768 frames at ratios averaging 1: 256 x 32,768
    # valid outputs, a 380-tap bank of 381 rows
    shape = dict(streams=256, hist=6080, inputs=32768, bank_rows=381,
                 taps=380, k_max=33280, valid_outputs=256 * 32768)
    ms, what = peaks.bound_ms(*asrc_step.counts(**shape), peaks.PEAK_F32)
    assert (round(ms, 4), what) == (0.1903, "operations")
