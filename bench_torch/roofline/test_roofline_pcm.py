"""The counts of the decimate kernels at the PCM cells' shapes: D2's least
time is its chains' (one wave of 64 CTAs at 2,048 channels, the chain
probe's 1.0784 ms at the batch cell's 30,135 frames) and D1's its bytes;
K1's template at the batch cell is bound by its operations.  Runs on the CPU:
python -m pytest bench_torch/roofline -q"""

import pytest

from bench_torch import peaks
from bench_torch.roofline import decimate_flat, decimate_shaped, k1


def test_d2_batch_cell_is_one_wave_of_chains():
    shape = dict(frames=30135, channels=2048, quantized=30135)
    nbytes, chains = decimate_shaped.counts(**shape)
    assert nbytes / peaks.PEAK_BYTES < chains      # latency, not bytes
    assert decimate_shaped.least_s(**shape) * 1e3 == pytest.approx(1.0784)
    # 133 groups of 32 channels take two waves on 132 SMs
    two = decimate_shaped.least_s(frames=100, channels=133 * 32,
                                  quantized=100)
    assert two == pytest.approx(2 * 100 * decimate_shaped.LATENCY_S)


def test_d2_bytes_bound_a_short_wide_launch():
    shape = dict(frames=1, channels=1 << 24, quantized=1)
    nbytes, _ = decimate_shaped.counts(**shape)
    assert decimate_shaped.least_s(**shape) == nbytes / peaks.PEAK_BYTES


def test_d1_packed_cell_group():
    # a p3_flat_int16 group: 8 chunks of 57,065 blocks of L = 160 outputs,
    # stereo, 4 bytes read and 2 written a sample
    samples = 2 * 8 * 57065 * 160
    ms, what = peaks.bound_ms(*decimate_flat.counts(samples=samples),
                              peaks.PEAK_F32)
    assert what == "bytes"
    assert ms == pytest.approx(6 * samples / 3.35e9)
    assert decimate_flat.least_s(samples=samples) * 1e3 == ms


def test_k1_template_batch_cell_bound_by_operations():
    # p2_cd16_1024trk: 2,048 channels, 205 periods of M = 320 in, 205
    # blocks of L = 147 out, P of qn*M = 640 rows, 156 taps
    shape = dict(channels=2048, hist=2496, inputs=65600, p_rows=640, L=147,
                 blocks=205, outputs=30135, taps=156)
    ms, what = peaks.bound_ms(*k1.counts(**shape), peaks.PEAK_F32)
    assert what == "operations"
    assert ms == pytest.approx(2 * 2048 * 30135 * 156 / 67e9)
