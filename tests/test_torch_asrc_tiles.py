"""The ASRC step kernel's launch geometry (``ops/asrc_step.py::
step_geometry``), on the CPU.  The kernel (``csrc/asrc_step.cu``) stages the
phase bank through shared memory in pieces, two buffers at a time: all F + 1
rows over a piece's P taps and the X taps that follow (wrapping to tap 0),
the lane with offset o = X - 1 - lane % X reading entries o .. o + P - 1.
For every (taps, F) that resampleInit allows, the pieces must cover the taps
exactly in 16-byte rows, the lanes' entries must stay inside a staged row,
and both buffers must fit the 232,448 bytes a block may use; any other shape
is refused by name."""

import pytest
import torch

from art_tpu_torch.ops.asrc_step import STEP_SLOTS, STEP_THREADS, step_geometry

SMEM = 232448
DTYPES = [torch.float32, torch.float64]


@pytest.mark.parametrize("filters", [1, 2, 48, 380, 1023, 1024])
@pytest.mark.parametrize("dtype", DTYPES)
def test_pieces_cover_every_allowed_tap_count_and_fit(dtype, filters):
    width = 4 if dtype == torch.float32 else 8
    lanes = 128 // width
    for taps in range(4, 1025, 4):
        g = step_geometry(taps, filters, dtype)
        P, X = g.piece_taps, g.lane_span
        assert P % 4 == 0 and P >= 4, (taps, g)
        # X <= taps: a staged row wraps to tap 0 at most once
        assert X % 4 == 0 and 4 <= X <= min(lanes, taps), (taps, g)
        assert g.pieces == -(-taps // P)
        last = taps - (g.pieces - 1) * P
        assert 0 < last <= P and last % 4 == 0, (taps, g)
        # a lane reads entries o + u < X + P of a row of P + X entries
        assert g.bank_bytes == 2 * (filters + 1) * (P + X) * width <= SMEM
        assert g.window_capacity == (SMEM - g.bank_bytes) // width
        # one pass of the threads' 16-byte copies covers a staged row
        assert (P + X) * width <= 16 * g.threads, (taps, g)
        # where a row of two wavefronts fits, the lanes' offsets span one
        # wavefront and rows stay aligned to it: every bank met once
        if 4 * (filters + 1) * lanes * width <= SMEM and taps >= lanes:
            assert X == lanes and (P + X) % lanes == 0, (taps, g)
        assert g.threads == STEP_THREADS
        assert g.outputs_per_block == g.threads * STEP_SLOTS[dtype]


@pytest.mark.parametrize("dtype,P,X,pieces,run", [
    (torch.float32, 32, 32, 12, 3072), (torch.float64, 16, 16, 24, 2304)])
def test_config5_geometry(dtype, P, X, pieces, run):
    """BASELINE config 5 (380 taps, 380 filters): 97.5 KB pieces."""
    g = step_geometry(380, 380, dtype)
    assert (g.piece_taps, g.lane_span, g.pieces) == (P, X, pieces)
    assert (g.bank_bytes, g.outputs_per_block) == (195072, run)
    # a run's window at ratio ~1 (outputs + taps values) is staged
    assert g.outputs_per_block + 380 <= g.window_capacity


def test_largest_bank_takes_the_smallest_pieces():
    """F = 1024: float64 rows of 8 + 4 taps, float32 of 16 + 12."""
    g = step_geometry(64, 1024, torch.float64)
    assert (g.piece_taps, g.lane_span) == (8, 4)
    g = step_geometry(1024, 1024, torch.float32)
    assert (g.piece_taps, g.lane_span) == (16, 12)


@pytest.mark.parametrize("taps,filters,dtype,name", [
    (0, 380, torch.float32, "taps=0, F=380"),
    (2, 380, torch.float32, "taps=2, F=380"),
    (382, 380, torch.float64, "taps=382, F=380"),
    (1028, 380, torch.float32, "taps=1028, F=380"),
    (380, 0, torch.float32, "taps=380, F=0"),
    (380, 1025, torch.float64, "taps=380, F=1025"),
    (380, 380, torch.float16, "taps=380, F=380, torch.float16"),
])
def test_shapes_outside_the_range_raise_naming_them(taps, filters, dtype,
                                                    name):
    with pytest.raises(ValueError, match=name):
        step_geometry(taps, filters, dtype)
