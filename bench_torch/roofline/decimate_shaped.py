"""D2, the shaped decimate kernel (``csrc/decimate.cu``
``decimate_shaped_kernel<float>``), at its least time: the larger of its
bytes at the memory's rate and its chains at their latency.

Bytes: each sample read once (``itemsize``) and its packed bytes written
once (``out_bytes``), over every frame of the launch, and each channel's
state read and written (the dither state, the feedback and 8 history
values).  Chains: the shaped quantizer is a serial recurrence a channel,
so a launch takes at least ``quantized`` frames times the latency of one
frame's chain, once a wave: a CTA serves 32 channels, and one CTA fits an
SM at the shapes that take it, so 132 groups run at once on an H100 SXM.

``LATENCY_S`` is the chain's latency a frame, which
``ops/decimate_device.chain_probe`` (the chain alone, in one thread, in
registers) measured on an H100 80GB HBM3 at 700 W at the batch cell's
30,135 frames: 1.0784 ms, the median of 5 launches (CUDA events; 0.6594
ms at an art block's 17,760 frames, 7.0276 ms at 200,000).  It is a
constant of the card, not measured again a run.
"""

from __future__ import annotations

import math

from .. import peaks

LATENCY_S = 1.0784e-3 / 30135
CHANNELS_A_CTA = 32
SMS = 132


def counts(*, frames: int, channels: int, quantized: int, itemsize: int = 4,
           out_bytes: int = 2):
    """(bytes, chain seconds) of one launch over ``frames`` frames of
    ``channels`` channels, ``quantized`` of them quantized."""
    nbytes = (itemsize + out_bytes) * frames * channels \
        + 2 * channels * (4 + 9 * itemsize)
    groups = math.ceil(channels / CHANNELS_A_CTA)
    return nbytes, quantized * LATENCY_S * math.ceil(groups / SMS)


def least_s(**shape) -> float:
    nbytes, chains = counts(**shape)
    return max(nbytes / peaks.PEAK_BYTES, chains)
