"""Round-trip fidelity of the streaming engine: the ``artest -i -e`` metric.

The counterpart of ``bench._measure_roundtrip_snr``: preset -3 stereo
44.1k->48k on the bit-identical artest LCG noise with 4096-frame fades,
forward then inverse through ``DeviceStreamResampler`` on the headline code
path (``bench._stream_flat_out``: the first chunk through ``process()``,
M-multiple groups through ``process_flat_out``, the tail through
``process()``, then ``flush()``), and the diff RMS against the
time-aligned source via the display_stats expression
``10*log10(sumsq / count * 2)`` (reference artest.c:106-114).  ``precise``
selects the engine's precision tier on both legs, as
``bench._measure_roundtrip_snr(seconds, precise)`` does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .core.flags import BLACKMAN_HARRIS, SUBSAMPLE_INTERPOLATE
from .parallel.streams import DeviceStreamResampler
from .utils.testsig import NoiseLCG, fade_in, fade_out

# no lowpass: `artest -i -e` runs without -l, and the inverse leg's
# auto-lowpass would strip the source's top band and dominate the diff
FLAGS = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS
CHANNELS, TAPS, SOURCE_RATE, DESTIN_RATE, FADE = 2, 380, 44100, 48000, 4096


def m_multiple(target: int, M: int) -> int:
    """The multiple of the input period M nearest ``target``: such chunks
    keep the fixed-ratio steady state exactly periodic."""
    return max(1, round(target / M)) * M


def artest_noise(seconds: float) -> np.ndarray:
    """[CHANNELS, n] float32 artest noise with fade-in and fade-out, n a
    whole number of 4096-frame buffers covering ``seconds``."""
    n = -(-int(seconds * SOURCE_RATE) // FADE) * FADE
    sig = NoiseLCG().fill(n * CHANNELS, np.float32).reshape(n, CHANNELS)
    fade_in(sig[:FADE])
    fade_out(sig[-FADE:])
    return np.ascontiguousarray(sig.T)


def stream(eng: DeviceStreamResampler, x: torch.Tensor,
           chunk_target: int = 1 << 19):
    """Push x [ch, n] through ``eng`` as ``bench._stream_flat_out`` does:
    the first M-multiple chunk through process() (it absorbs the
    non-periodic entry plan), the whole chunks that follow as one
    process_flat_out group (a chunk at a time through process() if the
    group is refused), the tail through process(), then flush().  Returns
    (valid output [ch, K_total], the number of dispatching calls: each
    process(), process_flat_out() and flush() is one K1 launch on a
    card)."""
    n = x.shape[1]
    chunk = m_multiple(chunk_target, eng.M)
    pos = min(chunk, n)
    o, K = eng.process(x[:, :pos], pos)
    outs, calls = [o[:, :K]], 1
    while n - pos >= chunk:
        g = (n - pos) // chunk
        try:
            o, _ = eng.process_flat_out(x[:, pos:pos + g * chunk], chunk)
            pos += g * chunk
        except ValueError:
            o, K = eng.process(x[:, pos:pos + chunk], chunk)
            o = o[:, :K]
            pos += chunk
        outs.append(o)
        calls += 1
    if pos < n:
        o, K = eng.process(x[:, pos:], n - pos)
        outs.append(o[:, :K])
        calls += 1
    o, K = eng.flush()
    outs.append(o[:, :K])
    return torch.cat(outs, dim=1), calls + 1


def roundtrip_diff_db(seconds: float, device, chunk_target: int = 1 << 19,
                      precise=False):
    """Forward then inverse resample ``seconds`` of the test signal on
    ``device`` in the ``precise`` tier (False, True or "int8").  Returns a
    dict: ``diff_db`` (the diff RMS in dB),
    ``calls`` (dispatching calls made on both legs, see ``stream``) and
    ``frames`` (output frames of the forward and the inverse leg)."""
    x = torch.from_numpy(artest_noise(seconds)).to(device)
    legs = []
    for src, dst in ((SOURCE_RATE, DESTIN_RATE), (DESTIN_RATE, SOURCE_RATE)):
        eng = DeviceStreamResampler(CHANNELS, TAPS, TAPS, src, dst, 0, FLAGS,
                                    precise=precise, device=device)
        eng.advance_position(TAPS // 2)
        legs.append(eng)
    y, calls_fwd = stream(legs[0], x, chunk_target)
    z, calls_inv = stream(legs[1], y, chunk_target)
    m = min(x.shape[1], z.shape[1])
    diff = (z[:, :m] - x[:, :m]).double()
    sumsq = float(torch.sum(diff * diff))
    return {"diff_db": 10.0 * math.log10(sumsq / (m * CHANNELS) * 2.0),
            "calls": calls_fwd + calls_inv,
            "frames": (y.shape[1], z.shape[1])}
