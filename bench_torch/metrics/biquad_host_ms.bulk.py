"""The biquad cascade's own host work in a call into a device-resident
chain, in ms a call: the union of the program's ``art.engine.biquad``
spans in the traced window (state packing, checks, the launch wrapper),
less what the CUDA runtime calls inside them cover, over the window's
calls; profiler trace.  None where the program opens no such span."""

from bench_torch import spans

BIQUAD = "art.engine.biquad"


def read(run):
    return spans.ms_per_call(run, BIQUAD, less=lambda t: t.runtime)
