"""The decimator's own host work in a call into a device-resident
engine, in ms a call: the union of the program's ``art.engine.decimate``
spans in the traced window (state conversions, checks, the launch
wrapper), less what the CUDA runtime calls inside them cover, over the
window's calls; profiler trace.  None where the program opens no such
span."""

from bench_torch import spans

DECIMATE = "art.engine.decimate"


def read(run):
    return spans.ms_per_call(run, DECIMATE, less=lambda t: t.runtime)
