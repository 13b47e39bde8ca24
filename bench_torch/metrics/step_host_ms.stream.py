"""The launching wrappers' own host work in a streaming call, in ms a
call: the union of the program's ``art.launch.*`` spans in the traced window
(checks, geometry, output allocation, the ctypes launch), less what the
CUDA runtime calls inside them cover, over the window's calls; profiler
trace."""

from bench_torch import spans


def read(run):
    return spans.ms_per_call(run, spans.LAUNCH, less=lambda t: t.runtime)
