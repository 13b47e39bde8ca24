"""The host plan of a streaming call, in ms a call: the union of the
program's ``art.engine.plan`` spans in the traced window (the count plan of
``BatchedASRC._plan``) over the window's calls; profiler trace."""

from bench_torch import spans


def read(run):
    return spans.ms_per_call(run, spans.PLAN)
