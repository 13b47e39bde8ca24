"""The device idle that a device-resident engine's own host time leaves,
in ms a call: the union of the program's ``art.engine.call`` spans in the
traced window less what device activity covers of it, over the window's
calls; None where the trace holds no device activity; profiler trace."""

from bench_torch import spans


def read(run):
    if run.trace is None or not len(run.trace.busy):
        return None
    return spans.ms_per_call(run, spans.CALL, less=lambda t: t.busy)
