"""The program's one-time builds inside the traced window of a streaming
cell (its ``art.build.*`` spans), a count; 0 where set-up built all the
window uses; profiler trace."""

from bench_torch import host_clocks


def read(run):
    return host_clocks.window_builds(run)
