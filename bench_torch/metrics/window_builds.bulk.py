"""The program's one-time builds inside the traced window (its
``art.build.*`` spans: a phase matrix rebuilt on a cache miss, P's hulls
found again, a first launch of a shape the warm-up missed), a count; 0
where set-up built all the window uses; profiler trace."""

from bench_torch import host_clocks


def read(run):
    return host_clocks.window_builds(run)
