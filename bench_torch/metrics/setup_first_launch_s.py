"""Set-up's first launches: the wall time of the ctypes call of each
entry point's first launch at the shape that picks its kernel instance,
where CUDA's lazy module loading loads that instance, before the window,
in s; the program's tally (``bench_torch/host_clocks.py``)."""

from bench_torch import host_clocks


def read(run):
    return host_clocks.setup_s(run, host_clocks.FIRST_LAUNCH)
