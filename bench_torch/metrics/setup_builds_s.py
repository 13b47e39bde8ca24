"""Set-up's host builds: the wall time of the program's ``bank``,
``matrix`` and ``hulls`` builds before the window (filter banks and
section tables with their uploads, phase matrices with theirs, P's hulls
and packed hull rows), in s.  ``setup_s`` less this and the other two
``setup_*`` metrics is what is not the program's own build: imports, the
CUDA context, the harness's inputs and the warm-up calls' work; the
program's tally (``bench_torch/host_clocks.py``)."""

from bench_torch import host_clocks


def read(run):
    return host_clocks.setup_s(run, host_clocks.SETUP_BUILDS)
