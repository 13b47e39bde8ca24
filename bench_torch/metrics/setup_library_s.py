"""Set-up's kernel libraries: the wall time of the program's ``library``
builds before the window (the kernels' library loaded, or built by nvcc
and loaded, and the host geometry library), in s; the program's tally
(``bench_torch/host_clocks.py``)."""

from bench_torch import host_clocks


def read(run):
    return host_clocks.setup_s(run, host_clocks.LIBRARY)
