"""D2's share of its least time, in %: the least time of one launch at the
cell's shape (``roofline/decimate_shaped.py``: the larger of its bytes at
the memory's rate and its chains at the latency the chain probe measured)
over the device time of a launch, the ``decimate_shaped_kernel`` time of
the trace divided by the launches the trace holds."""

from bench_torch.roofline import decimate_shaped


def read(run):
    shape = run.entry.roofline.get("d2")
    if run.trace is None or shape is None:
        return None
    seconds, launches = run.trace.kernel("decimate_shaped_kernel")
    if not launches:
        return None
    return 100.0 * decimate_shaped.least_s(**shape) / (seconds / launches)
