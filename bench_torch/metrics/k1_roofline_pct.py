"""K1's share of its roofline, in %: the least time of one launch at the
cell's shapes (``roofline/k1.py``) over the device time of a launch, the
``fixed_step_kernel`` time of the trace divided by the launches the trace
holds (the profiler drops a launch now and then)."""

from bench_torch.roofline import k1


def read(run):
    shape = run.entry.roofline.get("k1")
    if run.trace is None or shape is None:
        return None
    seconds, launches = run.trace.kernel("fixed_step_kernel")
    if not launches:
        return None
    return 100.0 * k1.least_s(**shape) / (seconds / launches)
