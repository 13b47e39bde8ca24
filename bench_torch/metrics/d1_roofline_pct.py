"""D1's share of its roofline, in %: the least time of one launch at the
cell's shape (``roofline/decimate_flat.py``: 4 bytes read and 2 written a
sample at 3.35 TB/s) over the device time of a launch, the
``decimate_flat_kernel`` time of the trace divided by the launches the
trace holds."""

from bench_torch.roofline import decimate_flat


def read(run):
    shape = run.entry.roofline.get("d1")
    if run.trace is None or shape is None:
        return None
    seconds, launches = run.trace.kernel("decimate_flat_kernel")
    if not launches:
        return None
    return 100.0 * decimate_flat.least_s(**shape) / (seconds / launches)
