"""B1's share of its roofline, in %: the least time of one section at the
cell's shape (``roofline/biquad_span.py``: 8 bytes read and 8 written a
sample at 3.35 TB/s) over the device time of a launch, the
``biquad_span_kernel`` time of the trace divided by the launches the
trace holds (one a section).  None where the trace holds no such
launch."""

from bench_torch.roofline import biquad_span


def read(run):
    shape = run.entry.roofline.get("b1")
    if run.trace is None or shape is None:
        return None
    seconds, launches = run.trace.kernel("biquad_span_kernel")
    if not launches:
        return None
    return 100.0 * biquad_span.least_s(**shape) / (seconds / launches)
