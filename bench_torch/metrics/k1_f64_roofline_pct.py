"""K1's float64 instance's share of its roofline, in %: the least time of
one launch at the cell's shapes (``roofline/k1_f64.py``: float64 bytes at
3.35 TB/s, operations at the plain FP64 rate) over the device time of a
launch, the time of the trace's ``fixed_step_kernel<double, double``
kernels divided by the launches the trace holds.  None where the trace
holds no such launch."""

from bench_torch.roofline import k1_f64

KERNEL = "fixed_step_kernel<double, double"


def read(run):
    shape = run.entry.roofline.get("k1_f64")
    if run.trace is None or shape is None:
        return None
    seconds, launches = run.trace.kernel(KERNEL)
    if not launches:
        return None
    return 100.0 * k1_f64.least_s(**shape) / (seconds / launches)
