"""K4's share of its roofline, in %: the mean least time of the window's
calls at their shapes (``roofline/asrc_step_f64.py``: float64 bytes at
3.35 TB/s, operations at the plain FP64 rate) over the device time of a
launch, the time of the trace's ``asrc_step_kernel<double, false``
kernels divided by the launches the trace holds.  None where the trace
holds no such launch."""

from bench_torch.roofline import asrc_step_f64

KERNEL = "asrc_step_kernel<double, false"


def read(run):
    shape = run.entry.roofline.get("asrc_step_f64")
    if run.trace is None or not shape or not shape["calls"]:
        return None
    seconds, launches = run.trace.kernel(KERNEL)
    if not launches:
        return None
    fixed = {k: v for k, v in shape.items() if k != "calls"}
    least = [asrc_step_f64.least_s(**fixed, k_max=k_max, valid_outputs=valid)
             for k_max, valid in shape["calls"]]
    return 100.0 * (sum(least) / len(least)) / (seconds / launches)
