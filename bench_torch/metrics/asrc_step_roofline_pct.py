"""The ASRC step kernel's share of its roofline, in %: the mean least time
of the window's calls at their shapes (``roofline/asrc_step.py``) over the
device time of a launch, the ``asrc_step_kernel`` time of the trace
divided by the launches the trace holds."""

from bench_torch.roofline import asrc_step


def read(run):
    shape = run.entry.roofline.get("asrc_step")
    if run.trace is None or not shape or not shape["calls"]:
        return None
    seconds, launches = run.trace.kernel("asrc_step_kernel")
    if not launches:
        return None
    fixed = {k: v for k, v in shape.items() if k != "calls"}
    least = [asrc_step.least_s(**fixed, k_max=k_max, valid_outputs=valid)
             for k_max, valid in shape["calls"]]
    return 100.0 * (sum(least) / len(least)) / (seconds / launches)
