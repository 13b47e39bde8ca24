"""The mean, over the traced window's calls, of a call's span less the
part of it that device activity (kernels and copies) covers: the host
work of a streaming call that the device does not hide, in ms."""


def read(run):
    if run.trace is None or not len(run.trace.busy):
        return None
    return run.trace.call_self_ms()
