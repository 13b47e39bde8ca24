"""The mean host time of one call into a device-resident engine, less
the time spent in CUDA runtime calls, in ms, over the traced window: the
engine's plan and the rest of its host work, without the waits behind the
device in launches, copies and synchronisations; profiler trace."""


def read(run):
    if run.trace is None:
        return None
    return run.trace.call_host_ms()
