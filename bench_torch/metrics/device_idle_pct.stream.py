"""The share of the traced window in which no device activity (a kernel,
a copy, a set) runs, in %, for the streaming cells."""


def read(run):
    return None if run.trace is None else run.trace.idle_pct()
