"""The 95th percentile of every call's time in the traced window, from
the call's start to its outputs on the host, in ms; host clock (the
profiler's cost a call is in it)."""

import numpy as np


def read(run):
    return float(np.percentile(np.asarray(run.call_s) * 1e3, 95))
