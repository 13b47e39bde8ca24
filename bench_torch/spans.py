"""The program's own spans in a traced window (``art_tpu_torch``'s
``utils/spans.py`` opens them), for the readers of the per-layer metrics
that time the program's layers from inside.

The names are spelled here as the program spells them: ``CALL`` around an
engine's public call, ``PLAN`` around its host plan, ``UPLOAD`` around
each host-to-device copy, and ``LAUNCH`` followed by the kernel's key
around each launching wrapper.  A name's spans are merged into their union
before they are summed, so that a span nested in another of the same name
never counts twice.  A program that opens none of them gives no value, and
the metric is then left out of the line.
"""

from __future__ import annotations

import numpy as np

from .trace import _merge

CALL = "art.engine.call"
PLAN = "art.engine.plan"
UPLOAD = "art.engine.upload"
LAUNCH = "art.launch."


def union(trace, name: str) -> np.ndarray | None:
    """The sorted, disjoint union of the spans called ``name`` (for a name
    that ends with ``.``, of those whose names start with it), clipped to
    the window, in ns; None where the window holds none."""
    a, b = trace.window
    hit = (lambda s: s.startswith(name)) if name.endswith(".") else \
        (lambda s: s == name)
    iv = np.array([o[:2] for o in trace.ops
                   if hit(o[2]) and o[1] > a and o[0] < b], np.int64)
    if not len(iv):
        return None
    return np.clip(_merge(iv), a, b)


def ms_per_call(run, name: str, less=None) -> float | None:
    """The time the union of the spans called ``name`` takes, less what
    the disjoint intervals ``less(trace)`` cover of it, over the window's
    calls, in ms; None without a trace or without such spans."""
    trace = run.trace
    if trace is None:
        return None
    iv = union(trace, name)
    if iv is None:
        return None
    ns = float((iv[:, 1] - iv[:, 0]).sum())
    if less is not None:
        ns -= float(trace.covered(iv, less(trace)).sum())
    return ns / len(trace.calls) * 1e-6
