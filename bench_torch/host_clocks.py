"""The program's own host clock (``art_tpu_torch``'s ``utils/spans.py``),
for the readers of the set-up split and the builds of the window.

The program tallies every one-time build (``BUILD`` followed by its kind:
the kernel library's load or build, an entry point's first launch, a
filter bank, a phase matrix, P's hulls) from the process's start, apart by
whether a profiler was recording: in a run, those made with none
recording are set-up's, since the profiler records only the window and
the readers run right after it.  While a profiler records, a build is
also a span.  A program without the tally gives no value, and the metric
is then left out of the line.
"""

from __future__ import annotations

import sys

BUILD = "art.build."
LIBRARY = ("library",)
FIRST_LAUNCH = ("first_launch",)
SETUP_BUILDS = ("bank", "matrix", "hulls")


def _program():
    """The program's spans module, as the entry's import of the program
    loaded it, where it keeps the tally; else None."""
    mod = sys.modules.get("art_tpu_torch.utils.spans")
    if not hasattr(mod, "builds"):
        return None
    return mod


def setup_s(run, kinds) -> float | None:
    """Wall seconds of the builds of ``kinds`` that no profiler recorded
    (set-up's), each build's own time; None without a trace or a tally."""
    prog = _program()
    if run.trace is None or prog is None:
        return None
    ns = sum(n for (what, recorded), (_, n) in prog.builds.items()
             if what in kinds and not recorded)
    return ns * 1e-9


def window_builds(run) -> int | None:
    """The number of ``BUILD`` spans that start inside the traced window;
    None without a trace or a tally."""
    trace = run.trace
    if trace is None or _program() is None:
        return None
    a, b = trace.window
    return sum(1 for s, _, name in trace.ops
               if name.startswith(BUILD) and a <= s < b)
