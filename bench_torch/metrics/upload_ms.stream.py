"""The host-to-device copies of a streaming call (its input buffer and
the plan's offsets, ratios and counts), in ms a call: the union of the
program's ``art.engine.upload`` spans in the traced window over the
window's calls, with the waits behind the device that a synchronising
(pageable) copy makes; profiler trace."""

from bench_torch import spans


def read(run):
    return spans.ms_per_call(run, spans.UPLOAD)
