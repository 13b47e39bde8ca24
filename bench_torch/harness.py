"""What every cell's run shares: the context, the entries' base class, the
timed window and the reading of the metrics.

An entry (``entries/<entry>.py``, class ``Entry``) drives one engine path
of the program with a cell's traffic.  It builds its engine and inputs in
``setup``, runs the calls that warm every shape the cell uses in
``warmup``, makes one call of the window in ``call`` (returning the output
frames it completed), waits for the device in ``sync``, drops the
program's state in ``release`` and compares what the window produced with
the configuration's plain reference in ``check``.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch

from . import trace as tr
from .traffic import Keeper

HERE = Path(__file__).resolve().parent


@dataclass
class Context:
    config: dict
    traffic: dict
    seed: int
    device: torch.device


class Entry:
    """Base of the entries: the context's parts, the kept calls and the
    per-call counts."""

    def __init__(self, ctx: Context):
        self.cfg = ctx.config
        self.tp = ctx.traffic
        self.dev = ctx.device
        self.seed = ctx.seed
        self.keeper = Keeper(ctx.seed)
        self.counts: list = []          # each call's outputs, warm-up too
        self.roofline: dict = {}        # kernel -> its launches' shapes

    def sync(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)


@dataclass
class Run:
    """What one run measured, for the metrics' readers."""
    entry: Entry
    setup_s: float
    frames: int = 0
    calls: int = 0
    window_s: float = 0.0
    call_s: list = field(default_factory=list)
    trace: tr.Trace | None = None


def window(run: Run, seconds: float, traced: bool) -> None:
    """Calls into the engine until ``seconds`` have passed on the host's
    clock, then waits for the device: all the work over all the time."""
    entry = run.entry
    span = torch.profiler.record_function if traced else \
        (lambda _name: contextlib.nullcontext())
    prof = tr.profiler() if traced else contextlib.nullcontext()
    # the set-up's objects leave the collector's young generations, so the
    # window's collections scan only what the window makes
    gc.collect()
    gc.freeze()
    with prof:
        t0 = time.perf_counter()
        while True:
            a = time.perf_counter()
            with span(tr.CALL):
                run.frames += entry.call()
            b = time.perf_counter()
            run.call_s.append(b - a)
            run.calls += 1
            if b - t0 >= seconds:
                break
        with span(tr.SYNC):
            entry.sync()
        run.window_s = time.perf_counter() - t0
    if traced:
        run.trace = tr.Trace(prof)


def read_metric(name: str, run: Run):
    """The value of metric ``name`` from ``metrics/<name>.py``'s ``read``,
    or None where it finds nothing to read."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_torch.metrics." + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)
