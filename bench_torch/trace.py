"""The reduction of a ``torch.profiler`` trace of the window.

The window runs under ``torch.profiler.profile`` (CPU and CUDA
activities); the harness marks each call into the engine with a
``record_function`` span (``CALL``) and the closing synchronisation with
another (``SYNC``).  The traced window runs from the first call's start to
the end of the closing synchronisation.  Device activity is the union of
every device interval in the trace (kernels, copies, sets), clipped to
the window; kernels are found by the names the profiler prints.  The
host's CUDA runtime calls (launches, copies, synchronisations,
allocations) are found by their ``cuda*``/``cu*`` names; inside them the
host may wait for the device.
"""

from __future__ import annotations

import re

import numpy as np
import torch

CALL = "bench.call"
SYNC = "bench.sync"
RUNTIME = re.compile(r"cu(da)?[A-Z]")


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _merge(iv: np.ndarray) -> np.ndarray:
    """Sorted, disjoint union of [start, end) rows."""
    if not len(iv):
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    last = np.r_[np.flatnonzero(new)[1:] - 1, len(iv) - 1]
    return np.stack([starts, ends[last]], axis=1)


def _short(name: str) -> str:
    """A kernel's name without its parameter list, return type and
    anonymous namespace."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    if len(name) > 80 and "<" in name:     # PyTorch's own templates
        name = name[:name.index("<")] + "<...>"
    return name


class Trace:
    """Device intervals, host spans and host ops of one traced window, in
    ns on the profiler's clock."""

    def __init__(self, prof):
        cuda = torch.autograd.DeviceType.CUDA
        dev, ops, calls, sync = [], [], [], []
        for e in prof.profiler.kineto_results.events():
            name, s = e.name(), e.start_ns()
            iv = (s, s + e.duration_ns())
            if e.device_type() == cuda:
                # the profiler mirrors the harness's spans on the device's
                # timeline; they are no device activity
                if not e.is_user_annotation() and name not in (CALL, SYNC):
                    dev.append((*iv, name))
            elif name == CALL:
                calls.append(iv)
            elif name == SYNC:
                sync.append(iv)
            else:
                ops.append((*iv, name))
        self.calls = np.array(sorted(calls), np.int64).reshape(-1, 2)
        end = max([c[1] for c in sync] + [int(self.calls[-1, 1])])
        self.window = (int(self.calls[0, 0]), end)
        a, b = self.window
        self.device_ops = [d for d in dev if d[1] > a and d[0] < b]
        iv = np.array([d[:2] for d in self.device_ops], np.int64)
        self.busy = np.clip(_merge(iv.reshape(-1, 2)), a, b)
        ops.sort()
        self.ops = ops
        rt = np.array([o[:2] for o in ops if RUNTIME.match(o[2])], np.int64)
        self.runtime = _merge(rt.reshape(-1, 2))
        self._op_starts = np.array([o[0] for o in ops], np.int64)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    @property
    def busy_s(self) -> float:
        return float((self.busy[:, 1] - self.busy[:, 0]).sum()) * 1e-9

    def idle_pct(self) -> float | None:
        if not len(self.busy):
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel(self, name: str) -> tuple[float, int]:
        """(device seconds, launches) of the kernels whose name holds
        ``name``."""
        ds = [d[1] - d[0] for d in self.device_ops if name in d[2]]
        return sum(ds) * 1e-9, len(ds)

    def covered(self, spans: np.ndarray, by: np.ndarray | None = None
                ) -> np.ndarray:
        """ns of each [start, end) row of ``spans`` that the disjoint,
        sorted intervals ``by`` (device activity by default) cover."""
        b = self.busy if by is None else by
        if not len(b):
            return np.zeros(len(spans))
        cum = np.r_[0, np.cumsum(b[:, 1] - b[:, 0])]
        ends = b[:, 1]

        def upto(t):    # busy ns before t
            i = np.searchsorted(ends, t, side="right")
            part = np.clip(t - b[np.minimum(i, len(b) - 1), 0], 0, None)
            return cum[i] + np.where(i < len(b), part, 0)

        return upto(spans[:, 1]) - upto(spans[:, 0])

    def call_self_ms(self) -> float:
        """Mean over calls of the call's span less what device activity
        covers of it, in ms."""
        span = self.calls[:, 1] - self.calls[:, 0]
        return float(np.mean(span - self.covered(self.calls))) * 1e-6

    def call_host_ms(self) -> float:
        """Mean over calls of the call's span less the time the host spent
        in CUDA runtime calls, in ms: the engine's own host work (its plan,
        its Python, PyTorch's dispatch), without the waits for the device
        that a full launch queue or a synchronising copy put there."""
        span = self.calls[:, 1] - self.calls[:, 0]
        inside = self.covered(self.calls, self.runtime)
        return float(np.mean(span - inside)) * 1e-6

    def _host_at(self, t: int) -> str:
        """The innermost host op running at ``t`` (the latest-starting one
        that covers it), or where in the harness the host was."""
        i = int(np.searchsorted(self._op_starts, t, side="right")) - 1
        for j in range(i, max(i - 256, -1), -1):
            if self.ops[j][1] >= t:
                return self.ops[j][2]
        c = int(np.searchsorted(self.calls[:, 0], t, side="right")) - 1
        if c >= 0 and self.calls[c, 1] >= t:
            return f"{CALL} (Python)"
        return "between calls"

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the idle time between
        device activity summed by what the host was doing at each gap's
        middle; seconds."""
        by_op: dict[str, int] = {}
        for s, e, name in self.device_ops:
            by_op[_short(name)] = by_op.get(_short(name), 0) + (e - s)
        a, b = self.window
        edges = np.r_[a, self.busy.ravel(), b].reshape(-1, 2)
        gaps: dict[str, int] = {}
        for s, e in edges:
            if e > s:
                label = self._host_at(int((s + e) // 2))
                gaps[label] = gaps.get(label, 0) + int(e - s)
        ranked = lambda d: [[k, v * 1e-9] for k, v in
                            sorted(d.items(), key=lambda kv: -kv[1])[:top]]
        return {"device_ops": ranked(by_op), "idle_gaps": ranked(gaps)}
