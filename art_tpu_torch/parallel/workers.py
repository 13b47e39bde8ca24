"""Host-side worker pool: the runtime counterpart of the reference's
workers.[ch] (fixed pthread pool, ~591 LoC).

On TPU the *device* parallelism the reference built this pool for — one
thread per audio channel (reference resampler.c:447-462,
decimator.c:119-134) — is expressed as vectorized channel/stream axes and
`shard_map` over a device mesh (see parallel/streams.py, parallel/sharding.py):
XLA schedules that work, so `RESAMPLE_MULTITHREADED` / `DECIMATE_MULTITHREADED`
are accepted no-ops on the compute path.

What still benefits from a host pool is the *runtime around* the device:
overlapping file IO, byte packing, and host-side parity backends across
channels or streams.  This module provides the reference's full job-queue
semantics (reference workers.h:84-94, workers.c:133-446) on
concurrent host threads:

  - a fixed pool created at init, jobs are ``fn(context, job)`` pairs,
  - four enqueue policies (wait / only-if-available / inline / fail),
  - non-zero wrapping uint32 job numbers with the A_BEFORE_B ordering
    convention, wait-all / wait-on-job / is-job-running queries,
  - ``worker_sync``: an in-job barrier that blocks until every job enqueued
    *earlier* has finished (reference workers.c:81-117).

A ``None``/zero-worker pool runs jobs inline and reports success, exactly
like the reference's NULL-context convention (reference workers.c:256-259).

A copy of ``art_tpu/parallel/workers.py``, unchanged, so that the port
imports nothing of the JAX package (``art -m`` runs on it).
"""

from __future__ import annotations

import os
import sys
import threading
from collections import deque

# enqueue policies (reference workers.h:84-94)
WAIT_FOR_AVAILABLE_WORKER = 0
USE_WORKER_ONLY_IF_AVAILABLE = 1
DONT_USE_WORKER_THREAD = 2
FAIL_ON_NO_WORKER_AVAILABLE = 3

_U32 = 0xFFFFFFFF


def a_before_b(a: int, b: int) -> bool:
    """Wrapping uint32 job-number ordering (reference workers.h:19-20)."""
    return ((b - a) & _U32) < 0x80000000 and a != b


class Workers:
    """Fixed-size host worker pool with the reference's queue semantics."""

    def __init__(self, num_workers: int):
        self.num_workers = max(0, int(num_workers))
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._queue: deque = deque()
        self._running: set[int] = set()
        self._next_job = 1
        self._shutdown = False
        # debug counters (reference workers.c:27-29, 425-427 DEBUG builds):
        # total enqueues, failed FAIL_ON_NO_WORKER attempts, inline runs,
        # and jobs observed completing out of enqueue order
        self.stats = {"enqueues": 0, "failures": 0, "inline_runs": 0,
                      "out_of_order": 0}
        self._last_completed = 0
        self._threads = [
            threading.Thread(target=self._worker_loop, daemon=True)
            for _ in range(self.num_workers)]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------- internal
    def _worker_loop(self):
        while True:
            with self._cv:
                while not self._queue and not self._shutdown:
                    self._cv.wait()
                if self._shutdown and not self._queue:
                    return
                jobnum, fn, ctx, job = self._queue.popleft()
                self._running.add(jobnum)
            try:
                fn(ctx, job)
            finally:
                with self._cv:
                    self._running.discard(jobnum)
                    if self._last_completed and a_before_b(
                            jobnum, self._last_completed):
                        self.stats["out_of_order"] += 1
                    self._last_completed = jobnum
                    self._cv.notify_all()

    def _alloc_jobnum(self) -> int:
        n = self._next_job
        self._next_job = (self._next_job + 1) & _U32 or 1   # skip 0
        return n

    def _busy(self) -> int:
        return len(self._queue) + len(self._running)

    # --------------------------------------------------------------- public
    def enqueue(self, fn, context, job,
                policy: int = WAIT_FOR_AVAILABLE_WORKER) -> int:
        """Run ``fn(context, job)``; returns a non-zero job number, or 0 if
        ``FAIL_ON_NO_WORKER_AVAILABLE`` found no idle worker
        (reference workers.c:249-318)."""
        if self._shutdown:
            raise RuntimeError("enqueue on a deinitialized worker pool")
        if self.num_workers == 0 or policy == DONT_USE_WORKER_THREAD:
            fn(context, job)
            with self._cv:
                self.stats["enqueues"] += 1
                self.stats["inline_runs"] += 1
                return self._alloc_jobnum()
        inline = None
        with self._cv:
            if policy == WAIT_FOR_AVAILABLE_WORKER:
                while self._busy() >= self.num_workers:
                    self._cv.wait()
            elif self._busy() >= self.num_workers:
                if policy == FAIL_ON_NO_WORKER_AVAILABLE:
                    self.stats["failures"] += 1
                    return 0
                # USE_WORKER_ONLY_IF_AVAILABLE: run inline, outside the
                # lock (an in-job enqueue must not deadlock the pool)
                inline = self._alloc_jobnum()
                self.stats["enqueues"] += 1
                self.stats["inline_runs"] += 1
            if inline is None:
                n = self._alloc_jobnum()
                self.stats["enqueues"] += 1
                self._queue.append((n, fn, context, job))
                self._cv.notify()
                return n
        fn(context, job)
        return inline

    def wait_all(self):
        """Block until every enqueued job has completed
        (reference workers.c:371-381)."""
        with self._cv:
            while self._busy():
                self._cv.wait()

    def _pending(self, jobnum: int) -> bool:
        return (jobnum in self._running
                or any(q[0] == jobnum for q in self._queue))

    def wait_on_job(self, jobnum: int):
        """Block until the given job is no longer pending
        (reference workers.c:354-367)."""
        with self._cv:
            while self._pending(jobnum):
                self._cv.wait()

    def is_job_running(self, jobnum: int) -> bool:
        """Non-blocking pending/running query (reference workers.c:327-346)."""
        with self._cv:
            return self._pending(jobnum)

    def worker_sync(self, jobnum: int):
        """In-job ordered-section barrier: returns once every job enqueued
        before ``jobnum`` has finished (reference workers.c:81-117)."""
        with self._cv:
            while any(a_before_b(j, jobnum) for j in self._running) or \
                    any(a_before_b(q[0], jobnum) for q in self._queue):
                self._cv.wait()

    def counts(self) -> tuple[int, int]:
        """(queued, running) — reference workers.c:386-412."""
        with self._cv:
            return len(self._queue), len(self._running)

    def deinit(self):
        """Join all workers (reference workers.c:420-446).  With
        ART_WORKERS_DEBUG set, prints the reference DEBUG-build summary
        line (reference workers.c:425-427) to stderr."""
        self.wait_all()
        if os.environ.get("ART_WORKERS_DEBUG"):
            s = self.stats
            print("total jobs = %u, failures = %u, enqueues = %u, "
                  "currents = %u, unordered = %u"
                  % ((self._next_job - 1) & 0xFFFFFFFF, s["failures"],
                     s["enqueues"], s["inline_runs"], s["out_of_order"]),
                  file=sys.stderr)
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        for t in self._threads:
            t.join()
        self._threads = []


def workers_init(num_workers: int) -> Workers | None:
    """Reference workersInit: 0 workers -> None context; jobs then run
    inline (reference workers.c:133-184, 256-259)."""
    return Workers(num_workers) if num_workers > 0 else None


def workers_enqueue_job(cxt: Workers | None, fn, context, job,
                        policy: int = WAIT_FOR_AVAILABLE_WORKER) -> int:
    if cxt is None:
        fn(context, job)
        return 1
    return cxt.enqueue(fn, context, job, policy)


def workers_wait_all_jobs(cxt: Workers | None):
    if cxt is not None:
        cxt.wait_all()


def workers_deinit(cxt: Workers | None):
    if cxt is not None:
        cxt.deinit()
