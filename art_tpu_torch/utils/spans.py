"""Named spans of the port's own layers, on the profiler's clock.

``span(name)`` is a profiler record scope while a profiler records
(``torch.profiler.profile``, ``artest --profile``, a benchmark's traced
run), and one shared null context otherwise: no profiler object is made
when nothing records, and nothing here stores or writes a span.  The
profiler keeps each span beside the PyTorch ops and CUDA runtime calls
inside it, on the clock of the device's events, so an idle gap on the
device can be put down to the layer the host was in.

The scope is PyTorch's fast one (``_RecordFunctionFast``, what its own
compiled kernels are marked with): a host event and no mirror on the
device's timeline, about an eighth of a ``record_function``'s cost to
enter and leave while recording.  Where PyTorch lacks it,
``record_function``.

The names, one span each:

- ``CALL``: an engine's public call (``BatchedASRC.process`` / ``flush``,
  ``DeviceStreamResampler.process`` / ``process_scan`` / ``process_flat*``);
- ``DECIMATE``: a decimator's public call (``DeviceDecimator.process_chunk``
  / ``process_chunk_async``, ``Decimator(backend="torch")``'s ``process`` /
  ``process_interleaved``): its state conversions, checks and launch;
- ``BIQUAD``: a device biquad cascade's public call
  (``DeviceBiquadCascade.process``): its checks, state handling and
  launches;
- ``PLAN``: the host plan of such a call (counts, positions, matrix
  lookups), never nested in another plan span;
- ``UPLOAD``: one host-to-device copy on such a call, with the wait for
  the device that a pageable copy makes;
- ``LAUNCH + key``: a launching wrapper in ``ops/`` (checks, geometry,
  output allocation and the launch), ``key`` being the key of the
  ``launches`` counter it bumps (``fixed_step`` for K1).

A host clock besides the profiler's: ``build(what)`` wraps one piece of
one-time host work where it happens, ``BUILD + what`` its span:
``library`` (a kernel library's load, or its compiler's build and then the
load: ``ops/_build.py``), ``first_launch`` (the first launch in the process
of an entry point at the shape that picks its kernel instance, whose ctypes
call pays the instance's lazy module load: ``first_launch(key)``), ``bank``
(an engine's filter bank or section tables and their upload, in its
constructor), ``matrix`` (a phase matrix built and uploaded on a cache
miss) and ``hulls`` (P's hulls or packed hull rows found for K1).  Every
build is tallied in ``builds``, always, from process start: its count and
its own wall ns on ``time.perf_counter_ns`` (a build inside another is the
inner one's alone), apart by whether a profiler was recording; while one
records it is also a span.  Builds are rare; the check on a launch is one
set lookup.
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time

import torch

CALL = "art.engine.call"
DECIMATE = "art.engine.decimate"
BIQUAD = "art.engine.biquad"
PLAN = "art.engine.plan"
UPLOAD = "art.engine.upload"
LAUNCH = "art.launch."
BUILD = "art.build."

_OFF = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled
_scope = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.autograd.profiler.record_function)


# (what, whether a profiler recorded) -> [builds, own wall ns]
builds: dict[tuple[str, bool], list[int]] = {}
_launched: set = set()
_lock = threading.Lock()
_nested = threading.local()     # .ns: wall ns of builds in the open one


class build:
    """A context around one piece of one-time host work of kind ``what``
    (``library``, ``first_launch``, ``bank``, ``matrix``, ``hulls``),
    tallied in ``builds`` on exit and, while a profiler records, the span
    ``BUILD + what``."""

    __slots__ = ("_what", "_scope", "_t0", "_outer")

    def __init__(self, what: str):
        self._what = what

    def __enter__(self):
        self._scope = _scope(BUILD + self._what) if _recording() else None
        if self._scope is not None:
            self._scope.__enter__()
        self._outer = getattr(_nested, "ns", 0)
        _nested.ns = 0
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ns = time.perf_counter_ns() - self._t0
        own = ns - _nested.ns
        _nested.ns = self._outer + ns
        with _lock:
            entry = builds.setdefault((self._what, self._scope is not None),
                                      [0, 0])
            entry[0] += 1
            entry[1] += own
        if self._scope is not None:
            return self._scope.__exit__(*exc)
        return False


def span(name: str):
    """A context that records ``name`` as a span while a profiler records,
    and does nothing otherwise."""
    if _recording():
        return _scope(name)
    return _OFF


def first_launch(key):
    """``build("first_launch")`` the first time ``key`` (an entry point and
    what picks its kernel instance) launches in the process, the shared
    null context after: one set lookup a launch."""
    if key in _launched:
        return _OFF
    _launched.add(key)
    return build("first_launch")


def spanned(name: str):
    """Decorator: the function's body inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def upload(x, device: torch.device):
    """``span(UPLOAD)`` for bringing ``x`` to ``device``, unless ``x`` is
    already a tensor on a device of that kind."""
    if torch.is_tensor(x) and x.device.type == device.type:
        return _OFF
    return span(UPLOAD)
