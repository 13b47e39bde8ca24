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
"""

from __future__ import annotations

import contextlib
import functools

import torch

CALL = "art.engine.call"
DECIMATE = "art.engine.decimate"
BIQUAD = "art.engine.biquad"
PLAN = "art.engine.plan"
UPLOAD = "art.engine.upload"
LAUNCH = "art.launch."

_OFF = contextlib.nullcontext()
_recording = torch.autograd._profiler_enabled
_scope = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.autograd.profiler.record_function)


def span(name: str):
    """A context that records ``name`` as a span while a profiler records,
    and does nothing otherwise."""
    if _recording():
        return _scope(name)
    return _OFF


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
