"""ART-TPU on PyTorch and CUDA: the port of ``art_tpu``'s device layer.

``art_tpu`` (JAX/XLA/Pallas) stays the reference.  This package rewrites
its device layer in PyTorch, with every Pallas kernel on the path replaced
by a kernel written by hand for NVIDIA Hopper (``csrc/``).  The numpy host
layer it needs -- flags, filter design, the float64 consume/emit accounting,
the phase-anchor matrices and the test signals -- is a copy of
``art_tpu``'s (``core/``, ``ops/polyphase.py``, ``utils/``), so counts and
positions match the JAX engines exactly.  Importing this package imports
neither jax nor ``art_tpu``.

Ported so far: the fixed-ratio streaming resampler, reduced and
interpolated, in every precision tier (``DeviceStreamResampler``, chunk step
on kernel K1, ``ops/fixed_step.py``) and the batched drifting-ratio ASRC (``BatchedASRC`` and its artest
adapter ``ASRCStreamResampler``, on the ASRC kernels of
``ops/asrc_step.py``), and the command lines ``art`` and ``artest``
(``python -m art_tpu_torch.cli.art``, ``--backend=cuda``) on the file
pipeline's ``HybridStreamResampler`` and copies of the host engines
(``engines/``, ``io/``, ``native/``), with the device decimate stage
(``ops/decimate_device.py``) and the biquad cascade
(``ops/biquad_kernel.py``) on their own kernels, and the host engines of
``art_tpu``'s top level (``Resampler``, ``Decimator``, ``Biquad``, the
extrapolators, ``Stretcher``), whose accelerator backend ``"torch"``
(``backend="jax"`` in JAX) runs the resampler's calls on kernels K1 and K5
and the shaped decimator on the shaped decimate kernel.  See ROADMAP.md for
what is still to come.
"""

from __future__ import annotations

from .core import flags  # noqa: F401
from .core.flags import *  # noqa: F401,F403
from .engines.biquad import Biquad, BiquadCoefficients  # noqa: F401
from .engines.decimator import Decimator  # noqa: F401
from .engines.extrapolator import (extrapolate_forward,  # noqa: F401
                                   extrapolate_reverse)
from .engines.resampler import Resampler, ResampleResult  # noqa: F401
from .engines.stretch import Stretcher  # noqa: F401

from ._device import pin_ieee_fp32, resolve_device  # noqa: F401
from .parallel.asrc import ASRCStreamResampler, BatchedASRC  # noqa: F401
from .parallel.streams import (DeviceStreamResampler,  # noqa: F401
                               HybridStreamResampler)

pin_ieee_fp32()

__version__ = "0.1.0"
