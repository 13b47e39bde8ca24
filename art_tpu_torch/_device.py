"""Device selection and float32 precision pins for the PyTorch port.

The counterpart of ``art_tpu/_jaxinit.py``.  Two rules hold everywhere in
the port:

- float32 means IEEE float32.  TF32 is the GPU's counterpart of the TPU's
  single-pass bf16 matmul default, which costs ~90 dB of round-trip SNR on
  this workload; both TF32 switches are pinned off and the matmul precision
  is pinned to "highest".
- A CUDA request without a usable card raises.  Nothing falls back to the
  CPU silently: a CPU tensor is only ever the caller's explicit choice.

The engines' data types and host uploads also live here: ``torch_dtype``
maps the two data types they take, ``to_device`` copies a host array to
the engine's device inside an upload span.
"""

from __future__ import annotations

import numpy as np
import torch

from .utils.spans import UPLOAD, span

_TORCH_DTYPES = {np.dtype(np.float32): torch.float32,
                 np.dtype(np.float64): torch.float64}


def pin_ieee_fp32() -> None:
    """Pin every float32 contraction PyTorch may route to the GPU to IEEE
    float32 (no TF32 in matmuls, no TF32 in cuDNN convolutions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises when CUDA is asked for and no
    card is usable (never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but "
                               "torch.cuda.is_available() is False")
        pin_ieee_fp32()
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device type {dev.type!r} "
                         "(cpu or cuda)")
    return dev


def torch_dtype(dtype) -> torch.dtype:
    """The torch type of an engine's numpy data type ``dtype``; raises
    unless it is float32 or float64."""
    t = _TORCH_DTYPES.get(np.dtype(dtype))
    if t is None:
        raise ValueError(f"dtype must be float32 or float64, got "
                         f"{np.dtype(dtype)}")
    return t


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """The host array ``a`` copied to ``device``, in an upload span."""
    with span(UPLOAD):
        return torch.from_numpy(a).to(device)
