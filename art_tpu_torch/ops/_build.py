"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` into ONE shared library
with a plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a
build takes seconds).  The library lands in ``build/art_tpu_torch/`` at the
root of the checkout, named by a hash of the sources and flags, so editing a
source rebuilds it and an unchanged tree reuses it.  Nothing is built at
import: the first launch builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "art_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_log = ""      # nvcc's output of the build this process made, if any

_vp, _ll, _i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_SIGNATURES = {
    # buf, ch, W, start, K, P, KQ, L2, fracv, M, L, qn, nb, out, stream
    "art_fixed_step": [_vp, _ll, _ll, _ll, _ll, _vp, _i, _i, _vp, _i, _i, _i,
                       _ll, _vp, _vp],
}


def nvcc() -> str:
    """Path of nvcc: on PATH, else the toolkit's default location."""
    path = shutil.which("nvcc")
    if path is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): the "
                           "CUDA kernels cannot be built")
    return path


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, build_log
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    so = BUILD_DIR / f"libart_kernels_{h.hexdigest()[:16]}.so"
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)],
            capture_output=True, text=True)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{build_log}")
        os.replace(tmp, so)     # atomic: a concurrent process sees all or none
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib
