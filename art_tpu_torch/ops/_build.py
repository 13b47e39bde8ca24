"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` source is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into ONE shared library with a
plain C interface, loaded with ``ctypes`` (no PyTorch headers, so a build
takes seconds).  The library lands in ``build/art_tpu_torch/`` at the root
of the checkout, named by a hash of the sources, headers and flags, so
editing a source rebuilds it and an unchanged tree reuses it.  Nothing is
built at import: the first launch builds.  ``csrc/*_geometry.cpp`` (the
decimate and biquad kernels' host geometry, from the headers ``decimate.cu``
and ``biquad.cu`` include) are built apart, by the host's C++ compiler,
so they need no card.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lib = None
build_log = ""      # nvcc's output of the build this process made, if any
library_path = None  # the shared library loaded, once built

_vp, _ll, _i, _d = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                    ctypes.c_double)
_ASRC_STEP = [_vp, _ll, _vp, _ll, _ll, _vp, _i, _i, _i, _i, _i, _i, _vp,
              _vp, _vp, _ll, _ll, _vp, _vp]
_ASRC_APPLY = [_vp, _ll, _ll, _vp, _i, _i, _i, _i, _i, _i, _vp, _vp, _vp,
               _ll, _vp, _vp]
_SIGNATURES = {
    # buf, ch, W, start, K, P, KQ, L2, fracv, M, L, qn, nb, out, kind,
    # stream
    "art_fixed_step": [_vp, _ll, _ll, _ll, _ll, _vp, _i, _i, _vp, _i, _i, _i,
                       _ll, _vp, _i, _vp],
    # M, qn, interp, kind, &blocks per CTA, &P rows per piece, &shared bytes
    "art_fixed_step_tile": [_i, _i, _i, _i, ctypes.POINTER(_i),
                            ctypes.POINTER(_i), ctypes.POINTER(_ll)],
    # hist, H, x, n, S, bank, taps, F, P, X, outputs per block, threads,
    # offsets, ratios, Ks, shift, k_max, out, stream
    "art_asrc_step_f32": _ASRC_STEP,
    "art_asrc_step_f64": _ASRC_STEP,
    # buf, S, B, bank, taps, F, P, X, outputs per block, threads, base, fi,
    # frac, K, out, stream
    "art_asrc_apply_f32": _ASRC_APPLY,
    "art_asrc_apply_f64": _ASRC_APPLY,
    # x, n, S, x strides (frame, channel), kind, K, scaler, fb, gens,
    # dithered, dither type, new gens, highclip, lowclip, bits, bytes, out,
    # out strides (frame, channel), clips, stream
    "art_decimate_flat": [_vp, _ll, _ll, _ll, _ll, _i, _ll, _d, _vp, _vp, _i,
                          _i, _vp, _i, _i, _i, _i, _vp, _ll, _ll, _vp, _vp],
    # x, n, S, x strides, kind, K, scaler, fb, a|b, xh, yh, gens, dithered,
    # dither type, new gens, new fb, new xh, new yh, highclip, lowclip,
    # bits, bytes, out, out strides, clips, stream
    "art_decimate_shaped": [_vp, _ll, _ll, _ll, _ll, _i, _ll, _d, _vp, _vp,
                            _vp, _vp, _vp, _i, _i, _vp, _vp, _vp, _vp, _i,
                            _i, _i, _i, _vp, _ll, _ll, _vp, _vp],
    # in [21], K, kind, state [9], stream
    "art_decimate_chain_probe": [_vp, _ll, _i, _vp, _vp],
    # sections, x, n, S, x strides (frame, channel), kind, K, then for
    # each of two sections its tables, xh, yh, new xh, new yh; mid and its
    # strides, y and its strides, scratch, epoch, stream
    "art_biquad_cascade": [_i, _vp, _ll, _ll, _ll, _ll, _i, _ll,
                           *[_vp] * 10, _vp, _ll, _ll, _vp, _ll, _ll, _vp,
                           ctypes.c_ulonglong, _vp],
}


# csrc/*_geometry.cpp, built by the host's C++ compiler
_GEOMETRY_SIGNATURES = {
    # n, S, kind, SMs, out [6]: the flat kernel's CTAs, threads, run,
    # stride frames, LCG map
    "art_decimate_flat_geometry": [_ll, _ll, _i, _i, _vp],
    # n, S, K, kind, out [6]: the shaped kernel's groups, zero CTAs, tile,
    # stages, threads, shared bytes
    "art_decimate_shaped_geometry": [_ll, _ll, _ll, _i, _vp],
    # odd, pairs, out [2]: the LCG map of 2 * pairs steps
    "art_decimate_pair_power": [_i, ctypes.c_ulonglong, _vp],
    # out [17]: the biquad kernel's span, table and record layout
    "art_biquad_constants": [_vp],
    # n, S, K, kind, out [5]: spans, active spans, CTAs, shared bytes,
    # scratch words
    "art_biquad_geometry": [_ll, _ll, _ll, _i, _vp],
}
CXX_FLAGS = ["-std=c++17", "-O2", "-fPIC", "-shared"]
_geometry_lib = None


def nvcc() -> str:
    """Path of nvcc: on PATH, else the toolkit's default location."""
    path = shutil.which("nvcc")
    if path is None and os.access("/usr/local/cuda/bin/nvcc", os.X_OK):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found (PATH, /usr/local/cuda/bin): the "
                           "CUDA kernels cannot be built")
    return path


def _compile(sources: list[Path], so: Path) -> str:
    """One nvcc per source, run in parallel, then one link into ``so``.
    Returns nvcc's output; raises if a step fails."""
    tag = f"{os.getpid()}.tmp"
    objs = [so.with_name(f"{so.stem}.{src.stem}.{tag}.o") for src in sources]
    procs = [subprocess.Popen([nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj),
                               str(src)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    log, failed = [], []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode})")
    try:
        if failed:
            raise RuntimeError(f"nvcc failed: {', '.join(failed)}\n"
                               + "".join(log))
        tmp = so.with_suffix(f".{tag}")
        link = subprocess.run([nvcc(), "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True,
                              text=True)
        log.append(link.stdout + link.stderr)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               + "".join(log))
        os.replace(tmp, so)     # atomic: a concurrent process sees all or none
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return "".join(log)


def _headers() -> list[Path]:
    return sorted(CSRC.glob("*.h"))


def _digest(flags: list[str], files: list[Path]) -> str:
    """16 hex digits of a hash of ``flags`` and the files' names and
    bytes: a library's name, so an edit rebuilds it."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in files:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _bind(lib: ctypes.CDLL, signatures: dict) -> ctypes.CDLL:
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def geometry_library() -> ctypes.CDLL:
    """csrc/*_geometry.cpp built with the host's C++ compiler into one
    library (no card, no nvcc): the decimate and biquad kernels' launch
    geometry from the headers their launches include.  Built on first use,
    beside the kernels' library."""
    global _geometry_lib
    if _geometry_lib is not None:
        return _geometry_lib
    srcs = sorted(CSRC.glob("*_geometry.cpp"))
    so = BUILD_DIR / (f"libart_geometry_"
                      f"{_digest(CXX_FLAGS, [*srcs, *_headers()])}.so")
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
        r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp),
                            *map(str, srcs)], capture_output=True, text=True)
        if r.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{cxx} failed ({r.returncode}) on "
                               f"{', '.join(p.name for p in srcs)}:\n"
                               f"{r.stdout}{r.stderr}")
        os.replace(tmp, so)     # atomic, as for the kernels' library
    _geometry_lib = _bind(ctypes.CDLL(str(so)), _GEOMETRY_SIGNATURES)
    return _geometry_lib


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib, build_log, library_path
    if _lib is not None:
        return _lib
    sources = sorted(CSRC.glob("*.cu"))
    so = BUILD_DIR / (f"libart_kernels_"
                      f"{_digest(NVCC_FLAGS, sources + _headers())}.so")
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        build_log = _compile(sources, so)
    lib = _bind(ctypes.CDLL(str(so)), _SIGNATURES)
    library_path = so
    _lib = lib
    return lib
