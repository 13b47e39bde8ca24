#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``art_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py               # every phase; needs one card
    python3 chip_smoke.py --checksum    # only K1's output hashes (3 lines)
    python3 chip_smoke.py --profile-biquad  # the biquad kernel's device times
    python3 chip_smoke.py --decimate-ab build/parent  # decimate A/B, in turns
    python3 chip_smoke.py --biquad-ab build/parent    # biquad A/B, in turns

Drives the port's paths on the card -- the fixed-ratio streaming
resampler (preset -3, 2 channels, 380 taps, 44.1k<->48k, reduced; and
BASELINE config 1, preset -1 mono 44.1k->48k, interpolated) in every
dispatch form and precision tier (precise=True and "int8" on the headline
engine, float64 data at BASELINE config 4's resampler, 5.1 channels
48k->44.1k, and config 4b's chain with its biquad cascade), and the
batched drifting-ratio ASRC at BASELINE config 5
(256 streams, 380 taps, 380 filters, 32768-frame chunks, ratios 1 + 0.01
sin(0.1 s + 0.031 t)) -- in phases; any failure raises and exits non-zero:

1. device: the card's name, count, and nvidia-smi's name and power limit;
2. build: every kernel of art_tpu_torch/csrc/ from the checkout (one nvcc
   per source, in parallel), with ptxas's register and spill lines; no
   kernel instance (K1's eighteen: float32, float32 with float64
   accumulators and float64, reduced and interpolated, three tiles; the
   ASRC step's two and the apply's two; the decimate stage's flat and shaped
   kernels and the shaped chain's probe in float32 and float64; the biquad
   section's span kernel in float32 and float64) may spill, and the six
   decimate instances' SASS (cuobjdump) may hold no FFMA or DFMA;
3. K1 against its plain PyTorch version on the card, at the main path's
   shapes (~2^22-frame stereo chunks), its edge cases, BASELINE config 1's
   interpolated chunk and the large input periods (preset -3 192k->44.1k,
   M=640; preset -1 96k->44.1k interpolated, M=320; 192k->11.025k, M=2560,
   reduced and interpolated, whose window K1 stages in column pieces) with
   the tile K1 picked
   for each and the hull it keeps (the rows of P from the first to the
   last nonzero in a CTA's 32 phases): max abs error vs the float64 plain
   version <= 1e-5, a zero tail past K, the new history bitwise equal;
   then the sha256 of K1's bytes on the preset -3 chunk, on config 1's
   interpolated chunk and on K6's main-path call (``--checksum`` prints
   them alone, also from an older checkout);
4. K6 (polyphase_apply) against its float64 plain version at the main
   path's shapes (<= 1e-5) with its hull, then its entry point called 4
   times: 4 launches;
5. the ASRC kernels against their plain versions at config 5's shapes,
   after the geometry (bank piece, outputs per block, threads, shared
   memory) each asrc_step instance picks there:
   near-1 drifting ratios, ratios 0.5, 0.2 and 2.0, a mid-tile Ks, Ks = 0
   rows, the flush call and S = 3; float32 within 1e-5 and float64 within
   1e-12 of the float64 plain version, new history bitwise, the apply
   kernel within 1e-5;
6. the fixed-ratio paths, K1's launches counted on each against its
   design (one per process() call and per chunk of process_scan and
   process_flat, one per process_flat_out/_packed group):
   - the 60 s artest round trip through the headline path (first chunk by
     process(), M-multiple groups by process_flat_out, tail, flush()):
     <= -130 dB and no more than 3 dB above the same stream on the CPU;
   - config 1: the first chunk by process(), then 16 ~2^22-frame chunks
     through process_flat, process_scan(stats=True) and process_flat_out,
     the last group replayed on a CPU engine of the port from the card's
     state (counts and positions equal, samples within 1e-5);
   - the headline group forms (G=8 chunks of 4,194,351 frames) against
     sequential process(): process_flat and process_scan bitwise in
     history, power and Ks, process_flat_out and process_scan bitwise in
     samples, process_flat_packed's bytes and clip counts (its epilogue
     one decimate_flat_kernel launch) equal to quantizing those samples
     on the host, with a power-of-two and another scaler;
7. the ASRC paths: BatchedASRC.process() over 256 streams and 32768-frame
   chunks with the drifting ratios, then staggered flush(mask) calls, in
   float32 (kernel "auto", 30 calls), float64 (8 calls) and with the apply
   kernel (kernel "pallas", 6 calls); 8 of the streams replayed through a
   CPU engine of the port: counts and positions exactly equal, samples
   within 1e-5 (float32) and 1e-12 (float64); each kernel's launch count
   equals the number of dispatching calls;
8. throughput: three windows of 8 chunks through process(x, n, acc), the
   host's planning time per chunk, K1's step against the plain step and
   one conv1d call (the library yardstick); K1 on config 1's interpolated
   chunk against its plain version; the group forms as
   bench._bench_device_fixed measures them (config 1 and config 1b, 64
   mono rows, by process_flat, G=16; preset -3 by process_flat,
   process_flat_out and process_flat_packed, G=8) with the host's group
   plan, the int16 rate beside the delivered one; K6 against its plain
   version and conv1d; config 5's bench.py
   loop with kernel "auto" (the step) and "pallas" (the apply), its host
   planning time, and the ASRC step (kernel only, kernel step, plain step)
   and apply in ms per call, in float32 and float64;
   all kernel times with CUDA events, taken in turns;
9. the precision tiers' K1 instances against their plain versions at full
   width, with the tile each picks: float32 data with float64 accumulators
   (precise=True and "int8") on the preset -3 chunk, config 1's
   interpolated chunk and the M=2560 shapes, within 1 float32 ulp of the
   float64 dots rounded once (the count of samples that differ printed);
   float64 data on config 4's chunk and the M=2560 shapes, within 1e-12;
10. the tiers' paths, each instance's launches counted: precise="int8"
   through the headline group forms as in 6 (bench.py's headline engine),
   config 4's float64 data through the same forms, and the 60 s round trip
   in precise=True and "int8", each within 0.1 dB of the plain path's
   reading on the CPU;
11. the tiers' throughput: each new instance beside the float32 instance
   at the same shape, with its plain version and one conv1d on float64
   operands, and process_flat_out's rate in the "int8" and float64 tiers;
12. the CLIs on the card, through their ``main`` as ``python -m
   art_tpu_torch.cli.art`` / ``.artest`` run them: a 60 s stereo 44.1k
   float32 WAV of artest noise with fades (written into build/) converted
   by ``art -3 -r48k`` and ``art -3 -r48k -o16`` with --backend=cuda and
   --backend=numpy (output frames and clip warnings equal, float32 samples
   within 1e-5, 16-bit codes within the shaped-noise floor, K1 launched
   once per steady block), ``art -3 -r48k -o16 -n0`` (the decimate stage
   on the card: codes within the same floor, one decimate_flat launch per
   block) and ``art -3 -o16 -n0`` (no resampler: bytes identical);
   ``artest -3 -s44.1k -d48k -c2 -e -i`` for 60 s
   (-w5 <= -130 dB, every -w count equal to the numpy backend's), the same
   with --precise (K1's float32-with-float64-accumulators instance) and
   ``artest -1 -s44.1k -d48k -c2 -i`` (the ASRC step; counts equal, -w5
   within 0.5 dB of numpy), each with artest's --timing stage split;
   wall time and M output frames/s of each command beside its numpy leg;
   and where an art steady block's time goes on the card: the whole
   HybridStreamResampler block beside its host plan, upload, K1 step and
   fetch, and the card's busy share over 50 blocks from torch.profiler;
13. the device decimate stage: each kernel's launch geometry at the main
   shapes (the flat kernel's CTAs and stride; the shaped kernel's CTAs,
   tile, stages, threads and shared memory; decimate_geometry.h, the
   code the launches run) with its registers and spills;
   decimate_flat_kernel and decimate_shaped_kernel against their plain
   versions on the card,
   bitwise in packed bytes, clip counts and the new LCG and shaper state:
   the flat kernel on a 2^22-frame stereo chunk read in K1's [ch,
   capacity] layout (bits 8, 16, 24 and 24 in 4 bytes, dither types -1,
   1, 0 and 2 and none, the per-channel container with a power-of-two
   and another scaler; K = n - 777 with NaN past it), both on the art
   command's steady block (K1's output of a 16,384-frame preset -3 block;
   ATH and 2nd-order shaping, dithered and not, float64), the shaped
   kernel on the 2^22 chunk against the native host decimator, at S = 6
   and 33 (two chain warps) with K in the ring's last stage, and on the
   art block cut into 3 calls against one; the sha256 of the flat
   kernel's 2^22 chunk and of the shaped kernel's art block with their
   states (``--decimate-ab`` checks them against an older tree);
   DeviceDecimator against the native host decimator over a 60 s stereo
   stream in 16,384-frame blocks (unshaped, ATH-shaped, 24-bit), bitwise;
   pipeline_chunk at the preset -3 shapes (flat and shaped: history and
   power K1's, bytes the plain version's or the native host's); then the
   times (decimate_times, the A/B's harness): a call's with CUDA events
   and the kernel's on the card with the L2 flushed (torch.profiler) for
   the flat kernel on the 2^22 chunk, process_flat_packed's int16
   epilogue and the shaped kernel per art block, the shaped kernel per
   2^22 chunk, Decimator(backend="torch") and the native host over phase
   15's stream; beside them the plain versions, the native host decimator
   and the bounds: bytes for the flat kernel, for the shaped one the time
   of decimate_chain_probe_kernel (its per-frame chain alone, in one
   thread, on values in registers) at the art block's K, its final state
   bitwise its plain version's;
14. the biquad cascade (csrc/biquad.cu, one launch a section, a cascade
   one host call): the kernel against its float64 plain version at
   BASELINE config 4b's chunk (6 x 524,320 float64; the combined section
   and the cascade's two) and at art -3 -r96k -p's steady block (float32,
   2 channels), at K = n, n - 777 with NaN past it, 0, 3, 256 and around
   the 8192-frame span edges (float64 within 1e-12 of scale, float32
   within 1 ulp, zero past K, xh' bitwise, yh' within 1e-12);
   DeviceBiquadCascade against the native host pair over a 60 s 5.1
   float64 stream with a mid-stream pull_to / push_from (within 1e-12),
   2 launches and 1 host call a block; config 4b's chain (the combined
   cascade into the float64 resampler, bench.py:297-335) for windows of 8
   chunks, M output frames/s, 1 launch a process() and K1's float64
   instance once a chunk; pipeline_chunk with the -p post filter at the
   preset -3 shapes against the plain chain (2 launches); art -3 -r96k -p
   -o16 -n0 with --backend=cuda beside numpy (codes within the floor, one
   cascade, 2 launches, per steady block); then the times (biquad_times,
   the A/B's harness): a section and the cascade at config 4b's chunk, a
   call's with CUDA events and the kernel's on the card with the L2
   flushed, the cascade on the art block (CUDA events and host time a
   call), beside the plain version in turns, one torch.matmul of JAX's
   Toeplitz product (one stage of JAX's method, printed, not the
   library yardstick: there is none), the native host cascade and pair,
   and the bound;
15. the host engines' accelerator backend (``backend="torch"``, JAX's
   ``backend="jax"``): K5's float64 instance against its plain version at
   config 5's shapes and on an art block's interpolated apply (within
   1e-12), and an art block's exact apply at F = 1024, whose phase index
   reaches F (float32 and float64, against the host's float64 dots);
   Resampler(backend="torch") against backend="numpy" on a 60 s stereo
   44.1k stream in 16,384-frame calls plus the flush (preset -3 -> 48k on
   K1, preset -3 pitched +50 cents and preset -1 at a ratio drifting per
   call on K5, preset -3 -> 48k in float64 on K1's float64 instance and
   K5's): counts and positions equal, samples within 1e-5 / 1e-12, each
   kernel launched once for each call the design sends it;
   Decimator(backend="torch") ATH-shaped, dithered, 16-bit against the
   native host over the same stream, bitwise, one shaped decimate launch
   a call; art -3 -r48k, artest -3 -e -i and artest -1 -i with
   --backend=torch beside phase 12's numpy legs, on phase 12's criteria;
   the streams' rates, and K5's float64 instance timed against its plain
   version with its bound.

Prints a {"kernels": [...]} line with each kernel's launches, error, times
and bound (the shaped decimate kernel's bound by latency; ``ms`` a call's
CUDA-events time, ``device_ms`` the decimate and biquad kernels' device
time with the L2 flushed, null for the others), then, last, the {"ok":
true, "device":
...} line.  Without a usable CUDA device it exits 2
and prints no result.

``--biquad-ab build/parent`` does the same for the biquad cascade
(biquad_times, four processes in turns, each writing its outputs under
build/biquad_ab/): the same tree's outputs bitwise equal in its two turns,
the change's within the class of the parent's.

``--decimate-ab build/parent`` times the decimate stage against an older
tree unpacked there (git archive), in four processes in turns (parent,
change, change, parent): the flat kernel on the 2^22 chunk,
process_flat_packed's int16 epilogue, the shaped kernel on the art block
and the 2^22 chunk, and Decimator(backend="torch") beside the native host
(decimate_times, as phase 13 takes them); the hashes of every turn must
be equal.
"""

from __future__ import annotations

import contextlib
import hashlib
import io
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from art_tpu_torch import (BLACKMAN_HARRIS, INCLUDE_LOWPASS,
                           SUBSAMPLE_INTERPOLATE, BatchedASRC,
                           DeviceStreamResampler, roundtrip)
from art_tpu_torch.core.filters import make_filter_bank
from art_tpu_torch.core.flags import (DITHER_FLAT, DITHER_HIGHPASS,
                                      DITHER_LOWPASS, SHAPING_2ND_ORDER,
                                      SHAPING_ATH_CURVE)
from art_tpu_torch.ops import _build
from art_tpu_torch.ops import asrc_step as kasrc
try:    # an older checkout (--checksum beside it) has no decimate stage
    from art_tpu_torch.ops import decimate_device as dd
except ImportError:
    dd = None
try:    # nor a biquad cascade
    from art_tpu_torch.ops import biquad_kernel as bk
except ImportError:
    bk = None
from art_tpu_torch.ops import fixed_step as k1
from art_tpu_torch.parallel import streams
from art_tpu_torch.parallel.pipeline import (window_and_hist, window_at,
                                             window_dots)

# bench.py's headline configuration (preset -3); the planner reduces it
FLAGS = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS | INCLUDE_LOWPASS
# BASELINE config 1 (bench.py:241-245): preset -1 mono 44.1k->48k, 48 taps,
# 48 filters, no lowpass; 48 filters cannot carry 160 phases, so the
# engine runs its interpolated mode
INTERP = (1, 48, 48, 44100, 48000, 0, SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS)
# BASELINE config 4's resampler (bench.py:303-307): 5.1 channels of float64
# data, 48k->44.1k, 380 taps, reduced to L=147, M=160, qn=4
CONFIG4 = (6, 380, 380, 48000, 44100, 0, FLAGS)
# the headline engine (bench.py:383, 416-417)
HEAD = (2, 380, 380, 44100, 48000, 0, FLAGS)
# BASELINE config 5 as bench.py measures it (bench.py:353-365)
ASRC_S, ASRC_TAPS, ASRC_N = 256, 380, 32768
# H100 SXM data sheet peaks at 700 W (NVIDIA): HBM3, float32 outside the
# tensor cores (TF32 is not IEEE float32), and float64 on the FP64 tensor
# cores (DMMA is IEEE double; the CUDA cores alone give 34 TFLOP/s)
PEAK_BYTES, PEAK_F32, PEAK_F64 = 3.35e12, 67e12, 67e12


def _require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def _kw(eng, K: int) -> dict:
    return dict(M=eng.M, L=eng.L, nb=-(-K // eng.L) if K else 1, qn=eng.qn,
                hist_len=eng.num_samples)


def _f64(t):
    return None if t is None else t.double()


def _engine(src: int, dst: int, dev) -> DeviceStreamResampler:
    eng = DeviceStreamResampler(2, 380, 380, src, dst, 0, FLAGS, device=dev)
    eng.advance_position(190)
    return eng


def phase_device():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"device: {name}; torch.cuda.device_count() = {count}; "
          f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(smi)
    return name, count, f"[{smi}]"


def _ptxas(log, pattern):
    """{kernel: the integers ``pattern`` captures in its ptxas -v lines}."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
        m = re.search(pattern, line)
        if m and fn:
            out[fn] = tuple(int(g) for g in m.groups())
    return out


def _spills(log):
    """{kernel: (spill store bytes, spill load bytes)} from ptxas -v."""
    return _ptxas(log, r"(\d+) bytes spill stores, (\d+) bytes spill loads")


def _registers(log):
    """{kernel: registers a thread} from ptxas -v."""
    return {k: v[0] for k, v in _ptxas(log, r"Used (\d+) registers").items()}


def phase_build():
    t0 = time.perf_counter()
    _build.library()
    print(f"build: {', '.join(p.name for p in sorted(_build.CSRC.glob('*.cu')))}"
          f" built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log.splitlines():
        if line.startswith("==") or "ptxas" in line or "spill" in line:
            print(f"  {line.strip()}")
    if _build.build_log:        # empty when an earlier process built it
        # 18 fixed_step_kernel instances (float, float-with-double
        # accumulators and double; reduced and interpolated; 3 tiles), 4
        # ASRC ones (step and apply, float32 and float64), 6 decimate ones
        # (the flat and shaped kernels and the shaped chain's probe, float
        # and double), 2 biquad ones (the span kernel, float and double)
        inst = {k: v for k, v in _spills(_build.build_log).items()
                if "_kernel" in k}
        print(f"  kernel instances (spill store, load bytes): {inst}")
        _require(len(inst) == 30 and not any(sum(v) for v in inst.values()),
                 "a kernel instance spills (or is missing)")
    _require_no_fma("decimate", 6)


def _cuobjdump() -> str:
    path = Path(_build.nvcc()).with_name("cuobjdump")
    _require(path.exists(), f"cuobjdump not found beside nvcc ({path})")
    return str(path)


def _require_no_fma(tag, count):
    """The SASS of each of the ``count`` kernels whose name holds ``tag``
    has no fused multiply-add (FFMA, DFMA): the decimate stage's bytes are
    a bit-exact contract, so every product is rounded before its sum (the
    shaped chain's probe too, since it times that chain)."""
    sass = subprocess.run([_cuobjdump(), "-sass", str(_build.library_path)],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    found, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1) if tag in m.group(1) else None
            if fn:
                found[fn] = [0, 0]
        elif fn and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            found[fn][0] += 1
            if re.search(r"\b(FFMA|DFMA)", line):
                found[fn][1] += 1
    print(f"  SASS of the {tag} kernels (instructions, FFMA/DFMA): {found}")
    _require(len(found) == count and all(n > 0 and f == 0
                                     for n, f in found.values()),
             f"a {tag} kernel holds a fused multiply-add (or is missing)")


def _steady_chunk(ctor, dev, n_target, **opts):
    """A steady M-multiple chunk of an engine built from ``ctor`` (and
    ``opts``: dtype, precise): (eng, n, K, start, P, fracv, kw) from the
    card engine's real plan (BASELINE config 1's interpolated chunk with
    ``INTERP``)."""
    eng = DeviceStreamResampler(*ctor, device=dev, **opts)
    eng.advance_position(ctor[1] // 2)
    n = roundtrip.m_multiple(n_target, eng.M)
    eng._plan(n)
    K, start, j0, pos0, plan = eng._plan_compute(n)
    kw = _kw(eng, K)
    if eng.interp:
        P, fracv = eng._interp_pattern(pos0, plan, n, K, kw["nb"])[:2]
    else:
        P, fracv = eng._matrix(j0), None
    return eng, n, K, start, P, fracv, kw


def _hull(P, L, interp):
    """What K1 keeps of P: the rows from the first to the last nonzero in
    each CTA's 32 phases (both banks' in the interpolated form), as a line
    of text (the kernel finds the same rows from P itself)."""
    nz = P != 0
    if interp:
        nz = nz[:, :L] | nz[:, L:]
    kept, work = [], 0
    for n0 in range(0, L, 32):
        rows = nz[:, n0:n0 + 32].any(dim=1).nonzero()
        kept.append(int(rows[-1] - rows[0] + 1) if len(rows) else 0)
        work += kept[-1] * min(32, L - n0)
    return (f"hull {min(kept)}-{max(kept)} of {P.shape[0]} rows per 32-phase "
            f"CTA ({work / (P.shape[0] * L):.1%} of the rows x phases)")


def _kernel_cases(dev, n_target):
    """(label, hist, x, P, fracv, start, K, kw) at the main path's shapes,
    inputs std-0.5 noise from a fixed numpy seed."""
    rng = np.random.default_rng(1234)

    def noise(*shape):
        return torch.from_numpy(
            rng.normal(0, 0.5, shape).astype(np.float32)).to(dev)

    cases = []
    for src, dst in ((44100, 48000), (48000, 44100)):
        eng = _engine(src, dst, dev)
        n = roundtrip.m_multiple(n_target, eng.M)
        hist, x = noise(2, eng.num_samples), noise(2, n)
        leg = f"{src / 1000:g}k->{dst / 1000:g}k"
        K0, s0, j0, _, _ = eng._plan_compute(n)
        cases.append((f"{leg} first chunk (start={s0}, j0={j0})", hist, x,
                      eng._matrix(j0), None, s0, K0, _kw(eng, K0)))
        Ks, ss, js, _, _ = eng._plan_compute(1000)
        cases.append((f"{leg} n_in=1000 < hist_len", hist, x[:, :1000],
                      eng._matrix(js), None, ss, Ks, _kw(eng, Ks)))
        eng._plan(n)
        K, start, js, _, _ = eng._plan_compute(n)
        for j in ((0, 1, 80, 159) if src == 44100 else (js,)):
            cases.append((f"{leg} steady j0={j} K={K}", hist, x,
                          eng._matrix(j), None, start, K, _kw(eng, K)))
        if src == 44100:
            Km = K - eng.L - eng.L // 3
            for k, what in ((0, "K=0"), (Km, f"K={Km} mid-block")):
                cases.append((f"{leg} {what}", hist, x, eng._matrix(js),
                              None, start, k, _kw(eng, k)))
    # interpolated form at the 48/48-tap 44.1k->48k shapes: qn=2, P2
    # [294, 320], fracv [160]; random, since the interpolated engine mode
    # is not ported yet (the kernel's fracv epilogue is)
    M, L, qn, H = 147, 160, 2, 48 * 16
    n = roundtrip.m_multiple(n_target, M)
    P2 = torch.from_numpy(rng.normal(0, 0.05, (qn * M, 2 * L))
                          .astype(np.float32)).to(dev)
    fracv = torch.from_numpy(rng.random(L).astype(np.float32)).to(dev)
    K = n * L // M
    cases.append(("interp fracv 48/48 taps, dense random P2", noise(2, H),
                  noise(2, n), P2, fracv, 100, K,
                  dict(M=M, L=L, nb=-(-K // L), qn=qn, hist_len=H)))
    eng, n, K, start, P2, fracv, kw = _steady_chunk(INTERP, dev, n_target)
    cases.append((f"config 1 (preset -1 mono 44.1k->48k) interpolated steady "
                  f"K={K}", noise(1, eng.num_samples), noise(1, n), P2, fracv,
                  start, K, kw))
    # large input periods, which the 128-block tile did not fit: preset -3
    # 192k->44.1k (reduced, M=640) and preset -1 96k->44.1k (interpolated,
    # M=320); and those whose whole window fits no tile, so it comes in
    # column pieces: 192k->11.025k (M=2560) in both modes
    for taps, src, dst in _LARGE_M:
        eng, n, K, start, P, fracv, kw = _steady_chunk(
            (2, taps, taps, src, dst, 0, FLAGS), dev, n_target)
        cases.append((_large_label(eng, src, dst, K),
                      noise(2, eng.num_samples), noise(2, n), P, fracv,
                      start, K, kw))
    return cases


# (taps, source rate, destination rate) of the large-input-period cases
_LARGE_M = ((380, 192000, 44100), (48, 96000, 44100), (380, 192000, 11025),
            (48, 192000, 11025))


def _large_label(eng, src, dst, K):
    return (f"preset {-1 if eng.interp else -3} {src / 1000:g}k->"
            f"{dst / 1000:g}k M={eng.M} qn={eng.qn} "
            f"{'interpolated' if eng.interp else 'reduced'} steady K={K}")


def phase_kernel_vs_plain(dev, n_target=1 << 22):
    """Returns the largest |K1 - float64 plain| over the cases."""
    worst = 0.0
    for label, hist, x, P, fracv, start, K, kw in _kernel_cases(dev,
                                                                n_target):
        acc = torch.zeros((), device=dev)
        h, out, a = k1.fixed_step(hist, x, P, start, K, acc, fracv=fracv,
                                  **kw)
        h32, o32, _ = k1.fixed_step_reference(hist, x, P, start, K, acc,
                                              fracv=fracv, **kw)
        _, o64, a64 = k1.fixed_step_reference(
            _f64(hist), _f64(x), _f64(P), start, K, acc.double(),
            fracv=_f64(fracv), **kw)
        err = float((out.double() - o64).abs().max())
        err32 = float((o32.double() - o64).abs().max())
        acc_rel = abs(float(a) - float(a64)) / max(abs(float(a64)), 1e-30)
        tail0 = not bool(out[:, K:].any())
        hist_eq = bool(torch.equal(h, h32))
        finite = bool(torch.isfinite(out).all())
        tile = k1.kernel_tile(kw["M"], kw["qn"], fracv is not None)
        print(f"  {label}: tile {tile[0]} blocks x P pieces of {tile[1]} "
              f"rows, {tile[2]} B shared; "
              f"{_hull(P, kw['L'], fracv is not None)}; out {tuple(out.shape)}; "
              f"max|K1 - f64 plain| = "
              f"{err:.3e} (f32 plain: {err32:.3e}); acc rel err "
              f"{acc_rel:.2e}; tail zero {tail0}; new_hist bitwise {hist_eq}")
        _require(finite and err <= 1e-5 and tail0 and hist_eq,
                 f"K1 vs plain, {label}")
        worst = max(worst, err)
    return worst


def phase_roundtrip(dev, seconds=60, precise=False):
    """The 60 s round trip through the headline path in the ``precise``
    tier.  Returns (K1's launch count during it, the diff RMS in dB)."""
    inst = k1.instance(torch.float32, bool(precise))
    _reset_launches()
    t0 = time.perf_counter()
    rt = roundtrip.roundtrip_diff_db(seconds, dev, precise=precise)
    secs = time.perf_counter() - t0
    launches = k1.launches
    mine = k1.instance_launches[inst]
    rt_cpu = roundtrip.roundtrip_diff_db(seconds, "cpu", precise=precise)
    print(f"  round trip {seconds} s stereo, precise={precise!r}: "
          f"{rt['diff_db']:.2f} dB on {dev} (K1 {inst}, {secs:.2f} s wall "
          f"incl. matrix builds), {rt_cpu['diff_db']:.2f} dB on cpu (plain "
          f"path); output frames {rt['frames']} vs {rt_cpu['frames']}")
    print(f"  K1 launches {launches} ({inst}: {mine}), "
          f"process()/process_flat_out()/flush() calls {rt['calls']}")
    _require(rt["frames"] == rt_cpu["frames"], "output counts differ")
    _require(rt["diff_db"] <= -130.0, "round trip above -130 dB")
    if precise:
        # each dot rounded once on both sides: the readings agree
        _require(abs(rt["diff_db"] - rt_cpu["diff_db"]) <= 0.1,
                 f"precise={precise!r} round trip more than 0.1 dB from "
                 "its plain reading")
    else:
        # one-sided: K1 sums each dot in blocks of 32 terms and lands below
        # the CPU's sgemm order; the gate catches a kernel path that is
        # worse (a TF32 leak would land far above -100 dB)
        _require(rt["diff_db"] <= rt_cpu["diff_db"] + 3.0,
                 "kernel-path round trip more than 3 dB above the plain "
                 "path")
    _require(dev.type != "cuda" or launches == mine == rt["calls"] > 0,
             "K1 launches != dispatching calls")
    return launches, rt["diff_db"]


def _time_ms(dev, fn, reps):
    if dev.type != "cuda":          # CPU rehearsal of the control flow only
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_throughput(dev, tag, n_target=1 << 22, nchunks=8, windows=3,
                     reps=10):
    """Returns the median ms per chunk of each timed variant."""
    eng = _engine(44100, 48000, dev)
    eng.prewarm()
    n = roundtrip.m_multiple(n_target, eng.M)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(0, 0.5, (2, n)).astype(np.float32)) \
        .to(dev)
    acc = torch.zeros((), device=dev)
    eng.process(x, n, acc)                       # warm-up, first chunk
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for window in range(windows):
        sync()
        t0 = time.perf_counter()
        produced = 0
        for _ in range(nchunks):
            _, K, acc = eng.process(x, n, acc)
            produced += K
        sync()
        dt = time.perf_counter() - t0
        print(f"  process() window {window}: {nchunks} chunks x {n} frames "
              f"-> {produced} output frames in {dt * 1e3:.3f} ms = "
              f"{produced / dt / 1e6:.2f} M output frames/s {tag}")
    _require(bool(torch.isfinite(acc)), "power accumulator not finite")
    t0 = time.perf_counter()
    for _ in range(20):
        eng._plan_compute(n)
    print(f"  host consume/emit plan: "
          f"{(time.perf_counter() - t0) / 20 * 1e6:.1f} us per chunk "
          f"(float64 accounting on the host CPU)")

    K, start, j0, _, _ = eng._plan_compute(n)
    kw = _kw(eng, K)
    P, hist = eng._matrix(j0), eng.hist
    buf = torch.cat([hist, x], dim=1)
    zero = torch.zeros((), device=dev)
    # the library yardstick: one conv1d over the window, weight P.T, stride
    # M, computes every block's dots (K1's function before the mask)
    KQ = kw["qn"] * kw["M"]
    win = window_and_hist(x, hist, start, (kw["nb"] - 1) * kw["M"] + KQ,
                          kw["hist_len"])[0][:, None, :].contiguous()
    weight = P.T[:, None, :].contiguous()

    def conv():
        return torch.nn.functional.conv1d(win, weight, stride=kw["M"])

    ref = k1.fixed_step_reference(hist, x, P, start, K, zero, **kw)[1]
    conv_out = conv().transpose(1, 2).reshape(ref.shape)[:, :K]
    conv_err = float((conv_out - ref[:, :K]).abs().max())
    print(f"  conv1d yardstick vs plain step: max abs diff {conv_err:.3e}")
    _require(conv_err <= 1e-5, "conv1d yardstick computes another function")
    variants = {
        "K1 step": lambda: k1.fixed_step(hist, x, P, start, K, zero, **kw),
        "plain step": lambda: k1.fixed_step_reference(hist, x, P, start, K,
                                                      zero, **kw),
        "K1 kernel only": lambda: k1.fixed_step_kernel(
            buf, P, start, K, M=kw["M"], L=kw["L"], nb=kw["nb"],
            qn=kw["qn"]),
        "conv1d library": conv,
    }
    order = ["plain step", "K1 step", "K1 kernel only", "conv1d library",
             "conv1d library", "K1 kernel only", "K1 step", "plain step"]
    med = _time_in_turns(dev, variants, order, reps, f"per {n}-frame chunk",
                         tag)
    ch, H = hist.shape
    # each output needs the num_taps taps of its phase's filter; the other
    # rows of its P column are structural zeros
    med["bound"] = _bound_ms(
        4 * (2 * ch * H + ch * n + P.numel() + ch * kw["nb"] * kw["L"]),
        2 * ch * K * eng.num_taps, PEAK_F32)
    return med


def _time_in_turns(dev, variants, order, reps, unit, tag):
    """Median ms per call of each variant, timed in ``order`` twice."""
    if dev.type != "cuda":          # CPU rehearsal: the kernels cannot run
        order = [name for name in order
                 if "kernel" not in name and "library" not in name]
        variants = {name: variants[name] for name in order}
    for fn in variants.values():
        fn()
    times = {name: [] for name in variants}
    for _ in range(2):
        for name in order:
            times[name].append(_time_ms(dev, variants[name], reps))
    med = {name: sorted(t)[len(t) // 2] for name, t in times.items()}
    for name, t in times.items():
        print(f"  {name}: {med[name]:.4f} ms {unit} "
              f"(runs {', '.join(f'{v:.4f}' for v in t)}) {tag}")
    return med


def _bound_ms(nbytes: int, flops: int, peak_flops: float):
    """(the least time the card could take in ms, what bounds it): the
    larger of the bytes over the memory rate and the operations over the
    peak rate of their type."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _sha256(t):
    return hashlib.sha256(t.cpu().numpy().tobytes()).hexdigest()


def k1_checksum(dev, n_target=1 << 22):
    """sha256 of K1's output bytes on the preset -3 44.1k->48k steady
    chunk (4,194,351 frames in, std-0.5 noise from a fixed seed).  Uses
    only entry points the port has had since its first kernel, so
    ``python3 chip_smoke.py --checksum`` run from an older checkout prints
    that tree's bytes for the same input (as do the two below, for trees
    that have the interpolated mode and K6)."""
    eng = _engine(44100, 48000, dev)
    n = roundtrip.m_multiple(n_target, eng.M)
    eng._plan(n)
    K, start, j0, _, _ = eng._plan_compute(n)
    rng = np.random.default_rng(4242)
    buf = torch.from_numpy(rng.normal(0, 0.5, (2, eng.num_samples + n))
                           .astype(np.float32)).to(dev)
    kw = _kw(eng, K)
    out = k1.fixed_step_kernel(buf, eng._matrix(j0), start, K, M=kw["M"],
                               L=kw["L"], nb=kw["nb"], qn=kw["qn"])
    return _sha256(out)


def k1_checksum_interp(dev, n_target=1 << 22):
    """sha256 of K1's output bytes on BASELINE config 1's steady
    interpolated chunk (mono, 4,194,351 frames in, std-0.5 noise)."""
    eng, n, K, start, P2, fracv, kw = _steady_chunk(INTERP, dev, n_target)
    rng = np.random.default_rng(4343)
    buf = torch.from_numpy(rng.normal(0, 0.5, (1, eng.num_samples + n))
                           .astype(np.float32)).to(dev)
    return _sha256(k1.fixed_step_kernel(
        buf, P2, start, K, M=kw["M"], L=kw["L"], nb=kw["nb"], qn=kw["qn"],
        fracv=fracv))


def k1_checksum_poly(dev):
    """sha256 of K6's output bytes on its main-path call (_poly_inputs)."""
    win, P, kw = _poly_inputs(dev)
    return _sha256(k1.polyphase_apply(win, P, **kw))


def k1_checksums(dev):
    """The three K1 hashes, one line each, the preset -3 line first."""
    print(f"K1 preset -3 44.1k->48k chunk sha256 {k1_checksum(dev)}")
    print(f"K1 config 1 interpolated chunk sha256 {k1_checksum_interp(dev)}")
    print(f"K6 main-path call sha256 {k1_checksum_poly(dev)}")


def _noise_dev(dev, shape, seed, scale=0.5, dtype=torch.float32):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev,
                       dtype=dtype).mul_(scale)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _poly_inputs(dev, nb_pad=28672, M=147, qn=4, L=160):
    """K6's arguments at the main path's shapes: 2 channels, M=147, qn=4,
    L=160, nb_pad = 56 x 512 (near a 2^22-frame chunk's 28,533 blocks);
    data over the first nb_pad*M + qn*M samples, then JAX's zero tile; a
    dense random P (K6 takes any matrix)."""
    rng = np.random.default_rng(99)
    win = torch.zeros((2, (nb_pad + 512) * M), device=dev)
    win[:, :nb_pad * M + qn * M] = torch.from_numpy(rng.normal(
        0, 0.5, (2, nb_pad * M + qn * M)).astype(np.float32)).to(dev)
    P = torch.from_numpy(rng.normal(0, 0.05, (qn * M, L))
                         .astype(np.float32)).to(dev)
    return win, P, dict(M=M, qn=qn, L=L)


def phase_polyphase(dev, calls=4):
    """K6 against its float64 plain version, then its entry point called
    ``calls`` times (no engine path runs it).  Returns (launches, max
    error)."""
    win, P, kw = _poly_inputs(dev)
    out = k1.polyphase_apply(win, P, **kw)
    ref = k1.polyphase_apply_reference(win.double(), P.double(), **kw)
    err = float((out.double() - ref).abs().max())
    print(f"  polyphase_apply win {tuple(win.shape)} P {tuple(P.shape)} -> "
          f"out {tuple(out.shape)}: {_hull(P, kw['L'], False)}; "
          f"max|K6 - f64 plain| = {err:.3e}")
    _require(bool(torch.isfinite(out).all()) and err <= 1e-5,
             "K6 vs plain")
    _reset_launches()
    for _ in range(calls):
        out = k1.polyphase_apply(win, P, **kw)
    _sync(dev)
    launches = k1.polyphase_launches
    print(f"  polyphase_apply entry point: {calls} calls, {launches} K6 "
          f"launches, {k1.launches} K1 chunk-step launches")
    _require(dev.type != "cuda" or (launches == calls and k1.launches == 0),
             "K6 launches != calls")
    return launches, err


def phase_interp_path(dev, n_target=1 << 22, G=16):
    """BASELINE config 1 through every form: the first chunk by
    process(), then a group of G M-multiple chunks each through
    process_flat (stats), process_scan(stats=True) and process_flat_out;
    the last group replayed through a CPU engine of the port from the
    card engine's state.  Returns K1's launches on the path."""
    eng = DeviceStreamResampler(*INTERP, device=dev)
    eng.advance_position(INTERP[1] // 2)
    assert eng.interp
    n = roundtrip.m_multiple(n_target, eng.M)
    x0 = _noise_dev(dev, (1, n), 31)
    xs = _noise_dev(dev, (G, 1, n), 32)
    flat = torch.cat(list(xs), dim=1)
    zero = torch.zeros((), device=dev)
    _reset_launches()
    t0 = time.perf_counter()
    _, K0 = eng.process(x0, n)
    Ks1, acc = eng.process_flat(flat, n, zero)
    _, Ks2, acc = eng.process_scan(xs, n, acc, stats=True)
    state = eng.state_dict()
    out, Ks3 = eng.process_flat_out(flat, n)
    _sync(dev)
    secs = time.perf_counter() - t0
    launches = k1.launches
    want = 1 + G + G + 1
    K = Ks1[0]
    print(f"  config 1 (mono, 48 taps, L/M {eng.L}/{eng.M}, qn {eng.qn}): "
          f"first chunk {n} frames -> {K0}; then process_flat, "
          f"process_scan(stats) and process_flat_out over {G} x {n} frames "
          f"-> {K} each, in {secs:.2f} s wall; K1 launches {launches} "
          f"(design: {want})")
    _require(all(k == K for k in (*Ks1, *Ks2, *Ks3)) and K == n * eng.L
             // eng.M, "config 1 group counts")
    _require(bool(torch.isfinite(acc)) and bool(torch.isfinite(out).all())
             and tuple(out.shape) == (1, G * K), "config 1 outputs")
    _require(dev.type != "cuda" or launches == want,
             "config 1 K1 launches != design")
    cpu = DeviceStreamResampler(*INTERP, device="cpu")
    cpu.load_state(state)
    out_c, Ks_c = cpu.process_flat_out(flat.cpu(), n)
    err = float((out.cpu() - out_c).abs().max())
    print(f"  CPU replay of the process_flat_out group: counts equal "
          f"{list(Ks_c) == list(Ks3)}, positions {cpu.get_position()} / "
          f"{eng.get_position()}, max sample diff {err:.3e}")
    _require(list(Ks_c) == list(Ks3)
             and cpu.get_position() == eng.get_position() and err <= 1e-5,
             "config 1 CPU replay")
    return launches


def _host_quantize(x, scaler, hi, lo):
    """The reference's double rounding on the host: code = fl32(x *
    fl32(scaler)) for float32 samples, x * scaler for float64 ones, then
    floor(float64(code) + 0.5), clip; and the clip count."""
    if x.dtype == np.float64:
        code = x * np.float64(scaler)
    else:
        code = (x.astype(np.float64) * np.float64(np.float32(scaler))) \
            .astype(np.float32).astype(np.float64)
    # floor(code + 0.5) with the sum taken exactly (JAX's rule for float64
    # codes, equal to it for float32 ones)
    f = np.floor(code)
    ov = f + (code - f >= 0.5)
    return np.clip(ov, lo, hi).astype(np.int64), int(((ov > hi)
                                                      | (ov < lo)).sum())


def phase_group_forms(dev, n_target=1 << 22, G=8, ctor=HEAD, **opts):
    """The group forms against sequential process() on the card, by
    default the headline's (preset -3, 2 ch, G=8 chunks of 4,194,351
    frames, as bench.py:386-421 sets them up); ``opts`` (dtype, precise)
    pick the tier.  Returns K1's launches over the six engines' runs."""
    engs = []
    for _ in range(6):
        eng = DeviceStreamResampler(*ctor, device=dev, **opts)
        eng.advance_position(ctor[1] // 2)
        engs.append(eng)
    ch, tdt = ctor[0], engs[0].hist.dtype
    inst = k1.instance(tdt, bool(opts.get("precise")))
    n = roundtrip.m_multiple(n_target, engs[0].M)
    first = _noise_dev(dev, (ch, n), 41, dtype=tdt)
    xs = _noise_dev(dev, (G, ch, n), 42, dtype=tdt)
    flat = torch.cat(list(xs), dim=1)
    for e in engs:
        e.prewarm()
        e.process(first, n)
    a, b, c, d, e, f = engs
    counts = {}

    def run(name, fn):
        _reset_launches()
        r = fn()
        _sync(dev)
        counts[name] = k1.launches
        _require(dev.type != "cuda"
                 or k1.instance_launches[inst] == k1.launches,
                 f"{name} launched another K1 instance than {inst}")
        # the packed form's epilogue is one decimate_flat launch
        want_dec = int("packed" in name)
        _require(dev.type != "cuda"
                 or dd.launches == {"decimate_flat": want_dec,
                                    "decimate_shaped": 0},
                 f"{name}: decimate launches {dd.launches}")
        _add_dec_launches()
        return r

    def sequential():
        acc, valid, Ks = torch.zeros((), dtype=tdt, device=dev), [], []
        for x in xs:
            o, K, acc = a.process(x, n, acc)
            valid.append(o[:, :K])
            Ks.append(K)
        return torch.cat(valid, dim=1), Ks, acc

    valid, Ks, acc_a = run("process() x G", sequential)
    Ks_b, acc_b = run("process_flat", lambda: b.process_flat(
        flat, n, torch.zeros((), dtype=tdt, device=dev)))
    out_c, Ks_c = run("process_flat_out", lambda: c.process_flat_out(
        flat, n))
    outs_f, Ks_f, acc_f = run("process_scan", lambda: f.process_scan(
        xs, n, torch.zeros((), dtype=tdt, device=dev)))
    zi = torch.zeros((), dtype=torch.int32, device=dev)
    packed = {}
    for eng, scaler in ((d, 32768.0), (e, 32768.0 * 1.37)):
        packed[scaler] = run(f"process_flat_packed scaler {scaler:g}",
                             lambda: eng.process_flat_packed(
                                 flat, n, zi, scaler=scaler,
                                 highclip=32767, lowclip=-32768))
    ok_flat = (list(Ks_b) == Ks and torch.equal(acc_b, acc_a)
               and torch.equal(b.hist, a.hist)
               and b.get_position() == a.get_position())
    ok_out = (list(Ks_c) == Ks and torch.equal(out_c, valid)
              and torch.equal(c.hist, a.hist))
    ok_scan = (list(Ks_f) == Ks and torch.equal(acc_f, acc_a)
               and torch.equal(f.hist, a.hist)
               and torch.equal(torch.cat([o[:, :K] for o, K in zip(outs_f,
                                                                   Ks)], 1),
                               valid))
    print(f"  {inst}, {ch} ch x {n} frames: sequential Ks {Ks[0]} x {G}, acc "
          f"{float(acc_a):.6e}; process_flat bitwise (hist, acc, Ks, "
          f"position) {ok_flat}; process_flat_out bitwise {ok_out}; "
          f"process_scan bitwise (outs, hist, acc) {ok_scan}")
    _require(ok_flat and ok_out and ok_scan,
             "group forms vs sequential process()")
    x = out_c.cpu().numpy()
    for scaler, (pk, Ks_p, clips) in packed.items():
        ov, nclip = _host_quantize(x, scaler, 32767, -32768)
        same = np.array_equal(pk.cpu().numpy().view(np.uint8),
                              ov.astype("<i2").view(np.uint8))
        print(f"  process_flat_packed scaler {scaler:g} (decimate_flat "
              f"kernel): {pk.dtype} {tuple(pk.shape)}, bytes equal to the "
              f"host quantization {same}, clips {int(clips)} (host "
              f"{nclip})")
        _require(same and int(clips) == nclip > 0 and list(Ks_p) == Ks,
                 f"packed scaler {scaler:g}")
    # one launch per chunk where the power is summed chunk by chunk, one
    # per group where the group's blocks are one launch
    want = {k: G if k in ("process() x G", "process_flat", "process_scan")
            else 1 for k in counts}
    print(f"  K1 launches: {counts} (design: {want})")
    _require(dev.type != "cuda" or counts == want,
             "group-form K1 launches != design")
    return sum(counts.values())


def _plan_group_us(eng, flat, n):
    """Host time of one group's consume/emit (and pattern) plan, in us,
    whether process_flat would take the group or refuse it; the engine's
    state is put back."""
    state = (eng.output_offset, eng.input_index)
    t0 = time.perf_counter()
    try:
        eng._flat_plan(flat, n)
    except ValueError:
        pass
    dt = time.perf_counter() - t0
    eng.output_offset, eng.input_index = state
    return dt * 1e6


def _group_rate(dev, tag, label, ctor, n_target, G, form, groups=1,
                aggregate_rows=False, windows=3, **opts):
    """Output frames/s of a group form as bench._bench_device_fixed
    measures it: the first chunk absorbed by process(), then ``groups``
    groups of G chunks per window ending in one sync, median of
    ``windows``.  ``aggregate_rows``: the rows are independent mono
    streams, so frames count once per row.  A stats group that
    process_flat refuses (an interpolated pattern whose float64 drift
    since its last fresh build passed PATTERN_TOL inside the group) runs
    through process_scan(stats=True), as bench.py's mode fallback does;
    such groups are counted and printed.  ``opts`` (dtype, precise) pick
    the tier."""
    eng = DeviceStreamResampler(*ctor, device=dev, **opts)
    eng.advance_position(ctor[1] // 2)
    eng.prewarm()
    n = roundtrip.m_multiple(n_target, eng.M)
    ch = ctor[0]
    flat = _noise_dev(dev, (ch, G * n), 51, 0.25, dtype=eng.hist.dtype)
    xs = flat.view(ch, G, n).transpose(0, 1)
    eng.process(flat[:, :n], n)
    zi = torch.zeros((), dtype=torch.int32, device=dev)
    scanned = [0]

    def run():
        produced, clips, out = 0, zi, None
        acc = torch.zeros((), dtype=eng.hist.dtype, device=dev)
        for _ in range(groups):
            if form == "stats":
                try:
                    Ks, acc = eng.process_flat(flat, n, acc)
                except ValueError:
                    _, Ks, acc = eng.process_scan(xs, n, acc, stats=True)
                    scanned[0] += 1
            elif form == "delivered":
                out, Ks = eng.process_flat_out(flat, n)
            else:
                _, Ks, clips = eng.process_flat_packed(
                    flat, n, clips, scaler=32768.0, highclip=32767,
                    lowclip=-32768)
            produced += int(Ks.sum())
        if form == "stats":
            float(acc)
        elif form == "delivered":
            float(out[0, -1])
        else:
            int(clips)
        return produced * (ch if aggregate_rows else 1)

    run()
    rates = []
    for w in range(windows):
        t0 = time.perf_counter()
        produced = run()
        dt = time.perf_counter() - t0
        rates.append(produced / dt / 1e6)
        print(f"  {label} window {w}: {groups} x {G} chunks x {ch} x {n} "
              f"frames -> {produced} output frames in {dt * 1e3:.3f} ms = "
              f"{rates[-1]:.2f} M output frames/s {tag}")
    plan = _plan_group_us(eng, flat, n)
    med = sorted(rates)[len(rates) // 2]
    print(f"  {label}: median {med:.2f} M output frames/s; host group plan "
          f"{plan:.1f} us per group of {G}; groups through process_scan "
          f"{scanned[0]} of {groups * (windows + 1)} {tag}")
    return med, plan


def phase_group_throughput(dev, tag):
    """Config 1, config 1b and the headline stats, delivered and int16
    packed forms.  Returns {label: (median M frames/s, plan us)}."""
    res = {}
    res["config 1 stats"] = _group_rate(
        dev, tag, "config 1 process_flat", INTERP, 1 << 22, 16, "stats")
    res["config 1b stats"] = _group_rate(
        dev, tag, "config 1b (64 mono rows) process_flat",
        (64, *INTERP[1:]), 1 << 21, 16, "stats", aggregate_rows=True)
    head = (2, 380, 380, 44100, 48000, 0, FLAGS)
    for form, api in (("stats", "process_flat"),
                      ("delivered", "process_flat_out"),
                      ("packed", "process_flat_packed int16")):
        res[f"preset -3 {form}"] = _group_rate(
            dev, tag, f"preset -3 {api}", head, 1 << 22, 8, form, groups=2)
    return res


def phase_interp_timing(dev, tag, reps=20):
    """K1 (kernel only) on BASELINE config 1's steady interpolated chunk
    against its plain version, in turns, with its bound.  Returns the
    medians and the bound."""
    eng, n, K, start, P2, fracv, kw = _steady_chunk(INTERP, dev, 1 << 22)
    buf = _noise_dev(dev, (1, eng.num_samples + n), 61)
    M, L, nb, qn = kw["M"], kw["L"], kw["nb"], kw["qn"]
    med = _time_in_turns(dev, {
        "config 1 plain": lambda: window_dots(
            window_at(buf, start, (nb - 1) * M + qn * M), P2, K, M=M, L=L,
            nb=nb, qn=qn, fracv=fracv),
        "config 1 K1 kernel only": lambda: k1.fixed_step_kernel(
            buf, P2, start, K, M=M, L=L, nb=nb, qn=qn, fracv=fracv)},
        ["config 1 plain", "config 1 K1 kernel only",
         "config 1 K1 kernel only", "config 1 plain"], reps,
        f"per {n}-frame interpolated chunk", tag)
    # each output needs its taps from both banks and a lerp
    med["bound"] = _bound_ms(
        4 * (buf.numel() + P2.numel() + L + nb * L), 2 * K * (2 * eng.num_taps
                                                             + 2), PEAK_F32)
    print(f"  config 1 K1 bound {med['bound'][0]:.4f} ms "
          f"({med['bound'][1]}-bound)")
    return med


def phase_polyphase_timing(dev, tag, reps=10):
    """K6 against its plain version and one conv1d (the library
    yardstick), with its bound.  Returns the medians and the bound."""
    win, P, kw = _poly_inputs(dev)
    M, qn, L = kw["M"], kw["qn"], kw["L"]
    nb_pad = win.shape[1] // M - 512
    xw = win[:, None, :(nb_pad - 1) * M + qn * M].contiguous()
    weight = P.T[:, None, :].contiguous()

    def conv():
        return torch.nn.functional.conv1d(xw, weight, stride=M)

    ref = k1.polyphase_apply_reference(win, P, **kw)
    conv_err = float((conv().transpose(1, 2) - ref).abs().max())
    print(f"  conv1d yardstick vs K6 plain: max abs diff {conv_err:.3e}")
    _require(conv_err <= 1e-5, "conv1d yardstick computes another function")
    med = _time_in_turns(dev, {
        "K6 plain": lambda: k1.polyphase_apply_reference(win, P, **kw),
        "K6 kernel": lambda: k1.polyphase_apply(win, P, **kw),
        "conv1d library": conv},
        ["K6 plain", "K6 kernel", "conv1d library", "conv1d library",
         "K6 kernel", "K6 plain"], reps, f"per call (nb_pad {nb_pad})", tag)
    ch = win.shape[0]
    # P is dense: every output needs all qn*M terms
    med["bound"] = _bound_ms(4 * (win.numel() + P.numel() + ch * nb_pad * L),
                             2 * ch * nb_pad * L * qn * M, PEAK_F32)
    print(f"  polyphase_apply bound {med['bound'][0]:.4f} ms "
          f"({med['bound'][1]}-bound)")
    return med


# ------------------------------------------------------- precision tiers
def _ulps(out, ref):
    """The largest |out - ref| in float32 ulps of ref (ref float32), and
    how many samples differ at all."""
    up = torch.nextafter(ref.abs(), torch.tensor(float("inf"),
                                                 device=ref.device))
    ulp = (up - ref.abs()).double()
    d = (out.double() - ref.double()).abs()
    return float((d / ulp).max()), int((out != ref).sum())


def _tier_chunks(dev, n_target):
    """(label, ctor, n_target, instances) of the tier cases at full width:
    the preset -3 chunk and config 1's interpolated chunk on the
    precise instance, config 4's float64 chunk, and the column-piece
    shapes (M=2560) on the two new instances (phase 3 runs them on the
    float32 one)."""
    cases = [("preset -3 44.1k->48k", HEAD, n_target, ("f32_acc64",)),
             ("config 1 interpolated", INTERP, n_target, ("f32_acc64",)),
             ("config 4 (5.1 ch, 48k->44.1k)", CONFIG4, 1 << 19, ("f64",))]
    for taps, src, dst in _LARGE_M[2:]:
        cases.append((f"preset {-1 if taps == 48 else -3} {src / 1000:g}k->"
                      f"{dst / 1000:g}k", (2, taps, taps, src, dst, 0, FLAGS),
                      n_target, ("f32_acc64", "f64")))
    return cases


def phase_tier_kernels(dev, n_target=1 << 22):
    """Each K1 instance of the precision tiers against its float64 plain
    version at full width: the precise instance within 1 float32 ulp of
    the float64 dots rounded once (the count of samples that differ
    printed; 0 expected), the float64 one within 1e-12, float32 within
    1e-5; a zero tail past K and the new history bitwise.  Returns the
    largest error of each instance against its plain version."""
    rng = np.random.default_rng(6060)
    worst = {"f32": 0.0, "f32_acc64": 0.0, "f64": 0.0}
    for label, ctor, n_t, insts in _tier_chunks(dev, n_target):
        for inst in insts:
            dt = np.float64 if inst == "f64" else np.float32
            precise = inst == "f32_acc64"
            eng, n, K, start, P, fracv, kw = _steady_chunk(
                ctor, dev, n_t, dtype=dt, precise=precise)
            ch = ctor[0]
            hist, x = (torch.from_numpy(rng.normal(0, 0.5, shape).astype(dt))
                       .to(dev) for shape in ((ch, eng.num_samples),
                                              (ch, n)))
            acc = torch.zeros((), dtype=hist.dtype, device=dev)
            tile = k1.kernel_tile(kw["M"], kw["qn"], fracv is not None,
                                  dtype=hist.dtype, precise=precise)
            h, out, _ = k1.fixed_step(hist, x, P, start, K, acc, fracv=fracv,
                                      precise=precise, **kw)
            hp, ref, _ = k1.fixed_step_reference(
                hist, x, P, start, K, acc, fracv=fracv, precise=precise, **kw)
            _, o64, _ = k1.fixed_step_reference(
                _f64(hist), _f64(x), _f64(P), start, K, acc.double(),
                fracv=_f64(fracv), **kw)
            err = float((out.double() - ref.double()).abs().max())
            err64 = float((out.double() - o64).abs().max())
            ok = (bool(torch.isfinite(out).all()) and not out[:, K:].any()
                  and torch.equal(h, hp))
            if inst == "f32_acc64":
                ulps, ndiff = _ulps(out, ref)
                note = (f"{ulps:.2f} ulp of the float64 dots rounded once, "
                        f"{ndiff} of {out.numel()} samples differ")
                ok &= ulps <= 1.0
            else:
                note = f"max|K1 - f64 plain| {err64:.3e}"
                ok &= err64 <= (1e-12 if inst == "f64" else 1e-5)
            print(f"  {inst} {label} M={kw['M']} qn={kw['qn']}"
                  f"{' interpolated' if fracv is not None else ''} K={K}: "
                  f"tile {tile[0]} blocks x P pieces of {tile[1]} rows, "
                  f"{tile[2]} B shared; {note}; max|K1 - its plain| "
                  f"{err:.3e}; tail zero and new_hist bitwise {ok}")
            _require(ok, f"K1 {inst} vs plain, {label}")
            worst[inst] = max(worst[inst], err)
    return worst


def phase_tier_paths(dev, seconds=60, n_targets=(1 << 22, 1 << 19)):
    """The tiers' engine paths on the card, the counts set to 0 before
    each and read after it: precise="int8" through bench.py's headline
    sequence (the first chunk by process(), then G=8 chunks of 4,194,351
    frames through process_flat_out, and every other group form, each
    bitwise equal to sequential process()); config 4's float64 data
    through process() and every group form, process_flat_packed's bytes
    equal to quantizing those samples on the host; the 60 s round trip in
    precise=True and precise="int8" against the plain path's readings.
    Returns ({instance: launches}, {tier: round-trip dB})."""
    launches = {"f32_acc64": 0, "f64": 0}
    launches["f32_acc64"] += phase_group_forms(dev, n_targets[0],
                                               precise="int8")
    launches["f64"] += phase_group_forms(dev, n_targets[1], ctor=CONFIG4,
                                         dtype=np.float64)
    db = {}
    for precise in (True, "int8"):
        n, db[precise] = phase_roundtrip(dev, seconds, precise=precise)
        launches["f32_acc64"] += n
    return launches, db


def phase_tier_timing(dev, tag, reps=10, n_targets=(1 << 22, 1 << 19)):
    """Each new instance beside the float32 instance at the same shape,
    with its plain version and one conv1d on float64 operands (the
    library yardstick), in turns: the precise instance on the preset -3
    chunk, the float64 one on config 4's chunk; then process_flat_out's
    rate in the int8 and the float64 tier.  Returns {instance: (ms,
    plain_ms, bound, library_ms)}."""
    result = {}
    for inst, ctor, n_target in (("f32_acc64", HEAD, n_targets[0]),
                                 ("f64", CONFIG4, n_targets[1])):
        dt = np.float64 if inst == "f64" else np.float32
        precise = inst == "f32_acc64"
        eng, n, K, start, P, fracv, kw = _steady_chunk(
            ctor, dev, n_target, dtype=dt, precise=precise)
        ch = ctor[0]
        tdt = eng.hist.dtype
        hist = _noise_dev(dev, (ch, eng.num_samples), 71, dtype=tdt)
        x = _noise_dev(dev, (ch, n), 72, dtype=tdt)
        zero = torch.zeros((), dtype=tdt, device=dev)
        KQ = kw["qn"] * kw["M"]
        win = window_and_hist(x, hist, start, (kw["nb"] - 1) * kw["M"] + KQ,
                              kw["hist_len"])[0][:, None, :].double() \
            .contiguous()
        weight = P.T[:, None, :].double().contiguous()

        def conv():
            return torch.nn.functional.conv1d(win, weight, stride=kw["M"])

        ref = k1.fixed_step_reference(hist, x, P, start, K, zero,
                                      precise=precise, **kw)[1]
        conv_out = conv().transpose(1, 2).reshape(ref.shape)[:, :K]
        conv_err = float((conv_out.to(tdt) - ref[:, :K]).abs().max())
        print(f"  conv1d float64 yardstick vs {inst} plain step: max abs "
              f"diff {conv_err:.3e}")
        _require(conv_err <= (1e-12 if inst == "f64" else 1e-6),
                 "conv1d yardstick computes another function")
        # the float32 instance on float32 data of the same shape
        h32, x32, P32 = hist.float(), x.float(), P.float()
        z32 = zero.float()
        buf = torch.cat([hist, x], dim=1)
        variants = {
            f"K1 step {inst}": lambda: k1.fixed_step(
                hist, x, P, start, K, zero, precise=precise, **kw),
            f"K1 step f32, same shape": lambda: k1.fixed_step(
                h32, x32, P32, start, K, z32, **kw),
            f"plain step {inst}": lambda: k1.fixed_step_reference(
                hist, x, P, start, K, zero, precise=precise, **kw),
            "conv1d float64 library": conv,
            f"K1 kernel only {inst}": lambda: k1.fixed_step_kernel(
                buf, P, start, K, M=kw["M"], L=kw["L"], nb=kw["nb"],
                qn=kw["qn"], precise=precise),
        }
        names = list(variants)
        order = [names[2], names[0], names[4], names[1], names[3], names[3],
                 names[1], names[4], names[0], names[2]]
        med = _time_in_turns(dev, variants, order, reps,
                             f"per {ch} x {n}-frame chunk", tag)
        w = 8 if inst == "f64" else 4
        # each output's num_taps FMAs, in float64, on the FP64 rate
        bound = _bound_ms(
            w * (2 * ch * eng.num_samples + ch * n + P.numel()
                 + ch * kw["nb"] * kw["L"]), 2 * ch * K * eng.num_taps,
            PEAK_F64)
        print(f"  K1 {inst} bound {bound[0]:.4f} ms ({bound[1]}-bound, "
              f"FP64 at {PEAK_F64 / 1e12:g} TFLOP/s)")
        result[inst] = (med.get(names[0]), med[names[2]], bound,
                        med.get(names[3]))
    _group_rate(dev, tag, "preset -3 precise='int8' process_flat_out", HEAD,
                n_targets[0], 8, "delivered", groups=2, precise="int8")
    _group_rate(dev, tag, "config 4 float64 process_flat_out", CONFIG4,
                n_targets[1], 8, "delivered", groups=2, dtype=np.float64)
    return result


# ------------------------------------------------------------------ ASRC
def _asrc_engine(dev, S=ASRC_S, dtype=np.float32, kernel="auto"):
    eng = BatchedASRC(S, ASRC_TAPS, ASRC_TAPS, dtype=dtype, kernel=kernel,
                      hankel_kb=256, device=dev)
    eng.advance_position(ASRC_TAPS // 2)
    return eng


def _drift(S, t):
    """bench.py's per-call ratios (bench.py:363-364)."""
    return 1.0 + 0.01 * np.sin(np.arange(S) * 0.1 + 0.031 * t)


def _asrc_cases(dev, n):
    """(label, engine, ratios, Ks, k_max, flush) at config 5's shapes, from
    engines whose ring was filled by one process() call."""
    engines = {}
    for S in (ASRC_S, 3):
        eng = _asrc_engine(dev, S)
        eng.process(torch.zeros((S, n), device=dev), _drift(S, 0))
        engines[S] = eng
    eng = engines[ASRC_S]
    cases = []
    for label, ratios in (("near-1 drift", _drift(ASRC_S, 1)),
                          ("ratios 0.5", np.full(ASRC_S, 0.5)),
                          ("ratios 0.2", np.full(ASRC_S, 0.2)),
                          ("ratios 2.0", np.full(ASRC_S, 2.0))):
        _, Ks, k_max, _ = eng._plan(n, ratios, None)
        cases.append((label, eng, ratios, Ks, k_max, False))
    label, _, ratios, Ks, k_max, _ = cases[0]
    mid = np.minimum(Ks, 20000 + 77 + np.arange(ASRC_S)).astype(np.int32)
    cases.append(("mid-tile Ks", eng, ratios, mid, k_max, False))
    zero = Ks.copy()
    zero[::3] = 0
    cases.append(("Ks = 0 rows", eng, ratios, zero, k_max, False))
    fr, _, Ks, k_max, _, _ = eng._plan_flush(_drift(ASRC_S, 2), None, None)
    cases.append(("flush", eng, fr, Ks, k_max, True))
    _, Ks, k_max, _ = engines[3]._plan(n, _drift(3, 1), None)
    cases.append(("S = 3", engines[3], _drift(3, 1), Ks, k_max, False))
    return cases


def _step_args(eng, hist, x, bank, ratios, Ks):
    dev = hist.device
    return (hist, x, bank, torch.from_numpy(eng.offsets).to(dev),
            torch.from_numpy(np.asarray(ratios, np.float64)).to(dev),
            torch.from_numpy(np.asarray(Ks, np.int32)).to(dev),
            eng.num_samples - eng.input_index)


def phase_asrc_kernels_vs_plain(dev, n=ASRC_N):
    """Returns the largest error of each ASRC kernel against the float64
    plain version over the cases."""
    rng = np.random.default_rng(2026)
    bank32 = torch.from_numpy(make_filter_bank(
        ASRC_TAPS, ASRC_TAPS, 1.0, True, np.float32)).to(dev)
    bank64 = torch.from_numpy(make_filter_bank(
        ASRC_TAPS, ASRC_TAPS, 1.0, True, np.float64)).to(dev)
    for dtype in (torch.float32, torch.float64):
        g = kasrc.step_geometry(ASRC_TAPS, ASRC_TAPS, dtype)
        print(f"  asrc_step {dtype} geometry: {g.pieces} pieces of "
              f"{g.piece_taps} taps, {ASRC_TAPS + 1} rows of "
              f"{g.piece_taps + g.lane_span} entries each, "
              f"{g.outputs_per_block} outputs per block, {g.threads} "
              f"threads; shared memory: {g.bank_bytes} B of bank buffers, "
              f"a staged window of up to {g.window_capacity} values")
    worst = {"asrc_step": 0.0, "asrc_step_f64": 0.0, "asrc_apply": 0.0}
    for label, eng, ratios, Ks, k_max, flush in _asrc_cases(dev, n):
        S, H = eng.S, eng.num_samples
        x64 = torch.zeros((S, eng.num_taps // 2), dtype=torch.float64,
                          device=dev) if flush else torch.from_numpy(
            rng.normal(0, 0.5, (S, n))).to(dev)
        h64 = torch.from_numpy(rng.normal(0, 0.5, (S, H))).to(dev)
        h32, x32 = h64.float(), x64.float()
        geom = dict(num_taps=eng.num_taps, num_filters=eng.num_filters,
                    k_max=k_max, hist_len=H)
        line = [f"  {label}: out [{S}, {k_max}], valid {int(Ks.sum())}"]
        ok = True
        for dt, hist, x, bank in (("f32", h32, x32, bank32),
                                  ("f64", h64, x64, bank64)):
            args = _step_args(eng, hist, x, bank, ratios, Ks)
            nh, out = kasrc.asrc_step(*args, **geom)
            nh_p, out_p = kasrc.asrc_step_reference(*args, **geom)
            up = [a.double() if torch.is_tensor(a) and a.is_floating_point()
                  else a for a in args]
            _, ref = kasrc.asrc_step_reference(*up, **geom)
            err = float((out.double() - ref).abs().max())
            err_p = float((out_p.double() - ref).abs().max())
            tail0 = all(not bool(out[s, int(Ks[s]):].any()) for s in (
                0, S // 2, S - 1))
            hist_eq = bool(torch.equal(nh, nh_p))
            tol = 1e-5 if dt == "f32" else 1e-12
            name = "asrc_step" if dt == "f32" else "asrc_step_f64"
            worst[name] = max(worst[name], err)
            ok &= (bool(torch.isfinite(out).all()) and err <= tol and tail0
                   and hist_eq)
            line.append(f"{dt} max|kernel - f64 plain| {err:.3e} (plain "
                        f"{dt}: {err_p:.3e}), tail zero {tail0}, new_hist "
                        f"bitwise {hist_eq}")
        if label not in ("mid-tile Ks", "Ks = 0 rows"):
            buf, base, fi, frac, _ = kasrc.apply_prologue(
                h32, x32, *_step_args(eng, h32, x32, bank32, ratios,
                                      Ks)[3:5], eng.num_samples -
                eng.input_index, **geom)
            out = kasrc.asrc_apply(buf, bank32, base, fi, frac)
            ref = kasrc.asrc_apply_reference(buf.double(), bank32.double(),
                                             base, fi, frac.double())
            err = float((out.double() - ref).abs().max())
            worst["asrc_apply"] = max(worst["asrc_apply"], err)
            ok &= bool(torch.isfinite(out).all()) and err <= 1e-5
            line.append(f"apply max|kernel - f64 plain| {err:.3e}")
        print("; ".join(line))
        _require(ok, f"ASRC kernels vs plain, {label}")
    return worst


def _reset_launches():
    k1.launches = 0
    k1.polyphase_launches = 0
    for name in k1.instance_launches:
        k1.instance_launches[name] = 0
    for name in kasrc.launches:
        kasrc.launches[name] = 0
    for name in dd.launches:
        dd.launches[name] = 0
    if bk is not None:
        bk.launches["biquad"] = 0
        if hasattr(bk, "host_calls"):
            bk.host_calls["biquad"] = 0


# the decimate kernels' launches on the main paths (process_flat_packed's
# epilogue, DeviceDecimator, pipeline_chunk, the art command), each read
# right after its path ran with the counts set to 0 before it
DEC_PATH_LAUNCHES = {"decimate_flat": 0, "decimate_shaped": 0}


def _add_dec_launches():
    for name, n in dd.launches.items():
        DEC_PATH_LAUNCHES[name] += n


def phase_asrc_path(dev, dtype, kernel, calls, n=ASRC_N, S=ASRC_S,
                    replay=8):
    """One ASRC path: process() calls with the drifting ratios, then
    staggered flush(mask) calls, with ``replay`` streams replayed through a
    CPU engine of the port.  Returns (launches of its kernel, the worst
    sample difference against the replay)."""
    name = {"pallas": "asrc_apply"}.get(
        kernel, "asrc_step_f64" if dtype == np.float64 else "asrc_step")
    tol = 1e-12 if dtype == np.float64 else 1e-5
    eng = _asrc_engine(dev, S, dtype, kernel)
    cpu = _asrc_engine("cpu", replay, dtype, kernel)
    rows = np.linspace(0, S - 1, replay).astype(np.int64)
    gen = torch.Generator(device=dev).manual_seed(5)
    tdtype = eng.hist.dtype
    worst, produced, dispatch = 0.0, 0, 0

    def compare(res, res_cpu, what):
        nonlocal worst
        (out, Ks), (oc, Kc) = res, res_cpu
        _require(np.array_equal(Ks[rows], Kc), f"{what}: counts differ")
        _require(np.array_equal(eng.get_position()[rows],
                                cpu.get_position()), f"{what}: positions "
                 "differ")
        kmx = int(Kc.max(initial=0))
        og = out[torch.from_numpy(rows).to(dev), :kmx].cpu()
        err = float((og - oc[:, :kmx]).abs().max()) if kmx else 0.0
        _require(bool(torch.isfinite(out).all()) and err <= tol,
                 f"{what}: samples differ by {err:.3e} (bound {tol:g})")
        worst = max(worst, err)

    _reset_launches()
    t0 = time.perf_counter()
    for t in range(calls):
        x = torch.randn((S, n), generator=gen, device=dev, dtype=tdtype)
        x.mul_(0.5)
        ratios = _drift(S, t)
        res = eng.process(x, ratios)
        dispatch += 1
        produced += int(res[1].sum())
        compare(res, cpu.process(x[torch.from_numpy(rows).to(dev)].cpu(),
                                 ratios[rows]), f"process call {t}")
    for j in range(4):      # staggered: a quarter of the streams at a time
        mask = np.arange(S) % 4 == j
        fr = _drift(S, calls + j)
        res = eng.flush(fr, mask)
        dispatch += int(res[1].max() > 0)
        compare(res, cpu.flush(fr[rows], mask[rows]), f"flush {j}")
        if j < 3:           # the live streams keep serving
            x = torch.randn((S, n), generator=gen, device=dev,
                            dtype=tdtype).mul_(0.5)
            res = eng.process(x, fr)
            dispatch += 1
            compare(res, cpu.process(
                x[torch.from_numpy(rows).to(dev)].cpu(), fr[rows]),
                f"process after flush {j}")
    res = eng.flush(np.ones(S))             # all latched: nothing to emit
    _require(not res[1].any() and not bool(res[0].any()),
             "flush of latched streams emitted")
    if dev.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = kasrc.launches[name]
    print(f"  {np.dtype(dtype).name} kernel={kernel!r}: {calls} process() "
          f"calls + 4 staggered flushes ({dispatch} dispatching calls) over "
          f"{S} streams x {n} frames -> {produced} outputs in {secs:.2f} s "
          f"wall incl. the CPU replay; {name} launches {launches}; "
          f"{replay} replayed streams: counts and positions equal, max "
          f"sample diff {worst:.3e}")
    _require(dev.type != "cuda" or launches == dispatch > 0,
             f"{name} launches != dispatching calls")
    return launches, worst


def phase_asrc_throughput(dev, tag, n=ASRC_N, S=ASRC_S, windows=3, reps=10):
    """config 5's bench.py loop, host planning, and the ASRC step and apply
    against their plain versions.  Returns {kernel: (ms, plain_ms,
    (bound_ms, bound_by))}."""
    rng = np.random.default_rng(0)
    xs = torch.from_numpy(rng.standard_normal((S, n)).astype(np.float32)) \
        .to(dev)
    tick = [0]
    engines = {}
    for kernel in ("auto", "pallas"):   # the step, then the apply
        eng = engines[kernel] = _asrc_engine(dev, S, kernel=kernel)

        def run5():             # bench.py:359-368
            tot = 0
            for _ in range(3):
                tick[0] += 1
                out, Ks = eng.process(xs, _drift(S, tick[0]))
                tot += int(Ks.sum())
            float(torch.sum(out))
            return tot

        run5()
        for window in range(windows):
            t0 = time.perf_counter()
            produced = run5()
            dt = time.perf_counter() - t0
            print(f"  config 5 kernel={kernel!r} window {window}: 3 process() "
                  f"calls x {S} streams x {n} frames -> {produced} outputs "
                  f"in {dt * 1e3:.3f} ms = {produced / dt / 1e6:.2f} M "
                  f"outputs/s {tag}")
    eng = engines["auto"]
    t0 = time.perf_counter()
    for _ in range(20):
        eng._plan(n, _drift(S, tick[0]), None)
    print(f"  host count plan: {(time.perf_counter() - t0) / 20 * 1e6:.1f} "
          f"us per call (float64 accounting on the host CPU)")

    result = {}
    for dtype in (np.float32, np.float64):
        if dtype == np.float64:
            eng = _asrc_engine(dev, S, dtype)
            eng.process(xs.double(), _drift(S, 0))
        ratios, Ks, k_max, _ = eng._plan(n, _drift(S, tick[0] + 1), None)
        x = xs.to(eng.hist.dtype)
        args = _step_args(eng, eng.hist, x, eng._bank_dev, ratios, Ks)
        geom = dict(num_taps=eng.num_taps, num_filters=eng.num_filters,
                    k_max=k_max)
        label = "f32" if dtype == np.float32 else "f64"
        variants = {
            "plain step": lambda: kasrc.asrc_step_reference(
                *args, hist_len=eng.num_samples, **geom),
            "kernel step": lambda: kasrc.asrc_step(
                *args, hist_len=eng.num_samples, **geom),
            "kernel only": lambda: kasrc.asrc_step_kernel(*args, **geom),
        }
        order = ["plain step", "kernel step", "kernel only", "kernel only",
                 "kernel step", "plain step"]
        med = _time_in_turns(dev, variants, order, reps,
                             f"per call ({label})", tag)
        w = np.dtype(dtype).itemsize
        bound = _bound_ms(
            w * (2 * S * eng.num_samples + S * n + eng.bank.size
                 + S * k_max) + 20 * S,
            4 * int(Ks.sum()) * eng.num_taps,
            PEAK_F32 if dtype == np.float32 else PEAK_F64)
        print(f"  asrc_step {label} bound {bound[0]:.4f} ms "
              f"({bound[1]}-bound; {int(Ks.sum())} valid outputs)")
        result["asrc_step" if dtype == np.float32 else "asrc_step_f64"] = (
            med.get("kernel step"), med["plain step"], bound)
        if dtype == np.float32:
            buf, base, fi, frac, _ = kasrc.apply_prologue(
                eng.hist, x, args[3], args[4], args[6],
                hist_len=eng.num_samples, **geom)
            bank = eng._bank_dev
            med = _time_in_turns(dev, {
                "plain apply": lambda: kasrc.asrc_apply_reference(
                    buf, bank, base, fi, frac),
                "apply kernel": lambda: kasrc.asrc_apply(
                    buf, bank, base, fi, frac)},
                ["plain apply", "apply kernel", "apply kernel",
                 "plain apply"], reps, "per call (f32)", tag)
            bound_a = _bound_ms(
                4 * (buf.numel() + 4 * S * k_max + eng.bank.size),
                4 * S * k_max * eng.num_taps, PEAK_F32)
            print(f"  asrc_apply bound {bound_a[0]:.4f} ms ({bound_a[1]}-"
                  f"bound; {S * k_max} outputs, unmasked)")
            result["asrc_apply"] = (med.get("apply kernel"),
                                    med["plain apply"], bound_a)
    return result


# ------------------------------------------------------------------ CLIs
CLI_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_cli"
_STATS = re.compile(r"\(-w(\d)\): count =\s*(\d+), checksum = \w+, range = "
                    r"\S+ to \S+, RMS = (\S+) dB")


def _cli_wav(seconds):
    """A stereo 44.1k float32 WAV of artest noise with 4096-frame fades in
    build/: (path, frames)."""
    from art_tpu_torch.io import wavfile
    CLI_DIR.mkdir(parents=True, exist_ok=True)
    x = np.ascontiguousarray(roundtrip.artest_noise(seconds).T, "<f4")
    path = CLI_DIR / "in.wav"
    with open(path, "wb") as f:
        wavfile.write_wav_header(f, bits=32, num_channels=2,
                                 num_frames=x.shape[0], sample_rate=44100,
                                 channel_mask=3)
        f.write(x.tobytes())
    return path, x.shape[0]


def _wav_data(wav: bytes) -> bytes:
    i = wav.index(b"data")
    return wav[i + 8:i + 8 + int.from_bytes(wav[i + 4:i + 8], "little")]


def _wav_samples(path, dtype):
    from art_tpu_torch.io import wavfile
    with open(path, "rb") as f:
        info = wavfile.read_wav_header(f)
        n = info.num_frames * info.num_channels
        return np.frombuffer(f.read(n * np.dtype(dtype).itemsize), dtype)


def _run_cli(main, args, dev, backend):
    """One command through the CLI's main: (its stderr, wall seconds, K1's
    launches by instance, the ASRC kernels' launches, the decimate
    kernels' launches).  On the card the command takes its default device,
    as the command line does."""
    kw = {"device": dev} if backend in ("cuda", "torch") and \
        dev.type != "cuda" else {}
    _reset_launches()
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = main([*args, f"--backend={backend}"], **kw)
    _sync(dev)
    secs = time.perf_counter() - t0
    _require(rc == 0, f"{' '.join(args)} --backend={backend} exited {rc}: "
             f"{err.getvalue()}")
    return (err.getvalue(), secs, dict(k1.instance_launches),
            dict(kasrc.launches), dict(dd.launches))


def _timing(text):
    return next(line for line in text.splitlines()
                if line.startswith("timing:"))


def _rate_line(cmd, legs, tag):
    for be, (secs, frames) in legs.items():
        print(f"  {cmd} --backend={be}: {secs:.3f} s wall, {frames} output "
              f"frames, {frames / secs / 1e6:.4f} M frames/s {tag}")


def _device_busy_ms(dev, fn, calls):
    """Kernel time on the card during ``calls`` calls of ``fn``, from a
    torch.profiler trace (None where it records no device time)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        _sync(dev)
    us = sum(getattr(e, "self_device_time_total", 0)
             for e in prof.key_averages())
    return us / 1e3 if us else None


def _cli_block_breakdown(dev, tag, n, steady):
    """Where an art steady block's time goes on the card: the whole
    HybridStreamResampler block (plan, upload, K1 step, fetch) beside its
    parts at the same shape, and the card's busy share over the blocks."""
    from art_tpu_torch import HybridStreamResampler
    hyb = HybridStreamResampler(*HEAD, device=dev)
    hyb.advance_position(190)
    rng = np.random.default_rng(12)
    blk = rng.normal(0, 0.5, (n, 2)).astype(np.float32)
    cap = int((n + 190) * 48000 / 44100 + 100)
    hyb.process_interleaved(blk, n, cap)
    _require(hyb._on_device, "the Hybrid's steady block left the card")
    eng, n1, K, start, P, fracv, kw = _steady_chunk(HEAD, dev, n)
    x = torch.from_numpy(np.ascontiguousarray(blk[:n1].T)).to(dev)
    zero = torch.zeros((), device=dev)
    out = k1.fixed_step(eng.hist, x, P, start, K, zero, **kw)[1]
    host_blk = np.ascontiguousarray(blk.T)
    variants = {
        "Hybrid steady block": lambda: hyb.process_interleaved(blk, n, cap),
        "host plan": lambda: hyb.dev._plan_compute(n),
        "upload of the block": lambda: torch.as_tensor(host_blk,
                                                       device=dev),
        f"K1 step ({n1} frames)": lambda: k1.fixed_step(
            eng.hist, x, P, start, K, zero, **kw),
        "fetch of its output": lambda: out[:, :K].cpu(),
    }
    names = list(variants)
    order = names + names[::-1]
    med = _time_in_turns(dev, variants, order, 20,
                         f"per {n}-frame art block", tag)
    busy = _device_busy_ms(dev, variants[names[0]], 50) if dev.type == \
        "cuda" else None
    whole = med[names[0]]
    share = ("not measured" if busy is None else
             f"{busy / 50:.4f} ms of kernels per block, idle "
             f"{1 - busy / 50 / whole:.1%}")
    print(f"  art steady block on the card: {whole:.4f} ms, {steady} blocks "
          f"= {whole * steady / 1e3:.3f} s of the command; card busy (torch."
          f"profiler, 50 blocks): {share} {tag}")


def _cli_device_decimate(art, wav, dev, tag, steady, on_card):
    """The unshaped 16-bit outputs, which --backend=cuda quantizes on the
    card (DeviceDecimator, decimate_flat_kernel): ``art -3 -r48k -o16
    -n0`` beside numpy (frames and clip warnings equal, codes within the
    resample-then-decimate class of PERF.md section 2), and ``art -3 -o16
    -n0`` with no resampler (bytes identical: the decimator's input is
    the same)."""
    for extra in (["-r48k"], []):
        cmd = " ".join(["art -3", *extra, "-o16 -n0"])
        got, legs = {}, {}
        for be in ("cuda", "numpy"):
            out = CLI_DIR / f"art_dec_{be}.wav"
            err, secs, kl, al, dl = _run_cli(
                art.main, ["-q", "-y", "-3", *extra, "-o16", "-n0",
                           str(wav), str(out)], dev, be)
            got[be] = (_wav_data(out.read_bytes()), err)
            legs[be] = (secs, len(got[be][0]) // 4)
            if be == "cuda":
                # every block with output is one launch: the steady ones
                # on K1's output in place, the host's prefill, tail and
                # flush on their samples
                print(f"  {cmd}: decimate launches {dl}, K1 launches "
                      f"{kl}")
                _require(not on_card or (
                    dl["decimate_flat"] >= steady + 2
                    and dl["decimate_shaped"] == 0
                    and kl["f32"] == (steady if extra else 0)),
                    f"{cmd}: decimate or K1 launches off the design")
                for name, n in dl.items():
                    DEC_PATH_LAUNCHES[name] += n
        (a, ea), (b, eb) = got["cuda"], got["numpy"]
        _require(len(a) == len(b) and ea == eb,
                 f"{cmd}: output length or clip warnings differ")
        if extra:
            diff = np.abs(np.frombuffer(a, "<i2").astype(np.int32)
                          - np.frombuffer(b, "<i2").astype(np.int32))
            print(f"  {cmd}: {len(a)} bytes each, codes within "
                  f"{diff.max()} LSB (mean {diff.mean():.3e}); stderr "
                  f"{ea.strip() or '(none)'!r}")
            _require(diff.max() <= 12 and diff.mean() < 2.0,
                     f"{cmd}: 16-bit codes beyond the shaped-noise floor")
        else:
            print(f"  {cmd}: {len(a)} bytes each, identical {a == b}")
            _require(a == b, f"{cmd}: bytes differ from numpy's")
        _rate_line(cmd, legs, tag)


def phase_cli(dev, tag, seconds=60):
    """The art and artest command lines with --backend=cuda beside
    --backend=numpy.  Returns the CLIs' launches {kernel: count} in the
    names of the kernels line."""
    # imported here, so that --checksum still runs from older trees
    from art_tpu_torch import native
    from art_tpu_torch.cli import art, artest
    on_card = dev.type == "cuda"
    # the host runtime builds with g++ at first use: outside the timings
    t0 = time.perf_counter()
    built = native.available()
    print(f"  host runtime (art_tpu_torch/native): "
          f"{'loaded' if built else 'no g++: pure-Python paths'} in "
          f"{time.perf_counter() - t0:.2f} s")
    wav, n = _cli_wav(seconds)
    # art feeds BUFFER_SAMPLES-frame blocks: the first (the extrapolation
    # prefill) and the odd tail run on the host, the rest on the card
    steady = n // art.BUFFER_SAMPLES - 1
    total = {"fixed_step": 0, "fixed_step_f32_acc64": 0, "asrc_step": 0}
    for extra, dtype in (([], "<f4"), (["-o16"], "<i2")):
        cmd = " ".join(["art -3 -r48k", *extra])
        got, legs = {}, {}
        for be in ("cuda", "numpy"):
            out = CLI_DIR / f"art_{be}.wav"
            err, secs, kl, al, dl = _run_cli(
                art.main, ["-q", "-y", "-3", "-r48k", *extra, str(wav),
                           str(out)], dev, be)
            got[be] = (_wav_samples(out, dtype), err)
            legs[be] = (secs, got[be][0].size // 2)
            if be == "numpy" and not extra:     # phase 15's reference
                CLI_NUMPY[cmd] = (*got[be], secs)
            if be == "cuda":
                print(f"  {cmd}: K1 launches {kl}, steady blocks {steady}")
                _require(not on_card or (kl["f32"] == steady > 0
                                         and sum(kl.values()) == steady),
                         f"{cmd}: K1 launches != steady blocks")
                total["fixed_step"] += kl["f32"]
        (a, ea), (b, eb) = got["cuda"], got["numpy"]
        _require(a.size == b.size and ea == eb,
                 f"{cmd}: output frames or clip warnings differ")
        diff = np.abs(a.astype(np.float64) - b.astype(np.float64))
        print(f"  {cmd}: {a.size // 2} frames each, max abs diff "
              f"{diff.max():.3e}{' LSB' if extra else ''}, mean "
              f"{diff.mean():.3e}; stderr {ea.strip() or '(none)'!r}")
        if extra:
            _require(diff.max() <= 12 and diff.mean() < 2.0,
                     f"{cmd}: 16-bit codes beyond the shaped-noise floor")
        else:
            _require(diff.max() <= 1e-5, f"{cmd}: samples beyond 1e-5")
        _rate_line(cmd, legs, tag)
    _cli_block_breakdown(dev, tag, art.BUFFER_SAMPLES, steady)
    _cli_device_decimate(art, wav, dev, tag, steady, on_card)

    def stats(text):
        return {m.group(1): (int(m.group(2)), float(m.group(3)))
                for m in _STATS.finditer(text)}

    base = ["-s44.1k", "-d48k", "-c2", "-i", f"-n{seconds}", "--timing"]
    ref = {}
    for preset, extra in (("-3", ["-e"]), ("-3", ["-e", "--precise"]),
                          ("-1", [])):
        cmd = " ".join(["artest", preset, *base, *extra])
        legs = {}
        err, secs, kl, al, _ = _run_cli(
            artest.main, [preset, *base, *extra], dev, "cuda")
        got = stats(err)
        legs["cuda"] = (secs, got["2"][0])
        key = (preset, "-e" in extra)
        if key not in ref:
            nerr, nsecs = _run_cli(artest.main, [preset, *base, *extra[:1]],
                                   dev, "numpy")[:2]
            ref[key] = stats(nerr)
            legs["numpy"] = (nsecs, ref[key]["2"][0])
            CLI_NUMPY[("artest", *key)] = (ref[key], nerr, nsecs)
        want = ref[key]
        print(f"  {cmd}: -w5 {got['5'][1]:.2f} dB (numpy {want['5'][1]:.2f}"
              f" dB), counts {[got[w][0] for w in sorted(got)]}; K1 "
              f"launches {kl}, ASRC launches {al}")
        print(f"  {cmd} --backend=cuda {_timing(err)}")
        if "numpy" in legs:
            print(f"  {cmd} --backend=numpy {_timing(nerr)}")
        _require({w: c for w, (c, _) in got.items()}
                 == {w: c for w, (c, _) in want.items()},
                 f"{cmd}: -w counts differ from the numpy backend's")
        if "-e" in extra:
            _require(got["5"][1] <= -130.0, f"{cmd}: -w5 above -130 dB")
            inst = "f32_acc64" if "--precise" in extra else "f32"
            _require(not on_card or (kl[inst] > 0 and kl[inst]
                                     == sum(kl.values())),
                     f"{cmd}: K1's {inst} instance not launched alone")
            total["fixed_step" if inst == "f32"
                  else "fixed_step_f32_acc64"] += kl[inst]
        else:
            _require(abs(got["5"][1] - want["5"][1]) <= 0.5,
                     f"{cmd}: -w5 more than 0.5 dB from numpy's")
            _require(not on_card or (al["asrc_step"] > 0
                                     and sum(kl.values()) == 0),
                     f"{cmd}: the ASRC step was not launched")
            total["asrc_step"] += al["asrc_step"]
        _rate_line(cmd, legs, tag)
    return total


# ------------------------------------------------ phase 13: device decimate
HP, LP, FLAT = DITHER_HIGHPASS, DITHER_LOWPASS, DITHER_FLAT
ATH, SECOND = SHAPING_ATH_CURVE, SHAPING_2ND_ORDER


def _host_decimator(flags, bits=16, nbytes=None, dtype=np.float32):
    """The host decimator on its native runtime, 2 channels at 48k (the
    ATH curve of 48k)."""
    from art_tpu_torch import native
    from art_tpu_torch.engines.decimator import Decimator
    _require(native.available(), "the native host runtime did not build")
    return Decimator(2, bits, nbytes or (bits + 7) // 8, 1.0, 48000, flags,
                     dtype=dtype, backend="native")


def _dec_kw(host, dev, dither_type="host"):
    """decimate_flat/_shaped keywords from a host decimator's settings and
    state (``dither_type`` overrides its type)."""
    dithered = host.tpdf_generators is not None
    gens = host.tpdf_generators if dithered else np.zeros(2, np.uint32)
    kw = dict(scaler=float(host.scaler), highclip=host.highclip,
              lowclip=host.lowclip, output_bits=host.output_bits,
              output_bytes=host.output_bytes,
              gens=dd.states_tensor(gens, dev),
              dither_type=(host.dither_type if dither_type == "host"
                           else dither_type) if dithered else None)
    sh = host.noise_shaper
    if sh is not None:
        kw.update(a=sh.a, b=sh.b, xh=sh.xh, yh=sh.yh,
                  feedback=host.feedback)
    return kw


def _bitwise(a, b) -> bool:
    """Equal bit for bit (floats compared as their bits)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        ints = {torch.float32: torch.int32, torch.float64: torch.int64}
        a, b = a.contiguous().view(ints[a.dtype]), \
            b.contiguous().view(ints[b.dtype])
    return torch.equal(a, b)


def _vs_plain(kernel, plain, samples, K, kw):
    """One decimate kernel against its plain version on the same inputs:
    (every output bitwise, max |kernel - plain| over the packed bytes)."""
    got = kernel(samples, K, **kw)
    want = plain(samples, K, **kw)
    _sync(samples.device)
    same = all(_bitwise(g, w) for g, w in zip(got, want))
    pk = got[0].contiguous().view(torch.uint8).int()
    pw = want[0].contiguous().view(torch.uint8).int()
    return same, float((pk - pw).abs().max()) if pk.numel() else 0.0


# the flat kernel's cases at the 2^22 chunk: (label, host flags, bits,
# bytes, dither type ("host": the flags'), container layout, scaler or
# None for the host's)
DEC_FLAT_CASES = [
    ("HP 16", HP, 16, 2, "host", False, None),
    ("LP 16", LP, 16, 2, "host", False, None),
    ("flat 16 (type 0)", FLAT, 16, 2, "host", False, None),
    ("type 2 16", FLAT, 16, 2, 2, False, None),
    ("no dither 16", 0, 16, 2, "host", False, None),
    ("HP 8", HP, 8, 1, "host", False, None),
    ("HP 24", HP, 24, 3, "host", False, None),
    ("HP 24 in 4", HP, 24, 4, "host", False, None),
    ("container 16, pow2 scaler", 0, 16, 2, "host", True, None),
    ("container 16, scaler x1.37", 0, 16, 2, "host", True, 32768.0 * 1.37)]


def phase_decimate_kernels(dev, n_target=1 << 22, block=16384):
    """Both decimate kernels against their plain versions on the card,
    bitwise (packed bytes, clip count, new LCG and shaper state): the flat
    kernel at a 2^22-frame stereo chunk in K1's [ch, capacity] layout
    (bits 8, 16, 24 and 24 in 4 bytes; dither types -1, 1, 0 and 2, and
    none; the per-channel container with a power-of-two scaler and
    another) with a ragged K and NaN past it, and at the art command's
    steady block (K1's output of a 16,384-frame preset -3 block); the
    shaped kernel at that block (ATH and 2nd order, dithered and not, a
    float64 case), and at the 2^22 chunk against the native host
    decimator.  Returns {kernel: max |kernel - plain| over packed
    bytes}."""
    worst = {"decimate_flat": 0.0, "decimate_shaped": 0.0}
    n = n_target
    buf = _noise_dev(dev, (2, n), 71, 0.6)
    K = n - 777
    buf[:, K:] = float("nan")
    for label, flags, bits, nbytes, dither_type, planar, scaler in \
            DEC_FLAT_CASES:
        kw = _dec_kw(_host_decimator(flags, bits, nbytes), dev, dither_type)
        kw["planar"] = planar
        if scaler is not None:
            kw["scaler"] = scaler
        same, err = _vs_plain(dd.decimate_flat, dd.decimate_flat_reference,
                              buf.T, K, kw)
        print(f"  decimate_flat {label} ({n} frames), K = n - 777, NaN past "
              f"K: bitwise {same}, max|kernel - plain| {err:g}")
        _require(same, f"decimate_flat vs plain, {label}")
        worst["decimate_flat"] = max(worst["decimate_flat"], err)
    # the art command's steady block: K1's output, read in place
    eng, n1, Kb, start, P, fracv, kw1 = _steady_chunk(HEAD, dev, block)
    x = _noise_dev(dev, (2, n1), 72, 0.6)
    out = k1.fixed_step(eng.hist, x, P, start, Kb,
                        torch.zeros((), device=dev), **kw1)[1]
    cases = [("decimate_flat", "HP 16", HP, 16, torch.float32),
             ("decimate_flat", "HP 16 float64", HP, 16, torch.float64),
             ("decimate_shaped", "ATH HP 16", HP | ATH, 16, torch.float32),
             ("decimate_shaped", "2nd order flat dither 8", FLAT | SECOND,
              8, torch.float32),
             ("decimate_shaped", "ATH no dither 24", ATH, 24,
              torch.float32),
             ("decimate_shaped", "ATH HP 16 float64", HP | ATH, 16,
              torch.float64)]
    for name, label, flags, bits, tdt in cases:
        kernel = getattr(dd, name)
        plain = getattr(dd, f"{name}_reference")
        host = _host_decimator(flags, bits, dtype=np.float64
                               if tdt == torch.float64 else np.float32)
        for K_, tail in ((Kb, "zeros past K"), (Kb - 333, "NaN past K")):
            samples = out.to(tdt).T
            if tail.startswith("NaN"):
                samples = samples.clone()
                samples[K_:] = float("nan")
            same, err = _vs_plain(kernel, plain, samples, K_,
                                  _dec_kw(host, dev))
            print(f"  {name} {label}, art's steady block ({samples.shape[0]}"
                  f" rows, K = {K_}, {tail}): bitwise {same}, max|kernel - "
                  f"plain| {err:g}")
            _require(same, f"{name} vs plain, {label}")
            worst[name] = max(worst[name], err)
    # the shaped kernel at the 2^22 chunk against the native host
    host = _host_decimator(HP | ATH)
    kw = _dec_kw(_host_decimator(HP | ATH), dev)
    packed, clips, gens, fb, xh, yh = dd.decimate_shaped(buf.T, K, **kw)
    want, wclips = host.process_interleaved(buf[:, :K].T.cpu().numpy())
    got = packed.cpu().numpy()
    sh = host.noise_shaper
    same = (np.array_equal(got[:K], want) and not got[K:].any()
            and int(clips) == wclips
            and np.array_equal(dd.states_numpy(gens), host.tpdf_generators)
            and all(np.array_equal(t.cpu().numpy(), w)
                    for t, w in ((fb, host.feedback), (xh, sh.xh),
                                 (yh, sh.yh))))
    print(f"  decimate_shaped ATH HP 16 ({n} frames, K = n - 777, NaN past "
          f"K) against the native host decimator: bytes, clips ({wclips}) "
          f"and state bitwise {same}")
    _require(same, "decimate_shaped vs the native host at 2^22 frames")
    worst["decimate_shaped"] = max(worst["decimate_shaped"],
                                   _shaped_widths(dev, out.T, Kb))
    return worst


def _shaped_widths(dev, block, K):
    """The shaped kernel beyond stereo, bitwise against its plain version:
    S = 6 (one CTA) and S = 33 (two, the second chain warp with one lane)
    with K past the ring's last stage; then the art block cut into 3
    calls, whose bytes, clips and final state must equal one call's.
    Returns max |kernel - plain| over packed bytes."""
    worst = 0.0
    sh = _host_decimator(HP | ATH).noise_shaper
    for S, dtype in ((6, torch.float32), (33, torch.float64)):
        tile = dd.library_geometry(0, S, 0, dtype, 1)["shaped"]["tile"]
        n, Ks = 3 * tile + 500, 2 * tile + tile // 2 + 7
        x = _noise_dev(dev, (S, n), 90 + S, 0.6, dtype).T
        rng = np.random.default_rng(S)
        kw = dict(scaler=32768.0 * 1.07, highclip=32767, lowclip=-32768,
                  output_bits=16, output_bytes=2,
                  gens=dd.states_tensor(rng.integers(
                      0, 1 << 32, S, dtype=np.uint64).astype(np.uint32), dev),
                  dither_type=0, a=sh.a, b=sh.b,
                  xh=np.tile(sh.xh[:, :1], (1, S)) + 0.1,
                  yh=np.tile(sh.yh[:, :1], (1, S)) - 0.1,
                  feedback=rng.uniform(-0.3, 0.3, S))
        same, err = _vs_plain(dd.decimate_shaped, dd.decimate_shaped_reference,
                              x, Ks, kw)
        print(f"  decimate_shaped S = {S} {str(dtype)[6:]} ({n} frames, "
              f"tile {tile}, K = {Ks}): bitwise {same}, max|kernel - plain| "
              f"{err:g}")
        _require(same, f"decimate_shaped vs plain at S = {S}")
        worst = max(worst, err)
    kw = _dec_kw(_host_decimator(HP | ATH), dev)
    whole = dd.decimate_shaped(block, K, **kw)
    parts, clips = [], 0
    state = dict(gens=kw["gens"], feedback=kw["feedback"], xh=kw["xh"],
                 yh=kw["yh"])
    for lo, hi in ((0, 1000), (1000, 4500), (4500, K)):
        p, c, g, f, xh, yh = dd.decimate_shaped(block[lo:hi], hi - lo,
                                                **{**kw, **state})
        parts.append(p)
        clips += int(c)
        state = dict(gens=g, feedback=f, xh=xh, yh=yh)
    _sync(dev)
    same = (_bitwise(torch.cat(parts), whole[0][:K]) and clips == int(whole[1])
            and all(_bitwise(a, b) for a, b in zip(
                (state["gens"], state["feedback"], state["xh"], state["yh"]),
                whole[2:])))
    print(f"  decimate_shaped on art's block in 3 calls (frames 0-1000, "
          f"1000-4500, 4500-{K}) against one call: bytes, clips and state "
          f"bitwise {same}")
    _require(same, "decimate_shaped: 3 calls differ from one")
    return worst


def phase_decimate_geometry(dev, n_target=1 << 22, block=16384):
    """Each decimate kernel's launch at the main path's shapes on this
    card's SMs (the flat kernel's CTAs and stride, the shaped kernel's
    CTAs, tile, stages, threads and shared memory; from
    decimate_geometry.h, the code the launches run), and their registers
    and spills from this process's build."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count \
        if dev.type == "cuda" else 132
    Kb = _steady_chunk(HEAD, dev, block)[2]
    shapes = [("2^22 stereo chunk", n_target, 2, n_target),
              ("art's block", Kb, 2, Kb), ("5.1 art block", Kb, 6, Kb),
              ("33 channels, n >> K", 100_000, 33, 1000)]
    for label, n, S, K in shapes:
        for dtype in (torch.float32, torch.float64):
            geo = dd.library_geometry(n, S, K, dtype, sms)
            fg, sg = geo["flat"], geo["shaped"]
            print(f"  {str(dtype)[6:]}, {label} ({n} x {S}, K {K}): "
                  f"decimate_flat {fg['ctas']} CTAs of {fg['threads']}, "
                  f"runs of {fg['run']} elements, stride "
                  f"{fg['frames'] or 'none'} frames ({sms} SMs); "
                  f"decimate_shaped {sg['groups']} + {sg['zero']} zero-tail "
                  f"CTAs of {sg['threads']}, tile {sg['tile']} frames, "
                  f"{sg['stages']} stages, {sg['smem']} B shared")
    regs, spills = _registers(_build.build_log), _spills(_build.build_log)
    print("  registers (spill store, load bytes): " + (", ".join(
        f"{k}: {regs[k]} ({spills.get(k)})" for k in sorted(regs)
        if "decimate" in k) or "not in this process's build log"))


def decimate_hashes(dev, n_target=1 << 22, block=16384):
    """sha256 of the flat kernel's packed 2^22-frame stereo chunk (16
    bits, HP dither, K1's layout) with its clips and LCG states, and of
    the shaped kernel's packed art block (ATH, HP, 16 bits) with its clips,
    LCG and shaper states: entry points every tree with the decimate stage
    has, so an older checkout prints its own (--decimate-times)."""
    buf = _noise_dev(dev, (2, n_target), 74, 0.6)
    flat = dd.decimate_flat(buf.T, n_target, **_dec_kw(
        _host_decimator(HP), dev))
    eng, n1, Kb, start, P, fracv, kw1 = _steady_chunk(HEAD, dev, block)
    out = k1.fixed_step(eng.hist, _noise_dev(dev, (2, n1), 76, 0.6), P,
                        start, Kb, torch.zeros((), device=dev), **kw1)[1]
    shaped = dd.decimate_shaped(out.T, Kb, **_dec_kw(
        _host_decimator(HP | ATH), dev))
    _sync(dev)

    def sha(ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().cpu().numpy().tobytes())
        return h.hexdigest()
    return {"decimate_flat 2^22 chunk": sha(flat),
            "decimate_shaped art block": sha(shaped)}


def phase_decimate_paths(dev, seconds=60, block=16384, n_target=1 << 22):
    """The decimate stage's main paths, the counts set to 0 before each
    and read after it: DeviceDecimator against the native host decimator
    over a 60 s stereo stream in 16,384-frame blocks (unshaped HP 16-bit,
    the art command's -n0 mode; ATH-shaped HP 16-bit; LP 24-bit), bytes,
    clips and final state bitwise; then pipeline_chunk at the preset -3
    shapes (one ~2^22-frame chunk, HP dither, flat and ATH-shaped): the
    history and power bitwise K1's, the bytes bitwise the flat plain
    version's on K1's output, or the native host's for the shaped one."""
    from art_tpu_torch.engines.decimator import DeviceDecimator
    from art_tpu_torch.parallel.pipeline import pipeline_chunk
    # artest's noise peaks at 0.5: at 2.1x some frames clip
    x = np.ascontiguousarray((roundtrip.artest_noise(seconds) * 2.1).T,
                             np.float32)
    for label, flags, bits in (("HP 16 (-n0)", HP, 16),
                               ("ATH HP 16", HP | ATH, 16),
                               ("LP 24", LP, 24)):
        host = _host_decimator(flags, bits)
        engine = DeviceDecimator(2, bits, (bits + 7) // 8, 1.0, 48000, flags,
                                 device=dev)
        _reset_launches()
        ok, clips, nblk = True, 0, 0
        for i in range(0, x.shape[0], block):
            blk = x[i:i + block]
            got, gc = engine.process_chunk(blk, blk.shape[0])
            want, wc = host.process_interleaved(blk)
            ok &= bool(np.array_equal(got, want) and gc == wc)
            clips += wc
            nblk += 1
        _sync(dev)
        st = engine.state_dict()
        ok &= bool(np.array_equal(st["gens"], host.tpdf_generators))
        ok &= bool(np.array_equal(st["feedback"], host.feedback))
        if host.noise_shaper is not None:
            ok &= bool(np.array_equal(st["xh"], host.noise_shaper.xh)
                       and np.array_equal(st["yh"], host.noise_shaper.yh))
        launches = dict(dd.launches)
        name = "decimate_shaped" if flags & ATH else "decimate_flat"
        print(f"  DeviceDecimator {label}: {nblk} blocks of {block} frames "
              f"({x.shape[0]} in all), bytes, clips ({clips}) and state "
              f"bitwise the native host's {ok}; launches {launches}")
        _require(ok and clips > 0,
                 f"DeviceDecimator {label} vs the native host")
        _require(dev.type != "cuda" or launches[name] == nblk == sum(
            launches.values()), f"DeviceDecimator {label}: launches")
        _add_dec_launches()
    eng, n, K, start, P, fracv, kw = _steady_chunk(HEAD, dev, n_target)
    xc = _noise_dev(dev, (2, n), 73, 0.6)
    hist = eng.hist
    zero = torch.zeros((), device=dev)
    ref_hist, ref_out, ref_pow = k1.fixed_step(hist, xc, P, start, K, zero,
                                               **kw)
    for label, flags in (("HP flat", HP), ("ATH HP", HP | ATH)):
        host = _host_decimator(flags)
        dkw = _dec_kw(host, dev)
        sh = host.noise_shaper
        _reset_launches()
        res = pipeline_chunk(
            xc, hist, P, start, K, dkw["gens"], host.feedback,
            np.zeros((4, 2), np.float32) if sh is None else sh.xh,
            np.zeros((4, 2), np.float32) if sh is None else sh.yh,
            M=kw["M"], L=kw["L"], nb=kw["nb"], qn_pad=kw["qn"],
            qn_local=kw["qn"], hist_len=kw["hist_len"],
            scaler=float(host.scaler), highclip=host.highclip,
            lowclip=host.lowclip, dither_type=host.dither_type,
            shaper_a=None if sh is None else sh.a,
            shaper_b=None if sh is None else sh.b, output_bits=16,
            output_bytes=2)
        _sync(dev)
        launches = (k1.launches, dict(dd.launches))
        _add_dec_launches()
        packed, new_hist, new_gens, fb, xh, yh, clips, power = res
        ok = _bitwise(new_hist, ref_hist) and _bitwise(power, ref_pow)
        if sh is None:
            want = dd.decimate_flat_reference(ref_out.T, K, **dkw)
            ok &= all(_bitwise(g, w) for g, w in
                      zip((packed, clips, new_gens), want))
        else:
            wp, wc = host.process_interleaved(ref_out[:, :K].T.cpu().numpy())
            ok &= bool(np.array_equal(packed[:K].cpu().numpy(), wp)
                       and int(clips) == wc
                       and np.array_equal(yh.cpu().numpy(), sh.yh)
                       and np.array_equal(dd.states_numpy(new_gens),
                                          host.tpdf_generators))
        ref = "the plain version" if sh is None else "the native host"
        print(f"  pipeline_chunk {label}, preset -3 chunk ({n} frames in, K "
              f"{K}): history and power bitwise K1's, bytes and state "
              f"bitwise {ref} {ok}; clips {int(clips)}; launches K1 "
              f"{launches[0]}, decimate {launches[1]}")
        _require(ok, f"pipeline_chunk {label}")
        _require(dev.type != "cuda" or (launches[0] == 1 and sum(
            launches[1].values()) == 1), f"pipeline_chunk {label} launches")


def _host_ms(fn, reps):
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def _chain_probe_ms(dev, host, frames, K, reps=3):
    """The shaped kernel's latency bound: decimate_chain_probe_kernel, the
    kernel's dithered per-frame chain alone in one thread, K times on the
    host shaper's coefficients and state and the block's first scaled
    sample, its final state bitwise against its plain version; the median
    ms of ``reps`` launches (CUDA events), nan off the card."""
    sh = host.noise_shaper
    xs = np.float32(np.float32(frames[0, 0]) * np.float32(host.scaler))
    values = [*sh.a, *sh.b, xs, 0.3, host.feedback[0], *sh.xh[:, 0],
              *sh.yh[:, 0]]
    want = dd.chain_probe_reference(values, K, torch.float32)
    if dev.type != "cuda":
        return float("nan")
    v = torch.from_numpy(dd._probe_values(values, torch.float32)).to(dev)
    got = dd.chain_probe(v, K, torch.float32, dev)
    times = [_time_ms(dev, lambda: dd.chain_probe(v, K, torch.float32, dev),
                      1) for _ in range(reps)]
    same = _bitwise(got.cpu(), torch.from_numpy(want))
    runs = ", ".join(f"{t:.4f}" for t in times)
    print(f"  decimate_chain_probe_kernel, K = {K}: final state bitwise its "
          f"plain version's {same}; runs {runs} ms")
    _require(same, "the chain probe differs from its plain version")
    return sorted(times)[len(times) // 2]


def _kernel_device_ms(dev, fn, calls, kernel):
    """The card's ms a launch of ``kernel`` (torch.profiler) over ``calls``
    calls of ``fn``, each after a 128 MB write that flushes the 50 MB L2,
    so the kernel reads its inputs from memory, as its byte bound counts
    them; the average over the launches the trace holds.  nan off the card
    or where the trace holds none."""
    if dev.type != "cuda":
        return float("nan")
    flush = torch.empty(1 << 25, device=dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    us = count = 0
    for e in prof.key_averages():
        if kernel in e.key:
            us += getattr(e, "self_device_time_total", 0)
            count += e.count
    return us / count / 1e3 if us and count else float("nan")


def decimate_times(dev, n_target=1 << 22, block=16384, group=8, seconds=60):
    """The decimate stage's times, on entry points every tree with the
    decimate stage has (so the A/B runs it on an older tree too): for the
    flat kernel on a 2^22-frame stereo chunk (16 bits, HP, K1's layout),
    process_flat_packed's int16 epilogue on a group of 8 preset -3 chunks
    and the shaped kernel on art's block, the ms a call (CUDA events, back
    to back) and the kernel's device ms with the L2 flushed
    (_kernel_device_ms); the shaped kernel's ms a call on the 2^22 chunk;
    the M frames/s of Decimator(backend="torch") and of the native host
    over phase 15's stream (ATH, HP, 16 bits, 16,384-frame calls)."""
    from art_tpu_torch import Decimator
    times = {}

    def timed(label, fn, reps, kernel):
        fn()
        times[f"{label}: ms a call"] = _time_ms(dev, fn, reps)
        times[f"{label}: device ms"] = _kernel_device_ms(dev, fn, reps,
                                                         kernel)
    buf = _noise_dev(dev, (2, n_target), 74, 0.6)
    kw = _dec_kw(_host_decimator(HP), dev)
    flat, shaped = "decimate_flat_kernel", "decimate_shaped_kernel"
    timed("decimate_flat chunk", lambda: dd.decimate_flat(
        buf.T, n_target, **kw), 20, flat)
    K0 = _steady_chunk(HEAD, dev, n_target)[2]
    grp = _noise_dev(dev, (2, group * K0), 75, 0.25)
    zi = torch.zeros((), dtype=torch.int32, device=dev)
    timed("epilogue group", lambda: streams._quantize_pack(
        grp, 32768.0, zi, highclip=32767, lowclip=-32768, output_bits=16,
        output_bytes=2), 5, flat)
    eng, n1, Kb, start, P, fracv, kw1 = _steady_chunk(HEAD, dev, block)
    out = k1.fixed_step(eng.hist, _noise_dev(dev, (2, n1), 76, 0.6), P,
                        start, Kb, torch.zeros((), device=dev), **kw1)[1]
    skw = _dec_kw(_host_decimator(HP | ATH), dev)
    timed("decimate_shaped block", lambda: dd.decimate_shaped(
        out.T, Kb, **skw), 10, shaped)
    times["decimate_shaped chunk: ms a call"] = _time_ms(
        dev, lambda: dd.decimate_shaped(buf.T, n_target, **skw), 2)
    frames = np.ascontiguousarray(roundtrip.artest_noise(seconds).T)
    for be in ("torch", "native"):
        dec = Decimator(2, 16, 2, 1.0, 44100, HP | ATH, backend=be,
                        device=dev)
        dec.process_interleaved(frames[:block])
        t0 = time.perf_counter()
        for i in range(block, frames.shape[0], block):
            dec.process_interleaved(frames[i:i + block])
        _sync(dev)
        times[f"Decimator {be}, M frames/s"] = \
            (frames.shape[0] - block) / (time.perf_counter() - t0) / 1e6
    return times


def phase_decimate_timing(dev, tag, n_target=1 << 22, block=16384,
                          group=8, seconds=60):
    """The decimate kernels' times (decimate_times: a call's with CUDA
    events, the kernel's on the card with the L2 flushed) beside their
    plain versions (CUDA events), the native host decimator on the same
    samples (host clock) and their bounds: the flat kernel on a
    2^22-frame stereo chunk to 16 bits and process_flat_packed's int16
    epilogue with their byte bounds (samples in plus packed bytes out over
    the memory rate), the shaped kernel on the art command's steady block
    with its latency bound (the chain probe) and on the 2^22 chunk.
    Returns {kernel: (ms a call, device ms, plain ms, bound)}."""
    t = decimate_times(dev, n_target, block, group, seconds)
    for label, v in t.items():
        print(f"  {label}: {v:.4f} {tag}")
    res = {}
    n = n_target
    buf = _noise_dev(dev, (2, n), 74, 0.6)
    host = _host_decimator(HP)
    kw = _dec_kw(host, dev)
    xnp = np.ascontiguousarray(buf.T.cpu().numpy())
    plain = _time_ms(dev, lambda: dd.decimate_flat_reference(buf.T, n, **kw),
                     3)
    host_ms = _host_ms(lambda: host.process_interleaved(xnp), 3)
    bound = _bound_ms(n * 2 * (4 + 2), 7 * n * 2, PEAK_F32)
    kms = t["decimate_flat chunk: device ms"]
    print(f"  decimate_flat, {n}-frame stereo chunk, 16 bits, HP: plain "
          f"{plain:.4f} ms, native host {host_ms:.4f} ms (host clock); "
          f"bound {bound[0]:.4f} ms ({bound[1]}: {n * 12 / 1e6:.1f} MB), "
          f"the kernel's device time at {bound[0] / kms:.1%} of it {tag}")
    res["decimate_flat"] = (t["decimate_flat chunk: ms a call"], kms, plain,
                            bound)
    K0 = _steady_chunk(HEAD, dev, n_target)[2]
    grp = _noise_dev(dev, (2, group * K0), 75, 0.25)
    zi = torch.zeros((), dtype=torch.int32, device=dev)
    eplain = _time_ms(dev, lambda: streams._quantize_pack_reference(
        grp, 32768.0, zi, highclip=32767, lowclip=-32768, output_bits=16,
        output_bytes=2), 3)
    ebound = _bound_ms(group * K0 * 2 * (4 + 2), 7 * group * K0 * 2,
                       PEAK_F32)
    print(f"  epilogue, group of {group} x {K0} stereo frames "
          f"(process_flat_packed int16): int64 plain {eplain:.4f} ms; bound "
          f"{ebound[0]:.4f} ms ({ebound[1]}), the kernel's device time at "
          f"{ebound[0] / t['epilogue group: device ms']:.1%} of it {tag}")
    eng, n1, Kb, start, P, fracv, kw1 = _steady_chunk(HEAD, dev, block)
    out = k1.fixed_step(eng.hist, _noise_dev(dev, (2, n1), 76, 0.6), P,
                        start, Kb, torch.zeros((), device=dev), **kw1)[1]
    host = _host_decimator(HP | ATH)
    skw = _dec_kw(host, dev)
    bnp = np.ascontiguousarray(out[:, :Kb].T.cpu().numpy())
    _sync(dev)
    t0 = time.perf_counter()
    dd.decimate_shaped_reference(out.T, Kb, **skw)
    _sync(dev)
    plain_ms = (time.perf_counter() - t0) * 1e3
    block_host = _host_ms(lambda: host.process_interleaved(bnp), 10)
    bound = (_chain_probe_ms(dev, host, bnp, Kb), "latency")
    ms = t["decimate_shaped block: device ms"]
    print(f"  decimate_shaped ATH HP 16, art's steady block ({Kb} frames): "
          f"plain {plain_ms:.1f} ms (one call, host clock), native host "
          f"{block_host:.4f} ms; latency bound {bound[0]:.4f} ms (the "
          f"chain probe), the kernel's device time at {bound[0] / ms:.1%} "
          f"of it {tag}")
    res["decimate_shaped"] = (t["decimate_shaped block: ms a call"], ms,
                              plain_ms, bound)
    chunk_host = _host_ms(lambda: host.process_interleaved(xnp), 2)
    print(f"  decimate_shaped ATH HP 16, {n}-frame stereo chunk: native "
          f"host {chunk_host:.3f} ms {tag}")
    return res


# ------------------------------------------------ phase 14: biquad cascade
# the -p lowpass of art -r48k and of BASELINE config 4 (bench.py:281); art
# -r96k's post filter (art.py: sample_rate * 0.45 / resample_rate)
BQ_C4, BQ_R96 = 0.45 * 44100 / 48000, 44100 * 0.45 / 96000
R96 = (2, 380, 380, 44100, 96000, 0, FLAGS)
C4_CHUNK = 1 << 19          # bench.py's _mult_chunk(1 << 19, M = 160)
BIQUAD_PATH_LAUNCHES = {"biquad": 0}


def _bq_pair(freq, ch, dtype=np.float64):
    from art_tpu_torch.engines.biquad import Biquad, biquad_lowpass
    c = biquad_lowpass(freq)
    return [Biquad.init(c, 1.0, ch, dtype) for _ in range(2)]


def _bq_sections(freq, combined):
    """[(a, b)] of the -p cascade's sections, or of its combined one."""
    q1, q2 = _bq_pair(freq, 1)
    if combined:
        return [bk.combine_biquads(q1, q2)]
    return [(np.asarray(q.a, np.float64), np.asarray(q.b, np.float64))
            for q in (q1, q2)]


def _bq_within(got, want):
    """(max |got - want|, within the class): float64 within 1e-12 of the
    plain version's scale, float32 within one float32 ulp."""
    g, w = got.double(), want.double()
    if not g.numel():
        return 0.0, True
    err = float((g - w).abs().max())
    if got.dtype == torch.float64:
        return err, err <= 1e-12 * max(float(w.abs().max()), 1e-300)
    ulp = torch.maximum(g.abs(), w.abs()).float()
    ulp = (torch.nextafter(ulp, torch.full_like(ulp, float("inf"))) - ulp)
    return err, bool(((g - w).abs() <= ulp.double()).all())


# K around the kernel's 8192-frame span edges and inside a span's first
# four frames
BQ_EDGE_KS = (8191, 8192, 8193, 8195, 16388)


def _bq_cases(label, x, sections, dev, seed):
    """Each section of ``sections`` by the kernel and by its plain version
    on the same input (at K = n section 2 reads the kernel's section 1
    output on both sides, at the other K the same input as section 1), at
    K = n, n - 777 with NaN past it, 0, 3, 256 and BQ_EDGE_KS, from
    random states: outputs within the class, zero past K, xh' bitwise, yh'
    within 1e-12.  Returns the largest |kernel - plain|."""
    S, n = x.shape
    rng = np.random.default_rng(seed)
    worst = 0.0
    for K in [k for k in (n, n - 777, 0, 3, 256, *BQ_EDGE_KS) if k <= n]:
        inp = x
        if K < n:
            inp = x.clone()
            inp[:, K:] = float("nan")
        for i, (a, b) in enumerate(sections):
            t = bk.iir_tables(b, B=bk.KERNEL_BLOCK, device=dev)
            xh, yh = (torch.from_numpy(rng.standard_normal((4, S)) * 0.1)
                      .to(dev) for _ in range(2))
            got = bk.assoc_core_masked_T(inp, a, b, xh, yh, K, t)
            want = bk.assoc_core_masked_reference(inp.T, a, b, xh, yh, K, t)
            _sync(dev)
            err, within = _bq_within(got[0][:, :K], want[0].T[:, :K])
            zero = not got[0][:, K:].any()
            xh_ok = _bitwise(got[1], want[1])
            yh_err = float((got[2] - want[2]).abs().max())
            print(f"  biquad {label}, section {i + 1} of {len(sections)}, "
                  f"K = {K}{' (NaN past K)' if K < n else ''}: max|kernel - "
                  f"plain| {err:.3e} (within the class {within}), zero past "
                  f"K {zero}, xh' bitwise {xh_ok}, |yh' - plain| "
                  f"{yh_err:.3e}")
            _require(within and zero and xh_ok and yh_err <= 1e-12,
                     f"biquad {label} vs plain, section {i + 1}, K = {K}")
            worst = max(worst, err)
            inp = got[0] if K == n else inp
    return worst


def phase_biquad_kernels(dev, n_c4=C4_CHUNK, block=16384):
    """The biquad kernel against its plain version on the card: BASELINE
    config 4b's chunk (6 x 524,320 float64; the combined section and the
    cascade's two) and the steady block of art -3 -r96k -p (K1's float32
    output of a 16,384-frame preset -3 block, 2 channels, the cascade).
    Returns the largest |kernel - plain|."""
    n = roundtrip.m_multiple(n_c4, 160)
    x = _noise_dev(dev, (6, n), 81, 0.25, torch.float64)
    worst = 0.0
    for combined in (True, False):
        worst = max(worst, _bq_cases(
            f"config 4b ({'combined' if combined else 'cascade'}, 6 x {n} "
            f"float64)", x, _bq_sections(BQ_C4, combined), dev, 82))
    eng, n1, K, start, P, fracv, kw = _steady_chunk(R96, dev, block)
    out = k1.fixed_step(eng.hist, _noise_dev(dev, (2, n1), 83, 0.6), P,
                        start, K, torch.zeros((), device=dev), **kw)[1]
    worst = max(worst, _bq_cases(
        f"art -3 -r96k -p steady block ({out.shape[1]} rows, K {K}, "
        f"float32)", out[:, :K].contiguous(),
        _bq_sections(BQ_R96, False), dev, 84))
    return worst


def phase_biquad_paths(dev, seconds=60, block=1 << 17, n_c4=C4_CHUNK,
                       nchunks=8, windows=3, n_head=1 << 22):
    """The cascade's main paths, the counts set to 0 before each and read
    after it: DeviceBiquadCascade against the native host pair over a 60 s
    5.1 float64 stream at 48k (blocks of 2^17 frames, a ragged last one,
    two blocks handed to the host mid-stream by pull_to / push_from);
    BASELINE config 4b's chain (the combined cascade into the float64
    DeviceStreamResampler, bench.py:297-335) for windows of 8 chunks of
    524,320 frames, M output frames/s; pipeline_chunk with the -p post
    filter at the preset -3 shapes against K1, the plain cascade and the
    plain decimate stage.  Returns the CLI-free launch count."""
    from art_tpu_torch.engines.biquad import apply_cascade
    from art_tpu_torch.parallel.pipeline import pipeline_chunk
    # 1. a 60 s 5.1 stream against the native host pair
    rng = np.random.default_rng(85)
    n = seconds * 48000
    x = rng.standard_normal((n, 6)) * 0.25
    host = _bq_pair(BQ_C4, 6)
    t0 = time.perf_counter()
    want = apply_cascade(host, x)
    host_s = time.perf_counter() - t0
    mixed = _bq_pair(BQ_C4, 6)
    cas = bk.DeviceBiquadCascade(*mixed, device=dev)
    _reset_launches()
    out, on_card, nblk = [], False, 0
    for i, lo in enumerate(range(0, n, block)):
        hi = min(lo + block, n)
        if i in (5, 6):                       # two blocks on the host
            if on_card:
                cas.pull_to(*mixed)
                on_card = False
            out.append(apply_cascade(mixed, x[lo:hi]))
            continue
        if not on_card:
            cas.push_from(*mixed)
            on_card = True
        blk = torch.zeros((6, block), dtype=torch.float64, device=dev)
        blk[:, :hi - lo] = torch.from_numpy(x[lo:hi].T).to(dev)
        out.append(cas.process(blk, hi - lo)[:, :hi - lo].T.cpu().numpy())
        nblk += 1
    got = np.concatenate(out)
    err = float(np.abs(got - want).max())
    launches, calls = bk.launches["biquad"], bk.host_calls["biquad"]
    BIQUAD_PATH_LAUNCHES["biquad"] += launches
    print(f"  DeviceBiquadCascade vs the native host pair, 60 s 5.1 float64 "
          f"({n} frames, {nblk} blocks of {block} on the card, 2 on the "
          f"host): max |card - host| {err:.3e}; launches {launches}, host "
          f"calls {calls}; host pair alone {host_s:.3f} s (host clock)")
    _require(err <= 1e-12, "DeviceBiquadCascade vs the native host pair")
    _require(dev.type != "cuda" or (launches == 2 * nblk and calls == nblk),
             "DeviceBiquadCascade: launches != 2 and host calls != 1 per "
             "block")
    # 2. BASELINE config 4b's chain
    eng, cas, x4, nc = _c4_setup(dev, n_c4)
    first = cas._state
    y = cas.process(x4, nc)
    (a, b), = _bq_sections(BQ_C4, True)
    ref = bk.assoc_core_masked_reference(
        x4.T, a, b, *first, nc, cas._sections[0].tables)[0].T
    err4, within = _bq_within(y, ref)
    print(f"  config 4b chain: the combined cascade's first chunk vs its "
          f"plain version: max abs {err4:.3e}, within 1e-12 of scale "
          f"{within}")
    _require(within, "config 4b's cascade vs its plain version")
    acc = torch.zeros((), dtype=torch.float64, device=dev)
    eng.process(y, nc, acc)                       # the first chunk
    _reset_launches()
    rates, acc = _c4_windows(dev, eng, cas, x4, nc, acc, nchunks, windows,
                             verbose=True)
    bl, kl = bk.launches["biquad"], k1.instance_launches["f64"]
    BIQUAD_PATH_LAUNCHES["biquad"] += bl
    print(f"  config 4b chain: median {sorted(rates)[len(rates) // 2]:.2f} M "
          f"output frames/s; launches biquad {bl} (design: 1 a section, 1 "
          f"section a chunk), K1 float64 {kl}; power {float(acc):.6e}")
    _require(bool(torch.isfinite(acc)) and float(acc) > 0,
             "config 4b chain: power not finite")
    _require(dev.type != "cuda" or (bl == nchunks * windows
                                    and kl == nchunks * windows),
             "config 4b chain: launches off the design")
    # 3. pipeline_chunk with the post filter, preset -3 shapes
    eng, n, K, start, P, fracv, kw = _steady_chunk(HEAD, dev, n_head)
    xc = _noise_dev(dev, (2, n), 87, 0.6)
    hist = eng.hist
    host = _host_decimator(HP)
    dkw = _dec_kw(host, dev)
    secs = _bq_sections(BQ_C4, False)
    state = tuple(torch.from_numpy(rng.standard_normal((4, 2)) * 0.1).to(dev)
                  for _ in range(4))
    _reset_launches()
    res = pipeline_chunk(
        xc, hist, P, start, K, dkw["gens"], host.feedback,
        np.zeros((4, 2), np.float32), np.zeros((4, 2), np.float32),
        M=kw["M"], L=kw["L"], nb=kw["nb"], qn_pad=kw["qn"],
        qn_local=kw["qn"], hist_len=kw["hist_len"],
        scaler=float(host.scaler), highclip=host.highclip,
        lowclip=host.lowclip, dither_type=host.dither_type, shaper_a=None,
        shaper_b=None, output_bits=16, output_bytes=2,
        post_bq=tuple(secs), bq_state=state)
    _sync(dev)
    launches = (k1.launches, bk.launches["biquad"], dict(dd.launches))
    BIQUAD_PATH_LAUNCHES["biquad"] += launches[1]
    _add_dec_launches()
    packed, new_hist, new_gens, _, _, _, clips, power, bq_state = res
    ref_hist, ref_out = k1.fixed_step(hist, xc, P, start, K,
                                      torch.zeros((), device=dev), **kw)[:2]
    y, st = ref_out, []
    for i, (a, b) in enumerate(secs):
        t = bk.iir_tables(b, B=bk.KERNEL_BLOCK, device=dev)
        y, xh_, yh_ = bk.assoc_core_masked_reference(
            y.T, a, b, state[2 * i], state[2 * i + 1], K, t)
        y = y.T
        st += [xh_, yh_]
    wp, wc, _ = dd.decimate_flat_reference(y.T, K, **dkw)
    codes = [t.view(torch.int16).int().cpu() for t in (packed, wp)]
    diff = (codes[0] - codes[1]).abs()
    st_err = max(float((g - w).abs().max()) for g, w in zip(bq_state, st))
    pw_err = abs(float(power) - float(torch.sum(y * y))) / float(power)
    ok = (_bitwise(new_hist, ref_hist) and int(diff.max()) <= 1
          and int(clips) == int(wc) and st_err <= 1e-12 and pw_err <= 1e-6)
    print(f"  pipeline_chunk with the -p post filter, preset -3 chunk ({n} "
          f"frames in, K {K}): history bitwise K1's, codes within "
          f"{int(diff.max())} LSB of the plain chain ({int((diff > 0).sum())}"
          f" differ), clips {int(clips)} (plain {int(wc)}), |bq_state' - "
          f"plain| {st_err:.3e}, power after the filter within {pw_err:.2e}"
          f": {ok}; launches K1 {launches[0]}, biquad {launches[1]}, "
          f"decimate {launches[2]}")
    _require(ok, "pipeline_chunk with the post filter")
    _require(dev.type != "cuda" or (launches[0] == 1 and launches[1] == 2
                                    and sum(launches[2].values()) == 1),
             "pipeline_chunk with the post filter: launches")


def _cli_post_filter(dev, tag, seconds=60):
    """art -3 -r96k -p -o16 -n0 with --backend=cuda beside --backend=numpy
    on the 60 s file: the post filter on the card between K1 and the
    decimate kernel, one cascade (2 launches) per steady block; lengths
    and clip warnings equal, codes within the resample-then-decimate
    floor."""
    from art_tpu_torch.cli import art
    wav, n = _cli_wav(seconds)
    steady = n // art.BUFFER_SAMPLES - 1
    cmd = "art -3 -r96k -p -o16 -n0"
    got, legs = {}, {}
    for be in ("cuda", "numpy"):
        out = CLI_DIR / f"art_p_{be}.wav"
        err, secs, kl, al, dl = _run_cli(
            art.main, ["-q", "-y", "-3", "-r96k", "-p", "-o16", "-n0",
                       str(wav), str(out)], dev, be)
        got[be] = (_wav_data(out.read_bytes()), err)
        legs[be] = (secs, len(got[be][0]) // 4)
        if be == "cuda":
            bl = bk.launches["biquad"]
            print(f"  {cmd}: biquad launches {bl}, K1 launches {kl}, "
                  f"decimate launches {dl}, steady blocks {steady}")
            _require(dev.type != "cuda" or (
                bl == 2 * steady and kl["f32"] == steady
                and dl["decimate_flat"] >= steady + 2),
                f"{cmd}: launches off the design")
            BIQUAD_PATH_LAUNCHES["biquad"] += bl
            for name, c in dl.items():
                DEC_PATH_LAUNCHES[name] += c
    (a, ea), (b, eb) = got["cuda"], got["numpy"]
    _require(len(a) == len(b) and ea == eb,
             f"{cmd}: output length or clip warnings differ")
    diff = np.abs(np.frombuffer(a, "<i2").astype(np.int32)
                  - np.frombuffer(b, "<i2").astype(np.int32))
    print(f"  {cmd}: {len(a)} bytes each, codes within {diff.max()} LSB "
          f"(mean {diff.mean():.3e}); stderr {ea.strip() or '(none)'!r}")
    _require(diff.max() <= 12 and diff.mean() < 2.0,
             f"{cmd}: 16-bit codes beyond the shaped-noise floor")
    _rate_line(cmd, legs, tag)


def _biquad_device_ms(dev, fn, calls, sections=1):
    """The card's ms a call of ``fn`` in the biquad kernels
    (torch.profiler), each call after a 128 MB write that flushes the 50
    MB L2, so the kernels read their inputs from memory, as the byte bound
    counts them: for each biquad kernel its time over the launches the
    trace holds, summed over the kernels and times the ``sections`` a call
    launches each of them for (an older tree's three kernels a section
    too).  nan off the card or where the trace holds none."""
    if dev.type != "cuda":
        return float("nan")
    flush = torch.empty(1 << 25, device=dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for _ in range(3):      # a trace now and then records no kernel
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(calls):
                flush.zero_()
                fn()
            torch.cuda.synchronize()
        per = [getattr(e, "self_device_time_total", 0) / e.count
               for e in prof.key_averages()
               if re.search(r"biquad_\w+_kernel", e.key) and e.count]
        us = sections * sum(per)
        if us:
            return us / 1e3
    return float("nan")


def _bq_art_block(dev, block=16384, seed=89):
    """K1's float32 output of art -3 -r96k's steady block [2, rows] and
    its K."""
    eng, n1, K, start, P, fracv, kw = _steady_chunk(R96, dev, block)
    out = k1.fixed_step(eng.hist, _noise_dev(dev, (2, n1), seed, 0.6), P,
                        start, K, torch.zeros((), device=dev), **kw)[1]
    return out, K


def biquad_times(dev, save=None, n_c4=C4_CHUNK, reps=100, chain=True):
    """The biquad cascade's times, on entry points every tree with the
    cascade has (so the A/B runs it on an older tree too): one section
    (the combined one, what config 4b's chain runs) and the -p cascade of
    two at config 4b's chunk (6 x 524,320 float64), each a call's ms (CUDA
    events, back to back, after 10 calls of warm-up) and the kernels'
    device ms a call with the L2 flushed (_biquad_device_ms, taken after
    every call is timed);
    DeviceBiquadCascade.process on art -3 -r96k -p's steady block (CUDA
    events, and the host's ms to issue a call); with ``chain``, config
    4b's chain in M output frames/s (the median of 3 windows of 8
    chunks).  ``save``: a directory the first outputs of each case go to
    as .npy (the A/B compares them)."""
    n = roundtrip.m_multiple(n_c4, 160)
    S = 6
    x = _noise_dev(dev, (S, n), 88, 0.25, torch.float64)
    (ac, bc), = _bq_sections(BQ_C4, True)
    (a, b), _ = _bq_sections(BQ_C4, False)
    sec = bk._prepare(ac, bc, None, dev)
    st = [torch.from_numpy(np.random.default_rng(90 + i).standard_normal(
        (4, S)) * 0.1).to(dev) for i in range(4)]
    out, K = _bq_art_block(dev)
    pair = _bq_pair(BQ_R96, 2, np.float32)
    cas = bk.DeviceBiquadCascade(*pair, device=dev)
    cas.push_from(*pair)
    cases = {
        "section, config 4b": (lambda: bk._solve(x.T, sec, st[0], st[1], n,
                                                 True), 1),
        "cascade, config 4b": (lambda: bk._cascade2_step_T(
            x, a, b, st[0], st[1], a, b, st[2], st[3], n, None, None), 2),
    }
    times, outs = {}, {}
    for label, (fn, _) in cases.items():
        outs[label] = fn()
        for _ in range(10):
            fn()
        times[f"{label}: ms a call"] = _time_ms(dev, fn, reps)
    outs["art block"] = (cas.process(out, K), *cas._state)
    for _ in range(10):
        cas.process(out, K)
    times["art -r96k -p block: ms a call"] = _time_ms(
        dev, lambda: cas.process(out, K), reps)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        cas.process(out, K)
    times["art -r96k -p block: host ms a call"] = \
        (time.perf_counter() - t0) * 1e3 / reps
    _sync(dev)
    if chain:
        times["config 4b chain: M output frames/s"] = _c4_chain(dev, n_c4)
    for label, (fn, sections) in cases.items():
        times[f"{label}: device ms"] = _biquad_device_ms(dev, fn, 20,
                                                         sections)
    if save is not None:
        save = Path(save)
        save.mkdir(parents=True, exist_ok=True)
        for label, ts in outs.items():
            for i, t in enumerate(ts):
                np.save(save / f"{re.sub(r'\W+', '_', label)}.{i}.npy",
                        t.cpu().numpy())
    return times


def _c4_setup(dev, n_c4):
    """Config 4b's chain (the combined -p cascade into the float64
    DeviceStreamResampler, bench.py:297-335): (engine, cascade, a chunk of
    6 x nc float64 noise, nc)."""
    eng = DeviceStreamResampler(*CONFIG4, dtype=np.float64, device=dev)
    eng.advance_position(190)
    eng.prewarm()
    nc = roundtrip.m_multiple(n_c4, eng.M)
    cas = bk.DeviceBiquadCascade(*_bq_pair(BQ_C4, 1), combined=True,
                                 device=dev)
    cas.push_from(*_bq_pair(BQ_C4, 6))
    return eng, cas, _noise_dev(dev, (6, nc), 86, 0.25, torch.float64), nc


def _c4_windows(dev, eng, cas, x, nc, acc, nchunks, windows,
                verbose=False):
    """``windows`` windows of ``nchunks`` chunks through config 4b's
    chain (host clock, one sync a window): (M output frames/s of each
    window, the power accumulator)."""
    rates = []
    for w in range(windows):
        _sync(dev)
        t0 = time.perf_counter()
        produced = 0
        for _ in range(nchunks):
            _, K, acc = eng.process(cas.process(x, nc), nc, acc)
            produced += K
        _sync(dev)
        dt = time.perf_counter() - t0
        rates.append(produced / dt / 1e6)
        if verbose:
            print(f"  config 4b chain window {w}: {nchunks} chunks x 6 x "
                  f"{nc} float64 frames -> {produced} output frames in "
                  f"{dt * 1e3:.3f} ms = {rates[-1]:.2f} M output frames/s")
    return rates, acc


def _c4_chain(dev, n_c4, nchunks=8, windows=3):
    """Config 4b's chain: the median M output frames/s of ``windows``
    windows of ``nchunks`` chunks after a first chunk."""
    eng, cas, x, nc = _c4_setup(dev, n_c4)
    acc = torch.zeros((), dtype=torch.float64, device=dev)
    eng.process(cas.process(x, nc), nc, acc)
    rates, _ = _c4_windows(dev, eng, cas, x, nc, acc, nchunks, windows)
    return sorted(rates)[len(rates) // 2]


def profile_biquad(dev, n_c4=C4_CHUNK):
    """``--profile-biquad``: the biquad kernels' device time a launch
    (torch.profiler, by kernel) for one section at config 4b's chunk (the
    combined one), the -p cascade there and DeviceBiquadCascade on art -3
    -r96k -p's block, with a call's CUDA-event time; also from an older
    checkout, as ``--checksum`` is."""
    n = roundtrip.m_multiple(n_c4, 160)
    x = _noise_dev(dev, (6, n), 88, 0.25, torch.float64)
    (ac, bc), = _bq_sections(BQ_C4, True)
    (a, b), _ = _bq_sections(BQ_C4, False)
    z = torch.zeros((4, 6), dtype=torch.float64, device=dev)
    sec = bk._prepare(ac, bc, None, dev)
    out, K = _bq_art_block(dev)
    pair = _bq_pair(BQ_R96, 2, np.float32)
    cas = bk.DeviceBiquadCascade(*pair, device=dev)
    cas.push_from(*pair)
    for label, fn in (
            ("section, config 4b", lambda: bk._solve(x.T, sec, z, z, n,
                                                     True)),
            ("cascade, config 4b", lambda: bk._cascade2_step_T(
                x, a, b, z, z, a, b, z, z, n, None, None)),
            ("art -r96k -p block", lambda: cas.process(out, K))):
        for _ in range(3):
            fn()
        _sync(dev)
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            m = re.search(r"(biquad_\w+_kernel)", e.key)
            t = getattr(e, "self_device_time_total", 0)
            if m and t and e.count:
                per[m.group(1)] = (round(t / e.count, 2), e.count)
        print(f"{label}: device us a launch (launches) {per or 'none'}; "
              f"{_time_ms(dev, fn, 20):.4f} ms a call (CUDA events)")


def phase_biquad_timing(dev, tag, n_c4=C4_CHUNK, reps=10):
    """The kernel's times (biquad_times, the A/B's harness, without the
    chain phase_biquad_paths times) beside, in turns with one section,
    the plain version and one torch.matmul of JAX's [B, B+4] x [B+4,
    nb*S] float64 Toeplitz product at B = 256 (cuBLAS DGEMM: one stage of
    JAX's method, printed as a line, not a library yardstick: no PyTorch
    call computes the section); the native host cascade on the same chunk
    and the pair on art's block (host clock); the bound.  Returns (ms a
    call, device ms, plain ms, bound)."""
    from art_tpu_torch.engines.biquad import apply_cascade
    t = biquad_times(dev, n_c4=n_c4, chain=False)
    for label, v in t.items():
        print(f"  biquad {label}: {v:.4f} {tag}")
    n = roundtrip.m_multiple(n_c4, 160)
    S = 6
    x = _noise_dev(dev, (S, n), 88, 0.25, torch.float64)
    (ac, bc), = _bq_sections(BQ_C4, True)
    sec = bk._prepare(ac, bc, None, dev)
    z = torch.zeros((4, S), dtype=torch.float64, device=dev)
    B = 256
    nb = -(-n // B)
    TG = torch.randn((B, B + 4), dtype=torch.float64, device=dev)
    FS = torch.randn((B + 4, nb * S), dtype=torch.float64, device=dev)
    tables = bk.iir_tables(bc, B=bk.KERNEL_BLOCK, device=dev)
    variants = {
        "biquad kernel, one section": lambda: bk._solve(x.T, sec, z, z, n,
                                                        True),
        "biquad plain, one section": lambda: bk.assoc_core_masked_reference(
            x.T, ac, bc, z, z, n, tables),
        "torch.matmul DGEMM, B = 256 (one stage of JAX's method)":
            lambda: TG @ FS,
    }
    names = list(variants)
    order = [names[1], names[0], names[2], names[2], names[0], names[1]]
    med = _time_in_turns(dev, variants, order, reps,
                         f"per {S} x {n}-frame float64 chunk", tag)
    xnp = np.ascontiguousarray(x.T.cpu().numpy())
    host = _bq_pair(BQ_C4, S)
    host_ms = _host_ms(lambda: apply_cascade(host, xnp), 3)
    # each sample read once and written once, float64; 9 multiply-adds a
    # sample a section (5 FIR taps, 4 feedback) on the FP64 rate
    bound = _bound_ms(2 * 8 * S * n + 4 * 8 * 4 * S, 18 * S * n, PEAK_F64)
    dms = t["section, config 4b: device ms"]
    print(f"  native host cascade (two sections), same chunk: {host_ms:.4f} "
          f"ms (host clock); one section's bound {bound[0]:.4f} ms "
          f"({bound[1]}: {2 * 8 * S * n / 1e6:.1f} MB), the kernel's device "
          f"time at {bound[0] / dms:.1%} of it {tag}")
    out, K = _bq_art_block(dev)
    pair = _bq_pair(BQ_R96, 2, np.float32)
    bnp = np.ascontiguousarray(out[:, :K].T.cpu().numpy())
    hms = _host_ms(lambda: apply_cascade(pair, bnp), reps)
    print(f"  native host pair, art -3 -r96k -p steady block (2 x "
          f"{out.shape[1]} float32, K {K}): {hms:.4f} ms (host clock) {tag}")
    return (t["section, config 4b: ms a call"], dms,
            med["biquad plain, one section"], bound)


# ------------------------------------------- phase 15: host-engine backends
# the kernels' launches on phase 15's paths (the host Resampler and
# Decimator with backend="torch", art and artest --backend=torch), each
# read right after its path ran with the counts set to 0 before it
BACKEND_PATH_LAUNCHES = {"f32": 0, "f64": 0, "asrc_apply": 0,
                         "asrc_apply_f64": 0, "decimate_shaped": 0}
# phase 12's numpy legs, which phase 15's CLI legs are compared with
CLI_NUMPY = {}
# preset -1 (48 filters, 48 taps), as artest -1 runs it
PRESET1 = (2, 48, 48)


def _art_block_parts(F, taps, interpolate, K=17760, ratio=48000 / 44100,
                     seed=15):
    """(buffer [2, 16384 + 2*taps] float64, decompose_positions parts) of
    an art block's K outputs at ``ratio``; a quarter of the positions a
    hair below the next sample (the exact mode's phase index reaches F
    there), a quarter on a sample."""
    from art_tpu_torch.ops import resample_kernel as rk
    rng = np.random.default_rng(seed)
    pos = taps + 0.37 + np.arange(K) / ratio
    pos[::4] = np.floor(pos[::4])
    pos[1::4] = np.floor(pos[1::4]) + 1.0 - 0.2 / F
    buf = rng.normal(0, 0.5, (2, 16384 + 2 * taps))
    return buf, rk.decompose_positions(pos, F, taps, interpolate, True)


def phase_backend_kernels(dev, n=ASRC_N):
    """K5's float64 instance against its float64 plain version at config
    5's shapes and on an art block's interpolated apply, and the art
    block's exact apply at F = 1024, whose phase index reaches F (float32
    and float64), against the host's float64 apply.  Returns the largest
    error of each instance."""
    from art_tpu_torch.ops import resample_kernel as rk
    worst = {"asrc_apply": 0.0, "asrc_apply_f64": 0.0}
    rng = np.random.default_rng(1515)
    eng = _asrc_engine(dev, ASRC_S, np.float64)
    bank = eng._bank_dev
    for label, ratios in (("near-1 drift", _drift(ASRC_S, 1)),
                          ("ratios 2.0", np.full(ASRC_S, 2.0))):
        _, Ks, k_max, _ = eng._plan(n, ratios, None)
        h = torch.from_numpy(rng.normal(0, 0.5, (ASRC_S, eng.num_samples))) \
            .to(dev)
        x = torch.from_numpy(rng.normal(0, 0.5, (ASRC_S, n))).to(dev)
        args = _step_args(eng, h, x, bank, ratios, Ks)
        buf, base, fi, frac, _ = kasrc.apply_prologue(
            h, x, args[3], args[4], args[6], num_taps=eng.num_taps,
            num_filters=eng.num_filters, k_max=k_max,
            hist_len=eng.num_samples)
        out = kasrc.asrc_apply(buf, bank, base, fi, frac)
        ref = kasrc.asrc_apply_reference(buf, bank, base, fi, frac)
        err = float((out - ref).abs().max())
        worst["asrc_apply_f64"] = max(worst["asrc_apply_f64"], err)
        print(f"  config 5 {label}: asrc_apply float64 out [{ASRC_S}, "
              f"{k_max}], max|kernel - plain| {err:.3e}")
        _require(bool(torch.isfinite(out).all()) and err <= 1e-12,
                 f"K5 float64 vs plain, config 5 {label}")
    for F, interp, dtype in ((380, True, np.float64),
                             (1024, False, np.float32),
                             (1024, False, np.float64)):
        buf, parts = _art_block_parts(F, 380, interp)
        bank = make_filter_bank(380, F, 1.0, True, dtype)
        L = buf.astype(dtype)
        out = rk.apply_torch(L, torch.from_numpy(bank).to(dev), parts,
                             interp, dtype)
        if interp:      # the plain version (a CPU bank)
            ref = rk.apply_torch(L, torch.from_numpy(bank), parts, interp,
                                 dtype)
        else:           # the host's float64 windowed dots
            ref = rk.apply_numpy(L, bank, parts, interp, np.float64)
        err = float(np.abs(out.astype(np.float64) - ref).max())
        tol = 1e-12 if dtype == np.float64 else 1e-5
        key = "asrc_apply_f64" if dtype == np.float64 else "asrc_apply"
        worst[key] = max(worst[key], err)
        top = int((parts["fi"] == F).sum())
        print(f"  art block, F={F} {'interpolated' if interp else 'exact'}"
              f" {np.dtype(dtype).name}: apply_torch [2, "
              f"{parts['base'].size}] (phase index F at {top} outputs), "
              f"max|kernel - {'plain' if interp else 'host f64'}| "
              f"{err:.3e}")
        _require(np.isfinite(out).all() and err <= tol and (interp or top),
                 f"apply_torch F={F} {np.dtype(dtype).name}")
    return worst


def _design_calls(monkeypatch_calls):
    """Spies on the Resampler's two device branches: counts the calls the
    design sends to K1 (PolyphaseKernel.apply) and to K5 (apply_torch with
    outputs).  Returns (calls, undo)."""
    from art_tpu_torch.ops import polyphase, resample_kernel as rk
    orig_poly, orig_apply = polyphase.PolyphaseKernel.apply, rk.apply_torch

    def poly(self, *a, **k):
        monkeypatch_calls["K1"] += 1
        return orig_poly(self, *a, **k)

    def apply(L, bank_dev, parts, *a, **k):
        monkeypatch_calls["K5"] += int(parts["base"].size > 0)
        return orig_apply(L, bank_dev, parts, *a, **k)

    polyphase.PolyphaseKernel.apply, rk.apply_torch = poly, apply

    def undo():
        polyphase.PolyphaseKernel.apply, rk.apply_torch = orig_poly, \
            orig_apply
    return undo


def _resampler_stream(eng, x, block, ratio_at):
    """x [2, n] through process() in ``block``-frame calls, then the flush:
    (outputs [2, m], [(used, generated, position)], wall s)."""
    outs, res = [], []
    cap = int(block * 1.2) + 400
    t0 = time.perf_counter()
    for j, i in enumerate(range(0, x.shape[1], block)):
        blk = x[:, i:i + block]
        o, r = eng.process(blk, blk.shape[1], cap, ratio_at(j))
        outs.append(o[:, :r.output_generated])
        res.append((r.input_used, r.output_generated, eng.get_position()))
    o, r = eng.process(None, -1, cap, ratio_at(-1))
    outs.append(o[:, :r.output_generated])
    res.append((r.input_used, r.output_generated, eng.get_position()))
    return np.concatenate(outs, axis=1), res, time.perf_counter() - t0


def _idle_share(dev, step, calls, wall_ms):
    """Kernel ms a call and the card's idle share over ``calls`` calls of
    ``step`` (torch.profiler), against the unprofiled wall ms a call."""
    busy = _device_busy_ms(dev, step, calls) if dev.type == "cuda" else None
    if busy is None:
        return "card busy: not measured"
    return (f"card busy (torch.profiler, {calls} calls): {busy / calls:.4f} "
            f"ms of kernels a call, idle {1 - busy / calls / wall_ms:.1%}")


def _stepper(eng, x, block, ratio_at):
    """One process() call of ``eng`` on the next ``block`` frames of x
    (from the start) a call."""
    j = [0]
    cap = int(block * 1.2) + 400

    def step():
        blk = x[:, j[0] * block:(j[0] + 1) * block]
        eng.process(blk, blk.shape[1], cap, ratio_at(j[0]))
        j[0] += 1
    return step


def phase_backend_paths(dev, tag, seconds=60, block=16384):
    """Resampler(backend="torch") against backend="numpy" on a 60 s stereo
    44.1k stream in ``block``-frame calls plus the flush (preset -3 ->
    48k, the polyphase path on K1; preset -3 at 48k from 44.1k pitched up
    50 cents, interpolated, K5; preset -1 at a ratio drifting per call, as
    artest without -e, K5; preset -3 -> 48k in float64), then
    Decimator(backend="torch") against the native host decimator on the
    same stream (ATH-shaped, dithered, 16-bit).  Counts and positions
    exact, samples within 1e-5 / 1e-12, the decimator bitwise; each
    kernel's launches equal the calls the design sends to it."""
    from art_tpu_torch import Resampler
    from art_tpu_torch.core.flags import PRESETS
    on_card = dev.type == "cuda"
    x32 = roundtrip.artest_noise(seconds)
    pitch = 44100 * 2 ** (50 / 1200)
    drift = lambda j: 48000 / 44100 * (1 + 0.002 * math.sin(0.05 * j))
    cases = (
        ("preset -3 -> 48k", np.float32, "f32",
         lambda **kw: Resampler.fixed_ratio(*HEAD, **kw), lambda j: 0.0),
        ("preset -3, 44.1k +50 cents -> 48k", np.float32, "asrc_apply",
         lambda **kw: Resampler.fixed_ratio(2, 380, 380, pitch, 48000, 0,
                                            FLAGS, **kw), lambda j: 0.0),
        ("preset -1, ratio drifting per call", np.float32, "asrc_apply",
         lambda **kw: Resampler(*PRESET1, 0.9, FLAGS, **kw), drift),
        ("preset -3 -> 48k float64", np.float64, "f64",
         lambda **kw: Resampler.fixed_ratio(*HEAD, **kw), lambda j: 0.0))
    assert PRESETS[1] == PRESET1[1:] and PRESETS[3] == HEAD[1:3]
    for label, dtype, main_kernel, make, ratio_at in cases:
        x = x32.astype(dtype)
        legs = {}
        for be in ("torch", "numpy"):
            eng = make(dtype=dtype, backend=be, device=dev)
            eng.advance_position(eng.num_taps / 2.0)
            calls = {"K1": 0, "K5": 0}
            undo = _design_calls(calls)
            _reset_launches()
            try:
                out, res, secs = _resampler_stream(eng, x, block, ratio_at)
                _sync(dev)
            finally:
                undo()
            legs[be] = (out, res, secs, calls, dict(k1.instance_launches),
                        dict(kasrc.launches))
        (a, ra, sa, calls, kl, al), (b, rb, sb, _, _, _) = \
            legs["torch"], legs["numpy"]
        err = float(np.abs(a.astype(np.float64) - b).max())
        tol = 1e-12 if dtype == np.float64 else 1e-5
        inst = "f64" if dtype == np.float64 else "f32"
        apply_name = "asrc_apply_f64" if dtype == np.float64 \
            else "asrc_apply"
        print(f"  Resampler {label}: {len(ra)} calls, {a.shape[1]} output "
              f"frames each, counts and positions equal {ra == rb}, max "
              f"sample diff {err:.3e}; design K1 {calls['K1']}, K5 "
              f"{calls['K5']}; launches K1 {kl[inst]}, {apply_name} "
              f"{al[apply_name]}")
        print(f"  Resampler {label}: torch {sa:.3f} s "
              f"({a.shape[1] / sa / 1e6:.4f} M output frames/s), numpy "
              f"{sb:.3f} s ({b.shape[1] / sb / 1e6:.4f}) {tag}")
        eng = make(dtype=dtype, backend="torch", device=dev)
        eng.advance_position(eng.num_taps / 2.0)
        share = _idle_share(dev, _stepper(eng, x, block, ratio_at), 30,
                            sa * 1e3 / len(ra))
        print(f"  Resampler {label}, torch: {share} {tag}")
        _require(ra == rb, f"Resampler {label}: counts or positions differ")
        _require(np.isfinite(a).all() and err <= tol,
                 f"Resampler {label}: samples differ by {err:.3e}")
        _require(calls["K1" if main_kernel in ("f32", "f64") else "K5"] > 0,
                 f"Resampler {label}: its main kernel was not called")
        _require(not on_card or (kl[inst] == calls["K1"]
                                 and sum(kl.values()) == calls["K1"]
                                 and al[apply_name] == calls["K5"]
                                 and sum(al.values()) == calls["K5"]),
                 f"Resampler {label}: launches off the design")
        BACKEND_PATH_LAUNCHES[inst] += kl[inst]
        BACKEND_PATH_LAUNCHES[apply_name] += al[apply_name]
    _decimator_stream(dev, x32, block, tag)


def _decimator_stream(dev, x32, block, tag):
    from art_tpu_torch import Decimator, native
    _require(native.available(), "the native host runtime did not build")
    fl = HP | ATH
    frames = np.ascontiguousarray(x32.T)
    legs = {}
    for be in ("torch", "native"):
        dec = Decimator(2, 16, 2, 1.0, 44100, fl, backend=be, device=dev)
        _reset_launches()
        got, clips = [], 0
        t0 = time.perf_counter()
        for i in range(0, frames.shape[0], block):
            p, c = dec.process_interleaved(frames[i:i + block])
            got.append(p)
            clips += c
        secs = time.perf_counter() - t0
        legs[be] = (np.concatenate(got), clips, dec.state_dict(), secs,
                    dd.launches["decimate_shaped"])
    (a, ca, sa, ta, la), (b, cb, sb, tb, _) = legs["torch"], legs["native"]
    calls = -(-frames.shape[0] // block)
    same = ca == cb and all(
        _bitwise(torch.from_numpy(u), torch.from_numpy(v)) for u, v in (
            (a, b), (sa["feedback"], sb["feedback"]), (sa["tpdf"], sb["tpdf"]),
            (sa["shaper"].xh, sb["shaper"].xh),
            (sa["shaper"].yh, sb["shaper"].yh)))
    print(f"  Decimator ATH-shaped dithered 16-bit: {calls} calls, "
          f"{a.shape[0]} frames, {ca} clipped; bytes, clips, feedback, "
          f"shaper state and generators bitwise the native host's: {same}; "
          f"decimate_shaped launches {la}")
    print(f"  Decimator: torch {ta:.3f} s ({a.shape[0] / ta / 1e6:.4f} M "
          f"frames/s), native {tb:.3f} s ({b.shape[0] / tb / 1e6:.4f}) "
          f"{tag}")
    dec = Decimator(2, 16, 2, 1.0, 44100, fl, backend="torch", device=dev)
    blocks = iter(range(0, frames.shape[0], block))

    def step():
        i = next(blocks)
        dec.process_interleaved(frames[i:i + block])
    print(f"  Decimator, torch: "
          f"{_idle_share(dev, step, 30, ta * 1e3 / calls)} {tag}")
    _require(same, "Decimator(backend='torch') differs from the native host")
    _require(dev.type != "cuda" or la == calls,
             "decimate_shaped launches != Decimator calls")
    BACKEND_PATH_LAUNCHES["decimate_shaped"] += la


def _numpy_leg(key, run):
    """Phase 12's numpy leg of a command (run here when phase 12 did not)."""
    if key not in CLI_NUMPY:
        CLI_NUMPY[key] = run()
    return CLI_NUMPY[key]


def phase_backend_cli(dev, tag, seconds=60):
    """art -3 -r48k, artest -3 -e -i and artest -1 -i with
    --backend=torch beside phase 12's --backend=numpy legs, on phase 12's
    criteria; K1 and K5 launched for the calls the design sends them."""
    from art_tpu_torch.cli import art, artest
    on_card = dev.type == "cuda"
    wav, n = _cli_wav(seconds)

    def checked(main, args, what):
        calls = {"K1": 0, "K5": 0}
        undo = _design_calls(calls)
        try:
            err, secs, kl, al, _ = _run_cli(main, args, dev, "torch")
        finally:
            undo()
        print(f"  {what} --backend=torch: design K1 {calls['K1']}, K5 "
              f"{calls['K5']}; launches K1 {kl}, ASRC {al}")
        _require(not on_card or (kl["f32"] == calls["K1"] == sum(kl.values())
                                 and al["asrc_apply"] == calls["K5"]
                                 == sum(al.values())),
                 f"{what} --backend=torch: launches off the design")
        BACKEND_PATH_LAUNCHES["f32"] += kl["f32"]
        BACKEND_PATH_LAUNCHES["asrc_apply"] += al["asrc_apply"]
        return err, secs, calls

    cmd = "art -3 -r48k"
    out = CLI_DIR / "art_torch.wav"
    err, secs, calls = checked(art.main, ["-q", "-y", "-3", "-r48k", str(wav),
                                          str(out)], cmd)
    a = _wav_samples(out, "<f4")

    def numpy_art():
        ref = CLI_DIR / "art_numpy_p15.wav"
        e, s = _run_cli(art.main, ["-q", "-y", "-3", "-r48k", str(wav),
                                   str(ref)], dev, "numpy")[:2]
        return _wav_samples(ref, "<f4"), e, s
    b, eb, sb = _numpy_leg(cmd, numpy_art)
    diff = float(np.abs(a.astype(np.float64) - b).max())
    print(f"  {cmd}: {a.size // 2} frames each, max abs diff {diff:.3e}; "
          f"stderr {err.strip() or '(none)'!r}")
    _require(a.size == b.size and err == eb and calls["K1"] > 0,
             f"{cmd} --backend=torch: frames or clip warnings differ")
    _require(diff <= 1e-5, f"{cmd} --backend=torch: samples beyond 1e-5")
    _rate_line(cmd, {"torch": (secs, a.size // 2), "numpy": (sb, b.size // 2)},
               tag)

    base = ["-s44.1k", "-d48k", "-c2", "-i", f"-n{seconds}", "--timing"]
    for preset, extra in (("-3", ["-e"]), ("-1", [])):
        cmd = " ".join(["artest", preset, *base, *extra])
        err, secs, calls = checked(artest.main, [preset, *base, *extra], cmd)
        got = _artest_stats(err)
        want, nerr, nsecs = _numpy_leg(
            ("artest", preset, bool(extra)),
            lambda: _artest_numpy(artest, [preset, *base, *extra], dev))
        print(f"  {cmd}: -w5 {got['5'][1]:.2f} dB (numpy "
              f"{want['5'][1]:.2f} dB), counts "
              f"{[got[w][0] for w in sorted(got)]}")
        print(f"  {cmd} --backend=torch {_timing(err)}")
        _require({w: c for w, (c, _) in got.items()}
                 == {w: c for w, (c, _) in want.items()},
                 f"{cmd} --backend=torch: -w counts differ from numpy's")
        if extra:
            _require(got["5"][1] <= -130.0 and calls["K1"] > 0,
                     f"{cmd} --backend=torch: -w5 above -130 dB")
        else:
            _require(abs(got["5"][1] - want["5"][1]) <= 0.5
                     and calls["K5"] > 0 and calls["K1"] == 0,
                     f"{cmd} --backend=torch: -w5 more than 0.5 dB from "
                     f"numpy's")
        _rate_line(cmd, {"torch": (secs, got["2"][0]),
                         "numpy": (nsecs, want["2"][0])}, tag)


def _artest_stats(text):
    return {m.group(1): (int(m.group(2)), float(m.group(3)))
            for m in _STATS.finditer(text)}


def _artest_numpy(artest, args, dev):
    err, secs = _run_cli(artest.main, args, dev, "numpy")[:2]
    return _artest_stats(err), err, secs


def phase_backend_timing(dev, tag, n=ASRC_N, reps=10):
    """K5's float64 instance at config 5's shapes against its plain
    version, with its bound.  Returns (ms, plain_ms, (bound_ms,
    bound_by))."""
    rng = np.random.default_rng(0)
    eng = _asrc_engine(dev, ASRC_S, np.float64)
    x = torch.from_numpy(rng.standard_normal((ASRC_S, n))).to(dev)
    eng.process(x, _drift(ASRC_S, 0))
    ratios, Ks, k_max, _ = eng._plan(n, _drift(ASRC_S, 1), None)
    args = _step_args(eng, eng.hist, x, eng._bank_dev, ratios, Ks)
    buf, base, fi, frac, _ = kasrc.apply_prologue(
        eng.hist, x, args[3], args[4], args[6], num_taps=eng.num_taps,
        num_filters=eng.num_filters, k_max=k_max, hist_len=eng.num_samples)
    bank = eng._bank_dev
    med = _time_in_turns(dev, {
        "plain apply f64": lambda: kasrc.asrc_apply_reference(
            buf, bank, base, fi, frac),
        "apply kernel f64": lambda: kasrc.asrc_apply(buf, bank, base, fi,
                                                     frac)},
        ["plain apply f64", "apply kernel f64", "apply kernel f64",
         "plain apply f64"], reps, "per call (f64)", tag)
    S = ASRC_S
    bound = _bound_ms(8 * (buf.numel() + 2 * S * k_max + eng.bank.size)
                      + 4 * 2 * S * k_max, 4 * S * k_max * eng.num_taps,
                      PEAK_F64)
    print(f"  asrc_apply f64 bound {bound[0]:.4f} ms ({bound[1]}-bound; "
          f"{S * k_max} outputs, unmasked)")
    return med.get("apply kernel f64"), med["plain apply f64"], bound


# ------------------------------------------------- the decimate stage's A/B
def decimate_ab(parent):
    """The decimate stage against an older tree unpacked in ``parent``
    (git archive into build/parent/): this script is copied there as
    chip_smoke_new.py, and decimate_times runs in four processes, one a
    turn, in the order parent, change, change, parent (each process
    imports its own tree's package and builds its own library); the
    hashes of every turn must be equal."""
    here = Path(__file__).resolve()
    parent = Path(parent).resolve()
    _require((parent / "art_tpu_torch").is_dir(),
             f"no art_tpu_torch in {parent}")
    shutil.copy(here, parent / "chip_smoke_new.py")
    script = {"parent": parent / "chip_smoke_new.py", "change": here}
    turns = []
    for name in ("parent", "change", "change", "parent"):
        r = subprocess.run([sys.executable, str(script[name]),
                            "--decimate-times"], cwd=script[name].parent,
                           capture_output=True, text=True, timeout=900)
        _require(r.returncode == 0, f"the {name} turn failed:\n"
                 f"{r.stdout[-3000:]}{r.stderr[-3000:]}")
        turns.append((name, json.loads(r.stdout.strip().splitlines()[-1])))
        print(f"  turn {len(turns)}, {name}: {json.dumps(turns[-1][1])}")
    for case in turns[0][1]["times"]:
        runs = [f"{name} {t['times'][case]}" for name, t in turns]
        print(f"  {case}: {', '.join(runs)}")
    hashes = [t["hashes"] for _, t in turns]
    same = all(h == hashes[0] for h in hashes)
    print(f"  hashes equal in all four turns: {same}")
    _require(same, "the decimate stage's bytes differ from the parent's")


# ------------------------------------------------- the biquad cascade's A/B
BQ_AB_DIR = Path(__file__).resolve().parent / "build" / "biquad_ab"


def biquad_ab(parent):
    """The biquad cascade against an older tree unpacked in ``parent``
    (git archive into build/parent/): this script is copied there as
    chip_smoke_new.py, and biquad_times runs in four processes, one a
    turn, in the order parent, change, change, parent (each process
    imports its own tree's package and builds its own library), each
    saving its outputs under build/biquad_ab/turn<i>/; a tree's outputs
    must be bitwise equal in its two turns, and the change's within the
    class of the parent's."""
    here = Path(__file__).resolve()
    parent = Path(parent).resolve()
    _require((parent / "art_tpu_torch").is_dir(),
             f"no art_tpu_torch in {parent}")
    shutil.copy(here, parent / "chip_smoke_new.py")
    script = {"parent": parent / "chip_smoke_new.py", "change": here}
    shutil.rmtree(BQ_AB_DIR, ignore_errors=True)
    turns = []
    for i, name in enumerate(("parent", "change", "change", "parent")):
        out = BQ_AB_DIR / f"turn{i}"
        r = subprocess.run([sys.executable, str(script[name]),
                            "--biquad-times", str(out)],
                           cwd=script[name].parent, capture_output=True,
                           text=True, timeout=900)
        _require(r.returncode == 0, f"the {name} turn failed:\n"
                 f"{r.stdout[-3000:]}{r.stderr[-3000:]}")
        turns.append((name, json.loads(r.stdout.strip().splitlines()[-1])))
        print(f"  turn {i + 1}, {name}: {json.dumps(turns[-1][1])}")
    for case in turns[0][1]:
        runs = [f"{name} {t[case]:.4f}" for name, t in turns]
        print(f"  {case}: {', '.join(runs)}")
    files = sorted(p.name for p in (BQ_AB_DIR / "turn0").glob("*.npy"))
    _require(bool(files), "the biquad A/B saved no outputs")
    same = within = True
    for f in files:
        o = [np.load(BQ_AB_DIR / f"turn{i}" / f) for i in range(4)]
        same &= o[0].tobytes() == o[3].tobytes()
        same &= o[1].tobytes() == o[2].tobytes()
        within &= (o[1].shape == o[0].shape and o[1].dtype == o[0].dtype
                   and _bq_within(torch.from_numpy(o[1]),
                                  torch.from_numpy(o[0]))[1])
    print(f"  outputs ({len(files)} tensors): bitwise equal within a tree "
          f"{same}; the change within the class of the parent {within}")
    _require(same and within, "the biquad A/B's outputs")


def _kernel_entry(name, source, replaces, launches, err, ms, plain_ms,
                  bound, library_ms=None, device_ms=None):
    """One entry of the kernels line: ``ms`` is a call's time with CUDA
    events; ``device_ms`` the kernel's device time with the L2 flushed
    (torch.profiler) where it was taken, else null."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
            "bound_by": bound[1], "library_ms": library_ms,
            "device_ms": device_ms}


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test runs only on an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    if argv[1:] == ["--checksum"]:
        k1_checksums(dev)
        return 0
    if argv[1:] == ["--profile-biquad"]:
        print(phase_device()[2])
        profile_biquad(dev)
        return 0
    if argv[1:] == ["--decimate-times"]:
        print(json.dumps({"times": decimate_times(dev),
                          "hashes": decimate_hashes(dev)}))
        return 0
    if argv[1:2] == ["--decimate-ab"] and len(argv) == 3:
        print(phase_device()[2])
        decimate_ab(argv[2])
        return 0
    if argv[1:2] == ["--biquad-times"] and len(argv) == 3:
        print(json.dumps(biquad_times(dev, save=argv[2])))
        return 0
    if argv[1:2] == ["--biquad-ab"] and len(argv) == 3:
        print(phase_device()[2])
        biquad_ab(argv[2])
        return 0
    t_start = time.perf_counter()
    print("phase 1: device")
    kind, count, tag = phase_device()
    print("phase 2: build")
    phase_build()
    print("phase 3: K1 vs plain PyTorch on the card")
    worst = {"fixed_step": phase_kernel_vs_plain(dev)}
    k1_checksums(dev)
    print("phase 4: K6 (polyphase_apply) vs plain PyTorch, its entry point")
    launches = {}
    launches["polyphase_apply"], worst["polyphase_apply"] = \
        phase_polyphase(dev)
    print("phase 5: ASRC kernels vs plain PyTorch on the card, config 5")
    worst.update(phase_asrc_kernels_vs_plain(dev))
    print("phase 6: fixed-ratio paths: the 60 s round trip through the "
          "headline path, BASELINE config 1 through every form, the "
          "headline group forms against sequential process()")
    fixed = {"round trip": phase_roundtrip(dev)[0],
             "config 1": phase_interp_path(dev),
             "group forms": phase_group_forms(dev)}
    launches["fixed_step"] = sum(fixed.values())
    print(f"  K1 launches on the fixed-ratio paths: {fixed}")
    print("phase 7: ASRC paths, config 5 through process()/flush(mask)")
    for key, dtype, kernel, calls in (
            ("asrc_step", np.float32, "auto", 30),
            ("asrc_step_f64", np.float64, "auto", 8),
            ("asrc_apply", np.float32, "pallas", 6)):
        launches[key], err = phase_asrc_path(dev, dtype, kernel, calls)
        worst[key] = max(worst[key], err)
    print("phase 8: throughput")
    med = phase_throughput(dev, tag)
    phase_interp_timing(dev, tag)
    rates = phase_group_throughput(dev, tag)
    print(f"  preset -3 process_flat_packed int16 "
          f"{rates['preset -3 packed'][0]:.2f} beside process_flat_out "
          f"delivered {rates['preset -3 delivered'][0]:.2f} M output "
          f"frames/s {tag}")
    poly = phase_polyphase_timing(dev, tag)
    timed = phase_asrc_throughput(dev, tag)
    print("phase 9: precision tiers, K1's instances vs plain PyTorch on the "
          "card")
    tier_err = phase_tier_kernels(dev)
    print("phase 10: precision tiers' paths: precise='int8' through the "
          "headline sequence and every group form, config 4's float64 data, "
          "the round trip in precise=True and 'int8'")
    tier_launches, tier_db = phase_tier_paths(dev)
    print(f"  K1 launches on the tiers' paths: {tier_launches}; round trip "
          f"precise=True {tier_db[True]:.2f} dB, 'int8' "
          f"{tier_db['int8']:.2f} dB")
    _require(dev.type != "cuda" or all(tier_launches.values()),
             "a tier's K1 instance was not launched on its path")
    print("phase 11: precision tiers' throughput")
    tier_timed = phase_tier_timing(dev, tag)
    print("phase 12: the CLIs on the card: art and artest --backend=cuda "
          "beside --backend=numpy")
    cli = phase_cli(dev, tag)
    print(f"  the CLIs' launches: {cli}")
    launches["fixed_step"] += cli["fixed_step"]
    launches["asrc_step"] += cli["asrc_step"]
    tier_launches["f32_acc64"] += cli["fixed_step_f32_acc64"]
    print("phase 13: device decimate: the kernels vs plain PyTorch, "
          "DeviceDecimator vs the native host over 60 s, pipeline_chunk, "
          "times")
    phase_decimate_geometry(dev)
    worst.update(phase_decimate_kernels(dev))
    for label, digest in decimate_hashes(dev).items():
        print(f"  sha256 {label}: {digest}")
    phase_decimate_paths(dev)
    print(f"  the decimate kernels' launches on the main paths: "
          f"{DEC_PATH_LAUNCHES}")
    _require(dev.type != "cuda" or all(DEC_PATH_LAUNCHES.values()),
             "a decimate kernel was not launched on its paths")
    dec_timed = phase_decimate_timing(dev, tag)
    print("phase 14: the biquad cascade: the kernel vs plain PyTorch, "
          "DeviceBiquadCascade vs the native host over 60 s, BASELINE "
          "config 4b's chain, pipeline_chunk with -p, art -r96k -p, times")
    worst["biquad"] = phase_biquad_kernels(dev)
    phase_biquad_paths(dev)
    _cli_post_filter(dev, tag)
    print(f"  the biquad kernel's launches on the main paths: "
          f"{BIQUAD_PATH_LAUNCHES}")
    _require(dev.type != "cuda" or BIQUAD_PATH_LAUNCHES["biquad"] > 0,
             "the biquad kernel was not launched on its paths")
    bq_timed = phase_biquad_timing(dev, tag)
    print("phase 15: host-engine backends: K5's float64 instance vs plain "
          "PyTorch, Resampler and Decimator(backend='torch') over 60 s, "
          "art and artest --backend=torch, times")
    worst["asrc_apply_f64"] = 0.0
    for key, err in phase_backend_kernels(dev).items():
        worst[key] = max(worst[key], err)
    phase_backend_paths(dev, tag)
    phase_backend_cli(dev, tag)
    print(f"  the kernels' launches on the host-engine paths: "
          f"{BACKEND_PATH_LAUNCHES}")
    _require(dev.type != "cuda" or all(BACKEND_PATH_LAUNCHES.values()),
             "a kernel was not launched on the host-engine paths")
    launches["fixed_step"] += BACKEND_PATH_LAUNCHES["f32"]
    tier_launches["f64"] += BACKEND_PATH_LAUNCHES["f64"]
    launches["asrc_apply"] += BACKEND_PATH_LAUNCHES["asrc_apply"]
    DEC_PATH_LAUNCHES["decimate_shaped"] += \
        BACKEND_PATH_LAUNCHES["decimate_shaped"]
    timed["asrc_apply_f64"] = phase_backend_timing(dev, tag)
    launches["asrc_apply_f64"] = BACKEND_PATH_LAUNCHES["asrc_apply_f64"]
    src = "art_tpu_torch/csrc/"
    pk = "art_tpu/ops/pallas_kernels.py:"
    kernels = [_kernel_entry(
        "fixed_step", src + "fixed_step.cu", "art_tpu/ops/fixed_pallas.py:108",
        launches["fixed_step"], worst["fixed_step"], med["K1 step"],
        med["plain step"], med["bound"], med["conv1d library"])]
    for key, replaces in (("asrc_step", pk + "567 and :355"),
                          ("asrc_step_f64", pk + "805"),
                          ("asrc_apply", pk + "82"),
                          # JAX runs the float64 apply as XLA code
                          ("asrc_apply_f64",
                           "art_tpu/ops/resample_kernel.py:135")):
        ms, plain_ms, bound = timed[key]
        kernels.append(_kernel_entry(key, src + "asrc_step.cu", replaces,
                                     launches[key], worst[key], ms, plain_ms,
                                     bound))
    kernels.append(_kernel_entry(
        "polyphase_apply", src + "fixed_step.cu", pk + "963",
        launches["polyphase_apply"], worst["polyphase_apply"],
        poly["K6 kernel"], poly["K6 plain"], poly["bound"],
        poly["conv1d library"]))
    # JAX computes the tiers as XLA dots (residue_window_dots, precise)
    for inst in ("f32_acc64", "f64"):
        ms, plain_ms, bound, lib_ms = tier_timed[inst]
        kernels.append(_kernel_entry(
            f"fixed_step_{inst}", src + "fixed_step.cu",
            "art_tpu/parallel/pipeline.py:39", tier_launches[inst],
            tier_err[inst], ms, plain_ms, bound, lib_ms))
    for key, line in (("decimate_flat", 113), ("decimate_shaped", 131)):
        ms, device_ms, plain_ms, bound = dec_timed[key]
        kernels.append(_kernel_entry(
            key, src + "decimate.cu",
            f"art_tpu/ops/decimate_device.py:{line}",
            DEC_PATH_LAUNCHES[key], worst[key], ms, plain_ms, bound,
            device_ms=device_ms))
    ms, device_ms, plain_ms, bound = bq_timed
    kernels.append(_kernel_entry(
        "biquad", src + "biquad.cu", "art_tpu/ops/biquad_kernel.py:206",
        BIQUAD_PATH_LAUNCHES["biquad"], worst["biquad"], ms, plain_ms, bound,
        device_ms=device_ms))
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
