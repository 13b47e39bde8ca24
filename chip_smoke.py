#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``art_tpu_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Drives the port's main path -- the reduced float32 fixed-ratio streaming
resampler, preset -3 (2 channels, 380 taps, 44.1k<->48k) -- on the card, in
phases; any failure raises and exits non-zero:

1. device: the card's name, count, and nvidia-smi's name and power limit;
2. build: kernel K1 (art_tpu_torch/csrc/fixed_step.cu) from the checkout;
3. K1 against its plain PyTorch version on the card, at the main path's
   shapes (~2^22-frame stereo chunks) and its edge cases: max abs error vs
   the float64 plain version <= 1e-5, a zero tail past K, the new history
   bitwise equal;
4. the main path: a 60 s artest round trip (forward then inverse) through
   DeviceStreamResampler.process()/flush() on the card, <= -130 dB and
   no more than 3 dB above the same stream on the CPU (plain path); K1's
   launch count equals the number of process()/flush() calls;
5. throughput: three windows of 8 chunks of ~2^22 frames through
   process(x, n, acc), the host's planning time per chunk, and K1's step
   against the plain step in ms per chunk, timed in turns with CUDA events.

Prints a {"kernels": [...]} line, then, last, the {"ok": true, "device":
...} line.  Without a usable CUDA device it exits 2 and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from art_tpu_torch import (BLACKMAN_HARRIS, INCLUDE_LOWPASS,
                           SUBSAMPLE_INTERPOLATE, DeviceStreamResampler,
                           roundtrip)
from art_tpu_torch.ops import _build
from art_tpu_torch.ops import fixed_step as k1

# bench.py's headline configuration (preset -3); the planner reduces it
FLAGS = SUBSAMPLE_INTERPOLATE | BLACKMAN_HARRIS | INCLUDE_LOWPASS


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


def phase_build():
    t0 = time.perf_counter()
    _build.library()
    print(f"build: K1 built and loaded in {time.perf_counter() - t0:.2f} s")
    for line in _build.build_log.splitlines():
        if "ptxas" in line or "spill" in line:
            print(f"  {line.strip()}")


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
    cases.append(("interp fracv 48/48 taps", noise(2, H), noise(2, n), P2,
                  fracv, 100, K, dict(M=M, L=L, nb=-(-K // L), qn=qn,
                                      hist_len=H)))
    return cases


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
        print(f"  {label}: out {tuple(out.shape)}; max|K1 - f64 plain| = "
              f"{err:.3e} (f32 plain: {err32:.3e}); acc rel err "
              f"{acc_rel:.2e}; tail zero {tail0}; new_hist bitwise {hist_eq}")
        _require(finite and err <= 1e-5 and tail0 and hist_eq,
                 f"K1 vs plain, {label}")
        worst = max(worst, err)
    return worst


def phase_roundtrip(dev, seconds=60):
    """The main path.  Returns K1's launch count during it."""
    k1.launches = 0
    t0 = time.perf_counter()
    rt = roundtrip.roundtrip_diff_db(seconds, dev)
    secs = time.perf_counter() - t0
    launches = k1.launches
    rt_cpu = roundtrip.roundtrip_diff_db(seconds, "cpu")
    print(f"  round trip {seconds} s stereo: {rt['diff_db']:.2f} dB on "
          f"{dev} (K1 path, {secs:.2f} s wall incl. matrix builds), "
          f"{rt_cpu['diff_db']:.2f} dB on cpu (plain path); output frames "
          f"{rt['frames']} vs {rt_cpu['frames']}")
    print(f"  K1 launches {launches}, process()/flush() calls "
          f"{rt['calls']}")
    _require(rt["frames"] == rt_cpu["frames"], "output counts differ")
    _require(rt["diff_db"] <= -130.0, "round trip above -130 dB")
    # one-sided: K1 sums each dot in blocks of 32 terms and lands below the
    # CPU's sgemm order; the gate catches a kernel path that is worse
    # (a TF32 leak would land far above -100 dB)
    _require(rt["diff_db"] <= rt_cpu["diff_db"] + 3.0,
             "kernel-path round trip more than 3 dB above the plain path")
    _require(dev.type != "cuda" or launches == rt["calls"] > 0,
             "K1 launches != process()/flush() calls")
    return launches


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
    variants = {
        "K1 step": lambda: k1.fixed_step(hist, x, P, start, K, zero, **kw),
        "plain step": lambda: k1.fixed_step_reference(hist, x, P, start, K,
                                                      zero, **kw),
        "K1 kernel only": lambda: k1.fixed_step_kernel(
            buf, P, start, K, M=kw["M"], L=kw["L"], nb=kw["nb"],
            qn=kw["qn"]),
    }
    order = ["plain step", "K1 step", "K1 kernel only", "K1 kernel only",
             "K1 step", "plain step"]
    if dev.type != "cuda":          # CPU rehearsal: the kernel cannot run
        del variants["K1 kernel only"]
        order = [name for name in order if name in variants]
    for fn in variants.values():
        fn()
    times = {name: [] for name in variants}
    for _ in range(2):
        for name in order:
            times[name].append(_time_ms(dev, variants[name], reps))
    med = {name: sorted(t)[len(t) // 2] for name, t in times.items()}
    for name, t in times.items():
        print(f"  {name}: {med[name]:.4f} ms per {n}-frame chunk "
              f"(runs {', '.join(f'{v:.4f}' for v in t)}) {tag}")
    return med


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test runs only on an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print("phase 1: device")
    name, count, tag = phase_device()
    print("phase 2: build")
    phase_build()
    print("phase 3: K1 vs plain PyTorch on the card")
    worst = phase_kernel_vs_plain(dev)
    print("phase 4: main path, 60 s round trip through process()/flush()")
    launches = phase_roundtrip(dev)
    print("phase 5: throughput")
    med = phase_throughput(dev, tag)
    print(json.dumps({"kernels": [{
        "name": "fixed_step", "route": "cuda",
        "source": "art_tpu_torch/csrc/fixed_step.cu",
        "replaces": "art_tpu/ops/fixed_pallas.py:108",
        "launches": launches, "max_abs_err": worst,
        "ms": med["K1 step"], "plain_ms": med["plain step"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
