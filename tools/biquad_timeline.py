#!/usr/bin/env python3
"""The biquad kernel's timeline on the card: when each CTA of one launch at
BASELINE config 4b's chunk (6 x 524,320 float64, the combined -p section)
reaches each phase of art_tpu_torch/csrc/biquad.cu.

    python3 tools/biquad_timeline.py      # needs one NVIDIA card and nvcc

A copy of biquad.cu under build/biquad_timeline/ gets a %globaltimer read
at each phase boundary (after the ticket, the span staged, the zero-state
run, the CTA's scan barrier, u_j published, E_j known, the entering state,
the rerun, the stores) from lane 0 of warps 0, 1, 2 and 7, is built with
nvcc beside the package's own header, and runs through the package's entry
point.  Each anchor must match the source once; the tool fails when the
kernel no longer has it.  Prints, for each phase, the min / median / max
microseconds from the launch's first CTA, then the card's name and power
limit.  The instrumented copy is not the kernel the port runs: its times
show where a launch's time goes, the kernel's own times are chip_smoke.py's.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from art_tpu_torch.engines.biquad import Biquad, biquad_lowpass  # noqa: E402
from art_tpu_torch.ops import _build  # noqa: E402
from art_tpu_torch.ops import biquad_kernel as bk  # noqa: E402

OUT = ROOT / "build" / "biquad_timeline"
PHASES = ["start", "ticket", "staged", "zero-state run", "scan barrier",
          "u_j published", "E_j known", "entering state", "rerun",
          "stored"]
WARPS = (0, 1, 2, 7)

PRELUDE = '''
__device__ unsigned long long g_timeline[1 << 20];
__device__ __forceinline__ unsigned long long gtime() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
}
#define MARK(k) do { \\
    const int wi = warp == 0 ? 0 : warp == 1 ? 1 : warp == 2 ? 2 \\
                 : warp == 7 ? 3 : -1; \\
    if (lane == 0 && wi >= 0) \\
        g_timeline[(ticket_s * 4 + wi) * 16 + (k)] = gtime(); \\
} while (0)
'''

# (anchor, text inserted after it)
MARKS = [
    ("    const int q = threadIdx.x, lane = q & 31, warp = q >> 5;\n",
     "    const unsigned long long t_start = gtime();\n"),
    ("    const long long j = ticket_s / p.S;\n",
     "    MARK(1);\n    if (lane == 0 && (warp < 3 || warp == 7))\n"
     "        g_timeline[(ticket_s * 4 + (warp == 7 ? 3 : warp)) * 16] ="
     " t_start;\n"),
    ("    stage_warp<T>(p, s, base, lane, wstage);\n", "    MARK(2);\n"),
    ("    run<false>(blk, f0, p, s, xp, z);                    // z = v_q\n",
     "    MARK(3);\n"),
    ("    __syncthreads();\n    if (warp == kBqWarps - 1 && lane < 4) {\n",
     ""),
    ("        exch128(record(p, j, s) + kRecU + 2 * r, "
     "__double_as_longlong(u),\n                p.epoch);\n",
     "        if (r == 0) g_timeline[ticket_s * 64 + 5] = gtime();\n"),
    ("        look_back(p, j, s, lane, E);\n", "        MARK(6);\n"),
    ("    matvec_acc_s(mt, lane, d, xw);\n", "    MARK(7);\n"),
    ("    run<true>(blk, f0, p, s, xp, xw);\n", "    MARK(8);\n"),
    ("    store_warp<T, false>(p, s, base, lane, wstage);\n",
     "    MARK(9);\n"),
]


def instrumented(src: str) -> str:
    for anchor, text in MARKS:
        if src.count(anchor) != 1:
            raise SystemExit(f"biquad_timeline: anchor not found once in "
                             f"biquad.cu:\n{anchor}")
        src = src.replace(anchor, anchor + text)
    # the scan barrier: after the CTA's second __syncthreads
    barrier = "    __syncthreads();\n    if (warp == kBqWarps - 1 && lane < 4) {\n"
    src = src.replace(barrier, barrier.replace(
        "__syncthreads();\n", "__syncthreads();\n    MARK(4);\n"))
    src = src.replace("namespace {\n\ntypedef", PRELUDE + "namespace {\n\ntypedef",
                      1)
    return src + '''
extern "C" int art_biquad_timeline(void* dst, long long words) {
    return cudaMemcpyFromSymbol(dst, g_timeline, words * 8);
}
'''


def build() -> ctypes.CDLL:
    OUT.mkdir(parents=True, exist_ok=True)
    src = OUT / "biquad.cu"
    src.write_text(instrumented((_build.CSRC / "biquad.cu").read_text()))
    so = OUT / "libbiquad_timeline.so"
    r = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-shared",
                        "-I", str(_build.CSRC), "-o", str(so), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"nvcc failed:\n{r.stdout}{r.stderr}")
    lib = ctypes.CDLL(str(so))
    fn = lib.art_biquad_cascade
    fn.argtypes = _build._SIGNATURES["art_biquad_cascade"]
    fn.restype = ctypes.c_int
    lib.art_biquad_timeline.argtypes = [ctypes.c_void_p, ctypes.c_longlong]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("biquad_timeline: needs an NVIDIA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    lib = build()
    _build._lib = lib       # the package's entry point launches the copy
    q = Biquad.init(biquad_lowpass(0.45 * 44100 / 48000), 1.0, 1)
    a, b = bk.combine_biquads(q, q)
    S, n = 6, 524320
    g = torch.Generator(device="cpu").manual_seed(88)
    x = (torch.randn((S, n), generator=g, dtype=torch.float64)
         * 0.25).to(dev)
    z = torch.zeros((4, S), dtype=torch.float64, device=dev)
    sec = bk._prepare(a, b, None, dev)
    for _ in range(3):
        bk._solve(x.T, sec, z, z, n, True)
    torch.empty(1 << 25, device=dev).zero_()        # flush the L2
    torch.cuda.synchronize()
    bk._solve(x.T, sec, z, z, n, True)
    torch.cuda.synchronize()
    spans = bk.library_geometry(n, S, n, torch.float64)["launch"]["ctas"]
    buf = np.zeros(spans * 4 * 16, np.uint64)
    if lib.art_biquad_timeline(buf.ctypes.data, buf.size):
        raise SystemExit("biquad_timeline: cudaMemcpyFromSymbol failed")
    t = buf.reshape(spans, 4, 16).astype(np.int64)
    t0 = t[:, :, 0].min()
    print(f"biquad_span_kernel<double>, {spans} CTAs, config 4b's chunk: "
          f"{(t[:, :, 9].max() - t0) / 1e3:.2f} us from the first CTA's "
          f"start to the last store (us from the first start: min / "
          f"median / max)")
    for w, warp in enumerate(WARPS):
        for k, phase in enumerate(PHASES):
            if k == 0 or (k in (5, 6) and warp != 0):
                continue
            v = (t[:, w, k] - t0) / 1e3
            print(f"  warp {warp} {phase:>15}: {v.min():7.2f} "
                  f"{np.median(v):7.2f} {v.max():7.2f}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
