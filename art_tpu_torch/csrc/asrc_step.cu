// The batched drifting-ratio ASRC step for NVIDIA Hopper (sm_90a).
//
// Replaces four Pallas kernels of art_tpu/ops/pallas_kernels.py that compute
// one function, split on the TPU only by Mosaic's gather limits:
//   K2 asrc_step_hankel    (_asrc_hankel_kernel, near-1 ratios, float32),
//   K3 asrc_step_dense     (_asrc_dense_kernel, general ratios, float32),
//   K4 asrc_step_hankel_ds (_asrc_hankel_ds_kernel, float64 audio and bank
//                           as paired-float32 planes),
// which asrc_step<float> / asrc_step<double> serve (H100 has native FP64),
// and
//   K5 asrc_apply_pallas   (_asrc_kernel, the windowed two-phase dot from
//                           precomputed base/fi/frac), served by asrc_apply
//                           in float32, and in float64 for the float64
//                           host Resampler(backend="torch"), whose JAX
//                           counterpart runs ops/resample_kernel.py::
//                           apply_jax's gather and dot in float64.
// All four are instances of one template, asrc_step_kernel<T, kTwo>,
// whose positions are computed (the step) or given (kTwo, the apply).
//
// What asrc_step computes (the body of art_tpu/parallel/asrc.py::_asrc_step),
// for each stream s and output k < k_max, with buf = hist ++ x per stream:
//
//   pos  = off[s] + k / ratio[s]                  float64, IEEE division
//   ipos = floor(pos);  ff = (pos - ipos) * F
//   fi   = min(floor(ff), F - 1);  frac = ff - fi (rounded to T)
//   base = ipos - T/2 + 1 + shift
//   out[s, k] = sum_t buf[s, base + t] * ((1 - frac) bank[fi, t] + frac bank[fi + 1, t])
//
// and out[s, k] = 0 for k >= Ks[s].  Reads of buf are clamped to the buffer
// as JAX's take_along_axis clip does (a valid output's window lies inside it).
// fi + 1 reaches row F, the rotated extra filter.  The position chain uses
// __ddiv_rn / __dadd_rn / __dsub_rn / __dmul_rn, which nvcc never contracts
// into an FMA, so fi, frac and base equal the plain version's bit for bit.
// asrc_apply computes, from given base/fi/frac [S, K] over one buffer
// buf [S, B],
//   out[s, k] = (1 - frac) sum_t buf[s, base + t] bank[fi, t]
//             +      frac  sum_t buf[s, base + t] bank[fi + 1, t]
// unmasked (the caller masks), as the K5 body does: dot, then lerp.
//
// What bounds it.  At BASELINE config 5 (256 streams, 380 taps, 380 filters,
// 32768-frame chunks, ratios 1 +- 1%) one call makes ~8.39M outputs of 380
// taps, two FMAs per tap (the lerp and the dot): ~12.8 GFLOP, ~0.19 ms at the
// 67 TFLOP/s float32 rate of an H100 SXM (also ~0.19 ms in float64 at the
// 67 TFLOP/s of its FP64 tensor cores; this kernel runs on the CUDA cores,
// 0.38 ms), against ~75 MB of history, input and output (~0.02 ms at
// 3.35 TB/s); that is arithmetic from shapes and the data sheet.  asrc_apply
// computes all 8.91M outputs (k_max 34,816), unmasked: ~0.20 ms.  What
// bounds a kernel that keeps the bank on chip is the SM's data path to
// shared memory and L1, 128 B/clk: every output-tap reads two bank values
// (8 B in float32, 16 B in float64) and one window value, ~3.19G
// output-taps a call, so ~25.5 GB (float32) or ~51 GB (float64) of bank
// reads alone, ~0.76 ms and ~1.5 ms at 132 SMs x 128 B/clk x 1.98 GHz.
// The first kernel of this file (one warp per output, both bank rows
// gathered from L2 for every output, a shuffle reduction per output) took
// 2.99 ms per float32 step, 7.19 ms per float64 step and 3.29 ms per apply
// on an H100 80GB HBM3 at 700 W; PERF.md has this design's times and what
// holds them (the window's reads and the per-run set-up come on top of the
// bank's).
//
// Design.
//   - The bank [F + 1, taps] (579 KB in float32 at config 5) does not fit
//     the 227 KB of shared memory a block may use, so it passes through in
//     tap pieces: all F + 1 rows over a piece's P taps and the X taps that
//     follow it (wrapping to tap 0), at row stride E = P + X, two buffers,
//     piece p + 1 copied with cp.async while piece p is used.  At config 5
//     P = X = 32 in float32 and 16 in float64: 97.5 KB a buffer.  The host
//     picks P and X from (taps, F, dtype) (ops/asrc_step.py::step_geometry;
//     asrc_apply takes the geometry of its type).
//   - A block owns a run of consecutive outputs of one stream, 8 per thread
//     in float32 and 6 in float64 (384 threads: runs of 3072 and 2304), each
//     thread keeping its outputs' phase row, window start and sum (step: and
//     fraction; apply: two sums, one per phase row) in registers across the
//     piece loop, so the whole bank crosses L2 once per run (~1.3 GB per
//     float32 call, not ~25 GB).  With 384 threads a thread may hold 168
//     registers, which these slots need without a spill.  No shuffle
//     reduction: a thread sums its output's taps piece by piece (float32: a
//     partial sum per piece, then added to the total; float64: one sum), so
//     the result does not depend on timing.  The apply lerps its two sums
//     once, after the last piece, reading frac then.
//   - The lanes of a warp read different phase rows at once, so their bank
//     reads are laid out by lane: the lane with offset o = X - kVec (1 +
//     l % 8) reads entries o .. o + P - 1 of its rows, four at a time in
//     16-byte loads (kVec = 4 float32 or 2 float64 values).  With X one
//     wavefront of values and E a multiple of it, the 8 lanes of a
//     quarter-warp read 8 different 16-byte columns whatever their rows: no
//     bank conflicts.  Such a lane reads taps o .. o + P - 1 of the piece,
//     the last X - o of them from the X that follow, and the last pieces'
//     reads wrap to tap 0, so each output sums all its taps once.
//   - Lane l takes output kVec (l % 8) + ... of its warp's 32 (see lk), so
//     that output + o is nearly the same for every lane near ratio 1 and the
//     lanes' window reads meet on one or two 128-byte lines.
//   - The run's windows [wlo, whi) are staged once in the shared memory the
//     bank leaves (37 KB at config 5: 9344 float32 or 4672 float64 values,
//     a run at ratio >= ~0.4 or ~0.6), read from hist and x with the reads
//     clamped to the buffer as JAX's take_along_axis clip.  A run whose
//     windows do not fit reads them in place through L1 (__ldg) from hist
//     and x, no concat, whatever the ratio: a warp whose piece windows lie
//     wholly in hist or wholly in x reads them straight, the few pieces
//     that cross the seam take clamped reads.  The step's positions grow
//     with k, so its span is the first and last output's; the apply takes
//     any bases, clamped to [0, B - taps] as the first kernel did, and
//     finds its span with a block reduction.  Its buf is one row (hist =
//     buf, no x) that holds every clamped window, so it needs neither the
//     seam nor the clamped reads.
//   - Outputs at k >= Ks[s] are written as 0 without being computed: a run
//     wholly past Ks[s] writes its zeros and returns, a warp skips its slots
//     past Ks[s], and lanes past it inside a slot repeat the last valid
//     output's position (so their window stays in the buffer) and store 0.
//     The apply's Ks is K for every stream.
//   - The float64 position chain is the first kernel's (__d*_rn), so fi,
//     frac and base stay the plain version's bit for bit; it runs once per
//     slot in a loop whose results are parked in shared memory, so that the
//     division's slow-path call finds few live registers.  Offsets into
//     hist, x and out are 64-bit; a stream's hist ++ x must be shorter than
//     2^31 values.
//   - One template, not a second kernel: the apply instance is the step's
//     with its positions loaded and two sums.  Every instance takes the
//     step's scalar arguments with the apply's three pointers appended:
//     the float64 step sits at its 168-register cap, and passing the
//     positions' pointers in a struct tipped it into a spill.
// The TPU kernels' workarounds are not carried over: no double-single
// position or bank planes, no Hankel carry/roll tiers or hankel_smax bounds,
// no one-hot coarse alignment, no transposed lane-padded bank tables, no
// fold_low, no pack_step_scalars, no S % 8 geometry.  One kernel takes any S,
// any positive ratio and any (taps, F) that resampleInit allows.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

// threads per block and outputs per thread (slots): 384 threads, so that a
// thread may hold 168 registers, and 8 float32 or 6 float64 slots, the
// most whose state those registers hold without spilling
constexpr int kStepThreads = 384;
constexpr int kStepWarps = kStepThreads / 32;
template <typename T>
constexpr int kStepSlots = sizeof(T) == 4 ? 8 : 6;
template <typename T>
constexpr int kStepRun = kStepThreads * kStepSlots<T>;  // outputs per block
constexpr long long kMaxSmem = 232448;    // shared memory a block may use

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Piece p of the bank into buf: row j, entry c < pc + X is bank[j, (p0 + c)
// mod taps] (the piece's pc taps and the X that follow, wrapping to tap 0;
// X <= taps, so it wraps at most once), at row stride E, in 16-byte copies
// (p0, pc, X and taps are multiples of 4 and rows start 16-byte aligned),
// as one cp.async group.  Each thread copies one 16-byte column of every
// rows_per_pass-th row (the host keeps a row's copies within one pass).
template <typename T>
__device__ __forceinline__ void stage_piece(T* buf, const T* __restrict__ bank,
                                            int taps, int F, int E, int X,
                                            int p0, int pc) {
    constexpr int kVec = 16 / sizeof(T);
    const int per_row = (pc + X) / kVec;
    const int rows_per_pass = kStepThreads / per_row;
    const int tid = threadIdx.x;
    const int c = (tid % per_row) * kVec;
    const int t = p0 + c < taps ? p0 + c : p0 + c - taps;
    if (tid < rows_per_pass * per_row)
        for (int j = tid / per_row; j <= F; j += rows_per_pass)
            cp_async16(buf + j * E + c,
                       bank + static_cast<long long>(j) * taps + t);
    cp_async_commit();
}

enum PieceMode { kLinear, kWrap, kClamped };

// Four consecutive bank entries from shared memory in 16-byte loads (one
// float4, two double2; p is 16-byte aligned).
__device__ __forceinline__ void lds4(const float* p, float (&v)[4]) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void lds4(const double* p, double (&v)[4]) {
    const double2 a = reinterpret_cast<const double2*>(p)[0];
    const double2 b = reinterpret_cast<const double2*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// Whether the window piece [b, b + len) of hist ++ x lies wholly in hist
// or wholly in x; window_at is then where it starts.
__device__ __forceinline__ bool window_fits(long long H, long long n,
                                            long long b, long long len) {
    return (b >= 0 && b + len <= H) || (b >= H && b + len <= H + n);
}

template <typename T>
__device__ __forceinline__ const T* window_at(const T* hist_s, long long H,
                                             const T* x_s, long long b) {
    return b < H ? hist_s + b : x_s + (b - H);
}

// One piece's dots for the warp's first ja slots (all kSlots when kAll).
// The lane with offset o takes buffer entries o, o + 1, ..., o + pc - 1 of
// rows fi and fi + 1 (bp + row[j] + o and + E), four at a time in 16-byte
// loads, that is taps T = p0 + o + u (mod taps) for u < pc.  The step
// (!kTwo) adds win[T] * (b1 + frac (b2 - b1)), b1 = bank[fi, T], b2 =
// bank[fi + 1, T], to sums[j] in that order (the lerp in this form needs
// no 1 - frac register per slot); the apply (kTwo) adds win[T] * b1 to
// sums[j] and win[T] * b2 to sums2[j].  Slot j's window starts at wlo +
// wrel[j] in hist ++ x.  kLinear: no lane's T wraps; kWrap: some do;
// kClamped: reads of hist ++ x are clamped to the buffer.  kStaged: the
// run's window from wlo on is in shared memory at ws; otherwise the window
// is read in place through L1, and (kLinear, kWrap) each slot's reads of
// this piece lie wholly in hist or in x.
template <typename T, int kSlots, bool kTwo, bool kAll, PieceMode kMode,
          bool kStaged>
__device__ __forceinline__ void piece_dots(
        const T* bp, const T* ws, int E, int o, int p0, int pc, int taps,
        int ja, const int (&row)[kSlots], const T (&frac)[kSlots],
        const int (&wrel)[kSlots], long long wlo,
        const T* __restrict__ hist_s, long long H, const T* __restrict__ x_s,
        long long last, T (&sums)[kSlots], T (&sums2)[kTwo ? kSlots : 1]) {
    constexpr bool kLin = kMode == kLinear;
    int wo[kSlots];                            // kStaged: window offset in ws
    const T* w[kSlots];                        // in place: window pointer
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
        wo[j] = wrel[j] + (kLin ? p0 + o : 0);
        w[j] = nullptr;
        if constexpr (!kStaged && kMode != kClamped)
            w[j] = window_at(hist_s, H, x_s, wlo + wo[j]);
    }
    for (int u0 = 0; u0 < pc; u0 += 4) {    // pc % 4 == 0
        int i[4];                           // window taps; kLinear: + u
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            i[c] = u0 + c;
            if constexpr (!kLin) {
                const int t = p0 + o + u0 + c;
                i[c] = t < taps ? t : t - taps;
            }
        }
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
            if (kAll || j < ja) {
                const T* b = bp + row[j] + o + u0;
                T w1[4], w2[4];
                lds4(b, w1);
                lds4(b + E, w2);
#pragma unroll
                for (int c = 0; c < 4; ++c) {
                    T v;
                    if constexpr (kStaged) {
                        v = ws[wo[j] + i[c]];
                    } else if constexpr (kMode == kClamped) {
                        const long long g =
                            min(max(wlo + wo[j] + i[c], 0LL), last);
                        v = g < H ? __ldg(hist_s + g) : __ldg(x_s + (g - H));
                    } else {
                        v = __ldg(w[j] + i[c]);
                    }
                    if constexpr (kTwo) {
                        sums[j] += v * w1[c];
                        sums2[j] += v * w2[c];
                    } else {
                        sums[j] += v * (w1[c] + frac[j] * (w2[c] - w1[c]));
                    }
                }
            }
        }
    }
}

// Output k's emission position, as the plain version computes it in
// float64: phase row fi, fraction frac (rounded to T) and window base.
template <typename T>
__device__ __forceinline__ long long position(long long k, double off,
                                              double ratio, int F, int half,
                                              long long shift, int* fi,
                                              T* frac) {
    const double pos = __dadd_rn(off, __ddiv_rn(static_cast<double>(k),
                                                ratio));
    const double ip = floor(pos);
    const double ff = __dmul_rn(__dsub_rn(pos, ip), static_cast<double>(F));
    *fi = min(static_cast<int>(floor(ff)), F - 1);
    *frac = static_cast<T>(__dsub_rn(ff, static_cast<double>(*fi)));
    return static_cast<long long>(ip) - half + 1 + shift;
}

// asrc_step (!kTwo: positions computed from offsets, ratios and shift,
// masked at Ks) and asrc_apply (kTwo: positions given as base, fi and frac
// [S, k_max], unmasked; buf as hist, n = 0): see the header.
template <typename T, bool kTwo>
__global__ void __launch_bounds__(kStepThreads, 1)
asrc_step_kernel(const T* __restrict__ hist, long long H,
                 const T* __restrict__ x, long long n,
                 const T* __restrict__ bank, int taps, int F, int P, int X,
                 int wcap, const double* __restrict__ offsets,
                 const double* __restrict__ ratios,
                 const int* __restrict__ Ks, long long shift,
                 long long k_max, T* __restrict__ out,
                 const int* __restrict__ base, const int* __restrict__ fi,
                 const T* __restrict__ given_frac) {
    constexpr int kSlots = kStepSlots<T>;
    constexpr int kSlots2 = kTwo ? kSlots : 1;  // the apply's second sums
    constexpr int kRun = kStepRun<T>;
    // float32 sums each piece apart, then adds it (a blocked order)
    constexpr bool kBlocked = sizeof(T) == 4;
    constexpr int kVec = 16 / sizeof(T);
    extern __shared__ float4 smem4[];
    T* const bufs = reinterpret_cast<T*>(smem4);
    const int E = P + X;                    // entries per staged row
    const int piece = (F + 1) * E;
    T* const ws = bufs + 2 * piece;         // the staged window, wcap values
    const int s = blockIdx.y;
    const int tid = threadIdx.x;
    const long long k0 = static_cast<long long>(blockIdx.x) * kRun;
    const long long kend =
        kTwo ? k_max : min(static_cast<long long>(Ks[s]), k_max);
    T* out_s = out + static_cast<long long>(s) * k_max;
    if (k0 >= kend) {                       // the whole run is masked
        for (long long k = k0 + tid; k < k0 + kRun && k < k_max;
             k += kStepThreads)
            out_s[k] = T(0);
        return;
    }
    const int pieces = (taps + P - 1) / P;
    // piece 0 lands while the positions are computed or loaded
    stage_piece(bufs, bank, taps, F, E, X, 0, min(P, taps));

    const int lane = tid & 31;
    // the lane's entry offset: lanes 8 apart share one, the 8 of a
    // quarter-warp read 8 different 16-byte columns of any rows
    const int o = X - kVec * (1 + lane % (X / kVec));
    const T* hist_s = hist + static_cast<long long>(s) * H;
    const T* x_s = x + static_cast<long long>(s) * n;
    const long long last = H + n - 1;
    const double off = kTwo ? 0.0 : offsets[s];
    const double ratio = kTwo ? 1.0 : ratios[s];
    const int half = taps / 2;
    const long long kwarp = k0 + (tid - lane);  // the warp's slot-0 output
    // the lane's output among its warp's 32 of a slot: where the offsets
    // span a wavefront (X = 8 kVec) lane l takes output kVec (l % 8) +
    // (l / 8) % kVec + 8 kVec (l / 8 / kVec), so that output + o is nearly
    // the same for all lanes near ratio 1 and their window reads meet on
    // one or two 128-byte lines; otherwise output l
    const int lk = X == 8 * kVec
        ? kVec * (lane % 8) + (lane / 8) % kVec + 8 * kVec * (lane / 8 / kVec)
        : lane;
    const long long kthread = kwarp + lk;
    int row[kSlots];
    T frac[kSlots], acc[kSlots];
    T acc2[kSlots2] = {};
    // The run's windows span [wlo, whi), less than H + n < 2^31 wide: a
    // slot's window starts at wlo + wrel[j].  Where the span fits the wcap
    // values left after the bank's buffers, it is staged once, with the
    // reads clamped to the buffer, and every piece reads it from shared
    // memory; otherwise the pieces read hist and x in place.  Lanes past
    // the valid outputs take the last valid one's position.  Positions are
    // parked in, and the apply's span reduced through, the shared memory
    // behind piece 0's buffer, which piece 1 and the staged window fill
    // only after the barrier below.
    int wrel[kSlots];
    int ja = 0;     // slots holding a valid output of this warp (a prefix)
    long long wlo, whi;
    if constexpr (kTwo) {
        const long long rs = static_cast<long long>(s) * k_max;
        int lo = INT_MAX, hi = 0;
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
            const long long k = min(kthread + j * kStepThreads, kend - 1);
            // the prologue keeps every window inside buf and every phase in
            // [0, F - 1]; the clamps keep any other argument in bounds
            wrel[j] = min(max(base[rs + k], 0), static_cast<int>(H) - taps);
            row[j] = min(max(fi[rs + k], 0), F - 1) * E;
            lo = min(lo, wrel[j]);
            hi = max(hi, wrel[j]);
        }
        int* const red = reinterpret_cast<int*>(bufs + piece);
        lo = __reduce_min_sync(0xffffffffu, lo);
        hi = __reduce_max_sync(0xffffffffu, hi);
        if (lane == 0) {
            red[tid / 32] = lo;
            red[kStepWarps + tid / 32] = hi;
        }
        __syncthreads();
#pragma unroll
        for (int w = 0; w < kStepWarps; ++w) {
            lo = min(lo, red[w]);
            hi = max(hi, red[kStepWarps + w]);
        }
        wlo = lo;
        whi = static_cast<long long>(hi) + taps;
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
            wrel[j] -= lo;
            frac[j] = T(0);                 // read at the end, not here
            acc[j] = T(0);
            if (kwarp + j * kStepThreads < kend) ja = j + 1;
        }
    } else {
        int fi_edge;
        T frac_edge;
        wlo = position(k0, off, ratio, F, half, shift, &fi_edge,
                       &frac_edge);
        whi = position(min(k0 + kRun, kend) - 1, off, ratio, F, half, shift,
                       &fi_edge, &frac_edge) + taps;
        // one slot at a time: a loop, so that the few values live across
        // the division's slow-path call need no spill
        int* const srow = reinterpret_cast<int*>(bufs + piece);
        int* const swrel = srow + kRun;
        T* const sfrac = reinterpret_cast<T*>(swrel + kRun);
#pragma unroll 1
        for (int j = 0; j < kSlots; ++j) {
            const int e = j * kStepThreads + tid;
            int f;
            swrel[e] = static_cast<int>(
                position(min(kthread + j * kStepThreads, kend - 1), off,
                         ratio, F, half, shift, &f, &sfrac[e]) - wlo);
            srow[e] = f * E;
        }
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
            const int e = j * kStepThreads + tid;
            wrel[j] = swrel[e];
            row[j] = srow[e];
            frac[j] = sfrac[e];
            acc[j] = T(0);
            if (kwarp + j * kStepThreads < kend) ja = j + 1;
        }
    }
    __syncthreads();
    const bool staged = whi - wlo <= wcap;
    if (staged)
        for (int e = tid; e < whi - wlo; e += kStepThreads) {
            const long long g = min(max(wlo + e, 0LL), last);
            ws[e] = g < H ? hist_s[g] : x_s[g - H];
        }

    for (int p = 0; p < pieces; ++p) {
        const int p0 = p * P;
        const int pc = min(P, taps - p0);
        if (p + 1 < pieces) {
            stage_piece(bufs + ((p + 1) & 1) * piece, bank, taps, F, E, X,
                        p0 + P, min(P, taps - p0 - P));
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();                    // piece p is in its buffer
        const T* bp = bufs + (p & 1) * piece;
        // taps p0 + o + u, u < pc, wrap past taps in the last pieces
        const bool wraps = p0 + pc + X - 1 > taps;
        // the apply's clamped windows all lie in its one buffer
        bool fast = true;
        if (!kTwo && !staged)
#pragma unroll
            for (int j = 0; j < kSlots; ++j)
                if (j < ja && !(wraps ? window_fits(H, n, wlo + wrel[j], taps)
                                      : window_fits(H, n,
                                                    wlo + wrel[j] + p0 + o,
                                                    pc)))
                    fast = false;
        fast = __all_sync(0xffffffffu, fast);   // warp-uniform path
        T part[kSlots], part2[kSlots2];
#pragma unroll
        for (int j = 0; j < kSlots; ++j) part[j] = kBlocked ? T(0) : acc[j];
#pragma unroll
        for (int j = 0; j < kSlots2; ++j) part2[j] = kBlocked ? T(0) : acc2[j];
#define ART_PIECE(ALL, MODE, STAGED)                                          \
        piece_dots<T, kSlots, kTwo, ALL, MODE, STAGED>(                       \
            bp, ws, E, o, p0, pc, taps, ja, row, frac, wrel, wlo, hist_s, H,  \
            x_s, last, part, part2)
        if (ja == kSlots) {
            if (staged) {
                if (wraps) ART_PIECE(true, kWrap, true);
                else ART_PIECE(true, kLinear, true);
            } else if (!fast) ART_PIECE(true, kClamped, false);
            else if (wraps) ART_PIECE(true, kWrap, false);
            else ART_PIECE(true, kLinear, false);
        } else {
            if (staged) {
                if (wraps) ART_PIECE(false, kWrap, true);
                else ART_PIECE(false, kLinear, true);
            } else if (!fast) ART_PIECE(false, kClamped, false);
            else if (wraps) ART_PIECE(false, kWrap, false);
            else ART_PIECE(false, kLinear, false);
        }
#undef ART_PIECE
#pragma unroll
        for (int j = 0; j < kSlots; ++j)
            acc[j] = kBlocked ? acc[j] + part[j] : part[j];
#pragma unroll
        for (int j = 0; j < kSlots2; ++j)
            acc2[j] = kBlocked ? acc2[j] + part2[j] : part2[j];
        __syncthreads();                    // buffer p & 1 may be refilled
    }

#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
        const long long k = kthread + j * kStepThreads;
        if constexpr (kTwo) {
            if (k < k_max) {
                const T f = given_frac[static_cast<long long>(s) * k_max + k];
                out_s[k] = acc[j] * (T(1) - f) + acc2[j] * f;
            }
        } else {
            if (k < k_max) out_s[k] = k < kend ? acc[j] : T(0);
        }
    }
}

// Launch one instance on S streams of k_max outputs; hist [S, H] and x
// [S, n] (the apply: buf [S, B] as hist, n = 0).
template <typename T, bool kTwo>
int launch(const T* hist, long long H, const T* x, long long n,
           long long S, const T* bank, int taps, int F, int P, int X,
           int threads, int run, const double* offsets, const double* ratios,
           const int* Ks, long long shift, const int* base, const int* fi,
           const T* frac, long long k_max, T* out, void* stream) {
    const long long runs = (k_max + kStepRun<T> - 1) / kStepRun<T>;
    // two bank piece buffers, then the staged window in what is left
    const long long bank_bytes =
        2LL * (F + 1) * (P + X) * static_cast<long long>(sizeof(T));
    if (S <= 0 || S > 65535 || H < 0 || n < 0 || H + n < 1 || taps <= 0 ||
        H + n > 0x7fffffffLL || taps % 4 || F <= 0 || k_max <= 0 ||
        runs > 0x7fffffffLL || P <= 0 ||
        P % 4 || X <= 0 || X % 4 || X > taps || X > 32 ||
        bank_bytes > kMaxSmem ||
        (P + X) * static_cast<int>(sizeof(T)) > 16 * kStepThreads ||
        threads != kStepThreads || run != kStepRun<T> ||
        (kTwo && H < taps) ||
        reinterpret_cast<uintptr_t>(bank) % 16)
        return cudaErrorInvalidValue;
    const int wcap =
        static_cast<int>((kMaxSmem - bank_bytes) / sizeof(T));
    const cudaError_t err = cudaFuncSetAttribute(
        asrc_step_kernel<T, kTwo>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxSmem));
    if (err != cudaSuccess) return err;
    const dim3 grid(static_cast<unsigned>(runs), static_cast<unsigned>(S));
    asrc_step_kernel<T, kTwo><<<grid, kStepThreads,
                                static_cast<size_t>(kMaxSmem),
                                static_cast<cudaStream_t>(stream)>>>(
        hist, H, x, n, bank, taps, F, P, X, wcap, offsets, ratios, Ks, shift,
        k_max, out, base, fi, frac);
    return cudaGetLastError();
}

}  // namespace

// hist [S, H], x [S, n], bank [F + 1, taps] (T contiguous on the device),
// offsets and ratios float64 [S], Ks int32 [S], out [S, k_max]; the
// geometry (taps per piece P, outputs per block, threads) from
// ops/asrc_step.py::step_geometry.  Return the launch's cudaError_t (0 on
// success); arguments the kernel does not take, a geometry it was not built
// for included, return cudaErrorInvalidValue.
extern "C" int art_asrc_step_f32(const float* hist, long long H,
                                 const float* x, long long n, long long S,
                                 const float* bank, int taps, int F, int P,
                                 int X, int run, int threads,
                                 const double* offsets,
                                 const double* ratios, const int* Ks,
                                 long long shift, long long k_max, float* out,
                                 void* stream) {
    return launch<float, false>(hist, H, x, n, S, bank, taps, F, P, X,
                                threads, run, offsets, ratios, Ks, shift,
                                nullptr, nullptr, nullptr, k_max, out,
                                stream);
}

extern "C" int art_asrc_step_f64(const double* hist, long long H,
                                 const double* x, long long n, long long S,
                                 const double* bank, int taps, int F, int P,
                                 int X, int run, int threads,
                                 const double* offsets,
                                 const double* ratios, const int* Ks,
                                 long long shift, long long k_max,
                                 double* out, void* stream) {
    return launch<double, false>(hist, H, x, n, S, bank, taps, F, P, X,
                                 threads, run, offsets, ratios, Ks, shift,
                                 nullptr, nullptr, nullptr, k_max, out,
                                 stream);
}

// buf [S, B], bank [F + 1, taps], frac and out [S, K] float32, base and fi
// int32 [S, K], all contiguous on the device; the geometry from
// ops/asrc_step.py::step_geometry(taps, F, float32).  Returns as above.
extern "C" int art_asrc_apply_f32(const float* buf, long long S, long long B,
                                  const float* bank, int taps, int F, int P,
                                  int X, int run, int threads,
                                  const int* base, const int* fi,
                                  const float* frac, long long K, float* out,
                                  void* stream) {
    return launch<float, true>(buf, B, buf, 0, S, bank, taps, F, P, X,
                               threads, run, nullptr, nullptr, nullptr, 0,
                               base, fi, frac, K, out, stream);
}

// The float64 apply: buf, bank, frac and out double, the geometry from
// step_geometry(taps, F, float64).  Returns as above.
extern "C" int art_asrc_apply_f64(const double* buf, long long S,
                                  long long B, const double* bank, int taps,
                                  int F, int P, int X, int run, int threads,
                                  const int* base, const int* fi,
                                  const double* frac, long long K,
                                  double* out, void* stream) {
    return launch<double, true>(buf, B, buf, 0, S, bank, taps, F, P, X,
                                threads, run, nullptr, nullptr, nullptr, 0,
                                base, fi, frac, K, out, stream);
}
