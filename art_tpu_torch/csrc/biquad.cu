// One order-4 IIR section for NVIDIA Hopper (sm_90a), solved in float64 in
// one launch: the device biquad cascade of the ART -p filters and of
// BASELINE config 4's chain.
//
// Replaces the XLA code of art_tpu/ops/biquad_kernel.py (no Pallas there):
// _iir_core_F2 (the block-Toeplitz solve and its two-level carry) with the
// FIR, mask and state of assoc_core_masked / assoc_core_full and their _T
// forms.  What it computes, per stream s (x, y in time order, xh and yh
// the 4 values before frame 0, newest first, all float64 inside):
//
//   x'_t = x_t for t < K, 0 at and past K (x there is never read);
//   f_t  = a0 x'_t + a1 x'_{t-1} + a2 x'_{t-2} + a3 x'_{t-3} + a4 x'_{t-4}
//          for t < K, 0 at and past K;
//   y_t  = f_t - b1 y_{t-1} - b2 y_{t-2} - b3 y_{t-3} - b4 y_{t-4};
//   out_t = T(y_t) for t < K (rounded once), 0 at and past K;
//   xh' = (x'_{K-1}, .., x'_{K-4}), yh' = (y_{K-1}, .., y_{K-4}) in
//         float64, from xh / yh where K - 1 - i < 0.
//
// T is float or double.  A two-section cascade is two launches from one
// host call, the second reading the first's T output, as JAX's section 2
// reads y1.astype(dt).
//
// What bounds it.  Each input sample is read and each output written once:
// at config 4b's chunk (6 x 524,320 float64) that is 50.3 MB, ~15 us at
// 3.35 TB/s, against 9 float64 multiply-adds a sample (the design runs the
// recurrence twice: 13, ~41 M, ~2.5 us at the card's 16.7 T float64
// multiply-adds a second outside the tensor cores).  It is bound by bytes.
// That is arithmetic from shapes and the data sheet.
//
// The recurrence's state s_t = (y_t, .., y_{t-3}) moves by the companion
// matrix A: s_t = A s_{t-1} + f_t e_0.  Over b frames from a state e a
// block ends at A^b e + v, v its end from zero state.  Design (geometry in
// biquad_geometry.h; at config 4b's chunk the grid is one wave of 390 CTAs,
// and tools/biquad_timeline.py shows when each reaches each phase):
//   - One CTA of kBqThreads threads takes one span of kBqSpan = 8192
//     frames of one stream.  CTAs draw their span from an atomic ticket
//     (span-major), so a CTA waits only on spans whose CTAs already run.
//   - The span is read once into shared memory, in float64 whatever T is
//     (16-byte loads on the [S, n] layout the main paths pass, streaming
//     so as not to evict the tables from L1; one pad element a thread's
//     block so that the threads' frame-t reads hit distinct banks).  Each
//     warp loads, runs and stores its own region of 1024 frames, so that
//     one warp's memory traffic overlaps the others' arithmetic; the CTA
//     meets only around the scan's totals and the entering states.
//   - Thread q runs its block of kBqFrames frames from zero state (v_q, its
//     end), and the FIR's f replaces x' in the stage, so the rerun does the
//     recurrence alone.  Blocks that end before frame K - 4 run without a
//     check a frame.
//   - The entering states come from a log-depth scan of (M = A^b, v_q):
//     Hillis-Steele over the warp's lanes by shuffles with M^(2^k), then
//     the same over the warps' totals Z_w with M^(32 * 2^k).  The tables of
//     M^d and M^(32w) the scans and the entering states read are copied
//     into shared memory first: read from L1 and L2 while the spans stream
//     in and out, each read waits in the memory system's queues.  The span's
//     aggregate u_j (its end from zero state) is sum_d M^(32d) Z_{7-d};
//     M^(32d) is exactly zero from d = free on (host tables; free = 2 for
//     config 4b's lowpass), so the last warp sums it (at most 8 terms, a
//     row a lane) and publishes it beside warp 0's scan.
//   - Across spans a fixed formula, not a chain: with P = A^8192,
//         E_j = P^W E_{j-W} + sum_{i=1..W} P^(i-1) u_{j-i},
//     for j < W P^j yh in place of the first term, the sum stopping at span
//     0.  Warp 0's lanes take one term each (lane i: u_{j-1-i}; lane 16:
//     the E term) and a fixed shuffle tree sums them.  The host picks W
//     (tables): the least d <= 16 with P^d exactly zero, and then no E
//     term at all (an exact zero times a finite state adds nothing), else
//     W = 16 and span j's CTA publishes E_j for span j + W.  The serial
//     dependence through the grid is ceil(spans / W) hops, none for the -p
//     lowpasses.  The formula never depends on which CTA finished first:
//     outputs are bitwise the same from run to run and for every batch
//     width S.
//   - Warp w's entering state is C_w + M^(32w) E_j (C_w from the scan).
//     Where M^(32w) is exactly zero (from w = 2 on for config 4b's lowpass,
//     w = 1 for art -r96k's), the warp takes C_w as soon as the scan is
//     done and never waits for E_j: a neighbour's u_j becomes visible
//     microseconds after it is published while the other CTAs' stores fill
//     the memory system, and only the first warps of a span sit through
//     that.
//   - Each thread reruns its block from its entering state on the staged
//     span (the input is not read again) and writes its float64 outputs (0
//     at and past K) over f; they leave rounded once to T through 16-byte
//     stores, a warp's covering whole lines (a lane's own pieces of its
//     block, written straight from registers, would write partial lines).
//     The rows of the state at K go out from the threads that hold frames
//     K-1..K-4; rows before frame 0 come from xh / yh (span 0's CTA).
//   - Spans with no frame below K only store zeros.
// Each published double travels with the launch's epoch (the host's
// counter) in one 16-byte pair, written and polled by 128-bit atomics, so
// the scratch is never cleared and a reader needs no fence and no flag;
// the last CTA to draw a ticket resets the ticket counter.

#include <cuda_runtime.h>

#include <cstdint>

#include "biquad_geometry.h"

namespace {

typedef unsigned long long u64;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kStep = 8;        // frames a thread takes at once

template <typename T> __device__ __forceinline__ T round_to(double v);
template <> __device__ __forceinline__ float round_to<float>(double v) {
    return __double2float_rn(v);
}
template <> __device__ __forceinline__ double round_to<double>(double v) {
    return v;
}

// 16 bytes of T and its elements (k a constant after unrolling)
template <typename T> struct Vec;
template <> struct Vec<float> {
    using type = float4;
    static constexpr int n = 4;
    static __device__ __forceinline__ float get(const float4& v, int k) {
        return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
    }
    static __device__ __forceinline__ void set(float4& v, int k, float a) {
        if (k == 0) v.x = a;
        else if (k == 1) v.y = a;
        else if (k == 2) v.z = a;
        else v.w = a;
    }
};
template <> struct Vec<double> {
    using type = double2;
    static constexpr int n = 2;
    static __device__ __forceinline__ double get(const double2& v, int k) {
        return k == 0 ? v.x : v.y;
    }
    static __device__ __forceinline__ void set(double2& v, int k, double a) {
        if (k == 0) v.x = a;
        else v.y = a;
    }
};

struct Section {
    const double* tab;              // kernel_tables, kTabDoubles
    const double* xh;               // [4, S] newest first
    const double* yh;
    double* new_xh;                 // [4, S], the state after K frames
    double* new_yh;
};

struct Launch {
    const void* x;                  // [n, S] at strides (xsi, xsc)
    long long xsi, xsc;
    void* y;                        // [n, S] at strides (ysi, ysc)
    long long ysi, ysc;
    long long n, K, spans;
    int S;
    int vec_in, vec_out;            // 16-byte loads / stores
    Section sec;
    u64* scratch;                   // biquad_geometry's records
    u64 epoch;
};

// A published value is a 16-byte pair {the double's bits, the launch's
// epoch}, written and read by 128-bit atomics, so a reader that sees its
// epoch holds the value itself: no fence, no flag and no second read.
__device__ __forceinline__ void exch128(u64* p, u64 lo, u64 hi) {
    asm volatile(
        "{\n\t.reg .b128 v, d;\n\tmov.b128 v, {%1, %2};\n\t"
        "atom.relaxed.gpu.global.exch.b128 d, [%0], v;\n\t}"
        :: "l"(p), "l"(lo), "l"(hi) : "memory");
}

__device__ __forceinline__ void read128(u64* p, u64& lo, u64& hi) {
    // an atomic read: compare and swap with the same value
    asm volatile(
        "{\n\t.reg .b128 c, d;\n\tmov.b128 c, {%2, %2};\n\t"
        "atom.relaxed.gpu.global.cas.b128 d, [%3], c, c;\n\t"
        "mov.b128 {%0, %1}, d;\n\t}"
        : "=l"(lo), "=l"(hi) : "l"(0ull), "l"(p) : "memory");
}

// the 4 doubles of a record field, each with this launch's epoch
__device__ __forceinline__ void publish(u64* rec, int field, const double* v,
                                        u64 epoch) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
        exch128(rec + field + 2 * r, __double_as_longlong(v[r]), epoch);
}

__device__ __forceinline__ void fetch(u64* rec, int field, u64 epoch,
                                      double* v) {
    for (;;) {
        bool all = true;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
            u64 lo, hi;
            read128(rec + field + 2 * r, lo, hi);
            v[r] = __longlong_as_double(static_cast<long long>(lo));
            all &= hi == epoch;
        }
        if (all) return;
        __nanosleep(64);
    }
}

// out += M v for a row-major 4x4 M, each row in the order c = 0..3
__device__ __forceinline__ void matvec_acc(const double* __restrict__ M,
                                           const double* v, double* out) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
        out[r] = fma(__ldg(M + 4 * r + 3), v[3],
                     fma(__ldg(M + 4 * r + 2), v[2],
                         fma(__ldg(M + 4 * r + 1), v[1],
                             fma(__ldg(M + 4 * r), v[0], out[r]))));
}

// out += M v for matrix l of a shared table held entry-major: entry k
// (row-major 4x4) of matrix l at t[k][l]
template <int kLd>
__device__ __forceinline__ void matvec_acc_s(const double (*t)[kLd], int l,
                                             const double* v, double* out) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
        out[r] = fma(t[4 * r + 3][l], v[3],
                     fma(t[4 * r + 2][l], v[2],
                         fma(t[4 * r + 1][l], v[1],
                             fma(t[4 * r][l], v[0], out[r]))));
}

__device__ __forceinline__ void shfl_up4(const double* z, double* o, int d) {
#pragma unroll
    for (int r = 0; r < 4; ++r) o[r] = __shfl_up_sync(kFull, z[r], d);
}

// frame e of a warp's region (or of the span) in the stage
__device__ __forceinline__ int slot(int e) {
    return (e / kBqFrames) * kBqPad + e % kBqFrames;
}

__device__ __forceinline__ u64* record(const Launch& p, long long j, int s) {
    return p.scratch + kBqRecWords * (1 + j * p.S + s);
}

// A warp's region: the kBqWarpFrames frames of its 32 threads' blocks,
// from frame ``base`` of stream s, staged in float64 at ``stage`` (the
// warp's first block).  Each warp moves its own region, so that one warp's
// loads, runs and stores overlap the others'.

// The region's frames below K into the stage, 0 at and past K (never
// read there): 16-byte loads, kBatch in flight a lane, where the layout
// allows, else an element a lane a load.
template <typename T>
__device__ __forceinline__ void stage_warp(const Launch& p, int s,
                                           long long base, int lane,
                                           double* stage) {
    using V = Vec<T>;
    using VT = typename V::type;
    const T* xs = static_cast<const T*>(p.x) + s * p.xsc;
    const long long left = p.K - base;
    const int lim = left <= 0 ? 0
                    : left < kBqWarpFrames ? static_cast<int>(left)
                                           : kBqWarpFrames;
    if (p.vec_in) {
        constexpr int kChunks = kBqWarpFrames / V::n / 32;
        constexpr int kBatch = sizeof(T);   // 16-byte loads in flight a lane
        static_assert(kChunks % kBatch == 0, "whole batches");
#pragma unroll 1
        for (int c0 = 0; c0 < kChunks; c0 += kBatch) {
            VT v[kBatch];
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const int e = ((c0 + u) * 32 + lane) * V::n;
                if (e + V::n <= lim) {
                    // streaming: read once, so as not to evict the tables
                    v[u] = __ldcs(reinterpret_cast<const VT*>(xs + base + e));
                } else {
#pragma unroll
                    for (int k = 0; k < V::n; ++k)
                        V::set(v[u], k,
                               e + k < lim ? xs[base + e + k] : T(0));
                }
            }
#pragma unroll
            for (int u = 0; u < kBatch; ++u) {
                const int e = ((c0 + u) * 32 + lane) * V::n;
#pragma unroll
                for (int k = 0; k < V::n; ++k)
                    stage[slot(e + k)] = static_cast<double>(V::get(v[u], k));
            }
        }
        return;
    }
#pragma unroll 4
    for (int e = lane; e < kBqWarpFrames; e += 32)
        stage[slot(e)] = e < lim ? static_cast<double>(xs[(base + e) * p.xsi])
                                 : 0.0;
}

// The region's frames below n from the stage (kZero: zeros), rounded once
// to T, to stream s.
template <typename T, bool kZero>
__device__ __forceinline__ void store_warp(const Launch& p, int s,
                                           long long base, int lane,
                                           const double* stage) {
    using V = Vec<T>;
    using VT = typename V::type;
    T* ys = static_cast<T*>(p.y) + s * p.ysc;
    const long long left = p.n - base;
    if (left <= 0) return;
    const int lim = left < kBqWarpFrames ? static_cast<int>(left)
                                         : kBqWarpFrames;
    if (p.vec_out) {
#pragma unroll (8 / V::n)
        for (int e = lane * V::n; e < lim; e += 32 * V::n) {
            VT v;
#pragma unroll
            for (int k = 0; k < V::n; ++k)
                V::set(v, k, kZero ? T(0) : round_to<T>(stage[slot(e + k)]));
            if (e + V::n <= lim) {
                *reinterpret_cast<VT*>(ys + base + e) = v;
            } else {
#pragma unroll
                for (int k = 0; k < V::n; ++k)
                    if (e + k < lim) ys[base + e + k] = V::get(v, k);
            }
        }
        return;
    }
#pragma unroll 4
    for (int e = lane; e < lim; e += 32)
        ys[(base + e) * p.ysi] = kZero ? T(0) : round_to<T>(stage[slot(e)]);
}

// Thread q's block, frames f0 .. f0 + kBqFrames - 1, staged at blk, from
// the state st = (y_{f0-1}, .., y_{f0-4}), kStep frames at a time: the
// step's inputs come from the stage at once and their FIR terms are
// independent, so only the recurrence's own y_{t-1} -> y_t multiply-add is
// serial.  st ends as the block's last 4 outputs.
//   kApply false, the run from zero state: f, the FIR over the staged x'
//     after the inputs xp = (x'_{f0-1}, .., x'_{f0-4}), replaces x' in the
//     stage, and the rows of x' in the state at K go out.
//   kApply true, the rerun: the outputs (0 at and past K) replace f, and
//     the rows of y in the state at K go out.
// kChecked: the block may reach frame K - 4 (the mask and the state's rows
// are checked a frame); else every frame lies below K - 4.
template <bool kApply, bool kChecked>
__device__ __forceinline__ void run_block(double* blk, long long f0,
                                          const Launch& p, int s,
                                          const double* xp, double* st) {
    const double* c = p.sec.tab + kTabAb;   // a0..a4, b0..b4
    const double a0 = __ldg(c), a1 = __ldg(c + 1), a2 = __ldg(c + 2),
                 a3 = __ldg(c + 3), a4 = __ldg(c + 4);
    const double b1 = __ldg(c + 6), b2 = __ldg(c + 7), b3 = __ldg(c + 8),
                 b4 = __ldg(c + 9);
    double x1 = xp[0], x2 = xp[1], x3 = xp[2], x4 = xp[3];
    double y1 = st[0], y2 = st[1], y3 = st[2], y4 = st[3];
#pragma unroll 1
    for (int t0 = 0; t0 < kBqFrames; t0 += kStep) {
        double y[kStep];
#pragma unroll
        for (int u = 0; u < kStep; ++u) {    // f_t
            const double x0 = blk[t0 + u];
            if (kApply) {
                y[u] = x0;
                continue;
            }
            const long long i = f0 + t0 + u;
            y[u] = fma(a4, x4, fma(a3, x3, fma(a2, x2, fma(a1, x1,
                                                           a0 * x0))));
            if (kChecked && i >= p.K) y[u] = 0.0;
            x4 = x3; x3 = x2; x2 = x1; x1 = x0;
            const long long r = p.K - 1 - i;     // row of the state at K
            if (kChecked && r >= 0 && r < 4) p.sec.new_xh[r * p.S + s] = x0;
            blk[t0 + u] = y[u];
        }
#pragma unroll
        for (int u = 0; u < kStep; ++u) {    // and then y_t
            y[u] = fma(-b1, y1, fma(-b2, y2, fma(-b3, y3, fma(-b4, y4,
                                                             y[u]))));
            y4 = y3; y3 = y2; y2 = y1; y1 = y[u];
        }
        if (kApply) {
#pragma unroll
            for (int u = 0; u < kStep; ++u) {
                const long long i = f0 + t0 + u;
                blk[t0 + u] = !kChecked || i < p.K ? y[u] : 0.0;
                const long long r = p.K - 1 - i;
                if (kChecked && r >= 0 && r < 4)
                    p.sec.new_yh[r * p.S + s] = y[u];
            }
        }
    }
    st[0] = y1; st[1] = y2; st[2] = y3; st[3] = y4;
}

template <bool kApply>
__device__ __forceinline__ void run(double* blk, long long f0,
                                    const Launch& p, int s, const double* xp,
                                    double* st) {
    if (f0 + kBqFrames + 4 <= p.K)
        run_block<kApply, false>(blk, f0, p, s, xp, st);
    else
        run_block<kApply, true>(blk, f0, p, s, xp, st);
}

// named barriers (0 is __syncthreads'): kBarFree, the entering states of
// the warps that need no E_j are in dw; kBarE, the others' are
constexpr int kBarFree = 1, kBarE = 2;

__device__ __forceinline__ void bar_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;" :: "r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
    asm volatile("bar.arrive %0, %1;" :: "r"(id), "r"(count) : "memory");
}

// Warp 0: E_j, one term a lane (lane i: P^i u_{j-1-i}; lane kBqWindow:
// P^j yh before span W, else P^W E_{j-W} where P^W is not zero), summed by
// a fixed shuffle tree, in every lane; published where a later span reads
// it (carry).
__device__ __forceinline__ void look_back(const Launch& p, long long j,
                                          int s, int lane, double* E) {
    const double* tab = p.sec.tab;
    const int W = static_cast<int>(__ldg(tab + kTabWindow));
    const bool carry = __ldg(tab + kTabCarry) != 0.0;
    double term[4] = {0.0, 0.0, 0.0, 0.0};
    if (lane < W && lane < j) {
        double u[4];
        fetch(record(p, j - 1 - lane, s), kRecU, p.epoch, u);
        matvec_acc(tab + kTabP + 16 * lane, u, term);
    } else if (lane == kBqWindow && (j < W || carry)) {
        double e[4];
        if (j < W) {
#pragma unroll
            for (int r = 0; r < 4; ++r) e[r] = p.sec.yh[r * p.S + s];
        } else {
            fetch(record(p, j - W, s), kRecE, p.epoch, e);
        }
        matvec_acc(tab + kTabP + 16 * (j < W ? j : W), e, term);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
#pragma unroll
        for (int r = 0; r < 4; ++r)
            term[r] += __shfl_down_sync(kFull, term[r], off);
#pragma unroll
    for (int r = 0; r < 4; ++r) E[r] = __shfl_sync(kFull, term[r], 0);
    if (carry && lane == 0) publish(record(p, j, s), kRecE, E, p.epoch);
}

template <typename T>
__global__ void __launch_bounds__(kBqThreads, kBqMinBlocks)
    biquad_span_kernel(const __grid_constant__ Launch p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    double* stage = reinterpret_cast<double*>(smem_raw);
    __shared__ double halo[kBqWarps][4];    // x' before each warp's region
    __shared__ double zw[kBqWarps][4];      // each warp's scan total
    __shared__ double dw[kBqWarps][4];      // the state entering each warp
    __shared__ double mt[16][33];           // M^d, d < 32, entry-major
    __shared__ double mwt[16][kBqWarps + 1];    // M^(32w), entry-major
    __shared__ long long ticket_s;
    const int q = threadIdx.x, lane = q & 31, warp = q >> 5;
    // the tables the scans and the entering states read, copied before the
    // span streams in and fills the memory system's queues
    for (int e = q; e < 16 * 32; e += kBqThreads)
        mt[e % 16][e / 16] = __ldg(p.sec.tab + kTabM + e);
    if (q < 16 * kBqWarps)
        mwt[q % 16][q / 16] = __ldg(p.sec.tab + kTabMw + q);
    if (q == 0) {
        const u64 t = atomicAdd(p.scratch, 1ull);
        if (t == static_cast<u64>(p.spans) * p.S - 1)
            atomicExch(p.scratch, 0ull);     // every ticket is drawn
        ticket_s = static_cast<long long>(t);
    }
    __syncthreads();
    const long long j = ticket_s / p.S;
    const int s = static_cast<int>(ticket_s - j * p.S);
    const long long t0 = j * kBqSpan;
    const long long base = t0 + static_cast<long long>(warp) * kBqWarpFrames;
    double* wstage = stage + warp * 32 * kBqPad;
    const Section& sec = p.sec;
    if (j == 0 && q < 4 && q >= p.K) {      // rows of the state before 0
        sec.new_xh[q * p.S + s] = sec.xh[(q - p.K) * p.S + s];
        sec.new_yh[q * p.S + s] = sec.yh[(q - p.K) * p.S + s];
    }
    if (t0 >= p.K) {                        // no frame below K
        store_warp<T, true>(p, s, base, lane, wstage);
        return;
    }
    double h = 0.0;                         // loaded ahead of the stage
    if (lane < 4) {
        const long long i = base - 4 + lane;
        const T* xs = static_cast<const T*>(p.x) + s * p.xsc;
        h = i < 0 ? sec.xh[(-1 - i) * p.S + s]
                  : i < p.K ? static_cast<double>(xs[i * p.xsi]) : 0.0;
    }
    stage_warp<T>(p, s, base, lane, wstage);
    if (lane < 4) halo[warp][lane] = h;
    __syncwarp();
    const double* tab = sec.tab;
    double* blk = stage + q * kBqPad;
    double xp[4];                           // x'_{f0-1} .. x'_{f0-4}
#pragma unroll
    for (int r = 0; r < 4; ++r)
        xp[r] = lane == 0 ? halo[warp][3 - r]
                          : blk[-kBqPad + kBqFrames - 1 - r];
    const long long f0 = t0 + static_cast<long long>(q) * kBqFrames;
    __syncwarp();                           // xp is read before f replaces x'
    double z[4] = {0.0, 0.0, 0.0, 0.0};
    run<false>(blk, f0, p, s, xp, z);                    // z = v_q
    // the warp's inclusive scan: z_l = sum_{k<=l} M^(l-k) v_k
#pragma unroll
    for (int k = 0; k < 5; ++k) {
        const int d = 1 << k;
        double o[4];
        shfl_up4(z, o, d);
        if (lane >= d) matvec_acc_s(mt, d, o, z);
    }
    double xw[4];                           // exclusive: lanes before this
    shfl_up4(z, xw, 1);
    if (lane == 0) xw[0] = xw[1] = xw[2] = xw[3] = 0.0;
    if (lane == 31) {
#pragma unroll
        for (int r = 0; r < 4; ++r) zw[warp][r] = z[r];
    }
    // M^(32d) is exactly zero from d = ``free`` on (host tables): u_j =
    // sum_{d<free} M^(32d) Z_{7-d} (Z_w the warps' totals), summed by the
    // last warp, a row a lane, beside warp 0's scan; the warps from
    // ``free`` on enter with C_w alone and never wait for E_j
    const int free = static_cast<int>(__ldg(tab + kTabFree));
    const int n_free = 32 * (1 + kBqWarps - free);      // with warp 0
    __syncthreads();
    if (warp == kBqWarps - 1 && lane < 4) {
        const int r = lane;
        double u = zw[kBqWarps - 1][r];
        for (int d = 1; d < free; ++d) {
            const double* z = zw[kBqWarps - 1 - d];
            u = fma(mwt[4 * r + 3][d], z[3], fma(mwt[4 * r + 2][d], z[2],
                    fma(mwt[4 * r + 1][d], z[1], fma(mwt[4 * r][d], z[0],
                                                     u))));
        }
        exch128(record(p, j, s) + kRecU + 2 * r, __double_as_longlong(u),
                p.epoch);
    }
    if (warp == 0) {
        // the warps' totals: lane w ends with C_{w+1} = sum_{k<32(w+1)}
        // M^(32(w+1)-1-k) v_k
        double cs[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cs[r] = lane < kBqWarps ? zw[lane][r] : 0.0;
#pragma unroll
        for (int d = 1; d < kBqWarps; d *= 2) {
            double o[4];
            shfl_up4(cs, o, d);
            if (lane >= d && lane < kBqWarps) matvec_acc_s(mwt, d, o, cs);
        }
        double cw[4];                       // C_w, the state entering warp
        shfl_up4(cs, cw, 1);                //   w from zero span state
        if (lane == 0) cw[0] = cw[1] = cw[2] = cw[3] = 0.0;
        if (lane >= free && lane < kBqWarps) {
#pragma unroll
            for (int r = 0; r < 4; ++r) dw[lane][r] = cw[r];
        }
        if (free < kBqWarps) bar_arrive(kBarFree, n_free);
        double E[4];
        look_back(p, j, s, lane, E);
        if (lane < free) {                  // D_w = C_w + M^(32w) E_j
            matvec_acc_s(mwt, lane, E, cw);
#pragma unroll
            for (int r = 0; r < 4; ++r) dw[lane][r] = cw[r];
        }
        if (free > 1) bar_arrive(kBarE, 32 * free);
        __syncwarp();
    } else if (warp >= free) {
        bar_sync(kBarFree, n_free);
    } else {
        bar_sync(kBarE, 32 * free);
    }
    // the state entering this thread's block: M^lane D_warp + xw
    double d[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) d[r] = dw[warp][r];
    matvec_acc_s(mt, lane, d, xw);
    run<true>(blk, f0, p, s, xp, xw);
    __syncwarp();
    store_warp<T, false>(p, s, base, lane, wstage);
}

bool aligned16(const void* ptr, long long S, long long si, long long sc,
               int elem) {
    return si == 1 && reinterpret_cast<uintptr_t>(ptr) % 16 == 0 &&
           (S == 1 || (sc * elem) % 16 == 0);
}

template <typename T>
int launch(Launch p, cudaStream_t st) {
    const BiquadGeometry g = biquad_geometry(p.n, p.S, p.K);
    p.spans = g.spans;
    p.vec_in = aligned16(p.x, p.S, p.xsi, p.xsc, sizeof(T));
    p.vec_out = aligned16(p.y, p.S, p.ysi, p.ysc, sizeof(T));
    cudaError_t rc = cudaFuncSetAttribute(
        biquad_span_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(g.smem));
    if (rc != cudaSuccess) return rc;
    biquad_span_kernel<T><<<static_cast<unsigned>(g.ctas), kBqThreads,
                            static_cast<size_t>(g.smem), st>>>(p);
    return cudaGetLastError();
}

}  // namespace

// One or two order-4 sections over x [n, S] at element strides (xsi, xsc),
// float32 for kind 0, float64 for kind 1, the first K frames valid; one
// launch a section on ``stream``.  Section i takes tab_i (its float64
// kernel_tables), xh_i and yh_i [4, S] float64 newest first, and writes
// the state after K frames to new_xh_i and new_yh_i [4, S]; section 1's
// output goes to mid (strides msi, msc) when there are two sections, and
// the last one's to y (strides ysi, ysc), both of x's type; section 2
// reads mid.  scratch: biquad_geometry's scratch words, zero when first
// allocated and kept for later calls on the stream; epoch: a number this
// stream's calls never used (the launch of section i takes epoch + i - 1).
// Returns the launches' cudaError_t (0 on success); arguments the kernel
// does not take return cudaErrorInvalidValue.
extern "C" int art_biquad_cascade(
    int sections, const void* x, long long n, long long S, long long xsi,
    long long xsc, int kind, long long K, const void* tab1, const void* xh1,
    const void* yh1, void* new_xh1, void* new_yh1, const void* tab2,
    const void* xh2, const void* yh2, void* new_xh2, void* new_yh2,
    void* mid, long long msi, long long msc, void* y, long long ysi,
    long long ysc, void* scratch, unsigned long long epoch, void* stream) {
    if (sections < 1 || sections > 2 || n < 0 || S < 1 || K < 0 || K > n ||
        (kind != 0 && kind != 1) || epoch == 0 || !scratch || !tab1 ||
        !xh1 || !yh1 || !new_xh1 || !new_yh1 ||
        (n > 0 && (!x || !y || (sections == 2 && !mid))) ||
        (sections == 2 && (!tab2 || !xh2 || !yh2 || !new_xh2 || !new_yh2)))
        return cudaErrorInvalidValue;
    if (biquad_geometry(n, S, K).ctas > 0x7fffffffLL)
        return cudaErrorInvalidValue;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    Launch p;
    p.n = n; p.K = K; p.S = static_cast<int>(S); p.spans = 0;
    p.vec_in = p.vec_out = 0;
    p.scratch = static_cast<u64*>(scratch);
    const void* tabs[2] = {tab1, tab2};
    const void* xhs[2] = {xh1, xh2};
    const void* yhs[2] = {yh1, yh2};
    void* nxs[2] = {new_xh1, new_xh2};
    void* nys[2] = {new_yh1, new_yh2};
    for (int i = 0; i < sections; ++i) {
        const bool last = i == sections - 1;
        p.x = i == 0 ? x : mid;
        p.xsi = i == 0 ? xsi : msi;
        p.xsc = i == 0 ? xsc : msc;
        p.y = last ? y : mid;
        p.ysi = last ? ysi : msi;
        p.ysc = last ? ysc : msc;
        p.sec.tab = static_cast<const double*>(tabs[i]);
        p.sec.xh = static_cast<const double*>(xhs[i]);
        p.sec.yh = static_cast<const double*>(yhs[i]);
        p.sec.new_xh = static_cast<double*>(nxs[i]);
        p.sec.new_yh = static_cast<double*>(nys[i]);
        p.epoch = epoch + i;
        const int rc = kind == 0 ? launch<float>(p, st)
                                 : launch<double>(p, st);
        if (rc != 0) return rc;
    }
    return 0;
}
