// One order-4 IIR section for NVIDIA Hopper (sm_90a), solved in float64 as
// a chunked linear recurrence: the device biquad cascade of the ART -p
// filters and of BASELINE config 4's chain.
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
// T is float or double.  A two-section cascade is two calls, the second
// reading the first's T output, as JAX's section 2 reads y1.astype(dt).
//
// What bounds it.  Each input sample is read and each output written once
// (the design below reads the input twice): at config 4b's chunk (6 x
// 524,320 float64) that is 50.3 MB, ~15 us at 3.35 TB/s, against 9
// float64 multiply-adds a sample (0.06 GFLOP; the design does them twice),
// ~2 us at the card's 34 TFLOP/s of float64 outside the tensor cores.  It
// is bound by bytes.  That is arithmetic from shapes and the data sheet,
// not a measurement.
//
// Design: three launches.  A stream's frames split into blocks of B
// frames, and Q blocks make a superblock, one CTA's tile.
//   1. biquad_block_kernel, one CTA of 128 threads per (superblock,
//      stream): the tile's input is staged in shared memory (coalesced
//      loads along time, the block's frames then read by its thread from
//      a padded transposed layout without bank conflicts), thread q runs
//      block q's FIR and the recurrence from zero state and keeps v_q, the
//      block's last 4 outputs (newest first); one thread then sums the
//      superblock's carry u_j = sum_q (A^B)^(Q-1-q) v_q as Horner's chain
//      u <- A^B u + v_q.  v and u go to a scratch buffer.  A thread takes
//      its frames 8 at a time into registers, so that their loads and FIR
//      terms overlap and only the recurrence's y_{t-1} -> y_t
//      multiply-add is serial.
//   2. biquad_carry_kernel, one CTA per stream: E_0 = yh, E_{j+1} =
//      (A^B)^Q E_j + u_j, the state entering each superblock, by one
//      thread from u staged in shared memory.  The chain is nb/Q steps
//      long, not nb (JAX's two-level carry, _iir_core_F2).
//   3. biquad_apply_kernel, one CTA per (superblock, stream): one thread
//      walks the state entering each block, e_0 = E_j, e_{q+1} = A^B e_q +
//      v_q; thread q reruns its block's recurrence from e_q (JAX adds
//      G[t] e_q to the stored zero-state output instead: rerunning reads
//      the input again, 4 or 8 bytes a frame, where storing y0 would write
//      and read 16), writes its outputs through shared memory (coalesced
//      stores) and the state at K.
// A^B and (A^B)^Q are the host's float64 tables (iir_tables' AB and ABQ).
// The in-CTA sums are serial chains of Q steps: the closed forms through
// the powers (A^B)^d, which JAX evaluates as matrix products, cost O(Q^2)
// multiply-adds a CTA here and took most of the time (PERF.md, PR 9).
// Every stream's work is the same whatever S is, so its outputs are
// bitwise independent of the batch width.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;   // per CTA of passes 1 and 3; Q <= kThreads
constexpr int kStep = 8;        // frames a thread takes at once; B % kStep == 0
constexpr int kCarry = 512;     // superblocks the carry stages at once

template <typename T> __device__ __forceinline__ T round_to(double v);
template <> __device__ __forceinline__ float round_to<float>(double v) {
    return __double2float_rn(v);
}
template <> __device__ __forceinline__ double round_to<double>(double v) {
    return v;
}

struct Geometry {
    long long n, K, nb, nsb;
    int S, B, Q;
};

// shared memory of passes 1 and 3: the tile [B][Q+1] (time t of block q at
// t*(Q+1) + q), the halo of 4 frames before it, v of the Q blocks [Q][4]
// and the states entering them [Q][4]
__host__ __device__ inline long long smem_doubles(int B, int Q) {
    return static_cast<long long>(B) * (Q + 1) + 4 + 8LL * Q;
}

// out += M x for a row-major 4x4 M
__device__ __forceinline__ void matvec_add(const double* M, const double* x,
                                           double* out) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
        out[r] = fma(M[4 * r + 3], x[3],
                     fma(M[4 * r + 2], x[2],
                         fma(M[4 * r + 1], x[1], fma(M[4 * r], x[0],
                                                     out[r]))));
}

// The CTA's tile of superblock j of stream s into shared memory: frames at
// and past K are 0 (never read), and the halo holds the 4 frames before
// the tile (oldest first), from xh before frame 0.
template <typename T>
__device__ void load_tile(const T* __restrict__ x, long long xsi,
                          long long xsc, const double* __restrict__ xh,
                          const Geometry& g, int s, long long t0,
                          double* tile, double* halo) {
    const int nt = g.B * g.Q;
    const T* xs = x + s * xsc;
    // kStep loads in flight per thread before any store to the tile
    for (int e0 = threadIdx.x; e0 < nt; e0 += kStep * blockDim.x) {
        double v[kStep];
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
            const int e = e0 + u * blockDim.x;
            const long long i = t0 + e;
            v[u] = e < nt && i < g.K ? static_cast<double>(xs[i * xsi])
                                     : 0.0;
        }
#pragma unroll
        for (int u = 0; u < kStep; ++u) {
            const int e = e0 + u * blockDim.x;
            if (e < nt) {
                const int q = e / g.B, t = e - q * g.B;
                tile[t * (g.Q + 1) + q] = v[u];
            }
        }
    }
    if (threadIdx.x < 4) {
        const long long i = t0 - 4 + threadIdx.x;
        halo[threadIdx.x] =
            i < 0 ? xh[(-1 - i) * g.S + s]
                  : (i < g.K ? static_cast<double>(xs[i * xsi]) : 0.0);
    }
}

// x'_{t-1} .. x'_{t-4} before block q's first frame: the previous block's
// last inputs in the tile, or the halo for block 0.  Read by every thread
// before a barrier, so that outputs may then overwrite the inputs.
__device__ __forceinline__ void block_prologue(const double* tile,
                                               const double* halo,
                                               const Geometry& g, int q,
                                               double* xp) {
    if (q == 0) {
        xp[0] = halo[3]; xp[1] = halo[2]; xp[2] = halo[1]; xp[3] = halo[0];
        return;
    }
    const int W = g.Q + 1;
    const double* prev = tile + (q - 1);
    xp[0] = prev[(g.B - 1) * W]; xp[1] = prev[(g.B - 2) * W];
    xp[2] = prev[(g.B - 3) * W]; xp[3] = prev[(g.B - 4) * W];
}

// Block q's recurrence from the state y1..y4 (y_{-1}..y_{-4} of the
// block) and the inputs xp before it, over its B frames from frame i0, in
// steps of kStep frames: the step's inputs come from the tile at once and
// its FIR terms are independent, so only the recurrence's own chain (one
// multiply-add from y_{t-1} to y_t) is serial.  With kApply the outputs
// replace the inputs in the tile (0 at and past K) and the state at K goes
// to new_xh/new_yh; without, the last 4 outputs go to v (newest first).
template <bool kApply>
__device__ void run_block(double* tile, const Geometry& g, int q,
                          long long i0, const double* __restrict__ ab,
                          const double* xp, double y1, double y2, double y3,
                          double y4, double* v, double* __restrict__ new_xh,
                          double* __restrict__ new_yh, int s) {
    const int W = g.Q + 1;
    double x1 = xp[0], x2 = xp[1], x3 = xp[2], x4 = xp[3];
    const double a0 = ab[0], a1 = ab[1], a2 = ab[2], a3 = ab[3], a4 = ab[4];
    const double b1 = ab[6], b2 = ab[7], b3 = ab[8], b4 = ab[9];
    double* col = tile + q;
    for (int t0 = 0; t0 < g.B; t0 += kStep) {
        double y[kStep];
#pragma unroll
        for (int u = 0; u < kStep; ++u) y[u] = col[(t0 + u) * W];
#pragma unroll
        for (int u = 0; u < kStep; ++u) {    // the input becomes f_t
            const long long i = i0 + t0 + u;
            const double x0 = y[u];
            y[u] = i < g.K ? fma(a4, x4, fma(a3, x3, fma(a2, x2,
                                                          fma(a1, x1,
                                                              a0 * x0))))
                           : 0.0;
            x4 = x3; x3 = x2; x2 = x1; x1 = x0;
            const long long r = g.K - 1 - i;     // row of the state at K
            if (kApply && r >= 0 && r < 4) new_xh[r * g.S + s] = x0;
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
                const long long i = i0 + t0 + u;
                col[(t0 + u) * W] = i < g.K ? y[u] : 0.0;
                const long long r = g.K - 1 - i;
                if (r >= 0 && r < 4) new_yh[r * g.S + s] = y[u];
            }
        }
    }
    if (!kApply) {
        v[0] = y1; v[1] = y2; v[2] = y3; v[3] = y4;
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) biquad_block_kernel(
    const T* __restrict__ x, long long xsi, long long xsc,
    const double* __restrict__ ab, const double* __restrict__ AB,
    const double* __restrict__ xh, Geometry g, double* __restrict__ vg,
    double* __restrict__ ug) {
    extern __shared__ double sm[];
    double* tile = sm;
    double* halo = tile + static_cast<long long>(g.B) * (g.Q + 1);
    double* vs = halo + 4;
    const long long j = blockIdx.x;
    const int s = blockIdx.y, q = threadIdx.x;
    const long long t0 = j * g.Q * g.B;
    load_tile(x, xsi, xsc, xh, g, s, t0, tile, halo);
    __syncthreads();
    const long long k = j * g.Q + q;             // this thread's block
    double xp[4], v[4] = {0.0, 0.0, 0.0, 0.0};
    if (q < g.Q && k < g.nb) {
        block_prologue(tile, halo, g, q, xp);
        run_block<false>(tile, g, q, t0 + q * g.B, ab, xp, 0.0, 0.0, 0.0,
                         0.0, v, nullptr, nullptr, s);
#pragma unroll
        for (int r = 0; r < 4; ++r) vg[(s * g.nb + k) * 4 + r] = v[r];
    }
    if (q < g.Q) {
#pragma unroll
        for (int r = 0; r < 4; ++r) vs[4 * q + r] = v[r];
    }
    __syncthreads();
    if (threadIdx.x == 0) {                      // u <- A^B u + v_q
        double M[16], u[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
        for (int e = 0; e < 16; ++e) M[e] = AB[e];
        for (int qq = 0; qq < g.Q; ++qq) {
            double next[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) next[r] = vs[4 * qq + r];
            matvec_add(M, u, next);
#pragma unroll
            for (int r = 0; r < 4; ++r) u[r] = next[r];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) ug[(s * g.nsb + j) * 4 + r] = u[r];
    }
}

__global__ void __launch_bounds__(kThreads) biquad_carry_kernel(
    const double* __restrict__ ABQ, const double* __restrict__ xh,
    const double* __restrict__ yh, Geometry g, const double* __restrict__ ug,
    double* __restrict__ Eg, double* __restrict__ new_xh,
    double* __restrict__ new_yh) {
    __shared__ double us[4 * kCarry], es[4 * kCarry];
    const int s = blockIdx.x;
    double M[16], E[4];
#pragma unroll
    for (int e = 0; e < 16; ++e) M[e] = ABQ[e];
#pragma unroll
    for (int r = 0; r < 4; ++r) E[r] = yh[r * g.S + s];
    for (long long j0 = 0; j0 < g.nsb; j0 += kCarry) {
        const int m = static_cast<int>(g.nsb - j0 < kCarry ? g.nsb - j0
                                                          : kCarry);
        const double* u = ug + (s * g.nsb + j0) * 4;
        for (int e = threadIdx.x; e < 4 * m; e += blockDim.x) us[e] = u[e];
        __syncthreads();
        if (threadIdx.x == 0) {
            for (int jj = 0; jj < m; ++jj) {
                double next[4];
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                    es[4 * jj + r] = E[r];
                    next[r] = us[4 * jj + r];
                }
                matvec_add(M, E, next);
#pragma unroll
                for (int r = 0; r < 4; ++r) E[r] = next[r];
            }
        }
        __syncthreads();
        double* out = Eg + (s * g.nsb + j0) * 4;
        for (int e = threadIdx.x; e < 4 * m; e += blockDim.x) out[e] = es[e];
        __syncthreads();
    }
    // the rows of the state at K that lie before frame 0
    const long long r = threadIdx.x;
    if (r >= g.K && r < 4) {
        new_xh[r * g.S + s] = xh[(r - g.K) * g.S + s];
        new_yh[r * g.S + s] = yh[(r - g.K) * g.S + s];
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) biquad_apply_kernel(
    const T* __restrict__ x, long long xsi, long long xsc,
    const double* __restrict__ ab, const double* __restrict__ AB,
    const double* __restrict__ xh, Geometry g,
    const double* __restrict__ vg, const double* __restrict__ Eg,
    double* __restrict__ new_xh, double* __restrict__ new_yh,
    T* __restrict__ y, long long ysi, long long ysc) {
    extern __shared__ double sm[];
    double* tile = sm;
    double* halo = tile + static_cast<long long>(g.B) * (g.Q + 1);
    double* vs = halo + 4;
    double* es = vs + 4 * g.Q;
    const long long j = blockIdx.x;
    const int s = blockIdx.y, q = threadIdx.x;
    const long long t0 = j * g.Q * g.B;
    const int nq = static_cast<int>(g.nb - j * g.Q < g.Q ? g.nb - j * g.Q
                                                         : g.Q);
    load_tile(x, xsi, xsc, xh, g, s, t0, tile, halo);
    for (int e = threadIdx.x; e < 4 * nq; e += blockDim.x)
        vs[e] = vg[(s * g.nb + j * g.Q) * 4 + e];
    __syncthreads();
    if (threadIdx.x == 0) {                      // e_{q+1} = A^B e_q + v_q
        double M[16], e[4];
#pragma unroll
        for (int i = 0; i < 16; ++i) M[i] = AB[i];
#pragma unroll
        for (int r = 0; r < 4; ++r) e[r] = Eg[(s * g.nsb + j) * 4 + r];
        for (int qq = 0; qq < nq; ++qq) {
            double next[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) {
                es[4 * qq + r] = e[r];
                next[r] = vs[4 * qq + r];
            }
            matvec_add(M, e, next);
#pragma unroll
            for (int r = 0; r < 4; ++r) e[r] = next[r];
        }
    }
    const bool mine = q < nq;
    double xp[4];
    if (mine) block_prologue(tile, halo, g, q, xp);
    __syncthreads();        // the tile's inputs are read; outputs follow
    if (mine)
        run_block<true>(tile, g, q, t0 + q * g.B, ab, xp, es[4 * q],
                        es[4 * q + 1], es[4 * q + 2], es[4 * q + 3], nullptr,
                        new_xh, new_yh, s);
    __syncthreads();
    const int nt = g.B * g.Q;
    T* ys = y + s * ysc;
#pragma unroll 4
    for (int e = threadIdx.x; e < nt; e += blockDim.x) {
        const long long i = t0 + e;
        if (i < g.n) {
            const int qq = e / g.B, t = e - qq * g.B;
            ys[i * ysi] = round_to<T>(tile[t * (g.Q + 1) + qq]);
        }
    }
}

template <typename T>
int launch(const void* x, long long xsi, long long xsc, const double* ab,
           const double* AB, const double* ABQ, const double* xh,
           const double* yh, const Geometry& g, double* work, double* new_xh,
           double* new_yh, void* y, long long ysi, long long ysc,
           cudaStream_t st) {
    const size_t smem = static_cast<size_t>(smem_doubles(g.B, g.Q)) *
                        sizeof(double);
    if (smem > 48 * 1024) {
        cudaError_t rc = cudaFuncSetAttribute(
            biquad_block_kernel<T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(smem));
        if (rc == cudaSuccess)
            rc = cudaFuncSetAttribute(
                biquad_apply_kernel<T>,
                cudaFuncAttributeMaxDynamicSharedMemorySize,
                static_cast<int>(smem));
        if (rc != cudaSuccess) return rc;
    }
    double* vg = work;
    double* ug = vg + 4 * g.S * g.nb;
    double* Eg = ug + 4 * g.S * g.nsb;
    const dim3 grid(static_cast<unsigned>(g.nsb), static_cast<unsigned>(g.S));
    biquad_block_kernel<T><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(x), xsi, xsc, ab, AB, xh, g, vg, ug);
    cudaError_t rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
    biquad_carry_kernel<<<g.S, kThreads, 0, st>>>(ABQ, xh, yh, g, ug, Eg,
                                                   new_xh, new_yh);
    rc = cudaGetLastError();
    if (rc != cudaSuccess) return rc;
    biquad_apply_kernel<T><<<grid, kThreads, smem, st>>>(
        static_cast<const T*>(x), xsi, xsc, ab, AB, xh, g, vg, Eg, new_xh,
        new_yh, static_cast<T*>(y), ysi, ysc);
    return cudaGetLastError();
}

}  // namespace

// One order-4 section over x [n, S] at element strides (xsi, xsc), float32
// for kind 0, float64 for kind 1, the first K frames valid; ab [10] =
// a0..a4, b0..b4 (b0 unused), AB [4][4] = A^B and ABQ [4][4] = (A^B)^Q
// (iir_tables at block B and superblock Q), xh and yh [4, S] newest first,
// all float64; work: 4 * S * (nb + 2 * nsb) doubles of scratch (nb =
// ceil(n / B), nsb = ceil(nb / Q)); the state at K to new_xh and new_yh
// [4, S] float64; the output, of x's type, to y at strides (ysi, ysc).
// Three kernels on ``stream`` (one when n is 0).  Returns the launches'
// cudaError_t (0 on success); arguments the kernels do not take return
// cudaErrorInvalidValue.
extern "C" int art_biquad_section(
    const void* x, long long n, long long S, long long xsi, long long xsc,
    int kind, long long K, const void* ab, const void* AB, const void* ABQ,
    int B, int Q, const void* xh, const void* yh, void* work, void* new_xh,
    void* new_yh, void* y, long long ysi, long long ysc, void* stream) {
    if (n < 0 || S < 1 || S > 65535 || K < 0 || K > n || B < kStep ||
        B % kStep || Q < 1 || Q > kThreads || !ab || !AB || !ABQ || !xh ||
        !yh || !new_xh || !new_yh || (n > 0 && (!x || !y || !work)))
        return cudaErrorInvalidValue;
    Geometry g;
    g.n = n; g.K = K; g.S = static_cast<int>(S); g.B = B; g.Q = Q;
    g.nb = (n + B - 1) / B;
    g.nsb = (g.nb + Q - 1) / Q;
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const auto* abd = static_cast<const double*>(ab);
    const auto* abm = static_cast<const double*>(AB);
    const auto* abq = static_cast<const double*>(ABQ);
    const auto* xhd = static_cast<const double*>(xh);
    const auto* yhd = static_cast<const double*>(yh);
    auto* w = static_cast<double*>(work);
    auto* nx = static_cast<double*>(new_xh);
    auto* ny = static_cast<double*>(new_yh);
    if (n == 0) {
        // no frame: the state is the history (K = 0)
        biquad_carry_kernel<<<g.S, kThreads, 0, st>>>(abq, xhd, yhd, g,
                                                       nullptr, nullptr, nx,
                                                       ny);
        return cudaGetLastError();
    }
    if (g.nsb > 0x7fffffffLL ||
        smem_doubles(B, Q) * static_cast<long long>(sizeof(double)) > 232448)
        return cudaErrorInvalidValue;
    if (kind == 0)
        return launch<float>(x, xsi, xsc, abd, abm, abq, xhd, yhd, g, w, nx,
                             ny, y, ysi, ysc, st);
    if (kind == 1)
        return launch<double>(x, xsi, xsc, abd, abm, abq, xhd, yhd, g, w, nx,
                              ny, y, ysi, ysc, st);
    return cudaErrorInvalidValue;
}
