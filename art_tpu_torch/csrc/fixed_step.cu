// K1 for NVIDIA Hopper (sm_90a): the fixed-ratio streaming contraction.
//
// Replaces art_tpu/ops/fixed_pallas.py::fixed_step_pallas (body
// _fixed_kernel), the Pallas kernel of parallel/streams.py's chunk step,
// and, launched with start 0 and nothing masked, K6
// (art_tpu/ops/pallas_kernels.py::polyphase_apply_pallas).
// What it computes, for every channel c, output block i < nb and phase l < L:
//
//   out[c, i*L + l] = sum_{k < KQ} buf[c, start + i*M + k] * P[k, l]
//
// with KQ = qn*M, reads past the end of buf taken as zero, and out set to 0
// where i*L + l >= K.  With ``fracv`` (the interpolated mode) P stacks two
// phase banks [KQ, 2L] and the two dots are lerped per phase:
//   out = d1 * (1 - fracv[l]) + d2 * fracv[l]
// (reference subsample_interpolate, dot-then-lerp as in the JAX body).
//
// Three instances of one template, fixed_step_kernel<T, Acc, ...>, serve the
// engine's precision tiers (art_tpu/parallel/streams.py:604-620, which runs
// them as XLA dots, art_tpu/parallel/pipeline.py:39-143):
//   <float, float>    float32 data, the default tier;
//   <float, double>   precise=True and precise="int8": every product of two
//                     float32 values is exact in double, the dot is one
//                     DFMA chain, rounded once to float32
//                     (__double2float_rn); interpolated, both banks'
//                     dots are rounded, then lerped in float32 as JAX's
//                     graph computes it, fma(d1, 1 - f, d2 * f);
//   <double, double>  float64 data: bank, window, P, fracv and out in
//                     double, one DFMA chain, the lerp in double.
// "int8" is JAX's Ozaki-split int8 dot, a TPU route to the same
// single-rounding result; the <float, double> instance computes that
// function directly.
//
// What bounds it.  Per 2^22-frame stereo chunk at the main path's shapes
// (44.1k->48k, M=147, L=160, qn=4) the function needs 2 x 4.57M outputs x
// 380 FMAs (a phase's filter covers 380 of each P column's 588 rows; the
// other 208 are structural zeros) ~ 6.9 GFLOP against ~70 MB of input and
// output, ~100 FLOP/byte, so it is bound by the float32 FMA rate (67
// TFLOP/s on an H100 SXM at 700 W: a floor of about 0.1036 ms).  The
// double-accumulated instances do the same count of FP64 FMAs (67 TFLOP/s
// on the FP64 tensor cores, 34 on the CUDA cores these run on).  That is
// arithmetic from shapes and the data sheet, not a measurement.
//
// Design.  IEEE FMAs on the CUDA cores: no TF32, no tensor cores (Hopper's
// tensor cores have no IEEE float32 mode).  The TPU kernel's workarounds --
// the residue split, the 8-tile halo BlockSpec, split_out, rounding nb up
// to a multiple of qn -- are not carried over: exactly nb blocks are
// computed.  A CTA owns kBM output blocks (128 at the main path's shapes,
// see below) x 32 phases of one channel:
//   - the hull: the phase-l column of P is nonzero only on rows [carry(l),
//     carry(l) + taps), so a CTA's 32 columns (both banks' in the
//     interpolated form) are nonzero only inside a hull [klo, khi) of the
//     KQ rows: ~409 of 588 at the main path, ~78 of 294 at BASELINE
//     config 1.  Each CTA first reads its columns of P once (coalesced,
//     through L2) and finds its hull from P's values (first and last row
//     holding a nonzero), so a dense P (K6) keeps every row and no host
//     state or API decides it.  Staging and FMAs then cover the hull only;
//   - where it fits, the CTA's window segment [i0*M, (i0+kBM)*M + KQ) is
//     staged once, as rows of M samples at an odd row stride S, so row
//     i0+r+q holds the samples block r needs from slice q: element k =
//     q*M + m of block r's window is win_s[(r + q)*S + m], and the four
//     rows a warp reads at one m fall in four different banks (~77 KB at
//     M=147; for 8-byte elements the four rows' words are 2S apart, so
//     they still take four different bank pairs).  It is copied with
//     element-wide cp.async (rows start at any offset), a warp per row, so
//     no element needs a division, and it lands while the hull is found;
//   - P (376 KB at the main path's shapes) does not fit shared memory, so
//     it passes through in pieces of PR rows of one M-row slice of the
//     CTA's 32 (or 2x32) columns, the hull's rows only, copied with
//     cp.async; where two piece buffers still fit the CTA's share of the SM
//     (two CTAs per SM at the main path), piece p + 1 is copied while
//     piece p is used, else one buffer;
//   - where the whole window does not fit (M above ~1700 in float32), each
//     piece carries the window too: columns [m0, m0 + PR) of the kBM
//     window rows its slice's blocks read, at an odd row stride, so any M
//     fits.  The pieces and each output's terms keep their order;
//   - each thread accumulates a 4x4 register tile (4 blocks strided by 32,
//     4 phases: adjacent ones read as one float4, or, in double, two
//     pairs 16 phases apart read as two double2, so a quarter warp's
//     16-byte loads cover 128 contiguous bytes), so every k step does 5
//     (double: 6) shared loads for 16 FMAs;
//   - two CTAs share an SM where their shared memory allows, so one CTA's
//     hull scan and staging overlap the other's FMAs;
//   - in float32 each output's KQ-term dot is summed slice by slice, in
//     blocks of 32 terms (m = 0, 32, 64, ... of each slice) whose partial
//     sums, each started at +0, are then added to the total, instead of
//     one sequential FMA chain.  The chain's rounding error grows with the
//     ~190 terms added after the filter's centre to a full-size sum:
//     summed in one chain, the 60 s round trip read -133.91 dB on an H100
//     (the CPU's blocked sgemm -136.49 dB); blocks of 32 cost 16 registers
//     and ~3% more adds.  The double accumulators need no blocks: one DFMA
//     chain over k = 0, 1, ... .  The hull skips only terms whose P entry
//     is zero for every column of the CTA, and fma(a, 0, part) == part for
//     finite audio, so the bytes are those of the kernel that multiplied
//     every row, whatever the tile.
//
// Shared memory and M.  The window tile grows as (kBM + qn - 1) * M
// elements and a P piece as PR * BNt elements (BNt = 32, or 64
// interpolated), so a fixed 128-block tile runs out of the 227 KB a block
// may use near M = 360 (float32, reduced) and M = 300 (interpolated).  The
// host therefore picks the row tile kBM = 32 * TM, TM in {4, 2, 1}, and the
// P piece (PR rows of the slice): the largest tile whose whole window fits
// with PR = M, else the largest whose whole window fits with PR a multiple
// of kKB; failing both, the window in column pieces, the largest tile with
// the most whole 32-row blocks (pick_tile); then two piece buffers where
// they fit in the same occupancy (two CTAs per SM, or one), else one:
//   float32, M = 147, qn = 4 (the main path)   kBM = 128, PR = M, 2 buffers  114736 B
//   float32, M = 147, qn = 2, interpolated     kBM = 128, PR = M, 1 buffer   113552 B
//   float32, M = 320, qn = 2, reduced          kBM = 128, PR = M, 1 buffer   206672 B
//   float32, M = 320, qn = 2, interpolated     kBM =  64, PR = M, 1 buffer   165456 B
//   float32, M = 640, qn = 2, reduced          kBM =  32, PR = M, 1 buffer   166608 B
//   float32, M = 640, qn = 2, interpolated     kBM =  64, PR = 256, 1 buffer 232272 B
//   float32, M = 2560, qn = 2, reduced         column pieces, kBM = 128, PR = 352, 1 buffer 225856 B
//   float32, M = 2560, qn = 2, interpolated    column pieces, kBM = 128, PR = 288, 1 buffer 221760 B
//   float64, M = 160, qn = 4 (config 4)        kBM = 128, PR = M, 1 buffer   209760 B
// (two CTAs share an SM up to 115712 B each).  A piece holds whole 32-term
// blocks, so each output's partial sums are taken over the same terms k =
// q*M + m in the same order whatever the tile.
// Offsets into buf and out are 64-bit: c*W and c*nb*L outgrow 2^31 for
// grouped flat buffers.

#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 32;                             // phases per CTA
constexpr int kTN = 4;                              // phases per thread
constexpr int kColThreads = kBN / kTN;              // 8
constexpr int kRowThreads = kThreads / kColThreads; // 32
// blocks per thread, the largest tile first
constexpr int kTM0 = 4, kTM1 = 2, kTM2 = 1;
constexpr int kKB = 32;                             // terms per partial sum
constexpr size_t kMaxSmem = 227 * 1024;
// the most shared memory each of two CTAs on one SM may take: an SM has
// 228 KB, less 1 KB reserved per CTA
constexpr size_t kTwoPerSm = (228 * 1024 - 2 * 1024) / 2;
constexpr size_t kRedBytes = 2 * kWarps * sizeof(int);  // the hull's reduction

// The instances, as the host names them (art_fixed_step's ``kind``).
enum Kind { kF32 = 0, kF32Acc64 = 1, kF64 = 2 };

// Elements of the whole window segment of a kBM-block CTA: rows of stride
// S = M | 1, padded so what follows starts 16B-aligned.
__host__ __device__ inline int win_elems(int kBM, int M, int qn) {
    return (((kBM + qn - 1) * (M | 1)) + 3) & ~3;
}

// Elements of a window column piece: kBM rows of PR columns at the odd
// stride PR | 1, padded as above.
__host__ __device__ inline int wpiece_elems(int kBM, int PR) {
    return ((kBM * (PR | 1)) + 3) & ~3;
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(sizeof(T)) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The phase (within the CTA's 32) of thread column tx's j-th accumulator:
// 4 adjacent ones in float, two pairs 16 apart in double (see lds).
template <typename T>
__device__ __forceinline__ int colof(int tx, int j) {
    if constexpr (sizeof(T) == 4)
        return tx * kTN + j;
    else
        return (j >> 1) * (2 * kColThreads) + tx * 2 + (j & 1);
}

// Thread column tx's kTN P entries of one staged row, in 16-byte loads.
__device__ __forceinline__ void lds(const float* p, int tx, float (&v)[kTN]) {
    const float4 q = *reinterpret_cast<const float4*>(p + tx * kTN);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void lds(const double* p, int tx,
                                    double (&v)[kTN]) {
    const double2 a = *reinterpret_cast<const double2*>(p + tx * 2);
    const double2 b =
        *reinterpret_cast<const double2*>(p + 2 * kColThreads + tx * 2);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// Rows [*r0, *r1) of slice *q that piece t (rows [mp, mp + PR) of its
// slice, pps pieces a slice) holds inside the hull [klo, khi) of the KQ
// rows; none when *r0 >= *r1.
__device__ __forceinline__ void piece_rows(int t, int pps, int PR, int M,
                                           int klo, int khi, int* q, int* r0,
                                           int* r1) {
    *q = t / pps;
    const int mp = (t - *q * pps) * PR;
    *r0 = max(mp, klo - *q * M);
    *r1 = min(min(mp + PR, M), khi - *q * M);
}

// The first piece from t on that holds hull rows, or n (none).
__device__ __forceinline__ int next_piece(int t, int n, int pps, int PR,
                                          int M, int klo, int khi) {
    for (; t < n; ++t) {
        int q, r0, r1;
        piece_rows(t, pps, PR, M, klo, khi, &q, &r0, &r1);
        if (r0 < r1) break;
    }
    return t;
}

// T: data (window, P, fracv, out); Acc: the dot's accumulator.  Two CTAs
// per SM where float data's shared memory allows it, in 128 registers;
// one where double data's shared memory allows no more (see the header),
// and for the 32 double accumulators of a precise interpolated tile.
template <typename T, typename Acc, bool kInterp, int kTM>
__global__ void __launch_bounds__(
    kThreads,
    sizeof(T) == 4 && (std::is_same<Acc, float>::value || !kInterp) ? 2 : 1)
fixed_step_kernel(const T* __restrict__ buf, long long W, long long start,
                  long long K, const T* __restrict__ P, int L2,
                  const T* __restrict__ fracv, int M, int L, int qn,
                  int PR, int nbuf, int wpiece, long long nb,
                  T* __restrict__ out) {
    constexpr int BNt = kInterp ? 2 * kBN : kBN;
    constexpr int kBM = kRowThreads * kTM;
    // float accumulators sum in blocks of 32 terms (see the header)
    constexpr bool kBlocked = std::is_same<Acc, float>::value;
    extern __shared__ float4 smem4[];
    T* win_s = reinterpret_cast<T*>(smem4);       // whole window, if staged
    // nbuf piece buffers: P's piece, then (column pieces) the window's
    T* P_s = win_s + (wpiece ? 0 : win_elems(kBM, M, qn));
    const int bufsz = PR * BNt + (wpiece ? wpiece_elems(kBM, PR) : 0);
    int* red = reinterpret_cast<int*>(P_s + nbuf * bufsz);
    const int S = M | 1;
    const int SP = PR | 1;
    const int KQ = qn * M;

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int tx = tid % kColThreads;
    const int ty = tid / kColThreads;
    const int n0 = blockIdx.x * kBN;
    const long long i0 = static_cast<long long>(blockIdx.y) * kBM;
    const T* bufc = buf + static_cast<long long>(blockIdx.z) * W;

    // whole window segment, a warp per row: row r, column m is buf[start +
    // (i0 + r)*M + m] (zero past W), one cp.async group (empty when the
    // window comes in column pieces)
    if (!wpiece) {
        const long long g0 = start + i0 * M;
        for (int r = warp; r < kBM + qn - 1; r += kWarps)
            for (int m = lane; m < M; m += 32) {
                const long long g = g0 + static_cast<long long>(r) * M + m;
                if (g < W) cp_async(win_s + r * S + m, bufc + g);
                else win_s[r * S + m] = T(0);
            }
    }
    cp_async_commit();

    // The hull [klo, khi): the first and last of the KQ rows in which any
    // of the CTA's columns (of either bank) is nonzero.  Thread tid reads
    // column tid % BNt of every (kThreads / BNt)-th row.
    const int jc = tid % BNt;
    const int col = n0 + jc % kBN;
    int lo = INT_MAX, hi = -1;
    if (col < L) {
        const T* pc = P + (jc >= kBN ? L + col : col);
#pragma unroll 8
        for (int k = tid / BNt; k < KQ; k += kThreads / BNt) {
            const bool nz = __ldg(pc + static_cast<long long>(k) * L2) != T(0);
            lo = nz ? min(lo, k) : lo;
            hi = nz ? k : hi;
        }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
        red[warp] = lo;
        red[kWarps + warp] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        lo = min(lo, red[w]);
        hi = max(hi, red[kWarps + w]);
    }
    const int klo = lo, khi = hi + 1;      // empty when khi <= klo

    // piece t into buffer b, one group: its hull rows of the CTA's 32 (or
    // 2x32) columns of P (row m at (m - r0) * BNt, zero for columns past
    // L), and with column pieces the window rows i0 + q + r, r < kBM, at
    // columns [r0, r1) (row r, column m at r * SP + m - r0, zero past W)
    const int pps = (M + PR - 1) / PR;
    const int npieces = qn * pps;
    auto stage = [&](int t, int b) {
        int q, r0, r1;
        piece_rows(t, pps, PR, M, klo, khi, &q, &r0, &r1);
        T* dst = P_s + b * bufsz;
        const T* src = P + static_cast<long long>(q * M) * L2 +
                       (jc >= kBN ? L + col : col);
        for (int m = r0 + tid / BNt; m < r1; m += kThreads / BNt) {
            T* d = dst + (m - r0) * BNt + jc;
            if (col < L) cp_async(d, src + static_cast<long long>(m) * L2);
            else *d = T(0);
        }
        if (wpiece) {
            T* wd = dst + PR * BNt;
            const long long g0 = start + (i0 + q) * M;
            for (int r = warp; r < kBM; r += kWarps)
                for (int m = r0 + lane; m < r1; m += 32) {
                    const long long g = g0 + static_cast<long long>(r) * M + m;
                    T* d = wd + r * SP + (m - r0);
                    if (g < W) cp_async(d, bufc + g);
                    else *d = T(0);
                }
        }
        cp_async_commit();
    };

    Acc acc[kTM][kTN] = {};
    Acc acc2[kInterp ? kTM : 1][kTN] = {};
    int t = next_piece(0, npieces, pps, PR, M, klo, khi);
    if (t < npieces) stage(t, 0);
    for (int i = 0; t < npieces; ++i) {
        const int tn = next_piece(t + 1, npieces, pps, PR, M, klo, khi);
        if (nbuf == 2 && tn < npieces) {
            stage(tn, (i + 1) & 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();        // piece t (and the window) are in place
        int q, r0, r1;
        piece_rows(t, pps, PR, M, klo, khi, &q, &r0, &r1);
        // row m of the slice at pq + (m - r0) * BNt
        const T* pq = P_s + (nbuf == 2 ? (i & 1) : 0) * bufsz;
        // block ty + r * kRowThreads reads column m of slice q at
        // wp[r * kRowThreads * rs + m - mo]
        const T* wp = wpiece ? pq + PR * BNt + ty * SP : win_s + (ty + q) * S;
        const int rs = wpiece ? SP : S;
        const int mo = wpiece ? r0 : 0;
        if constexpr (kBlocked) {
            // blocks of 32 terms at m = 0, 32, ... of the slice, cut to the
            // hull
            for (int m0 = r0 & ~(kKB - 1); m0 < r1; m0 += kKB) {
                const int m1 = min(m0 + kKB, r1);
                Acc part[kTM][kTN] = {};
                Acc part2[kInterp ? kTM : 1][kTN] = {};
#pragma unroll 4
                for (int m = max(m0, r0); m < m1; ++m) {
                    T a[kTM];
#pragma unroll
                    for (int r = 0; r < kTM; ++r)
                        a[r] = wp[r * kRowThreads * rs + m - mo];
                    T bv[kTN];
                    lds(pq + (m - r0) * BNt, tx, bv);
#pragma unroll
                    for (int r = 0; r < kTM; ++r)
#pragma unroll
                        for (int j = 0; j < kTN; ++j)
                            part[r][j] += a[r] * bv[j];
                    if constexpr (kInterp) {
                        T bv2[kTN];
                        lds(pq + (m - r0) * BNt + kBN, tx, bv2);
#pragma unroll
                        for (int r = 0; r < kTM; ++r)
#pragma unroll
                            for (int j = 0; j < kTN; ++j)
                                part2[r][j] += a[r] * bv2[j];
                    }
                }
#pragma unroll
                for (int r = 0; r < kTM; ++r)
#pragma unroll
                    for (int j = 0; j < kTN; ++j) {
                        acc[r][j] += part[r][j];
                        if constexpr (kInterp) acc2[r][j] += part2[r][j];
                    }
            }
        } else {
            // one DFMA chain per output; a product of two floats is exact
            // in double
#pragma unroll 4
            for (int m = r0; m < r1; ++m) {
                Acc a[kTM];
#pragma unroll
                for (int r = 0; r < kTM; ++r)
                    a[r] = static_cast<Acc>(wp[r * kRowThreads * rs + m - mo]);
                T bv[kTN];
                lds(pq + (m - r0) * BNt, tx, bv);
#pragma unroll
                for (int r = 0; r < kTM; ++r)
#pragma unroll
                    for (int j = 0; j < kTN; ++j)
                        acc[r][j] = fma(a[r], static_cast<Acc>(bv[j]),
                                        acc[r][j]);
                if constexpr (kInterp) {
                    T bv2[kTN];
                    lds(pq + (m - r0) * BNt + kBN, tx, bv2);
#pragma unroll
                    for (int r = 0; r < kTM; ++r)
#pragma unroll
                        for (int j = 0; j < kTN; ++j)
                            acc2[r][j] = fma(a[r], static_cast<Acc>(bv2[j]),
                                             acc2[r][j]);
                }
            }
        }
        __syncthreads();        // the buffer piece t used may be refilled
        if (nbuf == 1 && tn < npieces) stage(tn, 0);
        t = tn;
    }
    cp_async_wait<0>();         // an empty hull never waited for the window

    T* outc = out + static_cast<long long>(blockIdx.z) * nb * L;
#pragma unroll
    for (int r = 0; r < kTM; ++r) {
        const long long i = i0 + ty + r * kRowThreads;
        if (i >= nb) continue;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
            const int l = n0 + colof<T>(tx, j);
            if (l >= L) continue;
            T v;
            if constexpr (std::is_same<T, Acc>::value) {
                v = acc[r][j];
                if constexpr (kInterp) {
                    const T f = fracv[l];
                    v = v * (T(1) - f) + acc2[r][j] * f;
                }
            } else {
                // precise: each dot rounded once; interpolated, the two
                // rounded dots lerped in float32 as JAX's graph computes it
                // once XLA has contracted it, fma(d1, 1 - f, d2 * f)
                // (measured bitwise on XLA:CPU, where two products then a
                // sum differ from it by an ulp in one output of ten), the
                // form the plain version emulates in float64
                v = __double2float_rn(acc[r][j]);
                if constexpr (kInterp) {
                    const float f = fracv[l];
                    v = __fmaf_rn(v, __fsub_rn(1.f, f),
                                  __fmul_rn(__double2float_rn(acc2[r][j]), f));
                }
            }
            const long long o = i * L + l;
            outc[o] = o < K ? v : T(0);
        }
    }
}

template <typename T, typename Acc, bool kInterp, int kTM>
cudaError_t launch_tile(const T* buf, long long ch, long long W,
                        long long start, long long K, const T* P, int L2,
                        const T* fracv, int M, int L, int qn, int PR,
                        int nbuf, int wpiece, long long nb, T* out,
                        size_t smem, cudaStream_t stream) {
    constexpr int kBM = kRowThreads * kTM;
    const long long row_tiles = (nb + kBM - 1) / kBM;
    if (row_tiles > 65535 || ch > 65535) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        fixed_step_kernel<T, Acc, kInterp, kTM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((L + kBN - 1) / kBN, static_cast<unsigned>(row_tiles),
                    static_cast<unsigned>(ch));
    fixed_step_kernel<T, Acc, kInterp, kTM><<<grid, kThreads, smem, stream>>>(
        buf, W, start, K, P, L2, fracv, M, L, qn, PR, nbuf, wpiece, nb, out);
    return cudaGetLastError();
}

// The tile for elements of esz bytes: the largest row tile (kTM = 4, 2, 1)
// whose whole window fits with a P piece of all M rows; failing that, the
// largest whose whole window fits with a piece of the most whole 32-row
// blocks that fit; failing that (M above ~1700 in float32), the window in
// column pieces beside P's, the largest tile with the most whole 32-row
// blocks; then two piece buffers where they keep the CTAs per SM that one
// allows.  Every M fits the last form.
bool pick_tile(int M, int qn, int BNt, int esz, int* tm, int* pr, int* nbuf,
               int* wpiece, size_t* smem) {
    constexpr int kTMs[] = {kTM0, kTM1, kTM2};
    size_t win = 0, piece = 0;
    bool found = false;
    for (int whole = 1; whole >= 0 && !found; --whole)
        for (const int t : kTMs) {
            win = static_cast<size_t>(win_elems(kRowThreads * t, M, qn)) *
                  esz + kRedBytes;
            if (win >= kMaxSmem) continue;
            const long long fit = static_cast<long long>(kMaxSmem - win) /
                                  (static_cast<long long>(esz) * BNt);
            const int rows = fit >= M ? M
                                      : static_cast<int>(fit / kKB) * kKB;
            if (rows <= 0 || (whole && rows != M)) continue;
            *tm = t;
            *pr = rows;
            *wpiece = 0;
            piece = static_cast<size_t>(rows) * BNt * esz;
            found = true;
            break;
        }
    for (int k = 0; k < 3 && !found; ++k) {
        const int t = kTMs[k];
        int rows = 0;
        for (int r = kKB; r - kKB < M; r += kKB) {
            const int rr = min(r, M);
            const size_t bytes =
                (static_cast<size_t>(rr) * BNt +
                 wpiece_elems(kRowThreads * t, rr)) * esz;
            if (bytes + kRedBytes > kMaxSmem) break;
            rows = rr;
        }
        if (rows <= 0) continue;
        *tm = t;
        *pr = rows;
        *wpiece = 1;
        win = kRedBytes;
        piece = (static_cast<size_t>(rows) * BNt +
                 wpiece_elems(kRowThreads * t, rows)) * esz;
        found = true;
    }
    if (!found) return false;
    const size_t cap = win + piece <= kTwoPerSm ? kTwoPerSm : kMaxSmem;
    *nbuf = win + 2 * piece <= cap ? 2 : 1;
    *smem = win + *nbuf * piece;
    return true;
}

template <typename T, typename Acc, bool kInterp>
cudaError_t launch(const T* buf, long long ch, long long W, long long start,
                   long long K, const T* P, int L2, const T* fracv, int M,
                   int L, int qn, long long nb, T* out, cudaStream_t stream) {
    int tm = 0, pr = 0, nbuf = 0, wpiece = 0;
    size_t smem = 0;
    if (!pick_tile(M, qn, kInterp ? 2 * kBN : kBN, sizeof(T), &tm, &pr,
                   &nbuf, &wpiece, &smem))
        return cudaErrorInvalidValue;
    if (tm == kTM0)
        return launch_tile<T, Acc, kInterp, kTM0>(
            buf, ch, W, start, K, P, L2, fracv, M, L, qn, pr, nbuf, wpiece,
            nb, out, smem, stream);
    if (tm == kTM1)
        return launch_tile<T, Acc, kInterp, kTM1>(
            buf, ch, W, start, K, P, L2, fracv, M, L, qn, pr, nbuf, wpiece,
            nb, out, smem, stream);
    return launch_tile<T, Acc, kInterp, kTM2>(
        buf, ch, W, start, K, P, L2, fracv, M, L, qn, pr, nbuf, wpiece, nb,
        out, smem, stream);
}

template <typename T, typename Acc>
cudaError_t launch_any(const void* buf, long long ch, long long W,
                       long long start, long long K, const void* P, int L2,
                       const void* fracv, int M, int L, int qn, long long nb,
                       void* out, cudaStream_t s) {
    const T* b = static_cast<const T*>(buf);
    const T* p = static_cast<const T*>(P);
    const T* f = static_cast<const T*>(fracv);
    T* o = static_cast<T*>(out);
    if (fracv)
        return launch<T, Acc, true>(b, ch, W, start, K, p, L2, f, M, L, qn,
                                    nb, o, s);
    return launch<T, Acc, false>(b, ch, W, start, K, p, L2, f, M, L, qn, nb,
                                 o, s);
}

}  // namespace

// The tile art_fixed_step would launch for (M, qn, interpolated, kind):
// writes blocks per CTA, P rows per piece and shared-memory bytes, and
// returns 0, or cudaErrorInvalidValue for arguments no launch takes.
extern "C" int art_fixed_step_tile(int M, int qn, int interp, int kind,
                                   int* bm, int* pr, long long* smem) {
    int tm = 0, rows = 0, nbuf = 0, wpiece = 0;
    size_t bytes = 0;
    if (M <= 0 || qn <= 0 || kind < kF32 || kind > kF64 ||
        !pick_tile(M, qn, interp ? 2 * kBN : kBN, kind == kF64 ? 8 : 4, &tm,
                   &rows, &nbuf, &wpiece, &bytes))
        return cudaErrorInvalidValue;
    *bm = kRowThreads * tm;
    *pr = rows;
    *smem = static_cast<long long>(bytes);
    return 0;
}

// buf [ch, W] and P [KQ, L2] contiguous on the device, fracv [L] or null,
// out [ch, nb*L]: float32 for kind kF32 and kF32Acc64 (accumulated in
// double), float64 for kF64.  Returns the launch's cudaError_t (0 on
// success); arguments the kernel does not take return
// cudaErrorInvalidValue.
extern "C" int art_fixed_step(const void* buf, long long ch, long long W,
                              long long start, long long K, const void* P,
                              int KQ, int L2, const void* fracv, int M,
                              int L, int qn, long long nb, void* out,
                              int kind, void* stream) {
    if (M <= 0 || L <= 0 || qn <= 0 || nb <= 0 || ch <= 0 || start < 0 ||
        K < 0 || K > nb * L || KQ != qn * M ||
        L2 != (fracv ? 2 * L : L))
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    switch (kind) {
        case kF32:
            return launch_any<float, float>(buf, ch, W, start, K, P, L2,
                                            fracv, M, L, qn, nb, out, s);
        case kF32Acc64:
            return launch_any<float, double>(buf, ch, W, start, K, P, L2,
                                             fracv, M, L, qn, nb, out, s);
        case kF64:
            return launch_any<double, double>(buf, ch, W, start, K, P, L2,
                                              fracv, M, L, qn, nb, out, s);
        default:
            return cudaErrorInvalidValue;
    }
}
