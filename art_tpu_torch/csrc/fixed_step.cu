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
// What bounds it.  Per 2^22-frame stereo chunk at the main path's shapes
// (44.1k->48k, M=147, L=160, qn=4) the function needs 2 x 4.57M outputs x
// 380 FMAs (a phase's filter covers 380 of each P column's 588 rows; the
// other 208 are structural zeros) ~ 6.9 GFLOP against ~70 MB of input and
// output, ~100 FLOP/byte, so it is bound by the float32 FMA rate (67
// TFLOP/s on an H100 SXM at 700 W: a floor of about 0.1036 ms).  That is
// arithmetic from shapes and the data sheet, not a measurement.
//
// Design.  IEEE float32 FMAs on the CUDA cores: no TF32, no tensor cores
// (Hopper's tensor cores have no IEEE float32 mode).  The TPU kernel's
// workarounds -- the residue split, the 8-tile halo BlockSpec, split_out,
// rounding nb up to a multiple of qn -- are not carried over: exactly nb
// blocks are computed.  A CTA owns kBM output blocks (128 at the main
// path's shapes, see below) x 32 phases of one channel:
//   - the hull: the phase-l column of P is nonzero only on rows [carry(l),
//     carry(l) + taps), so a CTA's 32 columns (both banks' in the
//     interpolated form) are nonzero only inside a hull [klo, khi) of the
//     KQ rows: ~409 of 588 at the main path, ~78 of 294 at BASELINE
//     config 1.  Each CTA first reads its columns of P once (coalesced,
//     through L2) and finds its hull from P's values (first and last row
//     holding a nonzero), so a dense P (K6) keeps every row and no host
//     state or API decides it.  Staging and FMAs then cover the hull only;
//   - the CTA's window segment [i0*M, (i0+kBM)*M + KQ) is staged once, as
//     rows of M samples at an odd row stride S, so row i0+r+q holds the
//     samples block r needs from slice q: element k = q*M + m of block r's
//     window is win_s[(r + q)*S + m], and the four rows a warp reads at one
//     m fall in four different banks (~77 KB at M=147).  It is copied with
//     4-byte cp.async (rows start at any offset), a warp per row, so no
//     element needs a division, and it lands while the hull is found;
//   - P (376 KB at the main path's shapes) does not fit shared memory, so
//     it passes through in pieces of PR rows of one M-row slice of the
//     CTA's 32 (or 2x32) columns, the hull's rows only, copied with 4-byte
//     cp.async; where two piece buffers still fit the CTA's share of the SM
//     (two CTAs per SM at the main path), piece p + 1 is
//     copied while piece p is used, else one buffer;
//   - each thread accumulates a 4x4 register tile (4 blocks strided by 32,
//     4 adjacent phases read as one float4), so every k step does 5 shared
//     loads for 16 FMAs;
//   - two CTAs share an SM where their shared memory allows, so one CTA's
//     hull scan and staging overlap the other's FMAs;
//   - each output's KQ-term dot is summed slice by slice, in blocks of 32
//     terms (m = 0, 32, 64, ... of each slice) whose partial sums, each
//     started at +0, are then added to the total, instead of one sequential
//     FMA chain.  The chain's rounding error grows with the ~190 terms added
//     after the filter's centre to a full-size sum: summed in one chain, the
//     60 s round trip read -133.91 dB on an H100 (the CPU's blocked sgemm
//     -136.49 dB); blocks of 32 cost 16 registers and ~3% more adds.  The
//     hull skips only terms whose P entry is zero for every column of the
//     CTA, and fma(a, 0, part) == part for finite audio, so the bytes are
//     those of the kernel that multiplied every row.
//
// Shared memory and M.  The window tile grows as (kBM + qn - 1) * M floats
// and a P piece as PR * BNt floats (BNt = 32, or 64 interpolated), so a
// fixed 128-block tile runs out of the 227 KB a block may use near M = 360
// (reduced) and M = 300 (interpolated): 192k->44.1k (M = 640) did not fit.
// The host therefore picks the row tile kBM = 32 * TM, TM in {4, 2, 1},
// and the P piece (PR rows of the slice): the largest tile that fits with
// PR = M, else the largest that fits with PR a multiple of kKB (pick_tile);
// then two piece buffers where they fit in the same occupancy (two CTAs per
// SM, or one), else one:
//   M = 147, qn = 4 (the main path)   kBM = 128, PR = M, 2 buffers  114736 B
//   M = 147, qn = 2, interpolated     kBM = 128, PR = M, 1 buffer   113552 B
//   M = 320, qn = 2, reduced          kBM = 128, PR = M, 1 buffer   206672 B
//   M = 320, qn = 2, interpolated     kBM =  64, PR = M, 1 buffer   165456 B
//   M = 640, qn = 2, reduced          kBM =  32, PR = M, 1 buffer   166608 B
//   M = 640, qn = 2, interpolated     kBM =  64, PR = 256, 1 buffer 232272 B
// (two CTAs share an SM up to 115712 B each).
// A piece holds whole 32-term blocks, so each output's partial sums are
// taken over the same terms k = q*M + m in the same order whatever the
// tile.  A shape whose 32-block window plus one 32-row piece exceeds 227 KB
// (M above ~1700) is refused, and the wrapper names it.
// Offsets into buf and out are 64-bit: c*W and c*nb*L outgrow 2^31 for
// grouped flat buffers.

#include <cuda_runtime.h>

#include <climits>

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

// blocks per thread kTM; the CTA owns kBM = 32 * kTM output blocks
__host__ __device__ inline int win_floats(int kBM, int M, int qn) {
    // window rows of stride S = M | 1, padded so P's piece starts 16B-aligned
    return (((kBM + qn - 1) * (M | 1)) + 3) & ~3;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// kTN adjacent P entries from shared memory in 16-byte loads
__device__ __forceinline__ void lds(const float* p, float (&v)[kTN]) {
#pragma unroll
    for (int c = 0; c < kTN; c += 4) {
        const float4 q = *reinterpret_cast<const float4*>(p + c);
        v[c] = q.x; v[c + 1] = q.y; v[c + 2] = q.z; v[c + 3] = q.w;
    }
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

template <bool kInterp, int kTM>
__global__ void __launch_bounds__(kThreads, 2)
fixed_step_kernel(const float* __restrict__ buf, long long W, long long start,
                  long long K, const float* __restrict__ P, int L2,
                  const float* __restrict__ fracv, int M, int L, int qn,
                  int PR, int nbuf, long long nb, float* __restrict__ out) {
    constexpr int BNt = kInterp ? 2 * kBN : kBN;
    constexpr int kBM = kRowThreads * kTM;
    extern __shared__ float4 smem4[];
    float* win_s = reinterpret_cast<float*>(smem4);
    float* P_s = win_s + win_floats(kBM, M, qn);    // nbuf pieces
    int* red = reinterpret_cast<int*>(P_s + nbuf * PR * BNt);
    const int S = M | 1;
    const int KQ = qn * M;

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int tx = tid % kColThreads;
    const int ty = tid / kColThreads;
    const int n0 = blockIdx.x * kBN;
    const long long i0 = static_cast<long long>(blockIdx.y) * kBM;
    const float* bufc = buf + static_cast<long long>(blockIdx.z) * W;

    // window segment, a warp per row: row r, column m is buf[start + (i0 +
    // r)*M + m] (zero past W), one cp.async group
    const long long g0 = start + i0 * M;
    for (int r = warp; r < kBM + qn - 1; r += kWarps)
        for (int m = lane; m < M; m += 32) {
            const long long g = g0 + static_cast<long long>(r) * M + m;
            if (g < W) cp_async4(win_s + r * S + m, bufc + g);
            else win_s[r * S + m] = 0.f;
        }
    cp_async_commit();

    // The hull [klo, khi): the first and last of the KQ rows in which any
    // of the CTA's columns (of either bank) is nonzero.  Thread tid reads
    // column tid % BNt of every (kThreads / BNt)-th row.
    const int jc = tid % BNt;
    const int col = n0 + jc % kBN;
    int lo = INT_MAX, hi = -1;
    if (col < L) {
        const float* pc = P + (jc >= kBN ? L + col : col);
#pragma unroll 8
        for (int k = tid / BNt; k < KQ; k += kThreads / BNt) {
            const bool nz = __ldg(pc + static_cast<long long>(k) * L2) != 0.f;
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

    // piece t's hull rows of the CTA's 32 (or 2x32) columns into buffer
    // dst: row m at (m - r0) * BNt, zero for columns past L; one group
    const int pps = (M + PR - 1) / PR;
    const int npieces = qn * pps;
    auto stage = [&](int t, float* dst) {
        int q, r0, r1;
        piece_rows(t, pps, PR, M, klo, khi, &q, &r0, &r1);
        const float* src = P + static_cast<long long>(q * M) * L2 +
                           (jc >= kBN ? L + col : col);
        for (int m = r0 + tid / BNt; m < r1; m += kThreads / BNt) {
            float* d = dst + (m - r0) * BNt + jc;
            if (col < L) cp_async4(d, src + static_cast<long long>(m) * L2);
            else *d = 0.f;
        }
        cp_async_commit();
    };

    float acc[kTM][kTN] = {};
    float acc2[kInterp ? kTM : 1][kTN] = {};
    int t = next_piece(0, npieces, pps, PR, M, klo, khi);
    if (t < npieces) stage(t, P_s);
    for (int i = 0; t < npieces; ++i) {
        const int tn = next_piece(t + 1, npieces, pps, PR, M, klo, khi);
        if (nbuf == 2 && tn < npieces) {
            stage(tn, P_s + ((i + 1) & 1) * PR * BNt);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();        // piece t (and the window) are in place
        int q, r0, r1;
        piece_rows(t, pps, PR, M, klo, khi, &q, &r0, &r1);
        // row m of the slice at pq + (m - r0) * BNt
        const float* pq = P_s + (nbuf == 2 ? (i & 1) * PR * BNt : 0) +
                          tx * kTN;
        const float* wp = win_s + (ty + q) * S;
        // blocks of 32 terms at m = 0, 32, ... of the slice, cut to the hull
        for (int m0 = r0 & ~(kKB - 1); m0 < r1; m0 += kKB) {
            const int m1 = min(m0 + kKB, r1);
            float part[kTM][kTN] = {};
            float part2[kInterp ? kTM : 1][kTN] = {};
#pragma unroll 4
            for (int m = max(m0, r0); m < m1; ++m) {
                float a[kTM];
#pragma unroll
                for (int r = 0; r < kTM; ++r)
                    a[r] = wp[r * kRowThreads * S + m];
                float bv[kTN];
                lds(pq + (m - r0) * BNt, bv);
#pragma unroll
                for (int r = 0; r < kTM; ++r)
#pragma unroll
                    for (int j = 0; j < kTN; ++j)
                        part[r][j] += a[r] * bv[j];
                if constexpr (kInterp) {
                    float bv2[kTN];
                    lds(pq + (m - r0) * BNt + kBN, bv2);
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
        __syncthreads();        // the buffer piece t used may be refilled
        if (nbuf == 1 && tn < npieces) stage(tn, P_s);
        t = tn;
    }
    cp_async_wait<0>();         // an empty hull never waited for the window

    float* outc = out + static_cast<long long>(blockIdx.z) * nb * L;
#pragma unroll
    for (int r = 0; r < kTM; ++r) {
        const long long i = i0 + ty + r * kRowThreads;
        if (i >= nb) continue;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
            const int l = n0 + tx * kTN + j;
            if (l >= L) continue;
            float v = acc[r][j];
            if constexpr (kInterp) {
                const float f = fracv[l];
                v = v * (1.f - f) + acc2[r][j] * f;
            }
            const long long o = i * L + l;
            outc[o] = o < K ? v : 0.f;
        }
    }
}

template <bool kInterp, int kTM>
cudaError_t launch_tile(const float* buf, long long ch, long long W,
                        long long start, long long K, const float* P, int L2,
                        const float* fracv, int M, int L, int qn, int PR,
                        int nbuf, long long nb, float* out, size_t smem,
                        cudaStream_t stream) {
    constexpr int kBM = kRowThreads * kTM;
    const long long row_tiles = (nb + kBM - 1) / kBM;
    if (row_tiles > 65535 || ch > 65535) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        fixed_step_kernel<kInterp, kTM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((L + kBN - 1) / kBN, static_cast<unsigned>(row_tiles),
                    static_cast<unsigned>(ch));
    fixed_step_kernel<kInterp, kTM><<<grid, kThreads, smem, stream>>>(
        buf, W, start, K, P, L2, fracv, M, L, qn, PR, nbuf, nb, out);
    return cudaGetLastError();
}

// The tile: the largest row tile (kTM = 4, 2, 1) whose window fits with a
// P piece of all M rows; failing that, the largest whose window fits with a
// piece of the most whole 32-row blocks that fit; then two piece buffers
// where they keep the CTAs per SM that one allows.  Returns false when not
// even a 32-block window with a 32-row piece fits in kMaxSmem.
bool pick_tile(int M, int qn, int BNt, int* tm, int* pr, int* nbuf,
               size_t* smem) {
    constexpr int kTMs[] = {kTM0, kTM1, kTM2};
    for (int whole = 1; whole >= 0; --whole)
        for (const int t : kTMs) {
            const size_t win = static_cast<size_t>(
                win_floats(kRowThreads * t, M, qn)) * 4 + kRedBytes;
            if (win >= kMaxSmem) continue;
            const long long fit =
                static_cast<long long>(kMaxSmem - win) / (4LL * BNt);
            const int rows = fit >= M ? M
                                      : static_cast<int>(fit / kKB) * kKB;
            if (rows <= 0 || (whole && rows != M)) continue;
            const size_t piece = static_cast<size_t>(rows) * BNt * 4;
            const size_t cap = win + piece <= kTwoPerSm ? kTwoPerSm
                                                        : kMaxSmem;
            *tm = t;
            *pr = rows;
            *nbuf = win + 2 * piece <= cap ? 2 : 1;
            *smem = win + *nbuf * piece;
            return true;
        }
    return false;
}

template <bool kInterp>
cudaError_t launch(const float* buf, long long ch, long long W,
                   long long start, long long K, const float* P, int L2,
                   const float* fracv, int M, int L, int qn, long long nb,
                   float* out, cudaStream_t stream) {
    int tm = 0, pr = 0, nbuf = 0;
    size_t smem = 0;
    if (!pick_tile(M, qn, kInterp ? 2 * kBN : kBN, &tm, &pr, &nbuf, &smem))
        return cudaErrorInvalidValue;
    if (tm == kTM0)
        return launch_tile<kInterp, kTM0>(buf, ch, W, start, K, P, L2, fracv,
                                          M, L, qn, pr, nbuf, nb, out, smem,
                                          stream);
    if (tm == kTM1)
        return launch_tile<kInterp, kTM1>(buf, ch, W, start, K, P, L2, fracv,
                                          M, L, qn, pr, nbuf, nb, out, smem,
                                          stream);
    return launch_tile<kInterp, kTM2>(buf, ch, W, start, K, P, L2, fracv, M,
                                      L, qn, pr, nbuf, nb, out, smem, stream);
}

}  // namespace

// The tile art_fixed_step would launch for (M, qn, interpolated): writes
// blocks per CTA, P rows per piece and shared-memory bytes, and returns 0,
// or cudaErrorInvalidValue when the shape does not fit.
extern "C" int art_fixed_step_tile(int M, int qn, int interp, int* bm,
                                   int* pr, long long* smem) {
    int tm = 0, rows = 0, nbuf = 0;
    size_t bytes = 0;
    if (M <= 0 || qn <= 0 ||
        !pick_tile(M, qn, interp ? 2 * kBN : kBN, &tm, &rows, &nbuf, &bytes))
        return cudaErrorInvalidValue;
    *bm = kRowThreads * tm;
    *pr = rows;
    *smem = static_cast<long long>(bytes);
    return 0;
}

// buf [ch, W] and P [KQ, L2] float32 contiguous on the device, fracv [L] or
// null, out [ch, nb*L].  Returns the launch's cudaError_t (0 on success);
// arguments the kernel does not take return cudaErrorInvalidValue.
extern "C" int art_fixed_step(const float* buf, long long ch, long long W,
                              long long start, long long K, const float* P,
                              int KQ, int L2, const float* fracv, int M,
                              int L, int qn, long long nb, float* out,
                              void* stream) {
    if (M <= 0 || L <= 0 || qn <= 0 || nb <= 0 || ch <= 0 || start < 0 ||
        K < 0 || K > nb * L || KQ != qn * M ||
        L2 != (fracv ? 2 * L : L))
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (fracv)
        return launch<true>(buf, ch, W, start, K, P, L2, fracv, M, L, qn, nb,
                            out, s);
    return launch<false>(buf, ch, W, start, K, P, L2, fracv, M, L, qn, nb,
                         out, s);
}
