// K1 for NVIDIA Hopper (sm_90a): the fixed-ratio streaming contraction.
//
// Replaces art_tpu/ops/fixed_pallas.py::fixed_step_pallas (body
// _fixed_kernel), the Pallas kernel of parallel/streams.py's chunk step.
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
// TFLOP/s on an H100 SXM at 700 W: a floor of about 0.10 ms).  That is
// arithmetic from shapes and the data sheet, not a measurement.  This kernel
// multiplies all 588 rows; a later kernel may skip the zeros.
//
// Design.  IEEE float32 FMAs on the CUDA cores: no TF32, no tensor cores
// (Hopper's tensor cores have no IEEE float32 mode).  The TPU kernel's
// workarounds -- the residue split, the 8-tile halo BlockSpec, split_out,
// rounding nb up to a multiple of qn -- are not carried over: exactly nb
// blocks are computed.  A CTA owns kBM output blocks (128 at the main
// path's shapes, see below) x 32 phases of one
// channel:
//   - P (376 KB at the main path's shapes) does not fit shared memory, so
//     the CTA stages one M-row slice of its 32 (or 2x32) P columns at a
//     time: qn slices per CTA, ~19 KB each;
//   - the CTA's window segment [i0*M, (i0+kBM)*M + KQ) is staged once, as
//     rows of M samples at an odd row stride S, so row i0+r+q holds the
//     samples block r needs from slice q: element k = q*M + m of block r's
//     window is win_s[(r + q)*S + m], and the four rows a warp reads at one
//     m fall in four different banks (~77 KB at M=147);
//   - each thread accumulates a 4x4 register tile (4 blocks strided by 32,
//     4 adjacent phases read as one float4), so every k step does 5 shared
//     loads for 16 FMAs;
//   - ~96 KB of shared memory lets two CTAs share an SM, so one CTA's
//     staging overlaps the other's FMAs;
//   - each output's KQ-term dot is summed in blocks of 32 terms whose
//     partial sums are then added, instead of one sequential FMA chain.
//     The chain's rounding error grows with the ~190 terms added after
//     the filter's centre to a full-size sum: summed in one chain, the
//     60 s round trip read -133.91 dB on an H100 (the CPU's blocked sgemm
//     -136.49 dB); blocks of 32 cost 16 registers and ~3% more adds.
//
// Shared memory and M.  The window tile grows as (kBM + qn - 1) * M floats
// and the P slice as M * BNt floats (BNt = 32, or 64 interpolated), so a
// fixed 128-block tile runs out of the 227 KB a block may use near M = 360
// (reduced) and M = 300 (interpolated): 192k->44.1k (M = 640) did not fit.
// The host therefore picks the row tile kBM = 32 * TM, TM in {4, 2, 1},
// and the P piece (PR rows of the slice): the largest tile that fits with
// PR = M, else the largest that fits with PR a multiple of kKB (pick_tile):
//   M = 147, qn = 4 (the main path)   kBM = 128, PR = M     96 KB
//   M = 320, qn = 2, reduced          kBM = 128, PR = M    207 KB
//   M = 320, qn = 2, interpolated     kBM =  64, PR = M    165 KB
//   M = 640, qn = 2, reduced          kBM =  32, PR = M    167 KB
//   M = 640, qn = 2, interpolated     kBM =  64, PR = 256  232 KB
// A piece holds whole 32-term blocks, so each output's partial sums are
// taken over the same terms k = q*M + m in the same order whatever the
// tile: the outputs are bitwise those of the 128-block kernel.  A shape
// whose 32-block window plus one 32-row piece exceeds 227 KB (M above
// ~1700) is refused, and the wrapper names it.
// Offsets into buf and out are 64-bit: c*W and c*nb*L outgrow 2^31 for
// grouped flat buffers.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 32;                             // phases per CTA
constexpr int kTN = 4;                              // phases per thread
constexpr int kColThreads = kBN / kTN;              // 8
constexpr int kRowThreads = kThreads / kColThreads; // 32
constexpr int kKB = 32;                             // terms per partial sum
constexpr size_t kMaxSmem = 227 * 1024;

// blocks per thread kTM; the CTA owns kBM = 32 * kTM output blocks
__host__ __device__ inline int win_floats(int kBM, int M, int qn) {
    // window rows of stride S = M | 1, padded so P's piece starts 16B-aligned
    return (((kBM + qn - 1) * (M | 1)) + 3) & ~3;
}

template <bool kInterp, int kTM>
__global__ void __launch_bounds__(kThreads, 2)
fixed_step_kernel(const float* __restrict__ buf, long long W, long long start,
                  long long K, const float* __restrict__ P, int L2,
                  const float* __restrict__ fracv, int M, int L, int qn,
                  int PR, long long nb, float* __restrict__ out) {
    constexpr int BNt = kInterp ? 2 * kBN : kBN;
    constexpr int kBM = kRowThreads * kTM;
    extern __shared__ float4 smem4[];
    float* win_s = reinterpret_cast<float*>(smem4);
    float* P_s = win_s + win_floats(kBM, M, qn);
    const int S = M | 1;

    const int tid = threadIdx.x;
    const int tx = tid % kColThreads;
    const int ty = tid / kColThreads;
    const int n0 = blockIdx.x * kBN;
    const long long i0 = static_cast<long long>(blockIdx.y) * kBM;
    const float* bufc = buf + static_cast<long long>(blockIdx.z) * W;

    // window segment: row r, column m is buf[start + (i0 + r)*M + m]; the
    // rows are contiguous in buf, so element e of the segment is g0 + e
    const long long g0 = start + i0 * M;
    const int nwin = (kBM + qn - 1) * M;
    for (int e = tid; e < nwin; e += kThreads) {
        const int r = e / M;
        const long long g = g0 + e;
        win_s[r * S + (e - r * M)] = g < W ? bufc[g] : 0.f;
    }

    float acc[kTM][kTN] = {};
    float acc2[kInterp ? kTM : 1][kTN] = {};
    for (int q = 0; q < qn; ++q) {
        const float* Pq = P + static_cast<long long>(q) * M * L2;
        const float* wq = win_s + (ty + q) * S;
        for (int mp = 0; mp < M; mp += PR) {
            // stage rows [mp, mp + PR) of slice q's 32 (or 2x32) columns
            const int rows = min(PR, M - mp);
            __syncthreads();  // window staged / previous piece consumed
            for (int e = tid; e < rows * BNt; e += kThreads) {
                const int m = e / BNt;
                const int j = e - m * BNt;
                const int col = n0 + (j % kBN);
                float v = 0.f;
                if (col < L)
                    v = Pq[static_cast<long long>(mp + m) * L2 +
                           (j >= kBN ? L + col : col)];
                P_s[e] = v;
            }
            __syncthreads();
            // piece-local row index: the inner loop has PR 1's form
            const float* pq = P_s + tx * kTN;
            const float* wp = wq + mp;
            for (int m0 = 0; m0 < rows; m0 += kKB) {
                const int m1 = min(m0 + kKB, rows);
                float part[kTM][kTN] = {};
                float part2[kInterp ? kTM : 1][kTN] = {};
#pragma unroll 4
                for (int m = m0; m < m1; ++m) {
                    float a[kTM];
#pragma unroll
                    for (int r = 0; r < kTM; ++r)
                        a[r] = wp[r * kRowThreads * S + m];
                    const float4 b =
                        *reinterpret_cast<const float4*>(pq + m * BNt);
                    const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
                    for (int r = 0; r < kTM; ++r)
#pragma unroll
                        for (int j = 0; j < kTN; ++j)
                            part[r][j] += a[r] * bv[j];
                    if constexpr (kInterp) {
                        const float4 b2 = *reinterpret_cast<const float4*>(
                            pq + m * BNt + kBN);
                        const float bv2[kTN] = {b2.x, b2.y, b2.z, b2.w};
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
        }
    }

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
                        long long nb, float* out, size_t smem,
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
        buf, W, start, K, P, L2, fracv, M, L, qn, PR, nb, out);
    return cudaGetLastError();
}

// The tile: the largest row tile (kTM = 4, 2, 1) whose window fits with a
// P piece of all M rows; failing that, the largest whose window fits with a
// piece of the most whole 32-row blocks that fit.  Returns false when not
// even a 32-block window with a 32-row piece fits in kMaxSmem.
bool pick_tile(int M, int qn, int BNt, int* tm, int* pr, size_t* smem) {
    for (int whole = 1; whole >= 0; --whole)
        for (int t = 4; t >= 1; t /= 2) {
            const size_t win = static_cast<size_t>(
                win_floats(kRowThreads * t, M, qn)) * 4;
            if (win >= kMaxSmem) continue;
            const long long fit =
                static_cast<long long>(kMaxSmem - win) / (4LL * BNt);
            const int rows = fit >= M ? M
                                      : static_cast<int>(fit / kKB) * kKB;
            if (rows <= 0 || (whole && rows != M)) continue;
            *tm = t;
            *pr = rows;
            *smem = win + static_cast<size_t>(rows) * BNt * 4;
            return true;
        }
    return false;
}

template <bool kInterp>
cudaError_t launch(const float* buf, long long ch, long long W,
                   long long start, long long K, const float* P, int L2,
                   const float* fracv, int M, int L, int qn, long long nb,
                   float* out, cudaStream_t stream) {
    int tm = 0, pr = 0;
    size_t smem = 0;
    if (!pick_tile(M, qn, kInterp ? 2 * kBN : kBN, &tm, &pr, &smem))
        return cudaErrorInvalidValue;
    if (tm == 4)
        return launch_tile<kInterp, 4>(buf, ch, W, start, K, P, L2, fracv, M,
                                       L, qn, pr, nb, out, smem, stream);
    if (tm == 2)
        return launch_tile<kInterp, 2>(buf, ch, W, start, K, P, L2, fracv, M,
                                       L, qn, pr, nb, out, smem, stream);
    return launch_tile<kInterp, 1>(buf, ch, W, start, K, P, L2, fracv, M, L,
                                   qn, pr, nb, out, smem, stream);
}

}  // namespace

// The tile art_fixed_step would launch for (M, qn, interpolated): writes
// blocks per CTA, P rows per piece and shared-memory bytes, and returns 0,
// or cudaErrorInvalidValue when the shape does not fit.
extern "C" int art_fixed_step_tile(int M, int qn, int interp, int* bm,
                                   int* pr, long long* smem) {
    int tm = 0, rows = 0;
    size_t bytes = 0;
    if (M <= 0 || qn <= 0 ||
        !pick_tile(M, qn, interp ? 2 * kBN : kBN, &tm, &rows, &bytes))
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
