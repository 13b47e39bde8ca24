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
// blocks are computed.  A CTA owns 128 output blocks x 32 phases of one
// channel:
//   - P (376 KB at the main path's shapes) does not fit shared memory, so
//     the CTA stages one M-row slice of its 32 (or 2x32) P columns at a
//     time: qn slices per CTA, ~19 KB each;
//   - the CTA's window segment [i0*M, (i0+128)*M + KQ) is staged once, as
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
// Offsets into buf and out are 64-bit: c*W and c*nb*L outgrow 2^31 for
// grouped flat buffers.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 32;                             // phases per CTA
constexpr int kTN = 4;                              // phases per thread
constexpr int kTM = 4;                              // blocks per thread
constexpr int kColThreads = kBN / kTN;              // 8
constexpr int kRowThreads = kThreads / kColThreads; // 32
constexpr int kBM = kRowThreads * kTM;              // 128 blocks per CTA
constexpr int kKB = 32;                             // terms per partial sum
constexpr size_t kMaxSmem = 227 * 1024;

__host__ __device__ inline int win_floats(int M, int qn) {
    // window rows of stride S = M | 1, padded so P's slice starts 16B-aligned
    return (((kBM + qn - 1) * (M | 1)) + 3) & ~3;
}

template <bool kInterp>
__global__ void __launch_bounds__(kThreads, 2)
fixed_step_kernel(const float* __restrict__ buf, long long W, long long start,
                  long long K, const float* __restrict__ P, int L2,
                  const float* __restrict__ fracv, int M, int L, int qn,
                  long long nb, float* __restrict__ out) {
    constexpr int BNt = kInterp ? 2 * kBN : kBN;
    extern __shared__ float4 smem4[];
    float* win_s = reinterpret_cast<float*>(smem4);
    float* P_s = win_s + win_floats(M, qn);
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
        __syncthreads();  // window staged / previous slice consumed
        const float* Pq = P + static_cast<long long>(q) * M * L2;
        for (int e = tid; e < M * BNt; e += kThreads) {
            const int m = e / BNt;
            const int j = e - m * BNt;
            const int col = n0 + (j % kBN);
            float v = 0.f;
            if (col < L)
                v = Pq[static_cast<long long>(m) * L2 + (j >= kBN ? L + col : col)];
            P_s[e] = v;
        }
        __syncthreads();
        const float* wq = win_s + (ty + q) * S;
        const float* pq = P_s + tx * kTN;
        for (int m0 = 0; m0 < M; m0 += kKB) {
            const int m1 = min(m0 + kKB, M);
            float part[kTM][kTN] = {};
            float part2[kInterp ? kTM : 1][kTN] = {};
#pragma unroll 4
            for (int m = m0; m < m1; ++m) {
                float a[kTM];
#pragma unroll
                for (int r = 0; r < kTM; ++r)
                    a[r] = wq[r * kRowThreads * S + m];
                const float4 b =
                    *reinterpret_cast<const float4*>(pq + m * BNt);
                const float bv[kTN] = {b.x, b.y, b.z, b.w};
#pragma unroll
                for (int r = 0; r < kTM; ++r)
#pragma unroll
                    for (int j = 0; j < kTN; ++j) part[r][j] += a[r] * bv[j];
                if constexpr (kInterp) {
                    const float4 b2 =
                        *reinterpret_cast<const float4*>(pq + m * BNt + kBN);
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

template <bool kInterp>
cudaError_t launch(const float* buf, long long ch, long long W,
                   long long start, long long K, const float* P, int L2,
                   const float* fracv, int M, int L, int qn, long long nb,
                   float* out, cudaStream_t stream) {
    const int BNt = kInterp ? 2 * kBN : kBN;
    const size_t smem = (static_cast<size_t>(win_floats(M, qn)) +
                         static_cast<size_t>(M) * BNt) * sizeof(float);
    const long long row_tiles = (nb + kBM - 1) / kBM;
    if (smem > kMaxSmem || row_tiles > 65535 || ch > 65535)
        return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        fixed_step_kernel<kInterp>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((L + kBN - 1) / kBN, static_cast<unsigned>(row_tiles),
                    static_cast<unsigned>(ch));
    fixed_step_kernel<kInterp><<<grid, kThreads, smem, stream>>>(
        buf, W, start, K, P, L2, fracv, M, L, qn, nb, out);
    return cudaGetLastError();
}

}  // namespace

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
