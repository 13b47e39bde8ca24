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
//                           precomputed base/fi/frac), served by asrc_apply.
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
// asrc_apply computes, from given base/fi/frac [S, K],
//   out[s, k] = (1 - frac) sum_t buf[s, base + t] bank[fi, t]
//             +      frac  sum_t buf[s, base + t] bank[fi + 1, t]
// unmasked (the caller masks), as the K5 body does.
//
// What bounds it.  At BASELINE config 5 (256 streams, 380 taps, 380 filters,
// 32768-frame chunks, ratios 1 +- 1%) one call makes ~8.39M outputs of 380
// taps, two FMAs per tap (the lerp and the dot): ~12.8 GFLOP, ~0.19 ms at the
// 67 TFLOP/s float32 rate of an H100 SXM (also ~0.19 ms in float64 at the
// 67 TFLOP/s of its FP64 tensor cores; 0.38 ms on the CUDA cores alone),
// against ~75 MB of history, input and output (~0.02 ms at 3.35 TB/s); that
// is arithmetic from shapes and the data sheet.  What bounds the kernel is
// the bank: [381, 380] (579 KB in float32, 1.16 MB in float64) does not fit
// the 227 KB of shared memory a block may use, and every output gathers two
// of its rows (3,040 B in float32), so one call asks ~25 GB (float32) or
// ~51 GB (float64) of the L1/L2 caches.  Measured on an H100 80GB HBM3 at
// 700 W (PERF.md): 2.98 ms per float32 call, 7.21 ms per float64 call and
// 3.26 ms per apply call, all near 8.4 TB/s of bank-row traffic.
//
// Design (right and simple first).
//   - A grid of (output tiles, streams): a block of 8 warps owns kTile = 128
//     consecutive outputs of one stream, warp w takes outputs w, w + 8, ...,
//     so the block's warps read overlapping windows at the same time.
//   - One warp per output: lane l takes taps 4l..4l+3, 4l+128.., so the
//     bank rows are read in 16-byte loads and neighbouring lanes read
//     neighbouring addresses of the window and of both rows (coalesced),
//     through the read-only cache (__ldg).  buf is read from hist and x in
//     place, no concat: a window wholly inside one of them (all outputs but
//     the ~taps around the seam) is read straight, with no per-tap clamp or
//     select.  That fast path took the float32 step from 6.84 to 2.98 ms.
//   - Each lane keeps one partial sum of its ~12 taps (FMAs in T); the warp
//     then adds the 32 partial sums in a butterfly of shuffles: a blocked
//     summation order, like K1's blocks of 32.  The float64 instance
//     accumulates in double throughout.
//   - Outputs at k >= Ks[s] are written as 0 without being computed; a tile
//     that lies wholly past Ks[s] writes its zeros coalesced and returns.
//   - Offsets into hist, x, buf and out are 64-bit.
// The TPU kernels' workarounds are not carried over: no double-single
// position or bank planes, no Hankel carry/roll tiers or hankel_smax bounds,
// no one-hot coarse alignment, no transposed lane-padded bank tables, no
// fold_low, no pack_step_scalars, no S % 8 geometry.  One kernel takes any S
// and any positive ratio (and any taps % 4 == 0, which resampleInit
// requires).  Cutting the bank traffic (outputs that share a phase row
// sharing its load, or a bank staged per block) is work for a later kernel.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPerWarp = 16;
constexpr int kTile = kWarps * kPerWarp;   // outputs per block

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
    return v;
}

// Four consecutive taps of a bank row in 16-byte loads (rows start 16-byte
// aligned: taps % 4 == 0 and the bank is 16-byte aligned).
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, double (&v)[4]) {
    const double2 a = __ldg(reinterpret_cast<const double2*>(p));
    const double2 b = __ldg(reinterpret_cast<const double2*>(p) + 1);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
asrc_step_kernel(const T* __restrict__ hist, long long H,
                 const T* __restrict__ x, long long n,
                 const T* __restrict__ bank, int taps, int F,
                 const double* __restrict__ offsets,
                 const double* __restrict__ ratios,
                 const int* __restrict__ Ks, long long shift,
                 long long k_max, T* __restrict__ out) {
    const int s = blockIdx.y;
    const long long k0 = static_cast<long long>(blockIdx.x) * kTile;
    const long long Ks_s = Ks[s];
    T* out_s = out + static_cast<long long>(s) * k_max;
    if (k0 >= Ks_s) {                      // the whole tile is masked
        for (long long k = k0 + threadIdx.x; k < k0 + kTile && k < k_max;
             k += kThreads)
            out_s[k] = T(0);
        return;
    }
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const T* hist_s = hist + static_cast<long long>(s) * H;
    const T* x_s = x + static_cast<long long>(s) * n;
    const long long last = H + n - 1;
    const double off = offsets[s];
    const double ratio = ratios[s];
    const int half = taps / 2;

    for (int i = 0; i < kPerWarp; ++i) {
        const long long k = k0 + warp + static_cast<long long>(i) * kWarps;
        if (k >= k_max) break;
        if (k >= Ks_s) {
            if (lane == 0) out_s[k] = T(0);
            continue;
        }
        const double pos = __dadd_rn(off, __ddiv_rn(static_cast<double>(k),
                                                    ratio));
        const double ip = floor(pos);
        const double ff = __dmul_rn(__dsub_rn(pos, ip),
                                    static_cast<double>(F));
        const int fi = min(static_cast<int>(floor(ff)), F - 1);
        const T frac = static_cast<T>(__dsub_rn(ff, static_cast<double>(fi)));
        const T one_m = T(1) - frac;
        const long long base = static_cast<long long>(ip) - half + 1 + shift;
        const T* b1 = bank + static_cast<long long>(fi) * taps;
        const T* b2 = b1 + taps;
        // the window lies wholly in hist or wholly in x for all but the
        // ~taps outputs around the seam (warp-uniform branch); only those
        // pay the per-tap clamp and select
        const T* win = nullptr;
        if (base >= 0 && base + taps <= H)
            win = hist_s + base;
        else if (base >= H && base + taps <= H + n)
            win = x_s + (base - H);
        T acc = T(0);
        for (int t = 4 * lane; t < taps; t += 128) {
            T w1[4], w2[4], v[4];
            load4(b1 + t, w1);
            load4(b2 + t, w2);
            if (win != nullptr) {
#pragma unroll
                for (int u = 0; u < 4; ++u) v[u] = __ldg(win + t + u);
            } else {
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const long long j = min(max(base + t + u, 0LL), last);
                    v[u] = j < H ? __ldg(hist_s + j) : __ldg(x_s + (j - H));
                }
            }
#pragma unroll
            for (int u = 0; u < 4; ++u)
                acc += v[u] * (w1[u] * one_m + w2[u] * frac);
        }
        acc = warp_sum(acc);
        if (lane == 0) out_s[k] = acc;
    }
}

__global__ void __launch_bounds__(kThreads)
asrc_apply_kernel(const float* __restrict__ buf, long long B,
                  const float* __restrict__ bank, int taps, int F,
                  const int* __restrict__ base, const int* __restrict__ fi,
                  const float* __restrict__ frac, long long K,
                  float* __restrict__ out) {
    const int s = blockIdx.y;
    const long long k0 = static_cast<long long>(blockIdx.x) * kTile;
    const int warp = threadIdx.x / 32;
    const int lane = threadIdx.x % 32;
    const float* buf_s = buf + static_cast<long long>(s) * B;
    const long long row = static_cast<long long>(s) * K;
    for (int i = 0; i < kPerWarp; ++i) {
        const long long k = k0 + warp + static_cast<long long>(i) * kWarps;
        if (k >= K) break;
        // the prologue keeps every window inside buf and every phase in
        // [0, F - 1]; the clamps only keep a bad argument from reading out
        // of bounds
        const long long b = min(max(static_cast<long long>(base[row + k]), 0LL),
                                B - taps);
        const int f = min(max(fi[row + k], 0), F - 1);
        const float* w = buf_s + b;
        const float* b1 = bank + static_cast<long long>(f) * taps;
        const float* b2 = b1 + taps;
        float d1 = 0.f, d2 = 0.f;
        for (int t = 4 * lane; t < taps; t += 128) {
            float w1[4], w2[4];
            load4(b1 + t, w1);
            load4(b2 + t, w2);
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const float v = __ldg(w + t + u);
                d1 += v * w1[u];
                d2 += v * w2[u];
            }
        }
        d1 = warp_sum(d1);
        d2 = warp_sum(d2);
        if (lane == 0) {
            const float fr = frac[row + k];
            out[row + k] = d1 * (1.f - fr) + d2 * fr;
        }
    }
}

template <typename T>
int launch_step(const T* hist, long long H, const T* x, long long n,
                long long S, const T* bank, int taps, int F,
                const double* offsets, const double* ratios, const int* Ks,
                long long shift, long long k_max, T* out, void* stream) {
    const long long tiles = (k_max + kTile - 1) / kTile;
    if (S <= 0 || S > 65535 || H < 0 || n < 0 || H + n < 1 || taps <= 0 ||
        taps % 4 || F <= 0 || k_max <= 0 || tiles > 0x7fffffffLL ||
        reinterpret_cast<uintptr_t>(bank) % 16)
        return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(S));
    asrc_step_kernel<T><<<grid, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        hist, H, x, n, bank, taps, F, offsets, ratios, Ks, shift, k_max, out);
    return cudaGetLastError();
}

}  // namespace

// hist [S, H], x [S, n], bank [F + 1, taps] (T contiguous on the device),
// offsets and ratios float64 [S], Ks int32 [S], out [S, k_max].  Return the
// launch's cudaError_t (0 on success); arguments the kernel does not take
// return cudaErrorInvalidValue.
extern "C" int art_asrc_step_f32(const float* hist, long long H,
                                 const float* x, long long n, long long S,
                                 const float* bank, int taps, int F,
                                 const double* offsets, const double* ratios,
                                 const int* Ks, long long shift,
                                 long long k_max, float* out, void* stream) {
    return launch_step<float>(hist, H, x, n, S, bank, taps, F, offsets,
                              ratios, Ks, shift, k_max, out, stream);
}

extern "C" int art_asrc_step_f64(const double* hist, long long H,
                                 const double* x, long long n, long long S,
                                 const double* bank, int taps, int F,
                                 const double* offsets, const double* ratios,
                                 const int* Ks, long long shift,
                                 long long k_max, double* out, void* stream) {
    return launch_step<double>(hist, H, x, n, S, bank, taps, F, offsets,
                               ratios, Ks, shift, k_max, out, stream);
}

// buf [S, B], bank [F + 1, taps], frac and out [S, K] float32, base and fi
// int32 [S, K], all contiguous on the device.
extern "C" int art_asrc_apply_f32(const float* buf, long long S, long long B,
                                  const float* bank, int taps, int F,
                                  const int* base, const int* fi,
                                  const float* frac, long long K, float* out,
                                  void* stream) {
    const long long tiles = (K + kTile - 1) / kTile;
    if (S <= 0 || S > 65535 || taps <= 0 || taps % 4 || B < taps ||
        F <= 0 || K <= 0 || tiles > 0x7fffffffLL ||
        reinterpret_cast<uintptr_t>(bank) % 16)
        return cudaErrorInvalidValue;
    const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(S));
    asrc_apply_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        buf, B, bank, taps, F, base, fi, frac, K, out);
    return cudaGetLastError();
}
