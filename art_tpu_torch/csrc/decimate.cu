// The device decimate stage for NVIDIA Hopper (sm_90a): TPDF dither,
// quantization (flat or noise-shaped), clip count and little-endian byte
// packing of float samples.
//
// Replaces the XLA code of art_tpu/ops/decimate_device.py (no Pallas
// there): tpdf_dither_dev + advance_states + quantize_flat_dev +
// pack_bytes_dev (decimate_flat_kernel) and tpdf_dither_dev +
// quantize_shaped_dev + pack_bytes_dev (decimate_shaped_kernel), as
// engines/decimator.py::_device_decimate_step and
// parallel/pipeline.py::pipeline_chunk chain them.  What they compute, per
// channel c and frame i < K (reference decimator.c:152-194, 370-382):
//
//   dither   the LCG g -> ((g << 4) - g) ^ 1 stepped 5 times per frame
//            from gens[c]; with g0 the state entering the frame, r2 and r5
//            the states 2 and 5 steps on, first = ~g0 (type -1), g0
//            (type 1) or ~r2 (any other type), d = ((first >> 1) + (r5 >>
//            1)) / 2^31 - 1 in double, then rounded to T;
//   flat     code = fl(fl(x * scaler) - fb); ov = floor(double(fl(code +
//            d)) + 0.5);
//   shaped   the same code and ov with fb the shaper's last output, then
//            err = T(ov) - code and the 4th-order error-feedback filter
//            in quantize_shaped_dev's op order:
//              s = err*a0; s += xh3*a4 - b4*yh3; s += xh2*a3 - b3*yh2;
//              s += xh1*a2 - b2*yh1; s += xh0*a1 - b1*yh0;
//            xh <- [err, xh0, xh1, xh2], yh <- [s, yh0, yh1, yh2], fb <- s;
//   clip     ov above highclip or below lowclip is counted and clamped;
//   pack     v = (uint32(ov) << (24 - bits) % 8) + (bits <= 8 ? 128 : 0),
//            its (bits + 7) / 8 low bytes after nbytes - (bits + 7) / 8
//            zero bytes.
// Frames i in [K, n) pack ov = 0 and touch neither the clip count nor the
// state (they may hold NaN); the LCG state returned is the one after 5K
// steps (K = 0 keeps it), the shaper's after K frames.
//
// Every rounding is spelled out (__fmul_rn, __fsub_rn, __fadd_rn,
// __dmul_rn, __dadd_rn, __dsub_rn, __double2float_rn), so nvcc contracts
// nothing into an FMA whatever its flags: the bytes are a bit-exact
// contract with the host decimator.  A float32 product of float32 operands
// rounded once is what JAX's _mul_for computes through a float64 product.
//
// What bounds them.  decimate_flat_kernel reads each sample once and
// writes its nbytes packed bytes once: at a 2^22-frame stereo float32
// chunk to 16 bits that is 33.6 MB + 16.8 MB, ~15 us at 3.35 TB/s, while
// its ~60 integer and floating operations a sample are far below the
// card's rates: it is bound by bytes.  decimate_shaped_kernel is a serial
// recurrence (floor() inside the feedback loop) per channel: one thread
// runs each channel's K frames in order, so it is bound by the latency of
// one frame's chain of ~14 dependent operations, not by any rate.  That
// is arithmetic from shapes and the data sheet, not a measurement.
//
// Design.
//   - Layouts by strides.  Samples are read at x[i*xsi + c*xsc] (elements)
//     and each frame's slot written at out[i*osi + c*osc] (bytes), so one
//     kernel reads K1's [ch, capacity] output with no transpose and writes
//     either the interleaved [n, S*nbytes] stream or a per-channel
//     uint8/16/32 container (nbytes 1, 2 or 4 are stored as one word: the
//     host keeps those slots aligned).
//   - Dither without tables.  JAX precomputes [5n] tables of the LCG's
//     closed form (40 bytes a frame at 2^22 frames, more than the audio).
//     Here each state is reached by jumping: two steps are the affine map
//     g -> 225 g + 14 (g even) or 225 g - 14 (g odd), which keeps the
//     parity, so 2m steps are that map's m-th power, composed by squaring
//     in O(log m).  In the flat kernel lane l of a warp owns frames i0 + l
//     + 32 j (coalesced loads), jumps once to its first frame and then 160
//     steps (32 frames) at a time with one precomputed affine map; each
//     frame's dither takes the 5 steps from its entry state.
//   - Clip count: a warp and block reduction, then one atomicAdd into an
//     int32 per block.
//   - The shaped kernel keeps fb, xh, yh and the LCG state in registers,
//     and loads its samples 16 frames ahead of the recurrence.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRun = 8;                          // frames per lane
constexpr long long kTile = 32LL * kRun * kWarps; // frames per block
constexpr int kAhead = 16;                       // shaped: frames loaded ahead

// every product and sum rounded on its own: nvcc contracts none of these
// into an FMA
__device__ __forceinline__ float mul(float a, float b) {
    return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul(double a, double b) {
    return __dmul_rn(a, b);
}
__device__ __forceinline__ float add(float a, float b) {
    return __fadd_rn(a, b);
}
__device__ __forceinline__ double add(double a, double b) {
    return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
    return __fsub_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
    return __dsub_rn(a, b);
}
template <typename T> __device__ __forceinline__ T from_double(double v);
template <> __device__ __forceinline__ float from_double<float>(double v) {
    return __double2float_rn(v);
}
template <> __device__ __forceinline__ double from_double<double>(double v) {
    return v;
}

__device__ __forceinline__ uint32_t lcg_step(uint32_t g) {
    return ((g << 4) - g) ^ 1u;
}

struct Affine {                 // g -> a*g + b (mod 2^32)
    uint32_t a, b;
};

__device__ __forceinline__ Affine compose(Affine f, Affine g) {  // f(g(x))
    return {f.a * g.a, f.a * g.b + f.b};
}

// the map of 2*pairs steps from a state of parity ``odd``
__device__ Affine pair_power(bool odd, unsigned long long pairs) {
    Affine f = {225u, odd ? 0u - 14u : 14u};
    Affine acc = {1u, 0u};
    while (pairs) {
        if (pairs & 1ull) acc = compose(f, acc);
        f = compose(f, f);
        pairs >>= 1;
    }
    return acc;
}

// the state ``steps`` steps after g
__device__ uint32_t lcg_jump(uint32_t g, unsigned long long steps) {
    const Affine f = pair_power(g & 1u, steps >> 1);
    g = f.a * g + f.b;
    return (steps & 1ull) ? lcg_step(g) : g;
}

// one frame's TPDF draw from its entry state g; *after: the state 5 steps on
__device__ __forceinline__ double tpdf(uint32_t g, int type, uint32_t* after) {
    const uint32_t r1 = lcg_step(g), r2 = lcg_step(r1), r3 = lcg_step(r2),
                   r4 = lcg_step(r3), r5 = lcg_step(r4);
    *after = r5;
    const uint32_t first = type == -1 ? ~g : (type == 1 ? g : ~r2);
    const double sum = __dadd_rn(static_cast<double>(first >> 1),
                                 static_cast<double>(r5 >> 1));
    // / 2^31 is exact, so it is the product by 2^-31
    return __dsub_rn(__dmul_rn(sum, 1.0 / 2147483648.0), 1.0);
}

struct Pack {
    int shift, offset, pre_bits, nbytes;
    uint32_t mask;
};

__device__ __forceinline__ uint32_t slot(const Pack& p, int ov) {
    const uint32_t v = (static_cast<uint32_t>(ov) << p.shift) +
                       static_cast<uint32_t>(p.offset);
    return (v & p.mask) << p.pre_bits;
}

__device__ __forceinline__ void store(uint8_t* dst, uint32_t word,
                                      int nbytes) {
    switch (nbytes) {
        case 1: *dst = static_cast<uint8_t>(word); break;
        case 2: *reinterpret_cast<uint16_t*>(dst) =
                    static_cast<uint16_t>(word); break;
        case 4: *reinterpret_cast<uint32_t*>(dst) = word; break;
        default:
            dst[0] = static_cast<uint8_t>(word);
            dst[1] = static_cast<uint8_t>(word >> 8);
            dst[2] = static_cast<uint8_t>(word >> 16);
    }
}

// floor(double(v) + 0.5), v = code + d already rounded to T
template <typename T>
__device__ __forceinline__ double round_half_up(T v) {
    return floor(__dadd_rn(static_cast<double>(v), 0.5));
}

// f clamped to [lo, hi] as an int; *nclip counts it when it was outside
__device__ __forceinline__ int clamp_count(double f, int hi, int lo,
                                           int* nclip) {
    if (f > hi || f < lo) ++*nclip;
    return static_cast<int>(fmin(fmax(f, static_cast<double>(lo)),
                                 static_cast<double>(hi)));
}

__device__ __forceinline__ void add_clips(int nclip, int* clips) {
    __shared__ int part[kWarps];
    nclip = __reduce_add_sync(0xffffffffu, nclip);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) part[warp] = nclip;
    __syncthreads();
    if (threadIdx.x == 0) {
        int total = 0;
        for (int w = 0; w < kWarps; ++w) total += part[w];
        if (total) atomicAdd(clips, total);
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) decimate_flat_kernel(
    const T* __restrict__ x, long long n, int S, long long xsi,
    long long xsc, long long K, T scaler, const T* __restrict__ fb,
    const uint32_t* __restrict__ gens, int dithered, int dither_type,
    uint32_t* __restrict__ new_gens, int hi, int lo, Pack pk,
    uint8_t* __restrict__ out, long long osi, long long osc,
    int* __restrict__ clips) {
    const int c = static_cast<int>(blockIdx.x % S);
    const long long tile = blockIdx.x / S;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const long long i0 = tile * kTile + warp * (32LL * kRun) + lane;
    const T f = fb ? fb[c] : T(0);
    uint32_t g = 0;
    Affine next = {1u, 0u};
    if (dithered) {
        const uint32_t s0 = gens[c];
        if (i0 == 0 && K == 0) new_gens[c] = s0;
        g = lcg_jump(s0, 5ull * static_cast<unsigned long long>(i0));
        next = pair_power(g & 1u, 5 * 32 / 2);   // 32 frames on
    }
    int nclip = 0;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
        const long long i = i0 + 32LL * j;
        if (i < n) {
            int ov = 0;
            if (i < K) {
                T v = sub(mul(x[i * xsi + c * xsc], scaler), f);
                if (dithered) {
                    uint32_t after;
                    const double d = tpdf(g, dither_type, &after);
                    v = add(v, from_double<T>(d));
                    if (i == K - 1) new_gens[c] = after;
                }
                ov = clamp_count(round_half_up(v), hi, lo, &nclip);
            }
            store(out + i * osi + c * osc, slot(pk, ov), pk.nbytes);
        }
        g = next.a * g + next.b;
    }
    add_clips(nclip, clips);
}

template <typename T>
__global__ void decimate_shaped_kernel(
    const T* __restrict__ x, long long n, int S, long long xsi,
    long long xsc, long long K, T scaler, const T* __restrict__ fb,
    const T* __restrict__ ab, const T* __restrict__ xh,
    const T* __restrict__ yh, const uint32_t* __restrict__ gens,
    int dithered, int dither_type, uint32_t* __restrict__ new_gens,
    T* __restrict__ new_fb, T* __restrict__ new_xh, T* __restrict__ new_yh,
    int hi, int lo, Pack pk, uint8_t* __restrict__ out, long long osi,
    long long osc, int* __restrict__ clips) {
    const int c = blockIdx.x * blockDim.x + threadIdx.x;
    if (c >= S) return;
    const T a0 = ab[0], a1 = ab[1], a2 = ab[2], a3 = ab[3], a4 = ab[4];
    const T b1 = ab[6], b2 = ab[7], b3 = ab[8], b4 = ab[9];
    T f = fb[c];
    T x0 = xh[c], x1 = xh[S + c], x2 = xh[2 * S + c], x3 = xh[3 * S + c];
    T y0 = yh[c], y1 = yh[S + c], y2 = yh[2 * S + c], y3 = yh[3 * S + c];
    uint32_t g = dithered ? gens[c] : 0u;
    const T* xc = x + c * xsc;
    uint8_t* oc = out + c * osc;
    int nclip = 0;
    T cur[kAhead], nxt[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) cur[u] = u < K ? xc[u * xsi] : T(0);
    for (long long base = 0; base < K; base += kAhead) {
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
            const long long i = base + kAhead + u;
            nxt[u] = i < K ? xc[i * xsi] : T(0);
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) {
            const long long i = base + u;
            if (i < K) {
                const T code = sub(mul(cur[u], scaler), f);
                T v = code;
                if (dithered) {
                    uint32_t after;
                    v = add(code, from_double<T>(tpdf(g, dither_type,
                                                      &after)));
                    g = after;
                }
                const double fl = round_half_up(v);
                const T err = sub(from_double<T>(fl), code);
                T s = mul(err, a0);
                s = add(s, sub(mul(x3, a4), mul(b4, y3)));
                s = add(s, sub(mul(x2, a3), mul(b3, y2)));
                s = add(s, sub(mul(x1, a2), mul(b2, y1)));
                s = add(s, sub(mul(x0, a1), mul(b1, y0)));
                x3 = x2; x2 = x1; x1 = x0; x0 = err;
                y3 = y2; y2 = y1; y1 = y0; y0 = s;
                f = s;
                store(oc + i * osi, slot(pk, clamp_count(fl, hi, lo,
                                                         &nclip)),
                      pk.nbytes);
            }
        }
#pragma unroll
        for (int u = 0; u < kAhead; ++u) cur[u] = nxt[u];
    }
    const uint32_t zero = slot(pk, 0);
    for (long long i = K; i < n; ++i) store(oc + i * osi, zero, pk.nbytes);
    new_fb[c] = f;
    new_xh[c] = x0; new_xh[S + c] = x1; new_xh[2 * S + c] = x2;
    new_xh[3 * S + c] = x3;
    new_yh[c] = y0; new_yh[S + c] = y1; new_yh[2 * S + c] = y2;
    new_yh[3 * S + c] = y3;
    if (dithered) new_gens[c] = g;
    if (nclip) atomicAdd(clips, nclip);
}

// the arguments both kernels share; 0 when the kernels take them
int check(long long n, long long S, long long K, int bits, int nbytes,
          const void* out, long long osi, long long osc, Pack* pk) {
    const int used = (bits + 7) / 8;
    if (n < 0 || S < 1 || S > (1 << 30) || K < 0 || K > n || bits < 4 ||
        bits > 24 || nbytes < used || nbytes > 4)
        return cudaErrorInvalidValue;
    if (nbytes != 3) {
        const auto addr = reinterpret_cast<uintptr_t>(out);
        if (addr % nbytes || osi % nbytes || osc % nbytes)
            return cudaErrorInvalidValue;
    }
    pk->shift = (24 - bits) % 8;
    pk->offset = bits <= 8 ? 128 : 0;
    pk->pre_bits = 8 * (nbytes - used);
    pk->nbytes = nbytes;
    pk->mask = (1u << (8 * used)) - 1u;
    return 0;
}

}  // namespace

// x [n, S] at element strides (xsi, xsc): float32 for kind 0, float64 for
// kind 1; fb [S] of x's type or null (zero); gens and new_gens [S] uint32,
// read and written only when ``dithered``; out: frame i of channel c at
// byte i*osi + c*osc; clips: one int32 the kernel adds the clipped count
// of frames i < K to.  Returns the launch's cudaError_t (0 on success);
// arguments the kernel does not take return cudaErrorInvalidValue.
extern "C" int art_decimate_flat(const void* x, long long n, long long S,
                                 long long xsi, long long xsc, int kind,
                                 long long K, double scaler, const void* fb,
                                 const void* gens, int dithered,
                                 int dither_type, void* new_gens,
                                 int highclip, int lowclip, int bits,
                                 int nbytes, void* out, long long osi,
                                 long long osc, void* clips, void* stream) {
    Pack pk;
    if (const int rc = check(n, S, K, bits, nbytes, out, osi, osc, &pk))
        return rc;
    if (dithered && (!gens || !new_gens)) return cudaErrorInvalidValue;
    if (n == 0) return 0;
    const long long blocks = (n + kTile - 1) / kTile * S;
    if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* g = static_cast<const uint32_t*>(gens);
    auto* ng = static_cast<uint32_t*>(new_gens);
    auto* o = static_cast<uint8_t*>(out);
    auto* cl = static_cast<int*>(clips);
    const int Si = static_cast<int>(S);
    if (kind == 0)
        decimate_flat_kernel<float><<<blocks, kThreads, 0, s>>>(
            static_cast<const float*>(x), n, Si, xsi, xsc, K,
            static_cast<float>(scaler), static_cast<const float*>(fb), g,
            dithered, dither_type, ng, highclip, lowclip, pk, o, osi, osc,
            cl);
    else if (kind == 1)
        decimate_flat_kernel<double><<<blocks, kThreads, 0, s>>>(
            static_cast<const double*>(x), n, Si, xsi, xsc, K, scaler,
            static_cast<const double*>(fb), g, dithered, dither_type, ng,
            highclip, lowclip, pk, o, osi, osc, cl);
    else
        return cudaErrorInvalidValue;
    return cudaGetLastError();
}

// As art_decimate_flat, with fb [S] required and the shaper: ab [10] = a0..a4
// then b0..b4, xh and yh [4, S] (row 0 the newest), all of x's type; the
// state after K frames goes to new_fb [S], new_xh and new_yh [4, S] and,
// when ``dithered``, new_gens.  Output frames of one channel in order, one
// thread per channel.
extern "C" int art_decimate_shaped(
    const void* x, long long n, long long S, long long xsi, long long xsc,
    int kind, long long K, double scaler, const void* fb, const void* ab,
    const void* xh, const void* yh, const void* gens, int dithered,
    int dither_type, void* new_gens, void* new_fb, void* new_xh,
    void* new_yh, int highclip, int lowclip, int bits, int nbytes,
    void* out, long long osi, long long osc, void* clips, void* stream) {
    Pack pk;
    if (const int rc = check(n, S, K, bits, nbytes, out, osi, osc, &pk))
        return rc;
    if (!fb || !ab || !xh || !yh || !new_fb || !new_xh || !new_yh ||
        (dithered && (!gens || !new_gens)))
        return cudaErrorInvalidValue;
    if (n == 0) return 0;
    constexpr int kPerBlock = 32;
    const unsigned blocks = static_cast<unsigned>((S + kPerBlock - 1) /
                                                  kPerBlock);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* g = static_cast<const uint32_t*>(gens);
    auto* ng = static_cast<uint32_t*>(new_gens);
    auto* o = static_cast<uint8_t*>(out);
    auto* cl = static_cast<int*>(clips);
    const int Si = static_cast<int>(S);
    if (kind == 0)
        decimate_shaped_kernel<float><<<blocks, kPerBlock, 0, s>>>(
            static_cast<const float*>(x), n, Si, xsi, xsc, K,
            static_cast<float>(scaler), static_cast<const float*>(fb),
            static_cast<const float*>(ab), static_cast<const float*>(xh),
            static_cast<const float*>(yh), g, dithered, dither_type, ng,
            static_cast<float*>(new_fb), static_cast<float*>(new_xh),
            static_cast<float*>(new_yh), highclip, lowclip, pk, o, osi, osc,
            cl);
    else if (kind == 1)
        decimate_shaped_kernel<double><<<blocks, kPerBlock, 0, s>>>(
            static_cast<const double*>(x), n, Si, xsi, xsc, K, scaler,
            static_cast<const double*>(fb), static_cast<const double*>(ab),
            static_cast<const double*>(xh), static_cast<const double*>(yh),
            g, dithered, dither_type, ng, static_cast<double*>(new_fb),
            static_cast<double*>(new_xh), static_cast<double*>(new_yh),
            highclip, lowclip, pk, o, osi, osc, cl);
    else
        return cudaErrorInvalidValue;
    return cudaGetLastError();
}
