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
// __dmul_rn, __dadd_rn, __dsub_rn), so nvcc contracts nothing into an FMA
// whatever its flags: the bytes are a bit-exact contract with the host
// decimator.  A float32 product of float32 operands rounded once is what
// JAX's _mul_for computes through a float64 product.  Two exact
// reformulations shorten the work and keep every bit:
//   - the dither: the sum (first >> 1) + (r5 >> 1) < 2^32 is exact in
//     uint32, and sum / 2^31 - 1 = m * 2^-31 exactly with m = int32(sum -
//     2^31), so d rounded to T is T(m) * 2^-31 (one int-to-T conversion
//     and an exact scaling by a power of two, no float64 arithmetic for
//     float32 data);
//   - the round half up of a float32 v: floor(double(v) + 0.5) equals
//     fv + (v - fv >= 0.5) with fv = floorf(v), all in float32 (v - fv is
//     exact wherever it can reach 0.5, and an integer k is reached by the
//     double sum only if v + 0.5 >= k), so err = T(ov) - code is
//     (fv + 1) - code or fv - code, chosen by one compare.  float64 data
//     keeps floor(v + 0.5).
//
// What bounds them.  decimate_flat_kernel reads each sample once and
// writes its nbytes packed bytes once: at a 2^22-frame stereo float32
// chunk to 16 bits that is 33.6 MB + 16.8 MB, ~15 us at 3.35 TB/s, against
// ~35 integer and float32 operations a sample, ~9 us at the card's
// instruction rate: it is bound by bytes.  decimate_shaped_kernel is a serial
// recurrence per channel (the quantizer sits inside the feedback loop): it
// is bound by the latency of one frame's chain, about 11 dependent
// operations in float32 (code, v, floorf, v - fv, the compare, the select,
// err * a0 and four adds), not by any rate.  decimate_chain_probe_kernel
// runs that chain alone, K times on values in registers, in one thread: its
// time is the shaped kernel's latency bound.  That is arithmetic from
// shapes and the data sheet; the times are chip_smoke.py's.
//
// Design of decimate_flat_kernel (bytes at the memory's pace).
//   - Persistent lanes in a grid of a few CTAs per SM (4 for float32 in 64
//     registers, 3 for float64 in 80).  The samples are taken as one
//     sequence of elements e = i * S + c (frame-major, the interleaved
//     output's order); lane l takes runs of kRun consecutive elements, e0 =
//     kRun * (l + lanes * k), so one CTA covers every channel of its frames
//     and a run's packed bytes are contiguous in the interleaved stream.
//   - 16-byte loads and stores where the layout allows: the input as
//     contiguous elements (an interleaved [n, S] buffer) or as rows of
//     kRun / S frames per channel (K1's [ch, capacity] output at S = 1 or
//     2); the output as the run's kRun * nbytes bytes (interleaved, 24-bit
//     too) or as each channel's row piece (the per-channel uint8/16/32
//     container at S = 1 or 2).  Anything else (ragged edges, odd
//     strides, misaligned views) takes the element-wise path inside the
//     same kernel.
//   - The fast path (S = 1 or 2, 16-byte loads and stores; K1's stereo
//     output, the art command's blocks, process_flat_packed's container)
//     is compiled for its S: one LCG jump a lane a launch (the channels
//     share its map), one state a channel stepped through the run (a
//     frame's r5 is the next frame's state, and its two steps one
//     multiply-add 225 g +- 14), and in float32 the next run's loads in
//     flight while this run is quantized.
//   - The grid's element stride is a multiple of S and an even number of
//     frames F, so a lane keeps its channels and their states' parity;
//     after each run the states take the same affine map of 5F steps,
//     computed once on the host (g -> a g + b from an even state, a g - b
//     from an odd one).  The element-wise path keeps a state a slot (S
//     jumps a lane when S divides kRun, else one a slot); a grid whose
//     stride cannot be made so jumps per run.
//   - Clip count: a register count per lane, one block reduction at the
//     end, one atomicAdd per CTA.
//
// Design of decimate_shaped_kernel (one launch, warp-specialised).  A CTA
// serves a group of channels: up to 8 channels, one CTA for them all;
// above, groups of 8 channels, or of 16 where groups of 8 would not fit
// one wave of one CTA an SM; a channel's frames never split (the chain is
// serial).  Frames move in tiles of `tile` frames through a ring
// of kStages shared-memory stages, the warps on different tiles at once.
// The CTA is kQuads quads of 4 warps (decimate_geometry.h): one quad up to
// 8 channels, one every 8 channels above (at most 2).  Warp 0 is the chain and the
// first warp of every other quad idles, so that the chain warp has its
// scheduler (warp id mod 4) to itself; the other warps are the workers,
// the producers first:
//   - the producers (2 warps a quad: warps 1-2 of one quad, 8 threads a
//     channel from 8 channels up): cp.async copies of the samples kAhead
//     tiles ahead (any strides; each thread copies and later reads only
//     its own elements), then xs = fl(x * scaler) and the dither d of
//     every frame into the stage; each thread jumps its LCG once to its
//     first frame and then takes one affine map per frame of its channel;
//   - warp 0, the chain: lane c runs channel c's feedback loop and nothing
//     else, reading xs and d one batch of 8 frames ahead, the history
//     terms off the critical path, and writing each frame's rounded value
//     over its d;
//   - the consumers (1 warp a quad: warp 3 of one quad, 4 threads a
//     channel from 8 channels up): clamp, clip count, pack into the
//     stage, and, where one quad holds every channel of a dense output,
//     the finished tile's bytes out as 16-byte stores; one reduction and
//     at most one atomicAdd a warp.
// The chain's work a frame is the same at every width (one lane a
// channel); the producers' and the consumers' grow with the channels each
// thread serves.  At 32 channels a CTA with one consumer warp the
// consumer's stores set the pace, 2.7x the chain's time at the batch
// cell's 2,048 channels (PERF.md).  So above 8 channels each channel keeps
// the threads it has at 8, and the chain sets the pace.  Each quad count
// is its own instance, with its own launch bound: one quad keeps the
// register budget of a 128-thread CTA.
// The stages hand over through mbarriers (full: producers -> chain, done:
// chain -> consumer, empty: consumer -> producers), never a CTA-wide
// barrier inside the loop.  Frames past the last tile holding a frame < K
// pack 0 in extra CTAs of the same launch.

#include <cuda_runtime.h>

#include <cstdint>

#include "decimate_geometry.h"

namespace {

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

// ------------------------------------------------------------------ dither
__device__ __forceinline__ uint32_t lcg_step5(uint32_t g) {
    return lcg_step(lcg_step(lcg_step(lcg_step(lcg_step(g)))));
}

// m * 2^-31, exact
__device__ __forceinline__ void scale31(int m, float* d) {
    *d = __fmul_rn(__int2float_rn(m), 1.0f / 2147483648.0f);
}
__device__ __forceinline__ void scale31(int m, double* d) {
    *d = __dmul_rn(__int2double_rn(m), 1.0 / 2147483648.0);
}

// one frame's TPDF draw rounded to T, from its entry state g (the
// reformulation of the header: T(m) * 2^-31)
template <typename T>
__device__ __forceinline__ T tpdf(uint32_t g, int type) {
    const uint32_t r2 = lcg_step(lcg_step(g));
    const uint32_t r5 = lcg_step(lcg_step(lcg_step(r2)));
    const uint32_t first = type == -1 ? ~g : (type == 1 ? g : ~r2);
    T d;
    scale31(static_cast<int>(((first >> 1) + (r5 >> 1)) ^ 0x80000000u), &d);
    return d;
}

// --------------------------------------------------------------- quantize
template <typename T>
struct Rounded {
    T fl, err;                  // floor(v + 1/2) as T, and fl - code
};

// floor(double(v) + 0.5) in float32 (the header's reformulation)
__device__ __forceinline__ Rounded<float> round_half_up(float v,
                                                        float code) {
    const float fv = floorf(v);
    const float fv1 = __fadd_rn(fv, 1.0f);
    const bool up = __fsub_rn(v, fv) >= 0.5f;
    return {up ? fv1 : fv, up ? __fsub_rn(fv1, code) : __fsub_rn(fv, code)};
}
__device__ __forceinline__ Rounded<double> round_half_up(double v,
                                                         double code) {
    const double fl = floor(__dadd_rn(v, 0.5));
    return {fl, __dsub_rn(fl, code)};
}

// f clamped to [lo, hi] as an int; *nclip counts it when it was outside
// (hi and lo are below 2^24 in magnitude, so float32 compares them
// exactly)
template <typename T>
__device__ __forceinline__ int clamp_count(T f, int hi, int lo, int* nclip) {
    if (f > T(hi) || f < T(lo)) ++*nclip;
    return static_cast<int>(fmin(fmax(f, T(lo)), T(hi)));
}

// ----------------------------------------------------------------- packing
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

// =================================================== decimate_flat_kernel
constexpr int kFlatWarps = kFlatThreads / 32;

enum { kInElems = 1, kInRows = 2 };     // else element-wise loads
enum { kOutElems = 1, kOutRows = 2 };   // else element-wise stores

__device__ __forceinline__ void add_clips(int nclip, int* clips) {
    __shared__ int part[kFlatWarps];
    nclip = __reduce_add_sync(0xffffffffu, nclip);
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    if (lane == 0) part[warp] = nclip;
    __syncthreads();
    if (threadIdx.x == 0) {
        int total = 0;
        for (int w = 0; w < kFlatWarps; ++w) total += part[w];
        if (total) atomicAdd(clips, total);
    }
}

// CNT values of T from 16-byte-aligned src into v[FIRST + STEP * k]
template <int CNT, int FIRST, int STEP, typename T>
__device__ __forceinline__ void load_vec(const T* src, T (&v)[kRun]) {
    if constexpr (sizeof(T) == 4) {
#pragma unroll
        for (int q = 0; q < CNT / 4; ++q) {
            const float4 a = __ldg(reinterpret_cast<const float4*>(src) + q);
            v[FIRST + STEP * (4 * q)] = a.x;
            v[FIRST + STEP * (4 * q + 1)] = a.y;
            v[FIRST + STEP * (4 * q + 2)] = a.z;
            v[FIRST + STEP * (4 * q + 3)] = a.w;
        }
    } else {
#pragma unroll
        for (int q = 0; q < CNT / 2; ++q) {
            const double2 a =
                __ldg(reinterpret_cast<const double2*>(src) + q);
            v[FIRST + STEP * (2 * q)] = a.x;
            v[FIRST + STEP * (2 * q + 1)] = a.y;
        }
    }
}

// the little-endian bytes of the NB-byte slots w[FIRST + STEP * k], k <
// CNT, stored at dst with the widest aligned stores (the caller aligns dst
// to min(16, NB * CNT) bytes, or to 8 for 24 bytes)
template <int NB, int CNT, int FIRST, int STEP>
__device__ __forceinline__ void put_bytes(uint8_t* dst,
                                          const uint32_t (&w)[kRun]) {
    constexpr int kBytes = NB * CNT, kWords = (kBytes + 3) / 4;
    uint32_t o[kWords];
#pragma unroll
    for (int q = 0; q < kWords; ++q) o[q] = 0u;
#pragma unroll
    for (int k = 0; k < CNT; ++k)
#pragma unroll
        for (int b = 0; b < NB; ++b) {
            const int pos = k * NB + b;
            o[pos / 4] |= ((w[FIRST + STEP * k] >> (8 * b)) & 0xffu)
                          << (8 * (pos % 4));
        }
    if constexpr (kBytes % 16 == 0) {
#pragma unroll
        for (int q = 0; q < kBytes / 16; ++q)
            reinterpret_cast<uint4*>(dst)[q] =
                make_uint4(o[4 * q], o[4 * q + 1], o[4 * q + 2], o[4 * q + 3]);
    } else if constexpr (kBytes % 8 == 0) {
#pragma unroll
        for (int q = 0; q < kBytes / 8; ++q)
            reinterpret_cast<uint2*>(dst)[q] = make_uint2(o[2 * q],
                                                          o[2 * q + 1]);
    } else {
        static_assert(kBytes == 4, "a piece of 4, 8 or 16k bytes");
        *reinterpret_cast<uint32_t*>(dst) = o[0];
    }
}

template <int NB>
__device__ __forceinline__ void put_rows(uint8_t* dst, long long osc, int S,
                                         const uint32_t (&w)[kRun]) {
    if (S == 1) {
        put_bytes<NB, kRun, 0, 1>(dst, w);
    } else {
        put_bytes<NB, kRun / 2, 0, 2>(dst, w);
        put_bytes<NB, kRun / 2, 1, 2>(dst + osc, w);
    }
}

// the entry states of a run's slots when S divides kRun (channel j % kS,
// frame i0 + j / kS): kS jumps, then each slot is its channel's previous
// slot 5 steps on
template <int kS>
__device__ __forceinline__ void run_states(uint32_t (&g)[kRun],
                                           const uint32_t* gens,
                                           long long i0) {
#pragma unroll
    for (int j = 0; j < kRun; ++j)
        g[j] = j < kS ? lcg_jump(gens[j], 5ull * i0) : lcg_step5(g[j - kS]);
}

// what the flat kernel's lanes share
template <typename T>
struct Flat {
    const T* x;
    long long n, xsi, xsc, K;
    int S;
    T scaler;
    const T* fb;
    const uint32_t* gens;
    int dithered, dither_type, hi, lo;
    Pack pk;
    uint8_t* out;
    long long osi, osc;
    Stride st;
    int in_mode, out_mode;
};

// one element's packed slot from its sample v, feedback f and dither d
// (``live``: a frame < K; others pack 0 and count nothing)
template <typename T>
__device__ __forceinline__ uint32_t quantize(const Flat<T>& a, T v, T f,
                                             T d, bool live, int* nclip) {
    int ov = 0;
    if (live) {
        const T code = sub(mul(v, a.scaler), f);
        const T vd = a.dithered ? add(code, d) : code;
        ov = clamp_count(round_half_up(vd, code).fl, a.hi, a.lo, nclip);
    }
    return slot(a.pk, ov);
}

// 16-byte stores of a full run's slots: the interleaved stream's kRun *
// nbytes bytes at element e0, or each channel's row piece at frame i0
template <typename T>
__device__ __forceinline__ void store_run(const Flat<T>& a, long long e0,
                                          long long i0,
                                          const uint32_t (&w)[kRun]) {
    if (a.out_mode == kOutElems) {
        uint8_t* d = a.out + e0 * a.pk.nbytes;
        switch (a.pk.nbytes) {
            case 1: put_bytes<1, kRun, 0, 1>(d, w); break;
            case 2: put_bytes<2, kRun, 0, 1>(d, w); break;
            case 3: put_bytes<3, kRun, 0, 1>(d, w); break;
            default: put_bytes<4, kRun, 0, 1>(d, w);
        }
    } else {
        uint8_t* d = a.out + i0 * a.pk.nbytes;
        switch (a.pk.nbytes) {
            case 1: put_rows<1>(d, a.osc, a.S, w); break;
            case 2: put_rows<2>(d, a.osc, a.S, w); break;
            default: put_rows<4>(d, a.osc, a.S, w);
        }
    }
}

// 16-byte loads of a full run's samples: kRun contiguous elements at e0,
// or kRun / S frames of each channel's row at frame i0 (S <= 2)
template <typename T>
__device__ __forceinline__ void load_run(const Flat<T>& a, long long e0,
                                         long long i0, T (&v)[kRun]) {
    if (a.in_mode == kInElems) {
        load_vec<kRun, 0, 1>(a.x + e0, v);
    } else if (a.S == 1) {
        load_vec<kRun, 0, 1>(a.x + i0, v);
    } else {
        load_vec<kRun / 2, 0, 2>(a.x + i0, v);
        load_vec<kRun / 2, 1, 2>(a.x + a.xsc + i0, v);
    }
}

// The fast path: kS = S (1 or 2) channels, 16-byte loads and stores, the
// next run's loads in flight during this run's arithmetic (float32).  Slot j
// is channel j % kS at frame i0 + j / kS, i0 even, so a channel's state at
// i0 has its seed's parity: one jump of 5 * i0 steps (the same map for
// every channel, up to the sign of b) gives each channel's state, and
// within a run a frame's state is the previous frame's r5, its two steps
// one multiply-add by the channel's constant 225 g +- 14 (the sign flips
// each frame).  The next run's states are the stride's map of this run's.
// Returns the first element of the run it leaves to the element-wise path
// (>= n * kS when none).
template <typename T, int kS>
__device__ __forceinline__ long long flat_fixed(const Flat<T>& a,
                                                long long lane,
                                                long long lanes,
                                                int* nclip) {
    constexpr int kF = kRun / kS;               // frames of a channel a run
    const long long E = a.n * kS, step = lanes * kRun, fstep = step / kS;
    long long e0 = lane * kRun;
    if (e0 + kRun > E) return e0;
    long long i0 = e0 / kS;
    // float64 runs take twice the registers: no prefetch there
    constexpr bool kPrefetch = sizeof(T) == 4;
    T cur[kRun];                // the first run's loads, before the jump
#pragma unroll
    for (int j = 0; j < kRun; ++j) cur[j] = T(0);
    if (i0 < a.K) load_run(a, e0, i0, cur);
    T f[kS];
    uint32_t g[kS], two[kS], adv[kS];
#pragma unroll
    for (int c = 0; c < kS; ++c) f[c] = a.fb ? a.fb[c] : T(0);
    if (a.dithered) {
        const Affine m = pair_power(false, 5ull * i0 / 2);
#pragma unroll
        for (int c = 0; c < kS; ++c) {
            const uint32_t s0 = a.gens[c];
            const bool odd = s0 & 1u;
            g[c] = m.a * s0 + (odd ? 0u - m.b : m.b);
            two[c] = odd ? 0u - 14u : 14u;
            adv[c] = odd ? 0u - a.st.b : a.st.b;
        }
    }
    const uint32_t flip = a.dither_type == 1 ? 0u : ~0u;
    const bool from_r2 = a.dither_type != 1 && a.dither_type != -1;
    for (;;) {
        const long long e1 = e0 + step;
        const bool more = e1 + kRun <= E;
        T nxt[kRun];
#pragma unroll
        for (int j = 0; j < kRun; ++j) nxt[j] = T(0);
        if (kPrefetch && more && i0 + fstep < a.K)
            load_run(a, e1, i0 + fstep, nxt);
        const long long left = a.K - i0;        // frames of the run < K
        uint32_t w[kRun];
#pragma unroll
        for (int c = 0; c < kS; ++c) {
            uint32_t s = g[c];
#pragma unroll
            for (int k = 0; k < kF; ++k) {
                T d = T(0);
                if (a.dithered) {
                    const uint32_t b = (k & 1) ? 0u - two[c] : two[c];
                    const uint32_t r2 = 225u * s + b;
                    const uint32_t r5 = lcg_step(225u * r2 + b);
                    const uint32_t first = (from_r2 ? r2 : s) ^ flip;
                    scale31(static_cast<int>(((first >> 1) + (r5 >> 1)) ^
                                             0x80000000u), &d);
                    s = r5;
                }
                w[c + kS * k] = quantize(a, cur[c + kS * k], f[c], d,
                                         k < left, nclip);
            }
        }
        store_run(a, e0, i0, w);
        if (!more) return e1;
        e0 = e1;
        i0 += fstep;
        if (a.dithered) {
#pragma unroll
            for (int c = 0; c < kS; ++c) g[c] = a.st.a * g[c] + adv[c];
        }
#pragma unroll
        for (int j = 0; j < kRun; ++j) cur[j] = nxt[j];
        if (!kPrefetch && i0 < a.K) load_run(a, e0, i0, cur);
    }
}

// The element-wise path from element e (a multiple of kRun) on, in steps
// of ``step`` elements: any S and strides; 16-byte loads and stores for
// full runs where in_mode / out_mode allow.
template <typename T>
__device__ __forceinline__ void flat_any(const Flat<T>& a, long long e,
                                         long long step, int* nclip) {
    const int S = a.S;
    const long long E = a.n * S;
    uint32_t g[kRun];
    long long i0 = 0;
    int c0 = 0;
    for (long long e0 = e; e0 < E; e0 += step) {
        if (e0 == e || a.st.frames == 0) {
            // the run's first slot, and the slots' entry states
            i0 = e0 / S;
            c0 = static_cast<int>(e0 - i0 * S);
            long long i = i0;
            int c = c0;
#pragma unroll
            for (int j = 0; j < kRun; ++j) {
                if (a.dithered && S > 2)
                    g[j] = lcg_jump(a.gens[c], 5ull * i);
                if (++c == S) { c = 0; ++i; }
            }
            if (a.dithered && S == 1) run_states<1>(g, a.gens, i0);
            if (a.dithered && S == 2) run_states<2>(g, a.gens, i0);
        } else {
            i0 += a.st.frames;
            if (a.dithered) {
#pragma unroll
                for (int j = 0; j < kRun; ++j)
                    g[j] = a.st.a * g[j] + ((g[j] & 1u) ? 0u - a.st.b
                                                         : a.st.b);
            }
        }
        const bool full = e0 + kRun <= E;
        T v[kRun];
#pragma unroll
        for (int j = 0; j < kRun; ++j) v[j] = T(0);
        if (i0 < a.K) {
            if (full && a.in_mode) {
                load_run(a, e0, i0, v);
            } else {
                long long i = i0;
                int c = c0;
#pragma unroll
                for (int j = 0; j < kRun; ++j) {
                    if (e0 + j < E && i < a.K)
                        v[j] = a.x[i * a.xsi + c * a.xsc];
                    if (++c == S) { c = 0; ++i; }
                }
            }
        }
        uint32_t w[kRun];
        {
            long long i = i0;
            int c = c0;
#pragma unroll
            for (int j = 0; j < kRun; ++j) {
                const bool live = e0 + j < E && i < a.K;
                w[j] = quantize(a, v[j], a.fb && live ? a.fb[c] : T(0),
                                a.dithered ? tpdf<T>(g[j], a.dither_type)
                                           : T(0),
                                live, nclip);
                if (++c == S) { c = 0; ++i; }
            }
        }
        if (full && a.out_mode) {
            store_run(a, e0, i0, w);
        } else {
            long long i = i0;
            int c = c0;
#pragma unroll
            for (int j = 0; j < kRun; ++j) {
                if (e0 + j < E)
                    store(a.out + i * a.osi + c * a.osc, w[j], a.pk.nbytes);
                if (++c == S) { c = 0; ++i; }
            }
        }
    }
}

template <typename T>
__global__ void __launch_bounds__(kFlatThreads, flat_per_sm(sizeof(T)))
    decimate_flat_kernel(Flat<T> a, uint32_t* __restrict__ new_gens,
                         int* __restrict__ clips) {
    const long long lanes = static_cast<long long>(gridDim.x) * kFlatThreads;
    const long long lane =
        static_cast<long long>(blockIdx.x) * kFlatThreads + threadIdx.x;
    if (a.dithered)
        for (long long c = lane; c < a.S; c += lanes)
            new_gens[c] = lcg_jump(a.gens[c], 5ull * a.K);
    int nclip = 0;
    long long e = lane * kRun;
    if (a.in_mode && a.out_mode && a.S == 1)
        e = flat_fixed<T, 1>(a, lane, lanes, &nclip);
    else if (a.in_mode && a.out_mode && a.S == 2)
        e = flat_fixed<T, 2>(a, lane, lanes, &nclip);
    flat_any(a, e, lanes * kRun, &nclip);
    add_clips(nclip, clips);
}

// ================================================= decimate_shaped_kernel
constexpr int kBatch = 8;               // frames the chain reads ahead

template <typename T>
struct Coef {
    T a0, a1, a2, a3, a4, b1, b2, b3, b4;
};

template <typename T>
struct Shaper {
    T f, x0, x1, x2, x3, y0, y1, y2, y3;
};

// one frame of the feedback loop from xs = fl(x * scaler) and the dither;
// returns the rounded value.  The history terms depend only on earlier
// frames, so only code -> v -> round -> err -> s is serial.
template <typename T, bool kDither>
__device__ __forceinline__ T shaped_frame(T xs, T d, const Coef<T>& k,
                                          Shaper<T>& st) {
    const T code = sub(xs, st.f);
    const T v = kDither ? add(code, d) : code;
    const Rounded<T> q = round_half_up(v, code);
    T s = mul(q.err, k.a0);
    s = add(s, sub(mul(st.x3, k.a4), mul(k.b4, st.y3)));
    s = add(s, sub(mul(st.x2, k.a3), mul(k.b3, st.y2)));
    s = add(s, sub(mul(st.x1, k.a2), mul(k.b2, st.y1)));
    s = add(s, sub(mul(st.x0, k.a1), mul(k.b1, st.y0)));
    st.x3 = st.x2; st.x2 = st.x1; st.x1 = st.x0; st.x0 = q.err;
    st.y3 = st.y2; st.y2 = st.y1; st.y1 = st.y0; st.y0 = s;
    st.f = s;
    return q.fl;
}

template <typename T>
__device__ __forceinline__ Coef<T> load_coef(const T* ab) {
    return {ab[0], ab[1], ab[2], ab[3], ab[4], ab[6], ab[7], ab[8], ab[9]};
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                     smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile(
        "{\n .reg .b64 state;\n"
        " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
            smem_u32(bar)) : "memory");
}

// wait for the completion of the barrier's phase of parity ``parity``
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    unsigned ok = 0;
    while (!ok)
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n" : "=r"(ok) : "r"(smem_u32(bar)),
            "r"(parity) : "memory");
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)), "l"(src), "n"(sizeof(T)) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The chain over nt frames of a stage, lane by lane: xs and d at [i * Cb]
// (d overwritten by the rounded value), the next batch of kBatch frames
// read while this one runs.
template <typename T, bool kDither>
__device__ __forceinline__ void run_chain(const T* xs, T* d, int Cb, int nt,
                                          const Coef<T>& k, Shaper<T>& st) {
    T cx[kBatch], cd[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
        cx[u] = u < nt ? xs[u * Cb] : T(0);
        cd[u] = kDither && u < nt ? d[u * Cb] : T(0);
    }
    int i = 0;
    for (; i + kBatch <= nt; i += kBatch) {
        T nx[kBatch], nd[kBatch];
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            const int q = i + kBatch + u;
            nx[u] = q < nt ? xs[q * Cb] : T(0);
            nd[u] = kDither && q < nt ? d[q * Cb] : T(0);
        }
#pragma unroll
        for (int u = 0; u < kBatch; ++u)
            d[(i + u) * Cb] = shaped_frame<T, kDither>(cx[u], cd[u], k, st);
#pragma unroll
        for (int u = 0; u < kBatch; ++u) {
            cx[u] = nx[u];
            cd[u] = nd[u];
        }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
        if (i + u < nt)
            d[(i + u) * Cb] = shaped_frame<T, kDither>(cx[u], cd[u], k, st);
}

// the zero slots of frames [covered, n), all channels, in the CTAs after
// the channel groups
__device__ void zero_tail(long long n, int S, long long covered, int groups,
                          const Pack& pk, uint8_t* out, long long osi,
                          long long osc) {
    const long long total = (n - covered) * S;
    const long long stride =
        static_cast<long long>(gridDim.x - groups) * blockDim.x;
    long long e = static_cast<long long>(blockIdx.x - groups) * blockDim.x +
                  threadIdx.x;
    if (e >= total) return;
    const uint32_t zero = slot(pk, 0);
    long long i = covered + e / S;
    int c = static_cast<int>(e % S);
    const long long qi = stride / S;
    const int qc = static_cast<int>(stride % S);
    for (; e < total; e += stride) {
        store(out + i * osi + c * osc, zero, pk.nbytes);
        i += qi;
        c += qc;
        if (c >= S) { c -= S; ++i; }
    }
}

template <typename T, int kQuads>
__global__ void __launch_bounds__(kQuads * kQuadThreads)
    decimate_shaped_kernel(
    const T* __restrict__ x, long long n, int S, long long xsi,
    long long xsc, long long K, T scaler, const T* __restrict__ fb,
    const T* __restrict__ ab, const T* __restrict__ xh,
    const T* __restrict__ yh, const uint32_t* __restrict__ gens,
    int dithered, int dither_type, uint32_t* __restrict__ new_gens,
    T* __restrict__ new_fb, T* __restrict__ new_xh, T* __restrict__ new_yh,
    int hi, int lo, Pack pk, uint8_t* __restrict__ out, long long osi,
    long long osc, int* __restrict__ clips, int groups, int tile, int chans) {
    constexpr int kProducers = kQuads * kQuadProducers;
    constexpr int kConsumers = kQuads * 32;
    extern __shared__ __align__(16) unsigned char smem[];
    const long long ntiles = (K + tile - 1) / tile;
    if (static_cast<int>(blockIdx.x) >= groups) {
        zero_tail(n, S, n < ntiles * tile ? n : ntiles * tile, groups, pk,
                  out, osi, osc);
        return;
    }
    const int c0 = blockIdx.x * chans;
    const int Cb = S - c0 < chans ? S - c0 : chans;
    const long long slab =
        static_cast<long long>(tile) * (S < chans ? S : chans);
    uint64_t* full = reinterpret_cast<uint64_t*>(smem);
    uint64_t* done = full + kStages;
    uint64_t* empty = done + kStages;
    T* ring = reinterpret_cast<T*>(smem + kBarBytes);   // xs, d per stage
    T* raw = ring + 2 * kStages * slab;                 // copied samples
    if (threadIdx.x == 0) {
        for (int s = 0; s < kStages; ++s) {
            mbar_init(full + s, kProducers);
            mbar_init(done + s, 32);
            mbar_init(empty + s, kConsumers);
        }
    }
    __syncthreads();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    // the workers' index, warps 1-3 of each quad (one quad: threadIdx - 32)
    const int worker = kQuads == 1 ? static_cast<int>(threadIdx.x) - 32
                                   : (warp - warp / 4 - 1) * 32 + lane;
    if (warp == 0) {
        // the chain: lane c runs channel c0 + c
        const bool live = lane < Cb;
        const int c = c0 + lane;
        const Coef<T> k = load_coef(ab);
        Shaper<T> st{};
        if (live)
            st = {fb[c], xh[c], xh[S + c], xh[2 * S + c], xh[3 * S + c],
                  yh[c], yh[S + c], yh[2 * S + c], yh[3 * S + c]};
        for (long long t = 0; t < ntiles; ++t) {
            const int s = static_cast<int>(t % kStages);
            mbar_wait(full + s, static_cast<unsigned>(t / kStages) & 1u);
            if (live) {
                const long long left = K - t * tile;
                const int nt = left < tile ? static_cast<int>(left) : tile;
                const T* xs = ring + 2 * s * slab + lane;
                T* d = ring + (2 * s + 1) * slab + lane;
                if (dithered)
                    run_chain<T, true>(xs, d, Cb, nt, k, st);
                else
                    run_chain<T, false>(xs, d, Cb, nt, k, st);
            }
            mbar_arrive(done + s);
        }
        if (live) {
            new_fb[c] = st.f;
            new_xh[c] = st.x0; new_xh[S + c] = st.x1;
            new_xh[2 * S + c] = st.x2; new_xh[3 * S + c] = st.x3;
            new_yh[c] = st.y0; new_yh[S + c] = st.y1;
            new_yh[2 * S + c] = st.y2; new_yh[3 * S + c] = st.y3;
            if (dithered) new_gens[c] = lcg_jump(gens[c], 5ull * K);
        }
    } else if (kQuads > 1 && warp % 4 == 0) {
        // idle: the chain's scheduler is the chain warp's alone
    } else if (worker >= kProducers) {
        // the consumers: clamp, count, pack into the stage's xs, store
        const int q = worker - kProducers;
        // one consumer warp: a split CTA holds only some of the channels
        const bool contig = kQuads == 1 && Cb == S && osc == pk.nbytes &&
                            osi == static_cast<long long>(S) * pk.nbytes &&
                            reinterpret_cast<uintptr_t>(out) % 16 == 0;
        const int qi = kConsumers / Cb, qc = kConsumers % Cb;
        int nclip = 0;
        for (long long t = 0; t < ntiles; ++t) {
            const int s = static_cast<int>(t % kStages);
            mbar_wait(done + s, static_cast<unsigned>(t / kStages) & 1u);
            const long long f0 = t * tile;
            const int nf = n - f0 < tile ? static_cast<int>(n - f0) : tile;
            const int kv = K - f0 < nf ? static_cast<int>(K - f0) : nf;
            const T* fl = ring + (2 * s + 1) * slab;
            uint8_t* buf = reinterpret_cast<uint8_t*>(ring + 2 * s * slab);
            int i = q / Cb, cl = q % Cb;
            // unrolled as far as the compiler likes, a split CTA's loop
            // ran D2's batch call 1.6% slower than unrolled by 1 (PERF.md)
#pragma unroll (kQuads == 1 ? 2 : 1)
            for (int e = q; e < nf * Cb; e += kConsumers) {
                const uint32_t w =
                    slot(pk, i < kv ? clamp_count(fl[e], hi, lo, &nclip) : 0);
                if (contig)
                    store(buf + e * pk.nbytes, w, pk.nbytes);
                else
                    store(out + (f0 + i) * osi + (c0 + cl) * osc, w,
                          pk.nbytes);
                i += qi;
                cl += qc;
                if (cl >= Cb) { cl -= Cb; ++i; }
            }
            if (contig) {
                __syncwarp();
                uint8_t* dst = out + f0 * osi;      // 16-byte aligned
                const int bytes = nf * Cb * pk.nbytes;
                for (int o = q * 16; o + 16 <= bytes; o += kConsumers * 16)
                    *reinterpret_cast<uint4*>(dst + o) =
                        *reinterpret_cast<const uint4*>(buf + o);
                for (int o = (bytes & ~15) + q; o < bytes; o += kConsumers)
                    dst[o] = buf[o];
            }
            __syncwarp();
            mbar_arrive(empty + s);
        }
        nclip = __reduce_add_sync(0xffffffffu, nclip);
        if (lane == 0 && nclip) atomicAdd(clips, nclip);
    } else {
        // the producers: tpc threads per channel, thread r of a channel on
        // frames r, r + tpc, ... of every tile
        const int p = worker;
        int tpc = 1;
        while (2 * tpc * Cb <= kProducers) tpc *= 2;
        const int cl = p / tpc, r = p % tpc;
        const bool live = cl < Cb;
        const int per = tile / tpc;
        const T* xc = x + static_cast<long long>(c0 + cl) * xsc;
        uint32_t g = 0u;
        Affine next = {1u, 0u};
        if (live && dithered) {
            g = lcg_jump(gens[c0 + cl], 5ull * r);
            next = pair_power(g & 1u, 5ull * tpc / 2);
        }
        auto copy = [&](long long t) {
            if (live && t < ntiles) {
                T* dst = raw + (t % kRaw) * slab;
                for (int j = 0; j < per; ++j) {
                    const long long i = t * tile + r + j * tpc;
                    if (i >= K) break;
                    cp_async(dst + (r + j * tpc) * Cb + cl, xc + i * xsi);
                }
            }
            cp_async_commit();
        };
        for (int a = 0; a < kAhead; ++a) copy(a);
        for (long long t = 0; t < ntiles; ++t) {
            copy(t + kAhead);
            cp_async_wait<kAhead>();
            const int s = static_cast<int>(t % kStages);
            if (t >= kStages)
                mbar_wait(empty + s,
                          static_cast<unsigned>(t / kStages - 1) & 1u);
            if (live) {
                const T* src = raw + (t % kRaw) * slab;
                T* xs = ring + 2 * s * slab;
                T* d = xs + slab;
                for (int j = 0; j < per; ++j) {
                    if (t * tile + r + j * tpc >= K) break;
                    const int e = (r + j * tpc) * Cb + cl;
                    xs[e] = mul(src[e], scaler);
                    if (dithered) {
                        d[e] = tpdf<T>(g, dither_type);
                        g = next.a * g + next.b;
                    }
                }
            }
            mbar_arrive(full + s);
        }
        cp_async_wait<0>();
    }
}

// The shaped kernel's chain alone, in one thread: K frames of
// shaped_frame (dithered) on xs and d held in registers, no loads inside
// the loop and no stores but the final state.  Its time is the shaped
// kernel's latency bound.  in: a0..a4, b0..b4, xs, d, f, xh0..3, yh0..3.
template <typename T>
__global__ void decimate_chain_probe_kernel(const T* __restrict__ in,
                                            long long K,
                                            T* __restrict__ state) {
    const Coef<T> k = load_coef(in);
    const T xs = in[10], d = in[11];
    Shaper<T> st = {in[12], in[13], in[14], in[15], in[16],
                    in[17], in[18], in[19], in[20]};
    long long i = 0;
    for (; i + kBatch <= K; i += kBatch) {
#pragma unroll
        for (int u = 0; u < kBatch; ++u) shaped_frame<T, true>(xs, d, k, st);
    }
    for (; i < K; ++i) shaped_frame<T, true>(xs, d, k, st);
    const T out[9] = {st.f, st.x0, st.x1, st.x2, st.x3,
                      st.y0, st.y1, st.y2, st.y3};
    for (int q = 0; q < 9; ++q) state[q] = out[q];
}

// ======================================================== host geometry
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

int sm_count() {
    static int cached[64] = {0};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
    if (!cached[dev])
        cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    return cached[dev];
}

// one launch of the shaped kernel's instance of kQuads quads, after
// letting it take up to kSmemBudget bytes of dynamic shared memory (set on
// every launch, for the current device, to one value: so no cache to keep
// per device and no race between threads)
template <typename T, int kQuads, typename... Args>
int launch_quads(unsigned blocks, size_t smem, cudaStream_t s,
                 Args... args) {
    const int rc = cudaFuncSetAttribute(
        decimate_shaped_kernel<T, kQuads>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kSmemBudget));
    if (rc) return rc;
    decimate_shaped_kernel<T, kQuads>
        <<<blocks, kQuads * kQuadThreads, smem, s>>>(args...);
    return cudaGetLastError();
}

template <typename T, typename... Args>
int launch_shaped(long long quads, unsigned blocks, size_t smem,
                  cudaStream_t s, Args... args) {
    switch (quads) {
        case 1: return launch_quads<T, 1>(blocks, smem, s, args...);
        case 2: return launch_quads<T, 2>(blocks, smem, s, args...);
    }
    return cudaErrorInvalidValue;
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
    if (kind != 0 && kind != 1) return cudaErrorInvalidValue;
    if (n == 0) return 0;
    const int sms = sm_count();
    if (sms <= 0) return cudaErrorInvalidDevice;
    const FlatGeometry geo = flat_geometry(n, S, sms, kind == 0 ? 4 : 8);
    if (geo.ctas > 0x7fffffffLL) return cudaErrorInvalidValue;
    const long long es = kind == 0 ? 4 : 8;
    const auto xa = reinterpret_cast<uintptr_t>(x);
    const auto oa = reinterpret_cast<uintptr_t>(out);
    int in_mode = 0, out_mode = 0;
    if (xsc == 1 && xsi == S && xa % 16 == 0)
        in_mode = kInElems;
    else if (xsi == 1 && xa % 16 == 0 &&
             (S == 1 || (S == 2 && xsc * es % 16 == 0)))
        in_mode = kInRows;
    if (osi == S * nbytes && (osc == nbytes || S == 1) && oa % 16 == 0)
        out_mode = kOutElems;
    else if (osi == nbytes && nbytes != 3 && oa % 16 == 0 &&
             (S == 1 || (S == 2 && osc % (4 * nbytes) == 0)))
        out_mode = kOutRows;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* g = static_cast<const uint32_t*>(gens);
    auto* ng = static_cast<uint32_t*>(new_gens);
    auto* o = static_cast<uint8_t*>(out);
    auto* cl = static_cast<int*>(clips);
    const int Si = static_cast<int>(S);
    const unsigned blocks = static_cast<unsigned>(geo.ctas);
    if (kind == 0) {
        const Flat<float> a = {static_cast<const float*>(x), n, xsi, xsc,
                               K, Si, static_cast<float>(scaler),
                               static_cast<const float*>(fb), g, dithered,
                               dither_type, highclip, lowclip, pk, o, osi,
                               osc, geo.st, in_mode, out_mode};
        decimate_flat_kernel<float><<<blocks, kFlatThreads, 0, s>>>(a, ng,
                                                                     cl);
    } else {
        const Flat<double> a = {static_cast<const double*>(x), n, xsi, xsc,
                                K, Si, scaler,
                                static_cast<const double*>(fb), g, dithered,
                                dither_type, highclip, lowclip, pk, o, osi,
                                osc, geo.st, in_mode, out_mode};
        decimate_flat_kernel<double><<<blocks, kFlatThreads, 0, s>>>(a, ng,
                                                                      cl);
    }
    return cudaGetLastError();
}

// As art_decimate_flat, with fb [S] required and the shaper: ab [10] = a0..a4
// then b0..b4, xh and yh [4, S] (row 0 the newest), all of x's type; the
// state after K frames goes to new_fb [S], new_xh and new_yh [4, S] and,
// when ``dithered``, new_gens.  Output frames of one channel in order, one
// chain lane per channel.
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
    if (kind != 0 && kind != 1) return cudaErrorInvalidValue;
    if (n == 0) return 0;
    const int sms = sm_count();
    if (sms <= 0) return cudaErrorInvalidDevice;
    const ShapedGeometry geo =
        shaped_geometry(n, S, K, kind == 0 ? 4 : 8, sms);
    if (geo.smem > kSmemBudget) return cudaErrorInvalidValue;
    const unsigned blocks = static_cast<unsigned>(geo.groups + geo.zero);
    const size_t smem = static_cast<size_t>(geo.smem);
    const int groups = static_cast<int>(geo.groups);
    const int tile = static_cast<int>(geo.tile);
    const int chans = static_cast<int>(geo.chans);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* g = static_cast<const uint32_t*>(gens);
    auto* ng = static_cast<uint32_t*>(new_gens);
    auto* o = static_cast<uint8_t*>(out);
    auto* cl = static_cast<int*>(clips);
    const int Si = static_cast<int>(S);
    if (kind == 0)
        return launch_shaped<float>(
            geo.quads, blocks, smem, s, static_cast<const float*>(x), n, Si,
            xsi, xsc, K, static_cast<float>(scaler),
            static_cast<const float*>(fb), static_cast<const float*>(ab),
            static_cast<const float*>(xh), static_cast<const float*>(yh), g,
            dithered, dither_type, ng, static_cast<float*>(new_fb),
            static_cast<float*>(new_xh), static_cast<float*>(new_yh),
            highclip, lowclip, pk, o, osi, osc, cl, groups, tile, chans);
    return launch_shaped<double>(
        geo.quads, blocks, smem, s, static_cast<const double*>(x), n, Si,
        xsi, xsc, K, scaler, static_cast<const double*>(fb),
        static_cast<const double*>(ab), static_cast<const double*>(xh),
        static_cast<const double*>(yh), g, dithered, dither_type, ng,
        static_cast<double*>(new_fb), static_cast<double*>(new_xh),
        static_cast<double*>(new_yh), highclip, lowclip, pk, o, osi, osc,
        cl, groups, tile, chans);
}

// One launch of decimate_chain_probe_kernel (one thread) on ``in`` [21] of
// kind 0 (float32) or 1 (float64); the final state goes to ``state`` [9].
extern "C" int art_decimate_chain_probe(const void* in, long long K,
                                        int kind, void* state,
                                        void* stream) {
    if (K < 0 || !in || !state) return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (kind == 0)
        decimate_chain_probe_kernel<float><<<1, 1, 0, s>>>(
            static_cast<const float*>(in), K, static_cast<float*>(state));
    else if (kind == 1)
        decimate_chain_probe_kernel<double><<<1, 1, 0, s>>>(
            static_cast<const double*>(in), K, static_cast<double*>(state));
    else
        return cudaErrorInvalidValue;
    return cudaGetLastError();
}
