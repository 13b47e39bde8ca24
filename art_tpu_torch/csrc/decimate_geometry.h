// The decimate kernels' host geometry and the dither LCG's jumps: one
// source for decimate.cu (nvcc: the kernels, their launches) and for
// decimate_geometry.cpp (the C++ host compiler: the same functions behind
// a C interface that needs no card, which the tests and chip_smoke.py read
// through ops/decimate_device.py::library_geometry and lcg_pair_map).
// Plain C++ but for the __host__ __device__ qualifiers nvcc sees.

#ifndef ART_DECIMATE_GEOMETRY_H
#define ART_DECIMATE_GEOMETRY_H

#include <cstdint>

#ifdef __CUDACC__
#define ART_HD_INLINE __host__ __device__ __forceinline__
#define ART_HD __host__ __device__ inline
#else
#define ART_HD_INLINE inline
#define ART_HD inline
#endif

namespace {

// ------------------------------------------------------------------ dither
ART_HD_INLINE uint32_t lcg_step(uint32_t g) {
    return ((g << 4) - g) ^ 1u;
}

struct Affine {                 // g -> a*g + b (mod 2^32)
    uint32_t a, b;
};

ART_HD_INLINE Affine compose(Affine f, Affine g) {
    return {f.a * g.a, f.a * g.b + f.b};            // f(g(x))
}

// the map of 2*pairs steps from a state of parity ``odd``: two steps are
// 225 g + 14 from an even state and 225 g - 14 from an odd one, and keep
// the parity; the odd map is the even one's negation, a g - b
ART_HD Affine pair_power(bool odd, unsigned long long pairs) {
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
ART_HD uint32_t lcg_jump(uint32_t g, unsigned long long steps) {
    const Affine f = pair_power(g & 1u, steps >> 1);
    g = f.a * g + f.b;
    return (steps & 1ull) ? lcg_step(g) : g;
}

// ============================================ decimate_flat_kernel's grid
constexpr int kFlatThreads = 256;
// CTAs per SM: float32 in at most 64 registers a thread, float64 in 80
ART_HD constexpr int flat_per_sm(int elem) {
    return elem == 4 ? 4 : 3;
}
constexpr int kRun = 8;                             // elements per lane run
constexpr long long kPass = 1LL * kRun * kFlatThreads;  // a CTA's elements

struct Stride {                 // the lanes' stride of F frames, or 0
    long long frames;
    uint32_t a, b;              // 5F steps: a g + b (even g), a g - b (odd)
};

inline long long gcd(long long a, long long b) {
    while (b) {
        const long long t = a % b;
        a = b;
        b = t;
    }
    return a;
}

struct FlatGeometry {
    long long ctas;
    Stride st;
};

// The flat kernel's grid: one run a lane when that takes at most
// flat_per_sm CTAs an SM; else persistent lanes whose stride is a multiple
// of S and an even number of frames (its LCG map then the same for every
// slot, up to the sign of b), or, where that needs more than 4x the CTAs,
// lanes that jump per run.
inline FlatGeometry flat_geometry(long long n, long long S, int sms,
                                  int elem) {
    const long long runs = (n * S + kRun - 1) / kRun;
    const long long target = static_cast<long long>(sms) * flat_per_sm(elem);
    FlatGeometry geo = {(runs + kFlatThreads - 1) / kFlatThreads,
                        {0, 1u, 0u}};
    if (geo.ctas <= target) return geo;
    const long long unit = S / gcd(S, kPass);
    long long ctas = (target + unit - 1) / unit * unit;
    if (kPass * ctas / S % 2) ctas += unit;
    if (ctas > 4 * target) {
        geo.ctas = target;
        return geo;
    }
    geo.ctas = ctas;
    geo.st.frames = kPass * ctas / S;
    const Affine m = pair_power(false, 5ull * geo.st.frames / 2);
    geo.st.a = m.a;
    geo.st.b = m.b;
    return geo;
}

// ========================================= decimate_shaped_kernel's launch
// A CTA is quads of 4 warps: the first warp of the first quad is the
// chain, of every other quad idle, so that the chain warp has its
// scheduler (warp id mod 4) to itself; the other 3 warps of each quad are
// workers, 2 producer warps and 1 consumer warp a quad (the producers
// first, in worker order).
constexpr int kQuadThreads = 128;
constexpr int kQuadProducers = 64;
constexpr int kSplitFrom = 8;           // channels a quad serves
constexpr int kMaxQuads = 2;            // so at most 16 channels a CTA
constexpr int kStages = 3;              // the ring: producers -> chain ->
constexpr int kAhead = 2;               //   consumer; cp.async tiles ahead
constexpr int kRaw = kAhead + 1;        // stages of copied samples
constexpr int kMaxTile = 2048, kMinTile = 64;
constexpr int kBarBytes = 128;          // 3 * kStages mbarriers, padded
constexpr long long kSmemBudget = 200 * 1024;
constexpr int kMaxZero = 64;            // CTAs packing the zero tail

struct ShapedGeometry {
    long long groups, zero, tile, smem, chans, quads;
};

// The shaped kernel's launch.  Up to kSplitFrom channels: one CTA of one
// quad for them all.  Above, the split: CTAs of 8 channels and one quad,
// or of 16 channels and 2 quads where CTAs of 8 would not fit one wave of
// one CTA on each of the ``sms`` SMs (past 16 x sms channels, more waves),
// so every channel keeps the 8 producer threads and 4 consumer threads it
// has at 8 channels, and the chain warp, whose work a frame is the same at
// every width, sets the pace.  The tile is the largest power of two in
// [kMinTile, kMaxTile] whose ring and copy stages fit kSmemBudget (so one
// CTA an SM).  CTAs for the zero tail past the last tile holding a frame
// < K follow the channel groups.
inline ShapedGeometry shaped_geometry(long long n, long long S, long long K,
                                      int elem, int sms) {
    long long chans = S, quads = 1;
    if (S > kSplitFrom) {
        while (quads < kMaxQuads &&
               (S + kSplitFrom * quads - 1) / (kSplitFrom * quads) > sms)
            quads *= 2;
        chans = kSplitFrom * quads;
    }
    const long long cmax = S < chans ? S : chans;
    const long long per_frame = (2 * kStages + kRaw) * cmax * elem;
    long long tile = kMaxTile;
    while (tile > kMinTile && kBarBytes + tile * per_frame > kSmemBudget)
        tile /= 2;
    const long long covered = (K + tile - 1) / tile * tile;
    const long long rest = covered < n ? (n - covered) * S : 0;
    const long long chunk = 8LL * kQuadThreads * quads;
    long long zero = (rest + chunk - 1) / chunk;
    if (zero > kMaxZero) zero = kMaxZero;
    return {(S + chans - 1) / chans, zero, tile,
            kBarBytes + tile * per_frame, chans, quads};
}

}  // namespace

#endif  // ART_DECIMATE_GEOMETRY_H
