// The biquad kernel's geometry: one source for biquad.cu (nvcc: the
// kernel, its launch) and for biquad_geometry.cpp (the C++ host compiler:
// the same constants and functions behind a C interface that needs no
// card, which the tests read through ops/biquad_kernel.py's
// library_geometry and hold against the module's own copy of the layout).
// Plain C++ but for the __host__ __device__ qualifiers nvcc sees.

#ifndef ART_BIQUAD_GEOMETRY_H
#define ART_BIQUAD_GEOMETRY_H

#ifdef __CUDACC__
#define ART_BQ_HD __host__ __device__ inline
#else
#define ART_BQ_HD inline
#endif

namespace {

// ------------------------------------------------------------------ a span
// One CTA runs one span of one stream: kBqThreads threads, each a block of
// kBqFrames consecutive frames.  The span is staged in shared memory in
// float64 (whatever the data's type) with one pad element after each
// thread's block, so that the threads of a warp reading frame t of their
// blocks hit distinct banks.
constexpr int kBqThreads = 256;
constexpr int kBqFrames = 32;
constexpr int kBqWarps = kBqThreads / 32;
constexpr int kBqSpan = kBqThreads * kBqFrames;     // 8192 frames
constexpr int kBqWarpFrames = 32 * kBqFrames;       // a warp's region
constexpr int kBqPad = kBqFrames + 1;               // staged stride a thread
constexpr int kBqMinBlocks = 3;                     // CTAs an SM (launch
                                                    //   bounds)
// The look-back window: span j's entering state sums the aggregates of the
// W <= kBqWindow spans before it and P^W times the state entering span
// j - W (warp 0: lanes 0 .. W-1 the aggregates, lane kBqWindow the state).
constexpr int kBqWindow = 16;

static_assert(kBqThreads % 32 == 0 && kBqWarps <= 32, "whole warps");
static_assert(kBqFrames == 32, "lane l's entering state uses M^l, l < 32");
static_assert(kBqWindow < 32, "the window fits warp 0 with its E lane");

// ------------------------------------------------- a section's tables
// float64, built by the host once a section (ops/biquad_kernel.py's
// kernel_tables), M = A^kBqFrames (A the companion matrix of b), P =
// M^kBqThreads = A^kBqSpan (a span's transition), all 4x4 row-major:
constexpr int kTabAb = 0;           // a0..a4, b0..b4
constexpr int kTabWindow = 10;      // W, the window used (1..kBqWindow)
constexpr int kTabCarry = 11;       // 1 when P^W is not exactly zero
constexpr int kTabFree = 12;        // the least w >= 1 with M^(32 w) exactly
                                    //   zero (kBqWarps if none): warps from
                                    //   it on never wait for E_j
constexpr int kTabM = 16;           // M^d, d = 0..31
constexpr int kTabMw = kTabM + 16 * 32;             // M^(32 w), w < kBqWarps
constexpr int kTabP = kTabMw + 16 * kBqWarps;       // P^d, d <= kBqWindow
constexpr int kTabDoubles = kTabP + 16 * (kBqWindow + 1);

// ------------------------------------------------ the call's scratch
// Records of kBqRecWords 64-bit words (128 bytes): record 0's first word
// the ticket counter (the last CTA to draw a ticket sets it back to 0),
// record 1 + j * S + s that of span j of stream s: u_j and E_j, each 4
// pairs {a double's bits, the epoch of the launch that wrote it}.
constexpr int kBqRecWords = 16;
constexpr int kRecU = 0, kRecE = 8;

struct BiquadGeometry {
    long long spans;        // a stream's spans (at least 1)
    long long active;       // spans that hold a frame below K
    long long ctas;         // spans * S, one launch a section
    long long smem;         // dynamic shared memory bytes a CTA
    long long scratch;      // 64-bit words of scratch
};

// The launch of one section over n frames of S streams, K of them valid.
ART_BQ_HD BiquadGeometry biquad_geometry(long long n, long long S,
                                         long long K) {
    BiquadGeometry g;
    g.spans = n > 0 ? (n + kBqSpan - 1) / kBqSpan : 1;
    g.active = (K + kBqSpan - 1) / kBqSpan;
    g.ctas = g.spans * S;
    g.smem = static_cast<long long>(kBqThreads) * kBqPad * sizeof(double);
    g.scratch = (1 + g.ctas) * kBqRecWords;
    return g;
}

}  // namespace

#endif  // ART_BIQUAD_GEOMETRY_H
