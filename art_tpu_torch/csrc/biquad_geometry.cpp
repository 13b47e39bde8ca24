// biquad_geometry.h behind a C interface, built by the host's C++ compiler
// (ops/_build.py::geometry_library): the biquad kernel's span, table and
// scratch layout and its launch geometry, from the code its launch uses,
// without a card.  Each function returns 0, or 1 (CUDA's
// cudaErrorInvalidValue) for arguments the kernel does not take.

#include "biquad_geometry.h"

// out[0..16] = threads, frames a thread, span frames, window, staged
// stride a thread, CTAs an SM (launch bounds), the table's doubles and its
// offsets (a|b, W, carry, the first E-free warp, M^d, M^(32w), P^d),
// record words, and the record's offsets (u, E).
extern "C" int art_biquad_constants(long long* out) {
    const long long v[] = {kBqThreads, kBqFrames, kBqSpan, kBqWindow,
                           kBqPad, kBqMinBlocks, kTabDoubles, kTabAb,
                           kTabWindow, kTabCarry, kTabFree, kTabM, kTabMw,
                           kTabP, kBqRecWords, kRecU, kRecE};
    for (unsigned i = 0; i < sizeof(v) / sizeof(v[0]); ++i) out[i] = v[i];
    return 0;
}

// The launch of one section over n frames of S streams, K valid, kind 0
// (float32) or 1 (float64; both staged in float64): out[0..4] = spans a stream, spans holding a
// frame below K, CTAs, dynamic shared memory bytes, scratch words.
extern "C" int art_biquad_geometry(long long n, long long S, long long K,
                                   int kind, long long* out) {
    if (n < 0 || S < 1 || K < 0 || K > n || (kind != 0 && kind != 1))
        return 1;
    const BiquadGeometry g = biquad_geometry(n, S, K);
    out[0] = g.spans;
    out[1] = g.active;
    out[2] = g.ctas;
    out[3] = g.smem;
    out[4] = g.scratch;
    return 0;
}
