// decimate_geometry.h behind a C interface, built by the host's C++
// compiler (ops/_build.py::geometry_library): the decimate kernels' launch
// geometry and the dither LCG's pair map, computed by the code their
// launches use, without a card.  Each function returns 0, or 1 (CUDA's
// cudaErrorInvalidValue) for arguments the kernels do not take.

#include "decimate_geometry.h"

// The flat kernel's grid for n frames of S channels of kind 0 (float32)
// or 1 (float64) on ``sms`` SMs: out[0..5] = CTAs, threads a CTA, elements
// a lane's run, the lanes' stride in frames (0: one run a lane, or lanes
// that jump per run), and the LCG map (a, b) of 5 * stride steps.
extern "C" int art_decimate_flat_geometry(long long n, long long S,
                                          int kind, int sms,
                                          long long* out) {
    if (n < 0 || S < 1 || S > (1 << 30) || sms < 1 ||
        (kind != 0 && kind != 1))
        return 1;
    const FlatGeometry geo = flat_geometry(n, S, sms, kind == 0 ? 4 : 8);
    out[0] = geo.ctas;
    out[1] = kFlatThreads;
    out[2] = kRun;
    out[3] = geo.st.frames;
    out[4] = geo.st.a;
    out[5] = geo.st.b;
    return 0;
}

// The shaped kernel's launch for kind 0 (float32) or 1 (float64) on
// ``sms`` SMs: out[0..8] = channel-group CTAs, zero-tail CTAs, tile frames,
// ring stages, threads, dynamic shared memory bytes, channels a CTA,
// producer threads a CTA, 1 where the launch takes the many-channel split
// (more than kSplitFrom channels) else 0.
extern "C" int art_decimate_shaped_geometry(long long n, long long S,
                                            long long K, int kind, int sms,
                                            long long* out) {
    if (n < 0 || S < 1 || S > (1 << 30) || K < 0 || K > n || sms < 1 ||
        (kind != 0 && kind != 1))
        return 1;
    const ShapedGeometry geo =
        shaped_geometry(n, S, K, kind == 0 ? 4 : 8, sms);
    out[0] = geo.groups;
    out[1] = geo.zero;
    out[2] = geo.tile;
    out[3] = kStages;
    out[4] = kQuadThreads * geo.quads;
    out[5] = geo.smem;
    out[6] = geo.chans;
    out[7] = kQuadProducers * geo.quads;
    out[8] = S > kSplitFrom;
    return 0;
}

// The map of 2 * pairs LCG steps from a state of parity ``odd``: out[0..1]
// = (a, b), g -> a g + b (the odd map's b is already negated).
extern "C" int art_decimate_pair_power(int odd, unsigned long long pairs,
                                       unsigned int* out) {
    const Affine f = pair_power(odd != 0, pairs);
    out[0] = f.a;
    out[1] = f.b;
    return 0;
}
