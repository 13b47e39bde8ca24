// fixed_step_geometry.h behind a C interface, built by the host's C++
// compiler (ops/_build.py::geometry_library): which design and tile K1's
// launch takes for a shape, and the resident design's grid, computed by
// the code the launch uses, without a card.  Each function returns 0, or 1
// (CUDA's cudaErrorInvalidValue) for arguments no launch takes.

#include "fixed_step_geometry.h"

// The launch for (M, qn, interpolated, kind) and a hull of ``hull_rows``
// rows (0: not known): out[0..3] = the design (0 the template, 1 the
// resident design, 2 the hull design), blocks a row tile, P rows a staged
// piece (resident: all qn * M; hull: hull_rows), dynamic shared memory
// bytes.
extern "C" int art_fixed_step_geometry(int M, int qn, int interp, int kind,
                                       int hull_rows, long long* out) {
    Launch lc;
    if (!fixed_step_launch(M, qn, interp != 0, kind, hull_rows, &lc))
        return 1;
    out[0] = lc.design;
    out[1] = lc.bm;
    out[2] = lc.pr;
    out[3] = static_cast<long long>(lc.smem);
    return 0;
}

// The resident grid (the resident and hull designs') for G column groups
// of ``units`` row tiles each on ``slots`` resident CTAs, and CTA
// ``cta``'s share of it: out[0..4] = CTAs, CTAs a group, the CTA's first
// group, its tiles [t0, t1).
extern "C" int art_fixed_step_grid(int G, long long units, long long slots,
                                   long long cta, long long* out) {
    if (G < 1 || units < 1 || slots < 1) return 1;
    const ResidentGrid g = resident_grid(G, units, slots);
    if (cta < 0 || cta >= g.ctas) return 1;
    int first = 0;
    long long t0 = 0, t1 = 0;
    resident_range(cta, g.per_group, units, &first, &t0, &t1);
    out[0] = g.ctas;
    out[1] = g.per_group;
    out[2] = first;
    out[3] = t0;
    out[4] = t1;
    return 0;
}
