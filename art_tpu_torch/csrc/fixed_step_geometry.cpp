// fixed_step_geometry.h behind a C interface, built by the host's C++
// compiler (ops/_build.py::geometry_library): which design and tile K1's
// launch takes for a shape, and the resident design's grid, computed by
// the code the launch uses, without a card.  Each function returns 0, or 1
// (CUDA's cudaErrorInvalidValue) for arguments no launch takes.

#include "fixed_step_geometry.h"

// The launch for (M, qn, interpolated, kind) and a hull of ``hull_rows``
// rows (0: not known): out[0..3] = the design (0 the template, 1 the
// resident design, 2 the hull design, 3 the persistent float64 design),
// blocks a row tile, P rows a staged piece (resident: all qn * M; hull:
// hull_rows; persistent float64: a piece buffer's), dynamic shared memory
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

// The resident grid (the resident and hull designs'; the persistent
// float64 design's with G = 1 over all its units) for G column groups
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

// The persistent float64 design's padded rows [a, b) of a column group
// whose 16-phase halves' hulls are [lo0, hi0) and [lo1, hi1) (p64_rows):
// out[0..1] = a, b.
extern "C" int art_fixed_step_p64_rows(int M, int lo0, int hi0, int lo1,
                                       int hi1, int* out) {
    if (M <= 0) return 1;
    p64_rows(M, lo0, hi0, lo1, hi1, out, out + 1);
    return 0;
}

// The rows of P that padded rows [a, b) hold (p64_source_row; -1 for a
// pad row): out[j] for padded row a + j.
extern "C" int art_fixed_step_p64_sources(int M, int a, int b, int* out) {
    if (M <= 0 || a < 0 || b < a) return 1;
    for (int k = a; k < b; ++k) out[k - a] = p64_source_row(M, k);
    return 0;
}
