// K1's host geometry: which of its four designs a launch takes, and each
// design's tile, shared memory and grid.  One source for fixed_step.cu
// (nvcc: the kernels, their launches) and for fixed_step_geometry.cpp (the
// host's C++ compiler: the same functions behind a C interface that needs
// no card, which the tests and chip_smoke.py read through
// ops/fixed_step.py::kernel_tile).  Plain C++ but for the __host__
// __device__ qualifiers nvcc sees.  fixed_step.cu's header says what each
// design does; the numbers here follow from it.

#ifndef ART_FIXED_STEP_GEOMETRY_H
#define ART_FIXED_STEP_GEOMETRY_H

#include <cstddef>

#ifdef __CUDACC__
#define K1_HD __host__ __device__ inline
#else
#define K1_HD inline
#endif

namespace {

constexpr int kBN = 32;                     // phases a CTA (a column group)
constexpr int kTN = 4;                      // phases a thread
constexpr int kColThreads = kBN / kTN;      // 8 threads across the phases
constexpr int kKB = 32;                     // terms a partial sum
constexpr size_t kMaxSmem = 227 * 1024;     // a block's dynamic shared bytes
// the most shared memory each of two CTAs on one SM may take: an SM has
// 228 KB, less 1 KB reserved per CTA
constexpr size_t kTwoPerSm = (228 * 1024 - 2 * 1024) / 2;

// The instances, as the host names them (art_fixed_step's ``kind``).
enum Kind { kF32 = 0, kF32Acc64 = 1, kF64 = 2 };

// =================================================== the resident design
// A CTA of kResGroups warp groups of kResGroupThreads threads keeps its
// column group's whole P in shared memory; each warp group walks row tiles
// through a window buffer of its own, so one group's copies overlap the
// other's FMAs.  A thread computes res_tm blocks x 4 phases of each bank:
// 32 accumulators either way.
constexpr int kResGroups = 2;
constexpr int kResGroupThreads = 128;
constexpr int kResThreads = kResGroups * kResGroupThreads;
constexpr int kResMinM = 32;                // see resident_geometry
K1_HD constexpr int res_tm(bool interp) { return interp ? 4 : 8; }
// blocks a warp group's row tile: 128, or 64 interpolated
K1_HD constexpr int res_bm(bool interp) {
    return kResGroupThreads * res_tm(interp) * kTN / kBN;
}

// P's rows of a slice in shared memory: M rounded up to the 4-row groups
// the FMAs read (the pad rows are zero).
K1_HD int res_mp(int M) { return (M + 3) & ~3; }

// A window row's stride in floats: a multiple of 4, so a row's 16-byte
// groups are aligned, and not of 16, so the four consecutive rows a warp
// reads at one column fall in four different bank quads.
K1_HD int res_stride(int M) {
    const int s = res_mp(M);
    return s % 16 ? s : s + 4;
}

// Floats of one window buffer: the res_bm + qn - 1 rows a tile reads.
K1_HD long long res_stage_elems(int M, int qn, bool interp) {
    return static_cast<long long>(res_bm(interp) + qn - 1) * res_stride(M);
}

// The resident design takes float32 data summed in float32 (the other
// instances keep the template), M of at least 32 (the 4-row groups then
// add at most 3 zero rows to a slice of 32 or more; the integer ratios'
// M of 1 to 4 would mostly multiply pad rows), and shapes whose whole P
// (every row: the hull is found on the device, and a dense P keeps every
// row) and window buffers fit a block's shared memory.  Returns its
// shared-memory bytes, or 0 where it does not take the shape.
inline size_t resident_smem(int M, int qn, bool interp, int kind) {
    const int bnt = interp ? 2 * kBN : kBN;
    const size_t smem =
        (static_cast<size_t>(qn) * res_mp(M) * bnt +
         static_cast<size_t>(kResGroups) * res_stage_elems(M, qn, interp)) *
            sizeof(float) +
        2 * (kResThreads / 32) * sizeof(int);
    return kind == kF32 && M >= kResMinM && smem <= kMaxSmem ? smem : 0;
}

// The resident grid for G column groups of ``units`` row tiles each (every
// channel's), with ``slots`` CTAs resident on the card at once: R CTAs a
// group, each a contiguous run of its group's tiles, so the groups' CTAs
// read the same window rows at about the same time; where the card holds
// fewer CTAs than there are groups, one CTA a slot, each taking every
// slots-th group whole.  Never more CTAs than tiles.
struct ResidentGrid {
    long long ctas, per_group;
};

inline ResidentGrid resident_grid(int G, long long units, long long slots) {
    if (G > slots) return {slots, 1};
    long long r = slots / G;
    if (r > units) r = units;
    return {G * r, r};
}

// The tiles [*t0, *t1) of its group's that CTA ``cta`` takes, and its
// first group; it then takes every (ctas / per_group)-th group after it.
K1_HD void resident_range(long long cta, long long per_group,
                           long long units, int* first, long long* t0,
                           long long* t1) {
    const long long j = cta % per_group;
    *first = static_cast<int>(cta / per_group);
    *t0 = j * units / per_group;
    *t1 = (j + 1) * units / per_group;
}

// =================================================== the hull design
// Where the whole P does not fit: a CTA of the resident design's two warp
// groups keeps only its column group's hull rows of P, [klo, khi) rounded
// out to 4-row groups, which the host finds on a matrix's first launch
// (kept beside P), and each warp group's window buffer holds, for each block of a
// tile, only that block's hull span of its window.  The tiles run over
// every channel's blocks in turn.  A thread computes kHullTM blocks x 4
// phases.
constexpr int kHullTM = 6;
constexpr int kHullBM = kResGroupThreads * kHullTM * kTN / kBN;   // 96

// A block's staged row in floats: the hull's rows (a multiple of 4), +4
// where that is a multiple of 16, so the four rows a warp reads at one
// column fall in four different bank quads.
K1_HD int hull_stride(int rows) { return rows % 16 ? rows : rows + 4; }

// The hull design takes float32 data summed in float32, reduced (one
// bank), M of at least 32 and a multiple of 4 (a slice's edge is then a
// 4-row group's and a 32-term block's), and a hull of ``rows`` rows (the
// widest column group's, rounded out to 4-row groups; 0: not known) whose
// P rows and two window buffers fit a block's shared memory.  Returns its
// shared-memory bytes, or 0 where it does not take the shape.
inline size_t hull_smem(int M, int qn, bool interp, int kind, int rows) {
    if (kind != kF32 || interp || M < kResMinM || M % 4 || rows <= 0 ||
        rows % 4 || rows > qn * M)
        return 0;
    const size_t smem =
        (static_cast<size_t>(rows) * kBN +
         static_cast<size_t>(kResGroups) * kHullBM * hull_stride(rows)) *
        sizeof(float);
    return smem <= kMaxSmem ? smem : 0;
}

// =================================================== the persistent float64 design
// Float64 data summed in float64: one CTA an SM walks (channel, row tile,
// column group) units.  A tile's window (kP64BM blocks' rows) is staged
// once and serves every column group; P's hull rows of each column group
// (the host's hulls, as for the hull design, packed by the host) pass
// through two piece buffers of p64_piece_rows rows x 32 phases, a
// producer warp's bulk copy of the next piece running while the current
// one's DFMAs run.  A compute thread computes kP64TM blocks x 4 phases,
// over pairs of terms (m, m + 1): each pair it loads its blocks' window
// double2s and P's two rows of its phases, 8 16-byte loads for 32 DFMAs;
// rows go in 4-row groups (two pairs a loop step).
constexpr int kP64BM = 128;                 // blocks a row tile
constexpr int kP64TM = 4;                   // blocks a thread
constexpr int kP64RowThreads = kP64BM / kP64TM;
constexpr int kP64Threads = kP64RowThreads * kColThreads;  // compute, + a
                                                           // producer warp
constexpr int kP64MinPR = 32;               // the fewest rows a piece

// A slice's rows in the window and in P's pieces: M rounded up to the
// 4-row groups the DFMAs read (the pad rows are zero in both).
K1_HD int p64_mp(int M) { return (M + 3) & ~3; }

// A window row's stride in doubles: p64_mp(M) + 2, so that a row's pairs
// are 16-byte aligned and the four consecutive rows a warp reads at one
// column fall in four different 16-byte bank quads (the stride in quads
// is odd).
K1_HD int p64_stride(int M) { return p64_mp(M) + 2; }

// Doubles of the window: the kP64BM + qn - 1 rows a tile reads.
K1_HD long long p64_window_elems(int M, int qn) {
    return static_cast<long long>(kP64BM + qn - 1) * p64_stride(M);
}

// The mbarriers after the pieces: each piece buffer's full and empty.
constexpr size_t kP64Barriers = 4 * sizeof(unsigned long long);

// The rows of each of the two piece buffers: the most 4-row groups that
// fit beside the window, no more than the qn padded slices hold; 0 where
// fewer than kP64MinPR fit.
inline int p64_piece_rows(int M, int qn) {
    const long long win =
        p64_window_elems(M, qn) * sizeof(double) + kP64Barriers;
    if (win >= static_cast<long long>(kMaxSmem)) return 0;
    long long pr = (static_cast<long long>(kMaxSmem) - win) /
                   (2 * kBN * static_cast<long long>(sizeof(double)));
    const long long cap = static_cast<long long>(qn) * p64_mp(M);
    pr = (pr < cap ? pr : cap) & ~3LL;
    return pr >= kP64MinPR ? static_cast<int>(pr) : 0;
}

// Padded rows: row k = q*M + m of P at q*Mp + m (Mp = p64_mp(M)), so that
// a slice's rows and a tile's window rows hold the same 4-row groups.
// The row of P that padded row k holds, or -1 for a pad row.
K1_HD int p64_source_row(int M, int k) {
    const int Mp = p64_mp(M);
    return k % Mp < M ? k / Mp * M + k % Mp : -1;
}

// The padded rows [*a, *b) of a column group's hull that the persistent
// float64 design runs, from the hulls [lo0, hi0) and [lo1, hi1) of its two
// 16-phase halves (empty where hi <= lo; an empty half adds nothing):
// their union's padded rows rounded out to 4-row groups (a group never
// crosses a slice); (0, 0) for an empty group.  The host packs P's rows so
// (ops/fixed_step.py::_packed_of, by p64_source_row) and the kernel runs
// them.
K1_HD void p64_rows(int M, int lo0, int hi0, int lo1, int hi1, int* a,
                    int* b) {
    const bool h0 = hi0 > lo0, h1 = hi1 > lo1;
    if (!h0 && !h1) {
        *a = *b = 0;
        return;
    }
    const int Mp = p64_mp(M);
    const int lo = h0 ? (h1 && lo1 < lo0 ? lo1 : lo0) : lo1;
    const int hi = h0 ? (h1 && hi1 > hi0 ? hi1 : hi0) : hi1;
    *a = (lo / M * Mp + lo % M) & ~3;
    *b = ((hi - 1) / M * Mp + (hi - 1) % M + 4) & ~3;
}

// The persistent float64 design takes float64 data summed in float64,
// reduced (one bank), M of at least 32, a P whose hulls are known
// (``hull_rows`` > 0: the rows only say that they are) and shapes whose
// window, two pieces of at least kP64MinPR rows and the mbarriers fit a
// block's shared memory.  Returns its shared-memory bytes, or 0 where it
// does not take the shape.
inline size_t persistent64_smem(int M, int qn, bool interp, int kind,
                                int hull_rows) {
    if (kind != kF64 || interp || M < kResMinM || hull_rows <= 0 ||
        hull_rows > qn * M)
        return 0;
    const int pr = p64_piece_rows(M, qn);
    if (!pr) return 0;
    return (static_cast<size_t>(p64_window_elems(M, qn)) +
            static_cast<size_t>(2) * pr * kBN) *
               sizeof(double) +
           kP64Barriers;
}

// =================================================== the template design
constexpr int kThreads = 256;
constexpr int kRowThreads = kThreads / kColThreads;  // 32
constexpr int kTM0 = 4, kTM1 = 2, kTM2 = 1;          // blocks a thread
constexpr size_t kRedBytes = 2 * (kThreads / 32) * sizeof(int);

// Elements of the whole window segment of a kBM-block CTA: rows of stride
// S = M | 1, padded so what follows starts 16B-aligned.
K1_HD int win_elems(int kBM, int M, int qn) {
    return (((kBM + qn - 1) * (M | 1)) + 3) & ~3;
}

// Elements of a window column piece: kBM rows of PR columns at the odd
// stride PR | 1, padded as above.
K1_HD int wpiece_elems(int kBM, int PR) {
    return ((kBM * (PR | 1)) + 3) & ~3;
}

// The tile for elements of esz bytes: the largest row tile (kTM = 4, 2, 1)
// whose whole window fits with a P piece of all M rows; failing that, the
// largest whose whole window fits with a piece of the most whole 32-row
// blocks that fit; failing that (M above ~1700 in float32), the window in
// column pieces beside P's, the largest tile with the most whole 32-row
// blocks; then two piece buffers where they keep the CTAs per SM that one
// allows.  Every M fits the last form.
inline bool pick_tile(int M, int qn, int BNt, int esz, int* tm, int* pr,
                      int* nbuf, int* wpiece, size_t* smem) {
    constexpr int kTMs[] = {kTM0, kTM1, kTM2};
    size_t win = 0, piece = 0;
    bool found = false;
    for (int whole = 1; whole >= 0 && !found; --whole)
        for (const int t : kTMs) {
            win = static_cast<size_t>(win_elems(kRowThreads * t, M, qn)) *
                  esz + kRedBytes;
            if (win >= kMaxSmem) continue;
            const long long fit = static_cast<long long>(kMaxSmem - win) /
                                  (static_cast<long long>(esz) * BNt);
            const int rows = fit >= M ? M
                                      : static_cast<int>(fit / kKB) * kKB;
            if (rows <= 0 || (whole && rows != M)) continue;
            *tm = t;
            *pr = rows;
            *wpiece = 0;
            piece = static_cast<size_t>(rows) * BNt * esz;
            found = true;
            break;
        }
    for (int k = 0; k < 3 && !found; ++k) {
        const int t = kTMs[k];
        int rows = 0;
        for (int r = kKB; r - kKB < M; r += kKB) {
            const int rr = r < M ? r : M;
            const size_t bytes =
                (static_cast<size_t>(rr) * BNt +
                 wpiece_elems(kRowThreads * t, rr)) * esz;
            if (bytes + kRedBytes > kMaxSmem) break;
            rows = rr;
        }
        if (rows <= 0) continue;
        *tm = t;
        *pr = rows;
        *wpiece = 1;
        win = kRedBytes;
        piece = (static_cast<size_t>(rows) * BNt +
                 wpiece_elems(kRowThreads * t, rows)) * esz;
        found = true;
    }
    if (!found) return false;
    const size_t cap = win + piece <= kTwoPerSm ? kTwoPerSm : kMaxSmem;
    *nbuf = win + 2 * piece <= cap ? 2 : 1;
    *smem = win + *nbuf * piece;
    return true;
}

// The launch a shape takes, as art_fixed_step_geometry reports it.
enum Design { kTemplate = 0, kResident = 1, kHull = 2, kPersistent64 = 3 };

struct Launch {
    Design design;
    int bm;             // blocks a row tile
    int pr;             // P rows a staged piece (resident: all qn * M;
                        // hull: the hull's rows; persistent float64: a
                        // piece buffer's)
    size_t smem;
};

// The resident design where it fits, else the hull design or, for float64
// data, the persistent float64 design where the hull of ``hull_rows``
// rows (0: not known) fits, else the template.
inline bool fixed_step_launch(int M, int qn, bool interp, int kind,
                              int hull_rows, Launch* out) {
    if (M <= 0 || qn <= 0 || kind < kF32 || kind > kF64) return false;
    const size_t res = resident_smem(M, qn, interp, kind);
    if (res) {
        *out = {kResident, res_bm(interp), qn * M, res};
        return true;
    }
    const size_t hull = hull_smem(M, qn, interp, kind, hull_rows);
    if (hull) {
        *out = {kHull, kHullBM, hull_rows, hull};
        return true;
    }
    const size_t p64 = persistent64_smem(M, qn, interp, kind, hull_rows);
    if (p64) {
        *out = {kPersistent64, kP64BM, p64_piece_rows(M, qn), p64};
        return true;
    }
    int tm = 0, pr = 0, nbuf = 0, wpiece = 0;
    size_t smem = 0;
    if (!pick_tile(M, qn, interp ? 2 * kBN : kBN, kind == kF64 ? 8 : 4, &tm,
                   &pr, &nbuf, &wpiece, &smem))
        return false;
    *out = {kTemplate, kRowThreads * tm, pr, smem};
    return true;
}

}  // namespace

#endif  // ART_FIXED_STEP_GEOMETRY_H
