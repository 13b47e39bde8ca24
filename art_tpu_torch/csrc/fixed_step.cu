// K1 for NVIDIA Hopper (sm_90a): the fixed-ratio streaming contraction.
//
// Replaces art_tpu/ops/fixed_pallas.py::fixed_step_pallas (body
// _fixed_kernel), the Pallas kernel of parallel/streams.py's chunk step,
// and, launched with start 0 and nothing masked, K6
// (art_tpu/ops/pallas_kernels.py::polyphase_apply_pallas).
// What it computes, for every channel c, output block i < nb and phase l < L:
//
//   out[c, i*L + l] = sum_{k < KQ} buf[c, start + i*M + k] * P[k, l]
//
// with KQ = qn*M, reads past the end of buf taken as zero, and out set to 0
// where i*L + l >= K.  With ``fracv`` (the interpolated mode) P stacks two
// phase banks [KQ, 2L] and the two dots are lerped per phase:
//   out = d1 * (1 - fracv[l]) + d2 * fracv[l]
// (reference subsample_interpolate, dot-then-lerp as in the JAX body).
//
// Three instances serve the engine's precision tiers
// (art_tpu/parallel/streams.py:604-620, which runs them as XLA dots,
// art_tpu/parallel/pipeline.py:39-143):
//   <float, float>    float32 data, the default tier;
//   <float, double>   precise=True and precise="int8": every product of two
//                     float32 values is exact in double, the dot is one
//                     DFMA chain, rounded once to float32
//                     (__double2float_rn); interpolated, both banks'
//                     dots are rounded, then lerped in float32 as JAX's
//                     graph computes it, fma(d1, 1 - f, d2 * f);
//   <double, double>  float64 data: bank, window, P, fracv and out in
//                     double, one DFMA chain, the lerp in double.
// "int8" is JAX's Ozaki-split int8 dot, a TPU route to the same
// single-rounding result; the <float, double> instance computes that
// function directly.
//
// The sum.  In float32 each output's KQ-term dot is summed slice by slice,
// in blocks of 32 terms (m = 0, 32, 64, ... of each slice) whose partial
// sums, each started at +0 and accumulated by FFMA in m order, are then
// added to the total in slice order, instead of one sequential FMA chain:
// the chain's rounding error grows with the ~190 terms added after the
// filter's centre to a full-size sum (summed in one chain, the 60 s round
// trip read -133.91 dB on an H100, the CPU's blocked sgemm -136.49 dB;
// blocks of 32 cost ~3% more adds).  The double accumulators need no
// blocks: one DFMA chain over k = 0, 1, ... .  Both designs below skip or
// add only terms whose P entry is zero for every column of the CTA, and
// fma(a, 0, part) == part for finite audio (a partial sum that starts at
// +0 never becomes -0), so the bytes are those of a kernel that multiplied
// every row, whatever the design or tile.  IEEE FFMA on the CUDA cores: no
// TF32, no tensor cores (Hopper's tensor cores have no IEEE float32 mode).
//
// What bounds it.  The main path (44.1k->48k, M=147, L=160, qn=4) needs,
// for each output, the 380 taps of its phase's filter (a P column's other
// 208 of 588 rows are structural zeros): 2 FLOP a tap, ~100 FLOP a byte of
// input and output, so it is bound by the float32 FMA rate (67 TFLOP/s on
// an H100 SXM at 700 W): a 2^22-frame stereo chunk 0.1036 ms, a group of 8
// x 8,388,555 frames 1.657 ms.  The double-accumulated instances do the
// same count of FP64 FMAs (34 TFLOP/s on the CUDA cores they run on).
// That is arithmetic from shapes and the data sheet, not a measurement.
//
// The shared loads feed the FMAs.  An SM issues 4 warp-FFMAs a cycle; its
// shared memory answers one 16-byte-a-lane load (LDS.128) in 2 cycles when
// the warp's distinct addresses fit 128 bytes in distinct banks (lanes
// reading one address share it), a 4-byte one in 1 (measured on an H100).
// A thread's register tile of TM blocks x TN phases takes, each 4 terms,
// TM window float4s (4 terms of a block) and 4 P float4s a TN/4 for
// 4*TM*TN FMAs: 2*(TM + TN) shared cycles a warp against TM*TN FFMA
// cycles.  4 x 4 needs the shared memory as long as the FMAs, 8 x 4 three
// quarters of it.  Each CTA also has to find which rows of P its 32
// columns use (the hull: a column l is nonzero only on rows [carry(l),
// carry(l) + taps), so a CTA's 32 columns, both banks' in the interpolated
// form, are nonzero only inside [klo, khi): ~409 of 588 rows at the main
// path, ~78 of 294 at BASELINE config 1, 196-224 of 640 at the batch
// cell's preset -2 96k->44.1k) and bring those rows and its window into
// shared memory.  Four designs, the host choosing by the data's type, the
// shape and the hull (fixed_step_geometry.h::fixed_step_launch; no
// option):
//
// Design: resident (fixed_step_kernel_resident; float32 data summed in
// float32, M >= 32, where the CTA's whole P and two window buffers fit).
//   - Persistent CTAs, one an SM at the shapes that take it (the grid is
//     the card's resident CTAs, never more than the tiles): R CTAs a
//     column group of 32 phases, each a contiguous run of the group's row
//     tiles, every channel's (P is the same for each), so the groups' CTAs
//     read the same window rows at about the same time and the window
//     comes from DRAM once.  A CTA copies its group's columns of every row
//     of P into shared memory once (75,776 B at the main path: 4 slices of
//     M rounded up to 148 rows, the pad rows zero; a dense P keeps every
//     row), finds the hull there, and keeps both for the whole launch.
//     Where the card holds fewer CTAs than there are groups, a CTA takes
//     its groups one after another.
//   - Two warp groups of 128 threads take the CTA's tiles in turn, each
//     through a window buffer of its own: while one copies its next tile's
//     window (cp.async, then its own named barrier), the other's FMAs run.
//     The second group starts one copy after the first, so that their
//     copies fall apart.  (Two buffers of one 128-block tile each and P
//     fill the 227 KB; a 256-thread CTA over one ring of two would need a
//     4 x 4 tile, whose loads keep the shared memory as busy as the FMAs:
//     4.33 ms a p3_flat_bulk group against 3.92 on an H100.)  A tile's window rows
//     i0 + r (r < BM + qn - 1; row r + q holds the samples block r reads
//     from slice q) land at a stride S = M rounded up to a multiple of 4
//     (148 at the main path; +4 where that is a multiple of 16, so the
//     four consecutive rows a warp reads fall in four bank quads), with
//     columns [M, S) zero.  The rows start at any offset of buf, so they
//     come in as 4-byte cp.async, a warp a row; the aligned rows are what
//     let the FMAs read 4 terms of the window in one 16-byte load.
//   - A thread computes 8 blocks x 4 phases (BM = 128; interpolated, 4 x
//     4 of both banks, BM = 64): each 4 terms it loads 8 window float4s
//     and 4 P float4s (8 interpolated) for 128 FFMAs, the next group's
//     loads issued from a second register set before this group's FMAs
//     need theirs.  Terms go in 4-row groups over each slice's hull rows,
//     rounded out to multiples of 4 (the extra rows are zero in every
//     column of the CTA).
//   main path: 256 threads, P 75,776 B + 2 x 131 rows x 148 floats + the
//   hull's reduction = 230,944 B, one CTA an SM.
//
// Design: hull (fixed_step_kernel_hull<kWide>; float32 data summed in
// float32, reduced, M >= 32 a multiple of 4, where the whole P and two
// buffers of whole window rows do not fit but the hull does: P's hull rows
// and two buffers of 96 blocks' hull spans).  The resident design's
// structure (persistent CTAs, R a column group, two warp groups with a
// window buffer each, out of step by one copy, the double register set),
// with what is staged cut to the hull:
//   - the hull's width has to be known before the launch, to size shared
//     memory, so the host finds the hulls once a matrix, on its first
//     launch (ops/fixed_step.py::_hulls_of, kept beside P): the hull of
//     each 16-phase half of each column group (int32 [2G, 2] on the
//     device) and the widest column group's, rounded out to 4-row groups,
//     as a launch argument.  A P whose hull does not fit takes the
//     template;
//   - a CTA copies only its group's hull rows [k0, k1) of P (the union of
//     its halves', rounded out to 4-row groups; the extra rows are zero in
//     every column of the CTA) once a column group: 228 x 32 floats at the
//     batch cell;
//   - for each block of a tile, only the block's hull span of its window,
//     buf[c, start + i*M + k], k0 <= k < k1, lands as a row of the group's
//     buffer at a stride of k1 - k0 (a multiple of 4; +4 where that is a
//     multiple of 16), a warp a row: in 16-byte cp.async (kWide) where
//     every row's source is 16-byte aligned (buf, W and start multiples of
//     4: the engine frames its group buffers so where this design runs,
//     ops/fixed_step.py::window_frame), else 4-byte.  Where M is wider than
//     the hull, neighbouring blocks' spans do not overlap and this is less
//     than the (BM + qn - 1) whole rows the resident design copies; where
//     the hull is wider than M (the main path: ~409 rows at M = 147) whole
//     rows are the cheaper copy, and the resident design keeps them.  (At
//     the batch cell's call on an H100: 16-byte copies 1.39 ms, 4-byte
//     1.62, 8-byte ones of rows 8 bytes off 1.64; bulk copies, the TMA, one
//     a row on an mbarrier, 1.50 against 16-byte cp.async's 1.46 before
//     the halves below.)
//   - each staged row is one block's, copied from its own address, so the
//     tiles run over every channel's blocks in turn (block i of channel c
//     is block c * nb + i): every tile but the launch's last is full (205
//     blocks a channel fill 71% of three 96-block tiles cut one channel at
//     a time);
//   - a thread computes 6 blocks x 4 phases (BM = 96: two buffers of
//     128-block tiles do not fit beside P's hull).  Warps 0-1 of a warp
//     group take the column group's first 16 phases and warps 2-3 the
//     other 16, each over its half's hull rows alone (189 of the group's
//     228 at the batch cell; a warp's 8 block rows read 8 window float4s
//     in 8 bank quads, its 4 phase columns 4 P float4s), in 4-row groups
//     (M a multiple of 4 puts a slice's edge on one), the partial sums
//     flushed at m = 32, 64, ... of the slice and at its end, as in the
//     other designs.  Rows a half skips are zero in all its columns.
//   batch cell: 256 threads, P 29,184 B + 2 x 96 x 228 floats = 204,288 B,
//   one CTA an SM.
//
// Design: persistent float64 (fixed_step_kernel<double, double,
// Persistent>; float64 data summed in float64, reduced, M >= 32, P's hulls
// known, where a 128-block tile's window and two P pieces of at least 32
// rows fit: config 4's M = 160 and art64's M = 147).  The template's
// float64 CTA did its steps in series, one CTA an SM (its window alone
// takes ~168 KB): stage its window, scan P through L2 for its hull, then
// for each piece of the hull's rows wait for the copy, sync, DFMA, sync.
// Here:
//   - persistent CTAs, one an SM (the grid is the card's resident CTAs,
//     never more than the units): the units are (channel, 128-block row
//     tile, column group), column group fastest, each CTA a contiguous
//     run of them, so a tile's window is staged once (131 rows x 160
//     doubles at config 4) and serves every column group, where the
//     template staged it once a column group;
//   - the hulls come from the host (ops/fixed_step.py::_hulls_of, as for
//     the hull design): no CTA scans P.  A column group's hull rows,
//     rounded out to 4-row groups in padded rows (row q*M + m at q*Mp + m,
//     Mp = M rounded up to a multiple of 4; pad rows and the window's pad
//     columns are zero), are packed by the host once a matrix
//     (_packed_of: [column group, row, 32 phases]), so each piece of PR
//     rows is one contiguous bulk copy (the TMA, cp.async.bulk);
//   - a producer warp issues those copies into two piece buffers, handing
//     each over through mbarriers (full: the bytes landed; empty: every
//     compute warp is done with it), across column groups and tiles, so
//     P's copies run under the DFMAs and no CTA-wide barrier separates
//     pieces.  Only a new tile's window waits: its rows come by cp.async,
//     element by element, a warp a row;
//   - window rows at a stride S = Mp + 2 (162 at M = 160): a row's pairs
//     are 16-byte aligned and the four rows a warp reads at one column
//     fall in four bank quads.  A compute thread computes 4 blocks (32
//     apart) x 4 phases, pairs of terms at a time: each pair 4 window
//     double2s (blocks x terms m, m + 1) and 4 P double2s (two rows x two
//     phase pairs 16 apart) for 32 DFMAs, the next pair's loads issued
//     from a second register set before this pair's DFMAs, a loop step a
//     4-row group with no branch between a load and its DFMAs.  (8 x 4 on
//     128 compute threads, one warp a scheduler, measured level on an
//     H100 at a c4b_chain_f64 group; a DFMA probe reads
//     4 x 4 at two warps a scheduler and 8 x 4 at one at 57% and 56% of
//     the plain FP64 rate once the shared loads feed them, 83% and 77%
//     from registers alone);
//   - each output is one DFMA chain from +0 over k ascending, as in the
//     template; the extra rows (pad rows, and rows outside an output's
//     own hull but inside its group's) are zero in its column, so the
//     bytes are the template's.
//   config 4: 256 compute threads and a producer warp, 131 x 162 + 2 x
//   120 x 32 doubles and 4 mbarriers = 231248 B, one CTA an SM.
//
// Design: template (fixed_step_kernel<T, Acc, kInterp, kTM>; the float32
// data with float64 accumulators, interpolated float64, M < 32, and shapes
// whose P and ring do not fit, such as large M, or whose hull is not
// known).  A CTA owns kBM output blocks x 32 phases of one channel:
//   - it first reads its columns of P once through L2 and finds its hull
//     from P's values, so staging and FMAs then cover the hull only;
//   - where it fits, the CTA's window segment [i0*M, (i0+kBM)*M + KQ) is
//     staged once, as rows of M samples at an odd row stride S, so row
//     i0+r+q holds the samples block r needs from slice q: element k =
//     q*M + m of block r's window is win_s[(r + q)*S + m], and the four
//     rows a warp reads at one m fall in four different banks (for 8-byte
//     elements the four rows' words are 2S apart, so they still take four
//     different bank pairs), copied with element-wide cp.async, a warp per
//     row, while the hull is found;
//   - P passes through in pieces of PR rows of one M-row slice of the
//     CTA's 32 (or 2x32) columns, the hull's rows only; where two piece
//     buffers still fit the CTA's share of the SM, piece p + 1 is copied
//     while piece p is used, else one buffer;
//   - where the whole window does not fit (M above ~1700 in float32), each
//     piece carries the window too: columns [m0, m0 + PR) of the kBM
//     window rows its slice's blocks read, at an odd row stride, so any M
//     fits.  The pieces and each output's terms keep their order;
//   - each thread accumulates a 4x4 register tile (4 blocks strided by 32,
//     4 phases: adjacent ones read as one float4, or, in double, two
//     pairs 16 phases apart read as two double2), so every k step does 5
//     (double: 6) shared loads for 16 FMAs;
//   - two CTAs share an SM where their shared memory allows, so one CTA's
//     hull scan and staging overlap the other's FMAs.
//   The host picks the row tile kBM = 32 * TM, TM in {4, 2, 1}, and the P
//   piece (fixed_step_geometry.h::pick_tile): the largest tile whose whole
//   window fits with PR = M, else the largest whose whole window fits with
//   PR a multiple of 32; failing both, the window in column pieces; then
//   two piece buffers where they fit in the same occupancy.
//
// The launch each shape takes (fixed_step_geometry.h; two CTAs share an SM
// up to 115712 B each; the hull rows those of the engine's
// matrices there, the hull design taking none of the other shapes: 420
// rows at M = 160, 520 at M = 640, 924 at M = 2560, and the interpolated
// and float64-summed shapes are not its; the float64 data with its hulls
// known, as the launches find them):
//   float32, M = 147, qn = 4 (the main path)   resident, BM = 128            230944 B
//   float32, M = 147, qn = 2, interpolated     resident, BM = 64             152800 B
//   float32, M = 160, qn = 4 (48k->44.1k)      template kBM = 128, PR = M, 1 buffer  104912 B
//   float32, M = 320, qn = 2, reduced          hull, BM = 96, 228 P rows     204288 B
//     (preset -2, the batch cell; with no hull known the template, kBM =
//     128, PR = M, 1 buffer, 206672 B)
//   float32, M = 320, qn = 2, interpolated     template kBM =  64, PR = M, 1 buffer  165456 B
//   float32, M = 640, qn = 2, reduced          template kBM =  32, PR = M, 1 buffer  166608 B
//   float32, M = 640, qn = 2, interpolated     template kBM =  64, PR = 256, 1 buffer 232272 B
//   float32, M = 2560, qn = 2, reduced         template, column pieces, kBM = 128, PR = 352 225856 B
//   float32, M = 2560, qn = 2, interpolated    template, column pieces, kBM = 128, PR = 288 221760 B
//   float32 with float64 sums, M = 147, qn = 4 template kBM = 128, PR = M, 2 buffers 114736 B
//   float64, M = 160, qn = 4 (config 4)        persistent float64, BM = 128, 2 x 120 P rows 231248 B
//     (with no hull known the template, kBM = 128, PR = M, 1 buffer,
//     209760 B)
//   float64, M = 147, qn = 4 (art64 44.1k->48k) persistent float64, BM = 128, 2 x 144 P rows 230960 B
//   float64, M = 320, qn = 2, reduced          template kBM =  32, PR = M, 1 buffer  166752 B
//     (the persistent design's 128-block window would take 334880 B)
// Offsets into buf and out are 64-bit: c*W and c*nb*L outgrow 2^31 for
// grouped flat buffers.

#include <cuda_runtime.h>

#include <climits>
#include <type_traits>

#include "fixed_step_geometry.h"

namespace {

constexpr int kWarps = kThreads / 32;

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(sizeof(T)) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The phase (within the CTA's 32) of thread column tx's j-th accumulator:
// 4 adjacent ones in float, two pairs 16 apart in double (see lds).
template <typename T>
__device__ __forceinline__ int colof(int tx, int j) {
    if constexpr (sizeof(T) == 4)
        return tx * kTN + j;
    else
        return (j >> 1) * (2 * kColThreads) + tx * 2 + (j & 1);
}

// Thread column tx's kTN P entries of one staged row, in 16-byte loads.
__device__ __forceinline__ void lds(const float* p, int tx, float (&v)[kTN]) {
    const float4 q = *reinterpret_cast<const float4*>(p + tx * kTN);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void lds(const double* p, int tx,
                                    double (&v)[kTN]) {
    const double2 a = *reinterpret_cast<const double2*>(p + tx * 2);
    const double2 b =
        *reinterpret_cast<const double2*>(p + 2 * kColThreads + tx * 2);
    v[0] = a.x; v[1] = a.y; v[2] = b.x; v[3] = b.y;
}

// Rows [*r0, *r1) of slice *q that piece t (rows [mp, mp + PR) of its
// slice, pps pieces a slice) holds inside the hull [klo, khi) of the KQ
// rows; none when *r0 >= *r1.
__device__ __forceinline__ void piece_rows(int t, int pps, int PR, int M,
                                           int klo, int khi, int* q, int* r0,
                                           int* r1) {
    *q = t / pps;
    const int mp = (t - *q * pps) * PR;
    *r0 = max(mp, klo - *q * M);
    *r1 = min(min(mp + PR, M), khi - *q * M);
}

// The first piece from t on that holds hull rows, or n (none).
__device__ __forceinline__ int next_piece(int t, int n, int pps, int PR,
                                          int M, int klo, int khi) {
    for (; t < n; ++t) {
        int q, r0, r1;
        piece_rows(t, pps, PR, M, klo, khi, &q, &r0, &r1);
        if (r0 < r1) break;
    }
    return t;
}

// T: data (window, P, fracv, out); Acc: the dot's accumulator.  Two CTAs
// per SM where float data's shared memory allows it, in 128 registers;
// one where double data's shared memory allows no more (see the header),
// and for the 32 double accumulators of a precise interpolated tile.
template <typename T, typename Acc, bool kInterp, int kTM>
__global__ void __launch_bounds__(
    kThreads,
    sizeof(T) == 4 && (std::is_same<Acc, float>::value || !kInterp) ? 2 : 1)
fixed_step_kernel(const T* __restrict__ buf, long long W, long long start,
                  long long K, const T* __restrict__ P, int L2,
                  const T* __restrict__ fracv, int M, int L, int qn,
                  int PR, int nbuf, int wpiece, long long nb,
                  T* __restrict__ out) {
    constexpr int BNt = kInterp ? 2 * kBN : kBN;
    constexpr int kBM = kRowThreads * kTM;
    // float accumulators sum in blocks of 32 terms (see the header)
    constexpr bool kBlocked = std::is_same<Acc, float>::value;
    extern __shared__ float4 smem4[];
    T* win_s = reinterpret_cast<T*>(smem4);       // whole window, if staged
    // nbuf piece buffers: P's piece, then (column pieces) the window's
    T* P_s = win_s + (wpiece ? 0 : win_elems(kBM, M, qn));
    const int bufsz = PR * BNt + (wpiece ? wpiece_elems(kBM, PR) : 0);
    int* red = reinterpret_cast<int*>(P_s + nbuf * bufsz);
    const int S = M | 1;
    const int SP = PR | 1;
    const int KQ = qn * M;

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int tx = tid % kColThreads;
    const int ty = tid / kColThreads;
    const int n0 = blockIdx.x * kBN;
    const long long i0 = static_cast<long long>(blockIdx.y) * kBM;
    const T* bufc = buf + static_cast<long long>(blockIdx.z) * W;

    // whole window segment, a warp per row: row r, column m is buf[start +
    // (i0 + r)*M + m] (zero past W), one cp.async group (empty when the
    // window comes in column pieces)
    if (!wpiece) {
        const long long g0 = start + i0 * M;
        for (int r = warp; r < kBM + qn - 1; r += kWarps)
            for (int m = lane; m < M; m += 32) {
                const long long g = g0 + static_cast<long long>(r) * M + m;
                if (g < W) cp_async(win_s + r * S + m, bufc + g);
                else win_s[r * S + m] = T(0);
            }
    }
    cp_async_commit();

    // The hull [klo, khi): the first and last of the KQ rows in which any
    // of the CTA's columns (of either bank) is nonzero.  Thread tid reads
    // column tid % BNt of every (kThreads / BNt)-th row.
    const int jc = tid % BNt;
    const int col = n0 + jc % kBN;
    int lo = INT_MAX, hi = -1;
    if (col < L) {
        const T* pc = P + (jc >= kBN ? L + col : col);
#pragma unroll 8
        for (int k = tid / BNt; k < KQ; k += kThreads / BNt) {
            const bool nz = __ldg(pc + static_cast<long long>(k) * L2) != T(0);
            lo = nz ? min(lo, k) : lo;
            hi = nz ? k : hi;
        }
    }
    lo = __reduce_min_sync(0xffffffffu, lo);
    hi = __reduce_max_sync(0xffffffffu, hi);
    if (lane == 0) {
        red[warp] = lo;
        red[kWarps + warp] = hi;
    }
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        lo = min(lo, red[w]);
        hi = max(hi, red[kWarps + w]);
    }
    const int klo = lo, khi = hi + 1;      // empty when khi <= klo

    // piece t into buffer b, one group: its hull rows of the CTA's 32 (or
    // 2x32) columns of P (row m at (m - r0) * BNt, zero for columns past
    // L), and with column pieces the window rows i0 + q + r, r < kBM, at
    // columns [r0, r1) (row r, column m at r * SP + m - r0, zero past W)
    const int pps = (M + PR - 1) / PR;
    const int npieces = qn * pps;
    auto stage = [&](int t, int b) {
        int q, r0, r1;
        piece_rows(t, pps, PR, M, klo, khi, &q, &r0, &r1);
        T* dst = P_s + b * bufsz;
        const T* src = P + static_cast<long long>(q * M) * L2 +
                       (jc >= kBN ? L + col : col);
        for (int m = r0 + tid / BNt; m < r1; m += kThreads / BNt) {
            T* d = dst + (m - r0) * BNt + jc;
            if (col < L) cp_async(d, src + static_cast<long long>(m) * L2);
            else *d = T(0);
        }
        if (wpiece) {
            T* wd = dst + PR * BNt;
            const long long g0 = start + (i0 + q) * M;
            for (int r = warp; r < kBM; r += kWarps)
                for (int m = r0 + lane; m < r1; m += 32) {
                    const long long g = g0 + static_cast<long long>(r) * M + m;
                    T* d = wd + r * SP + (m - r0);
                    if (g < W) cp_async(d, bufc + g);
                    else *d = T(0);
                }
        }
        cp_async_commit();
    };

    Acc acc[kTM][kTN] = {};
    Acc acc2[kInterp ? kTM : 1][kTN] = {};
    int t = next_piece(0, npieces, pps, PR, M, klo, khi);
    if (t < npieces) stage(t, 0);
    for (int i = 0; t < npieces; ++i) {
        const int tn = next_piece(t + 1, npieces, pps, PR, M, klo, khi);
        if (nbuf == 2 && tn < npieces) {
            stage(tn, (i + 1) & 1);
            cp_async_wait<1>();
        } else {
            cp_async_wait<0>();
        }
        __syncthreads();        // piece t (and the window) are in place
        int q, r0, r1;
        piece_rows(t, pps, PR, M, klo, khi, &q, &r0, &r1);
        // row m of the slice at pq + (m - r0) * BNt
        const T* pq = P_s + (nbuf == 2 ? (i & 1) : 0) * bufsz;
        // block ty + r * kRowThreads reads column m of slice q at
        // wp[r * kRowThreads * rs + m - mo]
        const T* wp = wpiece ? pq + PR * BNt + ty * SP : win_s + (ty + q) * S;
        const int rs = wpiece ? SP : S;
        const int mo = wpiece ? r0 : 0;
        if constexpr (kBlocked) {
            // blocks of 32 terms at m = 0, 32, ... of the slice, cut to the
            // hull
            for (int m0 = r0 & ~(kKB - 1); m0 < r1; m0 += kKB) {
                const int m1 = min(m0 + kKB, r1);
                Acc part[kTM][kTN] = {};
                Acc part2[kInterp ? kTM : 1][kTN] = {};
#pragma unroll 4
                for (int m = max(m0, r0); m < m1; ++m) {
                    T a[kTM];
#pragma unroll
                    for (int r = 0; r < kTM; ++r)
                        a[r] = wp[r * kRowThreads * rs + m - mo];
                    T bv[kTN];
                    lds(pq + (m - r0) * BNt, tx, bv);
#pragma unroll
                    for (int r = 0; r < kTM; ++r)
#pragma unroll
                        for (int j = 0; j < kTN; ++j)
                            part[r][j] += a[r] * bv[j];
                    if constexpr (kInterp) {
                        T bv2[kTN];
                        lds(pq + (m - r0) * BNt + kBN, tx, bv2);
#pragma unroll
                        for (int r = 0; r < kTM; ++r)
#pragma unroll
                            for (int j = 0; j < kTN; ++j)
                                part2[r][j] += a[r] * bv2[j];
                    }
                }
#pragma unroll
                for (int r = 0; r < kTM; ++r)
#pragma unroll
                    for (int j = 0; j < kTN; ++j) {
                        acc[r][j] += part[r][j];
                        if constexpr (kInterp) acc2[r][j] += part2[r][j];
                    }
            }
        } else {
            // one DFMA chain per output; a product of two floats is exact
            // in double
#pragma unroll 4
            for (int m = r0; m < r1; ++m) {
                Acc a[kTM];
#pragma unroll
                for (int r = 0; r < kTM; ++r)
                    a[r] = static_cast<Acc>(wp[r * kRowThreads * rs + m - mo]);
                T bv[kTN];
                lds(pq + (m - r0) * BNt, tx, bv);
#pragma unroll
                for (int r = 0; r < kTM; ++r)
#pragma unroll
                    for (int j = 0; j < kTN; ++j)
                        acc[r][j] = fma(a[r], static_cast<Acc>(bv[j]),
                                        acc[r][j]);
                if constexpr (kInterp) {
                    T bv2[kTN];
                    lds(pq + (m - r0) * BNt + kBN, tx, bv2);
#pragma unroll
                    for (int r = 0; r < kTM; ++r)
#pragma unroll
                        for (int j = 0; j < kTN; ++j)
                            acc2[r][j] = fma(a[r], static_cast<Acc>(bv2[j]),
                                             acc2[r][j]);
                }
            }
        }
        __syncthreads();        // the buffer piece t used may be refilled
        if (nbuf == 1 && tn < npieces) stage(tn, 0);
        t = tn;
    }
    cp_async_wait<0>();         // an empty hull never waited for the window

    T* outc = out + static_cast<long long>(blockIdx.z) * nb * L;
#pragma unroll
    for (int r = 0; r < kTM; ++r) {
        const long long i = i0 + ty + r * kRowThreads;
        if (i >= nb) continue;
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
            const int l = n0 + colof<T>(tx, j);
            if (l >= L) continue;
            T v;
            if constexpr (std::is_same<T, Acc>::value) {
                v = acc[r][j];
                if constexpr (kInterp) {
                    const T f = fracv[l];
                    v = v * (T(1) - f) + acc2[r][j] * f;
                }
            } else {
                // precise: each dot rounded once; interpolated, the two
                // rounded dots lerped in float32 as JAX's graph computes it
                // once XLA has contracted it, fma(d1, 1 - f, d2 * f)
                // (measured bitwise on XLA:CPU, where two products then a
                // sum differ from it by an ulp in one output of ten), the
                // form the plain version emulates in float64
                v = __double2float_rn(acc[r][j]);
                if constexpr (kInterp) {
                    const float f = fracv[l];
                    v = __fmaf_rn(v, __fsub_rn(1.f, f),
                                  __fmul_rn(__double2float_rn(acc2[r][j]), f));
                }
            }
            const long long o = i * L + l;
            outc[o] = o < K ? v : T(0);
        }
    }
}

template <typename T, typename Acc, bool kInterp, int kTM>
cudaError_t launch_tile(const T* buf, long long ch, long long W,
                        long long start, long long K, const T* P, int L2,
                        const T* fracv, int M, int L, int qn, int PR,
                        int nbuf, int wpiece, long long nb, T* out,
                        size_t smem, cudaStream_t stream) {
    constexpr int kBM = kRowThreads * kTM;
    const long long row_tiles = (nb + kBM - 1) / kBM;
    if (row_tiles > 65535 || ch > 65535) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(
        fixed_step_kernel<T, Acc, kInterp, kTM>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid((L + kBN - 1) / kBN, static_cast<unsigned>(row_tiles),
                    static_cast<unsigned>(ch));
    fixed_step_kernel<T, Acc, kInterp, kTM><<<grid, kThreads, smem, stream>>>(
        buf, W, start, K, P, L2, fracv, M, L, qn, PR, nbuf, wpiece, nb, out);
    return cudaGetLastError();
}

// =================================================== the resident design
// Element kk of a float4, kk a constant once unrolled.
__device__ __forceinline__ float elem(const float4& v, int kk) {
    return kk == 0 ? v.x : kk == 1 ? v.y : kk == 2 ? v.z : v.w;
}

// One group of 4 terms of a thread's tile: its blocks' window float4s and
// the 4 rows of its 4 phases of P (and of the second bank).
template <bool kInterp>
struct Terms {
    static constexpr int kTM = res_tm(kInterp);
    float4 a[kTM];
    float4 p[4];
    float4 p2[kInterp ? 4 : 1];
};

// Named barrier ``id`` over ``count`` threads (0 is __syncthreads').
__device__ __forceinline__ void bar_sync(int id, int count) {
    asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int count) {
    asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// See the header ("Design: resident").  Warp group g (barrier 1 + g)
// takes tiles t0 + g, t0 + g + kResGroups, ... of the CTA's run; its
// thread (tx, ty) computes blocks ty + r * (BM / kTM), r < kTM, at phases
// n0 + 4 tx + j, j < 4, of each.  ``tiles`` row tiles a channel,
// ``per_group`` CTAs a column group (resident_grid).
template <bool kInterp>
__global__ void __launch_bounds__(kResThreads, 1)
fixed_step_kernel_resident(const float* __restrict__ buf, long long W,
                           long long start, long long K,
                           const float* __restrict__ P, int L2,
                           const float* __restrict__ fracv, int M, int L,
                           int qn, long long nb, long long tiles,
                           long long units, long long per_group,
                           float* __restrict__ out) {
    constexpr int kTM = res_tm(kInterp);
    constexpr int BM = res_bm(kInterp);
    constexpr int kGroupWarps = kResGroupThreads / 32;
    constexpr int BNt = kInterp ? 2 * kBN : kBN;
    constexpr int RS = BM / kTM;            // a thread's blocks RS apart
    static_assert(kResGroups == 2, "the groups' handshake pairs two");
    extern __shared__ float4 smem4[];
    const int Mp = res_mp(M);
    const int S = res_stride(M);
    const int rows = BM + qn - 1;
    const long long stage = res_stage_elems(M, qn, kInterp);
    float* P_s = reinterpret_cast<float*>(smem4);   // row (q, m) at (q*Mp + m)*BNt
    float* ring = P_s + static_cast<long long>(qn) * Mp * BNt;
    int* red = reinterpret_cast<int*>(ring + kResGroups * stage);

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int grp = tid / kResGroupThreads;
    const int gwarp = warp % kGroupWarps;
    const int tx = tid % kColThreads;
    const int ty = tid % kResGroupThreads / kColThreads;
    const int G = (L + kBN - 1) / kBN;
    int first;
    long long t0, t1;
    resident_range(blockIdx.x, per_group, units, &first, &t0, &t1);
    const int gstride = static_cast<int>(gridDim.x / per_group);
    float* win = ring + grp * stage;        // the group's window buffer

    // the window buffers' columns [M, S) stay zero: the last 4-term group
    // of a slice reads them against P's zero pad rows
    const int pad = S - M;
    for (int e = tid; e < kResGroups * rows * pad; e += kResThreads)
        ring[(e / pad) * S + M + e % pad] = 0.f;

    // tile u's window, rows r < rows of M samples from buf[c, start + (i0
    // + r)*M] (zero past W) at r*S of the group's buffer, a warp a row
    auto stage_window = [&](long long u) {
        const long long c = u / tiles;
        const long long g0 = start + (u - c * tiles) * BM * M;
        const float* src = buf + c * W + g0;
        if (g0 + static_cast<long long>(rows) * M <= W) {
            for (int r = gwarp; r < rows; r += kGroupWarps) {
                const float* s = src + static_cast<long long>(r) * M;
                float* d = win + r * S;
                for (int m = lane; m < M; m += 32) cp_async(d + m, s + m);
            }
        } else {
            for (int r = gwarp; r < rows; r += kGroupWarps)
                for (int m = lane; m < M; m += 32) {
                    const long long o = static_cast<long long>(r) * M + m;
                    if (g0 + o < W) cp_async(win + r * S + m, src + o);
                    else win[r * S + m] = 0.f;
                }
        }
        cp_async_commit();
        cp_async_wait<0>();
    };

    for (int cg = first; cg < G; cg += gstride) {
        const int n0 = cg * kBN;
        // the group's columns of every row of P (zero past L and on the
        // pad rows)
        for (int q = 0; q < qn; ++q)
            for (int e = tid; e < Mp * BNt; e += kResThreads) {
                const int m = e / BNt, jc = e % BNt;
                const int col = n0 + jc % kBN;
                float* d = P_s + (q * Mp + m) * BNt + jc;
                if (m < M && col < L)
                    cp_async(d, P + static_cast<long long>(q * M + m) * L2 +
                                    (jc >= kBN ? L : 0) + col);
                else
                    *d = 0.f;
            }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();

        // the hull [slo, shi) in rows of P_s: the first and last row in
        // which any of the group's columns is nonzero
        int lo = INT_MAX, hi = -1;
        for (int e = tid; e < qn * Mp * BNt; e += kResThreads)
            if (P_s[e] != 0.f) {
                lo = min(lo, e / BNt);
                hi = max(hi, e / BNt);
            }
        lo = __reduce_min_sync(0xffffffffu, lo);
        hi = __reduce_max_sync(0xffffffffu, hi);
        if (lane == 0) {
            red[warp] = lo;
            red[kResThreads / 32 + warp] = hi;
        }
        __syncthreads();
#pragma unroll
        for (int w = 0; w < kResThreads / 32; ++w) {
            lo = min(lo, red[w]);
            hi = max(hi, red[kResThreads / 32 + w]);
        }
        const int slo = lo, shi = hi + 1;       // empty when shi <= slo

        float f[kTN];
#pragma unroll
        for (int j = 0; j < kTN; ++j) {
            const int l = n0 + tx * kTN + j;
            f[j] = kInterp && l < L ? fracv[l] : 0.f;
        }

        // the groups out of step by one window copy, so that each one's
        // copies fall in the other's FMAs
        if (grp > 0) bar_sync(kResGroups + 1, kResThreads);
        for (long long u = t0 + grp; u < t1; u += kResGroups) {
            stage_window(u);
            if (grp == 0 && u == t0)
                bar_arrive(kResGroups + 1, kResThreads);
            bar_sync(1 + grp, kResGroupThreads);    // tile u's window in place

            float acc[kTM][kTN] = {};
            float acc2[kInterp ? kTM : 1][kTN] = {};
            for (int q = 0; q < qn; ++q) {
                // the slice's hull rows, out to 4-row groups
                const int r0 = max(slo - q * Mp, 0);
                const int r1 = min(shi - q * Mp, M);
                if (r0 >= r1) continue;
                const int m_lo = r0 & ~3, m_hi = (r1 + 3) & ~3;
                const float* wr[kTM];
#pragma unroll
                for (int r = 0; r < kTM; ++r)
                    wr[r] = win + (ty + q + r * RS) * S;
                const float* pq = P_s + q * Mp * BNt + tx * kTN;
                auto load = [&](Terms<kInterp>& t, int m) {
#pragma unroll
                    for (int r = 0; r < kTM; ++r)
                        t.a[r] = *reinterpret_cast<const float4*>(wr[r] + m);
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk) {
                        t.p[kk] = *reinterpret_cast<const float4*>(
                            pq + (m + kk) * BNt);
                        if constexpr (kInterp)
                            t.p2[kk] = *reinterpret_cast<const float4*>(
                                pq + (m + kk) * BNt + kBN);
                    }
                };
                float part[kTM][kTN] = {};
                float part2[kInterp ? kTM : 1][kTN] = {};
                // the FMAs of the group at m, then, at the end of its
                // 32-term block or of the slice, the partial sums into
                // the totals; returns whether a group follows
                auto fmas = [&](const Terms<kInterp>& t, int m) {
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                        for (int r = 0; r < kTM; ++r) {
                            const float av = elem(t.a[r], kk);
#pragma unroll
                            for (int j = 0; j < kTN; ++j) {
                                part[r][j] = __fmaf_rn(av, elem(t.p[kk], j),
                                                       part[r][j]);
                                if constexpr (kInterp)
                                    part2[r][j] = __fmaf_rn(
                                        av, elem(t.p2[kk], j), part2[r][j]);
                            }
                        }
                    const bool more = m + 4 < m_hi;
                    if (!more || ((m + 4) & (kKB - 1)) == 0) {
#pragma unroll
                        for (int r = 0; r < kTM; ++r)
#pragma unroll
                            for (int j = 0; j < kTN; ++j) {
                                acc[r][j] += part[r][j];
                                part[r][j] = 0.f;
                                if constexpr (kInterp) {
                                    acc2[r][j] += part2[r][j];
                                    part2[r][j] = 0.f;
                                }
                            }
                    }
                    return more;
                };
                // two register sets in turn: the next group's loads go
                // out before this group's FMAs, unconditionally (past the
                // slice's last group they reload it), so that nothing
                // holds them back behind the FMAs
                Terms<kInterp> ta, tb;
                load(ta, m_lo);
                for (int m = m_lo;; m += 8) {
                    load(tb, min(m + 4, m_hi - 4));
                    if (!fmas(ta, m)) break;
                    load(ta, min(m + 8, m_hi - 4));
                    if (!fmas(tb, m + 4)) break;
                }
            }

            const long long c = u / tiles;
            const long long i0 = (u - c * tiles) * BM;
            float* outc = out + c * nb * L;
#pragma unroll
            for (int r = 0; r < kTM; ++r) {
                const long long blk = i0 + ty + r * RS;
                if (blk >= nb) continue;
                float v[kTN];
#pragma unroll
                for (int j = 0; j < kTN; ++j) {
                    float x = acc[r][j];
                    if constexpr (kInterp)
                        x = x * (1.f - f[j]) + acc2[r][j] * f[j];
                    v[j] = blk * L + n0 + tx * kTN + j < K ? x : 0.f;
                }
                const int l0 = n0 + tx * kTN;
                float* o = outc + blk * L + l0;
                if (L % kTN == 0) {
                    if (l0 < L)
                        *reinterpret_cast<float4*>(o) =
                            make_float4(v[0], v[1], v[2], v[3]);
                } else {
#pragma unroll
                    for (int j = 0; j < kTN; ++j)
                        if (l0 + j < L) o[j] = v[j];
                }
            }
            bar_sync(1 + grp, kResGroupThreads);    // the buffer is free
        }
        __syncthreads();        // P_s and red may be refilled
    }
}

// =================================================== the hull design
// One group of 4 terms of a thread's hull tile.
struct HullTerms {
    float4 a[kHullTM];
    float4 p[4];
};

// The rows [*lo, *hi) of hull h (int pair [klo, khi), empty when khi <=
// klo) rounded out to 4-row groups; (0, 0) for an empty one.
__device__ __forceinline__ void hull_rows4(const int* h, int* lo, int* hi) {
    const bool any = h[1] > h[0];
    *lo = any ? h[0] & ~3 : 0;
    *hi = any ? (h[1] + 3) & ~3 : 0;
}

// See the header ("Design: hull").  As the resident design, with P's hull
// rows [k0, k1) of column group cg (the union of its two halves' hulls,
// hulls[2 cg] and hulls[2 cg + 1], rounded out to 4-row groups) at (k -
// k0) * kBN of P_s, and tile u's blocks b = u * kHullBM + r (r < kHullBM,
// b < blocks, block i of channel c at b = c * nb + i) each staging only
// buf[c, start + i*M + k], k0 <= k < k1, as row r of the group's buffer
// at stride S: with kWide (every row's source 16-byte aligned) in 16-byte
// cp.async, else 4-byte.  Warps 0-1 of a warp group compute the column
// group's first 16 phases, warps 2-3 the other 16, each over its half's
// hull rows only; thread (tx, ty) computes blocks ty + r * (BM / kTM), r <
// kTM, at phases n0 + 4 tx + j, j < 4.  ``units`` tiles, ``per_group``
// CTAs a column group (resident_grid).
template <bool kWide>
__global__ void __launch_bounds__(kResThreads, 1)
fixed_step_kernel_hull(const float* __restrict__ buf, long long W,
                       long long start, long long K,
                       const float* __restrict__ P, int M, int L, int qn,
                       long long nb, const int* __restrict__ hulls,
                       int rows, long long blocks, long long units,
                       long long per_group, float* __restrict__ out) {
    constexpr int kTM = kHullTM;
    constexpr int BM = kHullBM;
    constexpr int kGroupWarps = kResGroupThreads / 32;
    constexpr int RS = BM / kTM;            // a thread's blocks RS apart
    static_assert(kResGroups == 2, "the groups' handshake pairs two");
    static_assert(kGroupWarps == 4 && RS == 16,
                  "two warps of 8 block rows x 4 phase columns a half");
    extern __shared__ float4 smem4[];
    const int S = hull_stride(rows);
    float* P_s = reinterpret_cast<float*>(smem4);   // row k at (k - k0)*kBN
    float* ring = P_s + rows * kBN;

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int grp = tid / kResGroupThreads;
    const int gwarp = tid / 32 % kGroupWarps;
    const int half = gwarp / 2;             // the warp's 16 phases
    const int tx = half * 4 + lane % 4;
    const int ty = gwarp % 2 * 8 + lane / 4;
    const int G = (L + kBN - 1) / kBN;
    int first;
    long long t0, t1;
    resident_range(blockIdx.x, per_group, units, &first, &t0, &t1);
    const int gstride = static_cast<int>(gridDim.x / per_group);
    float* win = ring + grp * BM * S;       // the group's window buffer

    for (int cg = first; cg < G; cg += gstride) {
        const int n0 = cg * kBN;
        int lo0, hi0, lo1, hi1;
        hull_rows4(hulls + 4 * cg, &lo0, &hi0);
        hull_rows4(hulls + 4 * cg + 2, &lo1, &hi1);
        // the group's hull, both halves' (an empty half adds nothing), and
        // the warp's half's
        const int k0 = hi0 > lo0 ? (hi1 > lo1 ? min(lo0, lo1) : lo0) : lo1;
        const int k1 = max(hi0, hi1);
        const int w = max(k1 - k0, 0);
        const int wk0 = half ? lo1 : lo0, wk1 = half ? hi1 : hi0;
        // the group's columns of P's hull rows (zero past L)
        for (int e = tid; e < w * kBN; e += kResThreads) {
            const int col = n0 + e % kBN;
            if (col < L)
                cp_async(P_s + e, P + static_cast<long long>(k0 + e / kBN) *
                                          L + col);
            else
                P_s[e] = 0.f;
        }
        cp_async_commit();
        cp_async_wait<0>();
        __syncthreads();

        // tile u's hull spans, a warp a block: row r holds the w samples
        // from buf[c, start + i*M + k0] (zero past W)
        auto stage_window = [&](long long u) {
            long long b = u * BM + gwarp;
            long long c = b / nb;
            long long i = b - c * nb;
            for (int r = gwarp; r < BM && b < blocks; r += kGroupWarps) {
                const long long g0 = start + i * M + k0;
                const float* src = buf + c * W + g0;
                float* d = win + r * S;
                if (g0 + w > W) {
                    for (int m = lane; m < w; m += 32) {
                        if (g0 + m < W) cp_async(d + m, src + m);
                        else d[m] = 0.f;
                    }
                } else if constexpr (kWide) {
                    for (int m = 4 * lane; m < w; m += 128)
                        cp_async(reinterpret_cast<float4*>(d + m),
                                 reinterpret_cast<const float4*>(src + m));
                } else {
                    for (int m = lane; m < w; m += 32)
                        cp_async(d + m, src + m);
                }
                b += kGroupWarps;
                for (i += kGroupWarps; i >= nb; i -= nb) ++c;
            }
            cp_async_commit();
            cp_async_wait<0>();
        };

        // the groups out of step by one window copy, as in the resident
        // design
        if (grp > 0) bar_sync(kResGroups + 1, kResThreads);
        for (long long u = t0 + grp; u < t1; u += kResGroups) {
            stage_window(u);
            if (grp == 0 && u == t0)
                bar_arrive(kResGroups + 1, kResThreads);
            bar_sync(1 + grp, kResGroupThreads);    // tile u's spans in place

            float acc[kTM][kTN] = {};
            for (int q = 0; q < qn; ++q) {
                // the slice's rows of the half's hull, m = k - q*M; 4-row
                // groups, since k0, wk0, wk1 and q*M are multiples of 4
                const int m_lo = max(wk0 - q * M, 0);
                const int m_hi = min(wk1 - q * M, M);
                if (m_lo >= m_hi) continue;
                const int off = q * M - k0;         // m's offset in a row
                const float* wr[kTM];
#pragma unroll
                for (int r = 0; r < kTM; ++r)
                    wr[r] = win + (ty + r * RS) * S + off;
                const float* pq = P_s + off * kBN + tx * kTN;
                auto load = [&](HullTerms& t, int m) {
#pragma unroll
                    for (int r = 0; r < kTM; ++r)
                        t.a[r] = *reinterpret_cast<const float4*>(wr[r] + m);
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk)
                        t.p[kk] = *reinterpret_cast<const float4*>(
                            pq + (m + kk) * kBN);
                };
                float part[kTM][kTN] = {};
                // the FMAs of the group at m, then, at the end of its
                // 32-term block or of the slice, the partial sums into
                // the totals; returns whether a group follows
                auto fmas = [&](const HullTerms& t, int m) {
#pragma unroll
                    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
                        for (int r = 0; r < kTM; ++r) {
                            const float av = elem(t.a[r], kk);
#pragma unroll
                            for (int j = 0; j < kTN; ++j)
                                part[r][j] = __fmaf_rn(av, elem(t.p[kk], j),
                                                       part[r][j]);
                        }
                    const bool more = m + 4 < m_hi;
                    if (!more || ((m + 4) & (kKB - 1)) == 0) {
#pragma unroll
                        for (int r = 0; r < kTM; ++r)
#pragma unroll
                            for (int j = 0; j < kTN; ++j) {
                                acc[r][j] += part[r][j];
                                part[r][j] = 0.f;
                            }
                    }
                    return more;
                };
                // two register sets in turn, as in the resident design
                HullTerms ta, tb;
                load(ta, m_lo);
                for (int m = m_lo;; m += 8) {
                    load(tb, min(m + 4, m_hi - 4));
                    if (!fmas(ta, m)) break;
                    load(ta, min(m + 8, m_hi - 4));
                    if (!fmas(tb, m + 4)) break;
                }
            }

            // block b = c * nb + i's phase l at out[b * L + l]
            long long b = u * BM + ty;
            long long i = b - b / nb * nb;
            const int l0 = n0 + tx * kTN;
#pragma unroll
            for (int r = 0; r < kTM; ++r) {
                if (r > 0) {
                    b += RS;
                    for (i += RS; i >= nb; i -= nb) {}
                }
                if (b >= blocks) continue;
                float* o = out + b * L + l0;
                float v[kTN];
#pragma unroll
                for (int j = 0; j < kTN; ++j)
                    v[j] = i * L + l0 + j < K ? acc[r][j] : 0.f;
                if (L % kTN == 0) {
                    if (l0 < L)
                        *reinterpret_cast<float4*>(o) =
                            make_float4(v[0], v[1], v[2], v[3]);
                } else {
#pragma unroll
                    for (int j = 0; j < kTN; ++j)
                        if (l0 + j < L) o[j] = v[j];
                }
            }
            bar_sync(1 + grp, kResGroupThreads);    // the buffer is free
        }
        __syncthreads();        // P_s may be refilled
    }
}

// =================================================== the persistent float64 design
// The design's tag: its kernel is fixed_step_kernel<double, double,
// Persistent>, an overload of the template's name.
struct Persistent {};

// One pair of terms (m, m + 1) of a thread's tile: its blocks' window
// pairs and P's two rows of its 4 phases (two double2s a row, 16 phases
// apart, as the template reads them).
struct PairTerms {
    double2 a[kP64TM];
    double2 p[2][2];
};

// Phase j of a thread's 4 in row kk of a pair (colof<double>'s order).
__device__ __forceinline__ double pelem(const PairTerms& t, int kk, int j) {
    const double2& v = t.p[kk][j >> 1];
    return j & 1 ? v.y : v.x;
}

// The padded rows [*a, *b) of column group cg's hull (p64_rows on its
// halves' hulls, hulls[2 cg] and hulls[2 cg + 1]).
__device__ __forceinline__ void p64_group_rows(const int* __restrict__ hulls,
                                               int cg, int M, int* a,
                                               int* b) {
    p64_rows(M, __ldg(hulls + 4 * cg), __ldg(hulls + 4 * cg + 1),
             __ldg(hulls + 4 * cg + 2), __ldg(hulls + 4 * cg + 3), a, b);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
    return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// This thread's arrival on mbarrier bar, which then waits for ``bytes``
// of bulk copies besides.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(bar)), "r"(bytes) : "memory");
}

// ``bytes`` (a multiple of 16) from global src to shared dst (both
// 16-byte aligned) by the TMA, completing on mbarrier bar.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src),
        "r"(bytes), "r"(smem_u32(bar)) : "memory");
}

// Wait for the completion of mbarrier bar's phase of parity ``parity``.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
    unsigned ok = 0;
    while (!ok)
        asm volatile(
            "{\n .reg .pred p;\n"
            " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
            " selp.u32 %0, 1, 0, p;\n}\n" : "=r"(ok) : "r"(smem_u32(bar)),
            "r"(parity) : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
    asm volatile(
        "{\n .reg .b64 state;\n"
        " mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(
            smem_u32(bar)) : "memory");
}

// See the header ("Design: persistent float64").  CTA blockIdx.x takes
// units [u0, u1) of the ``units`` = channels x ``tiles`` x column groups,
// unit u being column group u % G of row tile u / G (tile t of channel c
// at c * tiles + t).  Its kP64Threads compute threads stage a tile's
// window when the tile changes and run the DFMAs.  Its producer warp
// streams the pieces of the units' padded hull rows through two buffers
// of ``PR`` rows, piece after piece across units and tiles: column group
// cg's padded rows [a, b) (p64_rows) are rows 0 .. b - a of ``packed``'s
// [cg], R rows of 32 doubles a group.  Buffer i is handed over through
// mbarriers full[i] (the TMA's bytes landed) and empty[i] (every compute
// warp is done with it).  Compute thread (tx, ty) computes blocks ty + r * kP64RowThreads,
// r < kP64TM, at phases n0 + colof<double>(tx, j), j < 4.
template <typename T, typename Acc, typename Design>
__global__ void __launch_bounds__(kP64Threads + 32, 1)
fixed_step_kernel(const double* __restrict__ buf, long long W,
                  long long start, long long K,
                  const double* __restrict__ packed, int R, int M, int L,
                  int qn, long long nb, const int* __restrict__ hulls,
                  int PR, long long tiles, long long units,
                  double* __restrict__ out) {
    static_assert(std::is_same<T, double>::value &&
                      std::is_same<Acc, double>::value &&
                      std::is_same<Design, Persistent>::value,
                  "the persistent design is float64's alone");
    constexpr int kTM = kP64TM;
    constexpr int RS = kP64RowThreads;      // a thread's blocks RS apart
    constexpr int kWarps64 = kP64Threads / 32;
    extern __shared__ float4 smem4[];
    const int Mp = p64_mp(M);
    const int S = p64_stride(M);
    const int rows = kP64BM + qn - 1;
    double* win = reinterpret_cast<double*>(smem4);     // row r at r * S
    double* pieces = win + rows * S;    // two of PR rows x kBN
    auto* full = reinterpret_cast<unsigned long long*>(pieces + 2 * PR * kBN);
    unsigned long long* empty = full + 2;

    const int tid = threadIdx.x;
    const int lane = tid % 32;
    const int warp = tid / 32;
    const int G = (L + kBN - 1) / kBN;
    int first;
    long long u0, u1;
    resident_range(blockIdx.x, gridDim.x, units, &first, &u0, &u1);

    if (tid == kP64Threads) {
        for (int i = 0; i < 2; ++i) {
            asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                             smem_u32(full + i)) : "memory");
            asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                             smem_u32(empty + i)), "n"(kWarps64) : "memory");
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    // the window's columns [M, S) stay zero: a pad column is read against
    // P's zero pad rows
    for (int e = tid; e < rows * (S - M); e += kP64Threads + 32)
        win[e / (S - M) * S + M + e % (S - M)] = 0.0;
    __syncthreads();

    // unit u's padded rows [a, b): its pieces start at a, a + PR, ...
    auto rows_of = [&](long long u, int* a, int* b) {
        p64_group_rows(hulls, static_cast<int>(u % G), M, a, b);
    };

    if (warp == kWarps64) {
        // the producer: one lane issues each piece's TMA copy once every
        // compute warp is done with its buffer
        if (lane == 0) {
            int bi = 0;
            // each buffer's empty parity to wait for, flipped: a fresh
            // mbarrier counts the phase before its first as complete
            unsigned ph = 0;
            for (long long u = u0; u < u1; ++u) {
                int a, b;
                rows_of(u, &a, &b);
                const long long g = static_cast<long long>(u % G) * R;
                for (int k0 = a; k0 < b; k0 += PR) {
                    mbar_wait(empty + bi, ((ph >> bi) & 1) ^ 1);
                    ph ^= 1u << bi;
                    const unsigned bytes = static_cast<unsigned>(
                        min(b - k0, PR) * kBN * sizeof(double));
                    mbar_expect(full + bi, bytes);
                    bulk_copy(pieces + bi * PR * kBN,
                              packed + (g + k0 - a) * kBN, bytes, full + bi);
                    bi ^= 1;
                }
            }
        }
        return;
    }

    const int tx = tid % kColThreads;
    const int ty = tid / kColThreads;

    // tile's window: row r holds the M samples from buf[c, start + (i0 +
    // r)*M] (zero past W), a warp a row by element; every compute thread
    // waits for it
    auto stage_window = [&](long long tile) {
        const long long c = tile / tiles;
        const long long g0 = start + (tile - c * tiles) * kP64BM * M;
        const double* src = buf + c * W + g0;
        const bool whole = g0 + static_cast<long long>(rows) * M <= W;
        for (int r = warp; r < rows; r += kWarps64)
            for (int m = lane; m < M; m += 32) {
                const long long o = static_cast<long long>(r) * M + m;
                if (whole || g0 + o < W) cp_async(win + r * S + m, src + o);
                else win[r * S + m] = 0.0;
            }
        cp_async_commit();
        cp_async_wait<0>();
        bar_sync(1, kP64Threads);
    };

    double acc[kTM][kTN] = {};

    // the DFMAs of padded rows [k0, k1) of a piece held at pb: each
    // output's one chain over k ascending, pairs of terms at a time, the
    // next pair's loads issued from the other register set before this
    // pair's DFMAs (past a run's last pair they reload it); a loop step
    // is a 4-row group, so no branch lies between a load and its DFMAs
    auto dfmas = [&](const double* pb, int k0, int k1) {
        for (int k = k0; k < k1;) {
            const int q = k / Mp;
            const int m0 = k - q * Mp;
            const int m1 = min(Mp, m0 + (k1 - k));
            const double* wr = win + (ty + q) * S;
            const double* pp = pb + (k - k0) * kBN + tx * 2;  // row m0
            auto load = [&](PairTerms& t, int m) {
#pragma unroll
                for (int r = 0; r < kTM; ++r)
                    t.a[r] = *reinterpret_cast<const double2*>(
                        wr + r * RS * S + m);
#pragma unroll
                for (int kk = 0; kk < 2; ++kk)
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        t.p[kk][h] = *reinterpret_cast<const double2*>(
                            pp + (m - m0 + kk) * kBN + h * 2 * kColThreads);
            };
            auto fma2 = [&](const PairTerms& t) {
#pragma unroll
                for (int kk = 0; kk < 2; ++kk)
#pragma unroll
                    for (int r = 0; r < kTM; ++r) {
                        const double av = kk ? t.a[r].y : t.a[r].x;
#pragma unroll
                        for (int j = 0; j < kTN; ++j)
                            acc[r][j] = fma(av, pelem(t, kk, j), acc[r][j]);
                    }
            };
            PairTerms ta, tb;
            load(ta, m0);
            for (int m = m0; m < m1; m += 4) {
                load(tb, m + 2);
                fma2(ta);
                load(ta, min(m + 4, m1 - 2));
                fma2(tb);
            }
            k += m1 - m0;
        }
    };

    int bi = 0;
    unsigned ph = 0;            // each buffer's full parity to wait
    long long staged_tile = -1;
    for (long long u = u0; u < u1; ++u) {
        const long long tile = u / G;
        const int cg = static_cast<int>(u % G);
        if (tile != staged_tile) {
            // every compute warp is past its last read of the window
            bar_sync(1, kP64Threads);
            stage_window(tile);
            staged_tile = tile;
        }
        int a, b;
        rows_of(u, &a, &b);
        for (int k0 = a; k0 < b; k0 += PR) {
            mbar_wait(full + bi, (ph >> bi) & 1);   // the piece in place
            ph ^= 1u << bi;
            dfmas(pieces + bi * PR * kBN, k0, min(b, k0 + PR));
            __syncwarp();
            if (lane == 0) mbar_arrive(empty + bi);  // the buffer is free
            bi ^= 1;
        }

        const long long c = tile / tiles;
        const long long i0 = (tile - c * tiles) * kP64BM;
        double* outc = out + c * nb * L;
#pragma unroll
        for (int r = 0; r < kTM; ++r) {
            const long long i = i0 + ty + r * RS;
#pragma unroll
            for (int j = 0; j < kTN; ++j) {
                const int l = cg * kBN + colof<double>(tx, j);
                if (i < nb && l < L) {
                    const long long o = i * L + l;
                    outc[o] = o < K ? acc[r][j] : 0.0;
                }
                acc[r][j] = 0.0;
            }
        }
    }
}

// The SMs of the current device, cached per device.
int sm_count() {
    static int cached[64] = {0};
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
    if (!cached[dev])
        cudaDeviceGetAttribute(&cached[dev], cudaDevAttrMultiProcessorCount,
                               dev);
    return cached[dev];
}

// CTAs an SM of one kernel, a function of the device and the shared
// memory, kept for the last pair a thread asked about (one a kernel).
struct Occupancy {
    int dev = -1, per_sm = 0;
    size_t smem = 0;
};

// The CTAs of ``kernel`` at ``threads`` threads and ``smem`` shared bytes
// the card holds at once, into *slots; its maximum dynamic shared memory
// set to smem first.
template <typename F>
cudaError_t resident_slots(F* kernel, int threads, size_t smem,
                           Occupancy& cache, long long* slots) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int now = 0;
    err = cudaGetDevice(&now);
    if (err != cudaSuccess) return err;
    if (now != cache.dev || smem != cache.smem) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &cache.per_sm, kernel, threads, smem);
        if (err != cudaSuccess) return err;
        cache.dev = now;
        cache.smem = smem;
    }
    const int sms = sm_count();
    if (cache.per_sm < 1 || sms < 1) return cudaErrorInvalidValue;
    *slots = static_cast<long long>(sms) * cache.per_sm;
    return cudaSuccess;
}

template <bool kInterp>
cudaError_t launch_resident(const float* buf, long long ch, long long W,
                            long long start, long long K, const float* P,
                            int L2, const float* fracv, int M, int L, int qn,
                            long long nb, float* out, size_t smem,
                            cudaStream_t stream) {
    thread_local Occupancy cache;
    long long slots = 0;
    const cudaError_t err = resident_slots(
        fixed_step_kernel_resident<kInterp>, kResThreads, smem, cache,
        &slots);
    if (err != cudaSuccess) return err;
    constexpr int BM = res_bm(kInterp);
    const long long tiles = (nb + BM - 1) / BM;
    const ResidentGrid g = resident_grid((L + kBN - 1) / kBN, ch * tiles,
                                         slots);
    fixed_step_kernel_resident<kInterp>
        <<<static_cast<unsigned>(g.ctas), kResThreads, smem, stream>>>(
        buf, W, start, K, P, L2, fracv, M, L, qn, nb, tiles, ch * tiles,
        g.per_group, out);
    return cudaGetLastError();
}

// Whether the hull design's rows may come in 16-byte copies: buf 16-byte
// aligned, and every channel's window start too (M and the hull's rows
// are multiples of 4).
bool hull_wide(const float* buf, long long W, long long start) {
    return reinterpret_cast<size_t>(buf) % 16 == 0 && W % 4 == 0 &&
           start % 4 == 0;
}

template <bool kWide>
cudaError_t launch_hull(const float* buf, long long ch, long long W,
                        long long start, long long K, const float* P, int M,
                        int L, int qn, long long nb, const int* hulls,
                        int rows, float* out, size_t smem,
                        cudaStream_t stream) {
    thread_local Occupancy cache;
    long long slots = 0;
    const cudaError_t err = resident_slots(fixed_step_kernel_hull<kWide>,
                                           kResThreads, smem, cache, &slots);
    if (err != cudaSuccess) return err;
    const long long blocks = ch * nb;
    const long long tiles = (blocks + kHullBM - 1) / kHullBM;
    const ResidentGrid g = resident_grid((L + kBN - 1) / kBN, tiles, slots);
    fixed_step_kernel_hull<kWide>
        <<<static_cast<unsigned>(g.ctas), kResThreads, smem, stream>>>(
            buf, W, start, K, P, M, L, qn, nb, hulls, rows, blocks, tiles,
            g.per_group, out);
    return cudaGetLastError();
}

// One launch of the persistent float64 design: a CTA a slot of the card,
// never more than the units, each a contiguous run of them (the resident
// grid of one group over every unit).
cudaError_t launch_persistent64(const double* buf, long long ch,
                                long long W, long long start, long long K,
                                const double* packed, int R, int M, int L,
                                int qn, long long nb, const int* hulls,
                                int pr, double* out, size_t smem,
                                cudaStream_t stream) {
    void (*kernel)(const double*, long long, long long, long long,
                   const double*, int, int, int, int, long long, const int*,
                   int, long long, long long, double*) =
        fixed_step_kernel<double, double, Persistent>;
    thread_local Occupancy cache;
    long long slots = 0;
    const cudaError_t err =
        resident_slots(kernel, kP64Threads + 32, smem, cache, &slots);
    if (err != cudaSuccess) return err;
    const long long tiles = (nb + kP64BM - 1) / kP64BM;
    const long long units = ch * tiles * ((L + kBN - 1) / kBN);
    const ResidentGrid g = resident_grid(1, units, slots);
    kernel<<<static_cast<unsigned>(g.ctas), kP64Threads + 32, smem, stream>>>(
        buf, W, start, K, packed, R, M, L, qn, nb, hulls, pr, tiles, units,
        out);
    return cudaGetLastError();
}

// =================================================== the four designs
// One launch of the design and tile fixed_step_launch picks for the hull
// of ``hull_rows`` rows (0, or hulls null, or for float64 packed null: not
// known); *design says which design ran.
template <typename T, typename Acc, bool kInterp>
cudaError_t launch(const T* buf, long long ch, long long W, long long start,
                   long long K, const T* P, int L2, const T* fracv, int M,
                   int L, int qn, long long nb, T* out, int kind,
                   const int* hulls, int hull_rows, const double* packed,
                   int packed_rows, int* design, cudaStream_t stream) {
    Launch lc;
    const bool known = hulls && (kind != kF64 || packed);
    if (!fixed_step_launch(M, qn, kInterp, kind, known ? hull_rows : 0, &lc))
        return cudaErrorInvalidValue;
    *design = lc.design;
    if constexpr (std::is_same<T, float>::value &&
                  std::is_same<Acc, float>::value) {
        if (lc.design == kResident)
            return launch_resident<kInterp>(buf, ch, W, start, K, P, L2,
                                            fracv, M, L, qn, nb, out, lc.smem,
                                            stream);
        if constexpr (!kInterp) {
            if (lc.design == kHull && hull_wide(buf, W, start))
                return launch_hull<true>(buf, ch, W, start, K, P, M, L, qn,
                                         nb, hulls, hull_rows, out, lc.smem,
                                         stream);
            if (lc.design == kHull)
                return launch_hull<false>(buf, ch, W, start, K, P, M, L, qn,
                                          nb, hulls, hull_rows, out, lc.smem,
                                          stream);
        }
    }
    if constexpr (std::is_same<T, double>::value &&
                  std::is_same<Acc, double>::value && !kInterp) {
        if (lc.design == kPersistent64)
            return launch_persistent64(buf, ch, W, start, K, packed,
                                       packed_rows, M, L, qn, nb, hulls,
                                       lc.pr, out, lc.smem, stream);
    }
    int tm = 0, pr = 0, nbuf = 0, wpiece = 0;
    size_t smem = 0;
    if (!pick_tile(M, qn, kInterp ? 2 * kBN : kBN, sizeof(T), &tm, &pr,
                   &nbuf, &wpiece, &smem))
        return cudaErrorInvalidValue;
    if (tm == kTM0)
        return launch_tile<T, Acc, kInterp, kTM0>(
            buf, ch, W, start, K, P, L2, fracv, M, L, qn, pr, nbuf, wpiece,
            nb, out, smem, stream);
    if (tm == kTM1)
        return launch_tile<T, Acc, kInterp, kTM1>(
            buf, ch, W, start, K, P, L2, fracv, M, L, qn, pr, nbuf, wpiece,
            nb, out, smem, stream);
    return launch_tile<T, Acc, kInterp, kTM2>(
        buf, ch, W, start, K, P, L2, fracv, M, L, qn, pr, nbuf, wpiece, nb,
        out, smem, stream);
}

template <typename T, typename Acc>
cudaError_t launch_any(const void* buf, long long ch, long long W,
                       long long start, long long K, const void* P, int L2,
                       const void* fracv, int M, int L, int qn, long long nb,
                       void* out, int kind, const int* hulls, int hull_rows,
                       const double* packed, int packed_rows, int* design,
                       cudaStream_t s) {
    const T* b = static_cast<const T*>(buf);
    const T* p = static_cast<const T*>(P);
    const T* f = static_cast<const T*>(fracv);
    T* o = static_cast<T*>(out);
    if (fracv)
        return launch<T, Acc, true>(b, ch, W, start, K, p, L2, f, M, L, qn,
                                    nb, o, kind, hulls, hull_rows, packed,
                                    packed_rows, design, s);
    return launch<T, Acc, false>(b, ch, W, start, K, p, L2, f, M, L, qn, nb,
                                 o, kind, hulls, hull_rows, packed,
                                 packed_rows, design, s);
}

}  // namespace

// buf [ch, W] and P [KQ, L2] contiguous on the device, fracv [L] or null,
// out [ch, nb*L]: float32 for kind kF32 and kF32Acc64 (accumulated in
// double), float64 for kF64.  hulls, null or int32 [2 ceil(L / 32), 2] on
// the device: for each 16-phase half of each 32-phase column group, the
// rows [klo, khi) of P outside which every one of its columns is zero
// (klo = khi = 0 for none); hull_rows the widest column group's hull (its
// halves' union) rounded out to 4-row groups, (khi + 3 & ~3) - (klo & ~3).
// packed, null or float64 [G, packed_rows, 32] on the device (16-byte
// aligned; float64 data only, where hulls are given): for each column
// group g, its padded rows [a, b) (p64_rows of its halves' hulls) of P's
// 32 columns, row j the padded row a + j (zero for pad rows and columns
// past L), packed_rows >= every b - a.
// Sets *design to the design the launch took: 0 the template, 1 the
// resident design, 2 the hull design, 3 the persistent float64 design.
// Returns the launch's cudaError_t (0 on success); arguments the kernel
// does not take return cudaErrorInvalidValue.
extern "C" int art_fixed_step(const void* buf, long long ch, long long W,
                              long long start, long long K, const void* P,
                              int KQ, int L2, const void* fracv, int M,
                              int L, int qn, long long nb, void* out,
                              int kind, const void* hulls, int hull_rows,
                              const void* packed, int packed_rows,
                              int* design, void* stream) {
    if (M <= 0 || L <= 0 || qn <= 0 || nb <= 0 || ch <= 0 || start < 0 ||
        K < 0 || K > nb * L || KQ != qn * M ||
        L2 != (fracv ? 2 * L : L) || hull_rows < 0 || packed_rows < 0 ||
        reinterpret_cast<size_t>(packed) % 16 || !design)
        return cudaErrorInvalidValue;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int* h = static_cast<const int*>(hulls);
    const double* pk = static_cast<const double*>(packed);
    switch (kind) {
        case kF32:
            return launch_any<float, float>(buf, ch, W, start, K, P, L2,
                                            fracv, M, L, qn, nb, out, kind,
                                            h, hull_rows, pk, packed_rows,
                                            design, s);
        case kF32Acc64:
            return launch_any<float, double>(buf, ch, W, start, K, P, L2,
                                             fracv, M, L, qn, nb, out, kind,
                                             h, hull_rows, pk, packed_rows,
                                             design, s);
        case kF64:
            return launch_any<double, double>(buf, ch, W, start, K, P, L2,
                                              fracv, M, L, qn, nb, out, kind,
                                              h, hull_rows, pk, packed_rows,
                                              design, s);
        default:
            return cudaErrorInvalidValue;
    }
}
