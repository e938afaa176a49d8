// The grid route of the PDHG solve (its templates; pdhg_grid.cu holds the
// entry points and the forms whose replicas live in shared memory,
// pdhg_grid_far.cu and pdhg_grid_far_cert.cu the far forms): the block, its
// checked form and the
// power iteration for ||K|| of one instance, or of every instance of a batch
// one after another in one launch (the walk, below), over a cooperative grid
// of one CTA an SM, for the shapes K2's cluster (pdhg_block.cu) does not hold
// in its shared memory.  Float32:
//
//   the block  `iters` iterations of lp/pdhg.py::_one_iter, every iterate
//       added to the ergodic sums, with tau, sigma and the stop flag of the
//       solve's control record (pdhg_common.cuh).  Twin: pdhg_block_plain.
//   the checked block  the same launch with the checked block's control as
//       its epilogue (what pdhg_check.cuh does after K2, on the slices each
//       CTA owns).  Twin: pdhg_block_steps_plain then pdhg_check_plain.
//   the norm  ||K|| after `iters` power iterations in one launch, as K6
//       (pdhg_norm.cu) computes it.  Twin: estimate_norm_plain.
//
// Two forms (kCuts): a pool of cuts of width k = 2..5 with its cut index
// (relax/cutbuffer.py build_cut_index), at the column widths 128, 256, 512,
// 1024 and 2048 (cols_for); and the certifier's pool without cuts, the dense route
// (lp/pdhg_dense.py) past n = 256 and past the rows K7 holds.  Any pool and
// any m dense rows (relax/denserows.py for a QCQP, the certifier's
// eigencuts): where the replicas of yD and of the cut weights do not fit a
// CTA's shared memory beside the ring and the owned state, or the pool has
// more than kThreads slots a CTA, the far form (kFar, below) takes the shape.
// The reference runs these shapes in XLA: its Pallas kernel takes n <= 128,
// a pool of at most 1024 slots and no dense row (sdpcutsel_tpu/lp/pdhg.py:
// 291-301), and its while_loop iterates the plain _one_iter elsewhere.
//
// Where it stands beside the others: K2 keeps R n-row bands of ten arrays and
// every dense row's band in each of 16 CTAs' shared memory, which stops near
// n = 280, or at 25 dense rows at n = 150 and 2 at n = 256 (lp/pdhg_kernel.py
// launch_plan).  Here every SM's CTA b owns near-equal slices, as K7's "grid"
// plan (pdhg_dense.cu) does: entries [e0, e1) of X and [i0, i1) of x, dense
// rows [q0, q1) and pool slots [s0, s1).  The owned entries' state and sums
// live in the CTA's shared memory (up to kMaxE: 4 a thread at 512 columns),
// the owned x entries in registers (lane 0 of warp w: entry i0 + w), the
// owned slots' yC and its sum in registers (thread t: slot s0 + t; the far
// form: in place in the outputs, thread t taking slots s0 + t + kThreads j).
// What other CTAs read goes through global memory between grid barriers.  An
// iteration:
//   I    yD and, with cuts, the weights w = yC act to shared memory; the
//        dense adjoint sum_q yD_q [G_q | g_q] of the owned entries (the
//        rows' owned segments, resident in shared memory or streamed in
//        cp.async stages, strands summed in order); gX of each owned entry
//        of X, ((box rows) + its segment of the cut index, summed in order,
//        segment_sum) + the dense adjoint, S = X - tau (cX - gX) to global
//        memory; gx and the x step of the owned entries of x, xb to global
//        memory;                                            grid barrier 1
//   II   X = clip(sym(S)), Xb, the dual ascent on yA, yB of the owned
//        entries, yA and yB to global memory (the x sums' rows and columns),
//        with cuts Xb too; each dense row's partial <G_q, Xb> + g_q . xb
//        over the owned entries to global memory;         grid barrier 2
//   III  the owned dense rows: their P partials in CTA order, yD and its sum;
//        with cuts, the owned slots: the residual at (xb, Xb) read at the
//        support (cut_residual_k), yC, its sum and the new weight w to global
//        memory; the next x step's row and column sums; grid barrier 3.
// The cut rows add no barrier: they are the math of _one_iter and of K2's
// stage B2 (pdhg_block.cu), with no atomics and one fixed order for every
// sum, so a launch repeats bit for bit; the twins sum in torch's order and
// agree to rounding.
//
// The check (kCheck) after the last iteration, as pdhg_dense.cu's grid_check,
// with the cut rows' terms of pdhg_check.cuh: for the current iterate, then
// the average (its weights (ayC / wlen) act), one pass over the dense rows
// for the adjoint and the residuals, M = cX - gX of the owned entries, the
// objective, the dual bound's yB, cut (rhs . yC) and x terms, the box and cut
// rows' infeasibility;                                       grid barrier
// M + M^T and the owned dense rows' terms;                   grid barrier
// every CTA folds every CTA's sums in CTA order and decides alike; on a
// restart each CTA writes its slices of the candidate (yC of its slots too),
// zeroes its sums and sends its distances (the cut part kDC);  grid barrier
// CTA 0 writes the record.
//
// The norm: a power iteration, from (y, Y) as the last one left it, is
//   A  each dense row's partial of <G_q, Y> + g_q . y;       grid barrier 1
//   B  nrm from every CTA's sums; kD of the owned rows, kA, kB of the owned
//      entries and, with cuts, the owned slots' rows at z = (y, Y) / nrm,
//      their weights ((kC act) act) to global memory;        grid barrier 2
//   C  the dense adjoint with weights kD; gX = ((box rows) + cut) + dense of
//      the owned entries, gx of the owned entries of x;      grid barrier 3
//   D  Y = 0.5 (gX + gX^T) of the owned entries and each CTA's sums.
// After the last iteration A and B give K z, whose squares each CTA sums,
// and CTA 0 folds them.
//
// The walk: a batch's instances share one shape, so one launch runs them one
// after another, each over the whole grid with the slices it has alone (the
// same partition, the same sum orders, the same bits), where splitting the
// grid among them would change both and overflow kMaxE.  A CTA computes its
// slices once a launch and keeps the instance's arguments (the launch's,
// shifted by the instance's strides) beside them in its shared memory; it
// loads the instance's resident dense rows, or starts their stream, anew.
// A stopped instance is skipped by every CTA before any barrier (its record
// is written only in its own turn), and one grid barrier between two turns
// that run keeps the global scratch of one from the next.  The single
// entries are the walk's batch of one.
//
// The column width (Cols) sets the entries a CTA may own (GridForm kMaxE),
// the scratch of the passes over the dense rows (kScratch: strand partials
// and the residual's weights) and the stages of their ring.  At 512 columns
// a CTA's spans run past 128 chunks of 4 floats, so the adjoint's lanes each
// take up to 4 chunks (kChunks) in 4 strands.
//
// At 1024 columns a CTA owns up to ~7,950 entries (1024^2 / 132), whose nine
// words an entry do not fit its shared memory, nor the whole card's.  So that
// form (GridForm kState = 0) keeps the owned entries' state in global memory,
// where the L2 holds most of it: the block copies its slices of the inputs
// to the outputs once (where they differ) and iterates on the outputs in
// place, S in the scratch, cX read where it lies; the norm keeps Y in its
// scratch and recomputes kA, kB where the adjoint takes them.  Shared memory
// keeps the Slices, the scratch, the ring and the replicas of yD and of the
// cut weights.  Its passes over the dense rows go by entry, not by chunk
// (Slices::entry_adjoint, entry_residual): thread t takes the entries
// t + kThreads i of [X | x] (i < kSpan), each read at its row's shift, so
// that the adjoint needs no strand partials and the residual no shifted
// copies of its weights.
//
// At 2048 columns (GridForm kStages = 0) a CTA owns up to ~31,800 entries,
// so a row's span outgrows a ring stage and the form keeps only the owned
// entries' buffer (127 KB) in shared memory beside the replicas: its passes
// read the dense rows where they lie in global memory, by entry as at 1024
// columns (Slices::direct_pass, direct_residual).  The adjoint walks a
// thread's entries kSub at a time, each sub-span its own pass over the rows
// in increasing q, so that its registers stay few and every entry's sum
// keeps one order; the residual's pass comes first, while the buffer still
// holds its weights.
//
// The far form (kFar) keeps no replica: the passes read yD where it lies (the
// inputs or the outputs, the norm's kD in its scratch; the check's average
// scaled where read, as the replica is filled) and the cut weights in the
// scratch (the block writes its owned slots' yC act there before its first
// iteration, and the check the average's (ayC / wlen) act before its first
// barrier), each through L2 (__ldcg) after a grid barrier.  Every sum keeps
// its order, so a shape the shared layout holds gives the same bits in either
// form; the slab takes the room the replicas leave.  Its own kernels
// (pdhg_grid_far_kernel, pdhg_grid_far_norm_kernel) leave the shared forms'
// SASS as it was.
//
// The open form (GridForm<kOpen>, every n past 2048, built in
// pdhg_grid_open.cu and pdhg_grid_open_cert.cu) is the 2048-column form
// with no cap on what a CTA owns: at n = 4096 a CTA owns ~127,100 entries,
// whose buffer (508 KB) no CTA's shared memory holds, and ~31 entries of x,
// more than its 16 warps.  So the owned entries' buffer (the dense
// adjoint's sums, the residual's weights) lives in the global scratch, each
// CTA's slice of [X | x] after the last one's (open_words), and
// the owned x entries' state in place in the outputs (x, its sum), their
// row and column sums in the scratch: warp w takes entries i0 + w + 16 j,
// lane 0 stepping them in order.  The norm reads y where it lies, not from
// a copy in the CTA's scratch (n floats past n = 2048), in two buffers in
// turn, since C reads the iterate while it writes the next.  Every sum keeps kVast's order (each
// entry's adjoint over q in increasing order, each row's residual over a
// thread's entries in increasing i, its warp's butterfly, then the warps),
// so a shape either form takes gives the same bits in both.  The one bound
// left is the 32-bit index of X's entries, n n + n < 2^31 (kOpenMax).

#pragma once

#include "pdhg_common.cuh"
#include "pdhg_stream.cuh"

namespace pdhg_grid {

using namespace pdhg;

constexpr int kStage = 8192;     // floats a ring stage
constexpr int kLanes = 128;      // the adjoint's chunk lanes a strand, at most
constexpr int kSmemWords = 232448 / 4;   // the layout takes what a CTA may have
constexpr int kRowGroup = 8;     // rows a pass of the residual's sums by entry

// The grid route's form at column width Cols: kMaxE, the entries (of X and
// x) a CTA may own, its spans (at most kMaxE + 12 floats) in at most
// kChunks kLanes chunks of 4; kScratch, at least the strand partials (4
// kThreads, or 4 strands of the spans) and the residual's weights (4 spans);
// kStages, the ring's stages; kState, the owned entries' state arrays in
// shared memory (8; 0: in global memory, the 1024- and 2048-column forms,
// whose passes go by entry).  kStages = 0: no ring, the passes read the rows
// in place (the 2048-column form, whose spans outgrow a stage; the 1024-
// column form's kMaxE keeps a row's spans within one).
template <int Cols>
struct GridForm;
template <>
struct GridForm<kNarrow> {
  static constexpr int kMaxE = 496, kChunks = 1, kScratch = 2048, kStages = 4, kState = 8;
};
template <>
struct GridForm<kWide> {
  static constexpr int kMaxE = 500, kChunks = 1, kScratch = 2048, kStages = 4, kState = 8;
};
template <>
struct GridForm<kWidest> {
  static constexpr int kMaxE = 2036, kChunks = 4, kScratch = 8192, kStages = 3, kState = 8;
};
template <>
struct GridForm<kHuge> {
  static constexpr int kMaxE = 8180, kChunks = 1, kScratch = 2048, kStages = 4, kState = 0;
};
template <>
struct GridForm<kVast> {
  static constexpr int kMaxE = 31808, kChunks = 1, kScratch = 2304, kStages = 0, kState = 0;
};
// kMaxE = 0: the open form's owned entries' buffer lives in global memory
template <>
struct GridForm<kOpen> {
  static constexpr int kMaxE = 0, kChunks = 1, kScratch = 2304, kStages = 0, kState = 0;
};

// sums of a check's evaluation point
constexpr int kNS = 10;
enum { kPX, kPx, kHyB, kHyC, kHyD, kRxm, kSm, kV2, kVC2, kVD2 };

// Offsets, in 4-byte words, of one CTA's dynamic shared memory at column
// width Cols: the CTA's Slices (below) and its instance's arguments, the
// scratch, the slab of the dense rows' owned segments (resident, or a ring
// of stages; none without dense rows), the replicas of
// yD and of the cut weights (none in the far form), the owned entries'
// buffer (the dense adjoint; the residual's values) and their state (X, yA,
// yB, aX, aA, aB, cX, S; the norm's Y, kA, kB; none at 1024 and 2048
// columns).  The slab takes what the rest leaves, and at least the ring
// (none in a form without a ring).
// lp/pdhg_grid.py::block_words mirrors the sum; the launch checks it.
struct GridLayout {
  int meta, scr, slab, yD, w, own, state, words;
};

// words of the CTA's Slices (the first kArgs) and of its instance's arguments
// (BlockArgs or NormArgs), first in its shared memory
constexpr int kMeta = 192;
constexpr int kArgs = 64;

template <int Cols>
__host__ __device__ inline GridLayout grid_layout(int n, int m, int M, bool cuts, bool far) {
  using F = GridForm<Cols>;
  const int ryD = far ? 0 : m;
  const int rw = far ? 0 : (cuts ? M : 0);
  const int rest = kMeta + F::kScratch + ryD + rw + (1 + F::kState) * F::kMaxE;
  const int free4 = (kSmemWords - rest) & ~3;
  const int ring = F::kStages * kStage;
  const int slabw = m * F::kStages > 0 ? (free4 > ring ? free4 : ring) : 0;
  GridLayout L;
  int o = 0;
#define TAKE(field, words) L.field = o; o += (words)
  TAKE(meta, kMeta);
  TAKE(scr, F::kScratch);
  TAKE(slab, slabw);
  TAKE(yD, ryD);
  TAKE(w, rw);
  TAKE(own, F::kMaxE);
  TAKE(state, F::kState * F::kMaxE);
#undef TAKE
  L.words = o;
  (void)n;
  return L;
}

// The block's global scratch (work), in floats: S (n n), xb (n), the dense
// rows' partials (P m), with cuts Xb (n n) and the weights (M); the checked
// form adds M at the average (n n; the iterate's takes S's place), the
// average's partials (P m), each CTA's sums (P 2 kNS) and distances (P kND),
// and in the far form with cuts the average's weights (M); then the
// barrier's counter.  lp/pdhg_grid.py::work_words mirrors it.
__host__ __device__ inline size_t work_words(int n, int m, int M, int P, bool cuts, bool checked,
                                             bool far) {
  const size_t NN = static_cast<size_t>(n) * n, Pm = static_cast<size_t>(P) * m;
  return NN + n + Pm + (cuts ? NN + M : 0) +
         (checked ? NN + Pm + static_cast<size_t>(P) * (2 * kNS + kND) : 0) +
         (checked && far && cuts ? M : 0) + 1;
}

// The open form's global buffers after the block's or the norm's scratch
// (before the barrier's counter), in floats: the owned entries' buffer, by
// CTA's slice of [X | x] (n n + n in all), the owned x entries' three sums
// (3 n) and the norm's second buffer of y (n).
// lp/pdhg_grid.py::open_words mirrors it.
__host__ __device__ inline size_t open_words(int n) {
  return static_cast<size_t>(n) * n + 5 * static_cast<size_t>(n);
}

// The norm's global scratch (work), in floats: the iterate Y (n n) and y
// (n), gX (n n), the dense rows' partials (P m), kD (m), with cuts the
// weights (M), each CTA's two sums of the iterate and three of the last step
// (5 P); then the barrier's counter.  lp/pdhg_grid.py::norm_work_words
// mirrors it.
__host__ __device__ inline size_t norm_work_words(int n, int m, int M, int P, bool cuts) {
  const size_t NN = static_cast<size_t>(n) * n, Pm = static_cast<size_t>(P) * m;
  return 2 * NN + n + Pm + m + (cuts ? M : 0) + 5 * static_cast<size_t>(P) + 1;
}

// What the kernels read of the pool (with cuts) and the dense rows.
struct Problem {
  int n, m, M, k;
  const float *G, *g;
  const int* idx;                  // (M, k) supports
  const float *lin, *quad, *rhs, *act;
  const int *xoff, *xcut;          // the cut index: x's segments
  const float* xcoef;
  const int *Xoff, *Xcut;          // X's segments (flattened i n + j)
  const float* Xcoef;
};

struct BlockArgs {
  Problem p;
  int iters;
  int* rec;                        // the solve's control record (the checked form writes it)
  const float *cx, *cX, *h;
  // inputs: x, X, yA, yB, yC, yD, then the sums ax, aX, aA, aB, ayC, ayD
  const float *x, *X, *yA, *yB, *yC, *yD, *ax, *aX, *aA, *aB, *ayC, *ayD;
  // outputs, in the same order (may be the inputs)
  float *xo, *Xo, *yAo, *yBo, *yCo, *yDo, *axo, *aXo, *aAo, *aBo, *ayCo, *ayDo;
  float* work;                     // work_words
  unsigned* bar;                   // the barrier's counter
  // the checked form: the anchor and the check's arguments (iters is its
  // check_every)
  float *zx, *zX, *zA, *zB, *zC, *zD;
  int restart_period, max_iters;
  float tol;
};

struct NormArgs {
  Problem p;
  int iters;
  const float *y, *Y;              // the start vector, read only
  float* work;                     // norm_work_words
  unsigned* bar;
  float* out;                      // ||K|| 1.02 + 1e-12
};

// The instance walk: a launch runs instances ids[0..count) of a batch
// stacked along the leading axis of every array, one after another, each on
// the whole grid, so that each gets the partition, the sum orders and the
// bits it gets alone.  Instance b's arrays start b strides in: its shape's
// sizes, and ex, eX (the cut index's term rows) and sG, sg (the dense rows'
// G and g, multiples of 4 floats, so that every instance's rows stay 16-byte
// aligned).  The launch's arguments (BlockArgs, NormArgs) point at the
// batch; the start vector of the norm is every instance's.  More than
// kMaxWalk instances go in consecutive launches.
constexpr int kMaxWalk = 128;
struct Walk {
  int count, ex, eX;
  long long sG, sg;
  int ids[kMaxWalk];
};

template <class T>
__device__ __forceinline__ T* at(T* p, size_t off) {
  return p == nullptr ? p : p + off;
}

__device__ __forceinline__ Problem problem_of(const Problem& p, const Walk& w, size_t b) {
  const size_t n = p.n, NN = n * n, M = p.M, Mk = M * p.k;
  Problem q = p;
  q.G = at(p.G, b * w.sG);
  q.g = at(p.g, b * w.sg);
  q.idx = at(p.idx, b * Mk);
  q.lin = at(p.lin, b * Mk);
  q.quad = at(p.quad, b * Mk * p.k);
  q.rhs = at(p.rhs, b * M);
  q.act = at(p.act, b * M);
  q.xoff = at(p.xoff, b * (n + 1));
  q.xcut = at(p.xcut, b * w.ex);
  q.xcoef = at(p.xcoef, b * w.ex);
  q.Xoff = at(p.Xoff, b * (NN + 1));
  q.Xcut = at(p.Xcut, b * w.eX);
  q.Xcoef = at(p.Xcoef, b * w.eX);
  return q;
}

// instance b's block arguments into o (a CTA's shared memory)
__device__ __forceinline__ void block_args_of(BlockArgs& o, const BlockArgs& a, const Walk& w,
                                              int bi) {
  const size_t b = bi, n = a.p.n, NN = n * n, M = a.p.M, m = a.p.m;
  o = a;
  o.p = problem_of(a.p, w, b);
  o.rec = at(a.rec, b * kRecWords);
  o.cx = at(a.cx, b * n);
  o.cX = at(a.cX, b * NN);
  o.h = at(a.h, b * m);
  // the state, its sums and the anchor, in the order x, X, yA, yB, yC, yD
#define SHIFT(f, size) o.f = at(a.f, b * (size))
#define SHIFT6(x, X, yA, yB, yC, yD) \
  SHIFT(x, n); SHIFT(X, NN); SHIFT(yA, NN); SHIFT(yB, NN); SHIFT(yC, M); SHIFT(yD, m)
  SHIFT6(x, X, yA, yB, yC, yD);
  SHIFT6(ax, aX, aA, aB, ayC, ayD);
  SHIFT6(xo, Xo, yAo, yBo, yCo, yDo);
  SHIFT6(axo, aXo, aAo, aBo, ayCo, ayDo);
  SHIFT6(zx, zX, zA, zB, zC, zD);
#undef SHIFT6
#undef SHIFT
}

// instance b's norm arguments into o (a CTA's shared memory)
__device__ __forceinline__ void norm_args_of(NormArgs& o, const NormArgs& a, const Walk& w,
                                             int b) {
  o = a;
  o.p = problem_of(a.p, w, b);
  o.out = a.out + b;
}

// A CTA's slices and the passes over its dense rows' owned segments: row q's
// G_q[e0, e1) and g_q[i0, i1), each as the 16-byte-aligned span that holds it
// (SA, SB floats: ca, cb chunks of 4), ES floats a row.  Entry j of G's part
// sits at span position shA(q) + j, of g's part at SA + shB(q) + j.  One
// thread fills it in the CTA's shared memory (init) and every thread reads
// it there, so that its fields take no registers across the iterations;
// the lanes of a thread (st, ct; rg, rl) come from threadIdx.x where used.
// kFar: the far form, whose passes read their weights from global memory
// (the adjoint's ysrc[q] yscale, set by weights_yD before each pass, and
// the cut weights at wsrc, set by weights_cut) instead of syD and sw.
template <int Cols, bool kFar>
struct Slices {
  using F = GridForm<Cols>;
  // the owned entries' state in global memory (GridForm kState = 0), and
  // the entries a thread takes in the passes by entry
  static constexpr bool kGlobal = F::kState == 0;
  static constexpr int kSpan = F::kMaxE > 0 ? (F::kMaxE + kThreads - 1) / kThreads : 1;
  // the open form: the owned entries' buffer (sown) and the x entries' sums
  // (xs) in the global scratch (open_buffers)
  static constexpr bool kOpenForm = Cols == kOpen;
  // no ring: the passes read the dense rows in place (2048 columns), the
  // adjoint kSub entries a thread at a time
  static constexpr bool kDirect = F::kStages == 0;
  static constexpr int kSub = 8;
  const Problem* p;
  int n, m, NN, P, b;
  int e0, e1, i0, i1, q0, q1, s0, s1, LA, LB, LS, E;
  int SA, SB, ES, ca, cr;
  bool resident;
  int QB, nst;
  int NS, tps, KC;              // the adjoint's lanes: chunks ct + tps j of strand st
  int RL, RG;                   // the residuals' lanes: RL a row, group rg of RG
  float *scr, *slab, *syD, *sw, *sown, *sst;
  const float* ysrc;            // the far form: the adjoint's weights, ysrc[q] yscale
  float yscale;
  const float* wsrc;            // and the cut weights
  float* xs;                    // the open form: the owned x entries' sums, (3, n), then y

  __device__ __forceinline__ void init(const Problem& pr, float* sm, bool cuts) {
    p = &pr;
    n = pr.n;
    m = pr.m;
    NN = n * n;
    P = static_cast<int>(gridDim.x);
    b = static_cast<int>(blockIdx.x);
    const GridLayout L = grid_layout<Cols>(n, m, pr.M, cuts, kFar);
    scr = sm + L.scr;
    slab = sm + L.slab;
    syD = sm + L.yD;
    sw = sm + L.w;
    sown = sm + L.own;
    sst = sm + L.state;
    slice(NN, b, P, e0, e1);
    slice(n, b, P, i0, i1);
    slice(m, b, P, q0, q1);
    slice(cuts ? pr.M : 0, b, P, s0, s1);
    LA = e1 - e0;
    LB = i1 - i0;
    LS = s1 - s0;
    E = LA + LB;
    SA = LA > 0 ? (LA + 6) & ~3 : 0;
    SB = LB > 0 ? (LB + 6) & ~3 : 0;
    ES = SA + SB;
    ca = SA / 4;
    cr = ES / 4;
    if constexpr (kDirect) {
      resident = false;
      QB = 0;
      nst = 0;
    } else {
      resident = static_cast<long long>(m) * ES <= L.yD - L.slab;
      QB = ES > 0 ? kStage / ES : m;
      nst = resident || m == 0 ? 0 : (m + QB - 1) / QB;
    }
    // NS is a multiple of 4, so a strand's rows share their shift
    tps = cr < kLanes ? cr : kLanes;
    NS = cr > 0 ? (kThreads / tps) & ~3 : 0;
    KC = cr > 0 ? (cr + tps - 1) / tps : 0;
    RL = 1;                     // the least power of two with at most 4 chunks a lane
    while (RL < 32 && RL * 4 < cr) RL <<= 1;
    RG = kThreads / RL;
  }
  // the open form's buffers at buf in the global scratch (open_words), set
  // by one thread after init: the CTA's E words of the owned entries'
  // buffer (the CTAs' [X | x] slices one after another: e0 + i0 words
  // before this one's) and the x entries' sums, the norm's second y after them
  __device__ __forceinline__ void open_buffers(float* buf) {
    sown = buf + (static_cast<size_t>(e0) + i0);
    xs = buf + (static_cast<size_t>(n) * n + n);
  }
  // the CTA's Slices, which one thread has filled (init), in its shared memory
  static __device__ __forceinline__ Slices& of(float* sm) {
    return *reinterpret_cast<Slices*>(sm);
  }
  // the owned entries' state: array f (0..7) of the layout's state
  __device__ __forceinline__ float* state(int f) const { return sst + f * F::kMaxE; }
  // the dense adjoint's weight of row q: the replica's, or in the far form
  // read from global memory through L2 (written by other CTAs in this launch)
  __device__ __forceinline__ float yd(int q) const {
    if constexpr (kFar) {
      const volatile Slices& v = *this;    // read where used: no pointer held in registers
      // rounded as the replica's store rounds it: never contracted into a sum
      return __fmul_rn(__ldcg(v.ysrc + q), v.yscale);
    } else {
      return syD[q];
    }
  }
  // the cut weights of a pass: the replica, or the far form's (weights_cut)
  __device__ __forceinline__ const float* cut_weights(const float* replica) const {
    if constexpr (kFar) {
      const volatile Slices& v = *this;
      return v.wsrc;
    } else {
      return replica;
    }
  }
  __device__ __forceinline__ void weights_cut(const float* w) const {
    if constexpr (kFar) {
      if (threadIdx.x == 0) const_cast<Slices&>(*this).wsrc = w;
    }
  }
  // the far form's weights of the next pass, yD[q] scale (one thread writes
  // them; a barrier comes before the pass)
  __device__ __forceinline__ void weights_yD(const float* yD, float scale) const {
    if constexpr (kFar) {
      if (threadIdx.x == 0) {
        Slices& w = const_cast<Slices&>(*this);
        w.ysrc = yD;
        w.yscale = scale;
      }
    }
  }
  __device__ __forceinline__ int shA(int q) const { return ((q & 3) * (NN & 3) + e0) & 3; }
  __device__ __forceinline__ int shB(int q) const { return ((q & 3) * (n & 3) + i0) & 3; }

  // copy rows [qs, qs + nq) into dst: 16-byte copies (4-byte at the arrays'
  // ends); a chunk past its segment, or past the array, holds zeros
  __device__ __forceinline__ void load_rows(int qs, int nq, float* dst) const {
    const size_t totG = static_cast<size_t>(m) * NN, totg = static_cast<size_t>(m) * n;
    for (int pp = threadIdx.x; pp < nq * cr; pp += kThreads) {
      const int ql = pp / cr, c = pp - ql * cr;
      const size_t q = static_cast<size_t>(qs + ql);
      const bool inA = c < ca;
      const size_t s0_ = inA ? q * NN + e0 : q * n + i0;
      const size_t start = (s0_ & ~static_cast<size_t>(3)) + 4 * (inA ? c : c - ca);
      const size_t end = s0_ + (inA ? LA : LB), tot = inA ? totG : totg;
      const float* base = inA ? p->G : p->g;
      float* d = dst + ql * ES + 4 * c;
      if (start >= end || start + 4 > tot) {
        for (int u = 0; u < 4; ++u) {
          if (start + u < end && start + u < tot) {
            cp_async4(d + u, base + start + u);
          } else {
            d[u] = 0.0f;
          }
        }
      } else {
        cp_async16(d, base + start);
      }
    }
  }
  __device__ __forceinline__ void issue(int s, float* dst) const {
    load_rows(s * QB, min(QB, m - s * QB), dst);
  }
  // the adjoint of rows [qs, qs + nq) (buf: their segments) into acc with the
  // weights syD: span positions 4 (ct + tps j) + u of the strand's rows, in
  // increasing q
  __device__ __forceinline__ void adjoint(float (&acc)[F::kChunks][4], int qs, int nq,
                                          const float* buf) const {
    if (cr == 0) return;
    const int st = threadIdx.x / tps, ct = threadIdx.x % tps;
    if (st >= NS) return;
    for (int ql = ((st - qs % NS) % NS + NS) % NS; ql < nq; ql += NS) {
      const float w = yd(qs + ql);
#pragma unroll
      for (int j = 0; j < F::kChunks; ++j) {
        const int c = ct + tps * j;
        if (j < KC && c < cr) {
          const float4 v = lds4(buf + ql * ES + 4 * c);
          acc[j][0] = fmaf(w, v.x, acc[j][0]);
          acc[j][1] = fmaf(w, v.y, acc[j][1]);
          acc[j][2] = fmaf(w, v.z, acc[j][2]);
          acc[j][3] = fmaf(w, v.w, acc[j][3]);
        }
      }
    }
  }
  // entry j of a part sits at span position sh + j of each strand's rows:
  // the strands' sums, in strand order, into sown[0, E)
  __device__ __forceinline__ void strand_sums(const float (&acc)[F::kChunks][4]) const {
    const int t = threadIdx.x, st = cr > 0 ? t / tps : 0, ct = cr > 0 ? t % tps : 0;
    if (cr > 0 && st < NS) {
#pragma unroll
      for (int j = 0; j < F::kChunks; ++j) {
        const int c = ct + tps * j;
        if (j < KC && c < cr) {
#pragma unroll
          for (int u = 0; u < 4; ++u) scr[(st * cr + c) * 4 + u] = acc[j][u];
        }
      }
    }
    __syncthreads();
    for (int j = t; j < E; j += kThreads) {
      const bool inA = j < LA;
      const int jj = inA ? j : j - LA, cbase = inA ? 0 : ca;
      float sum = 0.0f;
      for (int r = 0; r < NS; ++r) {
        const int pp = jj + (inA ? shA(r) : shB(r));
        sum += scr[(r * cr + cbase + pp / 4) * 4 + (pp & 3)];
      }
      sown[j] = sum;
    }
    __syncthreads();
  }
  // the residual's weights by shift, from the owned entries' values in
  // sown[0, E): span position pp of a row of shift s takes the value at its
  // entry, 0 off the segment (the passes by entry read sown itself)
  __device__ __forceinline__ void shift_weights() const {
    if constexpr (kGlobal) return;
    for (int pp = threadIdx.x; pp < 4 * ES; pp += kThreads) {
      const int s = pp / ES, ps = pp - s * ES;
      float w = 0.0f;
      if (ps < SA) {
        if (ps - s >= 0 && ps - s < LA) w = sown[ps - s];
      } else if (ps - SA - s >= 0 && ps - SA - s < LB) {
        w = sown[LA + ps - SA - s];
      }
      scr[pp] = w;
    }
    __syncthreads();
  }
  // each row's partial over the owned entries, RL lanes a row (a butterfly;
  // the same trip count in every lane: rows past nq redo the last, unstored),
  // into out[b bs + q qs_]
  __device__ __forceinline__ void residual(float* out, size_t bs, size_t qs_, int qs, int nq,
                                           const float* buf) const {
    const int rg = threadIdx.x / RL, rl = threadIdx.x % RL;
    for (int qb = 0; qb < nq; qb += RG) {
      const int ql = qb + rg, qq = min(ql, nq - 1), q = qs + qq;
      const int sa = shA(q), sb = shB(q);
      float r = 0.0f;
      for (int c = rl; c < cr; c += RL) {
        const float4 v = lds4(buf + qq * ES + 4 * c);
        const float4 w = lds4(scr + (c < ca ? sa * ES + 4 * c : sb * ES + 4 * c));
        r = fmaf(v.x, w.x, r);
        r = fmaf(v.y, w.y, r);
        r = fmaf(v.z, w.z, r);
        r = fmaf(v.w, w.w, r);
      }
      for (int o = RL / 2; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
      if (rl == 0 && ql < nq) out[b * bs + (qs + ql) * qs_] = r;
    }
  }
  // ---- the passes by entry (the 1024-column form) ----
  // thread t takes the entries t + kThreads i of X's part (i < entries_A();
  // entry j of row q at span position j + shA(q), one base address and
  // immediate offsets a row) and, since LB < kThreads, at most one entry of
  // x's part, entry_x() (E where it has none; at SA + shB(q) + j - LA)
  __device__ __forceinline__ int entries_A() const {
    const int t = threadIdx.x;
    return t < LA ? (LA - 1 - t) / kThreads + 1 : 0;
  }
  __device__ __forceinline__ int entry_x() const {
    const int jx = LA + ((threadIdx.x - LA) % kThreads + kThreads) % kThreads;
    return jx < E ? jx : E;
  }
  // acc[i] += yD_q (row q at entry t + kThreads i), ax at entry_x(), rows in
  // increasing q
  __device__ __forceinline__ void entry_adjoint(float (&acc)[kSpan], float& ax, int qs, int nq,
                                                const float* buf) const {
    const int t = threadIdx.x, nA = entries_A(), jx = entry_x();
    for (int ql = 0; ql < nq; ++ql) {
      const int q = qs + ql;
      const float w = yd(q);
      const float* const row = buf + ql * ES;
      const float* const rA = row + t + shA(q);
#pragma unroll
      for (int i = 0; i < kSpan; ++i)
        if (i < nA) acc[i] = fmaf(w, rA[kThreads * i], acc[i]);
      if (jx < E) ax = fmaf(w, row[SA + shB(q) + jx - LA], ax);
    }
  }
  // each row's partial over the owned entries at the weights sown[0, E) into
  // out[b bs + q qs_]: every thread its entries (X's part in increasing i,
  // then x's), each warp's butterfly, then the warps in order, kRowGroup
  // rows a pass of the scratch's last words
  __device__ __forceinline__ void entry_residual(float* out, size_t bs, size_t qs_, int qs,
                                                 int nq, const float* buf) const {
    const int t = threadIdx.x, lane = t % 32, warp = t / 32, nA = entries_A(), jx = entry_x();
    float* const red = scr + F::kScratch - kRowGroup * (kThreads / 32);
    for (int qb = 0; qb < nq; qb += kRowGroup) {
      const int nr = min(kRowGroup, nq - qb);
      for (int r = 0; r < nr; ++r) {
        const int ql = qb + r, q = qs + ql;
        const float* const row = buf + ql * ES;
        const float* const rA = row + t + shA(q);
        float v = 0.0f;
#pragma unroll
        for (int i = 0; i < kSpan; ++i)
          if (i < nA) v = fmaf(rA[kThreads * i], sown[t + kThreads * i], v);
        if (jx < E) v = fmaf(row[SA + shB(q) + jx - LA], sown[jx], v);
        v = warp_sum(v);
        if (lane == 0) red[warp * kRowGroup + r] = v;
      }
      __syncthreads();
      if (t < nr) {
        float sum = 0.0f;
        for (int w = 0; w < kThreads / 32; ++w) sum += red[w * kRowGroup + t];
        out[b * bs + (qs + qb + t) * qs_] = sum;
      }
      __syncthreads();
    }
  }
  // the pass by entry: the dense adjoint into sown[0, E) once every row is
  // read and, with a residual, each row's partial at the weights in sown
  __device__ __forceinline__ void entry_pass(float* out, size_t bs, size_t qs_,
                                             bool with_residual) const {
    float acc[kSpan], ax = 0.0f;
#pragma unroll
    for (int i = 0; i < kSpan; ++i) acc[i] = 0.0f;
    if (resident) {
      entry_adjoint(acc, ax, 0, m, slab);
      if (with_residual) entry_residual(out, bs, qs_, 0, m, slab);
    } else {
      ring_drain<kStage, F::kStages>(
          slab, nst, [&](int s, float* dst) { issue(s, dst); },
          [&](int s, const float* buf) {
            entry_adjoint(acc, ax, s * QB, min(QB, m - s * QB), buf);
            if (with_residual) entry_residual(out, bs, qs_, s * QB, min(QB, m - s * QB), buf);
          });
    }
    __syncthreads();               // every lane done with the weights in sown
    const int t = threadIdx.x, nA = entries_A(), jx = entry_x();
#pragma unroll
    for (int i = 0; i < kSpan; ++i)
      if (i < nA) sown[t + kThreads * i] = acc[i];
    if (jx < E) sown[jx] = ax;
    __syncthreads();
  }
  // the dense adjoint of the owned entries into sown[0, E), one pass over the
  // rows (resident, or the stream from its first stages, which the caller
  // issued); with a residual, each row's partial at the weights that
  // shift_weights left in scr (by entry: in sown) into out as residual()
  // stores it
  __device__ __forceinline__ void adjoint_pass(float* out, size_t bs, size_t qs_,
                                               bool with_residual) const {
    if constexpr (kDirect) {
      direct_pass(out, bs, qs_, with_residual);
    } else if constexpr (kGlobal) {
      entry_pass(out, bs, qs_, with_residual);
    } else {
      chunk_pass(out, bs, qs_, with_residual);
    }
  }
  // adjoint_pass by chunks of 4, strands and strand sums (up to 512 columns)
  __device__ __forceinline__ void chunk_pass(float* out, size_t bs, size_t qs_,
                                             bool with_residual) const {
    float acc[F::kChunks][4];
#pragma unroll
    for (int j = 0; j < F::kChunks; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.0f;
    if (resident) {
      adjoint(acc, 0, m, slab);
      if (with_residual) residual(out, bs, qs_, 0, m, slab);
      __syncthreads();             // every lane done with the weights in scr
    } else {
      ring_drain<kStage, F::kStages>(
          slab, nst, [&](int s, float* dst) { issue(s, dst); },
          [&](int s, const float* buf) {
            adjoint(acc, s * QB, min(QB, m - s * QB), buf);
            if (with_residual) residual(out, bs, qs_, s * QB, min(QB, m - s * QB), buf);
          });
    }
    strand_sums(acc);
  }
  // each row's partial at the weights in scr (by entry: in sown), one pass
  // over the rows
  __device__ __forceinline__ void residual_pass(float* out, size_t bs, size_t qs_) const {
    if constexpr (kDirect) {
      direct_residual(out, bs, qs_);
    } else {
      auto rows = [&](int qs, int nq, const float* buf) {
        if constexpr (kGlobal) {
          entry_residual(out, bs, qs_, qs, nq, buf);
        } else {
          residual(out, bs, qs_, qs, nq, buf);
        }
      };
      if (resident) {
        rows(0, m, slab);
      } else {
        ring_drain<kStage, F::kStages>(
            slab, nst, [&](int s, float* dst) { issue(s, dst); },
            [&](int s, const float* buf) { rows(s * QB, min(QB, m - s * QB), buf); });
      }
    }
  }
  // a stream's first stages (nothing when resident, without rows or without
  // a ring)
  __device__ __forceinline__ void stream_prologue() const {
    if constexpr (!kDirect)
      ring_prologue<kStage, F::kStages>(slab, nst, [&](int s, float* dst) { issue(s, dst); });
  }
  // ---- the passes in place (2048 columns) ----
  // row q's X part from the CTA's first entry e0 on, and its x part shifted
  // so that entry jx (LA <= jx < E) of [X | x] sits at index jx
  __device__ __forceinline__ const float* row_X(int q) const {
    return p->G + static_cast<size_t>(q) * NN + e0;
  }
  __device__ __forceinline__ const float* row_x(int q) const {
    return p->g + static_cast<size_t>(q) * n + i0 - LA;
  }
  // each row's partial over the owned entries at the weights sown[0, E) into
  // out[b bs + q qs_], as entry_residual sums it (every thread its entries
  // of X in increasing i, then its entry of x; each warp's butterfly, then
  // the warps in order), the rows read in place, kSub entries a load batch
  __device__ __forceinline__ void direct_residual(float* out, size_t bs, size_t qs_) const {
    const int t = threadIdx.x, lane = t % 32, warp = t / 32, nA = entries_A(), jx = entry_x();
    float* const red = scr + F::kScratch - kRowGroup * (kThreads / 32);
    for (int qb = 0; qb < m; qb += kRowGroup) {
      const int nr = min(kRowGroup, m - qb);
      for (int r = 0; r < nr; ++r) {
        const float* const rA = row_X(qb + r) + t;
        float v = 0.0f;
#pragma unroll 1
        for (int i0_ = 0; i0_ < nA; i0_ += kSub) {
          float g[kSub];
#pragma unroll
          for (int i = 0; i < kSub; ++i) g[i] = i0_ + i < nA ? __ldg(rA + kThreads * (i0_ + i)) : 0.0f;
#pragma unroll
          for (int i = 0; i < kSub; ++i)
            if (i0_ + i < nA) v = fmaf(g[i], sown[t + kThreads * (i0_ + i)], v);
        }
        if (jx < E) v = fmaf(__ldg(row_x(qb + r) + jx), sown[jx], v);
        v = warp_sum(v);
        if (lane == 0) red[warp * kRowGroup + r] = v;
      }
      __syncthreads();
      if (t < nr) {
        float sum = 0.0f;
        for (int w = 0; w < kThreads / 32; ++w) sum += red[w * kRowGroup + t];
        out[b * bs + (qb + t) * qs_] = sum;
      }
      __syncthreads();
    }
  }
  // the dense adjoint of the owned entries into sown[0, E), the rows read in
  // place: a thread's entries kSub at a time, each sub-span a pass over the
  // rows in increasing q (its x entry in the first), so that every entry's
  // sum has one order whatever the split
  __device__ __forceinline__ void direct_adjoint() const {
    const int t = threadIdx.x, nA = entries_A(), jx = entry_x();
#pragma unroll 1
    for (int i0_ = 0; i0_ < nA || (i0_ == 0 && jx < E); i0_ += kSub) {
      float acc[kSub], ax = 0.0f;
#pragma unroll
      for (int i = 0; i < kSub; ++i) acc[i] = 0.0f;
      for (int q = 0; q < m; ++q) {
        const float w = yd(q);
        const float* const rA = row_X(q) + t + kThreads * i0_;
#pragma unroll
        for (int i = 0; i < kSub; ++i)
          if (i0_ + i < nA) acc[i] = fmaf(w, __ldg(rA + kThreads * i), acc[i]);
        if (i0_ == 0 && jx < E) ax = fmaf(w, __ldg(row_x(q) + jx), ax);
      }
#pragma unroll
      for (int i = 0; i < kSub; ++i)
        if (i0_ + i < nA) sown[t + kThreads * (i0_ + i)] = acc[i];
      if (i0_ == 0 && jx < E) sown[jx] = ax;
    }
  }
  // adjoint_pass in place: the residual first, at the weights in sown, then
  // the adjoint into sown
  __device__ __forceinline__ void direct_pass(float* out, size_t bs, size_t qs_,
                                              bool with_residual) const {
    if (with_residual) direct_residual(out, bs, qs_);
    __syncthreads();               // every lane done with the weights in sown
    direct_adjoint();
    __syncthreads();
  }
};

// sum over q in [q0, q1) of w[cut[q]] coef[q], in order (segment_sum's):
// the far form's, its weights in global memory, written by other CTAs in
// this launch, read through L2
__device__ __forceinline__ float segment_sum_far(const int* cut, const float* coef, int q0,
                                                 int q1, const float* w) {
  float s = 0.0f;
  for (int q = q0; q < q1; ++q) s += __ldcg(w + cut[q]) * coef[q];
  return s;
}

// the cut adjoint of entry e of X (Xs) or i of x (xs) over the cut index's
// segment, weights w in shared memory (the far form: in global memory)
template <bool kFar>
__device__ __forceinline__ float cut_X(const Problem& p, int e, const float* w) {
  const int q0 = __ldg(p.Xoff + e), q1 = __ldg(p.Xoff + e + 1);
  if constexpr (kFar) {
    return segment_sum_far(p.Xcut, p.Xcoef, q0, q1, w);
  } else {
    return segment_sum(p.Xcut, p.Xcoef, q0, q1, w);
  }
}
template <bool kFar>
__device__ __forceinline__ float cut_x(const Problem& p, int i, const float* w) {
  const int q0 = __ldg(p.xoff + i), q1 = __ldg(p.xoff + i + 1);
  if constexpr (kFar) {
    return segment_sum_far(p.xcut, p.xcoef, q0, q1, w);
  } else {
    return segment_sum(p.xcut, p.xcoef, q0, q1, w);
  }
}

// slot q's K row at (x, X) from global memory, each value times sc:
// lin . x[id] + <quad, X[id, id]>
__device__ __forceinline__ float cut_row(const Problem& p, int q, const float* x, const float* X,
                                         float sc) {
  const int k = p.k, n = p.n;
  return cut_residual_k(
      k, p.idx + q * k, p.lin + q * k, p.quad + q * k * k,
      [&](int iu) { return __ldcg(x + iu) * sc; },
      [&](int iu, int iv) { return __ldcg(X + static_cast<size_t>(iu) * n + iv) * sc; });
}

// the state arrays of the owned entries (Slices::state)
enum { kSX, kSA_, kSB_, kSaX, kSaA, kSaB, kScX, kSS };

// At 1024 columns the owned entries' state array f is the instance's output
// array (cX: its input), at the CTA's entries e0 on; its pointer is read
// from the arguments in shared memory where it is used (a volatile read),
// so that no 64-bit pointer to the state stays in a register across the
// passes over the dense rows.  S is the scratch's (kSS: not here).
__device__ __forceinline__ float* owned_out(const BlockArgs& a, int f) {
  const volatile BlockArgs& v = a;
  switch (f) {
    case kSX: return v.Xo;
    case kSA_: return v.yAo;
    case kSB_: return v.yBo;
    case kSaX: return v.aXo;
    case kSaA: return v.aAo;
    case kSaB: return v.aBo;
    default: return const_cast<float*>(v.cX);
  }
}

// The far form's owned slots: yC (sum false) and its sum (true) in place in
// the instance's outputs, the pointer read where used, as owned_out's.
__device__ __forceinline__ float* slots_out(const BlockArgs& a, bool sum) {
  const volatile BlockArgs& v = a;
  return sum ? v.ayCo : v.yCo;
}

// ---- the check, the checked form's epilogue ------------------------------
// After the block's last iteration; the state and sums of the owned entries
// in shared memory (at 1024 columns in the outputs), of the owned x entries
// and slots in registers (rx, rax, rC, raC; the far form's slots in the
// outputs), everything else in global memory, where the block stored it.
template <bool kCuts, int Cols, bool kFar>
__device__ __forceinline__ void grid_check(const BlockArgs& L, const BlockArgs& a,
                                           const Slices<Cols, kFar>& g, unsigned& target,
                                           float rx, float rax, float rC, float raC) {
  const Problem& pr = a.p;
  const int n = pr.n, m = pr.m, NN = n * n, t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int &P = g.P, &b = g.b;        // read from the CTA's Slices where used
  const int &e0 = g.e0, &i0 = g.i0, &q0 = g.q0, &q1 = g.q1, &s0 = g.s0, &LA = g.LA, &LB = g.LB;
  float* const scr = g.scr;
  float* const sw = g.sw;
  float* const sown = g.sown;
  const float* const sX = g.state(kSX);
  const float* const sA = g.state(kSA_);
  const float* const sB = g.state(kSB_);
  const float* const saX = g.state(kSaX);
  const float* const saA = g.state(kSaA);
  const float* const saB = g.state(kSaB);
  const float* const scX = g.state(kScX);
  // the owned state array f at p, or at 1024 columns owned_out's
  const auto own = [&](int f, const float* p) -> const float* {
    if constexpr (Slices<Cols, kFar>::kGlobal) {
      return owned_out(a, f) + e0;
    } else {
      return p;
    }
  };
  float* const S = L.work;
  float* const part = S + NN + n;
  float* const wg = part + static_cast<size_t>(P) * m + NN;        // the weights (cuts)
  int* const rec = a.rec;
  const int wlen = rec[kRecWlen] + L.iters;
  const float inv = 1.0f / static_cast<float>(wlen);
  // M = cX - gX of each point (the iterate's in S's place) and its rows'
  // partials, (m, P) each; each CTA's sums (2 kNS, P) and distances (kND, P);
  // the far form's weights at the average (M)
  float* const M1 = L.work + work_words(n, m, pr.M, P, kCuts, false, false) - 1;
  float* const part1 = M1 + NN;
  float* const csum = part1 + static_cast<size_t>(P) * m;
  float* const cdist = csum + static_cast<size_t>(P) * 2 * kNS;
  float* const wavg = cdist + static_cast<size_t>(P) * kND;
  const bool ownx = lane == 0 && warp < LB, owns = t < g.LS;
  constexpr bool kO = Slices<Cols, kFar>::kOpenForm;   // the x entries in place, xo and axo
  if constexpr (kFar && kCuts) {       // the average's weights of the owned slots
    const float* const ayC = slots_out(a, true);
    for (int q = s0 + t; q < g.s1; q += kThreads) wavg[q] = (ayC[q] * inv) * pr.act[q];
  }
  grid_sync(L.bar, target, P);         // the state, the sums, yD and w in global memory

#pragma unroll 1
  for (int pt = 0; pt < 2; ++pt) {
    const float sc = pt == 0 ? 1.0f : inv;
    const float* const pyD = pt == 0 ? a.yDo : a.ayDo;
    const float* const px = pt == 0 ? a.xo : a.axo;
    const float* const pX = pt == 0 ? a.Xo : a.aXo;
    const float* const pyA = pt == 0 ? a.yAo : a.aAo;
    const float* const pyB = pt == 0 ? a.yBo : a.aBo;
    const int fX = pt == 0 ? kSX : kSaX, fA = pt == 0 ? kSA_ : kSaA, fB = pt == 0 ? kSB_ : kSaB;
    const float* const bX = pt == 0 ? sX : saX;
    const float* const bA = pt == 0 ? sA : saA;
    const float* const bB = pt == 0 ? sB : saB;
    // the point's yD and cut weights (the adjoints'), its owned [X | x] (the
    // residuals' weights, by shift); the far form reads them where they lie
    if constexpr (kFar) {
      g.weights_yD(pyD, sc);
      g.weights_cut(pt == 0 ? wg : wavg);
    } else {
      for (int q = t; q < m; q += kThreads) g.syD[q] = __ldcg(pyD + q) * sc;
      if constexpr (kCuts) {
        for (int q = t; q < pr.M; q += kThreads)
          sw[q] = pt == 0 ? __ldcg(wg + q) : (__ldcg(a.ayCo + q) * inv) * pr.act[q];
      }
    }
    if (m > 0) {
      const float* const oX = own(fX, bX);
      for (int j = t; j < LA; j += kThreads) sown[j] = oX[j] * sc;
      if constexpr (kO) {
        for (int i = i0 + t; i < g.i1; i += kThreads) sown[LA + i - i0] = px[i] * sc;
      } else {
        if (ownx) sown[LA + warp] = (pt == 0 ? rx : rax) * sc;
      }
      __syncthreads();
      g.shift_weights();
      g.stream_prologue();
      g.adjoint_pass(pt == 0 ? part : part1, 1, P, true);   // the dense adjoint, partials
    } else {
      __syncthreads();
    }
    float v[kNS];
#pragma unroll
    for (int j = 0; j < kNS; ++j) v[j] = 0.0f;
    // the owned entries of X: M = cX - gX to the transposes' readers, the
    // objective, the dual bound's yB term and K z's infeasibility
    const float *const oX = own(fX, bX), *const oA = own(fA, bA), *const oB = own(fB, bB);
    const float* const ocX = own(kScX, scX);
    for (int j = t; j < LA; j += kThreads) {
      const int e = e0 + j, io = e / n, co = e - io * n;
      const float Xv = oX[j] * sc, va = oA[j] * sc, vb = oB[j] * sc;
      float gX = -kSA * va + kSB * vb;
      if constexpr (kCuts) gX = gX + cut_X<kFar>(pr, e, g.cut_weights(sw));
      if (m > 0) gX = gX + sown[j];
      (pt == 0 ? S : M1)[e] = ocX[j] - gX;
      v[kPX] += ocX[j] * Xv;
      v[kHyB] += vb;
      const float xi = __ldcg(px + io) * sc, xc = __ldcg(px + co) * sc;
      const float kA = kSA * (xi - Xv);
      const float kB = kSB * (Xv - xi - xc);
      const float vA = fmaxf(-kA, 0.0f), vB = fmaxf(-kSB - kB, 0.0f);
      v[kV2] += vA * vA + vB * vB;
    }
    // the owned entries of x: gx from the point's row and column sums (warp
    // w: entry i0 + w; in the open form i0 + w + 16 j, in order, x in place)
    if constexpr (kO) {
      for (int i = i0 + warp; i < g.i1; i += kThreads / 32) {
        float sa = 0.0f, sb = 0.0f, sc2 = 0.0f;
        for (int c = lane; c < n; c += 32) {
          sa += __ldcg(pyA + i * n + c) * sc;
          sb += __ldcg(pyB + i * n + c) * sc;
          sc2 += __ldcg(pyB + c * n + i) * sc;
        }
        sa = warp_sum(sa);
        sb = warp_sum(sb);
        sc2 = warp_sum(sc2);
        if (lane == 0) {
          float gx = kSA * sa - kSB * (sb + sc2);
          if constexpr (kCuts) gx = gx + cut_x<kFar>(pr, i, g.cut_weights(sw));
          if (m > 0) gx = gx + sown[LA + i - i0];
          v[kRxm] += fminf(a.cx[i] - gx, 0.0f);
          v[kPx] += a.cx[i] * (px[i] * sc);
        }
      }
    } else {
      if (warp < LB) {
        const int i = i0 + warp;
        float sa = 0.0f, sb = 0.0f, sc2 = 0.0f;
        for (int c = lane; c < n; c += 32) {
          sa += __ldcg(pyA + i * n + c) * sc;
          sb += __ldcg(pyB + i * n + c) * sc;
          sc2 += __ldcg(pyB + c * n + i) * sc;
        }
        sa = warp_sum(sa);
        sb = warp_sum(sb);
        sc2 = warp_sum(sc2);
        if (lane == 0) {
          float gx = kSA * sa - kSB * (sb + sc2);
          if constexpr (kCuts) gx = gx + cut_x<kFar>(pr, i, g.cut_weights(sw));
          if (m > 0) gx = gx + sown[LA + warp];
          v[kRxm] += fminf(a.cx[i] - gx, 0.0f);
          v[kPx] += a.cx[i] * ((pt == 0 ? rx : rax) * sc);
        }
      }
    }
    // the owned slots: rhs . yC and the cut rows' infeasibility at the point
    const auto slot_terms = [&](int q, float y) {
      const float am = pr.act[q];
      v[kHyC] += pr.rhs[q] * am * (y * sc);
      if (am != 0.0f) {
        const float kC = cut_row(pr, q, px, pX, sc) * am;
        const float vC = fmaxf(pr.rhs[q] * am - kC, 0.0f) * am;
        v[kVC2] += vC * vC;
      }
    };
    if constexpr (kCuts && kFar) {
      for (int q = s0 + t; q < g.s1; q += kThreads) slot_terms(q, slots_out(a, pt != 0)[q]);
    } else if constexpr (kCuts) {
      if (owns) slot_terms(s0 + t, pt == 0 ? rC : raC);
    }
    block_sums(v, scr, scr + (kThreads / 32) * kNS);
    if (t == kPX || t == kPx || t == kHyB || t == kHyC || t == kRxm || t == kV2 || t == kVC2)
      csum[static_cast<size_t>(pt * kNS + t) * P + b] = scr[(kThreads / 32) * kNS + t];
  }
  grid_sync(L.bar, target, P);         // every M and every row's partials

  // the dual bound's M + M^T term, and the owned dense rows' terms
  {
    float v[2 * kNS];
#pragma unroll
    for (int j = 0; j < 2 * kNS; ++j) v[j] = 0.0f;
#pragma unroll
    for (int pt = 0; pt < 2; ++pt) {
      const float sc = pt == 0 ? 1.0f : inv;
      const float* const pyD = pt == 0 ? a.yDo : a.ayDo;
      const float* const Mp = pt == 0 ? S : M1;
      const float* const pp = pt == 0 ? part : part1;
      float sm_ = 0.0f;
      for (int j = t; j < LA; j += kThreads) {
        const int e = e0 + j, io = e / n, co = e - io * n;
        sm_ += fminf(__ldcg(Mp + e) + __ldcg(Mp + co * n + io), 0.0f);
      }
      float hyD = 0.0f, vD2 = 0.0f;
      for (int q = q0 + warp; q < q1; q += kThreads / 32) {
        float r = 0.0f;
        for (int c = lane; c < P; c += 32) r += __ldcg(pp + static_cast<size_t>(q) * P + c);
        r = warp_sum(r);
        if (lane == 0) {
          const float vD = fmaxf(a.h[q] - r, 0.0f);
          vD2 += vD * vD;
          hyD += a.h[q] * (__ldcg(pyD + q) * sc);
        }
      }
      v[pt * kNS + kSm] = sm_;
      v[pt * kNS + kHyD] = hyD;
      v[pt * kNS + kVD2] = vD2;
    }
    block_sums(v, scr, scr + (kThreads / 32) * 2 * kNS);
    if (t < 2 * kNS) {
      const int j = t % kNS;
      if (j == kSm || j == kVD2 || j == kHyD)
        csum[static_cast<size_t>(t) * P + b] = scr[(kThreads / 32) * 2 * kNS + t];
    }
  }
  grid_sync(L.bar, target, P);         // every CTA's sums

  // every CTA folds the sums in CTA order and decides alike
  float* const tot = scr;                        // (2 kNS) the sums, then the decision
  for (int j = warp; j < 2 * kNS; j += kThreads / 32) {
    float r = 0.0f;
    for (int c = lane; c < P; c += 32) r += __ldcg(csum + static_cast<size_t>(j) * P + c);
    r = warp_sum(r);
    if (lane == 0) tot[j] = r;
  }
  __syncthreads();
  float* const dec = scr + 2 * kNS;              // err, p, d of both points; use_avg
  if (t == 0) {
    for (int pt = 0; pt < 2; ++pt) {
      const float* s = tot + pt * kNS;
      const float p = s[kPx] + s[kPX];
      const float hy = (-kSB * s[kHyB] + s[kHyC]) + s[kHyD];
      const float d = (hy + s[kRxm]) + 0.5f * s[kSm];
      const float infeas = sqrtf((s[kV2] + s[kVC2]) + s[kVD2]);
      dec[3 * pt] = infeas + fmaxf(p - d, 0.0f);
      dec[3 * pt + 1] = p;
      dec[3 * pt + 2] = d;
    }
    dec[6] = dec[3] < dec[0] ? 1.0f : 0.0f;
  }
  __syncthreads();
  const bool use_avg = dec[6] != 0.0f;
  const bool restart = use_avg || wlen >= L.restart_period;
  if (restart) {
    // the candidate into the state and the anchor, the sums zeroed, each
    // CTA its own slices; the distances from the anchor
    const float csc = use_avg ? inv : 1.0f;
    float dv[kND];
#pragma unroll
    for (int j = 0; j < kND; ++j) dv[j] = 0.0f;
    const float* const cX_ = use_avg ? own(kSaX, saX) : own(kSX, sX);
    const float* const cA = use_avg ? own(kSaA, saA) : own(kSA_, sA);
    const float* const cB = use_avg ? own(kSaB, saB) : own(kSB_, sB);
    for (int j = t; j < LA; j += kThreads) {
      const int e = e0 + j;
      const float X = cX_[j] * csc, A = cA[j] * csc, B = cB[j] * csc;
      const float eX = X - a.zX[e], eA = A - a.zA[e], eB = B - a.zB[e];
      dv[kDX] += eX * eX;
      dv[kDA] += eA * eA;
      dv[kDB] += eB * eB;
      a.Xo[e] = X;
      a.yAo[e] = A;
      a.yBo[e] = B;
      a.zX[e] = X;
      a.zA[e] = A;
      a.zB[e] = B;
      a.aXo[e] = 0.0f;
      a.aAo[e] = 0.0f;
      a.aBo[e] = 0.0f;
    }
    if constexpr (kO) {
      if (lane == 0) {
        for (int i = i0 + warp; i < g.i1; i += kThreads / 32) {
          const float x = (use_avg ? a.axo[i] : a.xo[i]) * csc, e = x - a.zx[i];
          dv[kDx] += e * e;
          a.xo[i] = x;
          a.zx[i] = x;
          a.axo[i] = 0.0f;
        }
      }
    } else {
      if (ownx) {
        const int i = i0 + warp;
        const float x = (use_avg ? rax : rx) * csc, e = x - a.zx[i];
        dv[kDx] += e * e;
        a.xo[i] = x;
        a.zx[i] = x;
        a.axo[i] = 0.0f;
      }
    }
    const auto slot_restart = [&](int q, float yv) {
      const float y = yv * csc, e = y - a.zC[q];
      dv[kDC] += e * e;
      a.yCo[q] = y;
      a.zC[q] = y;
      a.ayCo[q] = 0.0f;
    };
    if constexpr (kCuts && kFar) {
      for (int q = s0 + t; q < g.s1; q += kThreads) slot_restart(q, slots_out(a, use_avg)[q]);
    } else if constexpr (kCuts) {
      if (owns) slot_restart(s0 + t, use_avg ? raC : rC);
    }
    for (int q = q0 + t; q < q1; q += kThreads) {
      const float y = __ldcg((use_avg ? a.ayDo : a.yDo) + q) * csc, e = y - a.zD[q];
      dv[kDD] += e * e;
      a.yDo[q] = y;
      a.zD[q] = y;
      a.ayDo[q] = 0.0f;
    }
    block_sums(dv, scr + 32, scr + 32 + (kThreads / 32) * kND);
    if (t < kND) cdist[static_cast<size_t>(t) * P + b] = scr[32 + (kThreads / 32) * kND + t];
    grid_sync(L.bar, target, P);       // every CTA's distances
    if (b == 0) {
      float* const dist = scr + 256;   // (P, kND), in CTA order
      for (int j = t; j < P * kND; j += kThreads)
        dist[j] = __ldcg(cdist + static_cast<size_t>(j % kND) * P + j / kND);
      __syncthreads();
    }
  }
  // ---- the record, by CTA 0 -------------------------------------------------
  if (b == 0 && t == 0)
    write_record(rec, dec, use_avg, restart, wlen, scr + 256, P, L.iters, L.max_iters, L.tol);
}

// ---- the block, and with kCheck its checked form ---------------------------
// One instance's turn of the walk: its arguments a and the CTA's slices g in
// the CTA's shared memory; L: the launch's arguments (kernel parameters),
// whose fields that every instance shares (iters, work, bar, the check's
// arguments) are read there, so that the scratch's pointers stay constants
// and take no registers; target: the grid barrier's count so far.
template <bool kCheck, bool kCuts, int Cols, bool kFar>
__device__ __forceinline__ void grid_block(const BlockArgs& L, const BlockArgs& a,
                                           const Slices<Cols, kFar>& g, unsigned& target) {
  const float tau = __int_as_float(a.rec[kRecTau]), sigma = __int_as_float(a.rec[kRecSigma]);
  const Problem& pr = a.p;
  const int n = pr.n, m = pr.m, NN = n * n;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int &P = g.P;                  // read from the CTA's Slices where used
  const int &e0 = g.e0, &i0 = g.i0, &q0 = g.q0, &q1 = g.q1, &s0 = g.s0, &LA = g.LA, &LB = g.LB;
  float* const sw = g.sw;
  float* const sown = g.sown;
  float* const S = L.work;
  // the owned entries' state: the CTA's shared memory, or at 1024 columns
  // the outputs themselves (updated in place: owned_out, read where used)
  // and S in the scratch
  constexpr bool kG = Slices<Cols, kFar>::kGlobal;
  float* const sX = g.state(kSX);
  float* const sA = g.state(kSA_);
  float* const sB = g.state(kSB_);
  float* const saX = g.state(kSaX);
  float* const saA = g.state(kSaA);
  float* const saB = g.state(kSaB);
  float* const scX = g.state(kScX);
  float* const sS = kG ? S + e0 : g.state(kSS);
  const auto own = [&](int f, float* p) -> float* {
    if constexpr (kG) {
      return owned_out(a, f) + e0;
    } else {
      return p;
    }
  };
  float* const xb = S + NN;
  float* const part = xb + n;            // (P, m): CTA b's partial of row q at b m + q
  float* const wXb = part + static_cast<size_t>(P) * m;   // with cuts: Xb
  float* const wg = wXb + NN;                               // and the weights w
  const bool ownx = lane == 0 && warp < LB, owns = kCuts && t < g.LS;
  // the open form: the owned x entries' state in place in the outputs and
  // their sums in the scratch (g.xs), lane 0 of warp w taking i0 + w + 16 j
  constexpr bool kO = Slices<Cols, kFar>::kOpenForm;

  if (g.resident && m > 0) g.load_rows(0, m, g.slab);   // the launch's one read of the slice
  cp_async_commit();
  if (L.iters > 0) g.stream_prologue();

  // ---- the owned entries' state and sums, the owned x entries and slots ----
  if constexpr (!kG) {
    for (int j = t; j < LA; j += kThreads) {
      const int e = e0 + j;
      sX[j] = a.X[e];
      sA[j] = a.yA[e];
      sB[j] = a.yB[e];
      saX[j] = a.aX[e];
      saA[j] = a.aA[e];
      saB[j] = a.aB[e];
      scX[j] = a.cX[e];
    }
  } else {                               // the inputs into the outputs, where they differ
    const auto to_out = [&](float* out, const float* in) {
      if (out != in)
        for (int j = t; j < LA; j += kThreads) out[e0 + j] = in[e0 + j];
    };
    to_out(a.Xo, a.X);
    to_out(a.yAo, a.yA);
    to_out(a.yBo, a.yB);
    to_out(a.aXo, a.aX);
    to_out(a.aAo, a.aA);
    to_out(a.aBo, a.aB);
  }
  // lane 0 of warp w: entry i0 + w of x, and the row sums of yA, yB and the
  // column sum of yB that its next x step takes
  float rx = 0.0f, rax = 0.0f, rsa = 0.0f, rsb = 0.0f, rsc = 0.0f;
  auto x_sums = [&](const float* yA, const float* yB) {
    if constexpr (kO) {                  // lane 0's sums of its warp's entries to g.xs
      for (int i = i0 + warp; i < g.i1; i += kThreads / 32) {
        float sa = 0.0f, sb = 0.0f, sc = 0.0f;
        for (int c = lane; c < n; c += 32) {
          sa += __ldcg(yA + i * n + c);
          sb += __ldcg(yB + i * n + c);
          sc += __ldcg(yB + c * n + i);
        }
        sa = warp_sum(sa);
        sb = warp_sum(sb);
        sc = warp_sum(sc);
        if (lane == 0) {
          float* const xs = g.xs;
          xs[i] = sa;
          xs[n + i] = sb;
          xs[2 * n + i] = sc;
        }
      }
    } else {
      if (warp < LB) {
        const int i = i0 + warp;
        float sa = 0.0f, sb = 0.0f, sc = 0.0f;
        for (int c = lane; c < n; c += 32) {
          sa += __ldcg(yA + i * n + c);
          sb += __ldcg(yB + i * n + c);
          sc += __ldcg(yB + c * n + i);
        }
        rsa = warp_sum(sa);
        rsb = warp_sum(sb);
        rsc = warp_sum(sc);
      }
    }
  };
  if constexpr (kO) {                    // the owned x entries into the outputs, where they differ
    if (a.xo != a.x) {
      for (int i = i0 + t; i < g.i1; i += kThreads) {
        a.xo[i] = a.x[i];
        a.axo[i] = a.ax[i];
      }
    }
  } else {
    if (ownx) {
      rx = a.x[i0 + warp];
      rax = a.ax[i0 + warp];
    }
  }
  x_sums(a.yA, a.yB);
  float rC = 0.0f, raC = 0.0f;           // thread t: slot s0 + t's yC and its sum
  if constexpr (kFar && kCuts) {
    // the far form: the owned slots' yC and its sum in the outputs (where
    // they differ), their weights yC act to the scratch for the first
    // iteration, before a grid barrier below
    for (int q = s0 + t; q < g.s1; q += kThreads) {
      const float y = a.yC[q];
      if (a.yCo != a.yC) {
        a.yCo[q] = y;
        a.ayCo[q] = a.ayC[q];
      }
      wg[q] = y * pr.act[q];
    }
  } else if (owns) {
    rC = a.yC[s0 + t];
    raC = a.ayC[s0 + t];
  }
  if (a.yDo != a.yD) {                   // the owned rows' yD and its sum into the outputs
    for (int q = q0 + t; q < q1; q += kThreads) {
      a.yDo[q] = a.yD[q];
      a.ayDo[q] = a.ayD[q];
    }
  }
  if (g.resident && m > 0) cp_async_wait<0>();   // the slice; a stream's stages stay in flight
  g.weights_cut(wg);                     // the far form's cut weights: the scratch's
  if (kFar && kCuts && L.iters > 0) {
    grid_sync(L.bar, target, P);         // every slot's first weights
  } else {
    __syncthreads();
  }

  for (int it = 0; it < L.iters; ++it) {
    const float* yDc = it == 0 ? a.yD : a.yDo;    // the last iteration's yD
    // ---- I: the adjoints of the owned entries, S and the x step -------------
    if constexpr (kFar) {
      g.weights_yD(yDc, 1.0f);
    } else {
      for (int q = t; q < m; q += kThreads) g.syD[q] = __ldcg(yDc + q);
      if constexpr (kCuts) {
        for (int q = t; q < pr.M; q += kThreads)
          sw[q] = it == 0 ? a.yC[q] * pr.act[q] : __ldcg(wg + q);
      }
    }
    __syncthreads();
    if (m > 0) {
      g.adjoint_pass(nullptr, 0, 0, false);      // the dense adjoint into sown[0, E)
      if (!g.resident) g.stream_prologue();      // phase II's first stages, early
    }
    {
      const float *const oA = own(kSA_, sA), *const oB = own(kSB_, sB), *const oX = own(kSX, sX);
      const float* const ocX = own(kScX, scX);
      for (int j = t; j < LA; j += kThreads) {
        const int e = e0 + j;
        float gX = -kSA * oA[j] + kSB * oB[j];
        if constexpr (kCuts) gX = gX + cut_X<kFar>(pr, e, g.cut_weights(sw));
        if (m > 0) gX = gX + sown[j];
        const float s = oX[j] - tau * (ocX[j] - gX);
        sS[j] = s;
        if constexpr (!kG) S[e] = s;
      }
    }
    if constexpr (kO) {                  // lane 0: its warp's entries in order, in place
      if (lane == 0) {
        for (int i = i0 + warp; i < g.i1; i += kThreads / 32) {
          const float* const xs = g.xs;
          float gx = kSA * xs[i] - kSB * (xs[n + i] + xs[2 * n + i]);
          if constexpr (kCuts) gx = gx + cut_x<kFar>(pr, i, g.cut_weights(sw));
          if (m > 0) gx = gx + sown[LA + i - i0];
          const float r = a.xo[i];
          const float xn = fminf(fmaxf(r - tau * (a.cx[i] - gx), 0.0f), 1.0f);
          xb[i] = 2.0f * xn - r;
          a.xo[i] = xn;
          a.axo[i] += xn;
        }
      }
    } else {
      if (ownx) {
        const int i = i0 + warp;
        float gx = kSA * rsa - kSB * (rsb + rsc);
        if constexpr (kCuts) gx = gx + cut_x<kFar>(pr, i, g.cut_weights(sw));
        if (m > 0) gx = gx + sown[LA + warp];
        const float xn = fminf(fmaxf(rx - tau * (a.cx[i] - gx), 0.0f), 1.0f);
        xb[i] = 2.0f * xn - rx;
        rx = xn;
        rax += xn;
      }
    }
    grid_sync(L.bar, target, P);

    // ---- II: X = clip(sym(S)), Xb; the dual ascent on yA, yB; the dense
    //      rows' partials ----------------------------------------------------
    {
      float *const oX = own(kSX, sX), *const oaX = own(kSaX, saX);
      float *const oA = own(kSA_, sA), *const oB = own(kSB_, sB);
      float *const oaA = own(kSaA, saA), *const oaB = own(kSaB, saB);
      for (int j = t; j < LA; j += kThreads) {
        const int e = e0 + j, io = e / n, co = e - io * n;
        const float xn = fminf(fmaxf(0.5f * (sS[j] + __ldcg(S + co * n + io)), 0.0f), 1.0f);
        const float xbv = 2.0f * xn - oX[j];
        oX[j] = xn;
        oaX[j] += xn;
        if constexpr (kCuts) wXb[e] = xbv;
        if constexpr (kO) {
          if (m > 0) sown[j] = xbv;      // the open form's buffer is global: only for rows
        } else {
          sown[j] = xbv;
        }
        const float xbi = __ldcg(xb + io), xbc = __ldcg(xb + co);
        const float kA = kSA * (xbi - xbv);
        const float kB = kSB * (xbv - xbi - xbc);
        const float ya = fmaxf(oA[j] - sigma * kA, 0.0f);
        const float yb = fmaxf(oB[j] + sigma * (-kSB - kB), 0.0f);
        oA[j] = ya;
        oB[j] = yb;
        oaA[j] += ya;
        oaB[j] += yb;
        if constexpr (!kG) {
          a.yAo[e] = ya;
          a.yBo[e] = yb;
        }
      }
    }
    if (m > 0) {
      for (int j = LA + t; j < g.E; j += kThreads) sown[j] = __ldcg(xb + i0 + j - LA);
      __syncthreads();
      g.shift_weights();                 // [Xb | xb]
      g.residual_pass(part, m, 1);
    }
    grid_sync(L.bar, target, P);

    // ---- III: the owned dense rows (their partials in CTA order) and slots;
    //      the next x step's sums of the new yA, yB ------------------------------
    for (int q = q0 + warp; q < q1; q += kThreads / 32) {
      float r = 0.0f;
      for (int c = lane; c < P; c += 32) r += __ldcg(part + static_cast<size_t>(c) * m + q);
      r = warp_sum(r);
      if (lane == 0) {
        const float yd = fmaxf(g.yd(q) + sigma * (a.h[q] - r), 0.0f);
        a.yDo[q] = yd;
        a.ayDo[q] += yd;
      }
    }
    // the owned slots' yC, its sum and the next weights
    const auto slot_step = [&](int q, float& y, float& ay) {
      const float am = pr.act[q];
      float yc = 0.0f;                   // an inactive slot's yC stays 0
      if (am != 0.0f) {
        const float r = cut_row(pr, q, xb, wXb, 1.0f) * am;
        yc = fmaxf(y + sigma * (pr.rhs[q] * am - r), 0.0f) * am;
      }
      y = yc;
      ay += yc;
      wg[q] = yc * am;
    };
    if constexpr (kFar && kCuts) {
      for (int q = s0 + t; q < g.s1; q += kThreads) slot_step(q, slots_out(a, false)[q],
                                                            slots_out(a, true)[q]);
    } else if (owns) {
      slot_step(s0 + t, rC, raC);
    }
    if (it + 1 < L.iters) {
      x_sums(a.yAo, a.yBo);
      if (m > 0 && !g.resident) g.stream_prologue();   // the next iteration's first stages
      grid_sync(L.bar, target, P);
    }
  }

  // ---- exit: the owned entries' state and sums ------------------------------
  if constexpr (!kG) {
    for (int j = t; j < LA; j += kThreads) {
      const int e = e0 + j;
      a.Xo[e] = sX[j];
      a.yAo[e] = sA[j];
      a.yBo[e] = sB[j];
      a.aXo[e] = saX[j];
      a.aAo[e] = saA[j];
      a.aBo[e] = saB[j];
    }
  }
  if constexpr (!kO) {
    if (ownx) {
      a.xo[i0 + warp] = rx;
      a.axo[i0 + warp] = rax;
    }
  }
  if (owns && !kFar) {
    a.yCo[s0 + t] = rC;
    a.ayCo[s0 + t] = raC;
  }
  if constexpr (kCheck) grid_check<kCuts, Cols, kFar>(L, a, g, target, rx, rax, rC, raC);
}

// The block's launch: the walk over the instances w.ids, each instance's
// arguments (a0's, shifted) in the CTA's shared memory.  A grid barrier
// between two turns keeps the global scratch and the arguments of one from
// the next; a stopped instance is skipped by every CTA after it, before any
// barrier of its own (only its own turn writes its record).  The slices are
// the same for every instance.  Its kernels: pdhg_grid_kernel (the replicas
// in shared memory) and pdhg_grid_far_kernel (the far form).
template <bool kCheck, bool kCuts, int Cols, bool kFar>
__device__ __forceinline__ void walk_blocks(const BlockArgs& a0, const Walk& w) {
  extern __shared__ __align__(16) float sm[];
  static_assert(sizeof(Slices<Cols, kFar>) <= 4 * kArgs, "the Slices fit their region");
  static_assert(sizeof(BlockArgs) <= 4 * (kMeta - kArgs), "the arguments fit their region");
  Slices<Cols, kFar>& g = Slices<Cols, kFar>::of(sm);
  BlockArgs& a = *reinterpret_cast<BlockArgs*>(sm + kArgs);
  unsigned target = 0;                 // thread 0's count of the grid barriers
#pragma unroll 1
  for (int s = 0; s < w.count; ++s) {
    if (s > 0) grid_sync(a0.bar, target, g.P);
    if (threadIdx.x == 0) {
      block_args_of(a, a0, w, w.ids[s]);
      if (s == 0) {
        g.init(a.p, sm, kCuts);
        if constexpr (Slices<Cols, kFar>::kOpenForm)
          g.open_buffers(a0.work + work_words(g.n, g.m, a.p.M, g.P, kCuts, kCheck, kFar) - 1);
      }
    }
    __syncthreads();
    if (a.rec[kRecStop]) continue;     // stopped: every CTA skips it
    grid_block<kCheck, kCuts, Cols, kFar>(a0, a, g, target);
  }
}
template <bool kCheck, bool kCuts, int Cols>
__global__ void __launch_bounds__(kThreads, 1) pdhg_grid_kernel(
    const __grid_constant__ BlockArgs a0, const __grid_constant__ Walk w) {
  walk_blocks<kCheck, kCuts, Cols, false>(a0, w);
}
template <bool kCheck, bool kCuts, int Cols>
__global__ void __launch_bounds__(kThreads, 1) pdhg_grid_far_kernel(
    const __grid_constant__ BlockArgs a0, const __grid_constant__ Walk w) {
  walk_blocks<kCheck, kCuts, Cols, true>(a0, w);
}

// ---- the norm ---------------------------------------------------------------
// CTA b's slices as the block's; the owned entries of the iterate Y and of
// K z's first two blocks in shared memory (the state's first three arrays;
// at 1024 columns Y in the scratch's iterate, and kA, kB recomputed where C
// takes them), the owned entries of y in registers (lane 0 of warp w: entry
// i0 + w), the whole iterate in global memory for the other CTAs.
template <bool kCuts, int Cols, bool kFar>
__device__ __forceinline__ void grid_norm(const NormArgs& L, const NormArgs& a,
                                          const Slices<Cols, kFar>& g, unsigned& target) {
  const Problem& pr = a.p;
  const int n = pr.n, m = pr.m, NN = n * n;
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int &P = g.P, &b = g.b;        // read from the CTA's Slices where used
  const int &e0 = g.e0, &i0 = g.i0, &q0 = g.q0, &q1 = g.q1, &s0 = g.s0, &LA = g.LA, &LB = g.LB;
  float* const scr = g.scr;            // [0, 3) the folded sums, block_sums at [32, 83),
                                       // y at [128, 128 + n)
  float* const sw = g.sw;
  float* const sown = g.sown;
  float* const wY = L.work;            // the iterate after the first iteration
  constexpr bool kG = Slices<Cols, kFar>::kGlobal;
  float* const sY = kG ? wY + e0 : g.state(0);
  float* const skA = g.state(1);       // (not at 1024 columns)
  float* const skB = g.state(2);
  float* const wy = wY + NN;
  float* const wgX = wy + n;
  float* const part = wgX + NN;        // (P, m): CTA b's partial of row q at b m + q
  float* const wkD = part + static_cast<size_t>(P) * m;
  float* const wg = wkD + m;           // with cuts: the weights
  float* const csum = wg + (kCuts ? pr.M : 0);   // (2, P): each CTA's sums of gx^2 and Y^2
  float* const cfin = csum + 2 * P;              // (3, P): each CTA's sums of the last step
  const bool ownx = lane == 0 && warp < LB, owns = kCuts && t < g.LS;
  // the open form: y read where it lies, no copy in the scratch (the start
  // vector, then two buffers in turn, wy and g.xs's fourth n: a power
  // iteration reads y in B and C while C writes the next one), the owned x
  // entries' sums in the scratch (g.xs), lane 0 of warp w taking
  // i0 + w + 16 j
  constexpr bool kO = Slices<Cols, kFar>::kOpenForm;

  if (g.resident && m > 0) g.load_rows(0, m, g.slab);   // the launch's one read of the slice
  cp_async_commit();
  if (m > 0) g.stream_prologue();                      // a stream's first stages
  for (int j = t; j < LA; j += kThreads) sY[j] = a.Y[e0 + j];
  float ry = 0.0f;
  if constexpr (!kO) ry = ownx ? a.y[i0 + warp] : 0.0f;
  if (g.resident && m > 0) cp_async_wait<0>();
  __syncthreads();

  for (int it = 0;; ++it) {
    const bool last = it == L.iters;
    const float* const Yc = it == 0 ? a.Y : wY;
    const float* yc = it == 0 ? a.y : wy;
    if constexpr (kO) {                  // the open form's y of the last iteration, in turn
      if (it > 0 && (it - 1) % 2 == 1) yc = g.xs + 3 * static_cast<size_t>(n);
    }
    // ---- A: the dense rows' partials at the iterate ---------------------------
    if (m > 0) {
      for (int j = t; j < LA; j += kThreads) sown[j] = sY[j];
      if constexpr (kO) {
        for (int i = i0 + t; i < g.i1; i += kThreads) sown[LA + i - i0] = __ldcg(yc + i);
      } else {
        if (ownx) sown[LA + warp] = ry;
      }
      __syncthreads();
      g.shift_weights();
      g.residual_pass(part, m, 1);
      if (!last && !g.resident) g.stream_prologue();   // C's first stages, early
    }
    grid_sync(L.bar, target, P);

    // ---- B: nrm; kD of the owned rows; K's box and cut rows at z -------------
    float fold = 0.0f;                   // warps 0, 1: every CTA's sums of the iterate
    if (it > 0 && warp < 2)
      for (int c = lane; c < P; c += 32) fold += __ldcg(csum + static_cast<size_t>(warp) * P + c);
    float* const sy = scr + 128;
    if constexpr (!kO) {
      for (int i = t; i < n; i += kThreads) sy[i] = __ldcg(yc + i);
    }
    // the rows' K z, unscaled (the far form: in kD's place, by the thread that
    // scales it below)
    float* const kz = kFar ? wkD : g.syD;
    for (int q = q0 + warp; q < q1; q += kThreads / 32) {
      float r = 0.0f;
      for (int c = lane; c < P; c += 32) r += __ldcg(part + static_cast<size_t>(c) * m + q);
      r = warp_sum(r);
      if (lane == 0) kz[q] = r;
    }
    if (it > 0 && warp < 2) {
      fold = warp_sum(fold);
      if (lane == 0) scr[warp] = fold;
    }
    __syncthreads();
    const float nrm = it == 0 ? 1.0f : sqrtf(scr[0] + scr[1]) + 1e-30f;
    float v[3] = {0.0f, 0.0f, 0.0f};     // the last step's kA^2 + kB^2, (kC act)^2, kD^2
    if (lane == 0) {
      for (int q = q0 + warp; q < q1; q += kThreads / 32) {
        const float kd = kz[q] / nrm;
        if (last) {
          v[2] += kd * kd;
        } else {
          wkD[q] = kd;
        }
      }
    }
    if constexpr (kO) {                  // y where it lies
      for (int j = t; j < LA; j += kThreads) {
        const int e = e0 + j, io = e / n, co = e - io * n;
        const float Z = sY[j] / nrm, zi = __ldcg(yc + io) / nrm;
        const float kA = kSA * (zi - Z);
        const float kB = kSB * (Z - zi - __ldcg(yc + co) / nrm);
        v[0] += kA * kA + kB * kB;
      }
    } else {
      for (int j = t; j < LA; j += kThreads) {
        const int e = e0 + j, io = e / n, co = e - io * n;
        const float Z = sY[j] / nrm, zi = sy[io] / nrm;
        const float kA = kSA * (zi - Z);
        const float kB = kSB * (Z - zi - sy[co] / nrm);
        if constexpr (!kG) {
          skA[j] = kA;
          skB[j] = kB;
        }
        v[0] += kA * kA + kB * kB;
      }
    }
    const auto slot_row = [&](int q, const auto& p) {
      // slot q's K row at z, X at its support read from the iterate in
      // global memory, each value divided as the twin's z is
      const int k = p.k;
      const float am = p.act[q];
      float kc = 0.0f;
      if (am != 0.0f) {
        kc = cut_residual_k(
                 k, p.idx + q * k, p.lin + q * k, p.quad + q * k * k,
                 [&](int iu) {
                   if constexpr (kO) {
                     return __ldcg(yc + iu) / nrm;
                   } else {
                     return sy[iu] / nrm;
                   }
                 },
                 [&](int iu, int iv) {
                   return __ldcg(Yc + static_cast<size_t>(iu) * n + iv) / nrm;
                 }) *
             am;
      }
      const float yc_ = kc * am;         // the adjoint's dual, as the twin passes it
      if (last) {
        v[1] += yc_ * yc_;
      } else {
        wg[q] = yc_ * am;
      }
    };
    if constexpr (kFar && kCuts) {
      // the walk over the slots reads the pool's pointers where used (a
      // volatile read of the arguments in shared memory): hoisted out of the
      // walk, they would take registers
      const volatile Problem& vp = pr;
      for (int q = s0 + t; q < g.s1; q += kThreads) slot_row(q, vp);
    } else if (owns) {
      slot_row(s0 + t, pr);
    }
    if (last) {
      block_sums(v, scr + 32, scr + 80);
      if (t < 3) cfin[static_cast<size_t>(t) * P + b] = scr[80 + t];
      grid_sync(L.bar, target, P);
      if (b == 0) {
        if (warp < 3) {
          float r = 0.0f;
          for (int c = lane; c < P; c += 32) r += __ldcg(cfin + static_cast<size_t>(warp) * P + c);
          r = warp_sum(r);
          if (lane == 0) scr[warp] = r;
        }
        __syncthreads();
        if (t == 0) *a.out = sqrtf((scr[0] + scr[1]) + scr[2]) * 1.02f + 1e-12f;
      }
      return;
    }
    // the box rows' part of gx of the owned entries of x: Y is symmetric bit
    // for bit (the start vector is sym(.), and D forms both (i, c) and (c, i)
    // as 0.5 (gX_ic + gX_ci)), so row i of Y is also its column
    float sa = 0.0f, sb = 0.0f, sc = 0.0f;
    if constexpr (kO) {                  // lane 0's sums of its warp's entries to g.xs
      for (int i = i0 + warp; i < g.i1; i += kThreads / 32) {
        const float zi = __ldcg(yc + i) / nrm;
        float ta = 0.0f, tb = 0.0f, tc = 0.0f;
        for (int c = lane; c < n; c += 32) {
          const float zc = __ldcg(yc + c) / nrm, Z = __ldcg(Yc + i * n + c) / nrm;
          ta += kSA * (zi - Z);
          tb += kSB * (Z - zi - zc);
          tc += kSB * (Z - zc - zi);
        }
        ta = warp_sum(ta);
        tb = warp_sum(tb);
        tc = warp_sum(tc);
        if (lane == 0) {
          float* const xs = g.xs;
          xs[i] = ta;
          xs[n + i] = tb;
          xs[2 * n + i] = tc;
        }
      }
    } else {
      if (warp < LB) {
        const int i = i0 + warp;
        const float zi = sy[i] / nrm;
        for (int c = lane; c < n; c += 32) {
          const float zc = sy[c] / nrm, Z = __ldcg(Yc + i * n + c) / nrm;
          sa += kSA * (zi - Z);
          sb += kSB * (Z - zi - zc);
          sc += kSB * (Z - zc - zi);
        }
        sa = warp_sum(sa);
        sb = warp_sum(sb);
        sc = warp_sum(sc);
      }
    }
    grid_sync(L.bar, target, P);

    // ---- C: K^T (kA, kB, kC act, kD) of the owned entries ---------------------
    if constexpr (kFar) {
      g.weights_yD(wkD, 1.0f);
      g.weights_cut(wg);
    } else {
      for (int q = t; q < m; q += kThreads) g.syD[q] = __ldcg(wkD + q);
      if constexpr (kCuts) {
        for (int q = t; q < pr.M; q += kThreads) sw[q] = __ldcg(wg + q);
      }
    }
    __syncthreads();
    if (m > 0) {
      g.adjoint_pass(nullptr, 0, 0, false);      // the dense adjoint into sown[0, E)
      if (!g.resident) g.stream_prologue();      // the next A's first stages
    }
    for (int j = t; j < LA; j += kThreads) {
      const int e = e0 + j;
      float gX;
      if constexpr (kO) {                // B's kA, kB, from the same Y, y and nrm
        const int io = e / n, co = e - io * n;
        const float Z = sY[j] / nrm, zi = __ldcg(yc + io) / nrm;
        const float kA = kSA * (zi - Z);
        const float kB = kSB * (Z - zi - __ldcg(yc + co) / nrm);
        gX = -kSA * kA + kSB * kB;
      } else if constexpr (kG) {         // B's kA, kB, from the same Y, y and nrm
        const int io = e / n, co = e - io * n;
        const float Z = sY[j] / nrm, zi = sy[io] / nrm;
        const float kA = kSA * (zi - Z);
        const float kB = kSB * (Z - zi - sy[co] / nrm);
        gX = -kSA * kA + kSB * kB;
      } else {
        gX = -kSA * skA[j] + kSB * skB[j];
      }
      if constexpr (kCuts) gX = gX + cut_X<kFar>(pr, e, g.cut_weights(sw));
      if (m > 0) gX = gX + sown[j];
      wgX[e] = gX;
    }
    float ss[2] = {0.0f, 0.0f};           // this CTA's sums of gx^2 and Y^2
    if constexpr (kO) {                    // lane 0: its warp's entries in order
      if (lane == 0) {
        // the next y: the buffer this iteration did not read
        float* const ynext = it % 2 == 1 ? g.xs + 3 * static_cast<size_t>(n) : wy;
        for (int i = i0 + warp; i < g.i1; i += kThreads / 32) {
          const float* const xs = g.xs;
          float r = kSA * xs[i] - kSB * (xs[n + i] + xs[2 * n + i]);
          if constexpr (kCuts) r = r + cut_x<kFar>(pr, i, g.cut_weights(sw));
          if (m > 0) r = r + sown[LA + i - i0];
          ynext[i] = r;
          ss[0] += r * r;
        }
      }
    } else if (ownx) {
      const int i = i0 + warp;
      ry = kSA * sa - kSB * (sb + sc);
      if constexpr (kCuts) ry = ry + cut_x<kFar>(pr, i, g.cut_weights(sw));
      if (m > 0) ry = ry + sown[LA + warp];
      wy[i] = ry;
      ss[0] = ry * ry;
    }
    grid_sync(L.bar, target, P);

    // ---- D: the new Y of the owned entries, and the CTA's sums -----------------
    for (int j = t; j < LA; j += kThreads) {
      const int e = e0 + j, io = e / n, co = e - io * n;
      const float y = 0.5f * (__ldcg(wgX + e) + __ldcg(wgX + co * n + io));
      sY[j] = y;
      if constexpr (!kG) wY[e] = y;
      ss[1] += y * y;
    }
    block_sums(ss, scr + 32, scr + 64);
    if (t < 2) csum[static_cast<size_t>(t) * P + b] = scr[64 + t];
  }
}

// The norm's launch: the walk over the instances w.ids as the block's, each
// instance's ||K|| into out[b]; its kernels pdhg_grid_norm_kernel and
// pdhg_grid_far_norm_kernel (the far form).
template <bool kCuts, int Cols, bool kFar>
__device__ __forceinline__ void walk_norms(const NormArgs& a0, const Walk& w) {
  extern __shared__ __align__(16) float sm[];
  static_assert(sizeof(Slices<Cols, kFar>) <= 4 * kArgs, "the Slices fit their region");
  static_assert(sizeof(NormArgs) <= 4 * (kMeta - kArgs), "the arguments fit their region");
  Slices<Cols, kFar>& g = Slices<Cols, kFar>::of(sm);
  NormArgs& a = *reinterpret_cast<NormArgs*>(sm + kArgs);
  unsigned target = 0;                 // thread 0's count of the grid barriers
#pragma unroll 1
  for (int s = 0; s < w.count; ++s) {
    if (s > 0) grid_sync(a0.bar, target, g.P);
    if (threadIdx.x == 0) {
      norm_args_of(a, a0, w, w.ids[s]);
      if (s == 0) {
        g.init(a.p, sm, kCuts);
        if constexpr (Slices<Cols, kFar>::kOpenForm)
          g.open_buffers(a0.work + norm_work_words(g.n, g.m, a.p.M, g.P, kCuts) - 1);
      }
    }
    __syncthreads();
    grid_norm<kCuts, Cols, kFar>(a0, a, g, target);
  }
}
template <bool kCuts, int Cols>
__global__ void __launch_bounds__(kThreads, 1) pdhg_grid_norm_kernel(
    const __grid_constant__ NormArgs a0, const __grid_constant__ Walk w) {
  walk_norms<kCuts, Cols, false>(a0, w);
}
template <bool kCuts, int Cols>
__global__ void __launch_bounds__(kThreads, 1) pdhg_grid_far_norm_kernel(
    const __grid_constant__ NormArgs a0, const __grid_constant__ Walk w) {
  walk_norms<kCuts, Cols, true>(a0, w);
}


// A form's kernels: the block's (kCheck: its checked form) and the norm's,
// pdhg_grid_far_* in the far form (each form's alone instantiated)
template <bool kCheck, bool kCuts, int Cols, bool kFar>
inline auto block_kernel() {
  if constexpr (kFar) {
    return pdhg_grid_far_kernel<kCheck, kCuts, Cols>;
  } else {
    return pdhg_grid_kernel<kCheck, kCuts, Cols>;
  }
}
template <bool kCuts, int Cols, bool kFar>
inline auto norm_kernel() {
  if constexpr (kFar) {
    return pdhg_grid_far_norm_kernel<kCuts, Cols>;
  } else {
    return pdhg_grid_norm_kernel<kCuts, Cols>;
  }
}

// What grid_ctas last computed for a form: the device, the shared bytes,
// the CTAs, and the kernel it was computed for (a static of a function
// template may be one object for every library of a process that defines
// it, such as a build of another checkout loaded beside this one, whose
// kernels would then go without their shared-memory attribute).
template <bool kCuts, int Cols, bool kFar>
struct GridCache {
  static inline int dev = -1, smem = -1, ctas = 0;
  static inline const void* owner = nullptr;
};

// The grid of a form with smem bytes a CTA, into *P: as many CTAs as the
// card holds at once (each SM's share times the SMs) of every kernel of the
// form, the block's two forms and the norm, so that they run one grid and
// their sums one order.  Returns 0, a CUDA error or kErrNoCluster.
template <bool kCuts, int Cols, bool kFar>
int grid_ctas(int smem, int* P) {
  using C = GridCache<kCuts, Cols, kFar>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const void* kernels[3] = {
      reinterpret_cast<const void*>(block_kernel<false, kCuts, Cols, kFar>()),
      reinterpret_cast<const void*>(block_kernel<true, kCuts, Cols, kFar>()),
      reinterpret_cast<const void*>(norm_kernel<kCuts, Cols, kFar>())};
  if (C::dev != dev || C::smem != smem || C::owner != kernels[0]) {
    int fewest = 1 << 30, sms = 0;
    for (const void* kernel : kernels) {
      int per_sm = 0;
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                        static_cast<size_t>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
      fewest = per_sm < fewest ? per_sm : fewest;
    }
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    C::dev = dev;
    C::smem = smem;
    C::ctas = fewest * sms;
    C::owner = kernels[0];
  }
  *P = C::ctas;
  return *P < 1 ? kErrNoCluster : 0;
}

// The cooperative launches of `kernel` (one of the form's) on the form's
// grid that walk the instances ids[0..count) (ids null: 0..count-1),
// kMaxWalk a launch, each launch's barrier counter zeroed first; what a CTA
// owns checked against the form (entries within kMaxE and x entries within
// the warps, in the open form x entries within the threads; but in the far
// form, slots within the threads; the checked form's copy of every CTA's
// distances within the scratch), and the walk's strides against the shape.
// The open form's work holds open_words(n) more floats before the counter.
// *grid receives the CTAs.
template <bool kCuts, int Cols, bool kFar, class Args>
int launch_grid(void (*kernel)(Args, Walk), const Args& a, Walk w, int count, const int* ids,
                int smem, bool distances, int* grid, cudaStream_t st) {
  using F = GridForm<Cols>;
  int P = 0;
  const int err = grid_ctas<kCuts, Cols, kFar>(smem, &P);
  if (err != 0) return err;
  const int n = a.p.n, m = a.p.m;
  const long long NN = static_cast<long long>(n) * n;
  if (Cols == kOpen ? (n + P - 1) / P > kThreads
                    : (NN + P - 1) / P + (n + P - 1) / P > F::kMaxE || (n + P - 1) / P > kThreads / 32)
    return kErrLayout;
  if (kCuts && !kFar && (a.p.M + P - 1) / P > kThreads) return kErrLayout;
  if (distances && 256 + P * kND > F::kScratch) return kErrLayout;
  if (count < 0 || w.ex < 0 || w.eX < 0 || w.sG % 4 || w.sg % 4 ||
      w.sG < static_cast<long long>(m) * n * n || w.sg < static_cast<long long>(m) * n)
    return kErrLayout;
  *grid = P;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.gridDim = dim3(P, 1, 1);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  for (int s0 = 0; s0 < count; s0 += kMaxWalk) {
    w.count = count - s0 < kMaxWalk ? count - s0 : kMaxWalk;
    for (int s = 0; s < w.count; ++s) w.ids[s] = ids == nullptr ? s0 + s : ids[s0 + s];
    cudaError_t e = cudaMemsetAsync(a.bar, 0, sizeof(unsigned), st);
    if (e != cudaSuccess) return static_cast<int>(e);
    e = cudaLaunchKernelEx(&cfg, kernel, a, w);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// A form's three launches at one column width: the block (kCheck: its
// checked form), the norm and the grid, each through launch_grid or
// grid_ctas.
template <bool kCuts, int Cols, bool kFar>
struct FormLaunch {
  static int block(bool checked, const BlockArgs& a, const Walk& w, int count, const int* ids,
                   int smem, int* grid, cudaStream_t st) {
    return checked ? launch_grid<kCuts, Cols, kFar>(block_kernel<true, kCuts, Cols, kFar>(), a,
                                                    w, count, ids, smem, true, grid, st)
                   : launch_grid<kCuts, Cols, kFar>(block_kernel<false, kCuts, Cols, kFar>(), a,
                                                    w, count, ids, smem, false, grid, st);
  }
  static int norm(const NormArgs& a, const Walk& w, int B, int smem, int* grid,
                  cudaStream_t st) {
    return launch_grid<kCuts, Cols, kFar>(norm_kernel<kCuts, Cols, kFar>(), a, w, B, nullptr,
                                          smem, false, grid, st);
  }
  static int ctas(int smem, int* P) { return grid_ctas<kCuts, Cols, kFar>(smem, P); }
};

// a form's launches at cols (one of the four widths up to 1024; the 2048-
// column forms go through vast_call)
template <bool kCuts, bool kFar, class Fn>
int at_width(int cols, Fn fn) {
  switch (cols) {
    case kNarrow: return fn(FormLaunch<kCuts, kNarrow, kFar>{});
    case kWide: return fn(FormLaunch<kCuts, kWide, kFar>{});
    case kWidest: return fn(FormLaunch<kCuts, kWidest, kFar>{});
    default: return fn(FormLaunch<kCuts, kHuge, kFar>{});
  }
}

// What pdhg_grid.cu's entry points ask of a form built in a translation
// unit of its own (the far forms; the 2048-column forms): a launch of its
// block, checked block or norm, or its grid, at column width cols.
struct FarCall {
  enum Op { kBlock, kChecked, kNorm, kCtas } op;
  int cols;
  const BlockArgs* block;          // kBlock, kChecked
  const NormArgs* norm;            // kNorm
  Walk w;
  int count;                       // the instances (kNorm: B)
  const int* ids;
  int smem;
  int* grid;                       // the CTAs (kCtas: P)
  cudaStream_t st;
};
template <class Form>
int call_form(Form form, const FarCall& c) {
  switch (c.op) {
    case FarCall::kBlock:
    case FarCall::kChecked:
      return form.block(c.op == FarCall::kChecked, *c.block, c.w, c.count, c.ids, c.smem, c.grid,
                        c.st);
    case FarCall::kNorm: return form.norm(*c.norm, c.w, c.count, c.smem, c.grid, c.st);
    default: return form.ctas(c.smem, c.grid);
  }
}
template <bool kCuts>
int far_call(const FarCall& c) {
  return at_width<kCuts, true>(c.cols, [&](auto form) { return call_form(form, c); });
}
// the 2048-column form (Cols = kVast) or the open form (kOpen), its
// replicas in shared memory or (far) not
template <bool kCuts, int Cols>
int wide_call(const FarCall& c, bool far) {
  return far ? call_form(FormLaunch<kCuts, Cols, true>{}, c)
             : call_form(FormLaunch<kCuts, Cols, false>{}, c);
}
// far_call<true> and far_call<false>, wide_call at kVast and at kOpen with
// cuts and without, each in a translation unit of its own
// (pdhg_grid_far.cu, pdhg_grid_far_cert.cu, pdhg_grid_vast.cu,
// pdhg_grid_vast_cert.cu, pdhg_grid_open.cu, pdhg_grid_open_cert.cu), built
// in parallel with pdhg_grid.cu's forms
int far_cuts(const FarCall& c);
int far_cert(const FarCall& c);
int vast_cuts(const FarCall& c, bool far);
int vast_cert(const FarCall& c, bool far);
int open_cuts(const FarCall& c, bool far);
int open_cert(const FarCall& c, bool far);

}  // namespace pdhg_grid
