// The dense-row route of the PDHG solve, K7: the SDP certifier's LP
// (loop/sdp_bound.py), whose pool holds no cut and whose m dense rows (the
// eigencuts, up to the buffer's capacity, 2048 by default) do not fit K2's
// shared memory.  Float32, for the one instance:
//
//   the block  `iters` iterations of lp/pdhg.py::_one_iter with an empty
//       pool, every iterate added to the ergodic sums; tau, sigma and the
//       stop flag from the solve's control record (pdhg_common.cuh), as K2
//       (pdhg_block.cu) reads them.  Two launch plans by shape (below):
//       pdhg_dense_cta_kernel and pdhg_dense_grid_kernel.  Twin:
//       pdhg_block_plain.  Steering launches it alone.
//   the checked block (K7c)  the solve's step: the same kernels in their
//       checked form (kCheck), whose epilogue is the checked block's control
//       as K5 (pdhg_check.cuh) does it after K2: both KKT errors with the
//       dense residuals, the current-or-average choice, restart, omega, the
//       stop test and the next steps, into the record, on the slices each
//       CTA owns.  Twin: pdhg_block_steps_plain then pdhg_check_plain.
//   the norm (K7n)  ||K|| by `iters` power iterations in one launch, as K6
//       (pdhg_norm.cu), on the block's plans: pdhg_dense_norm_cta_kernel and
//       pdhg_dense_norm_grid_kernel.  Twin: estimate_norm_plain.
//
// The reference runs this LP in XLA: its Pallas kernel refuses dense rows
// (sdpcutsel_tpu/lp/pdhg.py:291-301), so its lax.while_loop iterates the plain
// _one_iter (run_block, :216), checks in checked_block (:224) and estimates
// ||K|| in estimate_norm (:71).  No Pallas kernel stands behind these three.
//
// What bounds it on the H100: the dense rows.  An iteration reads G (m n^2
// floats) twice, once for the adjoint sum_q yD_q G_q and once for the
// residuals <G_q, Xb>, which cannot share a pass: the residuals need the
// primal step that the adjoint feeds.  At n = 125, m = 368 that is 46 MB an
// iteration (13.7 us at 3.35 TB/s; G fits the 50 MB L2), at m = 2048 256 MB
// (76 us).  Everything else is K2's n^2 work, well under a microsecond.  One
// SM streams G at 20-35 GB/s (PERF.md section 6: a cluster of 16 reached
// ~0.5 TB/s), so the block's "grid" plan streams it on every SM, and its "cta"
// plan, for the small sandwiches, keeps it in one SM's shared memory.  The
// check needs no primal step: each of its two points takes one pass over G
// for its adjoint and its residuals together.
//
// The norm runs on the block's launch plan and layout (block_plan): a power
// iteration is the block's two passes over G with other weights, the
// residual pass <G_q, Z> + g_q . z for K z's dense part and the adjoint
// sum_q kD_q [G_q | g_q] for K^T's.  "cta" stages G once and runs every
// iteration in one SM; "grid" runs the passes of the block's GridCta over
// each CTA's resident or streamed slice, three grid barriers a power
// iteration (pdhg_dense_norm_grid_kernel).  No atomics and one fixed order
// for every sum, so a launch repeats bit for bit; the twins sum in torch's
// order and agree to rounding.
//
// The pool: the certifier's is one slot of width 1 that nothing fills, so the
// kernels leave yC and its sum as they are (0, as the twin keeps them: its
// cut rows are all inactive).

#include "pdhg_common.cuh"
#include "pdhg_stream.cuh"

namespace {

using namespace pdhg;

// ---- the block ------------------------------------------------------------
// Two launch plans, chosen by shape (lp/pdhg_dense.py::block_plan):
//
//   "cta"   n <= kCtaMaxN and the whole problem in one CTA's shared memory:
//           G and g are staged there once per launch (cp.async), and each
//           iteration reads them from shared memory, with block barriers only.
//   "grid"  every other shape: one CTA on each SM the card co-schedules
//           (cudaOccupancyMaxActiveBlocksPerMultiprocessor x SMs), launched
//           cooperatively, so that the grid barrier below cannot hang.  CTA b
//           owns a slice of the entries of X and of x ([e0, e1), [i0, i1): E
//           entries, at most kMaxE: one entry of X a thread), keeps their
//           state and sums in registers, and owns a
//           slice of the dense rows [q0, q1).  Both passes over G run over
//           the CTA's own entries: the rows' segments of its slice, G_q[e0,
//           e1) and g_q[i0, i1) for every q, stay in its shared memory for
//           the launch where they fit (the slice is read from device memory
//           once), and stream through a ring of 16-byte cp.async stages
//           otherwise.  An iteration:
//     I    yD to shared memory; the adjoint sum_q yD_q [G_q | g_q] of the
//          owned entries (q in increasing order a strand, strands summed in
//          order); S = X - tau (cX - gX) of the owned entries of X to global
//          memory; the x step of the owned entries of x (row sums of yA, yB
//          and the column sum of yB read from global memory in order), xb to
//          global memory;                                   grid barrier 1
//    II    X = clip(sym(S)), Xb, the dual ascent on yA, yB of the owned
//          entries; each row's partial <G_q, Xb> + g_q . xb over them, to
//          global memory (P m partials);                    grid barrier 2
//   III    the owners of the rows sum their rows' P partials in CTA order,
//          step yD_q and its sum;                           grid barrier 3.
//
// No atomics in any sum (the barrier's arrival counter is no sum), and one
// fixed order for each, so a launch repeats bit for bit.
//
// The "grid" kernels take the column width Cols of pdhg_common.cuh (128 for
// n <= 128, 256 up to n = 256) as a template parameter: it sets how many
// columns a lane sums for a row of x (Cols / 32) and the entries a CTA may
// own (GridWidth::kMaxE), so that at n = 256 the 132 CTAs of the H100 take
// X's 65,536 entries (497 a CTA at most).  The narrow form keeps its layout.
//
// The checked form (kCheck, the solve's step) then runs the check on the
// same layout.  "grid": the state and sums stored;             grid barrier
//   for the current iterate, then the average: its yD into shared memory
//   (the adjoint's weights) and its owned [X | x] (the residual's, by
//   shift), one pass over the owned segments (resident, or streamed once
//   more) for the adjoint and the rows' partials together; M = cX - gX of
//   the owned entries and the partials to global memory (work_words);
//   the objective, dual-bound and infeasibility terms;        grid barrier
//   the M + M^T terms, the owned rows' residuals (partials in CTA order);
//   each CTA's sums to global memory;                          grid barrier
//   every CTA folds the sums in CTA order and decides alike; on a restart
//   each CTA copies its own slices and sends its distances;    grid barrier
//   CTA 0 writes the record.  "cta": the same on the state in shared
//   memory, with block barriers only, before the exit's stores.

constexpr int kCtaMaxN = 32;     // the "cta" plan's largest n
constexpr int kRowJ = 16;        // the "cta" plan's residual: entries a lane in registers
constexpr int kStage = 8192;     // floats a ring stage (the "grid" plan's stream)
constexpr int kStages = 4;       // stages in flight
constexpr int kScratch = 2048;   // strand partials (<= 4 kThreads), weights (<= 4 (kMaxE + 12))
constexpr int kSmemWords = 232448 / 4;   // the "grid" plan takes a CTA's whole shared memory

// The "grid" plan at column width Cols: kMaxE, the entries (of X and x) a
// CTA may own: at most one entry of X a thread, and its rows' spans (kMaxE +
// 12 floats at most) in at most 128 chunks of 4, which keeps 4 adjoint
// strands and kScratch's weights.  The narrow form's 496 is its first value.
template <int Cols>
struct GridWidth {
  static_assert(Cols == kNarrow || Cols == kWide, "the dense route's widths are 128 and 256");
  static constexpr int kMaxE = Cols == kNarrow ? 496 : 500;
  static_assert(4 * (kMaxE + 12) <= kScratch && kMaxE + 12 <= 4 * 128, "spans over 128 chunks");
};

struct BlockArgs {
  int n, m, iters;
  int* rec;                              // the solve's control record (the checked form
                                         // writes it)
  const float *cx, *cX, *G, *g, *h;
  // inputs: x, X, yA, yB, yD, then the sums ax, aX, aA, aB, ayD
  const float *x, *X, *yA, *yB, *yD, *ax, *aX, *aA, *aB, *ayD;
  // outputs, in the same order (may be the inputs)
  float *xo, *Xo, *yAo, *yBo, *yDo, *axo, *aXo, *aAo, *aBo, *ayDo;
  float* work;                           // grid plan: work_layout
  unsigned* bar;                         // grid plan: the barrier's counter
  // the checked form: the restart anchor x, X, yA, yB, yD and the check's
  // arguments (iters is its check_every)
  float *zx, *zX, *zA, *zB, *zD;
  int restart_period, max_iters;
  float tol;
};

// ---- the check (K7c), the epilogue of the checked form of both plans -----
// After the block's last iteration, what pdhg_check.cuh does after K2's
// (lp/pdhg.py pdhg_check_plain is the twin), on the dense rows:
// wlen += check_every, avg = acc / wlen; the KKT error of the current
// iterate (P = 0) and of the average (P = 1), the two points in turn, each
// through one pass over G that serves both its adjoint sum_q yD_q [G_q |
// g_q] (the strands' order of the block's adjoint) and its rows' residuals
// <G_q, X> + g_q . x; the choice, restart (each CTA copies its own slices
// of the candidate into the state and the anchor and zeroes its sums),
// omega, the stop test and the next steps into the record (write_record).
// Each CTA's partial sums are folded in CTA order, as the block folds its
// rows, so every CTA decides alike.

constexpr int kNV = 8;     // partial sums per evaluation point
enum { kPX, kPx, kHyB, kHyD, kRxm, kSm, kV2, kVD2 };

// The grid plan's global scratch (work), in floats: the block's S (n n), xb
// (n) and row partials (P m); the checked form adds M at the average (n n;
// the current point's takes S's place), the average's row partials (P m),
// each CTA's sums (P 2 kNV) and distances (P kND); then the barrier's
// counter.  lp/pdhg_dense.py::_work_words mirrors it.
__host__ __device__ inline size_t work_words(int n, int m, int P, bool checked) {
  const size_t NN = static_cast<size_t>(n) * n, Pm = static_cast<size_t>(P) * m;
  return NN + n + Pm + (checked ? NN + Pm + static_cast<size_t>(P) * (2 * kNV + kND) : 0) + 1;
}

// The norm's "grid" scratch (work), in floats: the iterate Y (n n) and y
// (n), gX (n n), the rows' partials (P m), kD (m), each CTA's two sums of
// the iterate and two of the last step (4 P); then the barrier's counter.
// lp/pdhg_dense.py::_norm_work_words mirrors it.
inline size_t norm_work_words(int n, int m, int P) {
  const size_t NN = static_cast<size_t>(n) * n, Pm = static_cast<size_t>(P) * m;
  return 2 * NN + n + Pm + m + 4 * static_cast<size_t>(P) + 1;
}

// ---- "grid" ---------------------------------------------------------------

// Offsets, in 4-byte words, of one CTA's dynamic shared memory at column
// width Cols: the slab (the owned segments of G's rows, resident or a ring
// of stages) takes what the rest leaves of kSmemWords, and at least the
// ring.  lp/pdhg_dense.py::_block_words mirrors the sum; the launch checks
// it.
struct GridLayout {
  int scr;       // (kScratch,) the adjoint's window partials; then the residual's weights
  int slab;      // the rows' owned segments, resident or streamed
  int yD;        // (m,) replica of yD
  int own;       // (kMaxE,) the adjoint of the owned entries; then their [Xb | xb]
  int words;
};

template <int Cols>
__host__ __device__ inline GridLayout grid_layout(int n, int m) {
  constexpr int kMaxE = GridWidth<Cols>::kMaxE;
  const int rest = kScratch + m + kMaxE;
  const int free4 = (kSmemWords - rest) & ~3;
  GridLayout L;
  int o = 0;
#define TAKE(field, words) L.field = o; o += (words)
  TAKE(scr, kScratch);
  TAKE(slab, free4 > kStages * kStage ? free4 : kStages * kStage);
  TAKE(yD, m);
  TAKE(own, kMaxE);
#undef TAKE
  L.words = o;
  (void)n;
  return L;
}

// A CTA's slices of the "grid" plan and the passes over them, shared by the
// block, its check and the norm (Args: BlockArgs or NormArgs, whose G and g
// it reads): CTA b's entries of X [e0, e1), of x [i0, i1) and rows
// [q0, q1); the rows' owned segments, row q's G_q[e0, e1) and g_q[i0, i1),
// each as the 16-byte-aligned span that holds it (SA, SB floats: ca, cb
// chunks of 4), ES floats a row.  Entry j of G's part sits at span position
// shA(q) + j, of g's part at SA + shB(q) + j.  Cols: the column width.
template <class Args, int Cols>
struct GridCta {
  const Args* a;
  int n, m, NN, P, b, t;
  int e0, e1, i0, i1, q0, q1, LA, LB, E;
  int SA, SB, ES, ca, cr;
  bool resident;
  int QB, nst;
  int NS, st, ct;               // the adjoint's lanes: chunk ct of strand st (rows q = st mod NS)
  int RL, RG, rg, rl;           // the residuals' lanes: RL a row, group rg of RG
  float *scr, *slab, *syD, *sown;

  __device__ __forceinline__ GridCta(const Args& args, float* sm) : a(&args) {
    n = args.n;
    m = args.m;
    NN = n * n;
    P = static_cast<int>(gridDim.x);
    b = static_cast<int>(blockIdx.x);
    t = threadIdx.x;
    const GridLayout L = grid_layout<Cols>(n, m);
    scr = sm + L.scr;
    slab = sm + L.slab;
    syD = sm + L.yD;
    sown = sm + L.own;
    slice(NN, b, P, e0, e1);
    slice(n, b, P, i0, i1);
    slice(m, b, P, q0, q1);
    LA = e1 - e0;
    LB = i1 - i0;
    E = LA + LB;
    SA = LA > 0 ? (LA + 6) & ~3 : 0;
    SB = LB > 0 ? (LB + 6) & ~3 : 0;
    ES = SA + SB;
    ca = SA / 4;
    cr = ES / 4;
    resident = static_cast<long long>(m) * ES <= L.yD - L.slab;
    QB = ES > 0 ? kStage / ES : m;
    nst = resident || m == 0 ? 0 : (m + QB - 1) / QB;
    // NS is a multiple of 4, so a strand's rows share their shift
    NS = cr > 0 ? (kThreads / cr) & ~3 : 0;
    st = cr > 0 ? t / cr : 0;
    ct = cr > 0 ? t % cr : 0;
    RL = 1;                     // the least power of two with at most 4 chunks a lane
    while (RL < 32 && RL * 4 < cr) RL <<= 1;
    RG = kThreads / RL;
    rg = t / RL;
    rl = t % RL;
  }
  __device__ __forceinline__ int shA(int q) const { return ((q & 3) * (NN & 3) + e0) & 3; }
  __device__ __forceinline__ int shB(int q) const { return ((q & 3) * (n & 3) + i0) & 3; }

  // copy rows [qs, qs + nq) into dst: 16-byte copies (4-byte at the arrays'
  // ends); a chunk past its segment, or past the array, holds zeros
  __device__ __forceinline__ void load_rows(int qs, int nq, float* dst) const {
    const size_t totG = static_cast<size_t>(m) * NN, totg = static_cast<size_t>(m) * n;
    for (int p = t; p < nq * cr; p += kThreads) {
      const int ql = p / cr, c = p - ql * cr;
      const size_t q = static_cast<size_t>(qs + ql);
      const bool inA = c < ca;
      const size_t s0 = inA ? q * NN + e0 : q * n + i0;
      const size_t start = (s0 & ~static_cast<size_t>(3)) + 4 * (inA ? c : c - ca);
      const size_t end = s0 + (inA ? LA : LB), tot = inA ? totG : totg;
      const float* base = inA ? a->G : a->g;
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
  // weights syD: span positions 4 ct + u of the strand's rows, in increasing q
  __device__ __forceinline__ void adjoint(float (&acc)[4], int qs, int nq, const float* buf) const {
    if (st >= NS) return;
    for (int ql = ((st - qs % NS) % NS + NS) % NS; ql < nq; ql += NS) {
      const float w = syD[qs + ql];
      const float4 v = lds4(buf + ql * ES + 4 * ct);
      acc[0] = fmaf(w, v.x, acc[0]);
      acc[1] = fmaf(w, v.y, acc[1]);
      acc[2] = fmaf(w, v.z, acc[2]);
      acc[3] = fmaf(w, v.w, acc[3]);
    }
  }
  // entry j of a part sits at span position sh + j of each strand's rows:
  // the strands' sums, in strand order, into sown[0, E)
  __device__ __forceinline__ void strand_sums(const float (&acc)[4]) const {
    if (st < NS) {
#pragma unroll
      for (int u = 0; u < 4; ++u) scr[(st * cr + ct) * 4 + u] = acc[u];
    }
    __syncthreads();
    for (int j = t; j < E; j += kThreads) {
      const bool inA = j < LA;
      const int jj = inA ? j : j - LA, cbase = inA ? 0 : ca;
      float sum = 0.0f;
      for (int r = 0; r < NS; ++r) {
        const int p = jj + (inA ? shA(r) : shB(r));
        sum += scr[(r * cr + cbase + p / 4) * 4 + (p & 3)];
      }
      sown[j] = sum;
    }
    __syncthreads();
  }
  // the residual's weights by shift, from the owned entries' values in
  // sown[0, E): span position p of a row of shift s takes the value at its
  // entry, 0 off the segment
  __device__ __forceinline__ void shift_weights() const {
    for (int p = t; p < 4 * ES; p += kThreads) {
      const int s = p / ES, pp = p - s * ES;
      float w = 0.0f;
      if (pp < SA) {
        if (pp - s >= 0 && pp - s < LA) w = sown[pp - s];
      } else if (pp - SA - s >= 0 && pp - SA - s < LB) {
        w = sown[LA + pp - SA - s];
      }
      scr[p] = w;
    }
    __syncthreads();
  }
  // each row's partial over the owned entries, RL lanes a row (a butterfly;
  // the same trip count in every lane: rows past nq redo the last, unstored),
  // into out[b bs + q qs_]
  __device__ __forceinline__ void residual(float* out, size_t bs, size_t qs_, int qs, int nq,
                                           const float* buf) const {
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
};

// The check (K7c) after the block's last iteration, over the grid; the
// block's final state and sums of the CTA's owned entries come in registers
// (rX ... rax), the rest from global memory, where the block has stored it.
template <int Cols>
__device__ __forceinline__ void grid_check(const BlockArgs& a, unsigned target, float rX, float rA,
                                        float rB, float raX, float raA, float raB, float rcX,
                                        float rx, float rax) {
  extern __shared__ __align__(16) float sm[];
  const GridCta<BlockArgs, Cols> g(a, sm);
  const int n = a.n, m = a.m, NN = n * n, P = g.P, b = g.b, t = g.t;
  const int lane = t % 32, warp = t / 32;
  const int i0 = g.i0, q0 = g.q0, q1 = g.q1, LA = g.LA, LB = g.LB, nst = g.nst, QB = g.QB;
  const bool resident = g.resident;
  const bool own = t < LA;
  const int eo = g.e0 + t, io = eo / n, co = eo - io * n;
  float* const scr = g.scr;
  float* const slab = g.slab;
  float* const syD = g.syD;
  float* const sown = g.sown;
  float* const S = a.work;
  float* const part = a.work + NN + n;
  auto issue = [&](int s, float* dst) { g.issue(s, dst); };
  // ---- the check (K7c) over the grid ----------------------------------------
  int* const rec = a.rec;
  const int wlen = rec[kRecWlen] + a.iters;
  const float inv = 1.0f / static_cast<float>(wlen);
  float* const Mq[2] = {S, a.work + work_words(n, m, P, false) - 1};   // M = cX - gX
  float* const partq[2] = {part, Mq[1] + NN};          // rows' partials, (m, P) each
  float* const csum = partq[1] + static_cast<size_t>(P) * m;            // (2 kNV, P)
  float* const cdist = csum + static_cast<size_t>(P) * 2 * kNV;         // (kND, P)
  float rM[2] = {0.0f, 0.0f};          // M of the owned entry of X at each point
  grid_sync(a.bar, target, P);         // the state, the sums and yD in global memory

#pragma unroll
  for (int pt = 0; pt < 2; ++pt) {
    const float sc = pt == 0 ? 1.0f : inv;
    const float* const pyD = pt == 0 ? a.yDo : a.ayDo;
    const float* const px = pt == 0 ? a.xo : a.axo;
    const float* const pyA = pt == 0 ? a.yAo : a.aAo;
    const float* const pyB = pt == 0 ? a.yBo : a.aBo;
    // the point's yD (the adjoint's weights) and its owned [X | x] (the
    // residuals' weights, by shift)
    for (int q = t; q < m; q += kThreads) syD[q] = __ldcg(pyD + q) * sc;
    if (own) sown[t] = (pt == 0 ? rX : raX) * sc;
    if (lane == 0 && warp < LB) sown[LA + warp] = (pt == 0 ? rx : rax) * sc;
    __syncthreads();
    g.shift_weights();
    // one pass over G: the adjoint of the owned entries, the rows' partials
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (resident) {
      g.adjoint(acc, 0, m, slab);
      g.residual(partq[pt], 1, P, 0, m, slab);
      __syncthreads();                 // every lane done with the weights in scr
    } else {
      ring_prologue<kStage, kStages>(slab, nst, issue);
      ring_drain<kStage, kStages>(slab, nst, issue, [&](int s, const float* buf) {
        g.adjoint(acc, s * QB, min(QB, m - s * QB), buf);
        g.residual(partq[pt], 1, P, s * QB, min(QB, m - s * QB), buf);
      });
    }
    g.strand_sums(acc);
    // the owned entry of X: M = cX - gX to the transposes' readers, the
    // objective, the dual bound's yB term and K z's infeasibility
    float v[kNV];
#pragma unroll
    for (int j = 0; j < kNV; ++j) v[j] = 0.0f;
    if (own) {
      const float Xv = (pt == 0 ? rX : raX) * sc;
      const float va = (pt == 0 ? rA : raA) * sc, vb = (pt == 0 ? rB : raB) * sc;
      const float gX = (-kSA * va + kSB * vb) + sown[t];
      rM[pt] = rcX - gX;
      Mq[pt][eo] = rM[pt];
      v[kPX] += rcX * Xv;
      v[kHyB] += vb;
      const float xi = __ldcg(px + io) * sc, xc = __ldcg(px + co) * sc;
      const float kA = kSA * (xi - Xv);
      const float kB = kSB * (Xv - xi - xc);
      const float vA = fmaxf(-kA, 0.0f), vB = fmaxf(-kSB - kB, 0.0f);
      v[kV2] += vA * vA + vB * vB;
    }
    // the owned entries of x: gx from the point's row and column sums
    if (warp < LB) {
      const int i = i0 + warp;
      float sa = 0.0f, sb = 0.0f, sc2 = 0.0f;
#pragma unroll
      for (int j = 0; j < Cols / 32; ++j) {       // every load issued, then the sums in order
        const int c = lane + 32 * j, cc = min(c, n - 1);
        const float ya = __ldcg(pyA + i * n + cc), yb = __ldcg(pyB + i * n + cc),
                    yc = __ldcg(pyB + cc * n + i);
        if (c < n) {
          sa += ya * sc;
          sb += yb * sc;
          sc2 += yc * sc;
        }
      }
      sa = warp_sum(sa);
      sb = warp_sum(sb);
      sc2 = warp_sum(sc2);
      if (lane == 0) {
        const float gx = (kSA * sa - kSB * (sb + sc2)) + sown[LA + warp];
        v[kRxm] += fminf(a.cx[i] - gx, 0.0f);
        v[kPx] += a.cx[i] * ((pt == 0 ? rx : rax) * sc);
      }
    }
    block_sums(v, scr, scr + (kThreads / 32) * kNV);
    if (t == kPX || t == kPx || t == kHyB || t == kRxm || t == kV2)
      csum[static_cast<size_t>(pt * kNV + t) * P + b] = scr[(kThreads / 32) * kNV + t];
  }
  grid_sync(a.bar, target, P);         // every M and every row's partials

  // the dual bound's M + M^T term, and the owned rows' residuals
  {
    float v[2 * kNV];
#pragma unroll
    for (int j = 0; j < 2 * kNV; ++j) v[j] = 0.0f;
#pragma unroll
    for (int pt = 0; pt < 2; ++pt) {
      const float sc = pt == 0 ? 1.0f : inv;
      const float* const pyD = pt == 0 ? a.yDo : a.ayDo;
      if (own) v[pt * kNV + kSm] += fminf(rM[pt] + __ldcg(Mq[pt] + co * n + io), 0.0f);
      for (int q = q0 + warp; q < q1; q += kThreads / 32) {
        float r = 0.0f;
        for (int c = lane; c < P; c += 32) r += __ldcg(partq[pt] + static_cast<size_t>(q) * P + c);
        r = warp_sum(r);
        if (lane == 0) {
          const float vD = fmaxf(a.h[q] - r, 0.0f);
          v[pt * kNV + kVD2] += vD * vD;
          v[pt * kNV + kHyD] += a.h[q] * (__ldcg(pyD + q) * sc);
        }
      }
    }
    block_sums(v, scr, scr + (kThreads / 32) * 2 * kNV);
    if (t < 2 * kNV) {
      const int j = t % kNV;
      if (j == kSm || j == kVD2 || j == kHyD)
        csum[static_cast<size_t>(t) * P + b] = scr[(kThreads / 32) * 2 * kNV + t];
    }
  }
  grid_sync(a.bar, target, P);         // every CTA's sums

  // every CTA folds the sums in CTA order (warp j the j-th) and decides alike
  float* const tot = scr;                        // (2 kNV) the sums, then the decision
  if (warp < 2 * kNV) {
    float r = 0.0f;
    for (int c = lane; c < P; c += 32) r += __ldcg(csum + static_cast<size_t>(warp) * P + c);
    r = warp_sum(r);
    if (lane == 0) tot[warp] = r;
  }
  __syncthreads();
  float* const dec = scr + 2 * kNV;              // err, p, d of both points; use_avg
  if (t == 0) {
    for (int pt = 0; pt < 2; ++pt) {
      const float* s = tot + pt * kNV;
      const float p = s[kPx] + s[kPX];
      const float hy = -kSB * s[kHyB] + s[kHyD];
      const float d = (hy + s[kRxm]) + 0.5f * s[kSm];
      const float infeas = sqrtf(s[kV2] + s[kVD2]);
      dec[3 * pt] = infeas + fmaxf(p - d, 0.0f);
      dec[3 * pt + 1] = p;
      dec[3 * pt + 2] = d;
    }
    dec[6] = dec[3] < dec[0] ? 1.0f : 0.0f;
  }
  __syncthreads();
  const bool use_avg = dec[6] != 0.0f;
  const bool restart = use_avg || wlen >= a.restart_period;
  if (restart) {
    // the candidate into the state and the anchor, the sums zeroed, each
    // CTA its own slices; the distances from the anchor
    const float csc = use_avg ? inv : 1.0f;
    float dv[kND];
#pragma unroll
    for (int j = 0; j < kND; ++j) dv[j] = 0.0f;
    if (own) {
      const float X = (use_avg ? raX : rX) * csc, A = (use_avg ? raA : rA) * csc,
                  B = (use_avg ? raB : rB) * csc;
      const float eX = X - a.zX[eo], eA = A - a.zA[eo], eB = B - a.zB[eo];
      dv[kDX] += eX * eX;
      dv[kDA] += eA * eA;
      dv[kDB] += eB * eB;
      a.Xo[eo] = X;
      a.yAo[eo] = A;
      a.yBo[eo] = B;
      a.zX[eo] = X;
      a.zA[eo] = A;
      a.zB[eo] = B;
      a.aXo[eo] = 0.0f;
      a.aAo[eo] = 0.0f;
      a.aBo[eo] = 0.0f;
    }
    if (lane == 0 && warp < LB) {
      const int i = i0 + warp;
      const float x = (use_avg ? rax : rx) * csc, e = x - a.zx[i];
      dv[kDx] += e * e;
      a.xo[i] = x;
      a.zx[i] = x;
      a.axo[i] = 0.0f;
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
    grid_sync(a.bar, target, P);       // every CTA's distances
    if (b == 0) {
      float* const dist = scr + 256;   // (P, kND), in CTA order
      for (int j = t; j < P * kND; j += kThreads)
        dist[j] = __ldcg(cdist + static_cast<size_t>(j % kND) * P + j / kND);
      __syncthreads();
    }
  }
  // ---- the record, by CTA 0 -------------------------------------------------
  if (b == 0 && t == 0)
    write_record(rec, dec, use_avg, restart, wlen, scr + 256, P, a.iters, a.max_iters, a.tol);
}

template <bool kCheck, int Cols>
__global__ void __launch_bounds__(kThreads, 1) pdhg_dense_grid_kernel(
    const __grid_constant__ BlockArgs a) {
  extern __shared__ __align__(16) float sm[];
  if (a.rec[kRecStop]) return;        // stopped: every CTA leaves before any barrier
  const float tau = __int_as_float(a.rec[kRecTau]), sigma = __int_as_float(a.rec[kRecSigma]);
  const int n = a.n, m = a.m, NN = n * n;
  const int P = static_cast<int>(gridDim.x), b = static_cast<int>(blockIdx.x);
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const GridCta<BlockArgs, Cols> g(a, sm);
  float* const slab = g.slab;
  float* const syD = g.syD;
  float* const sown = g.sown;
  float* const S = a.work;
  float* const xb = a.work + NN;
  float* const part = a.work + NN + n;   // (P, m): CTA b's partial of row q at b m + q
  unsigned target = 0;
  const int e0 = g.e0, i0 = g.i0, q0 = g.q0, q1 = g.q1, LA = g.LA, LB = g.LB, E = g.E;
  const bool resident = g.resident;
  const int QB = g.QB, nst = g.nst;
  auto issue = [&](int s, float* dst) { g.issue(s, dst); };

  if (resident) g.load_rows(0, m, slab);   // the launch's one read of the slice
  cp_async_commit();
  ring_prologue<kStage, kStages>(slab, a.iters > 0 ? nst : 0, issue);

  // ---- the owned entry of X of thread t, e0 + t: its state and sums in
  //      registers ------------------------------------------------------------
  const bool own = t < LA;
  const int eo = e0 + t, io = eo / n, co = eo - io * n;
  float rX = own ? a.X[eo] : 0.0f, rA = own ? a.yA[eo] : 0.0f, rB = own ? a.yB[eo] : 0.0f;
  float raX = own ? a.aX[eo] : 0.0f, raA = own ? a.aA[eo] : 0.0f, raB = own ? a.aB[eo] : 0.0f;
  const float rcX = own ? a.cX[eo] : 0.0f;
  float rS = 0.0f;
  // the owned entries of x: lane 0 of warp w holds entry i0 + w, and the row
  // sums of yA, yB and the column sum of yB that its next x step takes
  float rx = 0.0f, rax = 0.0f, rsa = 0.0f, rsb = 0.0f, rsc = 0.0f;
  auto x_sums = [&](const float* yA, const float* yB) {
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
  };
  if (lane == 0 && warp < LB) {
    rx = a.x[i0 + warp];
    rax = a.ax[i0 + warp];
  }
  x_sums(a.yA, a.yB);
  if (a.yDo != a.yD) {                   // the owned rows' yD and its sum into the outputs
    for (int q = q0 + t; q < q1; q += kThreads) {
      a.yDo[q] = a.yD[q];
      a.ayDo[q] = a.ayD[q];
    }
  }

  auto adjoint = [&](float (&acc)[4], int qs, int nq, const float* buf) {
    g.adjoint(acc, qs, nq, buf);
  };
  auto residual = [&](float* out, size_t bs, size_t qs_, int qs, int nq, const float* buf) {
    g.residual(out, bs, qs_, qs, nq, buf);
  };
  if (resident) cp_async_wait<0>();      // the slice; a stream's first stages stay in flight
  __syncthreads();

  for (int it = 0; it < a.iters; ++it) {
    const float* yDc = it == 0 ? a.yD : a.yDo;    // the last iteration's yD
    // ---- I: the adjoint of the owned entries ---------------------------------
    for (int q = t; q < m; q += kThreads) syD[q] = __ldcg(yDc + q);
    __syncthreads();
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (resident) {
      adjoint(acc, 0, m, slab);
    } else {
      ring_drain<kStage, kStages>(slab, nst, issue, [&](int s, const float* buf) {
        adjoint(acc, s * QB, min(QB, m - s * QB), buf);
      });
      ring_prologue<kStage, kStages>(slab, nst, issue);    // phase II's first stages, early
    }
    g.strand_sums(acc);

    // S = X - tau (cX - gX) of the owned entries of X
    if (own) {
      const float gX = (-kSA * rA + kSB * rB) + sown[t];
      rS = rX - tau * (rcX - gX);
      S[eo] = rS;
    }
    // the x step of the owned entries of x (the sums from the last iteration)
    if (lane == 0 && warp < LB) {
      const int i = i0 + warp;
      const float gx = (kSA * rsa - kSB * (rsb + rsc)) + sown[LA + warp];
      const float xn = fminf(fmaxf(rx - tau * (a.cx[i] - gx), 0.0f), 1.0f);
      xb[i] = 2.0f * xn - rx;
      rx = xn;
      rax += xn;
    }
    grid_sync(a.bar, target, P);

    // ---- II: X = clip(sym(S)), Xb; the dual ascent on yA, yB -----------------
    if (own) {
      const float xn = fminf(fmaxf(0.5f * (rS + __ldcg(S + co * n + io)), 0.0f), 1.0f);
      const float xbv = 2.0f * xn - rX;
      rX = xn;
      raX += xn;
      sown[t] = xbv;
      const float xbi = __ldcg(xb + io), xbc = __ldcg(xb + co);
      const float kA = kSA * (xbi - xbv);
      const float kB = kSB * (xbv - xbi - xbc);
      rA = fmaxf(rA - sigma * kA, 0.0f);
      rB = fmaxf(rB + sigma * (-kSB - kB), 0.0f);
      raA += rA;
      raB += rB;
      a.yAo[eo] = rA;
      a.yBo[eo] = rB;
    }
    for (int j = LA + t; j < E; j += kThreads) sown[j] = __ldcg(xb + i0 + j - LA);
    __syncthreads();
    g.shift_weights();                   // [Xb | xb]
    if (resident) {
      residual(part, m, 1, 0, m, slab);
    } else {
      ring_drain<kStage, kStages>(slab, nst, issue, [&](int s, const float* buf) {
        residual(part, m, 1, s * QB, min(QB, m - s * QB), buf);
      });
    }
    grid_sync(a.bar, target, P);

    // ---- III: the owned rows: their partials summed in CTA order, yD; the
    //      next x step's sums of the new yA, yB ---------------------------------
    for (int q = q0 + warp; q < q1; q += kThreads / 32) {
      float r = 0.0f;
      for (int c = lane; c < P; c += 32) r += __ldcg(part + static_cast<size_t>(c) * m + q);
      r = warp_sum(r);
      if (lane == 0) {
        const float yd = fmaxf(syD[q] + sigma * (a.h[q] - r), 0.0f);
        a.yDo[q] = yd;
        a.ayDo[q] += yd;
      }
    }
    if (it + 1 < a.iters) {
      x_sums(a.yAo, a.yBo);
      // the next iteration's first stages
      if (!resident) ring_prologue<kStage, kStages>(slab, nst, issue);
      grid_sync(a.bar, target, P);
    }
  }

  // ---- exit: the owned entries' state and sums ------------------------------
  if (own) {
    a.Xo[eo] = rX;
    a.yAo[eo] = rA;
    a.yBo[eo] = rB;
    a.aXo[eo] = raX;
    a.aAo[eo] = raA;
    a.aBo[eo] = raB;
  }
  if (lane == 0 && warp < LB) {
    a.xo[i0 + warp] = rx;
    a.axo[i0 + warp] = rax;
  }
  if constexpr (kCheck) grid_check<Cols>(a, target, rX, rA, rB, raX, raA, raB, rcX, rx, rax);
}

// ---- "cta" ----------------------------------------------------------------

struct CtaLayout {
  int W;                          // (m, V4) [G_q | g_q | 0], staged once
  int X, yA, yB, cX, aX, aA, aB, S;   // (n n) the state, cX, the sums and S
  int wv;                         // (V4,) [Xb | xb | 0]
  int gD;                         // (V4,) the adjoint
  int x, ax, cx;                  // (n,)
  int h, yD, ayD, res;            // (m,); res: the rows' residuals
  int strand;                     // (4 kThreads,) strand partials
  int words;
};

// a row of [G_q | g_q] padded to a multiple of 4 floats, for 16-byte loads
__host__ __device__ inline int cta_row(int n) { return (n * n + n + 3) & ~3; }

__host__ __device__ inline CtaLayout cta_layout(int n, int m) {
  const int NN = n * n, V4 = cta_row(n);
  CtaLayout L;
  int o = 0;
#define TAKE(field, words) L.field = o; o += (words)
  TAKE(W, m * V4);
  TAKE(X, NN); TAKE(yA, NN); TAKE(yB, NN); TAKE(cX, NN); TAKE(aX, NN); TAKE(aA, NN);
  TAKE(aB, NN); TAKE(S, NN);
  TAKE(wv, V4); TAKE(gD, V4);
  TAKE(x, n); TAKE(ax, n); TAKE(cx, n);
  TAKE(h, m); TAKE(yD, m); TAKE(ayD, m); TAKE(res, m);
  TAKE(strand, 4 * kThreads);
#undef TAKE
  L.words = o;
  return L;
}

// [G_q | g_q | 0] of every row into W (m rows of cta_row(n) floats), by
// cp.async; the caller waits for them
__device__ __forceinline__ void stage_rows(float* W, const float* G, const float* g, int n,
                                           int m) {
  const int NN = n * n, V = NN + n, V4 = cta_row(n);
  for (int p = threadIdx.x; p < m * V4; p += kThreads) {
    const int q = p / V4, v = p - q * V4;
    if (v < NN) {
      cp_async4(W + p, G + static_cast<size_t>(q) * NN + v);
    } else if (v < V) {
      cp_async4(W + p, g + static_cast<size_t>(q) * n + (v - NN));
    } else {
      W[p] = 0.0f;
    }
  }
  cp_async_commit();
}

// The "cta" plan's two passes over the staged rows W, shared by the block,
// its check and the norm.  The adjoint's lanes: entries 4 k4 .. 4 k4 + 3 of
// strand sj, whose rows are the block [sj m / NS, (sj + 1) m / NS), NS
// strands.  The residuals' lanes: RL a row (the least power of two with at
// most kRowJ / 4 quads a lane, at most 32), group rg of RG = kThreads / RL.
struct CtaPasses {
  const float* W;
  int m, V, V4, Q4, NS, sj, k4, qa, qe, RL, RG, rg, rl;

  __device__ __forceinline__ CtaPasses(const float* W_, int n, int m_) : W(W_), m(m_) {
    const int t = threadIdx.x;
    V = n * n + n;
    V4 = cta_row(n);
    Q4 = V4 / 4;
    NS = max(1, kThreads / Q4);
    sj = t / Q4;
    k4 = t % Q4;
    qa = static_cast<int>(static_cast<long long>(m) * sj / NS);
    qe = static_cast<int>(static_cast<long long>(m) * (sj + 1) / NS);
    RL = 1;
    while (RL < 32 && RL * (kRowJ / 4) < Q4) RL <<= 1;
    RG = kThreads / RL;
    rg = t / RL;
    rl = t % RL;
  }
  // whether a residual lane's quads fit its registers (residual<true>)
  __device__ __forceinline__ bool fast() const { return RL * (kRowJ / 4) >= Q4; }

  // the adjoint sum_q w(q) [G_q | g_q], each strand's rows in increasing q,
  // into str (strand sj at sj V4)
  template <class Weight>
  __device__ __forceinline__ void strands(Weight w, float* str) const {
    if (sj < NS) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int q = qa; q < qe; ++q) {
        const float wq = w(q);
        const float4 v = *reinterpret_cast<const float4*>(W + q * V4 + 4 * k4);
        acc.x = fmaf(wq, v.x, acc.x);
        acc.y = fmaf(wq, v.y, acc.y);
        acc.z = fmaf(wq, v.z, acc.z);
        acc.w = fmaf(wq, v.w, acc.w);
      }
      *reinterpret_cast<float4*>(str + sj * V4 + 4 * k4) = acc;
    }
  }
  // the strands summed in strand order into out[0, V) (after a barrier)
  __device__ __forceinline__ void strand_sums(const float* str, float* out) const {
    for (int v = threadIdx.x; v < V; v += kThreads) {
      float s = 0.0f;
      for (int r = 0; r < NS; ++r) s += str[r * V4 + v];
      out[v] = s;
    }
  }
  // <W_q, wv> of every row q into res, RL lanes a row (a butterfly; the same
  // trip count in every lane: rows past m redo row m - 1 unstored).  kFast:
  // a lane keeps wv's quads rl + RL j in registers, every load issued, from a
  // clamped quad, its weight 0 past V4.
  template <bool kFast>
  __device__ __forceinline__ void residual(const float* wv, float* res) const {
    float4 wr[kRowJ / 4];
    if (kFast) {
#pragma unroll
      for (int j = 0; j < kRowJ / 4; ++j) {
        const int k = rl + RL * j;
        wr[j] = k < Q4 ? *reinterpret_cast<const float4*>(wv + 4 * k)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
    }
    for (int qb = 0; qb < m; qb += RG) {
      const int q = qb + rg;
      const float* Wq = W + min(q, m - 1) * V4;
      float r = 0.0f;
      if (kFast) {
#pragma unroll
        for (int j = 0; j < kRowJ / 4; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(Wq + 4 * min(rl + RL * j, Q4 - 1));
          r = fmaf(v.x, wr[j].x, r);
          r = fmaf(v.y, wr[j].y, r);
          r = fmaf(v.z, wr[j].z, r);
          r = fmaf(v.w, wr[j].w, r);
        }
      } else {
        for (int k = rl; k < Q4; k += RL) {
          const float4 v = *reinterpret_cast<const float4*>(Wq + 4 * k);
          const float4 w = *reinterpret_cast<const float4*>(wv + 4 * k);
          r = fmaf(v.x, w.x, r);
          r = fmaf(v.y, w.y, r);
          r = fmaf(v.z, w.z, r);
          r = fmaf(v.w, w.w, r);
        }
      }
      for (int o = RL / 2; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
      if (rl == 0 && q < m) res[q] = r;
    }
  }
};

template <bool kCheck>
__global__ void __launch_bounds__(kThreads, 1) pdhg_dense_cta_kernel(
    const __grid_constant__ BlockArgs a) {
  extern __shared__ __align__(16) float sm[];
  if (a.rec[kRecStop]) return;
  const float tau = __int_as_float(a.rec[kRecTau]), sigma = __int_as_float(a.rec[kRecSigma]);
  const int n = a.n, m = a.m, NN = n * n, V = NN + n, V4 = cta_row(n);
  const int t = threadIdx.x;
  const CtaLayout L = cta_layout(n, m);
  float* const W = sm + L.W;
  float* const sX = sm + L.X;
  float* const syA = sm + L.yA;
  float* const syB = sm + L.yB;
  float* const scX = sm + L.cX;
  float* const saX = sm + L.aX;
  float* const saA = sm + L.aA;
  float* const saB = sm + L.aB;
  float* const sS = sm + L.S;
  float* const swv = sm + L.wv;       // [Xb | xb | 0]
  float* const sgD = sm + L.gD;
  float* const sx = sm + L.x;
  float* const sax = sm + L.ax;
  float* const scx = sm + L.cx;
  float* const sh = sm + L.h;
  float* const syD = sm + L.yD;
  float* const sayD = sm + L.ayD;
  float* const sres = sm + L.res;
  float* const sstr = sm + L.strand;

  // ---- entry: G and g staged once, the state loaded -----------------------
  stage_rows(W, a.G, a.g, n, m);
  for (int e = t; e < NN; e += kThreads) {
    sX[e] = a.X[e];
    syA[e] = a.yA[e];
    syB[e] = a.yB[e];
    scX[e] = a.cX[e];
    saX[e] = a.aX[e];
    saA[e] = a.aA[e];
    saB[e] = a.aB[e];
  }
  for (int i = t; i < n; i += kThreads) {
    sx[i] = a.x[i];
    sax[i] = a.ax[i];
    scx[i] = a.cx[i];
  }
  for (int q = t; q < m; q += kThreads) {
    sh[q] = a.h[q];
    syD[q] = a.yD[q];
    sayD[q] = a.ayD[q];
  }
  for (int v = V + t; v < V4; v += kThreads) swv[v] = 0.0f;
  cp_async_wait<0>();
  __syncthreads();

  const CtaPasses ps(W, n, m);
  const bool fast = ps.fast();

  for (int it = 0; it < a.iters; ++it) {
    // ---- the adjoint sum_q yD_q [G_q | g_q]: each strand's rows in order,
    //      then the strands in order ------------------------------------------
    ps.strands([&](int q) { return syD[q]; }, sstr);
    __syncthreads();
    ps.strand_sums(sstr, sgD);
    __syncthreads();

    // ---- S, and the x step (a thread a row; xb after X's Xb in wv) ---------
    for (int e = t; e < NN; e += kThreads) {
      const float gX = (-kSA * syA[e] + kSB * syB[e]) + sgD[e];
      sS[e] = sX[e] - tau * (scX[e] - gX);
    }
    if (t < n) {
      const int i = t;
      float sa = 0.0f, sb = 0.0f, sc = 0.0f;
      for (int c = 0; c < n; ++c) {
        sa += syA[i * n + c];
        sb += syB[i * n + c];
        sc += syB[c * n + i];
      }
      {
        const float gx = (kSA * sa - kSB * (sb + sc)) + sgD[NN + i];
        const float xo = sx[i];
        const float xn = fminf(fmaxf(xo - tau * (scx[i] - gx), 0.0f), 1.0f);
        sx[i] = xn;
        sax[i] += xn;
        swv[NN + i] = 2.0f * xn - xo;
      }
    }
    __syncthreads();

    // ---- X = clip(sym(S)), Xb; the dual ascent on yA, yB ---------------------
    for (int e = t; e < NN; e += kThreads) {
      const int i = e / n, c = e - i * n;
      const float xn = fminf(fmaxf(0.5f * (sS[e] + sS[c * n + i]), 0.0f), 1.0f);
      const float xbv = 2.0f * xn - sX[e];
      sX[e] = xn;
      saX[e] += xn;
      swv[e] = xbv;
      const float xbi = swv[NN + i], xbc = swv[NN + c];
      const float kA = kSA * (xbi - xbv);
      const float kB = kSB * (xbv - xbi - xbc);
      const float ya = fmaxf(syA[e] - sigma * kA, 0.0f);
      const float yb = fmaxf(syB[e] + sigma * (-kSB - kB), 0.0f);
      syA[e] = ya;
      syB[e] = yb;
      saA[e] += ya;
      saB[e] += yb;
    }
    __syncthreads();

    // ---- the residuals <G_q, Xb> + g_q . xb, then yD and its sum ------------
    if (fast) {
      ps.residual<true>(swv, sres);
    } else {
      ps.residual<false>(swv, sres);
    }
    __syncthreads();
    for (int q = t; q < m; q += kThreads) {
      const float yd = fmaxf(syD[q] + sigma * (sh[q] - sres[q]), 0.0f);
      syD[q] = yd;
      sayD[q] += yd;
    }
    __syncthreads();
  }

  if constexpr (kCheck) {
    // ---- the check (K7c) on the state in shared memory ------------------------
    int* const rec = a.rec;
    const int wlen = rec[kRecWlen] + a.iters;
    const float inv = 1.0f / static_cast<float>(wlen);
    float tot[2][kNV];                 // the sums of each point (thread 0's)
#pragma unroll
    for (int pt = 0; pt < 2; ++pt) {
      const float sc = pt == 0 ? 1.0f : inv;
      const float* const pX = pt == 0 ? sX : saX;
      const float* const pA = pt == 0 ? syA : saA;
      const float* const pB = pt == 0 ? syB : saB;
      const float* const px = pt == 0 ? sx : sax;
      const float* const pD = pt == 0 ? syD : sayD;
      // the adjoint sum_q yD_q [G_q | g_q] at the point, as the block's
      ps.strands([&](int q) { return pD[q] * sc; }, sstr);
      // [X | x] at the point, the residuals' weights
      for (int e = t; e < NN; e += kThreads) swv[e] = pX[e] * sc;
      for (int i = t; i < n; i += kThreads) swv[NN + i] = px[i] * sc;
      __syncthreads();
      ps.strand_sums(sstr, sgD);
      // the rows' residuals <G_q, X> + g_q . x
      ps.residual<false>(swv, sres);
      __syncthreads();
      // the point's sums: objective, dual bound (M + M^T from gX and its
      // transpose), infeasibility of K z
      float v[kNV];
#pragma unroll
      for (int j = 0; j < kNV; ++j) v[j] = 0.0f;
      for (int e = t; e < NN; e += kThreads) {
        const int i = e / n, c = e - i * n, T = c * n + i;
        const float Xv = swv[e], va = pA[e] * sc, vb = pB[e] * sc;
        const float Mv = scX[e] - ((-kSA * va + kSB * vb) + sgD[e]);
        const float MT = scX[T] - ((-kSA * (pA[T] * sc) + kSB * (pB[T] * sc)) + sgD[T]);
        v[kPX] += scX[e] * Xv;
        v[kHyB] += vb;
        v[kSm] += fminf(Mv + MT, 0.0f);
        const float xi = swv[NN + i], xc = swv[NN + c];
        const float kA = kSA * (xi - Xv);
        const float kB = kSB * (Xv - xi - xc);
        const float vA = fmaxf(-kA, 0.0f), vB = fmaxf(-kSB - kB, 0.0f);
        v[kV2] += vA * vA + vB * vB;
      }
      if (t < n) {
        const int i = t;
        float sa = 0.0f, sb = 0.0f, scl = 0.0f;
        for (int c = 0; c < n; ++c) {
          sa += pA[i * n + c] * sc;
          sb += pB[i * n + c] * sc;
          scl += pB[c * n + i] * sc;
        }
        const float gx = (kSA * sa - kSB * (sb + scl)) + sgD[NN + i];
        v[kRxm] += fminf(scx[i] - gx, 0.0f);
        v[kPx] += scx[i] * swv[NN + i];
      }
      for (int q = t; q < m; q += kThreads) {
        const float vD = fmaxf(sh[q] - sres[q], 0.0f);
        v[kVD2] += vD * vD;
        v[kHyD] += sh[q] * (pD[q] * sc);
      }
      block_sums(v, sstr, sstr + (kThreads / 32) * kNV);
      if (t == 0) {
#pragma unroll
        for (int j = 0; j < kNV; ++j) tot[pt][j] = sstr[(kThreads / 32) * kNV + j];
      }
      __syncthreads();
    }
    float* const dec = sstr + 160;     // err, p, d of both points; use_avg
    if (t == 0) {
#pragma unroll
      for (int pt = 0; pt < 2; ++pt) {
        const float* s = tot[pt];
        const float p = s[kPx] + s[kPX];
        const float hy = -kSB * s[kHyB] + s[kHyD];
        const float d = (hy + s[kRxm]) + 0.5f * s[kSm];
        const float infeas = sqrtf(s[kV2] + s[kVD2]);
        dec[3 * pt] = infeas + fmaxf(p - d, 0.0f);
        dec[3 * pt + 1] = p;
        dec[3 * pt + 2] = d;
      }
      dec[6] = dec[3] < dec[0] ? 1.0f : 0.0f;
    }
    __syncthreads();
    const bool use_avg = dec[6] != 0.0f;
    const bool restart = use_avg || wlen >= a.restart_period;
    if (restart) {
      // the candidate into the state and the anchor, the sums zeroed; the
      // distances from the anchor
      const float csc = use_avg ? inv : 1.0f;
      float dv[kND];
#pragma unroll
      for (int j = 0; j < kND; ++j) dv[j] = 0.0f;
      for (int e = t; e < NN; e += kThreads) {
        const float X = (use_avg ? saX[e] : sX[e]) * csc, A = (use_avg ? saA[e] : syA[e]) * csc,
                    B = (use_avg ? saB[e] : syB[e]) * csc;
        const float eX = X - a.zX[e], eA = A - a.zA[e], eB = B - a.zB[e];
        dv[kDX] += eX * eX;
        dv[kDA] += eA * eA;
        dv[kDB] += eB * eB;
        sX[e] = X;
        syA[e] = A;
        syB[e] = B;
        a.zX[e] = X;
        a.zA[e] = A;
        a.zB[e] = B;
        saX[e] = 0.0f;
        saA[e] = 0.0f;
        saB[e] = 0.0f;
      }
      for (int i = t; i < n; i += kThreads) {
        const float x = (use_avg ? sax[i] : sx[i]) * csc, e = x - a.zx[i];
        dv[kDx] += e * e;
        sx[i] = x;
        a.zx[i] = x;
        sax[i] = 0.0f;
      }
      for (int q = t; q < m; q += kThreads) {
        const float y = (use_avg ? sayD[q] : syD[q]) * csc, e = y - a.zD[q];
        dv[kDD] += e * e;
        syD[q] = y;
        a.zD[q] = y;
        sayD[q] = 0.0f;
      }
      block_sums(dv, sstr, sstr + 128);
    }
    if (t == 0)
      write_record(rec, dec, use_avg, restart, wlen, sstr + 128, 1, a.iters, a.max_iters,
                   a.tol);
    __syncthreads();
  }

  // ---- exit: the state and sums, stored once --------------------------------
  for (int e = t; e < NN; e += kThreads) {
    a.Xo[e] = sX[e];
    a.yAo[e] = syA[e];
    a.yBo[e] = syB[e];
    a.aXo[e] = saX[e];
    a.aAo[e] = saA[e];
    a.aBo[e] = saB[e];
  }
  for (int i = t; i < n; i += kThreads) {
    a.xo[i] = sx[i];
    a.axo[i] = sax[i];
  }
  for (int q = t; q < m; q += kThreads) {
    a.yDo[q] = syD[q];
    a.ayDo[q] = sayD[q];
  }
}

// ---- the norm (K7n) --------------------------------------------------------
// ||K|| 1.02 + 1e-12 after `iters` power iterations on the symmetric-X
// primal subspace from the start vector (y, Y), read only, as
// estimate_norm_plain (lp/pdhg.py) computes it: z = (y, Y) / nrm (nrm = 1
// at the start), K z = (kA, kB, kD), (gx, gX) = K^T K z with gX
// symmetrised, nrm = ||(gx, gX)|| + 1e-30 and (y, Y) = (gx, gX); after the
// last iteration ||K z||.  kD is the block's residual pass with weights z,
// K^T's dense part its adjoint pass with weights kD, on the block's plan and
// layout (block_plan), so the norm runs wherever the block runs.

struct NormArgs {
  int n, m, iters;
  const float *G, *g;     // the dense rows, read in place
  const float *y, *Y;     // the start vector, read only
  float* work;            // "grid": norm_work_words
  unsigned* bar;          // "grid": the barrier's counter
  float* out;             // ||K|| 1.02 + 1e-12
};

// "cta": G and g staged once (cta_layout; the norm's arrays in the block's
// fields), every iteration in shared memory with block barriers only.
__global__ void __launch_bounds__(kThreads, 1) pdhg_dense_norm_cta_kernel(
    const __grid_constant__ NormArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int n = a.n, m = a.m, NN = n * n, V = NN + n, V4 = cta_row(n);
  const int t = threadIdx.x;
  const CtaLayout L = cta_layout(n, m);
  float* const W = sm + L.W;
  float* const sY = sm + L.X;         // the iterate (y, Y), unnormalised
  float* const sy = sm + L.x;
  float* const skA = sm + L.yA;       // K z's first two blocks
  float* const skB = sm + L.yB;
  float* const skD = sm + L.res;      // and its dense rows
  float* const sgX = sm + L.S;
  float* const swv = sm + L.wv;       // z = [Y | y] / nrm | 0
  float* const sgD = sm + L.gD;       // the adjoint of kD
  float* const sstr = sm + L.strand;
  stage_rows(W, a.G, a.g, n, m);
  for (int e = t; e < NN; e += kThreads) sY[e] = a.Y[e];
  for (int i = t; i < n; i += kThreads) sy[i] = a.y[i];
  for (int v = V + t; v < V4; v += kThreads) swv[v] = 0.0f;
  cp_async_wait<0>();
  __syncthreads();
  const CtaPasses ps(W, n, m);
  const bool fast = ps.fast();

  float nrm = 1.0f;          // the start vector is used as it is (x / 1 = x)
  for (int it = 0;; ++it) {
    // ---- K z: its first two blocks, and the rows' residuals ---------------
    for (int e = t; e < NN; e += kThreads) swv[e] = sY[e] / nrm;
    for (int i = t; i < n; i += kThreads) swv[NN + i] = sy[i] / nrm;
    __syncthreads();
    float sq[2] = {0.0f, 0.0f};       // the last step's sums of kA^2 + kB^2, kD^2
    for (int e = t; e < NN; e += kThreads) {
      const int i = e / n, c = e - i * n;
      const float Z = swv[e], zi = swv[NN + i];
      const float kA = kSA * (zi - Z), kB = kSB * (Z - zi - swv[NN + c]);
      skA[e] = kA;
      skB[e] = kB;
      sq[0] += kA * kA + kB * kB;
    }
    if (fast) {
      ps.residual<true>(swv, skD);
    } else {
      ps.residual<false>(swv, skD);
    }
    __syncthreads();
    if (it == a.iters) {
      for (int q = t; q < m; q += kThreads) sq[1] += skD[q] * skD[q];
      block_sums(sq, sstr, sstr + 64);
      if (t == 0) *a.out = sqrtf(sstr[64] + sstr[65]) * 1.02f + 1e-12f;
      return;
    }
    // ---- (gx, gX) = K^T (kA, kB, 0, kD); the new iterate and its norm -----
    ps.strands([&](int q) { return skD[q]; }, sstr);
    __syncthreads();
    ps.strand_sums(sstr, sgD);
    __syncthreads();
    for (int e = t; e < NN; e += kThreads) sgX[e] = (-kSA * skA[e] + kSB * skB[e]) + sgD[e];
    float ss[2] = {0.0f, 0.0f};
    if (t < n) {
      const int i = t;
      float sa = 0.0f, sb = 0.0f, sc = 0.0f;
      for (int c = 0; c < n; ++c) {
        sa += skA[i * n + c];
        sb += skB[i * n + c];
        sc += skB[c * n + i];
      }
      const float gx = (kSA * sa - kSB * (sb + sc)) + sgD[NN + i];
      sy[i] = gx;
      ss[0] = gx * gx;
    }
    __syncthreads();
    for (int e = t; e < NN; e += kThreads) {
      const int i = e / n, c = e - i * n;
      const float v = 0.5f * (sgX[e] + sgX[c * n + i]);
      sY[e] = v;
      ss[1] += v * v;
    }
    block_sums(ss, sstr, sstr + 64);
    nrm = sqrtf(sstr[64] + sstr[65]) + 1e-30f;
  }
}

// "grid": CTA b's slices as the block's (GridCta); the owned entries of the
// iterate in registers (thread t: entry e0 + t of Y; lane 0 of warp w:
// entry i0 + w of y), the whole iterate in global memory for the other
// CTAs.  A power iteration, from the iterate (y, Y) as the last one left it
// (unnormalised):
//   A  each row's partial of <G_q, Y> + g_q . y over the owned entries (the
//      residual pass with weights [Y | y]);                grid barrier 1
//   B  nrm from every CTA's sums, folded in CTA order (1 at the start); the
//      owned rows' kD_q = (their partials in CTA order) / nrm; kA, kB of the
//      owned entries at z = (y, Y) / nrm, and the row sums of kA, kB and the
//      column sums of kB of the owned entries of x, every read issued
//      before the CTA waits for nrm;                       grid barrier 2
//   C  the adjoint pass with weights kD; gX of the owned entries to global
//      memory; gx of the owned entries of x, the new y;    grid barrier 3
//   D  Y = 0.5 (gX + gX^T) of the owned entries; each CTA's sums of gx^2
//      and Y^2 to global memory.
// The next A needs no barrier after D: its weights are the CTA's own
// entries, unnormalised, and B scales its partials once every CTA's sums
// have arrived (the barrier a normalised A would need, merged into
// barrier 1).  After the last iteration, A and B give K z; each CTA's sums
// of kA^2 + kB^2 and kD^2 to global memory, a barrier, and CTA 0 folds them.
// Cols: the column width.
template <int Cols>
__global__ void __launch_bounds__(kThreads, 1) pdhg_dense_norm_grid_kernel(
    const __grid_constant__ NormArgs a) {
  extern __shared__ __align__(16) float sm[];
  const int n = a.n, m = a.m, NN = n * n;
  const GridCta<NormArgs, Cols> g(a, sm);
  const int P = g.P, b = g.b, t = g.t, lane = t % 32, warp = t / 32;
  const int i0 = g.i0, q0 = g.q0, q1 = g.q1, LA = g.LA, LB = g.LB, QB = g.QB, nst = g.nst;
  const bool resident = g.resident;
  float* const scr = g.scr;            // [0, 2) the folded sums, block_sums at [32, 66),
                                       // y at [128, 128 + n)
  float* const slab = g.slab;
  float* const syD = g.syD;            // the replica of kD
  float* const sown = g.sown;
  float* const wY = a.work;            // the iterate after the first iteration
  float* const wy = wY + NN;
  float* const wgX = wy + n;
  float* const part = wgX + NN;        // (P, m): CTA b's partial of row q at b m + q
  float* const wkD = part + static_cast<size_t>(P) * m;
  float* const csum = wkD + m;         // (2, P): each CTA's sums of gx^2 and Y^2
  float* const cfin = csum + 2 * P;    // (2, P): each CTA's sums of the last step
  unsigned target = 0;
  auto issue = [&](int s, float* dst) { g.issue(s, dst); };

  if (resident) g.load_rows(0, m, slab);   // the launch's one read of the slice
  cp_async_commit();
  ring_prologue<kStage, kStages>(slab, nst, issue);         // a stream's first stages
  const bool own = t < LA, ownx = lane == 0 && warp < LB;
  const int eo = g.e0 + t, io = eo / n, co = eo - io * n;
  float rY = own ? a.Y[eo] : 0.0f;
  float ry = ownx ? a.y[i0 + warp] : 0.0f;
  if (resident) cp_async_wait<0>();
  __syncthreads();

  for (int it = 0;; ++it) {
    const bool last = it == a.iters;
    const float* const Yc = it == 0 ? a.Y : wY;
    const float* const yc = it == 0 ? a.y : wy;
    // ---- A: the rows' partials at the iterate --------------------------------
    if (own) sown[t] = rY;
    if (ownx) sown[LA + warp] = ry;
    __syncthreads();
    g.shift_weights();
    if (resident) {
      g.residual(part, m, 1, 0, m, slab);
    } else {
      ring_drain<kStage, kStages>(slab, nst, issue, [&](int s, const float* buf) {
        g.residual(part, m, 1, s * QB, min(QB, m - s * QB), buf);
      });
      if (!last) ring_prologue<kStage, kStages>(slab, nst, issue);   // C's first stages, early
    }
    grid_sync(a.bar, target, P);

    // ---- B: nrm; kD of the owned rows; K's first two blocks at z.  Every
    //      read of the step is issued before the CTA waits for nrm --------------
    float fold = 0.0f;                   // warps 0, 1: every CTA's sums of the iterate
    if (it > 0 && warp < 2)
      for (int c = lane; c < P; c += 32) fold += __ldcg(csum + static_cast<size_t>(warp) * P + c);
    float* const sy = scr + 128;
    for (int i = t; i < n; i += kThreads) sy[i] = __ldcg(yc + i);
    for (int q = q0 + warp; q < q1; q += kThreads / 32) {   // the rows' K z, unscaled
      float r = 0.0f;
      for (int c = lane; c < P; c += 32) r += __ldcg(part + static_cast<size_t>(c) * m + q);
      r = warp_sum(r);
      if (lane == 0) syD[q] = r;
    }
    // warp w < LB: row i0 + w of Y at columns lane + 32 j, which is also its
    // column: Y is symmetric bit for bit (the start vector is sym(.), and D
    // forms both (i, c) and (c, i) as 0.5 (gX_ic + gX_ci))
    float Yr[Cols / 32];
    if (!last && warp < LB) {
      const int i = i0 + warp;
#pragma unroll
      for (int j = 0; j < Cols / 32; ++j)       // every load issued, from a clamped column
        Yr[j] = __ldcg(Yc + i * n + min(lane + 32 * j, n - 1));
    }
    if (it > 0 && warp < 2) {
      fold = warp_sum(fold);
      if (lane == 0) scr[warp] = fold;
    }
    __syncthreads();
    const float nrm = it == 0 ? 1.0f : sqrtf(scr[0] + scr[1]) + 1e-30f;
    float v[2] = {0.0f, 0.0f};           // the last step's sums of kA^2 + kB^2, kD^2
    if (lane == 0) {
      for (int q = q0 + warp; q < q1; q += kThreads / 32) {
        const float kd = syD[q] / nrm;
        if (last) {
          v[1] += kd * kd;
        } else {
          wkD[q] = kd;
        }
      }
    }
    float kA = 0.0f, kB = 0.0f;
    if (own) {
      const float Z = rY / nrm, zi = sy[io] / nrm;
      kA = kSA * (zi - Z);
      kB = kSB * (Z - zi - sy[co] / nrm);
      v[0] += kA * kA + kB * kB;
    }
    if (last) {
      block_sums(v, scr + 32, scr + 64);
      if (t < 2) cfin[static_cast<size_t>(t) * P + b] = scr[64 + t];
      grid_sync(a.bar, target, P);
      if (b == 0) {
        if (warp < 2) {
          float r = 0.0f;
          for (int c = lane; c < P; c += 32) r += __ldcg(cfin + static_cast<size_t>(warp) * P + c);
          r = warp_sum(r);
          if (lane == 0) scr[warp] = r;
        }
        __syncthreads();
        if (t == 0) *a.out = sqrtf(scr[0] + scr[1]) * 1.02f + 1e-12f;
      }
      return;
    }
    float sa = 0.0f, sb = 0.0f, sc = 0.0f;
    if (warp < LB) {
      const float zi = sy[i0 + warp] / nrm;
#pragma unroll
      for (int j = 0; j < Cols / 32; ++j) {    // the columns in increasing order a lane
        if (lane + 32 * j < n) {
          const float zc = sy[lane + 32 * j] / nrm, Z = Yr[j] / nrm;
          sa += kSA * (zi - Z);
          sb += kSB * (Z - zi - zc);
          sc += kSB * (Z - zc - zi);
        }
      }
      sa = warp_sum(sa);
      sb = warp_sum(sb);
      sc = warp_sum(sc);
    }
    grid_sync(a.bar, target, P);

    // ---- C: K^T (kA, kB, 0, kD) of the owned entries -------------------------
    for (int q = t; q < m; q += kThreads) syD[q] = __ldcg(wkD + q);
    __syncthreads();
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (resident) {
      g.adjoint(acc, 0, m, slab);
    } else {
      ring_drain<kStage, kStages>(slab, nst, issue, [&](int s, const float* buf) {
        g.adjoint(acc, s * QB, min(QB, m - s * QB), buf);
      });
      ring_prologue<kStage, kStages>(slab, nst, issue);    // the next A's first stages
    }
    g.strand_sums(acc);
    if (own) wgX[eo] = (-kSA * kA + kSB * kB) + sown[t];
    float ss[2] = {0.0f, 0.0f};           // this CTA's sums of gx^2 and Y^2
    if (ownx) {
      ry = (kSA * sa - kSB * (sb + sc)) + sown[LA + warp];
      wy[i0 + warp] = ry;
      ss[0] = ry * ry;
    }
    grid_sync(a.bar, target, P);

    // ---- D: the new Y of the owned entries, and the CTA's sums -----------------
    if (own) {
      rY = 0.5f * (__ldcg(wgX + eo) + __ldcg(wgX + co * n + io));
      wY[eo] = rY;
      ss[1] = rY * rY;
    }
    block_sums(ss, scr + 32, scr + 64);
    if (t < 2) csum[static_cast<size_t>(t) * P + b] = scr[64 + t];
  }
}

// The cooperative grid of the "grid" plan with smem bytes a CTA, into *P:
// as many CTAs as the card holds at once (each SM's share times the SMs) of
// every kernel of the plan at column width Cols, the block's two forms and
// the norm, so that the block's forms run the same grid and the block's sums
// the same order.  Returns 0, a CUDA error or kErrNoCluster (not one CTA
// fits).
template <int Cols>
int dense_grid(int smem, int* P) {
  static int cached[3] = {-1, -1, 0};   // device, smem, CTAs
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (cached[0] != dev || cached[1] != smem) {
    int fewest = 1 << 30, sms = 0;
    const void* kernels[3] = {
        reinterpret_cast<const void*>(pdhg_dense_grid_kernel<false, Cols>),
        reinterpret_cast<const void*>(pdhg_dense_grid_kernel<true, Cols>),
        reinterpret_cast<const void*>(pdhg_dense_norm_grid_kernel<Cols>)};
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
    cached[0] = dev;
    cached[1] = smem;
    cached[2] = fewest * sms;
  }
  *P = cached[2];
  return *P < 1 ? kErrNoCluster : 0;
}

// One launch of a dense-route kernel under plan 0 "cta" (cta_kernel, one
// CTA; cta_smem: the size its attribute was last set to) or 1 "grid"
// (grid_kernel on dense_grid's CTAs, launched cooperatively once the
// barrier's counter bar is zeroed); the shape and smem already checked.
// distances: CTA 0 copies every CTA's distances into its scratch (the
// checked block).  *grid receives the CTAs.  Cols: the grid kernel's column
// width.
template <int Cols, class Args>
int launch_plan(void (*cta_kernel)(Args), void (*grid_kernel)(Args), int& cta_smem,
                const Args& a, unsigned* bar, int plan, int smem, bool distances, int* grid,
                cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cudaError_t e;
  if (plan == 0) {
    if (cta_smem != smem) {
      e = cudaFuncSetAttribute(cta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      cta_smem = smem;
    }
    cfg.gridDim = dim3(1, 1, 1);
    *grid = 1;
    e = cudaLaunchKernelEx(&cfg, cta_kernel, a);
  } else {
    int P = 0;
    const int err = dense_grid<Cols>(smem, &P);
    if (err != 0) return err;
    const int n = a.n;
    if ((n * n + P - 1) / P + (n + P - 1) / P > GridWidth<Cols>::kMaxE ||
        (n + P - 1) / P > kThreads / 32)
      return kErrLayout;
    if (distances && 256 + P * kND > kScratch) return kErrLayout;   // CTA 0's copy
    e = cudaMemsetAsync(bar, 0, sizeof(unsigned), st);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.gridDim = dim3(P, 1, 1);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    *grid = P;
    e = cudaLaunchKernelEx(&cfg, grid_kernel, a);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// One launch of the block (kCheck: its checked form) under `plan`, the grid
// kernel at n's column width.
template <bool kCheck>
int launch_block(const BlockArgs& a, int plan, int smem, int* grid, cudaStream_t st) {
  static int cta_smem = -1;
  return cols_for(a.n) == kNarrow
             ? launch_plan<kNarrow>(pdhg_dense_cta_kernel<kCheck>,
                                    pdhg_dense_grid_kernel<kCheck, kNarrow>, cta_smem, a, a.bar,
                                    plan, smem, kCheck, grid, st)
             : launch_plan<kWide>(pdhg_dense_cta_kernel<kCheck>,
                                  pdhg_dense_grid_kernel<kCheck, kWide>, cta_smem, a, a.bar,
                                  plan, smem, kCheck, grid, st);
}

// The grid plan's layout at n's column width.
GridLayout grid_layout_at(int n, int m) {
  return cols_for(n) == kNarrow ? grid_layout<kNarrow>(n, m) : grid_layout<kWide>(n, m);
}

int check_block(int n, int m, int iters, int plan, int smem) {
  if (cols_for(n) == 0 || cols_for(n) > kWide || m < 0 || iters < 0 || (plan != 0 && plan != 1))
    return kErrLayout;
  const int words = plan == 0 ? cta_layout(n, m).words : grid_layout_at(n, m).words;
  if (4 * static_cast<size_t>(words) != static_cast<size_t>(smem)) return kErrLayout;
  if (plan == 0 && n > kCtaMaxN) return kErrLayout;
  return 0;
}

}  // namespace

// `iters` iterations of the dense-row block for one instance, with the steps
// and stop flag of its control record rec (kRecWords int32 in device memory):
// state x, X, yA, yB, yD and sums ax, aX, aA, aB, ayD in, the same out (the
// outputs may be the inputs).  G (m, n, n), g (m, n), h (m,) are the dense
// rows, read in place.  plan: 0 "cta" (one CTA, the rows in its shared
// memory), 1 "grid" (one CTA an SM, launched cooperatively, with work:
// work_words(n, m, P, false) floats of scratch, P the grid
// (pdhg_dense_block_grid), and bar: one word for the barrier, zeroed here).
// smem comes from the caller's plan (lp/pdhg_dense.py::smem_bytes) and must
// equal this file's layout.  *grid receives the CTAs launched.  Returns 0, a
// CUDA error, kErrLayout or kErrNoCluster.
extern "C" int pdhg_dense_block_launch(
    int n, int m, int iters, int plan, int smem, const int* rec,
    const float* cx, const float* cX, const float* G, const float* g, const float* h,
    const float* x, const float* X, const float* yA, const float* yB, const float* yD,
    const float* ax, const float* aX, const float* aA, const float* aB, const float* ayD,
    float* xo, float* Xo, float* yAo, float* yBo, float* yDo,
    float* axo, float* aXo, float* aAo, float* aBo, float* ayDo, float* work, unsigned* bar,
    int* grid, void* stream) {
  const int err = check_block(n, m, iters, plan, smem);
  if (err != 0) return err;
  const BlockArgs a{n, m, iters, const_cast<int*>(rec), cx, cX, G, g, h,
                    x, X, yA, yB, yD, ax, aX, aA, aB, ayD,
                    xo, Xo, yAo, yBo, yDo, axo, aXo, aAo, aBo, ayDo, work, bar};
  return launch_block<false>(a, plan, smem, grid, static_cast<cudaStream_t>(stream));
}

// The checked block, the dense route's solve step: `check_every` iterations
// of the block in place on the state and sums, then (its epilogue, K7c) the
// checked block's control of pdhg_check.cuh with the dense rows, in place on
// the state, sums, anchor zx, zX, zA, zB, zD and the record rec.  A stopped
// record is left as it is, with everything else.  plan, smem and the grid
// plan's work (work_words(n, m, P, true) floats) and bar as for
// pdhg_dense_block_launch.  Returns 0, a CUDA error, kErrLayout or
// kErrNoCluster.
extern "C" int pdhg_dense_block_checked_launch(
    int n, int m, int check_every, int plan, int smem, int restart_period, int max_iters,
    float tol, int* rec, const float* cx, const float* cX, const float* G, const float* g,
    const float* h, float* x, float* X, float* yA, float* yB, float* yD,
    float* ax, float* aX, float* aA, float* aB, float* ayD,
    float* zx, float* zX, float* zA, float* zB, float* zD, float* work, unsigned* bar,
    int* grid, void* stream) {
  int err = check_block(n, m, check_every, plan, smem);
  if (err == 0 && check_every < 1) err = kErrLayout;
  if (err != 0) return err;
  const BlockArgs a{n, m, check_every, rec, cx, cX, G, g, h,
                    x, X, yA, yB, yD, ax, aX, aA, aB, ayD,
                    x, X, yA, yB, yD, ax, aX, aA, aB, ayD, work, bar,
                    zx, zX, zA, zB, zD, restart_period, max_iters, tol};
  return launch_block<true>(a, plan, smem, grid, static_cast<cudaStream_t>(stream));
}

// The CTAs of the "grid" plan at (n, m) with smem bytes a CTA: the blocks an
// SM holds at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor) times the
// SMs, into *grid.  Returns 0, a CUDA error, kErrLayout or kErrNoCluster.
extern "C" int pdhg_dense_block_grid(int n, int m, int smem, int* grid) {
  if (cols_for(n) == 0 || cols_for(n) > kWide || m < 0) return kErrLayout;
  if (4 * static_cast<size_t>(grid_layout_at(n, m).words) != static_cast<size_t>(smem))
    return kErrLayout;
  return cols_for(n) == kNarrow ? dense_grid<kNarrow>(smem, grid) : dense_grid<kWide>(smem, grid);
}

// ||K|| 1.02 + 1e-12 over the McCormick rows and the m dense rows after
// `iters` power iterations from the start vector y (n,), Y (n, n), which is
// read only, into out[0], on the block's plan: plan and smem as for
// pdhg_dense_block_launch (smem the block's layout), and under the "grid"
// plan work (norm_work_words(n, m, P) floats) and bar, one word for the
// barrier, zeroed here.  *grid receives the CTAs launched.  Returns 0, a
// CUDA error, kErrLayout or kErrNoCluster.
extern "C" int pdhg_dense_norm_launch(int n, int m, int iters, int plan, int smem,
                                      const float* G, const float* g, const float* y,
                                      const float* Y, float* work, unsigned* bar, float* out,
                                      int* grid, void* stream) {
  const int err = check_block(n, m, iters, plan, smem);
  if (err != 0) return err;
  static int cta_smem = -1;
  const NormArgs a{n, m, iters, G, g, y, Y, work, bar, out};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return cols_for(n) == kNarrow
             ? launch_plan<kNarrow>(pdhg_dense_norm_cta_kernel,
                                    pdhg_dense_norm_grid_kernel<kNarrow>, cta_smem, a, bar, plan,
                                    smem, false, grid, st)
             : launch_plan<kWide>(pdhg_dense_norm_cta_kernel, pdhg_dense_norm_grid_kernel<kWide>,
                                  cta_smem, a, bar, plan, smem, false, grid, st);
}
