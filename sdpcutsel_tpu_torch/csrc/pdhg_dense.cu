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
//   pdhg_dense_norm_kernel   ||K|| by `iters` power iterations in one launch,
//       as K6 (pdhg_norm.cu).  Twin: estimate_norm_plain.
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
// SM streams G at 20-35 GB/s (PERF.md section 6, one cluster of 16: ~0.5
// TB/s), so the block's "grid" plan streams it on every SM, and its "cta"
// plan, for the small sandwiches, keeps it in one SM's shared memory.  The
// check needs no primal step: each of its two points takes one pass over G
// for its adjoint and its residuals together.
//
// The norm: one thread-block cluster of C CTAs on K2's bands
// (pdhg_common.cuh): CTA r owns rows [r R, min(n, (r + 1) R)) of every
// (n, n) array, R = ceil(n / C), keeps its bands in shared memory and
// exchanges the transposed tile, the column sums of kB and x through
// distributed shared memory as K2 does.  The dense rows are never copied to
// shared memory: each pass streams the band's slice of every G_q and g_q
// from global memory (dense_adjoint: band entries to lanes, q in increasing
// order, on few entries the q range split into strands summed in strand
// order; dense_residuals: each rank's partial of <G_q, Z> + g_q . z over
// its band to the owner of q, [r mc, (r + 1) mc), mc = ceil(m / C), who sums
// the ranks' partials in rank order).  No atomics and one fixed order for
// every sum, so a launch repeats bit for bit; the twins sum in torch's order
// and agree to rounding.
//
// The pool: the certifier's is one slot of width 1 that nothing fills, so the
// kernels leave yC and its sum as they are (0, as the twin keeps them: its
// cut rows are all inactive).

#include "pdhg_common.cuh"

namespace {

using namespace pdhg;

constexpr int kAdjLoads = 32;    // loads in flight a lane in the adjoint's stream
constexpr int kMaxJ = 3;         // band entries a lane of the adjoint
constexpr int kResMax = 33;      // entries a lane of one row's residual (32 lanes)
constexpr int kMaxEntries = 32 * kResMax;   // R n + R; also <= kMaxJ kThreads

__device__ __forceinline__ int band_rows(int n, int R, int rank) {
  return max(0, min(R, n - rank * R));
}

// One lane's part of dense_adjoint: its J entries (le, le + E, ...) summed
// over its strand's rows q = s, s + S, ... in increasing q, U rows of loads
// in flight.  Every load is issued, from a valid address, and the terms of
// the rows past m (the last batch) are 0: no branch between the loads.
template <int NP, int J>
__device__ __forceinline__ void adjoint_lane(const float* __restrict__ G,
                                             const float* __restrict__ g, int n, int m, int r0,
                                             int RNb, int ent, int E, int S, int s, int le,
                                             const float* w, int wstride, float* outG,
                                             int gstride, float* outg, int xstride,
                                             float* scratch) {
  const size_t nn = static_cast<size_t>(n) * n;
  const float* p[J];
  size_t stride[J];
  bool ok[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int e = le + j * E;
    ok[j] = e < ent;
    const bool inG = e < RNb;
    p[j] = !ok[j] ? G : inG ? G + static_cast<size_t>(r0) * n + e : g + r0 + (e - RNb);
    stride[j] = inG ? nn : static_cast<size_t>(n);
  }
  float acc[NP][J];
#pragma unroll
  for (int P = 0; P < NP; ++P)
#pragma unroll
    for (int j = 0; j < J; ++j) acc[P][j] = 0.0f;
  constexpr int U = kAdjLoads / J;
  for (int q = s; q < m; q += U * S) {
    float v[J][U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int qu = q + u * S;
      const size_t qs = qu < m ? qu : 0;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float x = __ldg(p[j] + qs * stride[j]);
        v[j][u] = ok[j] && qu < m ? x : 0.0f;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int qu = q + u * S;
#pragma unroll
      for (int P = 0; P < NP; ++P) {
        const float wv = qu < m ? w[P * wstride + qu] : 0.0f;
#pragma unroll
        for (int j = 0; j < J; ++j) acc[P][j] += wv * v[j][u];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    if (!ok[j]) continue;
    const int e = le + j * E;
#pragma unroll
    for (int P = 0; P < NP; ++P) {
      if (S > 1) {
        scratch[(P * S + s) * E + e] = acc[P][j];
      } else if (e < RNb) {
        outG[P * gstride + e] = acc[P][j];
      } else {
        outg[P * xstride + e - RNb] = acc[P][j];
      }
    }
  }
}

// out(P, e) for every entry e of the band and point P: the sum over q in
// [0, m) of w[P wstride + q] times entry e of row q, where entries
// e < rows n are the band's entries of G_q (contiguous: G_q rows
// [r0, r0 + rows)) and rows n <= e < rows n + rows its entries of g_q.  The
// entries go to E = min(entries, kThreads) lanes, J = ceil(entries / E) a
// lane; the q range to S = kThreads / E strands (q = s, s + S, ...), each in
// increasing q, their partials summed in strand order.  outG[P gstride + e],
// outg[P xstride + i].  scratch: NP kThreads floats.  Every thread calls it;
// the caller syncs after.
template <int NP>
__device__ void dense_adjoint(const float* __restrict__ G, const float* __restrict__ g, int n,
                              int m, int r0, int rows, const float* w, int wstride,
                              float* outG, int gstride, float* outg, int xstride,
                              float* scratch) {
  const int RNb = rows * n, ent = RNb + rows;
  if (ent == 0) return;                         // uniform across the CTA
  const int E = min(ent, kThreads), S = kThreads / E, J = (ent + E - 1) / E;
  const int t = threadIdx.x, s = t / E, le = t % E;
  if (s < S) {
    if (J == 1) {
      adjoint_lane<NP, 1>(G, g, n, m, r0, RNb, ent, E, S, s, le, w, wstride, outG, gstride,
                          outg, xstride, scratch);
    } else if (J == 2) {
      adjoint_lane<NP, 2>(G, g, n, m, r0, RNb, ent, E, S, s, le, w, wstride, outG, gstride,
                          outg, xstride, scratch);
    } else {
      adjoint_lane<NP, kMaxJ>(G, g, n, m, r0, RNb, ent, E, S, s, le, w, wstride, outG,
                              gstride, outg, xstride, scratch);
    }
  }
  if (S > 1) {
    __syncthreads();
    for (int i = t; i < NP * ent; i += kThreads) {
      const int P = i / ent, e = i % ent;
      float sum = 0.0f;
      for (int r = 0; r < S; ++r) sum += scratch[(P * S + r) * E + e];
      if (e < RNb) {
        outG[P * gstride + e] = sum;
      } else {
        outg[P * xstride + e - RNb] = sum;
      }
    }
  }
}

// Each dense row's partial over this CTA's band at NP points,
// sum_{e < rows n} G_q[band e] vX[P vstride + e] + sum_{i < rows} g_q[r0 + i]
// vx[P xstride + i], sent to the owner of q (q / mc) as
// dst[(P C + rank) mc + q - owner mc] in the owner's shared memory.  L lanes
// a row, the least power of two (at most 32) with kResMax entries a lane:
// a small band takes several rows a warp at once.  Each lane loads all of
// its entries of G_q at once (kResMax loads, every one issued, from a
// clamped, valid index, so nothing orders them) and its entry of g_q, sums
// them in order, then a butterfly over the L lanes.  A CTA without rows
// sends nothing (the owners sum the ranks that have rows).
template <int NP>
__device__ void dense_residuals(cg::cluster_group& cluster, const float* __restrict__ G,
                                const float* __restrict__ g, int n, int m, int r0, int rows,
                                int rank, int C, int mc, const float* vX, int vstride,
                                const float* vx, int xstride, float* dst) {
  const int RNb = rows * n, ent = RNb + rows;
  if (ent == 0 || m == 0) return;
  int L = 1;                                    // kResMax L >= ent (check_shape)
  while (L < 32 && L * kResMax < ent) L <<= 1;
  const size_t nn = static_cast<size_t>(n) * n;
  const int sub = threadIdx.x % L, groups = kThreads / L;
  const float* Gb = G + static_cast<size_t>(r0) * n;
  const float* gb = g + r0;
  const int gi = min(sub, rows - 1);
  for (int qb = 0; qb < m; qb += groups) {      // the same trip count in every lane
    const int q = qb + static_cast<int>(threadIdx.x) / L;
    const int qc = min(q, m - 1);               // a valid row for the lanes past m
    const float* Gq = Gb + static_cast<size_t>(qc) * nn;
    float v[kResMax];
#pragma unroll
    for (int k = 0; k < kResMax; ++k) v[k] = __ldg(Gq + min(sub + k * L, RNb - 1));
    const float gv = __ldg(gb + static_cast<size_t>(qc) * n + gi);
    float acc[NP];
#pragma unroll
    for (int P = 0; P < NP; ++P) acc[P] = 0.0f;
#pragma unroll
    for (int k = 0; k < kResMax; ++k) {
      const int e = sub + k * L;
      if (e < RNb) {
#pragma unroll
        for (int P = 0; P < NP; ++P) acc[P] += v[k] * vX[P * vstride + e];
      }
    }
    for (int i = sub; i < rows; i += L) {      // one entry a lane: rows <= L at C = 16
      const float x = i == sub ? gv : __ldg(gb + static_cast<size_t>(qc) * n + i);
#pragma unroll
      for (int P = 0; P < NP; ++P) acc[P] += x * vx[P * xstride + i];
    }
    for (int o = L / 2; o > 0; o >>= 1) {
#pragma unroll
      for (int P = 0; P < NP; ++P) acc[P] += __shfl_xor_sync(0xffffffffu, acc[P], o);
    }
    if (q < m && sub == 0) {
      const int own = q / mc;
      float* d = cluster.map_shared_rank(dst, own);
#pragma unroll
      for (int P = 0; P < NP; ++P) d[(P * C + rank) * mc + q - own * mc] = acc[P];
    }
  }
}

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
//           entries), keeps their state and sums in registers, and owns a
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
constexpr int kMaxE = 496;       // entries (of X and x) a CTA of the grid owns: <= 128
                                 // chunks, and at most one entry of X a thread
constexpr int kScratch = 2048;   // strand partials (<= 4 kThreads), weights (<= 4 (kMaxE + 12))
constexpr int kSmemWords = 232448 / 4;   // the "grid" plan takes a CTA's whole shared memory

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The first kStages - 1 stages of a stream of nst stages into the ring;
// issue(s, dst) issues stage s's copies (every thread its share).
template <class Issue>
__device__ __forceinline__ void ring_prologue(float* ring, int nst, Issue issue) {
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) issue(s, ring + s * kStage);
    cp_async_commit();
  }
}

// The rest of the stream: stage s is consumed once it has landed, while the
// stages up to s + kStages - 1 are in flight.  Every thread calls it.
template <class Issue, class Consume>
__device__ __forceinline__ void ring_drain(float* ring, int nst, Issue issue, Consume consume) {
#pragma unroll 1
  for (int s = 0; s < nst; ++s) {
    const int nx = s + kStages - 1;
    if (nx < nst) issue(nx, ring + (nx % kStages) * kStage);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    consume(s, ring + (s % kStages) * kStage);
    __syncthreads();
  }
}

// A barrier over a cooperative grid of P CTAs: an arrival counter (zeroed
// by the launch) and a spin of one thread a CTA until all have arrived.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target, unsigned P) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += P;
    __threadfence();
    atomicAdd(bar, 1u);
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(bar) : "memory");
    } while (v < target);
    __threadfence();
  }
  __syncthreads();
}

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

// ---- "grid" ---------------------------------------------------------------

// Offsets, in 4-byte words, of one CTA's dynamic shared memory: the slab
// (the owned segments of G's rows, resident or a ring of stages) takes what
// the rest leaves of kSmemWords, and at least the ring.
// lp/pdhg_dense.py::_block_words mirrors the sum; the launch checks it.
struct GridLayout {
  int scr;       // (kScratch,) the adjoint's window partials; then the residual's weights
  int slab;      // the rows' owned segments, resident or streamed
  int yD;        // (m,) replica of yD
  int own;       // (kMaxE,) the adjoint of the owned entries; then their [Xb | xb]
  int words;
};

__host__ __device__ inline GridLayout grid_layout(int n, int m) {
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

// [lo, hi) of the b-th of P near-equal slices of [0, N)
__device__ __forceinline__ void slice(int N, int b, int P, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(N) * b / P);
  hi = static_cast<int>(static_cast<long long>(N) * (b + 1) / P);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// A CTA's slices of the "grid" plan and the passes over them, shared by the
// block and its check: CTA b's entries of X [e0, e1), of x [i0, i1) and rows
// [q0, q1); the rows' owned segments, row q's G_q[e0, e1) and g_q[i0, i1),
// each as the 16-byte-aligned span that holds it (SA, SB floats: ca, cb
// chunks of 4), ES floats a row.  Entry j of G's part sits at span position
// shA(q) + j, of g's part at SA + shB(q) + j.
struct GridCta {
  const BlockArgs* a;
  int n, m, NN, P, b, t;
  int e0, e1, i0, i1, q0, q1, LA, LB, E;
  int SA, SB, ES, ca, cr;
  bool resident;
  int QB, nst;
  int NS, st, ct;               // the adjoint's lanes: chunk ct of strand st (rows q = st mod NS)
  int RL, RG, rg, rl;           // the residuals' lanes: RL a row, group rg of RG
  float *scr, *slab, *syD, *sown;

  __device__ __forceinline__ GridCta(const BlockArgs& args, float* sm) : a(&args) {
    n = args.n;
    m = args.m;
    NN = n * n;
    P = static_cast<int>(gridDim.x);
    b = static_cast<int>(blockIdx.x);
    t = threadIdx.x;
    const GridLayout L = grid_layout(n, m);
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
__device__ __forceinline__ void grid_check(const BlockArgs& a, unsigned target, float rX, float rA,
                                        float rB, float raX, float raA, float raB, float rcX,
                                        float rx, float rax) {
  extern __shared__ __align__(16) float sm[];
  const GridCta g(a, sm);
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
      ring_prologue(slab, nst, issue);
      ring_drain(slab, nst, issue, [&](int s, const float* buf) {
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
      for (int j = 0; j < kCols / 32; ++j) {      // every load issued, then the sums in order
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

template <bool kCheck>
__global__ void __launch_bounds__(kThreads, 1) pdhg_dense_grid_kernel(
    const __grid_constant__ BlockArgs a) {
  extern __shared__ __align__(16) float sm[];
  if (a.rec[kRecStop]) return;        // stopped: every CTA leaves before any barrier
  const float tau = __int_as_float(a.rec[kRecTau]), sigma = __int_as_float(a.rec[kRecSigma]);
  const int n = a.n, m = a.m, NN = n * n;
  const int P = static_cast<int>(gridDim.x), b = static_cast<int>(blockIdx.x);
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const GridCta g(a, sm);
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
  ring_prologue(slab, a.iters > 0 ? nst : 0, issue);

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
      ring_drain(slab, nst, issue, [&](int s, const float* buf) {
        adjoint(acc, s * QB, min(QB, m - s * QB), buf);
      });
      ring_prologue(slab, nst, issue);    // phase II's first stages, early
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
      ring_drain(slab, nst, issue, [&](int s, const float* buf) {
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
      if (!resident) ring_prologue(slab, nst, issue);   // the next iteration's first stages
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
  if constexpr (kCheck) grid_check(a, target, rX, rA, rB, raX, raA, raB, rcX, rx, rax);
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

template <bool kCheck>
__global__ void __launch_bounds__(kThreads, 1) pdhg_dense_cta_kernel(
    const __grid_constant__ BlockArgs a) {
  extern __shared__ __align__(16) float sm[];
  if (a.rec[kRecStop]) return;
  const float tau = __int_as_float(a.rec[kRecTau]), sigma = __int_as_float(a.rec[kRecSigma]);
  const int n = a.n, m = a.m, NN = n * n, V = NN + n, V4 = cta_row(n), Q4 = V4 / 4;
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
  for (int p = t; p < m * V4; p += kThreads) {
    const int q = p / V4, v = p - q * V4;
    if (v < NN) {
      cp_async4(W + p, a.G + static_cast<size_t>(q) * NN + v);
    } else if (v < V) {
      cp_async4(W + p, a.g + static_cast<size_t>(q) * n + (v - NN));
    } else {
      W[p] = 0.0f;
    }
  }
  cp_async_commit();
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

  // the adjoint's lanes: entries 4 k4 .. 4 k4 + 3 of strand sj, whose rows
  // are the block [sj m / NS, (sj + 1) m / NS), NS strands
  const int NS = max(1, kThreads / Q4);
  const int sj = t / Q4, k4 = t % Q4;
  const int qa = static_cast<int>(static_cast<long long>(m) * sj / NS);
  const int qe = static_cast<int>(static_cast<long long>(m) * (sj + 1) / NS);
  // the residuals' lanes: RL a row (the least power of two with at most
  // kRowJ / 4 quads a lane, at most 32), group t / RL of RG = kThreads / RL;
  // lane l keeps [Xb | xb] at quads l + RL j in registers
  int RL = 1;
  while (RL < 32 && RL * (kRowJ / 4) < Q4) RL <<= 1;
  const int RG = kThreads / RL, rg = t / RL, rl = t % RL;
  const bool fast = RL * (kRowJ / 4) >= Q4;

  for (int it = 0; it < a.iters; ++it) {
    // ---- the adjoint sum_q yD_q [G_q | g_q]: each strand's rows in order,
    //      then the strands in order ------------------------------------------
    if (sj < NS) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int q = qa; q < qe; ++q) {
        const float w = syD[q];
        const float4 v = *reinterpret_cast<const float4*>(W + q * V4 + 4 * k4);
        acc.x = fmaf(w, v.x, acc.x);
        acc.y = fmaf(w, v.y, acc.y);
        acc.z = fmaf(w, v.z, acc.z);
        acc.w = fmaf(w, v.w, acc.w);
      }
      *reinterpret_cast<float4*>(sstr + sj * V4 + 4 * k4) = acc;
    }
    __syncthreads();
    for (int v = t; v < V; v += kThreads) {
      float s = 0.0f;
      for (int r = 0; r < NS; ++r) s += sstr[r * V4 + v];
      sgD[v] = s;
    }
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

    // ---- the residuals, RL lanes a row (a butterfly), then yD and its sum ----
    // (the same trip count in every lane: rows past m redo row m - 1
    // unstored; every load issued, from a clamped quad, its weight 0 past V4)
    if (fast) {
      float4 wr[kRowJ / 4];
#pragma unroll
      for (int j = 0; j < kRowJ / 4; ++j) {
        const int k = rl + RL * j;
        wr[j] = k < Q4 ? *reinterpret_cast<const float4*>(swv + 4 * k)
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
      for (int qb = 0; qb < m; qb += RG) {
        const int q = qb + rg;
        const float* Wq = W + min(q, m - 1) * V4;
        float r = 0.0f;
#pragma unroll
        for (int j = 0; j < kRowJ / 4; ++j) {
          const float4 v = *reinterpret_cast<const float4*>(Wq + 4 * min(rl + RL * j, Q4 - 1));
          r = fmaf(v.x, wr[j].x, r);
          r = fmaf(v.y, wr[j].y, r);
          r = fmaf(v.z, wr[j].z, r);
          r = fmaf(v.w, wr[j].w, r);
        }
        for (int o = RL / 2; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
        if (rl == 0 && q < m) sres[q] = r;
      }
    } else {
      for (int qb = 0; qb < m; qb += RG) {
        const int q = qb + rg;
        const float* Wq = W + min(q, m - 1) * V4;
        float r = 0.0f;
        for (int k = rl; k < Q4; k += RL) {
          const float4 v = *reinterpret_cast<const float4*>(Wq + 4 * k);
          const float4 w = *reinterpret_cast<const float4*>(swv + 4 * k);
          r = fmaf(v.x, w.x, r);
          r = fmaf(v.y, w.y, r);
          r = fmaf(v.z, w.z, r);
          r = fmaf(v.w, w.w, r);
        }
        for (int o = RL / 2; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
        if (rl == 0 && q < m) sres[q] = r;
      }
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
      if (sj < NS) {
        float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
        for (int q = qa; q < qe; ++q) {
          const float w = pD[q] * sc;
          const float4 v = *reinterpret_cast<const float4*>(W + q * V4 + 4 * k4);
          acc.x = fmaf(w, v.x, acc.x);
          acc.y = fmaf(w, v.y, acc.y);
          acc.z = fmaf(w, v.z, acc.z);
          acc.w = fmaf(w, v.w, acc.w);
        }
        *reinterpret_cast<float4*>(sstr + sj * V4 + 4 * k4) = acc;
      }
      // [X | x] at the point, the residuals' weights
      for (int e = t; e < NN; e += kThreads) swv[e] = pX[e] * sc;
      for (int i = t; i < n; i += kThreads) swv[NN + i] = px[i] * sc;
      __syncthreads();
      for (int v = t; v < V; v += kThreads) {
        float s = 0.0f;
        for (int r = 0; r < NS; ++r) s += sstr[r * V4 + v];
        sgD[v] = s;
      }
      // the rows' residuals <G_q, X> + g_q . x, RL lanes a row
      for (int qb = 0; qb < m; qb += RG) {
        const int q = qb + rg;
        const float* Wq = W + min(q, m - 1) * V4;
        float r = 0.0f;
        for (int k = rl; k < Q4; k += RL) {
          const float4 v = *reinterpret_cast<const float4*>(Wq + 4 * k);
          const float4 w = *reinterpret_cast<const float4*>(swv + 4 * k);
          r = fmaf(v.x, w.x, r);
          r = fmaf(v.y, w.y, r);
          r = fmaf(v.z, w.z, r);
          r = fmaf(v.w, w.w, r);
        }
        for (int o = RL / 2; o > 0; o >>= 1) r += __shfl_xor_sync(0xffffffffu, r, o);
        if (rl == 0 && q < m) sres[q] = r;
      }
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

// ---- the norm -------------------------------------------------------------

struct NormArgs {
  int n, m, R, mc, nr, iters;
  const float *G, *g;
  float *y, *Y;       // (n,), (n, n): the start vector in, the last iterate out
  float* out;         // ||K|| 1.02 + 1e-12
};

struct NormLayout {
  int kA, kB, gX, GT, Zb, D;   // (R, n) bands: K's first two blocks, gX, the transposed
                               // tiles, the band of Y / nrm, the dense adjoint
  int rowA, rowB;              // (R, kWarpsPerRow) row partials of kA, kB
  int colP;                    // (C kGroups, R) column partials of kB
  int xs;                      // (kCols,) x = y / nrm
  int gx, gD;                  // (R,) the band's gx and its dense part
  int kDp;                     // (C, mc) the ranks' partials of the owned rows
  int kD;                      // (m,) replica of K's dense block
  int red;                     // (C, 4) every rank's sums of squares (norm, last step)
  int scratch;                 // (kThreads,) strand partials and block sums
  int tot;                     // (4,) this CTA's sums
  int words;
};

__host__ __device__ inline NormLayout norm_layout(int n, int m, int C) {
  const int R = (n + C - 1) / C, mc = (m + C - 1) / C, RN = R * n;
  NormLayout L;
  int o = 0;
#define TAKE(field, words) L.field = o; o += (words)
  TAKE(kA, RN); TAKE(kB, RN); TAKE(gX, RN); TAKE(GT, RN); TAKE(Zb, RN); TAKE(D, RN);
  TAKE(rowA, R * kWarpsPerRow); TAKE(rowB, R * kWarpsPerRow);
  TAKE(colP, C * kGroups * R);
  TAKE(xs, kCols); TAKE(gx, R); TAKE(gD, R);
  TAKE(kDp, C * mc); TAKE(kD, m);
  TAKE(red, C * 4);
  TAKE(scratch, kThreads);
  TAKE(tot, 4);
#undef TAKE
  L.words = o;
  return L;
}

__global__ void __launch_bounds__(kThreads, 1) pdhg_dense_norm_kernel(
    const __grid_constant__ NormArgs a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = a.n, m = a.m, R = a.R, mc = a.mc;
  const NormLayout L = norm_layout(n, m, C);
  float* const y = a.y;
  float* const Y = a.Y;
  float* const skA = sm + L.kA;
  float* const skB = sm + L.kB;
  float* const sgX = sm + L.gX;
  float* const sGT = sm + L.GT;
  float* const sZb = sm + L.Zb;
  float* const sD = sm + L.D;
  float* const srowA = sm + L.rowA;
  float* const srowB = sm + L.rowB;
  float* const scolP = sm + L.colP;
  float* const sxs = sm + L.xs;
  float* const sgx = sm + L.gx;
  float* const sgD = sm + L.gD;
  float* const skDp = sm + L.kDp;
  float* const skD = sm + L.kD;
  float* const sred = sm + L.red;

  const int t = threadIdx.x;
  const int c = t % kCols;
  const int grp = t / kCols;
  const int lane = t % 32;
  const int wr = c / 32;
  const int r0 = rank * R;
  const int rows = band_rows(n, R, rank);
  const int q0 = rank * mc;
  const int qn = max(0, min(mc, m - q0));

  float nrm = 1.0f;        // the start vector is used as it is (x / 1 = x)
  cluster.sync();          // every CTA has started before any remote store
  for (int it = 0;; ++it) {
    const bool last = it == a.iters;
    // ---- 1: K z at z = (y, Y) / nrm; the dense rows' partials to the owners
    for (int j = t; j < n; j += kThreads) sxs[j] = y[j] / nrm;
    __syncthreads();
    float sq[2] = {0.0f, 0.0f};      // the last step's sums of kA^2 + kB^2, kD^2
    float cb = 0.0f;
    for (int il = grp; il < rows; il += kGroups) {   // uniform across each warp
      float va = 0.0f, vb = 0.0f;
      if (c < n) {
        const int i = r0 + il, e = il * n + c;
        const float Xv = Y[static_cast<size_t>(i) * n + c] / nrm;
        sZb[e] = Xv;
        va = kSA * (sxs[i] - Xv);
        vb = kSB * (Xv - sxs[i] - sxs[c]);
        skA[e] = va;
        skB[e] = vb;
        sq[0] += va * va + vb * vb;
        cb += vb;
      }
      const float rA = warp_sum(va);
      const float rB = warp_sum(vb);
      if (lane == 0) {
        srowA[il * kWarpsPerRow + wr] = rA;
        srowB[il * kWarpsPerRow + wr] = rB;
      }
    }
    if (c < n && !last) {
      const int oc = c / R;
      cluster.map_shared_rank(scolP, oc)[(rank * kGroups + grp) * R + (c - oc * R)] = cb;
    }
    __syncthreads();
    dense_residuals<1>(cluster, a.G, a.g, n, m, r0, rows, rank, C, mc, sZb, 0, sxs + r0, 0, skDp);
    cluster.sync();

    // ---- the owners sum their rows' K z; on the last step, ||K z||^2 ------
    for (int j = t; j < qn; j += kThreads) {
      float kD = 0.0f;
      for (int r = 0; r < a.nr; ++r) kD += skDp[r * mc + j];
      if (last) {
        sq[1] += kD * kD;
      } else {
        for (int r = 0; r < C; ++r) cluster.map_shared_rank(skD, r)[q0 + j] = kD;
      }
    }
    if (last) {
      block_sums(sq, sm + L.scratch, sm + L.tot);
      // columns 2, 3 of rank 0's sums: a CTA may still be reading columns
      // 0, 1 for the last norm
      if (t < 2) cluster.map_shared_rank(sred, 0)[rank * 4 + 2 + t] = sm[L.tot + t];
      cluster.sync();
      if (rank == 0 && t == 0) {
        float s0 = 0.0f, sD = 0.0f;
        for (int r = 0; r < C; ++r) {
          s0 += sred[r * 4 + 2];
          sD += sred[r * 4 + 3];
        }
        *a.out = sqrtf(s0 + sD) * 1.02f + 1e-12f;
      }
      break;
    }
    cluster.sync();

    // ---- 2: (gx, gX) = K^T (kA, kB, 0, kD) over the band -------------------
    dense_adjoint<1>(a.G, a.g, n, m, r0, rows, skD, m, sD, 0, sgD, 0, sm + L.scratch);
    __syncthreads();
    if (t < rows) {
      float sa = 0.0f, sb = 0.0f, sc = 0.0f;
#pragma unroll
      for (int q = 0; q < kWarpsPerRow; ++q) {
        sa += srowA[t * kWarpsPerRow + q];
        sb += srowB[t * kWarpsPerRow + q];
      }
      for (int q = 0; q < C * kGroups; ++q) sc += scolP[q * R + t];
      sgx[t] = (kSA * sa - kSB * (sb + sc)) + sgD[t];
    }
    if (c < n) {
      for (int il = grp; il < rows; il += kGroups) {
        const int i = r0 + il, e = il * n + c;
        const float gX = (-kSA * skA[e] + kSB * skB[e]) + sD[e];
        sgX[e] = gX;
        const int oc = c / R;
        cluster.map_shared_rank(sGT, oc)[(c - oc * R) * n + i] = gX;
      }
    }
    cluster.sync();

    // ---- 3: the new iterate (unnormalised) and its norm --------------------
    float ss[2] = {0.0f, 0.0f};
    if (t < rows) {
      const float gx = sgx[t];
      y[r0 + t] = gx;
      ss[0] = gx * gx;
    }
    if (c < n) {
      for (int il = grp; il < rows; il += kGroups) {
        const int e = il * n + c;
        const float s = 0.5f * (sgX[e] + sGT[e]);
        Y[static_cast<size_t>(r0 + il) * n + c] = s;
        ss[1] += s * s;
      }
    }
    block_sums(ss, sm + L.scratch, sm + L.tot);
    if (t < 2) {
      for (int r = 0; r < C; ++r) cluster.map_shared_rank(sred, r)[rank * 4 + t] = sm[L.tot + t];
    }
    cluster.sync();
    float s0 = 0.0f, s1 = 0.0f;
    for (int r = 0; r < C; ++r) {
      s0 += sred[r * 4];
      s1 += sred[r * 4 + 1];
    }
    nrm = sqrtf(s0 + s1) + 1e-30f;
  }
}

// The launch's shape: 1 <= n <= kCols, a cluster of at most kMaxCluster CTAs
// whose bands fit the adjoint's lanes, m >= 0, and the caller's shared bytes
// equal to this file's layout.
int check_shape(int n, int m, int cluster, int smem, int words) {
  if (cluster < 1 || cluster > kMaxCluster || n < 1 || n > kCols || m < 0) return kErrLayout;
  const int R = (n + cluster - 1) / cluster;
  if (R * n + R > kMaxEntries || R * n + R > kMaxJ * kThreads) return kErrLayout;
  if (4 * static_cast<size_t>(words) != static_cast<size_t>(smem)) return kErrLayout;
  return 0;
}

template <class Kernel, class Args>
int launch_one(Kernel kernel, int checked[2], int cluster, int smem, const Args& a, void* stream) {
  const int err = prepare_cluster(kernel, cluster, smem, checked);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(cluster, 1, smem, static_cast<cudaStream_t>(stream), attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

int ranks_with_rows(int n, int cluster) {
  const int R = (n + cluster - 1) / cluster;
  return (n + R - 1) / R;
}

// The cooperative grid of the "grid" plan with smem bytes a CTA, into *P:
// as many CTAs as the card holds at once (each SM's share times the SMs) of
// both forms, unchecked and checked, so that the two run the same grid and
// the block's sums the same order.  Returns 0, a CUDA error or kErrNoCluster
// (not one CTA fits).
int dense_grid(int smem, int* P) {
  static int cached[3] = {-1, -1, 0};   // device, smem, CTAs
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (cached[0] != dev || cached[1] != smem) {
    int per_sm[2] = {0, 0}, sms = 0;
    const void* kernels[2] = {reinterpret_cast<const void*>(pdhg_dense_grid_kernel<false>),
                              reinterpret_cast<const void*>(pdhg_dense_grid_kernel<true>)};
    for (int f = 0; f < 2; ++f) {
      e = cudaFuncSetAttribute(kernels[f], cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[f], kernels[f], kThreads,
                                                        static_cast<size_t>(smem));
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
    cached[0] = dev;
    cached[1] = smem;
    cached[2] = (per_sm[0] < per_sm[1] ? per_sm[0] : per_sm[1]) * sms;
  }
  *P = cached[2];
  return *P < 1 ? kErrNoCluster : 0;
}

// One launch of the block (kCheck: its checked form) under plan 0 "cta" or
// 1 "grid"; the shape and smem already checked.
template <bool kCheck>
int launch_block(const BlockArgs& a, int plan, int smem, int* grid, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = st;
  cudaError_t e;
  if (plan == 0) {
    static int checked = -1;
    if (checked != smem) {
      e = cudaFuncSetAttribute(pdhg_dense_cta_kernel<kCheck>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return static_cast<int>(e);
      checked = smem;
    }
    cfg.gridDim = dim3(1, 1, 1);
    *grid = 1;
    e = cudaLaunchKernelEx(&cfg, pdhg_dense_cta_kernel<kCheck>, a);
  } else {
    int P = 0;
    const int err = dense_grid(smem, &P);
    if (err != 0) return err;
    const int n = a.n;
    if ((n * n + P - 1) / P + (n + P - 1) / P > kMaxE || (n + P - 1) / P > kThreads / 32)
      return kErrLayout;
    if (kCheck && 256 + P * kND > kScratch) return kErrLayout;   // CTA 0's copy of the distances
    e = cudaMemsetAsync(a.bar, 0, sizeof(unsigned), st);
    if (e != cudaSuccess) return static_cast<int>(e);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.gridDim = dim3(P, 1, 1);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    *grid = P;
    e = cudaLaunchKernelEx(&cfg, pdhg_dense_grid_kernel<kCheck>, a);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

int check_block(int n, int m, int iters, int plan, int smem) {
  if (n < 1 || n > kCols || m < 0 || iters < 0 || (plan != 0 && plan != 1)) return kErrLayout;
  const int words = plan == 0 ? cta_layout(n, m).words : grid_layout(n, m).words;
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
  if (n < 1 || n > kCols || m < 0) return kErrLayout;
  if (4 * static_cast<size_t>(grid_layout(n, m).words) != static_cast<size_t>(smem))
    return kErrLayout;
  return dense_grid(smem, grid);
}

// ||K|| 1.02 + 1e-12 over the McCormick rows and the m dense rows after
// `iters` power iterations from (y, Y), which hold the start vector on entry
// and are overwritten; written to out[0].  Returns 0, a CUDA error,
// kErrLayout or kErrNoCluster.
extern "C" int pdhg_dense_norm_launch(int n, int m, int cluster, int smem, int iters,
                                      const float* G, const float* g, float* y, float* Y,
                                      float* out, void* stream) {
  static int checked[2] = {0, -1};
  const int err = check_shape(n, m, cluster, smem, norm_layout(n, m, cluster).words);
  if (err != 0) return err;
  if (iters < 0) return kErrLayout;
  const NormArgs a{n, m, (n + cluster - 1) / cluster, (m + cluster - 1) / cluster,
                   ranks_with_rows(n, cluster), iters, G, g, y, Y, out};
  return launch_one(pdhg_dense_norm_kernel, checked, cluster, smem, a, stream);
}
