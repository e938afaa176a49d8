// The dense-row route of the PDHG solve, K7: the SDP certifier's LP
// (loop/sdp_bound.py), whose pool holds no cut and whose m dense rows (the
// eigencuts, up to the buffer's capacity, 2048 by default) do not fit K2's
// shared memory.  Three kernels, float32, one thread-block cluster of C CTAs
// for the one instance:
//
//   pdhg_dense_block_kernel  `iters` iterations of lp/pdhg.py::_one_iter with
//       an empty pool, every iterate added to the ergodic sums; tau, sigma and
//       the stop flag from the solve's control record (pdhg_common.cuh), as
//       K2 (pdhg_block.cu) reads them.  Twin: pdhg_block_plain.
//   pdhg_dense_check_kernel  the checked block's control after each block, as
//       K5 (pdhg_check.cu) does it: both KKT errors with the dense residuals,
//       the current-or-average choice, restart, omega, the stop test and the
//       next steps, into the record.  Twin: pdhg_check_plain.
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
// (76 us).  Everything else is K2's n^2 work, well under a microsecond.
// Measured (PERF.md section 6): one cluster streams G at ~0.5 TB/s, 20-35
// GB/s an SM at clusters of 4, 8 and 16, far from HBM's rate: the loads a
// warp keeps in flight, not the bytes, set the pace, so the next step is
// the whole card (ROADMAP) or deeper load pipelines.
//
// Design: K2's cluster and bands (pdhg_common.cuh): CTA r owns rows
// [r R, min(n, (r + 1) R)) of every (n, n) array, R = ceil(n / C), and keeps
// its bands of X, yA, yB, cX, the sums and the primal pre-step in shared
// memory for the whole block launch, exchanging the transposed tile, the
// column sums of yB and xb through distributed shared memory as K2 does.  The
// dense rows are never copied to shared memory: each pass streams the band's
// slice of every G_q and g_q from global memory (L2 when it fits), so nothing
// in shared memory grows with m n.  Each CTA also owns a slice of the dense
// rows, [r mc, (r + 1) mc), mc = ceil(m / C): every rank sends its partial of
// <G_q, Xb> + g_q . xb over its band to the owner of q, the owner sums the
// ranks' partials in rank order, updates yD_q and its sum, and sends yD_q to
// every CTA's replica of yD.  So shared memory holds m + (C + 2) mc floats of
// the dense rows, not C m.  An iteration:
//   D   the band's dense adjoint sum_q yD_q G_q (and sum_q yD_q g_q for the
//       band's x): band entries to lanes, q in increasing order (on few
//       entries the q range is split into strands summed in strand order);
//   A   gX, S = X - tau (cX - gX), S's transposed tile to the column owners,
//       the row sums and column partials of yB (K2's phase A);
//                                                           cluster barrier 1
//   B1  gx, the x step and xb to every CTA; X = clip(sym(S)), Xb (K2's B1);
//                                                           cluster barrier 2
//   B2  dual ascent on yA, yB; each dense row's partial over the band to its
//       owner (L lanes a row, a butterfly);                 cluster barrier 3
//   F   the owners fold their rows' partials, step yD and push it to every
//       CTA.                                                cluster barrier 4
// The check and the norm use the same two passes (D and the residuals to the
// owners) at their evaluation points: the check at the current iterate and
// the average at once (one pass over G serves both), the norm at each power
// iterate.  No atomics and one fixed order for every sum, so a launch
// repeats bit for bit; the twins sum in torch's order and agree to rounding.
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

struct BlockArgs {
  int n, m, iters, R, mc, nr;            // nr: the ranks that own rows
  const int* rec;                        // the solve's control record
  const float *cx, *cX, *G, *g, *h;
  // inputs: x, X, yA, yB, yD, then the sums ax, aX, aA, aB, ayD
  const float *x, *X, *yA, *yB, *yD, *ax, *aX, *aA, *aB, *ayD;
  // outputs, in the same order (may be the inputs)
  float *xo, *Xo, *yAo, *yBo, *yDo, *axo, *aXo, *aAo, *aBo, *ayDo;
};

// Offsets, in 4-byte words, of one CTA's dynamic shared memory (the block).
// lp/pdhg_dense.py::smem_words mirrors the sum; the launch checks it.
struct BlockLayout {
  int X, yA, yB, cX, aX, aA, aB, S, Xb, ST, D;   // (R, n) bands
  int rowA, rowB;                                // (R, kWarpsPerRow) row partials
  int colP;                                      // (C kGroups, R) column partials
  int xs, axs, cxs, gD;                          // (R,) x, ax, cx and the dense g adjoint
  int xb;                                        // (kCols,) replica of xb
  int yD;                                        // (m,) replica of yD
  int h, ayD;                                    // (mc,) the owned rows' h and sum of yD
  int dpart;                                     // (C, mc) the ranks' partials of the owned rows
  int scratch;                                   // (kThreads,) strand partials
  int words;
};

__host__ __device__ inline BlockLayout block_layout(int n, int m, int C) {
  const int R = (n + C - 1) / C, mc = (m + C - 1) / C, RN = R * n;
  BlockLayout L;
  int o = 0;
#define TAKE(field, words) L.field = o; o += (words)
  TAKE(X, RN); TAKE(yA, RN); TAKE(yB, RN); TAKE(cX, RN); TAKE(aX, RN);
  TAKE(aA, RN); TAKE(aB, RN); TAKE(S, RN); TAKE(Xb, RN); TAKE(ST, RN); TAKE(D, RN);
  TAKE(rowA, R * kWarpsPerRow); TAKE(rowB, R * kWarpsPerRow);
  TAKE(colP, C * kGroups * R);
  TAKE(xs, R); TAKE(axs, R); TAKE(cxs, R); TAKE(gD, R);
  TAKE(xb, kCols);
  TAKE(yD, m);
  TAKE(h, mc); TAKE(ayD, mc);
  TAKE(dpart, C * mc);
  TAKE(scratch, kThreads);
#undef TAKE
  L.words = o;
  return L;
}

__global__ void __launch_bounds__(kThreads, 1) pdhg_dense_block_kernel(
    const __grid_constant__ BlockArgs a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  if (a.rec[kRecStop]) return;        // stopped: every CTA leaves before any barrier
  const float tau = __int_as_float(a.rec[kRecTau]), sigma = __int_as_float(a.rec[kRecSigma]);
  const int n = a.n, m = a.m, R = a.R, mc = a.mc;
  const BlockLayout L = block_layout(n, m, C);
  float* const sX = sm + L.X;
  float* const syA = sm + L.yA;
  float* const syB = sm + L.yB;
  float* const scX = sm + L.cX;
  float* const saX = sm + L.aX;
  float* const saA = sm + L.aA;
  float* const saB = sm + L.aB;
  float* const sS = sm + L.S;
  float* const sXb = sm + L.Xb;
  float* const sST = sm + L.ST;
  float* const sD = sm + L.D;
  float* const srowA = sm + L.rowA;
  float* const srowB = sm + L.rowB;
  float* const scolP = sm + L.colP;
  float* const sx = sm + L.xs;
  float* const sax = sm + L.axs;
  float* const scx = sm + L.cxs;
  float* const sgD = sm + L.gD;
  float* const sxb = sm + L.xb;
  float* const syD = sm + L.yD;
  float* const sh = sm + L.h;
  float* const sayD = sm + L.ayD;
  float* const sdpart = sm + L.dpart;
  float* const sscr = sm + L.scratch;

  const int t = threadIdx.x;
  const int r0 = rank * R;
  const int rows = band_rows(n, R, rank);
  const int q0 = rank * mc;
  const int qn = max(0, min(mc, m - q0));

  // ---- entry: the band, x, the yD replica and the owned rows, loaded once --
  for (int e = t; e < rows * n; e += kThreads) {
    const int ge = r0 * n + e;
    sX[e] = a.X[ge];
    syA[e] = a.yA[ge];
    syB[e] = a.yB[ge];
    scX[e] = a.cX[ge];
    saX[e] = a.aX[ge];
    saA[e] = a.aA[ge];
    saB[e] = a.aB[ge];
  }
  for (int i = t; i < rows; i += kThreads) {
    sx[i] = a.x[r0 + i];
    sax[i] = a.ax[r0 + i];
    scx[i] = a.cx[r0 + i];
  }
  for (int q = t; q < m; q += kThreads) syD[q] = a.yD[q];
  for (int j = t; j < qn; j += kThreads) {
    sh[j] = a.h[q0 + j];
    sayD[j] = a.ayD[q0 + j];
  }
  cluster.sync();

  for (int it = 0; it < a.iters; ++it) {
    // ---- D: the band's dense adjoint at yD ----------------------------------
    dense_adjoint<1>(a.G, a.g, n, m, r0, rows, syD, m, sD, 0, sgD, 0, sscr);
    __syncthreads();

    // ---- A: gX, the primal pre-step S, its transpose to the column owners,
    //      row sums (local) and column partials (to the owners) of yB --------
    mccormick_pre_step(cluster, sX, syA, syB, scX, sS, sST, srowA, srowB, scolP, tau, n, R, r0,
                       rows, rank, [&](int e, float base) { return base + sD[e]; });
    cluster.sync();

    // ---- B1: gx, x step, xb to every CTA; X projection and Xb --------------
    mccormick_primal_step(cluster, sx, sax, scx, sX, saX, sS, sST, sXb, sxb, srowA, srowB, scolP,
                          tau, n, R, r0, rows, C, [&](int i, float base) { return base + sgD[i]; });
    cluster.sync();

    // ---- B2: dual ascent on yA, yB; the dense rows' partials to the owners --
    mccormick_dual_step(syA, syB, saA, saB, sXb, sxb, sigma, n, r0, rows);
    dense_residuals<1>(cluster, a.G, a.g, n, m, r0, rows, rank, C, mc, sXb, 0, sxb + r0, 0,
                       sdpart);
    cluster.sync();

    // ---- F: the owners step their rows' yD and send it to every CTA ---------
    for (int j = t; j < qn; j += kThreads) {
      float kD = 0.0f;
      for (int r = 0; r < a.nr; ++r) kD += sdpart[r * mc + j];
      const int q = q0 + j;
      const float yd = fmaxf(syD[q] + sigma * (sh[j] - kD), 0.0f);
      sayD[j] += yd;
      for (int r = 0; r < C; ++r) cluster.map_shared_rank(syD, r)[q] = yd;
    }
    cluster.sync();
  }

  // ---- exit: the band, x and the owned rows of yD, stored once -------------
  // (after the last cluster barrier no CTA addresses another's shared memory)
  for (int e = t; e < rows * n; e += kThreads) {
    const int ge = r0 * n + e;
    a.Xo[ge] = sX[e];
    a.yAo[ge] = syA[e];
    a.yBo[ge] = syB[e];
    a.aXo[ge] = saX[e];
    a.aAo[ge] = saA[e];
    a.aBo[ge] = saB[e];
  }
  for (int i = t; i < rows; i += kThreads) {
    a.xo[r0 + i] = sx[i];
    a.axo[r0 + i] = sax[i];
  }
  for (int j = t; j < qn; j += kThreads) {
    a.yDo[q0 + j] = syD[q0 + j];
    a.ayDo[q0 + j] = sayD[j];
  }
}

// ---- the check ------------------------------------------------------------

constexpr int kNV = 8;     // partial sums per evaluation point
enum { kPX, kPx, kHyB, kHyD, kRxm, kSm, kV2, kVD2 };

struct Point {             // x, X, yA, yB, yD
  float *x, *X, *yA, *yB, *yD;
};

struct CheckArgs {
  int n, m, R, mc, nr;
  int check_every, restart_period, max_iters;
  float tol;
  const float *cx, *cX, *G, *g, *h;
  Point st, acc, anchor;
  int* rec;
};

struct CheckLayout {
  int xs, yd;              // [2] replicas: (kCols,), (m,)
  int Xb;                  // [2] (R, n) the band of X at both points
  int D, gD;               // [2] (R, n), (R,) the band's dense adjoint
  int Mt, MT;              // [2] (R, n) the band's M = cX - gX and the transposed tiles
  int rowA, rowB;          // [2] (R, kWarpsPerRow) row partials of yA, yB
  int colP;                // [2] (C kGroups, R) column partials of yB
  int kDp;                 // [2] (C, mc) the ranks' partials of the owned rows
  int red;                 // (C, 2 kNV) partial sums of every rank
  int dist;                // (C, kND) partial distances of every rank (rank 0's)
  int scratch;             // (2 kThreads) strand partials and block sums
  int tot;                 // (2 kNV + kND + 8) this CTA's sums, then the decision
  int words;
};

__host__ __device__ inline CheckLayout check_layout(int n, int m, int C) {
  const int R = (n + C - 1) / C, mc = (m + C - 1) / C, RN = R * n;
  CheckLayout L;
  int o = 0;
#define TAKE(field, words) L.field = o; o += (words)
  TAKE(xs, 2 * kCols); TAKE(yd, 2 * m);
  TAKE(Xb, 2 * RN); TAKE(D, 2 * RN); TAKE(gD, 2 * R);
  TAKE(Mt, 2 * RN); TAKE(MT, 2 * RN);
  TAKE(rowA, 2 * R * kWarpsPerRow); TAKE(rowB, 2 * R * kWarpsPerRow);
  TAKE(colP, 2 * C * kGroups * R);
  TAKE(kDp, 2 * C * mc);
  TAKE(red, C * 2 * kNV);
  TAKE(dist, C * kND);
  TAKE(scratch, 2 * kThreads);
  TAKE(tot, 2 * kNV + kND + 8);
#undef TAKE
  L.words = o;
  return L;
}

__global__ void __launch_bounds__(kThreads, 1) pdhg_dense_check_kernel(
    const __grid_constant__ CheckArgs a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  int* const rec = a.rec;
  if (rec[kRecStop]) return;          // stopped: every CTA leaves before any barrier
  const int n = a.n, m = a.m, R = a.R, mc = a.mc, RN = R * n;
  const int wlen = rec[kRecWlen] + a.check_every;
  const float inv = 1.0f / static_cast<float>(wlen);
  const CheckLayout L = check_layout(n, m, C);
  const Point st = a.st, acc = a.acc, anc = a.anchor;

  const int t = threadIdx.x;
  const int c = t % kCols;
  const int grp = t / kCols;
  const int lane = t % 32;
  const int wr = c / 32;
  const int r0 = rank * R;
  const int rows = band_rows(n, R, rank);
  const int q0 = rank * a.mc;
  const int qn = max(0, min(mc, m - q0));

  // the two evaluation points: P = 0 the current iterate, P = 1 the average
  const Point pt[2] = {st, acc};
  const float scale[2] = {1.0f, inv};

  // ---- replicas of x and yD, and the band of X, at both points -----------
#pragma unroll
  for (int P = 0; P < 2; ++P) {
    for (int j = t; j < n; j += kThreads) sm[L.xs + P * kCols + j] = pt[P].x[j] * scale[P];
    for (int q = t; q < m; q += kThreads) sm[L.yd + P * m + q] = pt[P].yD[q] * scale[P];
    for (int e = t; e < rows * n; e += kThreads)
      sm[L.Xb + P * RN + e] = pt[P].X[static_cast<size_t>(r0) * n + e] * scale[P];
  }
  cluster.sync();   // every CTA has started before any remote store

  // ---- the band's dense adjoint at both points, in one pass over G --------
  dense_adjoint<2>(a.G, a.g, n, m, r0, rows, sm + L.yd, m, sm + L.D, RN, sm + L.gD, R,
                   sm + L.scratch);
  __syncthreads();

  // ---- 1: M = cX - gX and its transpose, row and column sums, infeasibility;
  //      the dense rows' partials to the owners ---------------------------
  float part[2 * kNV];
#pragma unroll
  for (int j = 0; j < 2 * kNV; ++j) part[j] = 0.0f;
#pragma unroll
  for (int P = 0; P < 2; ++P) {
    const float* xs = sm + L.xs + P * kCols;
    float* v = part + P * kNV;
    float cb = 0.0f;
    for (int il = grp; il < rows; il += kGroups) {   // uniform across each warp
      float va = 0.0f, vb = 0.0f;
      if (c < n) {
        const int i = r0 + il, e = il * n + c;
        const size_t ge = static_cast<size_t>(i) * n + c;
        const float Xv = sm[L.Xb + P * RN + e];
        va = pt[P].yA[ge] * scale[P];
        vb = pt[P].yB[ge] * scale[P];
        const float gX = (-kSA * va + kSB * vb) + sm[L.D + P * RN + e];
        const float cXv = a.cX[ge];
        const float Mv = cXv - gX;
        sm[L.Mt + P * RN + e] = Mv;
        const int oc = c / R;
        cluster.map_shared_rank(sm + L.MT + P * RN, oc)[(c - oc * R) * n + i] = Mv;
        v[kPX] += cXv * Xv;
        v[kHyB] += vb;
        const float kA = kSA * (xs[i] - Xv);
        const float kB = kSB * (Xv - xs[i] - xs[c]);
        const float vA = fmaxf(-kA, 0.0f), vB = fmaxf(-kSB - kB, 0.0f);
        v[kV2] += vA * vA + vB * vB;
        cb += vb;
      }
      const float rA = warp_sum(va);
      const float rB = warp_sum(vb);
      if (lane == 0) {
        sm[L.rowA + P * R * kWarpsPerRow + il * kWarpsPerRow + wr] = rA;
        sm[L.rowB + P * R * kWarpsPerRow + il * kWarpsPerRow + wr] = rB;
      }
    }
    if (c < n) {
      const int oc = c / R;
      cluster.map_shared_rank(sm + L.colP + P * C * kGroups * R, oc)[
          (rank * kGroups + grp) * R + (c - oc * R)] = cb;
    }
  }
  dense_residuals<2>(cluster, a.G, a.g, n, m, r0, rows, rank, C, mc, sm + L.Xb, RN,
                     sm + L.xs + r0, kCols, sm + L.kDp);
  cluster.sync();

  // ---- 2: gx and the dual bound's terms; the owned rows' residuals; this
  //      CTA's sums to every CTA ------------------------------------------
#pragma unroll
  for (int P = 0; P < 2; ++P) {
    const float* xs = sm + L.xs + P * kCols;
    const float* yd = sm + L.yd + P * m;
    float* v = part + P * kNV;
    if (t < rows) {
      const int i = r0 + t;
      const float* rA = sm + L.rowA + P * R * kWarpsPerRow;
      const float* rB = sm + L.rowB + P * R * kWarpsPerRow;
      const float* cP = sm + L.colP + P * C * kGroups * R;
      float sa = 0.0f, sb = 0.0f, sc = 0.0f;
#pragma unroll
      for (int q = 0; q < kWarpsPerRow; ++q) {
        sa += rA[t * kWarpsPerRow + q];
        sb += rB[t * kWarpsPerRow + q];
      }
      for (int q = 0; q < C * kGroups; ++q) sc += cP[q * R + t];
      const float gx = (kSA * sa - kSB * (sb + sc)) + sm[L.gD + P * R + t];
      v[kRxm] += fminf(a.cx[i] - gx, 0.0f);
      v[kPx] += a.cx[i] * xs[i];
    }
    if (c < n) {
      for (int il = grp; il < rows; il += kGroups) {
        const int e = il * n + c;
        v[kSm] += fminf(sm[L.Mt + P * RN + e] + sm[L.MT + P * RN + e], 0.0f);
      }
    }
    for (int j = t; j < qn; j += kThreads) {
      float kD = 0.0f;
      for (int r = 0; r < a.nr; ++r) kD += sm[L.kDp + (P * C + r) * mc + j];
      const int q = q0 + j;
      const float vD = fmaxf(a.h[q] - kD, 0.0f);
      v[kVD2] += vD * vD;
      v[kHyD] += a.h[q] * yd[q];
    }
  }
  block_sums(part, sm + L.scratch, sm + L.tot);
  for (int j = t; j < C * 2 * kNV; j += kThreads) {
    const int r = j / (2 * kNV), q = j % (2 * kNV);
    cluster.map_shared_rank(sm + L.red, r)[rank * 2 * kNV + q] = sm[L.tot + q];
  }
  cluster.sync();

  // ---- 3: every CTA sums the ranks' partials in rank order and decides ---
  float* const dec = sm + L.tot + 2 * kNV + kND;   // err, p, d of both points; use_avg
  if (t == 0) {
    for (int P = 0; P < 2; ++P) {
      float s[kNV];
      for (int j = 0; j < kNV; ++j) {
        s[j] = 0.0f;
        for (int r = 0; r < C; ++r) s[j] += sm[L.red + r * 2 * kNV + P * kNV + j];
      }
      const float p = s[kPx] + s[kPX];
      const float hy = -kSB * s[kHyB] + s[kHyD];
      const float d = (hy + s[kRxm]) + 0.5f * s[kSm];
      const float infeas = sqrtf(s[kV2] + s[kVD2]);
      dec[3 * P] = infeas + fmaxf(p - d, 0.0f);
      dec[3 * P + 1] = p;
      dec[3 * P + 2] = d;
    }
    dec[6] = dec[3] < dec[0] ? 1.0f : 0.0f;
  }
  __syncthreads();
  const bool use_avg = dec[6] != 0.0f;
  const bool restart = use_avg || wlen >= a.restart_period;
  const Point cand = use_avg ? acc : st;
  const float csc = use_avg ? inv : 1.0f;

  // ---- restart: distances of the candidate from the anchor; the candidate
  //      into the state and the anchor, the sums zeroed --------------------
  if (restart) {
    float dv[kND];
#pragma unroll
    for (int j = 0; j < kND; ++j) dv[j] = 0.0f;
    if (c < n) {
      for (int il = grp; il < rows; il += kGroups) {
        const size_t ge = static_cast<size_t>(r0 + il) * n + c;
        const float X = cand.X[ge] * csc, A = cand.yA[ge] * csc, B = cand.yB[ge] * csc;
        const float eX = X - anc.X[ge], eA = A - anc.yA[ge], eB = B - anc.yB[ge];
        dv[kDX] += eX * eX;
        dv[kDA] += eA * eA;
        dv[kDB] += eB * eB;
        st.X[ge] = X;
        st.yA[ge] = A;
        st.yB[ge] = B;
        anc.X[ge] = X;
        anc.yA[ge] = A;
        anc.yB[ge] = B;
        acc.X[ge] = 0.0f;
        acc.yA[ge] = 0.0f;
        acc.yB[ge] = 0.0f;
      }
    }
    if (t < rows) {
      const int i = r0 + t;
      const float x = cand.x[i] * csc, e = x - anc.x[i];
      dv[kDx] += e * e;
      st.x[i] = x;
      anc.x[i] = x;
      acc.x[i] = 0.0f;
    }
    for (int j = t; j < qn; j += kThreads) {
      const int q = q0 + j;
      const float y = cand.yD[q] * csc, e = y - anc.yD[q];
      dv[kDD] += e * e;
      st.yD[q] = y;
      anc.yD[q] = y;
      acc.yD[q] = 0.0f;
    }
    block_sums(dv, sm + L.scratch, sm + L.tot + 2 * kNV);
    if (t < kND) cluster.map_shared_rank(sm + L.dist, 0)[rank * kND + t] = sm[L.tot + 2 * kNV + t];
  }
  cluster.sync();

  // ---- the record, by rank 0 ----------------------------------------------
  if (rank == 0 && t == 0)
    write_record(rec, dec, use_avg, restart, wlen, sm + L.dist, C, a.check_every,
                 a.max_iters, a.tol);
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

}  // namespace

// `iters` iterations of the dense-row block for one instance, with the steps
// and stop flag of its control record rec (kRecWords int32 in device memory):
// state x, X, yA, yB, yD and sums ax, aX, aA, aB, ayD in, the same out (the
// outputs may be the inputs).  G (m, n, n), g (m, n), h (m,) are the dense
// rows, read in place.  smem comes from the caller's plan
// (lp/pdhg_dense.py::smem_bytes) and must equal this file's layout.  Returns
// 0, a CUDA error, kErrLayout or kErrNoCluster.
extern "C" int pdhg_dense_block_launch(
    int n, int m, int iters, int cluster, int smem, const int* rec,
    const float* cx, const float* cX, const float* G, const float* g, const float* h,
    const float* x, const float* X, const float* yA, const float* yB, const float* yD,
    const float* ax, const float* aX, const float* aA, const float* aB, const float* ayD,
    float* xo, float* Xo, float* yAo, float* yBo, float* yDo,
    float* axo, float* aXo, float* aAo, float* aBo, float* ayDo, void* stream) {
  static int checked[2] = {0, -1};
  const int err = check_shape(n, m, cluster, smem, block_layout(n, m, cluster).words);
  if (err != 0) return err;
  if (iters < 0) return kErrLayout;
  const BlockArgs a{n, m, iters, (n + cluster - 1) / cluster, (m + cluster - 1) / cluster,
                    ranks_with_rows(n, cluster), rec, cx, cX, G, g, h,
                    x, X, yA, yB, yD, ax, aX, aA, aB, ayD,
                    xo, Xo, yAo, yBo, yDo, axo, aXo, aAo, aBo, ayDo};
  return launch_one(pdhg_dense_block_kernel, checked, cluster, smem, a, stream);
}

// The check after a dense-row block, in place on the state, sums, anchor and
// control record; a stopped record is left as it is.  Returns 0, a CUDA
// error, kErrLayout or kErrNoCluster.
extern "C" int pdhg_dense_check_launch(
    int n, int m, int cluster, int smem, int check_every, int restart_period, int max_iters,
    float tol, const float* cx, const float* cX, const float* G, const float* g, const float* h,
    float* x, float* X, float* yA, float* yB, float* yD,
    float* ax, float* aX, float* aA, float* aB, float* ayD,
    float* zx, float* zX, float* zA, float* zB, float* zD, int* rec, void* stream) {
  static int checked[2] = {0, -1};
  const int err = check_shape(n, m, cluster, smem, check_layout(n, m, cluster).words);
  if (err != 0) return err;
  if (check_every < 1) return kErrLayout;
  const CheckArgs a{n, m, (n + cluster - 1) / cluster, (m + cluster - 1) / cluster,
                    ranks_with_rows(n, cluster), check_every, restart_period, max_iters, tol,
                    cx, cX, G, g, h, Point{x, X, yA, yB, yD}, Point{ax, aX, aA, aB, ayD},
                    Point{zx, zX, zA, zB, zD}, rec};
  return launch_one(pdhg_dense_check_kernel, checked, cluster, smem, a, stream);
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
