// The checked block's control, K5, as the epilogue of K2's launch
// (pdhg_block.cu, its "checked" form): what the reference's while_loop body
// does after each block of PDHG iterations (sdpcutsel_tpu/lp/pdhg.py
// checked_block), float32, on the card, so that a solve needs no host read
// between blocks.  After K2's last iteration, in the same cluster, for an
// instance whose control record has not stopped:
//
//   wlen += check_every; avg = acc / wlen
//   (err, p, d) of the current iterate and of the average (_kkt_error: the
//       primal objective, the Lagrangian dual bound through K^T y, the
//       infeasibility through K z)
//   use_avg = err_avg < err_cur; the candidate's err, p, d
//   restart = use_avg or wlen >= restart_period: then the candidate's
//       distances dp, dd from the anchor, omega = clip(exp(log(dd / dp) / 2
//       + log(omega) / 2), 1e-4, 1e4), the candidate written into the state
//       and the anchor, the sums zeroed, wlen = 0
//   it += check_every; stop = it >= max_iters or err / (1 + |p| + |d|) <= tol
//   tau = eta / omega, sigma = eta omega for the next block
//
// into the state, sums, anchor and the control record (pdhg_common.cuh);
// K2 then stores the state and sums once.  lp/pdhg.py pdhg_check_plain is
// its plain twin.  The reference computes this in XLA inside its
// while_loop; no Pallas kernel.
//
// Layout: K2's bands, still in shared memory.  CTA r owns the rows
// [r R, (r + 1) R) and the pool slots [r Mc, (r + 1) Mc); each CTA keeps
// replicas of the cut weights w = yC act (M) and of x (n) at the point being
// evaluated: the current iterate's w is K2's own replica, then the
// average's overwrites it, x comes from its owners' shared memory; yD is
// K2's replica (the average's, ayD / wlen, taken entry by entry).  The two
// points run in turn on K2's dead buffers (S, ST, the partials), so the
// check adds only its sums to K2's shared memory.  Cross-band data moves
// through distributed shared memory, pushed by its producer before a
// cluster barrier; for each point:
//   1  each band entry's M = cX - K^T y (X part) goes to the owner of its
//      column as a transposed tile (for S = M + M^T), the column partials
//      of yB to the owners of the columns, each rank's partial <G_i, X> +
//      g_i . x of the dense rows to every CTA;                 cluster barrier
//   2  the gx terms and the dense rows' sums (every CTA alike); cluster
//      barrier after the iterate;
// then each CTA's partial sums (objective, dual bound terms, infeasibility)
// to every CTA;                                                cluster barrier
//   3  every CTA sums them in rank order, so all decide alike; on a restart
//      each CTA writes its band of the candidate and pushes its partial
//      distances;                                              cluster barrier
//   then rank 0 computes omega and writes the record.
// Every sum runs in the order the standalone K5 kernel of earlier versions
// ran it, on the same values (read from shared memory instead of from the
// stores of K2's exit), so the state, sums, anchor and record keep its bits.
// No atomics; the twin sums in torch's order and agrees to rounding
// (chip_smoke.py holds them at rtol 1e-5).

#pragma once

#include "pdhg_common.cuh"

namespace pdhg {

constexpr int kNV = 8;     // partial sums per evaluation point
enum { kPX, kPx, kHyB, kHyC, kRxm, kSm, kV2, kVC2 };

// x, X, yA, yB, yC, yD of one instance in global memory (the anchor)
struct Point {
  float *x, *X, *yA, *yB, *yC, *yD;
};

// The check's own shared memory, in 4-byte words after K2's layout: the
// sums and the decision.  The two evaluation points run one after the
// other on buffers of K2's that its loop no longer needs.
struct CheckLayout {
  int red;                 // (C, 2 kNV) partial sums of every rank
  int dist;                // (C, kND) partial distances of every rank
  int scratch;             // (kThreads / 32, 2 kNV) block sums
  int tot;                 // (2 kNV + kND + 8) this CTA's sums, then the decision
  int words;
};

__host__ __device__ inline CheckLayout check_layout(int C) {
  CheckLayout L;
  int o = 0;
#define TAKE(field, words) L.field = o; o += (words)
  TAKE(red, C * 2 * kNV);
  TAKE(dist, C * kND);
  TAKE(scratch, (kThreads / 32) * 2 * kNV);
  TAKE(tot, 2 * kNV + kND + 8);
#undef TAKE
  L.words = o;
  return L;
}

// What the epilogue reads and writes: K2's shared arrays (bands of R rows,
// owned slots, replicas), its cut-index segments, the check's region and
// the instance's anchor and record.
struct CheckView {
  int n, M, k, m, C, R, Mc, rank, r0, rows, p0, slots;
  int check_every, restart_period, max_iters;
  float tol;
  // bands: the state, the sums, cX; x, ax, cx of the band's rows
  float *X, *yA, *yB, *aX, *aA, *aB;
  const float* cX;
  float *x, *ax;
  const float* cx;
  // owned slots
  float *yC, *ayC;
  const float *rhs, *act, *lin, *quad;
  const int* idx;
  const float* actg;                   // act of every slot (global memory)
  // replicas: w = yC act (M), yD and its sum (m), h (m); the dense rows' bands
  float* w;
  float *yD, *ayD;
  const float *h, *G, *g;
  // the cut index's segments of the band (offsets relative to their starts)
  const int *Xoff, *xoff, *Xcut, *xcut;
  const float *Xcoef, *xcoef;
  // K2's buffers that its loop no longer needs: the x replica, M and the
  // transposed tiles, the row and column partials, the dense partials
  float *xs, *Mt, *MT, *rowA, *rowB, *colP, *kDp;
  float* ck;                           // the check's region (CheckLayout)
  Point anc;
  int* rec;
};

// The check after K2's last iteration, at K2's column width W.  Every
// thread of every CTA of the cluster calls it, after K2's dense fold and a
// __syncthreads; the record's stop flag was clear at entry.  The current
// iterate (P = 0) and the average (P = 1) are evaluated in turn, each with
// the same arithmetic as when both shared one pass.
template <int W>
__device__ __forceinline__ void check_epilogue(cg::cluster_group& cluster, const CheckView& v) {
  constexpr int kCols = Width<W>::kCols, kGroups = Width<W>::kGroups;
  constexpr int kWarpsPerRow = Width<W>::kWarpsPerRow;
  const int n = v.n, k = v.k, m = v.m, C = v.C, R = v.R;
  const int rank = v.rank, r0 = v.r0, rows = v.rows, p0 = v.p0, slots = v.slots;
  int* const rec = v.rec;
  const int wlen = rec[kRecWlen] + v.check_every;
  const float inv = 1.0f / static_cast<float>(wlen);
  const CheckLayout L = check_layout(C);
  float* const ck = v.ck;

  const int t = threadIdx.x;
  const int c = t % kCols;
  const int grp = t / kCols;
  const int lane = t % 32;
  const int wr = c / 32;

  float part[2 * kNV];
#pragma unroll
  for (int j = 0; j < 2 * kNV; ++j) part[j] = 0.0f;

#pragma unroll 1
  for (int P = 0; P < 2; ++P) {
    const float sc = P == 0 ? 1.0f : inv;
    const float* const bX = P == 0 ? v.X : v.aX;
    const float* const bA = P == 0 ? v.yA : v.aA;
    const float* const bB = P == 0 ? v.yB : v.aB;
    const float* const byC = P == 0 ? v.yC : v.ayC;
    const float* const byD = P == 0 ? v.yD : v.ayD;   // yD of the point: byD[q] * sc
    float* pv = part + P * kNV;

    // ---- the replicas of w (the average's; K2's own are the iterate's) and
    //      of x at this point ------------------------------------------------
    if (P == 1) {
      for (int q = t; q < v.M; q += kThreads) {
        const int o = q / v.Mc;
        v.w[q] = (cluster.map_shared_rank(v.ayC, o)[q - o * v.Mc] * inv) * v.actg[q];
      }
    }
    for (int j = t; j < n; j += kThreads) {
      const int o = j / R;
      v.xs[j] = P == 0 ? cluster.map_shared_rank(v.x, o)[j - o * R]
                       : cluster.map_shared_rank(v.ax, o)[j - o * R] * inv;
    }
    if (P == 0) {
      cluster.sync();   // K2's fold has read its dense partials before any remote store
    } else {
      __syncthreads();
    }
    const float* const w = v.w;
    const float* const xs = v.xs;

    // ---- 1: M = cX - gX and its transpose, row and column sums, infeasibility
    float cb = 0.0f;
    for (int il = grp; il < rows; il += kGroups) {   // uniform across each warp
      float va = 0.0f, vb = 0.0f;
      if (c < n) {
        const int i = r0 + il;
        const int e = il * n + c;
        const float Xv = bX[e] * sc;
        va = bA[e] * sc;
        vb = bB[e] * sc;
        const float cut = segment_sum(v.Xcut, v.Xcoef, v.Xoff[e], v.Xoff[e + 1], w);
        float gX = (-kSA * va + kSB * vb) + cut;
        if (m > 0) {
          float dn = 0.0f;
          for (int q = 0; q < m; ++q) dn += (byD[q] * sc) * v.G[q * R * n + e];
          gX += dn;
        }
        const float cXv = v.cX[e];
        const float Mv = cXv - gX;
        v.Mt[e] = Mv;
        const int oc = c / R;
        cluster.map_shared_rank(v.MT, oc)[(c - oc * R) * n + i] = Mv;
        pv[kPX] += cXv * Xv;
        pv[kHyB] += vb;
        const float kA = kSA * (xs[i] - Xv);
        const float kB = kSB * (Xv - xs[i] - xs[c]);
        const float vA = fmaxf(-kA, 0.0f), vB = fmaxf(-kSB - kB, 0.0f);
        pv[kV2] += vA * vA + vB * vB;
        cb += vb;
      }
      const float rA = warp_sum(va);
      const float rB = warp_sum(vb);
      if (lane == 0) {
        v.rowA[il * kWarpsPerRow + wr] = rA;
        v.rowB[il * kWarpsPerRow + wr] = rB;
      }
    }
    if (c < n) {
      const int oc = c / R;
      cluster.map_shared_rank(v.colP, oc)[(rank * kGroups + grp) * R + (c - oc * R)] = cb;
    }
    // the owned slots: rhs . yC, and the cut rows' infeasibility
    for (int s = t; s < slots; s += kThreads) {
      const float am = v.act[s];
      pv[kHyC] += v.rhs[s] * am * (byC[s] * sc);
      if (am != 0.0f) {
        const float res = cut_residual_k(
            k, v.idx + s * k, v.lin + s * k, v.quad + s * k * k,
            [&](int iu) { return xs[iu]; },
            [&](int iu, int iv) {
              const int ou = iu / R;
              return cluster.map_shared_rank(bX, ou)[(iu - ou * R) * n + iv] * sc;
            });
        const float kC = res * am;
        const float vC = fmaxf(v.rhs[s] * am - kC, 0.0f) * am;
        pv[kVC2] += vC * vC;
      }
    }
    // each dense row's partial <G_i, X> + g_i . x over the band, one warp a row
    for (int q = t / 32; q < m; q += kThreads / 32) {
      float r2 = 0.0f, r1 = 0.0f;
      for (int e = lane; e < rows * n; e += 32) r2 += v.G[q * R * n + e] * (bX[e] * sc);
      for (int j = lane; j < rows; j += 32) r1 += v.g[q * R + j] * xs[r0 + j];
      const float sum = warp_sum(r2) + warp_sum(r1);
      if (lane < C) cluster.map_shared_rank(v.kDp, lane)[rank * m + q] = sum;
    }
    cluster.sync();

    // ---- 2: gx, the dual bound's terms --------------------------------------
    if (t < rows) {
      const int i = r0 + t;
      float sa = 0.0f, sb = 0.0f, scs = 0.0f;
#pragma unroll
      for (int q = 0; q < kWarpsPerRow; ++q) {
        sa += v.rowA[t * kWarpsPerRow + q];
        sb += v.rowB[t * kWarpsPerRow + q];
      }
      for (int q = 0; q < C * kGroups; ++q) scs += v.colP[q * R + t];
      const float cut = segment_sum(v.xcut, v.xcoef, v.xoff[t], v.xoff[t + 1], w);
      float gx = (kSA * sa - kSB * (sb + scs)) + cut;
      if (m > 0) {
        float dn = 0.0f;
        for (int q = 0; q < m; ++q) dn += (byD[q] * sc) * v.g[q * R + t];
        gx += dn;
      }
      pv[kRxm] += fminf(v.cx[t] - gx, 0.0f);
      pv[kPx] += v.cx[t] * xs[i];
    }
    if (c < n) {
      for (int il = grp; il < rows; il += kGroups) {
        const int e = il * n + c;
        pv[kSm] += fminf(v.Mt[e] + v.MT[e], 0.0f);
      }
    }
    // the dense rows' infeasibility and dual terms, every CTA alike: each
    // row's partials in rank order (into rank 0's slot), then thread 0
    // over the rows in order
    for (int q = t; q < m; q += kThreads) {
      float kD = 0.0f;
      for (int r = 0; r < C; ++r) kD += v.kDp[r * m + q];
      v.kDp[q] = kD;
    }
    __syncthreads();
    if (t == 0) {
      float hyD = 0.0f, vD2 = 0.0f;
      for (int q = 0; q < m; ++q) {
        const float kD = v.kDp[q];
        const float vD = fmaxf(v.h[q] - kD, 0.0f);
        vD2 += vD * vD;
        hyD += v.h[q] * (byD[q] * sc);
      }
      ck[L.tot + 2 * kNV + kND + 6 + P] = hyD;     // dec[6 + P], read before dec is written
      ck[L.tot + 2 * kNV + kND + 2 * P] = vD2;     // dec[2 P], likewise
    }
    if (P == 0) cluster.sync();   // the iterate's buffers are read before the average's stores
  }

  // ---- this CTA's sums to every CTA -----------------------------------------
  block_sums(part, ck + L.scratch, ck + L.tot);
  for (int j = t; j < C * 2 * kNV; j += kThreads) {
    const int r = j / (2 * kNV), q = j % (2 * kNV);
    cluster.map_shared_rank(ck + L.red, r)[rank * 2 * kNV + q] = ck[L.tot + q];
  }
  cluster.sync();

  // ---- every CTA sums the ranks' partials in rank order and decides -------
  float* const dec = ck + L.tot + 2 * kNV + kND;   // err, p, d of both points; use_avg
  if (t == 0) {
    float hyDs[2], vD2s[2];
    for (int P = 0; P < 2; ++P) {
      hyDs[P] = dec[6 + P];
      vD2s[P] = dec[2 * P];
    }
    for (int P = 0; P < 2; ++P) {
      float s[kNV];
      for (int j = 0; j < kNV; ++j) {
        s[j] = 0.0f;
        for (int r = 0; r < C; ++r) s[j] += ck[L.red + r * 2 * kNV + P * kNV + j];
      }
      const float p = s[kPx] + s[kPX];
      const float hy = (-kSB * s[kHyB] + s[kHyC]) + hyDs[P];
      const float d = (hy + s[kRxm]) + 0.5f * s[kSm];
      const float infeas = sqrtf((s[kV2] + s[kVC2]) + vD2s[P]);
      dec[3 * P] = infeas + fmaxf(p - d, 0.0f);
      dec[3 * P + 1] = p;
      dec[3 * P + 2] = d;
    }
    dec[6] = dec[3] < dec[0] ? 1.0f : 0.0f;
  }
  __syncthreads();
  const bool use_avg = dec[6] != 0.0f;
  const bool restart = use_avg || wlen >= v.restart_period;
  const float csc = use_avg ? inv : 1.0f;

  // ---- restart: distances of the candidate from the anchor; the candidate
  //      into the state and the anchor, the sums zeroed --------------------
  if (restart) {
    const Point anc = v.anc;
    float dv[kND];
#pragma unroll
    for (int j = 0; j < kND; ++j) dv[j] = 0.0f;
    if (c < n) {
      for (int il = grp; il < rows; il += kGroups) {
        const int e = il * n + c;
        const size_t ge = static_cast<size_t>(r0 + il) * n + c;
        const float X = (use_avg ? v.aX[e] : v.X[e]) * csc;
        const float A = (use_avg ? v.aA[e] : v.yA[e]) * csc;
        const float B = (use_avg ? v.aB[e] : v.yB[e]) * csc;
        const float eX = X - anc.X[ge], eA = A - anc.yA[ge], eB = B - anc.yB[ge];
        dv[kDX] += eX * eX;
        dv[kDA] += eA * eA;
        dv[kDB] += eB * eB;
        v.X[e] = X;
        v.yA[e] = A;
        v.yB[e] = B;
        anc.X[ge] = X;
        anc.yA[ge] = A;
        anc.yB[ge] = B;
        v.aX[e] = 0.0f;
        v.aA[e] = 0.0f;
        v.aB[e] = 0.0f;
      }
    }
    if (t < rows) {
      const int i = r0 + t;
      const float x = (use_avg ? v.ax[t] : v.x[t]) * csc, e = x - anc.x[i];
      dv[kDx] += e * e;
      v.x[t] = x;
      anc.x[i] = x;
      v.ax[t] = 0.0f;
    }
    for (int s = t; s < slots; s += kThreads) {
      const int q = p0 + s;
      const float y = (use_avg ? v.ayC[s] : v.yC[s]) * csc, e = y - anc.yC[q];
      dv[kDC] += e * e;
      v.yC[s] = y;
      anc.yC[q] = y;
      v.ayC[s] = 0.0f;
    }
    if (rank == 0) {            // rank 0 stores yD and its sum at K2's exit
      for (int q = t; q < m; q += kThreads) {
        const float y = (use_avg ? v.ayD[q] : v.yD[q]) * csc, e = y - anc.yD[q];
        dv[kDD] += e * e;
        v.yD[q] = y;
        anc.yD[q] = y;
        v.ayD[q] = 0.0f;
      }
    }
    block_sums(dv, ck + L.scratch, ck + L.tot + 2 * kNV);
    for (int j = t; j < C * kND; j += kThreads) {
      const int r = j / kND, q = j % kND;
      cluster.map_shared_rank(ck + L.dist, r)[rank * kND + q] = ck[L.tot + 2 * kNV + q];
    }
  }
  cluster.sync();

  // ---- the record, by rank 0 ----------------------------------------------
  if (rank == 0 && t == 0)
    write_record(rec, dec, use_avg, restart, wlen, ck + L.dist, C, v.check_every,
                 v.max_iters, v.tol);
}

}  // namespace pdhg
