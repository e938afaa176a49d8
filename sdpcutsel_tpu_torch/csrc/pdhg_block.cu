// PDHG iteration block for the McCormick + cuts (+ dense QCQP rows) LP,
// float32, as one thread-block cluster whose state stays in shared memory.
//
// Replaces the Pallas TPU kernel sdpcutsel_tpu/lp/pdhg_kernel.py::_kernel
// (launched from pdhg_block).  Runs `iters` iterations of the exact
// lp/pdhg.py::_one_iter update and adds every iterate to the ergodic sums
// (ax, aX, aA, aB, ayC, ayD).  Restart, KKT and omega logic stay in torch,
// once per block.  The TPU kernel kept its whole working set in VMEM for the
// block and took no dense rows; this one also takes the m dense rows
// Gd (m, n, n), gd (m, n), hd (m,) of relax/denserows.py (m = 0: BoxQP).
// It reads its inputs and writes its outputs; no input is changed.
//
// What bounds it on the H100 (chip_smoke.py pdhg_ops, bound): a launch of 100
// iterations at n = 125, M = 1024 (400 active k = 3 cuts), m = 0 reads and
// writes ~1 MB once (0.3 us at 3.35 TB/s) and does ~51 MFLOP (0.76 us at
// 67 TFLOP/s fp32); at n = 100 with 25 dense rows and 400 active k = 5 cuts,
// ~2 MB (0.6 us) and ~137 MFLOP (2.0 us).  FLOPs set both bounds, at well
// under 0.1 us an iteration.  The real limit is latency: every iteration is
// a serial chain of three all-to-all dependences (the row and column sums of
// yB, the X^T read of the symmetrization, the cut and dense residuals at the
// extrapolated point), so an iteration costs a few barrier round trips plus
// the longest thread's serial work.  A single CTA of 1024 threads with its
// state in L2 took 35 us an iteration (72 us with the dense rows, which it
// streamed from L2 twice an iteration); this design takes 6.4 and 12.0 us
// on the H100 (PERF.md).
//
// Design: one cluster of C CTAs (C = 16 by default, non-portable; 8 is the
// portable size) on C SMs, 512 threads each.  CTA r owns rows
// [r R, min(n, (r + 1) R)) of every (n, n) array, R = ceil(n / C), and keeps
// its band of X, yA, yB, cX, aX, aA, aB, S, Xb, of the dense rows' G_i and
// g_i, and of the cut index in shared memory for the whole launch: loaded
// once at entry, stored once at exit.  It owns pool slots
// [r Mc, (r + 1) Mc), Mc = ceil(M / C), with their cut data, yC and ayC.
// Every CTA keeps a replica of the weights w = yC * active (M,), of xb (n,)
// and of yD (m,).  Thread (g, c) = (t / 128, t % 128) owns column c of the
// band rows g, g + 4, ...
//
// Cross-band data moves through distributed shared memory, pushed by its
// producer before a cluster barrier (remote stores, no remote waits):
//   A   gX, S = X - tau (cX - gX); S[i, c] is stored into the owner of row
//       c as its transposed tile ST; the band's row sums of yA, yB stay
//       local; each (CTA, row group)'s column partials of yB go to the
//       owner of the column.                                  cluster barrier 1
//   B1  gx from the row sums, the column partials (summed by rank, then
//       group), the x cut terms and g' yD; x step; xb pushed to every CTA.
//       X = clip((S + ST) / 2), Xb = 2 X - X_old.             cluster barrier 2
//   B2  dual ascent on yA, yB at (xb, Xb); each CTA's active pool slots read
//       Xb at their supports from the owning CTAs and push the new w to
//       every CTA (inactive slots do no math: yC = 0); per dense row, each
//       CTA pushes its partial <G_i, Xb> + g_i . xb of the band to every
//       CTA.                                                  cluster barrier 3
//   next A: every CTA sums the dense partials in rank order and updates its
//       yD replica identically (one __syncthreads).
// Three cluster barriers an iteration (the single-CTA kernel had four
// __syncthreads), and one more at entry and at exit, so that no CTA reads or
// writes the shared memory of one that has not started or has left.
//
// Deterministic: no atomics, and every sum runs in a fixed order (cut-index
// terms in their stored order, partials by rank and then lane or group), so
// two runs give identical bits.  The band's cut-index segment is copied to
// shared memory when it fits the plan's term capacity; otherwise the CTA
// reads the same terms in the same order from global memory.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kCols = 128;                   // n <= 128
constexpr int kGroups = kThreads / kCols;    // row groups of a band
constexpr int kWarpsPerRow = kCols / 32;
constexpr int kMaxCluster = 16;
constexpr float kSA = 0.70710678118654752440f;   // 1 / sqrt(2)
constexpr float kSB = 0.57735026918962576451f;   // 1 / sqrt(3)
constexpr int kErrLayout = -2;      // the caller's plan disagrees with this layout
constexpr int kErrNoCluster = -3;   // no cluster of this shape fits on the card

struct Args {
  int n, M, k, m, iters, R, Mc, term_cap;
  float tau, sigma;
  const float *cx, *cX;
  const int* idx;
  const float *lin, *quad, *rhs, *act;
  const int* xoff;
  const int* xcut;
  const float* xcoef;
  const int* Xoff;
  const int* Xcut;
  const float* Xcoef;
  const float *G, *g, *h;
  // inputs: x, X, yA, yB, yC, yD, then the sums ax, aX, aA, aB, ayC, ayD
  const float *x, *X, *yA, *yB, *yC, *yD, *ax, *aX, *aA, *aB, *ayC, *ayD;
  // outputs, in the same order
  float *xo, *Xo, *yAo, *yBo, *yCo, *yDo, *axo, *aXo, *aAo, *aBo, *ayCo, *ayDo;
};

// Offsets, in 4-byte words, of one CTA's dynamic shared memory.  The same
// sum is lp/pdhg_kernel.py::_smem_words; the launch checks that they agree.
struct Layout {
  int X, yA, yB, cX, aX, aA, aB, S, Xb, ST;     // (R, n) bands
  int rowA, rowB;                               // (R, kWarpsPerRow) row partials
  int colP;                                     // (C * kGroups, R) column partials
  int xs, axs, cxs;                             // (R,) band of x, ax, cx
  int xb;                                       // (kCols,) replica of xb
  int w;                                        // (M,) replica of yC * active
  int yC, ayC, rhs, act, lin, quad, idx;        // owned slots: (Mc,), (Mc, k), (Mc, k, k)
  int G, g, h, yD, ayD, dpart;                  // (m, R, n), (m, R), (m,) x 3, (C, m)
  int Xoff, xoff;                               // (R n + 1,), (R + 1,) segment offsets
  int tcut, tcoef;                              // (term_cap,) cut-index terms
  int words;
};

__host__ __device__ inline Layout make_layout(int n, int M, int k, int m, int C, int R,
                                              int Mc, int term_cap) {
  Layout L;
  int o = 0;
  const int RN = R * n;
#define TAKE(field, words) L.field = o; o += (words)
  TAKE(X, RN); TAKE(yA, RN); TAKE(yB, RN); TAKE(cX, RN); TAKE(aX, RN);
  TAKE(aA, RN); TAKE(aB, RN); TAKE(S, RN); TAKE(Xb, RN); TAKE(ST, RN);
  TAKE(rowA, R * kWarpsPerRow); TAKE(rowB, R * kWarpsPerRow);
  TAKE(colP, C * kGroups * R);
  TAKE(xs, R); TAKE(axs, R); TAKE(cxs, R);
  TAKE(xb, kCols);
  TAKE(w, M);
  TAKE(yC, Mc); TAKE(ayC, Mc); TAKE(rhs, Mc); TAKE(act, Mc);
  TAKE(lin, Mc * k); TAKE(quad, Mc * k * k); TAKE(idx, Mc * k);
  TAKE(G, m * RN); TAKE(g, m * R); TAKE(h, m); TAKE(yD, m); TAKE(ayD, m);
  TAKE(dpart, C * m);
  TAKE(Xoff, RN + 1); TAKE(xoff, R + 1);
  TAKE(tcut, term_cap); TAKE(tcoef, term_cap);
#undef TAKE
  L.words = o;
  return L;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// yD <- max(yD + sigma (h - kD), 0) with kD the ranks' partials in rank
// order; every CTA runs it on the same data, so the replicas stay equal.
__device__ __forceinline__ void fold_dense(int m, int C, float sigma, const float* sh,
                                           const float* sdpart, float* syD, float* sayD) {
  for (int q = threadIdx.x; q < m; q += kThreads) {
    float kD = 0.0f;
    for (int r = 0; r < C; ++r) kD += sdpart[r * m + q];
    const float yd = fmaxf(syD[q] + sigma * (sh[q] - kD), 0.0f);
    syD[q] = yd;
    sayD[q] += yd;
  }
}

// lin . xb[id] + <quad, Xb[id, id]> of one cut of width K: the K^2 reads of
// Xb go to the CTAs that own the rows and are all issued before the sums
// (unrolled), so an iteration pays about one remote latency, not K^2
template <int K>
__device__ __forceinline__ float cut_residual(const cg::cluster_group& cluster,
                                              const int* id, const float* l,
                                              const float* qd, const float* sxb,
                                              float* sXb, int R, int n) {
  float xs[K], xv[K * K];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int iu = id[u];
    xs[u] = sxb[iu];
    const int ou = iu / R;
    const float* Xr = cluster.map_shared_rank(sXb, ou) + (iu - ou * R) * n;
#pragma unroll
    for (int v = 0; v < K; ++v) xv[u * K + v] = Xr[id[v]];
  }
  float r1 = 0.0f, r2 = 0.0f;
#pragma unroll
  for (int u = 0; u < K; ++u) {
    r1 += l[u] * xs[u];
#pragma unroll
    for (int v = 0; v < K; ++v) r2 += qd[u * K + v] * xv[u * K + v];
  }
  return r1 + r2;
}

__global__ void __launch_bounds__(kThreads, 1) pdhg_cluster_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = a.n, M = a.M, k = a.k, m = a.m, R = a.R, RN = R * n, nn = n * n;
  const float tau = a.tau, sigma = a.sigma;
  const Layout L = make_layout(n, M, k, m, C, R, a.Mc, a.term_cap);
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
  float* const srowA = sm + L.rowA;
  float* const srowB = sm + L.rowB;
  float* const scolP = sm + L.colP;
  float* const sx = sm + L.xs;
  float* const sax = sm + L.axs;
  float* const scx = sm + L.cxs;
  float* const sxb = sm + L.xb;
  float* const sw = sm + L.w;
  float* const syC = sm + L.yC;
  float* const sayC = sm + L.ayC;
  float* const srhs = sm + L.rhs;
  float* const sact = sm + L.act;
  float* const slin = sm + L.lin;
  float* const squad = sm + L.quad;
  int* const sidx = reinterpret_cast<int*>(sm + L.idx);
  float* const sG = sm + L.G;
  float* const sg = sm + L.g;
  float* const sh = sm + L.h;
  float* const syD = sm + L.yD;
  float* const sayD = sm + L.ayD;
  float* const sdpart = sm + L.dpart;
  int* const sXoff = reinterpret_cast<int*>(sm + L.Xoff);
  int* const sxoff = reinterpret_cast<int*>(sm + L.xoff);
  int* const tcut = reinterpret_cast<int*>(sm + L.tcut);
  float* const tcoef = sm + L.tcoef;

  const int t = threadIdx.x;
  const int c = t % kCols;
  const int grp = t / kCols;
  const int lane = t % 32;
  const int wr = c / 32;
  const int r0 = rank * R;
  const int rows = max(0, min(R, n - r0));
  const int p0 = rank * a.Mc;
  const int slots = max(0, min(a.Mc, M - p0));

  // ---- entry: the band, the owned slots and the replicas, loaded once ----
  for (int e = t; e < rows * n; e += kThreads) {
    const int ge = r0 * n + e;
    sX[e] = a.X[ge];
    syA[e] = a.yA[ge];
    syB[e] = a.yB[ge];
    scX[e] = a.cX[ge];
    saX[e] = a.aX[ge];
    saA[e] = a.aA[ge];
    saB[e] = a.aB[ge];
    for (int q = 0; q < m; ++q) sG[q * RN + e] = a.G[static_cast<size_t>(q) * nn + ge];
  }
  for (int i = t; i < rows; i += kThreads) {
    sx[i] = a.x[r0 + i];
    sax[i] = a.ax[r0 + i];
    scx[i] = a.cx[r0 + i];
    for (int q = 0; q < m; ++q) sg[q * R + i] = a.g[q * n + r0 + i];
  }
  for (int q = t; q < M; q += kThreads) sw[q] = a.yC[q] * a.act[q];
  for (int s = t; s < slots; s += kThreads) {
    const int p = p0 + s;
    syC[s] = a.yC[p];
    sayC[s] = a.ayC[p];
    srhs[s] = a.rhs[p];
    sact[s] = a.act[p];
    for (int j = 0; j < k; ++j) {
      slin[s * k + j] = a.lin[p * k + j];
      sidx[s * k + j] = a.idx[p * k + j];
    }
    for (int j = 0; j < k * k; ++j) squad[s * k * k + j] = a.quad[p * k * k + j];
  }
  for (int q = t; q < m; q += kThreads) {
    sh[q] = a.h[q];
    syD[q] = a.yD[q];
    sayD[q] = a.ayD[q];
  }
  // the band's segments of the cut index, offsets relative to their starts
  const int ra = min(r0, n), rb = min(r0 + R, n);
  const int X0 = a.Xoff[ra * n], x0 = a.xoff[ra];
  const int LX = a.Xoff[rb * n] - X0, Lx = a.xoff[rb] - x0;
  const bool fits = LX + Lx <= a.term_cap;
  for (int e = t; e <= rows * n; e += kThreads) sXoff[e] = a.Xoff[ra * n + e] - X0;
  for (int i = t; i <= rows; i += kThreads) sxoff[i] = a.xoff[ra + i] - x0;
  if (fits) {
    for (int q = t; q < LX; q += kThreads) {
      tcut[q] = a.Xcut[X0 + q];
      tcoef[q] = a.Xcoef[X0 + q];
    }
    for (int q = t; q < Lx; q += kThreads) {
      tcut[LX + q] = a.xcut[x0 + q];
      tcoef[LX + q] = a.xcoef[x0 + q];
    }
  }
  const int* const Xcut = fits ? tcut : a.Xcut + X0;
  const float* const Xcoef = fits ? tcoef : a.Xcoef + X0;
  const int* const xcut = fits ? tcut + LX : a.xcut + x0;
  const float* const xcoef = fits ? tcoef + LX : a.xcoef + x0;
  cluster.sync();

  for (int it = 0; it < a.iters; ++it) {
    if (m > 0 && it > 0) {
      fold_dense(m, C, sigma, sh, sdpart, syD, sayD);
      __syncthreads();
    }

    // ---- A: adjoint, primal pre-step S, its transpose to the column owners,
    //      row sums (local) and column partials (to the owners) of yB -------
    float cb = 0.0f;
    for (int il = grp; il < rows; il += kGroups) {   // uniform across each warp
      float va = 0.0f, vb = 0.0f;
      if (c < n) {
        const int e = il * n + c;
        va = syA[e];
        vb = syB[e];
        float cut = 0.0f;
        for (int q = sXoff[e]; q < sXoff[e + 1]; ++q) cut += sw[Xcut[q]] * Xcoef[q];
        float gX = (-kSA * va + kSB * vb) + cut;
        if (m > 0) {
          float dn = 0.0f;
          for (int q = 0; q < m; ++q) dn += syD[q] * sG[q * RN + e];
          gX += dn;
        }
        const float s = sX[e] - tau * (scX[e] - gX);
        sS[e] = s;
        const int oc = c / R;
        cluster.map_shared_rank(sST, oc)[(c - oc * R) * n + r0 + il] = s;
        cb += vb;
      }
      const float rA = warp_sum(va);
      const float rB = warp_sum(vb);
      if (lane == 0) {
        srowA[il * kWarpsPerRow + wr] = rA;
        srowB[il * kWarpsPerRow + wr] = rB;
      }
    }
    if (c < n) {
      const int oc = c / R;
      cluster.map_shared_rank(scolP, oc)[(rank * kGroups + grp) * R + (c - oc * R)] = cb;
    }
    cluster.sync();

    // ---- B1: gx, x step, xb to every CTA; X projection and Xb ---------------
    if (t < rows) {
      float sa = 0.0f, sb = 0.0f, sc = 0.0f;
#pragma unroll
      for (int q = 0; q < kWarpsPerRow; ++q) {
        sa += srowA[t * kWarpsPerRow + q];
        sb += srowB[t * kWarpsPerRow + q];
      }
      for (int q = 0; q < C * kGroups; ++q) sc += scolP[q * R + t];
      float cut = 0.0f;
      for (int q = sxoff[t]; q < sxoff[t + 1]; ++q) cut += sw[xcut[q]] * xcoef[q];
      float gx = (kSA * sa - kSB * (sb + sc)) + cut;
      if (m > 0) {
        float dn = 0.0f;
        for (int q = 0; q < m; ++q) dn += syD[q] * sg[q * R + t];
        gx += dn;
      }
      const float xo = sx[t];
      const float xn = fminf(fmaxf(xo - tau * (scx[t] - gx), 0.0f), 1.0f);
      sx[t] = xn;
      sax[t] += xn;
      const float xbv = 2.0f * xn - xo;
      for (int r = 0; r < C; ++r) cluster.map_shared_rank(sxb, r)[r0 + t] = xbv;
    }
    if (c < n) {
      for (int il = grp; il < rows; il += kGroups) {
        const int e = il * n + c;
        const float xn = fminf(fmaxf(0.5f * (sS[e] + sST[e]), 0.0f), 1.0f);
        sXb[e] = 2.0f * xn - sX[e];
        sX[e] = xn;
        saX[e] += xn;
      }
    }
    cluster.sync();

    // ---- B2: dual ascent on yA, yB; cut rows; dense-row partials ------------
    if (c < n) {
      const float xbc = sxb[c];
      for (int il = grp; il < rows; il += kGroups) {
        const int e = il * n + c;
        const float xbv = sXb[e];
        const float xbi = sxb[r0 + il];
        const float kA = kSA * (xbi - xbv);
        const float kB = kSB * (xbv - xbi - xbc);
        const float ya = fmaxf(syA[e] - sigma * kA, 0.0f);
        const float yb = fmaxf(syB[e] + sigma * (-kSB - kB), 0.0f);
        syA[e] = ya;
        syB[e] = yb;
        saA[e] += ya;
        saB[e] += yb;
      }
    }
    for (int s = t; s < slots; s += kThreads) {
      const float am = sact[s];
      float yc = 0.0f;                     // an inactive slot's yC stays 0
      if (am != 0.0f) {
        const int* id = sidx + s * k;
        const float* l = slin + s * k;
        const float* qd = squad + s * k * k;
        float res;
        switch (k) {
          case 2: res = cut_residual<2>(cluster, id, l, qd, sxb, sXb, R, n); break;
          case 3: res = cut_residual<3>(cluster, id, l, qd, sxb, sXb, R, n); break;
          case 4: res = cut_residual<4>(cluster, id, l, qd, sxb, sXb, R, n); break;
          default: res = cut_residual<5>(cluster, id, l, qd, sxb, sXb, R, n); break;
        }
        const float r = res * am;
        yc = fmaxf(syC[s] + sigma * (srhs[s] * am - r), 0.0f) * am;
      }
      syC[s] = yc;
      sayC[s] += yc;
      const float wv = yc * am;
      for (int r = 0; r < C; ++r) cluster.map_shared_rank(sw, r)[p0 + s] = wv;
    }
    for (int q = t / 32; q < m; q += kThreads / 32) {   // one warp per dense row
      float r2 = 0.0f, r1 = 0.0f;
      for (int e = lane; e < rows * n; e += 32) r2 += sG[q * RN + e] * sXb[e];
      for (int j = lane; j < rows; j += 32) r1 += sg[q * R + j] * sxb[r0 + j];
      const float part = warp_sum(r2) + warp_sum(r1);
      if (lane < C) cluster.map_shared_rank(sdpart, lane)[rank * m + q] = part;
    }
    cluster.sync();
  }
  if (m > 0 && a.iters > 0) fold_dense(m, C, sigma, sh, sdpart, syD, sayD);
  __syncthreads();

  // ---- exit: the band, the owned slots and yD, stored once ---------------
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
  for (int s = t; s < slots; s += kThreads) {
    a.yCo[p0 + s] = syC[s];
    a.ayCo[p0 + s] = sayC[s];
  }
  if (rank == 0) {
    for (int q = t; q < m; q += kThreads) {
      a.yDo[q] = syD[q];
      a.ayDo[q] = sayD[q];
    }
  }
  cluster.sync();   // no CTA leaves while another may still address it
}

}  // namespace

// cluster: CTAs in the cluster (<= 16); term_cap and smem come from the
// caller's launch plan (lp/pdhg_kernel.py launch_plan), and smem must equal
// this file's layout.  Returns 0, a CUDA error, kErrLayout or kErrNoCluster.
extern "C" int pdhg_block_launch(
    int n, int M, int k, int m, int iters, float tau, float sigma,
    int cluster, int term_cap, int smem,
    const float* cx, const float* cX,
    const int* idx, const float* lin, const float* quad, const float* rhs,
    const float* act,
    const int* xoff, const int* xcut, const float* xcoef,
    const int* Xoff, const int* Xcut, const float* Xcoef,
    const float* G, const float* g, const float* h,
    const float* x, const float* X, const float* yA, const float* yB,
    const float* yC, const float* yD,
    const float* ax, const float* aX, const float* aA, const float* aB,
    const float* ayC, const float* ayD,
    float* xo, float* Xo, float* yAo, float* yBo, float* yCo, float* yDo,
    float* axo, float* aXo, float* aAo, float* aBo, float* ayCo, float* ayDo,
    void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || n < 1 || n > kCols || k < 2 || k > 5 ||
      term_cap < 0)
    return kErrLayout;
  const int R = (n + cluster - 1) / cluster;
  const int Mc = (M + cluster - 1) / cluster;
  const Layout L = make_layout(n, M, k, m, cluster, R, Mc, term_cap);
  if (4 * static_cast<size_t>(L.words) != static_cast<size_t>(smem)) return kErrLayout;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  // set up and checked once per (cluster, smem): the card must hold one
  // such cluster
  static int checked_cluster = 0, checked_smem = -1;
  cudaError_t err;
  if (cluster != checked_cluster || smem != checked_smem) {
    err = cudaFuncSetAttribute(pdhg_cluster_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (cluster > 8) {
      err = cudaFuncSetAttribute(pdhg_cluster_kernel,
                                 cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, pdhg_cluster_kernel, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return kErrNoCluster;
    checked_cluster = cluster;
    checked_smem = smem;
  }

  const Args a{n, M, k, m, iters, R, Mc, term_cap, tau, sigma,
               cx, cX, idx, lin, quad, rhs, act,
               xoff, xcut, xcoef, Xoff, Xcut, Xcoef, G, g, h,
               x, X, yA, yB, yC, yD, ax, aX, aA, aB, ayC, ayD,
               xo, Xo, yAo, yBo, yCo, yDo, axo, aXo, aAo, aBo, ayCo, ayDo};
  err = cudaLaunchKernelEx(&cfg, pdhg_cluster_kernel, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
