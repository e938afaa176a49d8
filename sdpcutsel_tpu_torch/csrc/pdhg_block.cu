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
//
// Instance axis: one launch runs the block for a batch of B instances of one
// shape, stacked along a leading axis of every input and output.  The grid
// is C x (instances listed in ids): cluster s runs instance ids[s] with its
// own tau[s] and sigma[s], and touches no other instance's data, so an
// instance left out of ids is never read or written (a converged instance
// stays frozen), and one cluster's arithmetic does not depend on the batch
// or on its place in the grid.  The cut index's term arrays are padded to
// the batch's longest (term strides ex, eX), each instance with its own
// offsets.  A single solve is the batch of one.  Each cluster reads its
// state at entry and writes it at exit, behind cluster barriers, so the
// outputs may be the inputs themselves (an in-place launch).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kCols = 128;                   // n <= 128
constexpr int kGroups = kThreads / kCols;    // row groups of a band
constexpr int kWarpsPerRow = kCols / 32;
constexpr int kMaxCluster = 16;
constexpr int kMaxBatch = 128;                // instances per grid (kernel parameter arrays)
constexpr float kSA = 0.70710678118654752440f;   // 1 / sqrt(2)
constexpr float kSB = 0.57735026918962576451f;   // 1 / sqrt(3)
constexpr int kErrLayout = -2;      // the caller's plan disagrees with this layout
constexpr int kErrNoCluster = -3;   // no cluster of this shape fits on the card

// The stacked arrays of a batch; instance_arrays() gives one instance's slices.
struct Arrays {
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

struct Args {
  int n, M, k, m, iters, R, Mc, term_cap;
  int ex, eX;                                // per-instance strides of the term arrays
  Arrays in;
  // cluster s of the grid runs instance ids[s] with steps tau[s], sigma[s]
  int ids[kMaxBatch];
  float tau[kMaxBatch], sigma[kMaxBatch];
};

__device__ __forceinline__ Arrays instance_arrays(const Arrays& a, size_t b, int n, int M,
                                                  int k, int m, int ex, int eX) {
  const size_t N = n, NN = N * N;
  Arrays p;
  p.cx = a.cx + b * N;
  p.cX = a.cX + b * NN;
  p.idx = a.idx + b * M * k;
  p.lin = a.lin + b * M * k;
  p.quad = a.quad + b * M * k * k;
  p.rhs = a.rhs + b * M;
  p.act = a.act + b * M;
  p.xoff = a.xoff + b * (N + 1);
  p.xcut = a.xcut + b * ex;
  p.xcoef = a.xcoef + b * ex;
  p.Xoff = a.Xoff + b * (NN + 1);
  p.Xcut = a.Xcut + b * eX;
  p.Xcoef = a.Xcoef + b * eX;
  p.G = a.G + b * m * NN;
  p.g = a.g + b * m * N;
  p.h = a.h + b * m;
  p.x = a.x + b * N;
  p.X = a.X + b * NN;
  p.yA = a.yA + b * NN;
  p.yB = a.yB + b * NN;
  p.yC = a.yC + b * M;
  p.yD = a.yD + b * m;
  p.ax = a.ax + b * N;
  p.aX = a.aX + b * NN;
  p.aA = a.aA + b * NN;
  p.aB = a.aB + b * NN;
  p.ayC = a.ayC + b * M;
  p.ayD = a.ayD + b * m;
  p.xo = a.xo + b * N;
  p.Xo = a.Xo + b * NN;
  p.yAo = a.yAo + b * NN;
  p.yBo = a.yBo + b * NN;
  p.yCo = a.yCo + b * M;
  p.yDo = a.yDo + b * m;
  p.axo = a.axo + b * N;
  p.aXo = a.aXo + b * NN;
  p.aAo = a.aAo + b * NN;
  p.aBo = a.aBo + b * NN;
  p.ayCo = a.ayCo + b * M;
  p.ayDo = a.ayDo + b * m;
  return p;
}

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

__global__ void __launch_bounds__(kThreads, 1) pdhg_cluster_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = a.n, M = a.M, k = a.k, m = a.m, R = a.R, RN = R * n, nn = n * n;
  const int slot = static_cast<int>(blockIdx.x) / C;   // this cluster's place in the grid
  const float tau = a.tau[slot], sigma = a.sigma[slot];
  const size_t inst = static_cast<size_t>(a.ids[slot]);
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

  // the band's cut-index terms, in shared memory when they fit
  const int* xcut;
  const int* Xcut;
  const float* xcoef;
  const float* Xcoef;
  {  // this instance's arrays are addressed at entry and at exit only
  const Arrays p = instance_arrays(a.in, inst, n, M, k, m, a.ex, a.eX);

  // ---- entry: the band, the owned slots and the replicas, loaded once ----
  for (int e = t; e < rows * n; e += kThreads) {
    const int ge = r0 * n + e;
    sX[e] = p.X[ge];
    syA[e] = p.yA[ge];
    syB[e] = p.yB[ge];
    scX[e] = p.cX[ge];
    saX[e] = p.aX[ge];
    saA[e] = p.aA[ge];
    saB[e] = p.aB[ge];
    for (int q = 0; q < m; ++q) sG[q * RN + e] = p.G[static_cast<size_t>(q) * nn + ge];
  }
  for (int i = t; i < rows; i += kThreads) {
    sx[i] = p.x[r0 + i];
    sax[i] = p.ax[r0 + i];
    scx[i] = p.cx[r0 + i];
    for (int q = 0; q < m; ++q) sg[q * R + i] = p.g[q * n + r0 + i];
  }
  for (int q = t; q < M; q += kThreads) sw[q] = p.yC[q] * p.act[q];
  for (int s = t; s < slots; s += kThreads) {
    const int q = p0 + s;
    syC[s] = p.yC[q];
    sayC[s] = p.ayC[q];
    srhs[s] = p.rhs[q];
    sact[s] = p.act[q];
    for (int j = 0; j < k; ++j) {
      slin[s * k + j] = p.lin[q * k + j];
      sidx[s * k + j] = p.idx[q * k + j];
    }
    for (int j = 0; j < k * k; ++j) squad[s * k * k + j] = p.quad[q * k * k + j];
  }
  for (int q = t; q < m; q += kThreads) {
    sh[q] = p.h[q];
    syD[q] = p.yD[q];
    sayD[q] = p.ayD[q];
  }
  // the band's segments of the cut index, offsets relative to their starts
  const int ra = min(r0, n), rb = min(r0 + R, n);
  const int X0 = p.Xoff[ra * n], x0 = p.xoff[ra];
  const int LX = p.Xoff[rb * n] - X0, Lx = p.xoff[rb] - x0;
  const bool fits = LX + Lx <= a.term_cap;
  for (int e = t; e <= rows * n; e += kThreads) sXoff[e] = p.Xoff[ra * n + e] - X0;
  for (int i = t; i <= rows; i += kThreads) sxoff[i] = p.xoff[ra + i] - x0;
  if (fits) {
    for (int q = t; q < LX; q += kThreads) {
      tcut[q] = p.Xcut[X0 + q];
      tcoef[q] = p.Xcoef[X0 + q];
    }
    for (int q = t; q < Lx; q += kThreads) {
      tcut[LX + q] = p.xcut[x0 + q];
      tcoef[LX + q] = p.xcoef[x0 + q];
    }
  }
  Xcut = fits ? tcut : p.Xcut + X0;
  Xcoef = fits ? tcoef : p.Xcoef + X0;
  xcut = fits ? tcut + LX : p.xcut + x0;
  xcoef = fits ? tcoef + LX : p.xcoef + x0;
  }
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
  {
  const Arrays p = instance_arrays(a.in, inst, n, M, k, m, a.ex, a.eX);
  for (int e = t; e < rows * n; e += kThreads) {
    const int ge = r0 * n + e;
    p.Xo[ge] = sX[e];
    p.yAo[ge] = syA[e];
    p.yBo[ge] = syB[e];
    p.aXo[ge] = saX[e];
    p.aAo[ge] = saA[e];
    p.aBo[ge] = saB[e];
  }
  for (int i = t; i < rows; i += kThreads) {
    p.xo[r0 + i] = sx[i];
    p.axo[r0 + i] = sax[i];
  }
  for (int s = t; s < slots; s += kThreads) {
    p.yCo[p0 + s] = syC[s];
    p.ayCo[p0 + s] = sayC[s];
  }
  if (rank == 0) {
    for (int q = t; q < m; q += kThreads) {
      p.yDo[q] = syD[q];
      p.ayDo[q] = sayD[q];
    }
  }
  }
  cluster.sync();   // no CTA leaves while another may still address it
}

}  // namespace

namespace {

cudaLaunchConfig_t launch_config(int cluster, int instances, int smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * instances, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The kernel's attributes for (cluster, smem), and the check that the card
// holds one such cluster: done when (cluster, smem) changes, so a batch of
// another shape than the last launch's checks again.  Nothing depends on B.
int prepare(int cluster, int smem) {
  static int checked_cluster = 0, checked_smem = -1;
  if (cluster == checked_cluster && smem == checked_smem) return 0;
  cudaError_t err = cudaFuncSetAttribute(pdhg_cluster_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cluster > 8) {
    err = cudaFuncSetAttribute(pdhg_cluster_kernel,
                               cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(cluster, 1, smem, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, pdhg_cluster_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return kErrNoCluster;
  checked_cluster = cluster;
  checked_smem = smem;
  return 0;
}

int check_layout(int n, int M, int k, int m, int cluster, int term_cap, int smem) {
  if (cluster < 1 || cluster > kMaxCluster || n < 1 || n > kCols || k < 2 || k > 5 ||
      term_cap < 0)
    return kErrLayout;
  const int R = (n + cluster - 1) / cluster;
  const int Mc = (M + cluster - 1) / cluster;
  const Layout L = make_layout(n, M, k, m, cluster, R, Mc, term_cap);
  if (4 * static_cast<size_t>(L.words) != static_cast<size_t>(smem)) return kErrLayout;
  return 0;
}

}  // namespace

// One launch of `iters` iterations for the instances ids[0..count) of a
// batch stacked along the leading axis of every array, instance ids[s] with
// steps tau[s], sigma[s] (host arrays).  ex and eX are the per-instance
// strides of xcut/xcoef and Xcut/Xcoef.  The outputs may be the inputs (the
// launch then updates the listed instances in place).  cluster: CTAs a
// cluster (<= 16); term_cap and smem come from the caller's launch plan
// (lp/pdhg_kernel.py launch_plan), and smem must equal this file's layout.
// More than kMaxBatch instances go in consecutive grids.  Returns 0, a CUDA
// error, kErrLayout or kErrNoCluster.
extern "C" int pdhg_block_launch(
    int n, int M, int k, int m, int iters, int cluster, int term_cap, int smem,
    int count, const int* ids, const float* tau, const float* sigma, int ex, int eX,
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
  int err = check_layout(n, M, k, m, cluster, term_cap, smem);
  if (err == 0) err = prepare(cluster, smem);
  if (err != 0) return err;
  if (count < 0 || ex < 0 || eX < 0) return kErrLayout;

  Args a{n, M, k, m, iters, (n + cluster - 1) / cluster, (M + cluster - 1) / cluster,
         term_cap, ex, eX,
         Arrays{cx, cX, idx, lin, quad, rhs, act, xoff, xcut, xcoef, Xoff, Xcut, Xcoef,
                G, g, h, x, X, yA, yB, yC, yD, ax, aX, aA, aB, ayC, ayD,
                xo, Xo, yAo, yBo, yCo, yDo, axo, aXo, aAo, aBo, ayCo, ayDo},
         {}, {}, {}};
  for (int s0 = 0; s0 < count; s0 += kMaxBatch) {
    const int part = count - s0 < kMaxBatch ? count - s0 : kMaxBatch;
    for (int s = 0; s < part; ++s) {
      a.ids[s] = ids[s0 + s];
      a.tau[s] = tau[s0 + s];
      a.sigma[s] = sigma[s0 + s];
    }
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        launch_config(cluster, part, smem, static_cast<cudaStream_t>(stream), attr);
    const cudaError_t e = cudaLaunchKernelEx(&cfg, pdhg_cluster_kernel, a);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of this launch plan the card runs at once
// (cudaOccupancyMaxActiveClusters for a grid of `instances` clusters).
extern "C" int pdhg_block_max_active_clusters(int n, int M, int k, int m, int cluster,
                                              int term_cap, int smem, int instances,
                                              int* out) {
  int err = check_layout(n, M, k, m, cluster, term_cap, smem);
  if (err == 0) err = prepare(cluster, smem);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(cluster, instances, smem, nullptr, attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(out, pdhg_cluster_kernel, &cfg));
}
