// What the PDHG kernels share: the iteration block (pdhg_block.cu, K2), the
// checked block's control (pdhg_check.cuh, K5, the epilogue of K2's checked
// form), the power iteration for ||K|| (pdhg_norm.cu, K6) and the dense
// route's (pdhg_dense.cu, K7).  K2 takes the McCormick step from
// mccormick_pre_step, mccormick_primal_step and mccormick_dual_step; K5 and
// K7's check write the record with write_record.
//
// K2, K5 and K6 run one thread-block cluster of C CTAs x kThreads threads
// per instance; CTA r owns rows [r R, min(n, (r + 1) R)) of every (n, n) array,
// R = ceil(n / C), and pool slots [r Mc, (r + 1) Mc), Mc = ceil(M / C).
// Thread t works on column t % kCols of the band rows t / kCols,
// t / kCols + kGroups, ...  Sums run in one fixed order (no atomics), so a
// launch repeats bit for bit.
//
// The column width kCols is a template parameter W of every function that
// walks a band (Width<W>): 128 for n <= 128 (four row groups, the kernels'
// first width, whose bits and layouts it keeps) and 256 for 128 < n <= 256
// (two row groups of 256 columns: a thread still owns one column, and a band
// takes twice the passes).  cols_for(n) is the rule; the Python plans
// (lp/pdhg_kernel.py columns) mirror it.  The grid route (pdhg_grid.cu) adds
// a third, 512 for 256 < n <= 512, where a thread owns several entries, a
// fourth, 1024 for 512 < n <= 1024, whose owned state lives in global
// memory, a fifth, 2048 for 1024 < n <= 2048, whose passes over the
// dense rows read them where they lie, and the open form past n = 2048
// (kOpen, a tag at least every n it takes), whose owned entries' buffer
// lives in global memory too, so that a CTA may own any number of
// entries; it ends only where an index of X's entries, n n + n, would
// pass 2^31 (kOpenMax).
//
// The control record: every solve keeps one int32 record of kRecWords words
// per instance in device memory (lp/pdhg.py REC_*: the same offsets, held
// equal by tests/test_torch_pdhg_check.py).  K5 writes it at the end of each
// checked launch; K2 reads its steps and the stop flag from it at the start,
// so the solve's loop needs no host read between blocks.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace pdhg {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kNarrow = 128;                 // the width for n <= 128
constexpr int kWide = 256;                   // and for 128 < n <= 256
constexpr int kWidest = 512;                 // and for 256 < n <= 512 (pdhg_grid.cu alone)
constexpr int kHuge = 1024;                  // and for 512 < n <= 1024 (pdhg_grid.cu alone)
constexpr int kVast = 2048;                  // and for 1024 < n <= 2048 (pdhg_grid.cu alone)
constexpr int kOpen = 65536;                 // the open form, 2048 < n <= kOpenMax (pdhg_grid.cu)
constexpr int kOpenMax = 46340;              // the largest n with n n + n < 2^31
constexpr int kMaxCluster = 16;
constexpr float kSA = 0.70710678118654752440f;   // 1 / sqrt(2)
constexpr float kSB = 0.57735026918962576451f;   // 1 / sqrt(3)
constexpr int kErrLayout = -2;      // the caller's plan disagrees with this layout
constexpr int kErrNoCluster = -3;   // no cluster of this shape fits on the card

// the control record's words: ints, then floats (stored by their bits)
constexpr int kRecIt = 0;        // iterations run
constexpr int kRecWlen = 1;      // iterations since the last restart
constexpr int kRecStop = 2;      // 1 once the instance has stopped
constexpr int kRecRestart = 3;   // 1 when the last check restarted
constexpr int kRecUseAvg = 4;    // 1 when the last check chose the average
constexpr int kRecOmega = 5;     // primal weight
constexpr int kRecErr = 6;       // KKT error of the last check's candidate
constexpr int kRecP = 7;         // its primal objective
constexpr int kRecD = 8;         // its dual bound
constexpr int kRecTau = 9;       // the next block's primal step eta / omega
constexpr int kRecSigma = 10;    // and dual step eta omega
constexpr int kRecEta = 11;      // step_scale / ||K||
constexpr int kRecDp = 12;       // the last restart's primal distance (+1e-12)
constexpr int kRecDd = 13;       // and dual distance (+1e-12)
constexpr int kRecWords = 16;

// a check's partial sums of the squared distances from the restart anchor
// (the dense route has no cut rows: its kDC stays 0)
constexpr int kND = 6;
enum { kDx, kDX, kDA, kDB, kDC, kDD };

// A band's thread layout at column width W: column t % kCols, row groups
// of kGroups, kWarpsPerRow warps a row.
template <int W>
struct Width {
  static_assert(W == kNarrow || W == kWide, "K2's widths are 128 and 256");
  static constexpr int kCols = W;
  static constexpr int kGroups = kThreads / W;
  static constexpr int kWarpsPerRow = W / 32;
};

// The width a launch at n takes: 128 up to n = 128, 256 up to n = 256, 512
// up to n = 512, 1024 up to n = 1024, 2048 up to n = 2048, else the open
// form (0: n outside 1..kOpenMax, which no kernel takes).  K2, K6 and the
// dense route's kernels of pdhg_dense.cu take the first two; the grid
// route's kernels (pdhg_grid.cu) all six.
__host__ __device__ constexpr int cols_for(int n) {
  return n < 1 || n > kOpenMax
             ? 0
             : (n <= kNarrow
                    ? kNarrow
                    : (n <= kWide
                           ? kWide
                           : (n <= kWidest ? kWidest
                                           : (n <= kHuge ? kHuge : (n <= kVast ? kVast : kOpen)))));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The CTA's sums of v[0..NV) over its threads, in one fixed order (each
// warp's butterfly, then the warps in order), into out[0..NV) in shared
// memory; scratch holds (kThreads / 32) NV floats.  Every thread calls it.
template <int NV>
__device__ __forceinline__ void block_sums(float (&v)[NV], float* scratch, float* out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = warp_sum(v[j]);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) scratch[warp * NV + j] = v[j];
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) s += scratch[w * NV + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// sum over q in [q0, q1) of w[cut[q]] coef[q], in order: one destination's
// segment of the cut index (relax/cutbuffer.py build_cut_index)
__device__ __forceinline__ float segment_sum(const int* cut, const float* coef, int q0, int q1,
                                             const float* w) {
  float s = 0.0f;
  for (int q = q0; q < q1; ++q) s += w[cut[q]] * coef[q];
  return s;
}

// lin . x[id] + <quad, X[id, id]> of one cut of width K, with x(i) and
// X(i, j) given by the caller: every read is issued before the sums
// (unrolled), so remote reads cost about one latency, not K^2
template <int K, class XAt, class XXAt>
__device__ __forceinline__ float cut_residual(const int* id, const float* l, const float* qd,
                                              XAt x_at, XXAt X_at) {
  float xs[K], xv[K * K];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int iu = id[u];
    xs[u] = x_at(iu);
#pragma unroll
    for (int v = 0; v < K; ++v) xv[u * K + v] = X_at(iu, id[v]);
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

template <class XAt, class XXAt>
__device__ __forceinline__ float cut_residual_k(int k, const int* id, const float* l,
                                                const float* qd, XAt x_at, XXAt X_at) {
  switch (k) {
    case 2: return cut_residual<2>(id, l, qd, x_at, X_at);
    case 3: return cut_residual<3>(id, l, qd, x_at, X_at);
    case 4: return cut_residual<4>(id, l, qd, x_at, X_at);
    default: return cut_residual<5>(id, l, qd, x_at, X_at);
  }
}

// ---- the McCormick step over a band (K2), at column width W ----------------
// Thread t works on column t % kCols of the band rows t / kCols + kGroups j;
// every (n, n) array below is the CTA's band of R rows (r0 its first global
// row, `rows` those that exist); x-like arrays hold the band's rows, xb is
// the replica of all n.  The callers pass the adjoints of their other rows
// (cuts, dense rows) as adj(e, base) and adj_x(i, base): gX and gx at band
// entry e or row i, given base, the box rows' part.

// A: S = X - tau (cX - gX) and its transposed tile to the column owners'
// ST; the row sums of yA and yB per warp (rowA, rowB, local) and the column
// partials of yB (colP, to the owners).  A cluster barrier follows.
template <int W, class Adj>
__device__ __forceinline__ void mccormick_pre_step(
    cg::cluster_group& cluster, const float* X, const float* yA, const float* yB,
    const float* cX, float* S, float* ST, float* rowA, float* rowB, float* colP, float tau,
    int n, int R, int r0, int rows, int rank, Adj adj) {
  constexpr int kCols = Width<W>::kCols, kGroups = Width<W>::kGroups;
  constexpr int kWarpsPerRow = Width<W>::kWarpsPerRow;
  const int t = threadIdx.x, c = t % kCols, grp = t / kCols, lane = t % 32, wr = c / 32;
  float cb = 0.0f;
  for (int il = grp; il < rows; il += kGroups) {   // uniform across each warp
    float va = 0.0f, vb = 0.0f;
    if (c < n) {
      const int e = il * n + c;
      va = yA[e];
      vb = yB[e];
      const float gX = adj(e, -kSA * va + kSB * vb);
      const float s = X[e] - tau * (cX[e] - gX);
      S[e] = s;
      const int oc = c / R;
      cluster.map_shared_rank(ST, oc)[(c - oc * R) * n + r0 + il] = s;
      cb += vb;
    }
    const float rA = warp_sum(va);
    const float rB = warp_sum(vb);
    if (lane == 0) {
      rowA[il * kWarpsPerRow + wr] = rA;
      rowB[il * kWarpsPerRow + wr] = rB;
    }
  }
  if (c < n) {
    const int oc = c / R;
    cluster.map_shared_rank(colP, oc)[(rank * kGroups + grp) * R + (c - oc * R)] = cb;
  }
}

// B1: gx from the row sums and the column partials, the x step (clipped to
// [0, 1]) and its sum, xb = 2 x - x_old to every CTA's replica; then
// X = clip(sym(S)), Xb = 2 X - X_old and X's sum.  A cluster barrier follows.
template <int W, class AdjX>
__device__ __forceinline__ void mccormick_primal_step(
    cg::cluster_group& cluster, float* x, float* ax, const float* cx, float* X, float* aX,
    const float* S, const float* ST, float* Xb, float* xb, const float* rowA,
    const float* rowB, const float* colP, float tau, int n, int R, int r0, int rows, int C,
    AdjX adj_x) {
  constexpr int kCols = Width<W>::kCols, kGroups = Width<W>::kGroups;
  constexpr int kWarpsPerRow = Width<W>::kWarpsPerRow;
  const int t = threadIdx.x, c = t % kCols, grp = t / kCols;
  if (t < rows) {
    float sa = 0.0f, sb = 0.0f, sc = 0.0f;
#pragma unroll
    for (int q = 0; q < kWarpsPerRow; ++q) {
      sa += rowA[t * kWarpsPerRow + q];
      sb += rowB[t * kWarpsPerRow + q];
    }
    for (int q = 0; q < C * kGroups; ++q) sc += colP[q * R + t];
    const float gx = adj_x(t, kSA * sa - kSB * (sb + sc));
    const float xo = x[t];
    const float xn = fminf(fmaxf(xo - tau * (cx[t] - gx), 0.0f), 1.0f);
    x[t] = xn;
    ax[t] += xn;
    const float xbv = 2.0f * xn - xo;
    for (int r = 0; r < C; ++r) cluster.map_shared_rank(xb, r)[r0 + t] = xbv;
  }
  if (c < n) {
    for (int il = grp; il < rows; il += kGroups) {
      const int e = il * n + c;
      const float xn = fminf(fmaxf(0.5f * (S[e] + ST[e]), 0.0f), 1.0f);
      Xb[e] = 2.0f * xn - X[e];
      X[e] = xn;
      aX[e] += xn;
    }
  }
}

// B2: the dual ascent on yA and yB at (xb, Xb), and their sums.
template <int W>
__device__ __forceinline__ void mccormick_dual_step(float* yA, float* yB, float* aA, float* aB,
                                                    const float* Xb, const float* xb,
                                                    float sigma, int n, int r0, int rows) {
  constexpr int kCols = Width<W>::kCols, kGroups = Width<W>::kGroups;
  const int t = threadIdx.x, c = t % kCols, grp = t / kCols;
  if (c < n) {
    const float xbc = xb[c];
    for (int il = grp; il < rows; il += kGroups) {
      const int e = il * n + c;
      const float xbv = Xb[e];
      const float xbi = xb[r0 + il];
      const float kA = kSA * (xbi - xbv);
      const float kB = kSB * (xbv - xbi - xbc);
      const float ya = fmaxf(yA[e] - sigma * kA, 0.0f);
      const float yb = fmaxf(yB[e] + sigma * (-kSB - kB), 0.0f);
      yA[e] = ya;
      yB[e] = yb;
      aA[e] += ya;
      aB[e] += yb;
    }
  }
}

// ---- the record after a checked block (K5 and the dense route's check) ----
// One thread writes it.  dec: err, p, d of the current point, then of the
// average; dist: the C ranks' (C, kND) distance partials, summed in rank
// order on a restart; wlen: the window before this block.  On a restart
// omega moves by PDLP's primal-weight rule (theta = 0.5); then the stop test
// and the next block's steps.
__device__ __forceinline__ void write_record(int* rec, const float* dec, bool use_avg,
                                             bool restart, int wlen, const float* dist, int C,
                                             int check_every, int max_iters, float tol) {
  const int P = use_avg ? 1 : 0;
  const float err = dec[3 * P], p = dec[3 * P + 1], d = dec[3 * P + 2];
  float omega = __int_as_float(rec[kRecOmega]);
  const float eta = __int_as_float(rec[kRecEta]);
  int wl = wlen;
  if (restart) {
    float s[kND];
    for (int j = 0; j < kND; ++j) {
      s[j] = 0.0f;
      for (int r = 0; r < C; ++r) s[j] += dist[r * kND + j];
    }
    const float dp = sqrtf(s[kDx] + s[kDX]) + 1e-12f;
    const float dd = sqrtf(((s[kDA] + s[kDB]) + s[kDC]) + s[kDD]) + 1e-12f;
    const float e = expf(__fadd_rn(__fmul_rn(0.5f, logf(dd / dp)), __fmul_rn(0.5f, logf(omega))));
    omega = fminf(fmaxf(e, 1e-4f), 1e4f);
    rec[kRecDp] = __float_as_int(dp);
    rec[kRecDd] = __float_as_int(dd);
    wl = 0;
  }
  const int it = rec[kRecIt] + check_every;
  const float rel = err / ((1.0f + fabsf(p)) + fabsf(d));
  rec[kRecIt] = it;
  rec[kRecWlen] = wl;
  rec[kRecStop] = (it >= max_iters || !(rel > tol)) ? 1 : 0;
  rec[kRecRestart] = restart ? 1 : 0;
  rec[kRecUseAvg] = use_avg ? 1 : 0;
  rec[kRecOmega] = __float_as_int(omega);
  rec[kRecErr] = __float_as_int(err);
  rec[kRecP] = __float_as_int(p);
  rec[kRecD] = __float_as_int(d);
  rec[kRecTau] = __float_as_int(eta / omega);
  rec[kRecSigma] = __float_as_int(eta * omega);
}

// one cluster of `cluster` CTAs per instance, `instances` clusters
inline cudaLaunchConfig_t launch_config(int cluster, int instances, int smem,
                                        cudaStream_t stream, cudaLaunchAttribute* attr) {
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

// A kernel's attributes for (cluster, smem), and the check that the card
// holds one such cluster; `checked` keeps the last pair that passed.
template <class Kernel>
int prepare_cluster(Kernel kernel, int cluster, int smem, int checked[2]) {
  if (cluster == checked[0] && smem == checked[1]) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(cluster, 1, smem, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return kErrNoCluster;
  checked[0] = cluster;
  checked[1] = smem;
  return 0;
}

}  // namespace pdhg
