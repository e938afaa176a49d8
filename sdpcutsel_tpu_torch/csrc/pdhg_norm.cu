// The power iteration for ||K||, K6: all `iters` iterations of
// lp/pdhg.py estimate_norm_plain in one launch, float32, for every instance
// of a batch:
//
//   repeat iters times:  (kA, kB, kC, kD) = K (x, X)
//                        (gx, gX) = K^T (kA, kB, kC act, kD); gX = sym(gX)
//                        (x, X) = (gx, gX) / (||(gx, gX)|| + 1e-30)
//   ||K|| ~ ||K (x, X)|| 1.02 + 1e-12
//
// on the symmetric-X primal subspace, from the start vector (x0, X0) the
// caller draws (one seeded CPU draw, uploaded once).  The reference runs it
// as a jitted fori_loop in XLA (sdpcutsel_tpu/lp/pdhg.py estimate_norm); no
// Pallas kernel.
//
// Layout: K2's bands (pdhg_common.cuh), one cluster of C CTAs per instance.
// The iterate lives in global memory unnormalised, (y, Y) = ||.|| (x, X),
// with its norm in every CTA, so x = y / nrm and X = Y / nrm are formed as
// they are read: the same division the twin does.  An iteration is three
// steps between cluster barriers:
//   1  the band's kA, kB (shared memory), their row sums, the column
//      partials of kB to the owners of the columns; the owned slots' cut
//      rows kC act, pushed to every CTA's replica of the weights; each
//      rank's partial K z of the dense rows to every CTA;  cluster barrier
//   2  gx, gX of the band (the cut adjoint over the fixed-order cut index,
//      the dense adjoint with kD summed in rank order); gX to the owner of
//      its column as a transposed tile;                    cluster barrier
//   3  sym(gX) and gx of the band written to (Y, y); the band's sums of
//      squares to every CTA, summed in rank order into the norm.
//                                                          cluster barrier
// After the last iteration step 1 runs once more, and its sums of squares
// give ||K z||.  No atomics and one order for every sum, so a launch repeats
// bit for bit; the twin sums in torch's order and agrees to rounding.

#include "pdhg_common.cuh"

namespace {

using namespace pdhg;

struct Arrays {
  const int* idx;
  const float *lin, *quad, *act;
  const int* xoff;
  const int* xcut;
  const float* xcoef;
  const int* Xoff;
  const int* Xcut;
  const float* Xcoef;
  const float *G, *g;
  float *y, *Y;       // (B, n), (B, n, n): the start vector in, the last iterate out
  float* out;         // (B,) ||K|| 1.02 + 1e-12
};

struct Args {
  int n, M, k, m, R, Mc, ex, eX, iters;
  Arrays in;
};

struct Layout {
  int kA, kB, gX, GT;      // (R, n) bands: K's first two blocks, gX, the transposed tiles
  int rowA, rowB;          // (R, kWarpsPerRow) row partials of kA, kB
  int colP;                // (C kGroups, R) column partials of kB
  int xs;                  // (kCols,) x = y / nrm
  int gx;                  // (R,) the band's gx
  int w;                   // (M,) the weights (kC act) act, every slot
  int kDp, kD;             // (C, m) dense partials, (m,) their sums
  int red;                 // (C, 4) every rank's sums of squares (norm, last step)
  int scratch;             // (kThreads / 32, 2) block sums
  int tot;                 // (4,) this CTA's sums
  int words;
};

__host__ __device__ inline Layout make_layout(int n, int M, int m, int C, int R) {
  Layout L;
  int o = 0;
  const int RN = R * n;
#define TAKE(field, words) L.field = o; o += (words)
  TAKE(kA, RN); TAKE(kB, RN); TAKE(gX, RN); TAKE(GT, RN);
  TAKE(rowA, R * kWarpsPerRow); TAKE(rowB, R * kWarpsPerRow);
  TAKE(colP, C * kGroups * R);
  TAKE(xs, kCols); TAKE(gx, R);
  TAKE(w, M);
  TAKE(kDp, C * m); TAKE(kD, m);
  TAKE(red, C * 4);
  TAKE(scratch, (kThreads / 32) * 2);
  TAKE(tot, 4);
#undef TAKE
  L.words = o;
  return L;
}

__global__ void __launch_bounds__(kThreads, 1) pdhg_norm_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = a.n, M = a.M, k = a.k, m = a.m, R = a.R;
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t inst = static_cast<size_t>(blockIdx.x) / C;
  const Layout L = make_layout(n, M, m, C, R);
  const int* idx = a.in.idx + inst * M * k;
  const float* lin = a.in.lin + inst * M * k;
  const float* quad = a.in.quad + inst * M * k * k;
  const float* act = a.in.act + inst * M;
  const int* xoff = a.in.xoff + inst * (n + 1);
  const int* xcut = a.in.xcut + inst * a.ex;
  const float* xcoef = a.in.xcoef + inst * a.ex;
  const int* Xoff = a.in.Xoff + inst * (nn + 1);
  const int* Xcut = a.in.Xcut + inst * a.eX;
  const float* Xcoef = a.in.Xcoef + inst * a.eX;
  const float* G = a.in.G + inst * m * nn;
  const float* g = a.in.g + inst * m * n;
  float* const y = a.in.y + inst * n;
  float* const Y = a.in.Y + inst * nn;

  float* const skA = sm + L.kA;
  float* const skB = sm + L.kB;
  float* const sgX = sm + L.gX;
  float* const sGT = sm + L.GT;
  float* const srowA = sm + L.rowA;
  float* const srowB = sm + L.rowB;
  float* const scolP = sm + L.colP;
  float* const sxs = sm + L.xs;
  float* const sgx = sm + L.gx;
  float* const sw = sm + L.w;
  float* const skDp = sm + L.kDp;
  float* const skD = sm + L.kD;
  float* const sred = sm + L.red;

  const int t = threadIdx.x;
  const int c = t % kCols;
  const int grp = t / kCols;
  const int lane = t % 32;
  const int wr = c / 32;
  const int r0 = rank * R;
  const int rows = max(0, min(R, n - r0));
  const int p0 = rank * a.Mc;
  const int slots = max(0, min(a.Mc, M - p0));

  float nrm = 1.0f;        // the start vector is used as it is (x / 1 = x)
  cluster.sync();          // every CTA has started before any remote store
  for (int it = 0;; ++it) {
    const bool last = it == a.iters;
    // ---- 1: K z at z = (y, Y) / nrm ----------------------------------------
    for (int j = t; j < n; j += kThreads) sxs[j] = y[j] / nrm;
    __syncthreads();
    float sq[2] = {0.0f, 0.0f};      // the last step's sums of kA^2 + kB^2, (kC act)^2
    float cb = 0.0f;
    for (int il = grp; il < rows; il += kGroups) {   // uniform across each warp
      float va = 0.0f, vb = 0.0f;
      if (c < n) {
        const int i = r0 + il, e = il * n + c;
        const float Xv = Y[static_cast<size_t>(i) * n + c] / nrm;
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
    for (int s = t; s < slots; s += kThreads) {
      const int q = p0 + s;
      const float am = act[q];
      float kc = 0.0f;
      if (am != 0.0f) {
        const float res = cut_residual_k(
            k, idx + q * k, lin + q * k, quad + q * k * k, [&](int iu) { return sxs[iu]; },
            [&](int iu, int iv) { return Y[static_cast<size_t>(iu) * n + iv] / nrm; });
        kc = res * am;                       // K's cut block
      }
      const float yc = kc * am;              // the adjoint's dual, as the twin passes it
      sq[1] += yc * yc;
      if (!last) {
        const float wv = yc * am;
        for (int r = 0; r < C; ++r) cluster.map_shared_rank(sw, r)[p0 + s] = wv;
      }
    }
    for (int q = t / 32; q < m; q += kThreads / 32) {   // one warp per dense row
      float r2 = 0.0f, r1 = 0.0f;
      for (int e = lane; e < rows * n; e += 32) {
        const size_t ge = static_cast<size_t>(r0) * n + e;
        r2 += G[q * nn + ge] * (Y[ge] / nrm);
      }
      for (int j = lane; j < rows; j += 32) r1 += g[q * n + r0 + j] * sxs[r0 + j];
      const float part = warp_sum(r2) + warp_sum(r1);
      if (lane < C) cluster.map_shared_rank(skDp, lane)[rank * m + q] = part;
    }
    if (last) {
      block_sums(sq, sm + L.scratch, sm + L.tot);
      // columns 2, 3 of rank 0's sums: a CTA may still be reading columns
      // 0, 1 for the last norm
      if (t < 2) cluster.map_shared_rank(sred, 0)[rank * 4 + 2 + t] = sm[L.tot + t];
      cluster.sync();
      if (rank == 0 && t == 0) {
        float s0 = 0.0f, s1 = 0.0f, sD = 0.0f;
        for (int r = 0; r < C; ++r) {
          s0 += sred[r * 4 + 2];
          s1 += sred[r * 4 + 3];
        }
        for (int q = 0; q < m; ++q) {
          float kD = 0.0f;
          for (int r = 0; r < C; ++r) kD += skDp[r * m + q];
          sD += kD * kD;
        }
        a.in.out[inst] = sqrtf((s0 + s1) + sD) * 1.02f + 1e-12f;
      }
      break;
    }
    cluster.sync();

    // ---- 2: (gx, gX) = K^T (kA, kB, kC act, kD) over the band -------------
    for (int q = t; q < m; q += kThreads) {
      float kD = 0.0f;
      for (int r = 0; r < C; ++r) kD += skDp[r * m + q];
      skD[q] = kD;
    }
    __syncthreads();
    if (t < rows) {
      const int i = r0 + t;
      float sa = 0.0f, sb = 0.0f, sc = 0.0f;
#pragma unroll
      for (int q = 0; q < kWarpsPerRow; ++q) {
        sa += srowA[t * kWarpsPerRow + q];
        sb += srowB[t * kWarpsPerRow + q];
      }
      for (int q = 0; q < C * kGroups; ++q) sc += scolP[q * R + t];
      const float cut = segment_sum(xcut, xcoef, xoff[i], xoff[i + 1], sw);
      float gx = (kSA * sa - kSB * (sb + sc)) + cut;
      if (m > 0) {
        float dn = 0.0f;
        for (int q = 0; q < m; ++q) dn += skD[q] * g[q * n + i];
        gx += dn;
      }
      sgx[t] = gx;
    }
    if (c < n) {
      for (int il = grp; il < rows; il += kGroups) {
        const int i = r0 + il, e = il * n + c;
        const size_t ge = static_cast<size_t>(i) * n + c;
        const float cut = segment_sum(Xcut, Xcoef, Xoff[ge], Xoff[ge + 1], sw);
        float gX = (-kSA * skA[e] + kSB * skB[e]) + cut;
        if (m > 0) {
          float dn = 0.0f;
          for (int q = 0; q < m; ++q) dn += skD[q] * G[q * nn + ge];
          gX += dn;
        }
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

int check_shape(int n, int M, int k, int m, int cluster) {
  if (cluster < 1 || cluster > kMaxCluster || n < 1 || n > kCols || k < 2 || k > 5 ||
      M < 0 || m < 0)
    return kErrLayout;
  return 0;
}

}  // namespace

// ||K|| of every instance of a batch of B (one cluster of `cluster` CTAs
// each) after `iters` power iterations from (y, Y), which hold the start
// vector on entry and are overwritten.  ex and eX are the per-instance
// strides of xcut/xcoef and Xcut/Xcoef.  Writes out[0..B).  Returns 0, a CUDA
// error, kErrLayout or kErrNoCluster.
extern "C" int pdhg_norm_launch(
    int n, int M, int k, int m, int B, int cluster, int ex, int eX, int iters,
    const int* idx, const float* lin, const float* quad, const float* act,
    const int* xoff, const int* xcut, const float* xcoef,
    const int* Xoff, const int* Xcut, const float* Xcoef,
    const float* G, const float* g, float* y, float* Y, float* out, void* stream) {
  static int checked[2] = {0, -1};
  int err = check_shape(n, M, k, m, cluster);
  const int smem = 4 * make_layout(n, M, m, cluster, (n + cluster - 1) / cluster).words;
  if (err == 0) err = prepare_cluster(pdhg_norm_kernel, cluster, smem, checked);
  if (err != 0) return err;
  if (B < 1 || ex < 0 || eX < 0 || iters < 0) return kErrLayout;
  Args a{n, M, k, m, (n + cluster - 1) / cluster, (M + cluster - 1) / cluster, ex, eX, iters,
         Arrays{idx, lin, quad, act, xoff, xcut, xcoef, Xoff, Xcut, Xcoef, G, g, y, Y, out}};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(cluster, B, smem, static_cast<cudaStream_t>(stream), attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, pdhg_norm_kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}
