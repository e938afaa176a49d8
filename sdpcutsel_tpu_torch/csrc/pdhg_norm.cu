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
// caller passes (lp/pdhg_norm.py: one seeded draw, kept on the device for
// each n).  The reference runs it as a jitted fori_loop in XLA
// (sdpcutsel_tpu/lp/pdhg.py estimate_norm); no Pallas kernel.
//
// Layout: K2's bands (pdhg_common.cuh) at K2's column width (128 for
// n <= 128, 256 up to n = 256), one cluster of C CTAs per instance, and the
// iterate on chip for the whole launch.  CTA r keeps its band of Y
// and a replica of y in shared memory, unnormalised, (y, Y) = ||.|| (x, X),
// with the norm in every CTA, so x = y / nrm and X = Y / nrm are formed as
// they are read: the same division the twin does.  The band's slice of the
// dense rows (G_q's rows [r R, r R + R) and g_q's entries, every q) is
// copied into shared memory once a launch where the layout holds it
// (`resident`: up to ~2,500 / n rows at n = 125, i.e. every QCQP shape of
// the registry), and read from global memory on each pass otherwise; so are
// the cut data the CTA reads each iteration (`staged`: the supports and
// coefficients of its slots, the band's cut-index segments, where they
// fit), since a global read after a cluster barrier goes to L2.  An
// iteration is three steps between cluster barriers, the least its sums
// need (the cut and dense rows' K z before K^T, the transposed tile before
// sym, every band's sum of squares before the next division):
//   1  z = Y / nrm of the band (kept for the dense rows), kA, kB (shared
//      memory), their row sums, the column partials of kB to the owners of
//      the columns; the active slots' cut rows kC act (slot q on CTA q mod C,
//      its supports' X read from the owners' bands through distributed
//      shared memory), pushed to every CTA's replica of the weights; each
//      rank's partial K z of the dense rows to every CTA;     cluster barrier
//   2  gx, gX of the band (the cut adjoint over the fixed-order cut index,
//      the dense adjoint with kD summed in rank order, q increasing; gx's
//      three sums in three warps at once); gX over the band of Y (dead since
//      barrier 1) and to the owner of its column as a transposed tile;
//                                                             cluster barrier
//   3  sym(gX) into the band of Y, gx into every CTA's replica of y; the
//      band's sums of squares to every CTA, summed in rank order into the
//      norm.                                                  cluster barrier
// After the last iteration step 1 runs once more, and its sums of squares
// give ||K z|| (each slot's (kC act)^2 summed by the CTA that owns the slot,
// after one more barrier).  Every sum runs in the order and on the values of
// the version that kept the iterate in global memory, so the result keeps
// its bits.  No atomics and one order for every sum, so a launch repeats bit
// for bit; the twin sums in torch's order and agrees to rounding.

#include "pdhg_common.cuh"

namespace {

using namespace pdhg;

constexpr int kSmemWords = 232448 / 4;   // a CTA's dynamic shared memory on the H100

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
  const float *y, *Y;  // (n,), (n, n): the start vector of every instance
  float* out;          // (B,) ||K|| 1.02 + 1e-12
};

struct Args {
  int n, M, k, m, R, Mc, ex, eX, iters;
  Arrays in;
};

// Offsets, in 4-byte words, of one CTA's dynamic shared memory at column
// width W.  lp/pdhg_norm.py::smem_words mirrors the sum.
struct Layout {
  int kA, kB;              // (R, n) bands: K's first two blocks
  int Y;                   // (R, n) the band of Y; gX in step 2
  int GT;                  // (R, n) z = Y / nrm in step 1; the transposed tiles of gX
  int rowA, rowB;          // (R, kWarpsPerRow) row partials of kA, kB
  int colP;                // (C kGroups, R) column partials of kB
  int xs;                  // (kCols,) the replica of y; x = y / nrm in step 1
  int gx;                  // (R,) the band's gx
  int w;                   // (M,) the weights (kC act) act, every slot
  int kDp, kD;             // (C, m) dense partials, (m,) their sums
  int red;                 // (C, 4) every rank's sums of squares (norm, last step)
  int scratch;             // (kThreads / 32, 2) block sums
  int tot;                 // (4,) this CTA's sums
  int Gd, gd;              // resident: (m, R n) the band's G_q, (m, R) its g_q; else empty
  // staged: the cut data of the slots this CTA computes (q = rank + C j, j <
  // Mc) and the band's cut-index offsets; else empty.  The band's terms
  // take what is left (cap each), where they fit.
  int act, idx, lin, quad;  // (Mc,), (Mc, k), (Mc, k), (Mc, k, k)
  int gath;                 // (Mc, k, k) X at the supports, gathered each step
  int xoff, Xoff;           // (R + 1,), (R n + 1,) offsets relative to the band's first term
  int tcut, tcoef;          // (cap,) the band's X terms, then its x terms
  int cap;
  int words;
};

template <int W>
__host__ __device__ inline Layout make_layout(int n, int M, int k, int m, int C, int R) {
  constexpr int kCols = Width<W>::kCols, kGroups = Width<W>::kGroups;
  constexpr int kWarpsPerRow = Width<W>::kWarpsPerRow;
  Layout L;
  int o = 0;
  const int RN = R * n;
#define TAKE(field, words) L.field = o; o += (words)
  TAKE(kA, RN); TAKE(kB, RN); TAKE(Y, RN); TAKE(GT, RN);
  TAKE(rowA, R * kWarpsPerRow); TAKE(rowB, R * kWarpsPerRow);
  TAKE(colP, C * kGroups * R);
  TAKE(xs, kCols); TAKE(gx, R);
  TAKE(w, M);
  TAKE(kDp, C * m); TAKE(kD, m);
  TAKE(red, C * 4);
  TAKE(scratch, (kThreads / 32) * 2);
  TAKE(tot, 4);
  const bool resident = m > 0 && static_cast<long long>(o) + static_cast<long long>(m) *
                                                               (RN + R) <= kSmemWords;
  TAKE(Gd, resident ? m * RN : 0);
  TAKE(gd, resident ? m * R : 0);
  const int Mc = (M + C - 1) / C;
  const bool staged = static_cast<long long>(o) + static_cast<long long>(Mc) *
                      (1 + 2 * k + 2 * k * k) + (RN + 1) + (R + 1) <= kSmemWords;
  TAKE(act, staged ? Mc : 0); TAKE(idx, staged ? Mc * k : 0); TAKE(lin, staged ? Mc * k : 0);
  TAKE(quad, staged ? Mc * k * k : 0); TAKE(gath, staged ? Mc * k * k : 0);
  TAKE(xoff, staged ? R + 1 : 0); TAKE(Xoff, staged ? RN + 1 : 0);
  L.cap = staged ? (kSmemWords - o) / 2 : 0;
  TAKE(tcut, L.cap); TAKE(tcoef, L.cap);
#undef TAKE
  L.words = o;
  return L;
}

// segment_sum (pdhg_common.cuh) with four terms' loads issued together: the
// same sum in the same order
__device__ __forceinline__ float segment_sum4(const int* cut, const float* coef, int q0, int q1,
                                              const float* w) {
  float s = 0.0f;
#pragma unroll 4
  for (int q = q0; q < q1; ++q) s += w[cut[q]] * coef[q];
  return s;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// kStaged: the layout stages the cut data and its terms' capacity holds
// every term of the cut index (the launch decides), so that every read of
// the loop is from shared memory; else the cut data is read from global
// memory, the dense slice still resident where it fits.  W: the column width.
template <bool kStaged, int W>
__global__ void __launch_bounds__(kThreads, 1) pdhg_norm_kernel(const __grid_constant__ Args a) {
  constexpr int kCols = Width<W>::kCols, kGroups = Width<W>::kGroups;
  constexpr int kWarpsPerRow = Width<W>::kWarpsPerRow;
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = a.n, M = a.M, k = a.k, m = a.m, R = a.R, RN = R * n;
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t inst = static_cast<size_t>(blockIdx.x) / C;
  const Layout L = make_layout<W>(n, M, k, m, C, R);
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

  float* const skA = sm + L.kA;
  float* const skB = sm + L.kB;
  float* const sY = sm + L.Y;
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

  // the band's rows of the dense rows: G_q's band (contiguous: rows n
  // floats at q n^2 + r0 n) and g_q's entries, from shared memory where
  // resident, else from global memory, at q gs + e and q hs + j
  const bool resident = L.Gd < L.words;
  const float* const Gb = resident ? sm + L.Gd : G + r0 * n;
  const float* const gb = resident ? sm + L.gd : g + r0;
  const int gs = resident ? RN : n * n;       // m n^2 fits an int wherever the layout does
  const int hs = resident ? R : n;
  if (resident) {      // the launch's one read of the slice, behind the first barrier
    for (int p = t; p < m * rows * n; p += kThreads) {
      const int q = p / (rows * n), e = p - q * (rows * n);
      cp_async4(sm + L.Gd + q * RN + e, G + q * nn + static_cast<size_t>(r0) * n + e);
    }
    for (int p = t; p < m * rows; p += kThreads) {
      const int q = p / rows, j = p - q * rows;
      cp_async4(sm + L.gd + q * R + j, g + static_cast<size_t>(q) * n + r0 + j);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  // the cut data of the slots this CTA computes before the last step, and the
  // band's segments of the cut index (offsets relative to their starts), read
  // from global memory once a launch: global reads after a cluster barrier
  // go to L2
  const int ra = min(r0, n), rb = min(r0 + R, n);
  const int X0 = Xoff[static_cast<size_t>(ra) * n], x0 = xoff[ra];
  const int LX = Xoff[static_cast<size_t>(rb) * n] - X0, Lx = xoff[rb] - x0;
  // the band's offsets and the terms they index: the pool's (absolute), or
  // the staged ones (relative to the band's first terms)
  const int* bXoff = Xoff + static_cast<size_t>(ra) * n;
  const int* bxoff = xoff + ra;
  const int* tXcut = Xcut;
  const float* tXcoef = Xcoef;
  const int* txcut = xcut;
  const float* txcoef = xcoef;
  if constexpr (kStaged) {
    float* const a_ = sm + L.act;
    int* const i_ = reinterpret_cast<int*>(sm + L.idx);
    float* const l_ = sm + L.lin;
    float* const q_ = sm + L.quad;
    for (int j = t; j < a.Mc; j += kThreads) {
      const int q = rank + C * j;
      a_[j] = q < M ? act[q] : 0.0f;
      if (q < M) {
        for (int u = 0; u < k; ++u) {
          i_[j * k + u] = idx[q * k + u];
          l_[j * k + u] = lin[q * k + u];
        }
        for (int u = 0; u < k * k; ++u) q_[j * k * k + u] = quad[q * k * k + u];
      }
    }
    int* const xo_ = reinterpret_cast<int*>(sm + L.xoff);
    int* const Xo_ = reinterpret_cast<int*>(sm + L.Xoff);
    for (int e = t; e <= rows * n; e += kThreads) Xo_[e] = Xoff[static_cast<size_t>(ra) * n + e] - X0;
    for (int i = t; i <= rows; i += kThreads) xo_[i] = xoff[ra + i] - x0;
    int* const tc = reinterpret_cast<int*>(sm + L.tcut);
    float* const tf = sm + L.tcoef;
    for (int q = t; q < LX; q += kThreads) {
      tc[q] = Xcut[X0 + q];
      tf[q] = Xcoef[X0 + q];
    }
    for (int q = t; q < Lx; q += kThreads) {
      tc[LX + q] = xcut[x0 + q];
      tf[LX + q] = xcoef[x0 + q];
    }
    bXoff = Xo_;
    bxoff = xo_;
    tXcut = tc;
    tXcoef = tf;
    txcut = tc + LX;
    txcoef = tf + LX;
  }
  // the start vector: the band of Y and the replica of y; the weights of the
  // inactive slots, which stay 0 (only the active ones are sent)
  for (int j = t; j < n; j += kThreads) sxs[j] = a.in.y[j];
  for (int q = t; q < M; q += kThreads) sw[q] = 0.0f;
  if (c < n) {
    for (int il = grp; il < rows; il += kGroups) sY[il * n + c] = a.in.Y[(r0 + il) * n + c];
  }
  if (resident) asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  float nrm = 1.0f;        // the start vector is used as it is (x / 1 = x)
  cluster.sync();          // every CTA has started before any remote access
  for (int it = 0;; ++it) {
    const bool last = it == a.iters;
    // ---- 1: K z at z = (y, Y) / nrm ----------------------------------------
    for (int j = t; j < n; j += kThreads) sxs[j] = sxs[j] / nrm;
    __syncthreads();
    float sq[2] = {0.0f, 0.0f};      // the last step's sums of kA^2 + kB^2, (kC act)^2
    float cb = 0.0f;
    for (int il = grp; il < rows; il += kGroups) {   // uniform across each warp
      float va = 0.0f, vb = 0.0f;
      if (c < n) {
        const int i = r0 + il, e = il * n + c;
        const float Xv = sY[e] / nrm;
        sGT[e] = Xv;
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
    // the cut rows: slot q's K row, X at its supports read from the bands of
    // the CTAs that own their rows, computed by CTA q mod C (the active
    // slots, which a pool keeps first, spread over the cluster).  Before the
    // last step, to every CTA's replica of the weights (an inactive slot's
    // weight stays 0); the last step sums (kC act)^2 over each CTA's own
    // slots [r Mc, (r + 1) Mc) in order, as the twin's partition does.
    // staged: X at the supports of the CTA's active slots gathered into
    // shared memory by every thread at once (each value read and divided as
    // the row would), then each slot's row sums them in its order
    if constexpr (kStaged) {
      const int kk = k * k;
      const int* const gi = reinterpret_cast<const int*>(sm + L.idx);
      for (int p = t; p < a.Mc * kk; p += kThreads) {
        const int j = p / kk, uv = p - j * kk;
        if (rank + C * j < M && sm[L.act + j] != 0.0f) {
          const int iu = gi[j * k + uv / k], iv = gi[j * k + uv % k];
          const int ou = iu / R;
          sm[L.gath + p] = cluster.map_shared_rank(sY, ou)[(iu - ou * R) * n + iv] / nrm;
        }
      }
      __syncthreads();
    }
    // K's cut block of slot q, the CTA's j-th: lin . x[id] + <quad, X[id, id]>
    // summed as pdhg_common.cuh's cut_residual sums it, X from the gathered
    // values (staged) or read here from the owners' bands
    auto cut_row = [&](int j, int q, float am) {
      const int kk = k * k;
      const int* id;
      const float *l, *qd;
      if constexpr (kStaged) {
        id = reinterpret_cast<const int*>(sm + L.idx) + j * k;
        l = sm + L.lin + j * k;
        qd = sm + L.quad + j * kk;
      } else {
        id = idx + q * k;
        l = lin + q * k;
        qd = quad + q * kk;
      }
      float r1 = 0.0f, r2 = 0.0f;
      for (int u = 0; u < k; ++u) {
        const int iu = id[u];
        r1 += l[u] * sxs[iu];
        for (int v = 0; v < k; ++v) {
          float xv;
          if constexpr (kStaged) {
            xv = sm[L.gath + j * kk + u * k + v];
          } else {
            const int ou = iu / R;
            xv = cluster.map_shared_rank(sY, ou)[(iu - ou * R) * n + id[v]] / nrm;
          }
          r2 += qd[u * k + v] * xv;
        }
      }
      return (r1 + r2) * am;
    };
    if (!last) {
      for (int j = t; rank + C * j < M; j += kThreads) {
        const int q = rank + C * j;
        const float am = kStaged ? sm[L.act + j] : act[q];
        if (am != 0.0f) {
          const float wv = (cut_row(j, q, am) * am) * am;   // the adjoint's dual yc, times act
          for (int r = 0; r < C; ++r) cluster.map_shared_rank(sw, r)[q] = wv;
        }
      }
    } else {
      // each slot's (kC act)^2 to the CTA that owns the slot, which sums its
      // slots [p0, p0 + slots) in order (the weights' replica is free now)
      for (int j = t; rank + C * j < M; j += kThreads) {
        const int q = rank + C * j;
        const float am = kStaged ? sm[L.act + j] : act[q];
        const float kc = am != 0.0f ? cut_row(j, q, am) : 0.0f;
        const float yc = kc * am;            // the adjoint's dual, as the twin passes it
        const int o = q / a.Mc;
        cluster.map_shared_rank(sw, o)[q - o * a.Mc] = yc * yc;
      }
      cluster.sync();
      for (int s = t; s < slots; s += kThreads) sq[1] += sw[s];
    }
    if (m > 0) {
      __syncthreads();                       // z of the band, from every thread
      for (int q = t / 32; q < m; q += kThreads / 32) {   // one warp per dense row
        float r2 = 0.0f, r1 = 0.0f;
#pragma unroll 4
        for (int e = lane; e < rows * n; e += 32) r2 += Gb[q * gs + e] * sGT[e];
        for (int j = lane; j < rows; j += 32) r1 += gb[q * hs + j] * sxs[r0 + j];
        const float part = warp_sum(r2) + warp_sum(r1);
        if (lane < C) cluster.map_shared_rank(skDp, lane)[rank * m + q] = part;
      }
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
#pragma unroll 4
      for (int r = 0; r < C; ++r) kD += skDp[r * m + q];
      skD[q] = kD;
    }
    __syncthreads();
    // gx's three chains run in three warps at once: the box rows' sums (warp
    // 0), the x cut terms (warp 1) and the dense adjoint (warp 2), each
    // summed in its order, combined by warp 0 after the band's gX; the x
    // replica's slots hold the last two (x is not read again before step 3)
    const bool split = 2 * R <= kCols;
    float gxb = 0.0f;                  // warp 0: the box rows' part of gx
    if (t < rows) {
      float sa = 0.0f, sb = 0.0f, sc = 0.0f;
#pragma unroll
      for (int q = 0; q < kWarpsPerRow; ++q) {
        sa += srowA[t * kWarpsPerRow + q];
        sb += srowB[t * kWarpsPerRow + q];
      }
#pragma unroll 4
      for (int q = 0; q < C * kGroups; ++q) sc += scolP[q * R + t];
      gxb = kSA * sa - kSB * (sb + sc);
    }
    auto gx_cut = [&](int j) {
      return segment_sum4(txcut, txcoef, bxoff[j], bxoff[j + 1], sw);
    };
    auto gx_dense = [&](int j) {
      float dn = 0.0f;
#pragma unroll 4
      for (int q = 0; q < m; ++q) dn += skD[q] * gb[q * hs + j];
      return dn;
    };
    if (split) {
      if (t >= 32 && t < 32 + rows) sxs[t - 32] = gx_cut(t - 32);
      if (m > 0 && t >= 64 && t < 64 + rows) sxs[R + t - 64] = gx_dense(t - 64);
    }
    if (c < n) {
      for (int il = grp; il < rows; il += kGroups) {
        const int i = r0 + il, e = il * n + c;
        const float cut = segment_sum4(tXcut, tXcoef, bXoff[e], bXoff[e + 1], sw);
        float gX = (-kSA * skA[e] + kSB * skB[e]) + cut;
        if (m > 0) {
          float dn = 0.0f;
#pragma unroll 4
          for (int q = 0; q < m; ++q) dn += skD[q] * Gb[q * gs + e];
          gX += dn;
        }
        sY[e] = gX;
        const int oc = c / R;
        cluster.map_shared_rank(sGT, oc)[(c - oc * R) * n + i] = gX;
      }
    }
    if (split) __syncthreads();
    if (t < rows) {
      float gx = gxb + (split ? sxs[t] : gx_cut(t));
      if (m > 0) gx += split ? sxs[R + t] : gx_dense(t);
      sgx[t] = gx;
    }
    cluster.sync();

    // ---- 3: the new iterate (unnormalised) and its norm --------------------
    float ss[2] = {0.0f, 0.0f};
    if (t < rows) {
      const float gx = sgx[t];
      for (int r = 0; r < C; ++r) cluster.map_shared_rank(sxs, r)[r0 + t] = gx;
      ss[0] = gx * gx;
    }
    if (c < n) {
      for (int il = grp; il < rows; il += kGroups) {
        const int e = il * n + c;
        const float s = 0.5f * (sY[e] + sGT[e]);
        sY[e] = s;
        ss[1] += s * s;
      }
    }
    block_sums(ss, sm + L.scratch, sm + L.tot);
    if (t < 2) {
      for (int r = 0; r < C; ++r) cluster.map_shared_rank(sred, r)[rank * 4 + t] = sm[L.tot + t];
    }
    cluster.sync();
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll 4
    for (int r = 0; r < C; ++r) {
      s0 += sred[r * 4];
      s1 += sred[r * 4 + 1];
    }
    nrm = sqrtf(s0 + s1) + 1e-30f;
  }
}

int check_shape(int n, int M, int k, int m, int cluster) {
  if (cluster < 1 || cluster > kMaxCluster || cols_for(n) == 0 || cols_for(n) > kWide || k < 2 ||
      k > 5 || M < 0 || m < 0)
    return kErrLayout;
  return 0;
}

// One launch at column width W (the shape checked).
template <int W>
int launch(const Args& a, int cluster, int B, void* stream) {
  static int checked[2][2] = {{0, -1}, {0, -1}};
  const Layout L = make_layout<W>(a.n, a.M, a.k, a.m, cluster, a.R);
  const int smem = 4 * L.words;
  // staged where the layout holds the cut data and every term of the index
  const bool staged = L.xoff < L.words && static_cast<long long>(a.ex) + a.eX <= L.cap;
  const auto kernel = staged ? pdhg_norm_kernel<true, W> : pdhg_norm_kernel<false, W>;
  const int err = prepare_cluster(kernel, cluster, smem, checked[staged ? 1 : 0]);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(cluster, B, smem, static_cast<cudaStream_t>(stream), attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ||K|| of every instance of a batch of B (one cluster of `cluster` CTAs
// each) after `iters` power iterations from the start vector (y (n,), Y (n,
// n)), the same for every instance and only read.  ex and eX are the
// per-instance strides of xcut/xcoef and Xcut/Xcoef.  Writes out[0..B).  The
// column width is n's (pdhg_common.cuh cols_for), as K2's plan takes it.
// Returns 0, a CUDA error, kErrLayout or kErrNoCluster.
extern "C" int pdhg_norm_launch(
    int n, int M, int k, int m, int B, int cluster, int ex, int eX, int iters,
    const int* idx, const float* lin, const float* quad, const float* act,
    const int* xoff, const int* xcut, const float* xcoef,
    const int* Xoff, const int* Xcut, const float* Xcoef,
    const float* G, const float* g, const float* y, const float* Y, float* out,
    void* stream) {
  int err = check_shape(n, M, k, m, cluster);
  if (err == 0 && (B < 1 || ex < 0 || eX < 0 || iters < 0)) err = kErrLayout;
  if (err != 0) return err;
  const Args a{n, M, k, m, (n + cluster - 1) / cluster, (M + cluster - 1) / cluster, ex, eX,
               iters,
               Arrays{idx, lin, quad, act, xoff, xcut, xcoef, Xoff, Xcut, Xcoef, G, g, y, Y, out}};
  return cols_for(n) == kNarrow ? launch<kNarrow>(a, cluster, B, stream)
                                : launch<kWide>(a, cluster, B, stream);
}
