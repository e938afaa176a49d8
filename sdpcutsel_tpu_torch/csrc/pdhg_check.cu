// The checked block's control, K5: what the reference's while_loop body does
// after each block of PDHG iterations (sdpcutsel_tpu/lp/pdhg.py
// checked_block), float32, on the card, so that a solve needs no host read
// between blocks.  One launch after each K2 block (pdhg_block.cu), for every
// instance of a batch whose control record has not stopped:
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
// into the state, sums, anchor and the control record (pdhg_common.cuh) in
// place.  lp/pdhg.py pdhg_check_plain is its plain twin.  The reference
// computes this in XLA inside its while_loop; no Pallas kernel.
//
// Layout: K2's.  One cluster of C CTAs per instance; CTA r owns the rows
// [r R, (r + 1) R) and the pool slots [r Mc, (r + 1) Mc), and reads the
// state from global memory (the check runs once a block: nothing stays in
// shared memory).  Each CTA keeps replicas of the cut weights w = yC act
// (M), of x (n) and of yD (m), for the current iterate and the average.
// Cross-band data moves through distributed shared memory, pushed by its
// producer before a cluster barrier:
//   1  each band entry's M = cX - K^T y (X part) goes to the owner of its
//      column as a transposed tile (for S = M + M^T), the column partials
//      of yB to the owners of the columns, each rank's partial <G_i, X> +
//      g_i . x of the dense rows to every CTA;                 cluster barrier
//   2  each CTA's partial sums (objective, dual bound terms, infeasibility)
//      to every CTA;                                           cluster barrier
//   3  every CTA sums them in rank order, so all decide alike; on a restart
//      each CTA writes its band of the candidate and pushes its partial
//      distances;                                              cluster barrier
//   then rank 0 computes omega and writes the record.
// No atomics; every sum runs in one fixed order, so a launch repeats bit for
// bit.  The sums run in another order than torch's, so the twin agrees to
// rounding (chip_smoke.py holds them at rtol 1e-5).

#include "pdhg_common.cuh"

namespace {

using namespace pdhg;

constexpr int kNV = 8;     // partial sums per evaluation point
enum { kPX, kPx, kHyB, kHyC, kRxm, kSm, kV2, kVC2 };

struct Point {                // x, X, yA, yB, yC, yD of a batch
  float *x, *X, *yA, *yB, *yC, *yD;
};

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
  Point st, acc, anchor;
  int* rec;
};

struct Args {
  int n, M, k, m, R, Mc, ex, eX;
  int check_every, restart_period, max_iters;
  float tol;
  Arrays in;
};

__device__ __forceinline__ Point instance_point(const Point& p, size_t b, int n, int M, int m) {
  const size_t N = n, NN = N * N;
  return Point{p.x + b * N, p.X + b * NN, p.yA + b * NN, p.yB + b * NN, p.yC + b * M,
               p.yD + b * m};
}

// Offsets, in 4-byte words, of one CTA's dynamic shared memory.
struct Layout {
  int w, xs, yd;           // [2] replicas: (M,), (kCols,), (m,)
  int Mt, MT;              // [2] (R, n): the band's M and the transposed tiles
  int rowA, rowB;          // [2] (R, kWarpsPerRow) row partials of yA, yB
  int colP;                // [2] (C kGroups, R) column partials of yB
  int kDp;                 // [2] (C, m) dense partials
  int red;                 // (C, 2 kNV) partial sums of every rank
  int dist;                // (C, kND) partial distances of every rank
  int scratch;             // (kThreads / 32, 2 kNV) block sums
  int tot;                 // (2 kNV + kND + 8) this CTA's sums, then the decision
  int words;
};

__host__ __device__ inline Layout make_layout(int n, int M, int m, int C, int R) {
  Layout L;
  int o = 0;
  const int RN = R * n;
#define TAKE(field, words) L.field = o; o += (words)
  TAKE(w, 2 * M); TAKE(xs, 2 * kCols); TAKE(yd, 2 * m);
  TAKE(Mt, 2 * RN); TAKE(MT, 2 * RN);
  TAKE(rowA, 2 * R * kWarpsPerRow); TAKE(rowB, 2 * R * kWarpsPerRow);
  TAKE(colP, 2 * C * kGroups * R);
  TAKE(kDp, 2 * C * m);
  TAKE(red, C * 2 * kNV);
  TAKE(dist, C * kND);
  TAKE(scratch, (kThreads / 32) * 2 * kNV);
  TAKE(tot, 2 * kNV + kND + 8);
#undef TAKE
  L.words = o;
  return L;
}

__global__ void __launch_bounds__(kThreads, 1) pdhg_check_kernel(const __grid_constant__ Args a) {
  extern __shared__ __align__(16) float sm[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = a.n, M = a.M, k = a.k, m = a.m, R = a.R, RN = R * n;
  const size_t nn = static_cast<size_t>(n) * n;
  const size_t inst = static_cast<size_t>(blockIdx.x) / C;
  int* const rec = a.in.rec + inst * kRecWords;
  if (rec[kRecStop]) return;          // stopped: every CTA leaves before any barrier
  const int wlen = rec[kRecWlen] + a.check_every;
  const float inv = 1.0f / static_cast<float>(wlen);

  const Layout L = make_layout(n, M, m, C, R);
  const Point st = instance_point(a.in.st, inst, n, M, m);
  const Point acc = instance_point(a.in.acc, inst, n, M, m);
  const Point anc = instance_point(a.in.anchor, inst, n, M, m);
  const float* cx = a.in.cx + inst * n;
  const float* cX = a.in.cX + inst * nn;
  const int* idx = a.in.idx + inst * M * k;
  const float* lin = a.in.lin + inst * M * k;
  const float* quad = a.in.quad + inst * M * k * k;
  const float* rhs = a.in.rhs + inst * M;
  const float* act = a.in.act + inst * M;
  const int* xoff = a.in.xoff + inst * (n + 1);
  const int* xcut = a.in.xcut + inst * a.ex;
  const float* xcoef = a.in.xcoef + inst * a.ex;
  const int* Xoff = a.in.Xoff + inst * (nn + 1);
  const int* Xcut = a.in.Xcut + inst * a.eX;
  const float* Xcoef = a.in.Xcoef + inst * a.eX;
  const float* G = a.in.G + inst * m * nn;
  const float* g = a.in.g + inst * m * n;
  const float* h = a.in.h + inst * m;

  const int t = threadIdx.x;
  const int c = t % kCols;
  const int grp = t / kCols;
  const int lane = t % 32;
  const int wr = c / 32;
  const int r0 = rank * R;
  const int rows = max(0, min(R, n - r0));
  const int p0 = rank * a.Mc;
  const int slots = max(0, min(a.Mc, M - p0));

  // the two evaluation points: P = 0 the current iterate, P = 1 the average
  const Point pt[2] = {st, acc};
  const float scale[2] = {1.0f, inv};

  // ---- replicas of w, x and yD at both points ----------------------------
#pragma unroll
  for (int P = 0; P < 2; ++P) {
    for (int q = t; q < M; q += kThreads) sm[L.w + P * M + q] = (pt[P].yC[q] * scale[P]) * act[q];
    for (int j = t; j < n; j += kThreads) sm[L.xs + P * kCols + j] = pt[P].x[j] * scale[P];
    for (int q = t; q < m; q += kThreads) sm[L.yd + P * m + q] = pt[P].yD[q] * scale[P];
  }
  cluster.sync();   // every CTA has started before any remote store

  // ---- 1: M = cX - gX and its transpose, row and column sums, infeasibility
  float part[2 * kNV];
#pragma unroll
  for (int j = 0; j < 2 * kNV; ++j) part[j] = 0.0f;
#pragma unroll
  for (int P = 0; P < 2; ++P) {
    const float sc = scale[P];
    const float* w = sm + L.w + P * M;
    const float* xs = sm + L.xs + P * kCols;
    const float* yd = sm + L.yd + P * m;
    float* v = part + P * kNV;
    float cb = 0.0f;
    for (int il = grp; il < rows; il += kGroups) {   // uniform across each warp
      float va = 0.0f, vb = 0.0f;
      if (c < n) {
        const int i = r0 + il;
        const size_t ge = static_cast<size_t>(i) * n + c;
        const float Xv = pt[P].X[ge] * sc;
        va = pt[P].yA[ge] * sc;
        vb = pt[P].yB[ge] * sc;
        const float cut = segment_sum(Xcut, Xcoef, Xoff[ge], Xoff[ge + 1], w);
        float gX = (-kSA * va + kSB * vb) + cut;
        if (m > 0) {
          float dn = 0.0f;
          for (int q = 0; q < m; ++q) dn += yd[q] * G[q * nn + ge];
          gX += dn;
        }
        const float cXv = cX[ge];
        const float Mv = cXv - gX;
        sm[L.Mt + P * RN + il * n + c] = Mv;
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
    // the owned slots: rhs . yC, and the cut rows' infeasibility
    for (int s = t; s < slots; s += kThreads) {
      const int q = p0 + s;
      const float am = act[q];
      v[kHyC] += rhs[q] * am * (pt[P].yC[q] * sc);
      if (am != 0.0f) {
        const float res = cut_residual_k(
            k, idx + q * k, lin + q * k, quad + q * k * k, [&](int iu) { return xs[iu]; },
            [&](int iu, int iv) { return pt[P].X[static_cast<size_t>(iu) * n + iv] * sc; });
        const float kC = res * am;
        const float vC = fmaxf(rhs[q] * am - kC, 0.0f) * am;
        v[kVC2] += vC * vC;
      }
    }
    // each dense row's partial <G_i, X> + g_i . x over the band, one warp a row
    for (int q = t / 32; q < m; q += kThreads / 32) {
      float r2 = 0.0f, r1 = 0.0f;
      for (int e = lane; e < rows * n; e += 32) {
        const size_t ge = static_cast<size_t>(r0) * n + e;
        r2 += G[q * nn + ge] * (pt[P].X[ge] * sc);
      }
      for (int j = lane; j < rows; j += 32) r1 += g[q * n + r0 + j] * xs[r0 + j];
      const float sum = warp_sum(r2) + warp_sum(r1);
      if (lane < C) cluster.map_shared_rank(sm + L.kDp + P * C * m, lane)[rank * m + q] = sum;
    }
  }
  cluster.sync();

  // ---- 2: gx, the dual bound's terms; this CTA's sums to every CTA -------
#pragma unroll
  for (int P = 0; P < 2; ++P) {
    const float* w = sm + L.w + P * M;
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
      const float cut = segment_sum(xcut, xcoef, xoff[i], xoff[i + 1], w);
      float gx = (kSA * sa - kSB * (sb + sc)) + cut;
      if (m > 0) {
        float dn = 0.0f;
        for (int q = 0; q < m; ++q) dn += yd[q] * g[q * n + i];
        gx += dn;
      }
      v[kRxm] += fminf(cx[i] - gx, 0.0f);
      v[kPx] += cx[i] * xs[i];
    }
    if (c < n) {
      for (int il = grp; il < rows; il += kGroups) {
        const int e = il * n + c;
        v[kSm] += fminf(sm[L.Mt + P * RN + e] + sm[L.MT + P * RN + e], 0.0f);
      }
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
      const float* yd = sm + L.yd + P * m;
      float hyD = 0.0f, vD2 = 0.0f;
      for (int q = 0; q < m; ++q) {
        float kD = 0.0f;
        for (int r = 0; r < C; ++r) kD += sm[L.kDp + P * C * m + r * m + q];
        const float vD = fmaxf(h[q] - kD, 0.0f);
        vD2 += vD * vD;
        hyD += h[q] * yd[q];
      }
      const float p = s[kPx] + s[kPX];
      const float hy = (-kSB * s[kHyB] + s[kHyC]) + hyD;
      const float d = (hy + s[kRxm]) + 0.5f * s[kSm];
      const float infeas = sqrtf((s[kV2] + s[kVC2]) + vD2);
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
    for (int s = t; s < slots; s += kThreads) {
      const int q = p0 + s;
      const float y = cand.yC[q] * csc, e = y - anc.yC[q];
      dv[kDC] += e * e;
      st.yC[q] = y;
      anc.yC[q] = y;
      acc.yC[q] = 0.0f;
    }
    if (rank == 0) {
      for (int q = t; q < m; q += kThreads) {
        const float y = cand.yD[q] * csc, e = y - anc.yD[q];
        dv[kDD] += e * e;
        st.yD[q] = y;
        anc.yD[q] = y;
        acc.yD[q] = 0.0f;
      }
    }
    block_sums(dv, sm + L.scratch, sm + L.tot + 2 * kNV);
    for (int j = t; j < C * kND; j += kThreads) {
      const int r = j / kND, q = j % kND;
      cluster.map_shared_rank(sm + L.dist, r)[rank * kND + q] = sm[L.tot + 2 * kNV + q];
    }
  }
  cluster.sync();

  // ---- the record, by rank 0 ----------------------------------------------
  if (rank == 0 && t == 0)
    write_record(rec, dec, use_avg, restart, wlen, sm + L.dist, C, a.check_every,
                 a.max_iters, a.tol);
}

int check_shape(int n, int M, int k, int m, int cluster) {
  if (cluster < 1 || cluster > kMaxCluster || n < 1 || n > kCols || k < 2 || k > 5 ||
      M < 0 || m < 0)
    return kErrLayout;
  return 0;
}

int smem_bytes(int n, int M, int m, int cluster) {
  return 4 * make_layout(n, M, m, cluster, (n + cluster - 1) / cluster).words;
}

}  // namespace

// The check after a block, for every instance of a batch of B stacked along
// the leading axis of every array (one cluster of `cluster` CTAs each), in
// place on the state, sums, anchor and control records; an instance whose
// record has stopped is left as it is.  ex and eX are the per-instance
// strides of xcut/xcoef and Xcut/Xcoef.  Returns 0, a CUDA error,
// kErrLayout or kErrNoCluster.
extern "C" int pdhg_check_launch(
    int n, int M, int k, int m, int B, int cluster, int ex, int eX, int check_every,
    int restart_period, int max_iters, float tol,
    const float* cx, const float* cX,
    const int* idx, const float* lin, const float* quad, const float* rhs, const float* act,
    const int* xoff, const int* xcut, const float* xcoef,
    const int* Xoff, const int* Xcut, const float* Xcoef,
    const float* G, const float* g, const float* h,
    float* x, float* X, float* yA, float* yB, float* yC, float* yD,
    float* ax, float* aX, float* aA, float* aB, float* ayC, float* ayD,
    float* zx, float* zX, float* zA, float* zB, float* zC, float* zD,
    int* rec, void* stream) {
  static int checked[2] = {0, -1};
  int err = check_shape(n, M, k, m, cluster);
  const int smem = smem_bytes(n, M, m, cluster);
  if (err == 0) err = prepare_cluster(pdhg_check_kernel, cluster, smem, checked);
  if (err != 0) return err;
  if (B < 1 || ex < 0 || eX < 0 || check_every < 1) return kErrLayout;
  Args a{n, M, k, m, (n + cluster - 1) / cluster, (M + cluster - 1) / cluster, ex, eX,
         check_every, restart_period, max_iters, tol,
         Arrays{cx, cX, idx, lin, quad, rhs, act, xoff, xcut, xcoef, Xoff, Xcut, Xcoef,
                G, g, h, Point{x, X, yA, yB, yC, yD}, Point{ax, aX, aA, aB, ayC, ayD},
                Point{zx, zX, zA, zB, zC, zD}, rec}};
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config(cluster, B, smem, static_cast<cudaStream_t>(stream), attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, pdhg_check_kernel, a);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

