// PDHG iteration block for the McCormick + cuts (+ dense QCQP rows) LP,
// float32.
//
// Replaces the Pallas TPU kernel sdpcutsel_tpu/lp/pdhg_kernel.py::_kernel
// (launched from pdhg_block).  Runs `iters` iterations of the exact
// lp/pdhg.py::_one_iter update and adds every iterate to the ergodic sums
// (ax, aX, aA, aB, ayC, ayD).  Restart, KKT and omega logic stay in torch,
// once per block.  The TPU kernel took no dense rows (a QCQP solve ran the
// jnp loop there); this one takes the m dense rows Gd (m, n, n), gd (m, n),
// hd (m,) of relax/denserows.py, and with m = 0 it does the BoxQP work only.
//
// What bounds it on the H100: latency, not bandwidth or FLOPs.  One
// iteration touches ~10 (n, n) float arrays (~0.6 MB at n = 125) that all
// stay in the 50 MB L2, and the iterations are a serial chain with three
// all-to-all dependences each (row/column sums, the X^T read of the
// symmetrization, the cut gathers of the extrapolated point).  The dense
// rows add 2 m n^2 float reads an iteration (1 MB twice at n = 100,
// m = 25), also from L2.
//
// Design: one persistent block of 1024 threads runs all `iters` iterations,
// with __syncthreads() between the phases; no launch per iteration.  Thread
// (g, c) = (t / 128, t % 128) owns column c of the rows g, g + 8, ...  State
// lives in device memory (L2); the (M,) weights w = yC * active, the partial
// sums and the extrapolated x live in shared memory.  The cut adjoint reads
// an inverse index built once per solve (lp/pdhg_kernel.py build_cut_index):
// every x or X entry sums its own terms in a fixed order, so the kernel is
// deterministic and needs no atomics.  The dense duals yD sit in shared
// memory after w; every dense sum runs over a fixed order (rows i = 0..m-1
// in phases 1a/1b, a fixed lane stride and shuffle tree in phase 4).
//
// Phases of one iteration:
//   1a. gX = -SA yA + SB yB + cut terms + sum_i yD_i G_i;
//       S = X - tau (cX - gX) to scratch; partial row sums of yA, yB (warp
//       shuffles) and column sums of yB.
//   1b. gx from the partial sums plus cut terms plus g' yD; x step, clip,
//       extrapolate.
//   2.  X = clip((S + S^T) / 2); Xb = 2 X - X_old; dual ascent on yA, yB;
//       accumulators.
//   4.  per cut: residual at (xb, Xb), dual ascent on yC, accumulator, w;
//       per dense row (one warp each): <G_i, Xb> + g_i . xb, dual ascent
//       on yD, accumulator.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kCols = 128;                   // n <= 128
constexpr int kGroups = kThreads / kCols;    // row groups
constexpr int kWarpsPerRow = kCols / 32;
constexpr float kSA = 0.70710678118654752440f;   // 1 / sqrt(2)
constexpr float kSB = 0.57735026918962576451f;   // 1 / sqrt(3)

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kThreads, 1) pdhg_block_kernel(
    int n, int M, int k, int m, int iters, float tau, float sigma,
    const float* __restrict__ cx, const float* __restrict__ cX,
    const int* __restrict__ idx, const float* __restrict__ lin,
    const float* __restrict__ quad, const float* __restrict__ rhs,
    const float* __restrict__ act,
    const int* __restrict__ xoff, const int* __restrict__ xcut,
    const float* __restrict__ xcoef,
    const int* __restrict__ Xoff, const int* __restrict__ Xcut,
    const float* __restrict__ Xcoef,
    const float* __restrict__ Gd, const float* __restrict__ gd,
    const float* __restrict__ hd,
    float* x, float* X, float* yA, float* yB, float* yC, float* yD,
    float* ax, float* aX, float* aA, float* aB, float* ayC, float* ayD,
    float* S, float* Xb) {
  extern __shared__ float w[];                 // (M,) yC * active, then (m,) yD
  float* const sD = w + M;
  __shared__ float rowA[kCols][kWarpsPerRow];  // partial row sums of yA
  __shared__ float rowB[kCols][kWarpsPerRow];  // partial row sums of yB
  __shared__ float colB[kGroups][kCols];       // partial column sums of yB
  __shared__ float xb[kCols];                  // extrapolated x

  const int t = threadIdx.x;
  const int c = t % kCols;
  const int g = t / kCols;
  const int lane = t % 32;
  const int wr = c / 32;
  const int nn = n * n;

  for (int q = t; q < M; q += kThreads) w[q] = yC[q] * act[q];
  for (int q = t; q < m; q += kThreads) sD[q] = yD[q];
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    // ---- 1a: adjoint of the (n, n) blocks and the primal pre-step -------
    float cb = 0.0f;
    for (int i = g; i < n; i += kGroups) {     // uniform across each warp
      float a = 0.0f, b = 0.0f;
      if (c < n) {
        const int e = i * n + c;
        a = yA[e];
        b = yB[e];
        float cut = 0.0f;
        for (int q = Xoff[e]; q < Xoff[e + 1]; ++q) cut += w[Xcut[q]] * Xcoef[q];
        float gX = (-kSA * a + kSB * b) + cut;
        if (m > 0) {
          float dn = 0.0f;
          for (int q = 0; q < m; ++q) dn += sD[q] * Gd[q * nn + e];
          gX += dn;
        }
        S[e] = X[e] - tau * (cX[e] - gX);
        cb += b;
      }
      const float ra = warp_sum(a);
      const float rb = warp_sum(b);
      if (lane == 0) {
        rowA[i][wr] = ra;
        rowB[i][wr] = rb;
      }
    }
    colB[g][c] = cb;
    __syncthreads();

    // ---- 1b: gx, x step, extrapolation --------------------------------
    if (t < n) {
      float sa = 0.0f, sb = 0.0f, sc = 0.0f;
#pragma unroll
      for (int q = 0; q < kWarpsPerRow; ++q) {
        sa += rowA[t][q];
        sb += rowB[t][q];
      }
#pragma unroll
      for (int q = 0; q < kGroups; ++q) sc += colB[q][t];
      float cut = 0.0f;
      for (int q = xoff[t]; q < xoff[t + 1]; ++q) cut += w[xcut[q]] * xcoef[q];
      float gx = (kSA * sa - kSB * (sb + sc)) + cut;
      if (m > 0) {
        float dn = 0.0f;
        for (int q = 0; q < m; ++q) dn += sD[q] * gd[q * n + t];
        gx += dn;
      }
      const float xo = x[t];
      const float xn = fminf(fmaxf(xo - tau * (cx[t] - gx), 0.0f), 1.0f);
      x[t] = xn;
      ax[t] += xn;
      xb[t] = 2.0f * xn - xo;
    }
    __syncthreads();

    // ---- 2: X projection, extrapolation, dual ascent on yA, yB --------
    if (c < n) {
      const float xbc = xb[c];
      for (int i = g; i < n; i += kGroups) {
        const int e = i * n + c;
        const float xn = fminf(fmaxf(0.5f * (S[e] + S[c * n + i]), 0.0f), 1.0f);
        const float xbv = 2.0f * xn - X[e];
        X[e] = xn;
        aX[e] += xn;
        Xb[e] = xbv;
        const float kA = kSA * (xb[i] - xbv);
        const float kB = kSB * (xbv - xb[i] - xbc);
        const float ya = fmaxf(yA[e] - sigma * kA, 0.0f);
        const float yb = fmaxf(yB[e] + sigma * (-kSB - kB), 0.0f);
        yA[e] = ya;
        yB[e] = yb;
        aA[e] += ya;
        aB[e] += yb;
      }
    }
    __syncthreads();

    // ---- 4: cut residuals at (xb, Xb) and dual ascent on yC ------------
    for (int p = t; p < M; p += kThreads) {
      const int* id = idx + p * k;
      const float* l = lin + p * k;
      const float* qd = quad + p * k * k;
      float r1 = 0.0f, r2 = 0.0f;
      for (int a = 0; a < k; ++a) {
        r1 += l[a] * xb[id[a]];
        for (int b = 0; b < k; ++b) r2 += qd[a * k + b] * Xb[id[a] * n + id[b]];
      }
      const float am = act[p];
      const float r = (r1 + r2) * am;
      const float yc = fmaxf(yC[p] + sigma * (rhs[p] * am - r), 0.0f) * am;
      yC[p] = yc;
      ayC[p] += yc;
      w[p] = yc * am;
    }
    // dense rows: one warp per row (the loop bound is warp-uniform)
    for (int i = t / 32; i < m; i += kThreads / 32) {
      const float* Gi = Gd + static_cast<size_t>(i) * nn;
      float r2 = 0.0f, r1 = 0.0f;
      for (int e = lane; e < nn; e += 32) r2 += Gi[e] * Xb[e];
      for (int j = lane; j < n; j += 32) r1 += gd[i * n + j] * xb[j];
      const float kD = warp_sum(r2) + warp_sum(r1);
      if (lane == 0) {
        const float yd = fmaxf(sD[i] + sigma * (hd[i] - kD), 0.0f);
        sD[i] = yd;
        yD[i] = yd;
        ayD[i] += yd;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int pdhg_block_launch(
    int n, int M, int k, int m, int iters, float tau, float sigma,
    const float* cx, const float* cX,
    const int* idx, const float* lin, const float* quad, const float* rhs,
    const float* act,
    const int* xoff, const int* xcut, const float* xcoef,
    const int* Xoff, const int* Xcut, const float* Xcoef,
    const float* G, const float* g, const float* h,
    float* x, float* X, float* yA, float* yB, float* yC, float* yD,
    float* ax, float* aX, float* aA, float* aB, float* ayC, float* ayD,
    float* S, float* Xb, void* stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(M + m);
  cudaError_t err = cudaFuncSetAttribute(
      pdhg_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pdhg_block_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      n, M, k, m, iters, tau, sigma, cx, cX, idx, lin, quad, rhs, act,
      xoff, xcut, xcoef, Xoff, Xcut, Xcoef, G, g, h,
      x, X, yA, yB, yC, yD, ax, aX, aA, aB, ayC, ayD, S, Xb);
  return static_cast<int>(cudaGetLastError());
}
