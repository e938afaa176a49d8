// PDHG iteration block for the BoxQP McCormick + cuts LP, float32.
//
// Replaces the Pallas TPU kernel sdpcutsel_tpu/lp/pdhg_kernel.py::_kernel
// (launched from pdhg_block).  Runs `iters` iterations of the exact
// lp/pdhg.py::_one_iter update and adds every iterate to the ergodic sums
// (ax, aX, aA, aB, ayC).  Restart, KKT and omega logic stay in torch, once
// per block.
//
// What bounds it on the H100: latency, not bandwidth or FLOPs.  One
// iteration touches ~10 (n, n) float arrays (~0.6 MB at n = 125) that all
// stay in the 50 MB L2, and the iterations are a serial chain with three
// all-to-all dependences each (row/column sums, the X^T read of the
// symmetrization, the cut gathers of the extrapolated point).
//
// Design: one persistent block of 1024 threads runs all `iters` iterations,
// with __syncthreads() between the phases; no launch per iteration.  Thread
// (g, c) = (t / 128, t % 128) owns column c of the rows g, g + 8, ...  State
// lives in device memory (L2); the (M,) weights w = yC * active, the partial
// sums and the extrapolated x live in shared memory.  The cut adjoint reads
// an inverse index built once per solve (lp/pdhg_kernel.py build_cut_index):
// every x or X entry sums its own terms in a fixed order, so the kernel is
// deterministic and needs no atomics.
//
// Phases of one iteration:
//   1a. gX = -SA yA + SB yB + cut terms; S = X - tau (cX - gX) to scratch;
//       partial row sums of yA, yB (warp shuffles) and column sums of yB.
//   1b. gx from the partial sums plus cut terms; x step, clip, extrapolate.
//   2.  X = clip((S + S^T) / 2); Xb = 2 X - X_old; dual ascent on yA, yB;
//       accumulators.
//   4.  per cut: residual at (xb, Xb), dual ascent on yC, accumulator, w.

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
    int n, int M, int k, int iters, float tau, float sigma,
    const float* __restrict__ cx, const float* __restrict__ cX,
    const int* __restrict__ idx, const float* __restrict__ lin,
    const float* __restrict__ quad, const float* __restrict__ rhs,
    const float* __restrict__ act,
    const int* __restrict__ xoff, const int* __restrict__ xcut,
    const float* __restrict__ xcoef,
    const int* __restrict__ Xoff, const int* __restrict__ Xcut,
    const float* __restrict__ Xcoef,
    float* x, float* X, float* yA, float* yB, float* yC,
    float* ax, float* aX, float* aA, float* aB, float* ayC,
    float* S, float* Xb) {
  extern __shared__ float w[];                 // (M,) yC * active
  __shared__ float rowA[kCols][kWarpsPerRow];  // partial row sums of yA
  __shared__ float rowB[kCols][kWarpsPerRow];  // partial row sums of yB
  __shared__ float colB[kGroups][kCols];       // partial column sums of yB
  __shared__ float xb[kCols];                  // extrapolated x

  const int t = threadIdx.x;
  const int c = t % kCols;
  const int g = t / kCols;
  const int lane = t % 32;
  const int wr = c / 32;

  for (int m = t; m < M; m += kThreads) w[m] = yC[m] * act[m];
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
        const float gX = (-kSA * a + kSB * b) + cut;
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
      const float gx = (kSA * sa - kSB * (sb + sc)) + cut;
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
    for (int m = t; m < M; m += kThreads) {
      const int* id = idx + m * k;
      const float* l = lin + m * k;
      const float* qd = quad + m * k * k;
      float r1 = 0.0f, r2 = 0.0f;
      for (int a = 0; a < k; ++a) {
        r1 += l[a] * xb[id[a]];
        for (int b = 0; b < k; ++b) r2 += qd[a * k + b] * Xb[id[a] * n + id[b]];
      }
      const float am = act[m];
      const float r = (r1 + r2) * am;
      const float yc = fmaxf(yC[m] + sigma * (rhs[m] * am - r), 0.0f) * am;
      yC[m] = yc;
      ayC[m] += yc;
      w[m] = yc * am;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int pdhg_block_launch(
    int n, int M, int k, int iters, float tau, float sigma,
    const float* cx, const float* cX,
    const int* idx, const float* lin, const float* quad, const float* rhs,
    const float* act,
    const int* xoff, const int* xcut, const float* xcoef,
    const int* Xoff, const int* Xcut, const float* Xcoef,
    float* x, float* X, float* yA, float* yB, float* yC,
    float* ax, float* aX, float* aA, float* aB, float* ayC,
    float* S, float* Xb, void* stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(M);
  cudaError_t err = cudaFuncSetAttribute(
      pdhg_block_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  pdhg_block_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      n, M, k, iters, tau, sigma, cx, cX, idx, lin, quad, rhs, act,
      xoff, xcut, xcoef, Xoff, Xcut, Xcoef,
      x, X, yA, yB, yC, ax, aX, aA, aB, ayC, S, Xb);
  return static_cast<int>(cudaGetLastError());
}
