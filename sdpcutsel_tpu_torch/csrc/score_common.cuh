// Device code shared by the candidate scoring kernels (pair_score.cu,
// pair_packed.cu and fused_score.cu, through score_mma.cuh): cyclic Jacobi on
// the packed upper triangle of a small symmetric matrix.
//
// The rotation formulas and the sign(0) = +1 rule of ops/jacobi.py, in its
// cyclic order (0,1), (0,2), ..., (M-2,M-1), on the M(M+1)/2 unique entries in
// registers (every index is a compile-time constant).
//
// Overflow guard: where |tau| >= 2^64, tau^2 rounds to inf, and IEEE
// arithmetic gives t = sgn / (|tau| + sqrtf(inf)) = +-0 through the slow
// paths of the square root and the division, which diverge inside a warp.
// The guard feeds the arithmetic tau = 0 there and then selects
// copysignf(0, sgn): the same +-0, so the same bits, with no lane on a slow
// path.  (tau^2 and the contracted fma(tau, tau, 1) overflow at the same
// tau: near 2^128 the exact square is a multiple of 2^82, far from the
// rounding midpoint.)

#pragma once

#include <cuda_runtime.h>

namespace scoring {

constexpr int kH = 64;   // hidden width of the scoring MLP

// packed upper-triangle position of (i, j) in a symmetric M x M matrix; for
// the k x k block it is also the np.triu_indices order of the features
template <int M>
__host__ __device__ constexpr int U(int i, int j) {
  return i <= j ? i * M - i * (i - 1) / 2 + (j - i) : U<M>(j, i);
}

template <int M>
constexpr int kPacked = M * (M + 1) / 2;

constexpr float kTauOverflow = 0x1p64f;   // the least |tau| whose square is inf

template <int M, int P, int Q>
__device__ __forceinline__ void rotate(float (&a)[kPacked<M>]) {
  const float apq = a[U<M>(P, Q)];
  const float app = a[U<M>(P, P)];
  const float aqq = a[U<M>(Q, Q)];
  const bool small = fabsf(apq) < 1e-30f;
  const float tau = (aqq - app) / (2.0f * (small ? 1.0f : apq));
  const float sgn = tau >= 0.0f ? 1.0f : -1.0f;   // sign(0) = +1
  const bool over = fabsf(tau) >= kTauOverflow;
  const float safe = over ? 0.0f : tau;
  float t = sgn / (fabsf(safe) + sqrtf(1.0f + safe * safe));
  t = small ? 0.0f : (over ? copysignf(0.0f, sgn) : t);
  const float c = 1.0f / sqrtf(1.0f + t * t);
  const float s = t * c;
  a[U<M>(P, P)] = app - t * apq;
  a[U<M>(Q, Q)] = aqq + t * apq;
  a[U<M>(P, Q)] = 0.0f;
#pragma unroll
  for (int r = 0; r < M; ++r) {
    if (r == P || r == Q) continue;
    const float arp = a[U<M>(r, P)];
    const float arq = a[U<M>(r, Q)];
    a[U<M>(r, P)] = c * arp - s * arq;
    a[U<M>(r, Q)] = s * arp + c * arq;
  }
}

// one cyclic sweep: rotations (P, Q), (P, Q + 1), ..., then row P + 1
template <int M, int P = 0, int Q = 1>
__device__ __forceinline__ void sweep(float (&a)[kPacked<M>]) {
  rotate<M, P, Q>(a);
  if constexpr (Q + 1 < M) {
    sweep<M, P, Q + 1>(a);
  } else if constexpr (P + 2 < M) {
    sweep<M, P + 1, P + 2>(a);
  }
}

// lambda_min after `sweeps` sweeps: the smallest diagonal entry
template <int M>
__device__ __forceinline__ float jacobi_min_eig(float (&a)[kPacked<M>], int sweeps) {
  for (int s = 0; s < sweeps; ++s) sweep<M>(a);
  float lam = a[U<M>(0, 0)];
#pragma unroll
  for (int i = 1; i < M; ++i) lam = fminf(lam, a[U<M>(i, i)]);
  return lam;
}

}  // namespace scoring
