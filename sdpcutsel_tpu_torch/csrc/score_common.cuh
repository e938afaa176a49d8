// Device code shared by the candidate scoring kernels: cyclic Jacobi on the
// packed upper triangle of a small symmetric matrix (fused_score.cu, and the
// k = 3 kernels pair_score.cu and pair_packed.cu through score_mma.cuh), and
// the F -> 64 -> 64 -> 1 relu MLP with its weights in shared memory, one
// thread a candidate on the CUDA cores (fused_score.cu).
//
// Jacobi: the rotation formulas and the sign(0) = +1 rule of ops/jacobi.py,
// in its cyclic order (0,1), (0,2), ..., (M-2,M-1), on the M(M+1)/2 unique
// entries in registers (every index is a compile-time constant).
//
// MLP: weights in PyTorch's Linear layout ([out][in]).  The first hidden
// layer stays in 64 registers; layer 2 folds into layer 3 one neuron at a
// time (contiguous W2 rows read as float4 broadcasts), so no second 64-wide
// array is live.

#pragma once

#include <cuda_runtime.h>

namespace scoring {

constexpr int kH = 64;   // hidden width

// packed upper-triangle position of (i, j) in a symmetric M x M matrix; for
// the k x k block it is also the np.triu_indices order of the features
template <int M>
__host__ __device__ constexpr int U(int i, int j) {
  return i <= j ? i * M - i * (i - 1) / 2 + (j - i) : U<M>(j, i);
}

template <int M>
constexpr int kPacked = M * (M + 1) / 2;

template <int M, int P, int Q>
__device__ __forceinline__ void rotate(float (&a)[kPacked<M>]) {
  const float apq = a[U<M>(P, Q)];
  const float app = a[U<M>(P, P)];
  const float aqq = a[U<M>(Q, Q)];
  const bool small = fabsf(apq) < 1e-30f;
  const float tau = (aqq - app) / (2.0f * (small ? 1.0f : apq));
  const float sgn = tau >= 0.0f ? 1.0f : -1.0f;   // sign(0) = +1
  float t = sgn / (fabsf(tau) + sqrtf(1.0f + tau * tau));
  t = small ? 0.0f : t;
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

template <int F>
struct MLPWeights {
  float W1[kH * F];
  float b1[kH];
  __align__(16) float W2[kH * kH];
  float b2[kH];
  float W3[kH];
  float b3;
};

// every thread of the block calls it; a __syncthreads() must follow
template <int F>
__device__ __forceinline__ void load_mlp(
    MLPWeights<F>& w, const float* __restrict__ W1, const float* __restrict__ b1,
    const float* __restrict__ W2, const float* __restrict__ b2,
    const float* __restrict__ W3, const float* __restrict__ b3) {
  for (int q = threadIdx.x; q < kH * F; q += blockDim.x) w.W1[q] = W1[q];
  for (int q = threadIdx.x; q < kH * kH; q += blockDim.x) w.W2[q] = W2[q];
  if (threadIdx.x < kH) {
    w.b1[threadIdx.x] = b1[threadIdx.x];
    w.b2[threadIdx.x] = b2[threadIdx.x];
    w.W3[threadIdx.x] = W3[threadIdx.x];
  }
  if (threadIdx.x == 0) w.b3 = b3[0];
}

// relu(MLP(f)), the network's output before the per-candidate scale
template <int F>
__device__ __forceinline__ float mlp_relu(const float (&f)[F], const MLPWeights<F>& w) {
  float h[kH];
#pragma unroll
  for (int o = 0; o < kH; ++o) {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < F; ++q) s += f[q] * w.W1[o * F + q];
    h[o] = fmaxf(s + w.b1[o], 0.0f);
  }
  float out = 0.0f;
#pragma unroll 2
  for (int o = 0; o < kH; ++o) {
    const float4* row = reinterpret_cast<const float4*>(w.W2 + o * kH);
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < kH / 4; ++q) {
      const float4 v = row[q];
      s += h[4 * q] * v.x;
      s += h[4 * q + 1] * v.y;
      s += h[4 * q + 2] * v.z;
      s += h[4 * q + 3] * v.w;
    }
    out += w.W3[o] * fmaxf(s + w.b2[o], 0.0f);
  }
  return fmaxf(out + w.b3, 0.0f);
}

}  // namespace scoring
