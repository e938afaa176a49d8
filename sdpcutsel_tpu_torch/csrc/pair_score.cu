// Dense k = 3 candidate scoring: MLP estimate and feasibility violation of
// every triple of the lexicographic C(n, 3) table, float32.
//
// Replaces the Pallas TPU kernel sdpcutsel_tpu/ops/pair_score.py::_pair_kernel
// (launched from pair_score_fused) together with the XLA MLP that ran on its
// feature planes (pair_score.py::_mlp).  Per candidate rho = (i, j, l):
//   feats = [tri(Q_rho) / scale | x_rho | tri(X_rho)],  scale = max |Q_rho|,
//   nn    = scale * relu(MLP(feats))     (15 -> 64 -> 64 -> 1, relu)
//   feas  = -lambda_min(Z(rho)) after `sweeps` cyclic Jacobi sweeps on the
//           4 x 4 Z = [[1, x_rho'], [x_rho, X_rho]] (ops/jacobi.py rules,
//           sign(0) = +1).
//
// What bounds it on the H100: the MLP's ~5.1k multiply-adds per candidate,
// whose weights come from shared memory (one shared load per one to four
// FMAs); the 24 gathered inputs per candidate hit L2 (x, X, Q ~125 KB at
// n = 125) and the 12-byte table row is the only streamed input.
//
// Design: one thread per candidate, 256 threads a block.  The 5,249 MLP
// weights sit in static shared memory in PyTorch's Linear layout
// ([out][in]), so layer 2 reads contiguous rows as float4 broadcasts.  The
// first hidden layer stays in 64 registers; layer 2 folds into layer 3 one
// neuron at a time, so no second 64-wide array is live.  The Jacobi runs on
// the 10 unique entries of Z in registers.  The MLP is fused into the
// kernel: the TPU version wrote 15 feature planes to device memory and read
// them back for the matmuls.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kF = 15;   // features, k = 3
constexpr int kH = 64;   // hidden width

// packed upper-triangle position of (i, j) in a symmetric 4 x 4 matrix
__host__ __device__ constexpr int U(int i, int j) {
  return i <= j ? i * 4 - i * (i - 1) / 2 + (j - i) : U(j, i);
}

template <int P, int Q>
__device__ __forceinline__ void rotate(float (&a)[10]) {
  const float apq = a[U(P, Q)];
  const float app = a[U(P, P)];
  const float aqq = a[U(Q, Q)];
  const bool small = fabsf(apq) < 1e-30f;
  const float tau = (aqq - app) / (2.0f * (small ? 1.0f : apq));
  const float sgn = tau >= 0.0f ? 1.0f : -1.0f;   // sign(0) = +1
  float t = sgn / (fabsf(tau) + sqrtf(1.0f + tau * tau));
  t = small ? 0.0f : t;
  const float c = 1.0f / sqrtf(1.0f + t * t);
  const float s = t * c;
  a[U(P, P)] = app - t * apq;
  a[U(Q, Q)] = aqq + t * apq;
  a[U(P, Q)] = 0.0f;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    if (r == P || r == Q) continue;
    const float arp = a[U(r, P)];
    const float arq = a[U(r, Q)];
    a[U(r, P)] = c * arp - s * arq;
    a[U(r, Q)] = s * arp + c * arq;
  }
}

__global__ void __launch_bounds__(kThreads) pair_score_kernel(
    int T, int n, int sweeps, const int* __restrict__ table,
    const float* __restrict__ x, const float* __restrict__ X,
    const float* __restrict__ Q,
    const float* __restrict__ W1, const float* __restrict__ b1,
    const float* __restrict__ W2, const float* __restrict__ b2,
    const float* __restrict__ W3, const float* __restrict__ b3,
    float* __restrict__ nn_out, float* __restrict__ feas_out) {
  __shared__ float sW1[kH * kF];
  __shared__ float sb1[kH];
  __shared__ __align__(16) float sW2[kH * kH];
  __shared__ float sb2[kH];
  __shared__ float sW3[kH];
  __shared__ float sb3;
  for (int q = threadIdx.x; q < kH * kF; q += kThreads) sW1[q] = W1[q];
  for (int q = threadIdx.x; q < kH * kH; q += kThreads) sW2[q] = W2[q];
  if (threadIdx.x < kH) {
    sb1[threadIdx.x] = b1[threadIdx.x];
    sb2[threadIdx.x] = b2[threadIdx.x];
    sW3[threadIdx.x] = W3[threadIdx.x];
  }
  if (threadIdx.x == 0) sb3 = b3[0];
  __syncthreads();

  const int tid = blockIdx.x * kThreads + threadIdx.x;
  if (tid >= T) return;
  const int i = table[3 * tid];
  const int j = table[3 * tid + 1];
  const int l = table[3 * tid + 2];

  const float qii = Q[i * n + i], qij = Q[i * n + j], qil = Q[i * n + l];
  const float qjj = Q[j * n + j], qjl = Q[j * n + l], qll = Q[l * n + l];
  const float xi = x[i], xj = x[j], xl = x[l];
  const float Xii = X[i * n + i], Xij = X[i * n + j], Xil = X[i * n + l];
  const float Xjj = X[j * n + j], Xjl = X[j * n + l], Xll = X[l * n + l];

  const float scale = fmaxf(fmaxf(fmaxf(fabsf(qii), fabsf(qij)), fmaxf(fabsf(qil), fabsf(qjj))),
                            fmaxf(fabsf(qjl), fabsf(qll)));
  const float safe = fmaxf(scale, 1e-12f);
  const float f[kF] = {qii / safe, qij / safe, qil / safe, qjj / safe, qjl / safe,
                       qll / safe, xi, xj, xl, Xii, Xij, Xil, Xjj, Xjl, Xll};

  // ---- MLP: layer 1 in registers, layer 2 folded into layer 3 ----------
  float h[kH];
#pragma unroll
  for (int o = 0; o < kH; ++o) {
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < kF; ++q) s += f[q] * sW1[o * kF + q];
    h[o] = fmaxf(s + sb1[o], 0.0f);
  }
  float out = 0.0f;
#pragma unroll 2
  for (int o = 0; o < kH; ++o) {
    const float4* row = reinterpret_cast<const float4*>(sW2 + o * kH);
    float s = 0.0f;
#pragma unroll
    for (int q = 0; q < kH / 4; ++q) {
      const float4 v = row[q];
      s += h[4 * q] * v.x;
      s += h[4 * q + 1] * v.y;
      s += h[4 * q + 2] * v.z;
      s += h[4 * q + 3] * v.w;
    }
    out += sW3[o] * fmaxf(s + sb2[o], 0.0f);
  }
  nn_out[tid] = scale * fmaxf(out + sb3, 0.0f);

  // ---- feasibility: cyclic Jacobi on Z(rho) ----------------------------
  float a[10] = {1.0f, xi, xj, xl, Xii, Xij, Xil, Xjj, Xjl, Xll};
  for (int s = 0; s < sweeps; ++s) {
    rotate<0, 1>(a);
    rotate<0, 2>(a);
    rotate<0, 3>(a);
    rotate<1, 2>(a);
    rotate<1, 3>(a);
    rotate<2, 3>(a);
  }
  const float lam = fminf(fminf(a[U(0, 0)], a[U(1, 1)]), fminf(a[U(2, 2)], a[U(3, 3)]));
  feas_out[tid] = -lam;
}

}  // namespace

extern "C" int pair_score_launch(
    int T, int n, int sweeps, const int* table, const float* x,
    const float* X, const float* Q, const float* W1, const float* b1,
    const float* W2, const float* b2, const float* W3, const float* b3,
    float* nn_out, float* feas_out, void* stream) {
  const int blocks = (T + kThreads - 1) / kThreads;
  if (blocks > 0) {
    pair_score_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        T, n, sweeps, table, x, X, Q, W1, b1, W2, b2, W3, b3, nn_out, feas_out);
  }
  return static_cast<int>(cudaGetLastError());
}
