// Generic candidate scoring over any (T, k) table, k = 2..5, float32: MLP
// estimate and feasibility violation of every row rho.
//
// Replaces the Pallas TPU kernel sdpcutsel_tpu/ops/fused_score.py::_kernel
// (launched from fused_score).  Per candidate rho (indices may repeat: the
// QCQP clique tables pad short subsets by repeating the last index):
//   feats = [triQ_rho | x_rho | tri(X_rho)],  F = k(k+1) + k,
//   nn    = scale_rho * relu(MLP(feats))     (F -> 64 -> 64 -> 1, relu)
//   feas  = -lambda_min(Z(rho)) after `sweeps` cyclic Jacobi sweeps on the
//           (k+1) x (k+1) Z = [[1, x_rho'], [x_rho, X_rho]].
// triQ (T, k(k+1)/2) and scale (T,) are per-instance constants computed once
// by the caller (models/features.py candidate_q_features).
//
// What bounds it on the H100: the MLP's F*64 + 64*64 + 64 multiply-adds per
// candidate (5,440 at k = 5), whose weights come from shared memory, then
// the Jacobi's 15 rotations a sweep at k = 5.  The gathers of x and X
// (40 KB at n = 100) hit L1/L2; triQ (60 B a row at k = 5) is the largest
// streamed input.  The tables are small (2,876 rows on qcqpband100-5-25-1,
// 51,503 at most in the registry), so one call is a few waves at most and
// launch latency is a large part of its time.
//
// Design: not the TPU's.  The TPU gathered with one-hot MXU matmuls over
// 128-candidate chunks of a table padded to a 1024-row block.  Here one
// thread scores one candidate and gathers directly, 256 threads a block, no
// padding rows and no atomics.  One template instantiation per k keeps the
// k + k(k+1)/2 gathered entries, the features and the C(k+2, 2) <= 21 Jacobi
// entries in registers; the Jacobi and the MLP are score_common.cuh's, as in
// pair_score.cu.  The Jacobi runs first, so only the features stay live
// through the MLP's first layer.

#include <cuda_runtime.h>

#include "score_common.cuh"

namespace {

constexpr int kThreads = 256;

template <int K>
__global__ void __launch_bounds__(kThreads) fused_score_kernel(
    int T, int n, int sweeps, const int* __restrict__ table,
    const float* __restrict__ x, const float* __restrict__ X,
    const float* __restrict__ triQ, const float* __restrict__ scale,
    const float* __restrict__ W1, const float* __restrict__ b1,
    const float* __restrict__ W2, const float* __restrict__ b2,
    const float* __restrict__ W3, const float* __restrict__ b3,
    float* __restrict__ nn_out, float* __restrict__ feas_out) {
  constexpr int kT = K * (K + 1) / 2;   // upper triangle of a k x k block
  constexpr int kF = 2 * kT + K;        // feature width
  constexpr int kM = K + 1;             // Z(rho) is kM x kM
  __shared__ scoring::MLPWeights<kF> sw;
  scoring::load_mlp(sw, W1, b1, W2, b2, W3, b3);
  __syncthreads();

  const int tid = blockIdx.x * kThreads + threadIdx.x;
  if (tid >= T) return;
  int id[K];
#pragma unroll
  for (int a = 0; a < K; ++a) id[a] = table[tid * K + a];

  float f[kF];
#pragma unroll
  for (int q = 0; q < kT; ++q) f[q] = triQ[tid * kT + q];
#pragma unroll
  for (int a = 0; a < K; ++a) {
    f[kT + a] = x[id[a]];
#pragma unroll
    for (int b = a; b < K; ++b) f[kT + K + scoring::U<K>(a, b)] = X[id[a] * n + id[b]];
  }

  // ---- feasibility: cyclic Jacobi on Z(rho) ----------------------------
  float z[scoring::kPacked<kM>];
  z[0] = 1.0f;
#pragma unroll
  for (int a = 0; a < K; ++a) {
    z[scoring::U<kM>(0, a + 1)] = f[kT + a];
#pragma unroll
    for (int b = a; b < K; ++b) {
      z[scoring::U<kM>(a + 1, b + 1)] = f[kT + K + scoring::U<K>(a, b)];
    }
  }
  feas_out[tid] = -scoring::jacobi_min_eig<kM>(z, sweeps);

  nn_out[tid] = scale[tid] * scoring::mlp_relu(f, sw);
}

template <int K>
void launch(int T, int n, int sweeps, const int* table, const float* x,
            const float* X, const float* triQ, const float* scale,
            const float* W1, const float* b1, const float* W2, const float* b2,
            const float* W3, const float* b3, float* nn_out, float* feas_out,
            cudaStream_t stream) {
  fused_score_kernel<K><<<(T + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      T, n, sweeps, table, x, X, triQ, scale, W1, b1, W2, b2, W3, b3, nn_out,
      feas_out);
}

}  // namespace

extern "C" int fused_score_launch(
    int T, int n, int k, int sweeps, const int* table, const float* x,
    const float* X, const float* triQ, const float* scale, const float* W1,
    const float* b1, const float* W2, const float* b2, const float* W3,
    const float* b3, float* nn_out, float* feas_out, void* stream) {
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 2: launch<2>(T, n, sweeps, table, x, X, triQ, scale, W1, b1, W2, b2, W3, b3, nn_out, feas_out, s); break;
    case 3: launch<3>(T, n, sweeps, table, x, X, triQ, scale, W1, b1, W2, b2, W3, b3, nn_out, feas_out, s); break;
    case 4: launch<4>(T, n, sweeps, table, x, X, triQ, scale, W1, b1, W2, b2, W3, b3, nn_out, feas_out, s); break;
    case 5: launch<5>(T, n, sweeps, table, x, X, triQ, scale, W1, b1, W2, b2, W3, b3, nn_out, feas_out, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
