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
// weights sit in static shared memory; the MLP and the Jacobi are the shared
// device code of score_common.cuh (first hidden layer in 64 registers, layer
// 2 folded into layer 3; Jacobi on the 10 unique entries of Z in registers),
// all inside score_triple, which the packed kernel pair_packed.cu shares.
// The MLP is fused into the kernel: the TPU version wrote 15 feature planes
// to device memory and read them back for the matmuls.

#include <cuda_runtime.h>

#include "score_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kF = 15;   // features, k = 3

__global__ void __launch_bounds__(kThreads) pair_score_kernel(
    int T, int n, int sweeps, const int* __restrict__ table,
    const float* __restrict__ x, const float* __restrict__ X,
    const float* __restrict__ Q,
    const float* __restrict__ W1, const float* __restrict__ b1,
    const float* __restrict__ W2, const float* __restrict__ b2,
    const float* __restrict__ W3, const float* __restrict__ b3,
    float* __restrict__ nn_out, float* __restrict__ feas_out) {
  __shared__ scoring::MLPWeights<kF> sw;
  scoring::load_mlp(sw, W1, b1, W2, b2, W3, b3);
  __syncthreads();

  const int tid = blockIdx.x * kThreads + threadIdx.x;
  if (tid >= T) return;
  scoring::score_triple(table[3 * tid], table[3 * tid + 1], table[3 * tid + 2], n, sweeps,
                        x, X, Q, sw, nn_out[tid], feas_out[tid]);
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
