// Dense k = 3 candidate scoring: MLP estimate and feasibility violation of
// every triple of a (T, 3) table (the lexicographic C(n, 3) table on the
// main path), float32.
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
// What bounds it on the H100: the operations, and among them the Jacobi.
// Of a candidate's ~11.4k, 10,112 are the MLP's products 15 -> 64 and
// 64 -> 64, which one thread a candidate ran on the CUDA cores at one
// shared-memory weight load per one to four FMAs, while the tensor cores
// idled.  With the products on the tensor cores, what is left is the
// Jacobi's 30 rotations (5 sweeps), three IEEE divisions and two square
// roots each, a dependent chain a triple; feas is held to its bits, so the
// Jacobi keeps these semantics (score_common.cuh guards the rotations whose
// tau^2 overflows, with the same bits).  The 24 gathered inputs hit L2 (x,
// X, Q ~125 KB at n = 125); the 12-byte table row is the only streamed
// input.
//
// Design: the warp-specialised persistent CTA of score_mma.cuh at K = 3, one
// a SM (768 threads, 154 KB of dynamic shared memory): 20 producer warps at
// 48 registers gather, build the features into shared stages and run the
// Jacobi; 4 consumer warps at 232 registers split the weights once a CTA and
// run layers 1 and 2 of the MLP as m16n8k8 TF32 mma in split TF32 (hi*hi +
// hi*lo + lo*hi, which keeps the fp32 twin's tolerance where one TF32 pass
// does not) and layer 3 in fp32.  The table's rows are cut into tiles of
// 32, dealt over the CTAs; the last tile is masked.  The MLP is fused: the
// TPU version wrote 15 feature planes to device memory and read them back
// for the matmuls.

#include <cuda_runtime.h>

#include "score_mma.cuh"

namespace {

using namespace scoring::mma;
using S = Shape<3>;

// candidate c is row c of the table
struct TableRows {
  const int* __restrict__ table;
  const float* __restrict__ Q;
  int n;
  __device__ bool operator()(int c, int (&id)[3], float* f, float& scale, int& pos) const {
    id[0] = table[3 * c];
    id[1] = table[3 * c + 1];
    id[2] = table[3 * c + 2];
    q_features<3>(Q, n, id, f, scale);
    pos = c;
    return true;
  }
};

__global__ void __launch_bounds__(S::kThreads, 1) pair_score_kernel(
    int T, int n, int sweeps, const int* __restrict__ table,
    const float* __restrict__ x, const float* __restrict__ X,
    const float* __restrict__ Q, MLPArgs mlp,
    float* __restrict__ nn_out, float* __restrict__ feas_out) {
  extern __shared__ float4 smem[];
  score_rounds<3>(TableRows{table, Q, n}, T, n, sweeps, x, X, mlp,
                  *reinterpret_cast<Shared<3>*>(smem), nn_out, feas_out);
}

const Grid& grid() {
  static const Grid g = persistent_grid<3>(pair_score_kernel);
  return g;
}

}  // namespace

// the persistent grid: out[0] CTAs of out[1] threads, out[2] bytes of dynamic
// shared memory a CTA
extern "C" int pair_score_grid(int* out) {
  out[0] = grid().ctas;
  out[1] = S::kThreads;
  out[2] = static_cast<int>(sizeof(Shared<3>));
  return static_cast<int>(grid().err);
}

extern "C" int pair_score_launch(
    int T, int n, int sweeps, const int* table, const float* x,
    const float* X, const float* Q, const float* W1, const float* b1,
    const float* W2, const float* b2, const float* W3, const float* b3,
    float* nn_out, float* feas_out, void* stream) {
  if (grid().err != cudaSuccess) return static_cast<int>(grid().err);
  if (T > 0) {
    pair_score_kernel<<<ctas_for(grid(), T), S::kThreads, sizeof(Shared<3>),
                        static_cast<cudaStream_t>(stream)>>>(
        T, n, sweeps, table, x, X, Q, MLPArgs{W1, b1, W2, b2, W3, b3}, nn_out, feas_out);
  }
  return static_cast<int>(cudaGetLastError());
}
