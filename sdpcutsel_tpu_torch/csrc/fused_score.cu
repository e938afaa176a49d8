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
// What bounds it on the H100: per candidate, the MLP's products F -> 64 and
// 64 -> 64 (2 * 64 * (F + 64) operations, 12,672 at k = 5), then the
// Jacobi's k(k+1)/2 rotations a sweep (90 at k = 5 and the QCQP path's 6
// sweeps), a dependent chain of IEEE divisions and square roots.  The tables
// are small (2,876 rows on qcqpband100-5-25-1, 51,503 at most in the
// registry): one thread a candidate filled 12 of 132 SMs on band100, and the
// time was one thread's serial chain with the MLP on the CUDA cores.  The
// gathers of x and X (40 KB at n = 100) hit L1/L2; triQ (60 B a row at
// k = 5) is the largest streamed input.
//
// Design: K1's and K3's warp-specialised persistent CTA (score_mma.cuh),
// instantiated for K = 2..5 with this kernel's source of candidates: a
// producer lane reads its table row, the caller's triQ row and scale, and
// gathers x and X.  Consumer warps run the MLP's products on the tensor cores
// in split TF32 while the producers run the Jacobi; the producer count falls
// with K (20, 20, 16, 12), so that two stages of wider feature rows and the
// split weights fit one CTA's shared memory.  Tiles of 32 rows are dealt
// over min(SMs, tiles) CTAs, so band100's 90 tiles run on 90 SMs and a
// call's time approaches one tile's gather and Jacobi.  No padding rows and
// no atomics.  The TPU gathered with one-hot MXU matmuls over 128-candidate
// chunks of a table padded to a 1024-row block.

#include <cuda_runtime.h>

#include "score_mma.cuh"

namespace {

using namespace scoring::mma;

// candidate c is row c of the table, with the caller's triQ row and scale
template <int K>
struct TriQRows {
  const int* __restrict__ table;
  const float* __restrict__ triQ;
  const float* __restrict__ scale;
  __device__ bool operator()(int c, int (&id)[K], float* f, float& s, int& pos) const {
#pragma unroll
    for (int a = 0; a < K; ++a) id[a] = table[K * c + a];
#pragma unroll
    for (int e = 0; e < Shape<K>::kT; ++e) f[e] = triQ[Shape<K>::kT * c + e];
    s = scale[c];
    pos = c;
    return true;
  }
};

template <int K>
__global__ void __launch_bounds__(Shape<K>::kThreads, 1) fused_score_kernel(
    int T, int n, int sweeps, const int* __restrict__ table,
    const float* __restrict__ x, const float* __restrict__ X,
    const float* __restrict__ triQ, const float* __restrict__ scale, MLPArgs mlp,
    float* __restrict__ nn_out, float* __restrict__ feas_out) {
  extern __shared__ float4 smem[];
  score_rounds<K>(TriQRows<K>{table, triQ, scale}, T, n, sweeps, x, X, mlp,
                  *reinterpret_cast<Shared<K>*>(smem), nn_out, feas_out);
}

template <int K>
const Grid& grid() {
  static const Grid g = persistent_grid<K>(fused_score_kernel<K>);
  return g;
}

template <int K>
int grid_of(int* out) {
  out[0] = grid<K>().ctas;
  out[1] = Shape<K>::kThreads;
  out[2] = static_cast<int>(sizeof(Shared<K>));
  return static_cast<int>(grid<K>().err);
}

template <int K>
int launch(int T, int n, int sweeps, const int* table, const float* x, const float* X,
           const float* triQ, const float* scale, const MLPArgs& mlp, float* nn_out,
           float* feas_out, cudaStream_t stream) {
  if (grid<K>().err != cudaSuccess) return static_cast<int>(grid<K>().err);
  fused_score_kernel<K><<<ctas_for(grid<K>(), T), Shape<K>::kThreads, sizeof(Shared<K>),
                          stream>>>(T, n, sweeps, table, x, X, triQ, scale, mlp, nn_out,
                                    feas_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// the persistent grid of width k: out[0] CTAs of out[1] threads, out[2]
// bytes of dynamic shared memory a CTA
extern "C" int fused_score_grid(int k, int* out) {
  switch (k) {
    case 2: return grid_of<2>(out);
    case 3: return grid_of<3>(out);
    case 4: return grid_of<4>(out);
    case 5: return grid_of<5>(out);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int fused_score_launch(
    int T, int n, int k, int sweeps, const int* table, const float* x,
    const float* X, const float* triQ, const float* scale, const float* W1,
    const float* b1, const float* W2, const float* b2, const float* W3,
    const float* b3, float* nn_out, float* feas_out, void* stream) {
  if (T <= 0) return static_cast<int>(cudaGetLastError());
  const MLPArgs mlp{W1, b1, W2, b2, W3, b3};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 2: return launch<2>(T, n, sweeps, table, x, X, triQ, scale, mlp, nn_out, feas_out, s);
    case 3: return launch<3>(T, n, sweeps, table, x, X, triQ, scale, mlp, nn_out, feas_out, s);
    case 4: return launch<4>(T, n, sweeps, table, x, X, triQ, scale, mlp, nn_out, feas_out, s);
    case 5: return launch<5>(T, n, sweeps, table, x, X, triQ, scale, mlp, nn_out, feas_out, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
