// Dense k = 3 candidate scoring over the tiered packed pair layout: MLP
// estimate and feasibility violation of every slot, float32, in the layout's
// slot order [tier 0 | tier 1 | tier 2], each tier row-major (R_t, 128).
//
// Replaces the Pallas TPU kernel sdpcutsel_tpu/ops/pair_packed.py::_packed_kernel
// (launched from _tier_score / packed_score) together with the XLA MLP that
// ran on its feature planes (pair_score.py::_mlp).  The layout
// (ops/pair_packed.py::build_packed_pair_layout) packs the pairs (i, j) of
// np.triu_indices(n, 1) into rows of 128 lanes:
//   tier 0: j <  n-65          1 pair a row,  l = lane
//   tier 1: j in [n-65, n-33)  2 pairs a row, l = n-64 + lane % 64
//   tier 2: j >= n-33          4 pairs a row, l = n-32 + lane % 32
// Slot (row, lane) of tier t holds the triple (iu[p], ju[p], l) with
// p = rows_t[row][lane / (128 / per_t)]; it is valid when p >= 0, l > j and
// l < n.  Valid slots get the per-triple score of pair_score.cu
// (score_common.cuh score_triple); invalid slots get -inf in both outputs.
//
// What bounds it on the H100: as pair_score.cu, the MLP's ~5.1k
// multiply-adds per valid slot from shared-memory weights; at n = 125,
// 317,750 of the 507,904 slots are valid and the invalid ones exit after
// three small loads.
//
// Design: one thread per slot, 256 threads a block.  The thread decodes its
// tier, row and lane from the slot number, reads its pair id from that
// tier's row array and (i, j) from iu / ju, and takes l from the tier's
// affine lane map: it reads no gathered (slots, 3) table.  The TPU kernel's
// reason to pack (128-lane vectors that only row slices can fill) does not
// hold for a thread that gathers on its own; the packing is kept because it
// fixes the candidate order that the solver's selection ties follow.

#include <cuda_runtime.h>

#include <math_constants.h>

#include "score_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kLanes = 128;
constexpr int kF = 15;   // features, k = 3

// rows: the three tiers' (R_t, per_t) pair-id arrays, concatenated row-major
__global__ void __launch_bounds__(kThreads) pair_packed_kernel(
    int S, int n, int R0, int R1, int sweeps, const int* __restrict__ rows,
    const int* __restrict__ iu, const int* __restrict__ ju,
    const float* __restrict__ x, const float* __restrict__ X,
    const float* __restrict__ Q,
    const float* __restrict__ W1, const float* __restrict__ b1,
    const float* __restrict__ W2, const float* __restrict__ b2,
    const float* __restrict__ W3, const float* __restrict__ b3,
    float* __restrict__ nn_out, float* __restrict__ feas_out) {
  __shared__ scoring::MLPWeights<kF> sw;
  scoring::load_mlp(sw, W1, b1, W2, b2, W3, b3);
  __syncthreads();

  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= S) return;
  const int g = s / kLanes;            // row over all tiers
  const int lane = s % kLanes;
  int per, first, lo;                  // pairs a row, tier's first pair id entry, lane map
  int r = g;
  if (g < R0) {
    per = 1; first = 0; lo = 0;
  } else if (g < R0 + R1) {
    per = 2; first = R0; lo = n - 64; r = g - R0;
  } else {
    per = 4; first = R0 + 2 * R1; lo = n - 32; r = g - R0 - R1;
  }
  const int sub = kLanes / per;        // lanes a pair
  const int p = rows[first + r * per + lane / sub];
  const int l = lo + lane % sub;
  if (p < 0 || l >= n || l <= ju[p]) {
    nn_out[s] = -CUDART_INF_F;
    feas_out[s] = -CUDART_INF_F;
    return;
  }
  scoring::score_triple(iu[p], ju[p], l, n, sweeps, x, X, Q, sw, nn_out[s], feas_out[s]);
}

}  // namespace

extern "C" int pair_packed_launch(
    int S, int n, int R0, int R1, int sweeps, const int* rows, const int* iu,
    const int* ju, const float* x, const float* X, const float* Q,
    const float* W1, const float* b1, const float* W2, const float* b2,
    const float* W3, const float* b3, float* nn_out, float* feas_out,
    void* stream) {
  const int blocks = (S + kThreads - 1) / kThreads;
  if (blocks > 0) {
    pair_packed_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        S, n, R0, R1, sweeps, rows, iu, ju, x, X, Q, W1, b1, W2, b2, W3, b3, nn_out,
        feas_out);
  }
  return static_cast<int>(cudaGetLastError());
}
