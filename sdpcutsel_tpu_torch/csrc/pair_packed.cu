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
// (score_mma.cuh score_rounds); invalid slots get -inf in both outputs.
//
// What bounds it on the H100: the operations of the valid slots, as in
// pair_score.cu (the MLP's products on the tensor cores, the Jacobi's IEEE
// chains on the CUDA cores).  At n = 125, 190,154 of the 507,904 slots (37%)
// are invalid: one thread a slot left those lanes idle beside warp-mates
// that scored, so the same triples took 1.38x as long as in pair_score.cu.
//
// Design: the valid slots are scored in dense tiles of 32, by pair_score.cu's
// own warp-specialised device code (score_mma.cuh), so every triple gets
// K1's bits.  The layout's valid-slot list (PackedLayout.valid_slots, built
// once per n) gives each producer lane its slot; the lane decodes tier, row
// and lane from it, reads its pair id from that tier's row array and (i, j)
// from iu / ju, and takes l from the tier's affine lane map.  The scores go
// back to the slot's position.  Before the rounds, a grid-stride pass over
// all slots decodes each one the same way and writes -inf where it is
// invalid.  The
// TPU kernel's reason to pack (128-lane vectors that only row slices can
// fill) does not hold here; the packing is kept because it fixes the
// candidate order that the solver's selection ties follow.

#include <cuda_runtime.h>

#include <math_constants.h>

#include "score_mma.cuh"

namespace {

using namespace scoring::mma;
using S = Shape<3>;

constexpr int kLanes = 128;

// the triple of slot s; false when the slot is invalid.  rows: the three
// tiers' (R_t, per_t) pair-id arrays, concatenated row-major
__device__ __forceinline__ bool decode_slot(
    int s, int n, int R0, int R1, const int* __restrict__ rows,
    const int* __restrict__ iu, const int* __restrict__ ju, int& i, int& j, int& l) {
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
  l = lo + lane % sub;
  if (p < 0 || l >= n) return false;
  i = iu[p];
  j = ju[p];
  return l > j;
}

// candidate c is the valid slot valid_slots[c]
struct ValidSlots {
  const int* __restrict__ valid_slots;
  int n, R0, R1;
  const int* __restrict__ rows;
  const int* __restrict__ iu;
  const int* __restrict__ ju;
  const float* __restrict__ Q;
  __device__ bool operator()(int c, int (&id)[3], float* f, float& scale, int& pos) const {
    pos = valid_slots[c];
    if (!decode_slot(pos, n, R0, R1, rows, iu, ju, id[0], id[1], id[2])) return false;
    q_features<3>(Q, n, id, f, scale);
    return true;
  }
};

__global__ void __launch_bounds__(S::kThreads, 1) pair_packed_kernel(
    int slots, int V, int n, int R0, int R1, int sweeps, const int* __restrict__ valid_slots,
    const int* __restrict__ rows, const int* __restrict__ iu, const int* __restrict__ ju,
    const float* __restrict__ x, const float* __restrict__ X,
    const float* __restrict__ Q, MLPArgs mlp,
    float* __restrict__ nn_out, float* __restrict__ feas_out) {
  extern __shared__ float4 smem[];
  // the invalid slots' -inf; score_rounds writes only valid slots, so no
  // barrier is needed between the two
  for (int s = blockIdx.x * S::kThreads + threadIdx.x; s < slots;
       s += gridDim.x * S::kThreads) {
    int i, j, l;
    if (!decode_slot(s, n, R0, R1, rows, iu, ju, i, j, l)) {
      nn_out[s] = -CUDART_INF_F;
      feas_out[s] = -CUDART_INF_F;
    }
  }
  score_rounds<3>(ValidSlots{valid_slots, n, R0, R1, rows, iu, ju, Q}, V, n, sweeps, x, X,
                  mlp, *reinterpret_cast<Shared<3>*>(smem), nn_out, feas_out);
}

const Grid& grid() {
  static const Grid g = persistent_grid<3>(pair_packed_kernel);
  return g;
}

}  // namespace

// the persistent grid: out[0] CTAs of out[1] threads, out[2] bytes of dynamic
// shared memory a CTA
extern "C" int pair_packed_grid(int* out) {
  out[0] = grid().ctas;
  out[1] = S::kThreads;
  out[2] = static_cast<int>(sizeof(Shared<3>));
  return static_cast<int>(grid().err);
}

extern "C" int pair_packed_launch(
    int slots, int V, int n, int R0, int R1, int sweeps, const int* valid_slots,
    const int* rows, const int* iu, const int* ju, const float* x, const float* X,
    const float* Q, const float* W1, const float* b1, const float* W2, const float* b2,
    const float* W3, const float* b3, float* nn_out, float* feas_out, void* stream) {
  if (grid().err != cudaSuccess) return static_cast<int>(grid().err);
  if (slots > 0) {
    pair_packed_kernel<<<ctas_for(grid(), slots), S::kThreads, sizeof(Shared<3>),
                         static_cast<cudaStream_t>(stream)>>>(
        slots, V, n, R0, R1, sweeps, valid_slots, rows, iu, ju, x, X, Q,
        MLPArgs{W1, b1, W2, b2, W3, b3}, nn_out, feas_out);
  }
  return static_cast<int>(cudaGetLastError());
}
