// What the three PDHG kernels share: the iteration block (pdhg_block.cu,
// K2), the checked block's control (pdhg_check.cu, K5) and the power
// iteration for ||K|| (pdhg_norm.cu, K6).
//
// All three run one thread-block cluster of C CTAs x kThreads threads per
// instance; CTA r owns rows [r R, min(n, (r + 1) R)) of every (n, n) array,
// R = ceil(n / C), and pool slots [r Mc, (r + 1) Mc), Mc = ceil(M / C).
// Thread t works on column t % kCols of the band rows t / kCols,
// t / kCols + kGroups, ...  Sums run in one fixed order (no atomics), so a
// launch repeats bit for bit.
//
// The control record: every solve keeps one int32 record of kRecWords words
// per instance in device memory (lp/pdhg.py REC_*: the same offsets, held
// equal by tests/test_torch_pdhg_check.py).  K5 writes it after each block;
// K2 reads its steps and the stop flag from it, so the solve's loop needs no
// host read between blocks.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace pdhg {

namespace cg = cooperative_groups;

constexpr int kThreads = 512;
constexpr int kCols = 128;                   // n <= 128
constexpr int kGroups = kThreads / kCols;    // row groups of a band
constexpr int kWarpsPerRow = kCols / 32;
constexpr int kMaxCluster = 16;
constexpr float kSA = 0.70710678118654752440f;   // 1 / sqrt(2)
constexpr float kSB = 0.57735026918962576451f;   // 1 / sqrt(3)
constexpr int kErrLayout = -2;      // the caller's plan disagrees with this layout
constexpr int kErrNoCluster = -3;   // no cluster of this shape fits on the card

// the control record's words: ints, then floats (stored by their bits)
constexpr int kRecIt = 0;        // iterations run
constexpr int kRecWlen = 1;      // iterations since the last restart
constexpr int kRecStop = 2;      // 1 once the instance has stopped
constexpr int kRecRestart = 3;   // 1 when the last check restarted
constexpr int kRecUseAvg = 4;    // 1 when the last check chose the average
constexpr int kRecOmega = 5;     // primal weight
constexpr int kRecErr = 6;       // KKT error of the last check's candidate
constexpr int kRecP = 7;         // its primal objective
constexpr int kRecD = 8;         // its dual bound
constexpr int kRecTau = 9;       // the next block's primal step eta / omega
constexpr int kRecSigma = 10;    // and dual step eta omega
constexpr int kRecEta = 11;      // step_scale / ||K||
constexpr int kRecDp = 12;       // the last restart's primal distance (+1e-12)
constexpr int kRecDd = 13;       // and dual distance (+1e-12)
constexpr int kRecWords = 16;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The CTA's sums of v[0..NV) over its threads, in one fixed order (each
// warp's butterfly, then the warps in order), into out[0..NV) in shared
// memory; scratch holds (kThreads / 32) NV floats.  Every thread calls it.
template <int NV>
__device__ __forceinline__ void block_sums(float (&v)[NV], float* scratch, float* out) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int j = 0; j < NV; ++j) v[j] = warp_sum(v[j]);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NV; ++j) scratch[warp * NV + j] = v[j];
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float s = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w) s += scratch[w * NV + threadIdx.x];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// sum over q in [q0, q1) of w[cut[q]] coef[q], in order: one destination's
// segment of the cut index (relax/cutbuffer.py build_cut_index)
__device__ __forceinline__ float segment_sum(const int* cut, const float* coef, int q0, int q1,
                                             const float* w) {
  float s = 0.0f;
  for (int q = q0; q < q1; ++q) s += w[cut[q]] * coef[q];
  return s;
}

// lin . x[id] + <quad, X[id, id]> of one cut of width K, with x(i) and
// X(i, j) given by the caller: every read is issued before the sums
// (unrolled), so remote reads cost about one latency, not K^2
template <int K, class XAt, class XXAt>
__device__ __forceinline__ float cut_residual(const int* id, const float* l, const float* qd,
                                              XAt x_at, XXAt X_at) {
  float xs[K], xv[K * K];
#pragma unroll
  for (int u = 0; u < K; ++u) {
    const int iu = id[u];
    xs[u] = x_at(iu);
#pragma unroll
    for (int v = 0; v < K; ++v) xv[u * K + v] = X_at(iu, id[v]);
  }
  float r1 = 0.0f, r2 = 0.0f;
#pragma unroll
  for (int u = 0; u < K; ++u) {
    r1 += l[u] * xs[u];
#pragma unroll
    for (int v = 0; v < K; ++v) r2 += qd[u * K + v] * xv[u * K + v];
  }
  return r1 + r2;
}

template <class XAt, class XXAt>
__device__ __forceinline__ float cut_residual_k(int k, const int* id, const float* l,
                                                const float* qd, XAt x_at, XXAt X_at) {
  switch (k) {
    case 2: return cut_residual<2>(id, l, qd, x_at, X_at);
    case 3: return cut_residual<3>(id, l, qd, x_at, X_at);
    case 4: return cut_residual<4>(id, l, qd, x_at, X_at);
    default: return cut_residual<5>(id, l, qd, x_at, X_at);
  }
}

// one cluster of `cluster` CTAs per instance, `instances` clusters
inline cudaLaunchConfig_t launch_config(int cluster, int instances, int smem,
                                        cudaStream_t stream, cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster * instances, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(smem);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// A kernel's attributes for (cluster, smem), and the check that the card
// holds one such cluster; `checked` keeps the last pair that passed.
template <class Kernel>
int prepare_cluster(Kernel kernel, int cluster, int smem, int checked[2]) {
  if (cluster == checked[0] && smem == checked[1]) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (cluster > 8) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config(cluster, 1, smem, nullptr, attr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (clusters < 1) return kErrNoCluster;
  checked[0] = cluster;
  checked[1] = smem;
  return 0;
}

}  // namespace pdhg
