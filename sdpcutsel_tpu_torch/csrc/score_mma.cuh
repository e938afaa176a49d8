// Tensor-core scoring of candidates of width K = 2..5, the one body of the
// three scoring kernels: pair_score.cu (K1, K = 3, any table), pair_packed.cu
// (K3, K = 3, the packed layout's valid slots) and fused_score.cu (K4, any
// (T, K) table).  One device function scores every candidate, so a
// candidate gets the same bits whichever kernel, CTA, warp or tile row
// scores it.  Per candidate rho, with F = K(K+1) + K features:
//   feats = [tri(Q_rho) / scale | x_rho | tri(X_rho)],
//   nn    = scale * relu(MLP(feats))   (F -> 64 -> 64 -> 1, relu)
//   feas  = -lambda_min(Z(rho)), Z = [[1, x_rho'], [x_rho, X_rho]], by
//           score_common.cuh's cyclic Jacobi.
// A Source gives each candidate's indices, its tri(Q_rho) / scale and scale
// (K1 and K3 compute them from Q, K4 reads the caller's rows), and the
// position of its scores.
//
// A persistent CTA in two roles (warp specialisation):
// - kProducers producer warps (warpgroups 1 and up; setmaxnreg to what the
//   consumers leave): each takes a tile of 32 candidates, one a lane,
//   gathers the candidate's x and X entries, writes its features into a row
//   of its stage in shared memory (padded with zeros to a multiple of 8),
//   signals the consumers, and then runs the Jacobi on its own
//   (K+1) x (K+1) Z(rho) and writes feas.  The Jacobi's IEEE divisions and
//   square roots are long dependent chains; many light warps hide what they
//   can of them.
// - 4 consumer warps (warpgroup 0, 232 registers): they split the weights
//   into shared memory while the producers gather, then run the MLP of every
//   producer's tile.  Layers 1 and 2 are mma.sync.m16n8k8 TF32 products in
//   split TF32 ("3xTF32"): every operand v is split into hi = rna_tf32(v)
//   and lo = rna_tf32(v - hi), and each k-step accumulates lo*hi, hi*lo,
//   hi*hi in fp32, in that order (one pass of TF32 keeps ~3 digits, which
//   the scale factor max |Q_rho| blows past the twin tolerance; the split
//   keeps ~fp32).  The weights are split once a CTA and stored in the B
//   fragments' order (one float4 a lane: hi b0, hi b1, lo b0, lo b1), so a B
//   load is one conflict-free 16-byte load, shared by the tile's two m16
//   halves.  Layer 1 takes F padded to kK1 k-steps of 8; a stage row holds
//   8 kK1 + 4 floats, so the A-fragment reads of 8 rows x 4 columns fall in
//   32 different banks.  Layer 1's accumulators become layer 2's A fragments
//   in registers: a thread holds hidden columns 2t and 2t + 1 of each
//   n-tile, and layer 2 takes them as k = t and t + 4 of its k-step, with
//   W2's columns stored in that order.  Layer 3 (64 -> 1), its bias, the
//   relu and the scale stay in fp32: partial sums over the thread's 16
//   columns, then a fixed xor-shuffle sum in the quad.
// Producers and consumers meet at two stages (double buffering) through
// named barriers: FULL(b) when every producer has written stage b, EMPTY(b)
// when the consumers are done with it.  Every warp of every CTA runs the
// same number of rounds, so the arrivals always match.
//
// Tiles are dealt over the grid first: tile t goes to CTA t mod grid, and
// the grid is min(CTAs the card holds, tiles), so a small table puts one
// tile on each of up to 132 SMs and its time approaches one tile's latency.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "score_common.cuh"

namespace scoring {
namespace mma {

constexpr int kConsumers = 4;           // warpgroup 0
constexpr int kRows = 32;               // a producer's tile: one candidate a lane
constexpr int kK2 = kH / 8;             // k-steps of layer 2
constexpr int kN = kH / 8;              // n-tiles of layers 1 and 2
constexpr int kFull = 1, kEmpty = 3;    // named barriers, + stage (0 is __syncthreads)
constexpr int kWeights = 5;             // named barrier of the consumers' weight split
constexpr int kConsumerRegs = 232;

// Producer warps a CTA, in whole warpgroups (setmaxnreg acts on a
// warpgroup): as many as the two stages and the split weights leave room
// for in 227 KB of shared memory, and at K = 4 enough registers for the
// 15-entry Jacobi.
constexpr int producers_for(int K) { return K == 5 ? 12 : K == 4 ? 16 : 20; }

template <int K>
struct Shape {
  static constexpr int kT = K * (K + 1) / 2;     // upper triangle of a K x K block
  static constexpr int kF = 2 * kT + K;          // features
  static constexpr int kK1 = (kF + 7) / 8;       // k-steps of layer 1
  static constexpr int kPad = 8 * kK1;           // features padded with zeros
  static constexpr int kStride = kPad + 4;       // floats a stage row
  static constexpr int kM = K + 1;               // Z(rho) is kM x kM
  static constexpr int kProducers = producers_for(K);
  static constexpr int kThreads = 32 * (kConsumers + kProducers);
  // registers a thread: at launch (__launch_bounds__(kThreads, 1)), then
  // after setmaxnreg the consumers' and, of what they leave, the producers'
  static constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kProducerRegs =
      (kLaunchRegs * kThreads - 32 * kConsumers * kConsumerRegs) / (32 * kProducers) / 8 * 8;
  static_assert(kProducers % 4 == 0, "producers come in warpgroups");
  static_assert(kProducerRegs >= 24 && kProducerRegs <= kLaunchRegs, "no register split");
};

// the MLP's weights in PyTorch's Linear layout ([out][in])
struct MLPArgs {
  const float* __restrict__ W1;
  const float* __restrict__ b1;
  const float* __restrict__ W2;
  const float* __restrict__ b2;
  const float* __restrict__ W3;
  const float* __restrict__ b3;
};

// the weights as the tensor cores read them, split into hi and lo
template <int K>
struct SplitMLP {
  float4 W1[Shape<K>::kK1 * kN * 32];   // [k-step][n-tile][lane]
  float4 W2[kK2 * kN * 32];
  float b1[kH];
  float b2[kH];
  float W3[kH];
  float b3;
};

// one producer's tile in one stage
template <int K>
struct Stage {
  __align__(16) float f[kRows * Shape<K>::kStride];   // features, a row a candidate
  float scale[kRows];
  int out[kRows];               // output position of the row's candidate; -1: none
};

template <int K>
struct Shared {
  SplitMLP<K> w;
  Stage<K> stage[2][Shape<K>::kProducers];
};

__device__ __forceinline__ uint32_t rna_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(v));
  return r;
}

__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = rna_tf32(v);
  lo = rna_tf32(v - __uint_as_float(hi));
}

__device__ __forceinline__ float4 split_pair(float v0, float v1) {
  uint32_t h0, l0, h1, l1;
  split(v0, h0, l0);
  split(v1, h1, l1);
  return make_float4(__uint_as_float(h0), __uint_as_float(h1), __uint_as_float(l0),
                     __uint_as_float(l1));
}

// d += a * b on the tensor cores, m16n8k8, TF32 operands, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in split TF32: lo*hi, hi*lo, hi*hi, in that order
__device__ __forceinline__ void mma_split(float (&d)[4], const uint32_t (&ah)[4],
                                          const uint32_t (&al)[4], float4 b) {
  mma_tf32(d, al, __float_as_uint(b.x), __float_as_uint(b.y));
  mma_tf32(d, ah, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(d, ah, __float_as_uint(b.x), __float_as_uint(b.y));
}

template <int Threads>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(Threads) : "memory");
}

template <int Threads>
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(Threads) : "memory");
}

// Threads 0 .. threads - 1 call it; a barrier over them must follow.  Lane
// (g, t) = (lane / 4, lane % 4) of an m16n8k8 B fragment holds (k, n) = (t, g)
// and (t + 4, g).
template <int K>
__device__ __forceinline__ void load_split_mlp(SplitMLP<K>& w, const MLPArgs& m, int threads) {
  constexpr int kF = Shape<K>::kF;
  for (int q = threadIdx.x; q < Shape<K>::kK1 * kN * 32; q += threads) {
    const int lane = q % 32, j = q / 32 % kN, s = q / (32 * kN);
    const int o = 8 * j + lane / 4;           // hidden unit: n
    const int f = 8 * s + lane % 4;           // features f and f + 4: k
    w.W1[q] = split_pair(f < kF ? m.W1[o * kF + f] : 0.0f,
                         f + 4 < kF ? m.W1[o * kF + f + 4] : 0.0f);
  }
  for (int q = threadIdx.x; q < kK2 * kN * 32; q += threads) {
    const int lane = q % 32, j = q / 32 % kN, s = q / (32 * kN);
    const int o = 8 * j + lane / 4;           // layer-2 unit: n
    const int h = 8 * s + 2 * (lane % 4);     // layer-1 units h, h + 1 as k = t, t + 4
    w.W2[q] = split_pair(m.W2[o * kH + h], m.W2[o * kH + h + 1]);
  }
  for (int q = threadIdx.x; q < kH; q += threads) {
    w.b1[q] = m.b1[q];
    w.b2[q] = m.b2[q];
    w.W3[q] = m.W3[q];
  }
  if (threadIdx.x == 0) w.b3 = m.b3[0];
}

// The layer-3 sums (before b3) of a stage's 32 rows, m16 tiles m = 0, 1 of
// rows 16m .. 16m + 15; lane L returns row L's.  The whole warp calls it.
template <int K>
__device__ __forceinline__ float mlp_rows(const float* rows, const SplitMLP<K>& w) {
  constexpr int kStride = Shape<K>::kStride;
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // layer 1: rows 16m + g and 16m + g + 8, hidden columns 8j + 2t and 8j + 2t + 1
  float h[2][kN][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < kN; ++j) h[m][j][0] = h[m][j][1] = h[m][j][2] = h[m][j][3] = 0.0f;
#pragma unroll
  for (int s = 0; s < Shape<K>::kK1; ++s) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float* r = rows + 16 * m * kStride + 8 * s + t;
      split(r[g * kStride], ah[m][0], al[m][0]);
      split(r[(g + 8) * kStride], ah[m][1], al[m][1]);
      split(r[g * kStride + 4], ah[m][2], al[m][2]);
      split(r[(g + 8) * kStride + 4], ah[m][3], al[m][3]);
    }
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float4 b = w.W1[(s * kN + j) * 32 + lane];
      mma_split(h[0][j], ah[0], al[0], b);
      mma_split(h[1][j], ah[1], al[1], b);
    }
  }
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(w.b1 + 8 * j + 2 * t);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      h[m][j][0] = fmaxf(h[m][j][0] + b.x, 0.0f);
      h[m][j][1] = fmaxf(h[m][j][1] + b.y, 0.0f);
      h[m][j][2] = fmaxf(h[m][j][2] + b.x, 0.0f);
      h[m][j][3] = fmaxf(h[m][j][3] + b.y, 0.0f);
    }
  }
  // layer 2: layer 1's n-tile s is k-step s, its accumulators the A fragment
  float o[2][kN][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < kN; ++j) o[m][j][0] = o[m][j][1] = o[m][j][2] = o[m][j][3] = 0.0f;
#pragma unroll
  for (int s = 0; s < kK2; ++s) {
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      split(h[m][s][0], ah[m][0], al[m][0]);  // (row g,     k = t):     unit 8s + 2t
      split(h[m][s][2], ah[m][1], al[m][1]);  // (row g + 8, k = t)
      split(h[m][s][1], ah[m][2], al[m][2]);  // (row g,     k = t + 4): unit 8s + 2t + 1
      split(h[m][s][3], ah[m][3], al[m][3]);  // (row g + 8, k = t + 4)
    }
#pragma unroll
    for (int j = 0; j < kN; ++j) {
      const float4 b = w.W2[(s * kN + j) * 32 + lane];
      mma_split(o[0][j], ah[0], al[0], b);
      mma_split(o[1][j], ah[1], al[1], b);
    }
  }
  // layer 3 in fp32: the thread's 16 columns, then the quad
  float p[2][2] = {};                          // [m][row g, row g + 8]
#pragma unroll
  for (int j = 0; j < kN; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(w.b2 + 8 * j + 2 * t);
    const float2 v = *reinterpret_cast<const float2*>(w.W3 + 8 * j + 2 * t);
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      p[m][0] = fmaf(v.x, fmaxf(o[m][j][0] + b.x, 0.0f), p[m][0]);
      p[m][0] = fmaf(v.y, fmaxf(o[m][j][1] + b.y, 0.0f), p[m][0]);
      p[m][1] = fmaf(v.x, fmaxf(o[m][j][2] + b.x, 0.0f), p[m][1]);
      p[m][1] = fmaf(v.y, fmaxf(o[m][j][3] + b.y, 0.0f), p[m][1]);
    }
  }
  float out = 0.0f;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = p[m][e];
      v += __shfl_xor_sync(0xffffffffu, v, 1);
      v += __shfl_xor_sync(0xffffffffu, v, 2);
      v = __shfl_sync(0xffffffffu, v, (lane % 8) * 4);     // row 16m + 8e + lane % 8
      if (lane / 8 == 2 * m + e) out = v;
    }
  return out;
}

// tri(Q_rho) / scale into f[0 .. kT) and scale = max |Q_rho|, from Q (n x n),
// as models/features.py candidate_q_features computes them
template <int K>
__device__ __forceinline__ void q_features(const float* __restrict__ Q, int n,
                                           const int (&id)[K], float* f, float& scale) {
  float q[Shape<K>::kT];
#pragma unroll
  for (int a = 0; a < K; ++a)
#pragma unroll
    for (int b = a; b < K; ++b) q[U<K>(a, b)] = Q[id[a] * n + id[b]];
  scale = fabsf(q[0]);
#pragma unroll
  for (int e = 1; e < Shape<K>::kT; ++e) scale = fmaxf(scale, fabsf(q[e]));
  const float safe = fmaxf(scale, 1e-12f);
#pragma unroll
  for (int e = 0; e < Shape<K>::kT; ++e) f[e] = q[e] / safe;
}

// The rounds of a persistent CTA over `rows` candidates: candidate c is
// src(c, id, f, scale, pos) -> valid, which sets its K indices, f[0 .. kT)
// = tri(Q_rho) / scale, scale, and the position pos of its scores.  Every
// thread of the CTA calls it.
template <int K, typename Source>
__device__ __forceinline__ void score_rounds(
    Source src, int rows, int n, int sweeps, const float* __restrict__ x,
    const float* __restrict__ X, const MLPArgs& mlp, Shared<K>& sh,
    float* __restrict__ nn_out, float* __restrict__ feas_out) {
  using S = Shape<K>;
  constexpr int kT = S::kT;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = (rows + kRows - 1) / kRows;
  const int per_round = gridDim.x * S::kProducers;
  const int rounds = (tiles + per_round - 1) / per_round;
  if (warp < kConsumers) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    load_split_mlp<K>(sh.w, mlp, 32 * kConsumers);
    bar_sync<32 * kConsumers>(kWeights);
    for (int r = 0; r < rounds; ++r) {
      const int b = r & 1;
      bar_sync<S::kThreads>(kFull + b);
      for (int p = warp; p < S::kProducers; p += kConsumers) {
        const Stage<K>& st = sh.stage[b][p];
        if (st.out[0] < 0) continue;          // no candidate in this tile (uniform)
        const float out = mlp_rows<K>(st.f, sh.w);
        const int pos = st.out[lane];
        if (pos >= 0) nn_out[pos] = st.scale[lane] * fmaxf(out + sh.w.b3, 0.0f);
      }
      if (r + 2 < rounds) {
        __threadfence_block();
        bar_arrive<S::kThreads>(kEmpty + b);
      }
    }
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(S::kProducerRegs));
    const int p = warp - kConsumers;
    for (int r = 0; r < rounds; ++r) {
      const int b = r & 1;
      if (r >= 2) bar_sync<S::kThreads>(kEmpty + b);
      Stage<K>& st = sh.stage[b][p];
      const int tile = blockIdx.x + gridDim.x * (r * S::kProducers + p);
      const int c = tile * kRows + lane;
      int id[K] = {};
      int pos = -1;
      float f[S::kPad] = {};
      float scale = 0.0f;
      const bool active = c < rows && src(c, id, f, scale, pos);
      if (active) {
#pragma unroll
        for (int a = 0; a < K; ++a) {
          f[kT + a] = x[id[a]];
#pragma unroll
          for (int e = a; e < K; ++e) f[kT + K + U<K>(a, e)] = X[id[a] * n + id[e]];
        }
      }
      float4* row = reinterpret_cast<float4*>(st.f + lane * S::kStride);
#pragma unroll
      for (int q = 0; q < S::kPad / 4; ++q)
        row[q] = make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
      st.scale[lane] = scale;
      st.out[lane] = active ? pos : -1;
      __threadfence_block();
      bar_arrive<S::kThreads>(kFull + b);
      if (active) {
        // feasibility: cyclic Jacobi on the packed triangle of Z(rho)
        float z[kPacked<S::kM>];
        z[0] = 1.0f;
#pragma unroll
        for (int a = 0; a < K; ++a) {
          z[U<S::kM>(0, a + 1)] = f[kT + a];
#pragma unroll
          for (int e = a; e < K; ++e) z[U<S::kM>(a + 1, e + 1)] = f[kT + K + U<K>(a, e)];
        }
        feas_out[pos] = -jacobi_min_eig<S::kM>(z, sweeps);
      }
    }
  }
}

// Grid of a persistent launch: the CTAs the card holds at once (one a SM);
// the kernel attribute for sizeof(Shared<K>) bytes of dynamic shared memory
// is set on the first call.  The registers the kernel was built with must
// cover both roles after setmaxnreg, or the consumers' increase would wait
// forever: such a build is refused here, before any launch.
struct Grid {
  cudaError_t err;
  int ctas;      // CTAs the card holds at once
};

template <int K, typename Kernel>
Grid persistent_grid(Kernel kernel) {
  using S = Shape<K>;
  constexpr int kBytes = static_cast<int>(sizeof(Shared<K>));
  Grid grid{cudaSuccess, 0};
  int dev = 0, sms = 0, per_sm = 0;
  grid.err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kBytes);
  if (grid.err == cudaSuccess) grid.err = cudaGetDevice(&dev);
  if (grid.err == cudaSuccess)
    grid.err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (grid.err == cudaSuccess)
    grid.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, S::kThreads,
                                                             kBytes);
  cudaFuncAttributes attr{};
  if (grid.err == cudaSuccess) grid.err = cudaFuncGetAttributes(&attr, kernel);
  if (grid.err == cudaSuccess &&
      attr.numRegs * S::kThreads <
          32 * (S::kProducers * S::kProducerRegs + kConsumers * kConsumerRegs))
    grid.err = cudaErrorInvalidConfiguration;
  grid.ctas = sms * per_sm;
  if (grid.err == cudaSuccess && grid.ctas == 0) grid.err = cudaErrorInvalidConfiguration;
  return grid;
}

// CTAs of a launch over `rows` candidates: one tile each, up to the card's
inline int ctas_for(const Grid& grid, int rows) {
  const int tiles = (rows + kRows - 1) / kRows;
  return tiles < grid.ctas ? tiles : grid.ctas;
}

}  // namespace mma
}  // namespace scoring
