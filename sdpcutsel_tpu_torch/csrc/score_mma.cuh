// Tensor-core scoring of k = 3 candidates, shared by pair_score.cu (K1, any
// table) and pair_packed.cu (K3, the packed layout's valid slots).  One
// device function scores every triple, so a triple gets the same bits
// whichever kernel, warp or tile row scores it.
//
// A persistent CTA of 24 warps, one a SM, in two roles (warp specialisation):
// - 20 producer warps (warpgroups 1-5, 48 registers a thread after
//   setmaxnreg): each takes a tile of 32 triples, one a lane, gathers the
//   triple's 24 inputs, builds its 15 features exactly as the reference does
//   (tri(Q_rho) / scale | x_rho | tri(X_rho)) into a row of its stage in
//   shared memory (16 columns, the 16th zero), signals the consumers, and
//   then runs the Jacobi of score_common.cuh on its own 4 x 4 Z(rho) and
//   writes feas.  The Jacobi's IEEE divisions and square roots are long
//   dependent chains with divergent slow paths; many light warps hide what
//   they can of them.
// - 4 consumer warps (warpgroup 0, 232 registers): the MLP 15(+1) -> 64 ->
//   64 -> 1 of every producer's tile.  Layers 1 and 2 are mma.sync.m16n8k8
//   TF32 products in split TF32 ("3xTF32"): every operand v is split into
//   hi = rna_tf32(v) and lo = rna_tf32(v - hi), and each k-step accumulates
//   lo*hi, hi*lo, hi*hi in fp32, in that order (one pass of TF32 keeps ~3
//   digits, which the scale factor max |Q_rho| blows past the twin
//   tolerance; the split keeps ~fp32).  The weights are split once a CTA and
//   stored in the B fragments' order (one float4 a lane: hi b0, hi b1, lo b0,
//   lo b1), so a B load is one conflict-free 16-byte load, shared by the
//   tile's two m16 halves.  Layer 1's accumulators become layer 2's A
//   fragments in registers: a thread holds hidden columns 2t and 2t + 1 of
//   each n-tile, and layer 2 takes them as k = t and t + 4 of its k-step,
//   with W2's columns stored in that order.  Layer 3 (64 -> 1), its bias, the
//   relu and the scale stay in fp32: partial sums over the thread's 16
//   columns, then a fixed xor-shuffle sum in the quad.
// Producers and consumers meet at two stages (double buffering) through
// named barriers: FULL(b) when every producer has written stage b, EMPTY(b)
// when the consumers are done with it.  Every warp runs the same number of
// rounds, so the arrivals always match.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "score_common.cuh"

namespace scoring {
namespace mma3 {

constexpr int kF = 15;                  // features of a triple; a stage row pads them to 16
constexpr int kConsumers = 4;           // warpgroup 0
constexpr int kProducers = 20;          // warpgroups 1-5
constexpr int kWarps = kConsumers + kProducers;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 32;               // a producer's tile: one triple a lane
constexpr int kStride = 20;             // floats a stage row: 16 + 4, so A reads are conflict-free
constexpr int kK1 = 2;                  // k-steps of layer 1 (16 features)
constexpr int kK2 = kH / 8;             // k-steps of layer 2
constexpr int kN = kH / 8;              // n-tiles of layers 1 and 2
constexpr int kFull = 1, kEmpty = 3;    // named barriers, + stage (0 is __syncthreads)
// registers a thread: at launch (__launch_bounds__(kThreads, 1)), then after
// setmaxnreg the consumers' and, of what they leave, the producers' share
constexpr int kLaunchRegs = 65536 / kThreads / 8 * 8;
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs =
    (kLaunchRegs * kThreads - 32 * kConsumers * kConsumerRegs) / (32 * kProducers) / 8 * 8;
static_assert(kProducerRegs >= 24 && kProducerRegs <= kLaunchRegs, "no register split");

// the weights as the tensor cores read them, split into hi and lo
struct SplitMLP {
  float4 W1[kK1 * kN * 32];     // [k-step][n-tile][lane]
  float4 W2[kK2 * kN * 32];
  float b1[kH];
  float b2[kH];
  float W3[kH];
  float b3;
};

// one producer's tile in one stage
struct Stage {
  float f[kRows * kStride];     // features, a row a triple
  float scale[kRows];
  int out[kRows];               // output position of the row's triple; -1: none
};

struct Shared {
  SplitMLP w;
  Stage stage[2][kProducers];
};

constexpr size_t kSmemBytes = sizeof(Shared);

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

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kThreads) : "memory");
}

// Every thread of the CTA calls it; a __syncthreads() must follow.  Weights
// in PyTorch's Linear layout ([out][in]).  Lane (g, t) = (lane / 4, lane % 4)
// of an m16n8k8 B fragment holds (k, n) = (t, g) and (t + 4, g).
__device__ __forceinline__ void load_split_mlp(
    SplitMLP& w, const float* __restrict__ W1, const float* __restrict__ b1,
    const float* __restrict__ W2, const float* __restrict__ b2,
    const float* __restrict__ W3, const float* __restrict__ b3) {
  for (int q = threadIdx.x; q < kK1 * kN * 32; q += blockDim.x) {
    const int lane = q % 32, j = q / 32 % kN, s = q / (32 * kN);
    const int o = 8 * j + lane / 4;           // hidden unit: n
    const int f = 8 * s + lane % 4;           // features f and f + 4: k
    w.W1[q] = split_pair(W1[o * kF + f], f + 4 < kF ? W1[o * kF + f + 4] : 0.0f);
  }
  for (int q = threadIdx.x; q < kK2 * kN * 32; q += blockDim.x) {
    const int lane = q % 32, j = q / 32 % kN, s = q / (32 * kN);
    const int o = 8 * j + lane / 4;           // layer-2 unit: n
    const int h = 8 * s + 2 * (lane % 4);     // layer-1 units h, h + 1 as k = t, t + 4
    w.W2[q] = split_pair(W2[o * kH + h], W2[o * kH + h + 1]);
  }
  if (threadIdx.x < kH) {
    w.b1[threadIdx.x] = b1[threadIdx.x];
    w.b2[threadIdx.x] = b2[threadIdx.x];
    w.W3[threadIdx.x] = W3[threadIdx.x];
  }
  if (threadIdx.x == 0) w.b3 = b3[0];
}

// The layer-3 sums (before b3) of a stage's 32 rows, m16 tiles m = 0, 1 of
// rows 16m .. 16m + 15; lane L returns row L's.  The whole warp calls it.
__device__ __forceinline__ float mlp_rows(const float* rows, const SplitMLP& w) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  // layer 1: rows 16m + g and 16m + g + 8, hidden columns 8j + 2t and 8j + 2t + 1
  float h[2][kN][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < kN; ++j) h[m][j][0] = h[m][j][1] = h[m][j][2] = h[m][j][3] = 0.0f;
#pragma unroll
  for (int s = 0; s < kK1; ++s) {
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

// The rounds of a persistent CTA over `rows` candidates: candidate c is
// src(c, i, j, l, pos) -> valid, with its scores going to position pos.
// Every thread of the CTA calls it, after the weights are loaded and a
// __syncthreads().
template <typename Source>
__device__ __forceinline__ void score_rounds(
    Source src, int rows, int n, int sweeps, const float* __restrict__ x,
    const float* __restrict__ X, const float* __restrict__ Q, Shared& sh,
    float* __restrict__ nn_out, float* __restrict__ feas_out) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int tiles = (rows + kRows - 1) / kRows;
  const int per_round = gridDim.x * kProducers;
  const int rounds = (tiles + per_round - 1) / per_round;
  if (warp < kConsumers) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    for (int r = 0; r < rounds; ++r) {
      const int b = r & 1;
      bar_sync(kFull + b);
      for (int p = warp; p < kProducers; p += kConsumers) {
        const Stage& st = sh.stage[b][p];
        if (st.out[0] < 0) continue;          // no triple in this tile (uniform)
        const float out = mlp_rows(st.f, sh.w);
        const int pos = st.out[lane];
        if (pos >= 0) nn_out[pos] = st.scale[lane] * fmaxf(out + sh.w.b3, 0.0f);
      }
      if (r + 2 < rounds) {
        __threadfence_block();
        bar_arrive(kEmpty + b);
      }
    }
  } else {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    const int p = warp - kConsumers;
    for (int r = 0; r < rounds; ++r) {
      const int b = r & 1;
      if (r >= 2) bar_sync(kEmpty + b);
      Stage& st = sh.stage[b][p];
      const int c = ((r * gridDim.x + blockIdx.x) * kProducers + p) * kRows + lane;
      int i = 0, j = 0, l = 0, pos = -1;
      const bool active = c < rows && src(c, i, j, l, pos);
      float f[16] = {};
      float scale = 0.0f;
      if (active) {
        const float qii = Q[i * n + i], qij = Q[i * n + j], qil = Q[i * n + l];
        const float qjj = Q[j * n + j], qjl = Q[j * n + l], qll = Q[l * n + l];
        scale = fmaxf(fmaxf(fmaxf(fabsf(qii), fabsf(qij)), fmaxf(fabsf(qil), fabsf(qjj))),
                      fmaxf(fabsf(qjl), fabsf(qll)));
        const float safe = fmaxf(scale, 1e-12f);
        f[0] = qii / safe; f[1] = qij / safe; f[2] = qil / safe;
        f[3] = qjj / safe; f[4] = qjl / safe; f[5] = qll / safe;
        f[6] = x[i]; f[7] = x[j]; f[8] = x[l];
        f[9] = X[i * n + i]; f[10] = X[i * n + j]; f[11] = X[i * n + l];
        f[12] = X[j * n + j]; f[13] = X[j * n + l]; f[14] = X[l * n + l];
      }
      float4* row = reinterpret_cast<float4*>(st.f + lane * kStride);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        row[q] = make_float4(f[4 * q], f[4 * q + 1], f[4 * q + 2], f[4 * q + 3]);
      st.scale[lane] = scale;
      st.out[lane] = active ? pos : -1;
      __threadfence_block();
      bar_arrive(kFull + b);
      if (active) {
        // feasibility: cyclic Jacobi on the 4 x 4 Z(rho)
        float a[10] = {1.0f, f[6], f[7], f[8], f[9], f[10], f[11], f[12], f[13], f[14]};
        feas_out[pos] = -jacobi_min_eig<4>(a, sweeps);
      }
    }
  }
}

// Grid of a persistent launch: one CTA a SM, or fewer when there are fewer
// rounds of tiles; the kernel attribute for kSmemBytes of dynamic shared
// memory is set on the first call.  The registers the kernel was built with
// must cover both roles after setmaxnreg, or the consumers' increase would
// wait forever: such a build is refused here, before any launch.
struct Grid {
  cudaError_t err;
  int ctas;      // CTAs the card holds at once
};

template <typename Kernel>
Grid persistent_grid(Kernel kernel) {
  Grid grid{cudaSuccess, 0};
  int dev = 0, sms = 0, per_sm = 0;
  grid.err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(kSmemBytes));
  if (grid.err == cudaSuccess) grid.err = cudaGetDevice(&dev);
  if (grid.err == cudaSuccess)
    grid.err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (grid.err == cudaSuccess)
    grid.err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                             kSmemBytes);
  cudaFuncAttributes attr{};
  if (grid.err == cudaSuccess) grid.err = cudaFuncGetAttributes(&attr, kernel);
  if (grid.err == cudaSuccess &&
      attr.numRegs * kThreads < 32 * (kProducers * kProducerRegs + kConsumers * kConsumerRegs))
    grid.err = cudaErrorInvalidConfiguration;
  grid.ctas = sms * per_sm;
  if (grid.err == cudaSuccess && grid.ctas == 0) grid.err = cudaErrorInvalidConfiguration;
  return grid;
}

inline int ctas_for(const Grid& grid, int rows) {
  const int tiles = (rows + kRows - 1) / kRows;
  const int ctas = (tiles + kProducers - 1) / kProducers;
  return ctas < grid.ctas ? ctas : grid.ctas;
}

}  // namespace mma3
}  // namespace scoring
