// What the kernels that run over a cooperative grid of every SM share: the
// dense route's "grid" plan (pdhg_dense.cu, K7) and the grid route
// (pdhg_grid.cu): 16- and 4-byte cp.async copies, a ring of stages that
// streams rows from global memory through shared memory, the grid barrier,
// and the near-equal slices a CTA owns.

#pragma once

#include "pdhg_common.cuh"

namespace pdhg {

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The first Stages - 1 stages of a stream of nst stages into a ring of
// Stages stages of Stage floats; issue(s, dst) issues stage s's copies
// (every thread its share).
template <int Stage, int Stages, class Issue>
__device__ __forceinline__ void ring_prologue(float* ring, int nst, Issue issue) {
#pragma unroll 1
  for (int s = 0; s < Stages - 1; ++s) {
    if (s < nst) issue(s, ring + s * Stage);
    cp_async_commit();
  }
}

// The rest of the stream: stage s is consumed once it has landed, while the
// stages up to s + Stages - 1 are in flight.  Every thread calls it.
template <int Stage, int Stages, class Issue, class Consume>
__device__ __forceinline__ void ring_drain(float* ring, int nst, Issue issue, Consume consume) {
#pragma unroll 1
  for (int s = 0; s < nst; ++s) {
    const int nx = s + Stages - 1;
    if (nx < nst) issue(nx, ring + (nx % Stages) * Stage);
    cp_async_commit();
    cp_async_wait<Stages - 1>();
    __syncthreads();
    consume(s, ring + (s % Stages) * Stage);
    __syncthreads();
  }
}

// A barrier over a cooperative grid of P CTAs: an arrival counter (zeroed
// by the launch) and a spin of one thread a CTA until all have arrived.
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target, unsigned P) {
  __syncthreads();
  if (threadIdx.x == 0) {
    target += P;
    __threadfence();
    atomicAdd(bar, 1u);
    unsigned v;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(bar) : "memory");
    } while (v < target);
    __threadfence();
  }
  __syncthreads();
}

// [lo, hi) of the b-th of P near-equal slices of [0, N)
__device__ __forceinline__ void slice(int N, int b, int P, int& lo, int& hi) {
  lo = static_cast<int>(static_cast<long long>(N) * b / P);
  hi = static_cast<int>(static_cast<long long>(N) * (b + 1) / P);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

}  // namespace pdhg
