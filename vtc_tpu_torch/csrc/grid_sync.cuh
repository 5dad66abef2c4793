// The grid-wide barrier and the cp.async copies of the persistent
// cooperative kernels, CUDA C++ for Hopper (sm_90a): ica_segment.cuh's
// ica_segment_kernel (K8, K18) and code_shard_solve.cuh's
// code_shard_solve_kernel (K19 at a code axis of 1).  Each .cu that
// includes it gets its own copy (internal linkage).
//
// cooperative_groups' grid.sync() pattern written out: an arrival counter
// that each CTA's thread 0 increments after a __threadfence and then polls
// with ld.acquire.gpu until every CTA of this barrier has arrived (about
// 1 us on 128 CTAs of an H100).  A poll that runs past kSegSpinLimit
// traps, so a fault ends the launch with an error instead of hanging the
// card.  Only a cooperative launch (every CTA resident at once) may use
// it.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kSegSpinLimit = 1u << 26;

// A 4-byte cp.async; where copy is false it reads nothing and writes a
// zero (a source size of 0), so gmem need only be a valid address.
__device__ __forceinline__ void seg_cp_async4(float* smem, const float* gmem,
                                              bool copy) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(copy ? 4 : 0));
}

// A 16-byte cp.async past the L1; where copy is false it reads nothing
// and writes zeros.
__device__ __forceinline__ void seg_cp_async16(float* smem, const float* gmem,
                                               bool copy) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(copy ? 16 : 0));
}

__device__ __forceinline__ void seg_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's copy groups are still in flight
template <int N>
__device__ __forceinline__ void seg_cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ unsigned seg_ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Every CTA of the grid arrives before any leaves; writes before the
// barrier are seen by every thread after it.  target counts the arrivals
// this CTA has waited for so far (gridDim.x per barrier, from the count
// the counter held at launch), in wrapping unsigned arithmetic.
__device__ __forceinline__ void seg_grid_sync(unsigned* counter,
                                              unsigned& target) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    unsigned spins = 0;
    while (static_cast<int>(seg_ld_acquire(counter) - target) < 0) {
      if (++spins > kSegSpinLimit) __trap();
    }
  }
  __syncthreads();
}

}  // namespace
