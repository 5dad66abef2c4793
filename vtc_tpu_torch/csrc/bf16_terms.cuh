// The bf16 terms of a float32 value and the bf16 tensor-core product that
// the precision tiers are built from, for Hopper (sm_90a).  Shared by the
// solve's tier kernel (fista_tier.cuh: K1, K2, K4, K6 and the
// data-parallel kernels), the conv tier GEMM (conv_gemm_tier.cuh: K10,
// K12, K13, K17), the ICA tier tile (ica_segment.cuh: K8, K9, K18) and
// K19's tier tile (code_shard_solve.cuh).
//
// vtc_tpu splits a float32 operand into bf16 terms, each rounded to
// nearest even: hi = bf16(x); at bf16x3 lo = bf16(x - hi)
// (_split_hi_lo, vtc_tpu/ops/pallas_train_step.py:103-108); at bf16x5 the
// exact three-term split mid = bf16(x - hi), lo = bf16(x - hi - mid)
// (_split3, :111-126), each residual in float32.  A product of two bf16
// values is exact in float32, so mma.sync m16n8k16 .bf16 with float32
// accumulation computes vtc_tpu's single-pass products.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "tier_codes.cuh"

namespace {

// bf16 terms of one operand at a tier: 1 at bf16, 2 at bf16x3, 3 at bf16x5.
__host__ __device__ constexpr int tier_terms(int tier) {
  return tier == kTierBf16 ? 1 : tier == kTierBf16x3 ? 2 : 3;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

// The terms of v: hi; then lo = bf16(v - hi) (bf16x3) or mid and lo of the
// exact split (bf16x5), each residual in float32.
template <int TERMS>
__device__ __forceinline__ void split_bits(float v, uint16_t (&t)[TERMS]) {
  t[0] = bf16_bits(v);
  if constexpr (TERMS >= 2) {
    const float r = __fsub_rn(v, bf16_round(v));
    t[1] = bf16_bits(r);
    if constexpr (TERMS == 3) t[2] = bf16_bits(__fsub_rn(r, bf16_round(r)));
  }
}

// split_bits' terms as float values.
template <int TERMS>
__device__ __forceinline__ void split_terms(float v, float (&t)[TERMS]) {
  t[0] = bf16_round(v);
  if constexpr (TERMS >= 2) {
    const float r = __fsub_rn(v, t[0]);
    t[1] = bf16_round(r);
    if constexpr (TERMS == 3) t[2] = bf16_round(__fsub_rn(r, t[1]));
  }
}

// c += a b over one m16n8k16 tile: bf16 operands, float32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint4& a,
                                         const uint2& b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b.x), "r"(b.y));
}

}  // namespace
