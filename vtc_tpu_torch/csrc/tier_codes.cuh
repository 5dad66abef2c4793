// The iteration product's tier (vtc_tpu's _make_iter_dot, ops/
// pallas_train_step.py:129-169), as the C entries of K1, K2, K4 and K6
// take it: 'highest' is fista_core.cuh's fp32 FMA kernels; the others
// split their operands into bf16 terms for the tensor cores
// (fista_tier.cuh), and at kTierBf16 K2 and K6 also take c = X D^T as one
// bf16 pass (train_core.cuh).  ops/precision.py's TIER_CODES holds the
// same numbers.
#pragma once

namespace {

enum Tier { kTierHighest = 0, kTierBf16 = 1, kTierBf16x3 = 2, kTierBf16x5 = 3 };

}  // namespace
