// Fused convolutional train steps and the conv solve+stats step for Hopper
// (sm_90a), CUDA C++.
//
// Replaces the TPU kernel K12: vtc_tpu/ops/pallas_conv_train.py,
// fused_conv_train_segment_pallas (:547) with its segment kernel
// _make_segment_kernel (:374).  Same contract, in the stride-block space
// of K10 (fused_conv_direct.cu): for each of the k batches of a segment,
// with the packed kernels dstk (cpx, R*s), the Hessian-diagonal EMA h (s,)
// and the warm eigenvector v (s,) carried from step to step,
//
//   dall  = dstk re-laid out as (s, R*cpx)        the analysis weights
//   G     = dall dall^T                           flat-kernel Gram (s, s)
//   v = v / |v|; power_iters times v = G v / |G v|;  eta = 1 / ((G v) . v)
//   codes = K10's FISTA / ISTA, num_iters iterations, from zero codes
//   h     = 0.99 h + (sum_{b, positions} codes^2 / b) / 100 (cheap quad)
//   upd_num_iters times, at the current dstk:
//     resid = mask * S(dstk, codes) - xblk         (image blocks)
//     grad  = resid (x) code stack / b             (cpx, R*s)
//     grad  = grad * supp [/ (h + lowest)]; grad = grad * |dstk| / |grad|
//     dstk  = dstk - step * grad; each kernel's columns renormalized
//
// the order of pallas_conv_train.py:476-499.  supp is the 0/1 mask of the
// real kernel taps: kernels that are not stride multiples run zero-
// extended (K10's geometry), and projecting the gradient onto the real
// support keeps the extension taps at zero for the whole segment.
//
// Layout.  One sample's code and image state (1.1 MB at the flagship)
// exceeds a block's 227 KB, and blocks run in no order, so the TPU
// kernel's VMEM residency across grid steps cannot be copied.  As in K2,
// the C entry vtc_conv_train_segment enqueues per-step kernels for the
// whole segment on one stream; dstk, h, v, eta and the code state stay in
// device memory and the host never waits.  The solve is K10's: the
// tiled gathered implicit GEMM of conv_gemm.cuh (64 x 128 tiles of 8 x 8
// fp32 FMA outputs a thread, a two-stage cp.async ring, a shared-memory
// k-offset table, an epilogue written through shared memory in coalesced
// rows; 64-wide tiles at small batches) for corr, the synthesis (mask in
// the epilogue) and the analysis (shrink and momentum in the epilogue).
// The update's synthesis is the same GEMM with the residual epilogue.
// The batch is one tile: the TPU kernel's batch tiles and its gram-form
// tile accumulators (:501-516) exist for VMEM only and have no
// counterpart here.
//
// What bounds it on this card.  At the flagship (64 kernels of 16x16 at
// stride 8, b = 40 images of 272x272, FISTA 25) a step does about 78 GFLOP,
// 2.94 GFLOP per iteration, about 1.2 ms at the 67 TFLOP/s fp32 SIMT peak,
// against 35 MB of image blocks read: operations bound.  The gradient
// product is a long-K reduction with a small output (cpx x R*s = 64 x 256
// over K = b*bh*bw = 46,240): a 32 x 32 tile GEMM would run 16 blocks, so
// it is split over K in fixed chunks (kGradChunk) into partial sums that a
// second pass adds in order -- deterministic, no atomics.  Every product
// is IEEE fp32 FMA on the CUDA cores (no TF32, no library); the small
// products and the power refresh are train_core.cuh's.
//
// Also the TPU kernel K13: conv_solve_stats_pallas (pallas_conv_train.py:
// 840, kernel _make_stats_kernel :776), the data-parallel step of one
// shard.  vtc_conv_solve_stats runs K12's first half (refresh_and_solve
// below: the same kernels in the same order) and then, in place of the
// update, the shard's UNAVERAGED block-space statistics, which the caller
// sums over the ranks:
//
//   gradient form: grad_sum = (mask * S(dstk, codes) - xblk) (x) stack
//                  (cpx, R*s), K12's gradient product without the 1/b;
//   gram form:     bx = xblk (x) stack (cpx, R*s) and
//                  cm[a*s+i, a'*s+j] = sum m[B] z[i, B-a] z[j, B-a']
//                  (R*s, R*s), m the first row of the block mask (exact
//                  for a stride-block-uniform mask, which the wrapper's
//                  gate requires), so the gradient at ANY dstk' is
//                  (dstk' cm - bx) / b;
//   stat[j] = sum_{b, positions} codes^2, in the order of K12's EMA.
//
// Both products are long-K reductions over the b*bh*bw block positions
// with small outputs, split over K in kGradChunk chunks into partial sums
// that a second pass adds in order: deterministic, no atomics.  cm is
// symmetric, so its work is (R*s)(R*s + 1) FLOP per position (3 GFLOP at
// the flagship); the kernel computes both triangles, twice that.
//
// And the TPU kernel K17: fused_conv_dp_train_segment_pallas
// (pallas_conv_dp_train.py:300, kernel _make_conv_dp_kernel :125), a
// rank's whole data-parallel segment.  vtc_conv_dp_train_segment runs, per
// step, K13's refresh, solve and statistics (the same functions), then
// hands the packed statistics to a host hook that sums them over the ranks
// (where the TPU kernel all-reduces them over remote DMA, in-kernel), then
// the replicated update from the global statistics with K12's update
// kernel: the Hessian EMA from the summed stat, and per update iteration
// the gradient grad_sum / global_b, or (dstk cm - bx) / global_b in the
// gram form, projected, Hessian-scaled, rescaled, stepped, renormalized.
// The whole segment is enqueued from one C loop; at a world of one there
// is no hook and no host work per step.
//
// The early stop of K12's and K17's solves (vtc_tpu's
// pallas_conv_train.py:320-344 and pallas_conv_dp_train.py:143-213):
// with stop words refresh_and_solve runs K10's loop on the gathered
// GEMM's STOP builds (conv_gemm.cuh, "The early stop"), step k's solve
// tagged k + 1 with its count in iters[k], so one zeroed set of words
// serves the segment.  At a world above one (K17) the analysis leaves the
// rank's sum of |codes - old| in a one-float buffer, the C loop calls the
// stop hook, which sums it over the ranks (the same bits on every rank),
// and conv_stop_decide_kernel decides: every rank stops at the same
// count, vtc_tpu's one slot all-reduce an iteration (:190-213).  K13 has
// no stop, as vtc_tpu's.
//
// The precision tiers of K12, K13 and K17 (vtc_tpu's mxu, the tile
// solver's _make_deep_dot, pallas_conv_train.py:240-300): at a tier other
// than 'highest' refresh_and_solve splits dstk and dall into bf16 planes
// once per step, after dall_from_dstk, and runs the solve's three products
// (corr, the synthesis, the analysis) on conv_gemm_tier.cuh's bf16
// tensor-core GEMM.  The flat-kernel Gram and the power refresh, the
// update residual, the block gradient, K13's statistics and the update
// stay fp32 at every tier, as vtc_tpu's (:96-103, :518, :830).
#include "conv_gemm.cuh"
#include "conv_gemm_tier.cuh"
#include "train_core.cuh"

namespace {

constexpr int kGradChunk = 1024;  // gradient-product K values per split
constexpr int kUpdateThreads = 1024;
constexpr int kMaxKernels = 512;  // K10's gate bounds s by 512

// dall[i, a*cpx + p] = dstk[p, a*s + i]
__global__ void dall_from_dstk_kernel(const float* __restrict__ dstk,
                                      float* __restrict__ dall, int cpx,
                                      int r, int s) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  const int total = cpx * r * s;
  if (e >= total) return;
  const int rs = r * s;
  const int p = e / rs;
  const int col = e - p * rs;
  const int a = col / s;
  const int i = col - a * s;
  dall[(static_cast<int64_t>(i) * r + a) * cpx + p] = dstk[e];
}

// sum_{b, y, x} codes[b, j, y, x]^2 over one block, in a fixed order.
__device__ float code_square_sum(const float* __restrict__ codes, int b,
                                 int s, int chw, int j, float* scratch) {
  const int count = b * chw;
  float acc = 0.0f;
  for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
    const int bb = idx / chw;
    const float c =
        codes[(static_cast<int64_t>(bb) * s + j) * chw + (idx - bb * chw)];
    acc = fmaf(c, c, acc);
  }
  return block_sum(acc, scratch);
}

// h[j] = 0.99 h[j] + (sum_{b, y, x} codes[b, j, y, x]^2 / b) / 100, one
// block per kernel j.
__global__ void __launch_bounds__(kRowThreads)
    conv_hessian_ema_kernel(const float* __restrict__ codes,
                            float* __restrict__ h, int b, int s, int chw) {
  __shared__ float scratch[33];
  const float total = code_square_sum(codes, b, s, chw, blockIdx.x, scratch);
  if (threadIdx.x == 0)
    h[blockIdx.x] = __fadd_rn(__fmul_rn(0.99f, h[blockIdx.x]),
                              (total / static_cast<float>(b)) / 100.0f);
}

// stat[j] = sum_{b, y, x} codes[b, j, y, x]^2 (K13), the sum of the EMA
// above in the same order.
__global__ void __launch_bounds__(kRowThreads)
    conv_code_stat_kernel(const float* __restrict__ codes,
                          float* __restrict__ stat, int b, int s, int chw) {
  __shared__ float scratch[33];
  const float total = code_square_sum(codes, b, s, chw, blockIdx.x, scratch);
  if (threadIdx.x == 0) stat[blockIdx.x] = total;
}

// codes[b, j, Y - a_y, X - a_x] for the stack column col = a*s + j at the
// block position pos = Y*bw + X of sample b, zero outside the codes.
__device__ __forceinline__ float stacked_code(const float* __restrict__ codes,
                                              int col, int s, int ax, int bb,
                                              int pos, int bw, int code_h,
                                              int code_w) {
  const int a = col / s;
  const int j = col - a * s;
  const int by = pos / bw;
  const int y = by - a / ax;
  const int x = (pos - by * bw) - a % ax;
  if (y < 0 || y >= code_h || x < 0 || x >= code_w) return 0.0f;
  return codes[((static_cast<int64_t>(bb) * s + j) * code_h + y) * code_w + x];
}

// partial[split, p, a*s + j] = sum over the split's chunk of k = (b, Y, X)
// of resid[b, p, Y, X] * codes[b, j, Y - a_y, X - a_x], a = a_y*ax + a_x
// (codes outside their range are zero): the stride-block kernel gradient
// of pallas_conv_direct.dictionary_gradient_from_block_stats, unaveraged.
__global__ void __launch_bounds__(kGemmThreads)
    block_grad_partial_kernel(const float* __restrict__ resid,
                              const float* __restrict__ codes,
                              float* __restrict__ partial, int cpx, int s,
                              int ax, int r, int bh, int bw, int code_h,
                              int code_w, int64_t kdim) {
  __shared__ float As[kTile][kTile + 1];  // As[k][p]
  __shared__ float Bs[kTile][kTile + 1];  // Bs[k][column]
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int rs = r * s;
  const int blocks = bh * bw;
  const int64_t k_lo = static_cast<int64_t>(blockIdx.z) * kGradChunk;
  const int64_t k_hi = k_lo + kGradChunk < kdim ? k_lo + kGradChunk : kdim;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int64_t k0 = k_lo; k0 < k_hi; k0 += kTile) {
    // neighbouring threads take neighbouring k: neighbouring pixels
    for (int idx = tid; idx < kTile * kTile; idx += kGemmThreads) {
      const int hi = idx >> 5;
      const int lo = idx & 31;
      const int64_t k = k0 + lo;
      float av = 0.0f, bv = 0.0f;
      if (k < k_hi) {
        const int bb = static_cast<int>(k / blocks);
        const int pos = static_cast<int>(k - static_cast<int64_t>(bb) * blocks);
        const int p = i0 + hi;
        if (p < cpx)
          av = resid[(static_cast<int64_t>(bb) * cpx + p) * blocks + pos];
        const int col = j0 + hi;
        if (col < rs)
          bv = stacked_code(codes, col, s, ax, bb, pos, bw, code_h, code_w);
      }
      As[lo][hi] = av;
      Bs[lo][hi] = bv;
    }
    __syncthreads();
    for (int kk = 0; kk < kTile; ++kk) {
      const float bv = Bs[kk][tx];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = fmaf(As[kk][ty * 4 + q], bv, acc[q]);
    }
    __syncthreads();
  }
  const int col = j0 + tx;
  if (col >= rs) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int p = i0 + ty * 4 + q;
    if (p < cpx)
      partial[(static_cast<int64_t>(blockIdx.z) * cpx + p) * rs + col] =
          acc[q];
  }
}

// partial[split, a*s + i, a'*s + j] = sum over the split's chunk of
// k = (b, Y, X) of m[Y, X] * stack[a*s + i] * stack[a'*s + j], stack the
// codes of block_grad_partial_kernel: K13's gram-form C_m, unaveraged.
__global__ void __launch_bounds__(kGemmThreads)
    block_cm_partial_kernel(const float* __restrict__ codes,
                            const float* __restrict__ m,
                            float* __restrict__ partial, int s, int ax, int r,
                            int bh, int bw, int code_h, int code_w,
                            int64_t kdim) {
  __shared__ float As[kTile][kTile + 1];  // As[k][row]
  __shared__ float Bs[kTile][kTile + 1];  // Bs[k][column]
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int rs = r * s;
  const int blocks = bh * bw;
  const int64_t k_lo = static_cast<int64_t>(blockIdx.z) * kGradChunk;
  const int64_t k_hi = k_lo + kGradChunk < kdim ? k_lo + kGradChunk : kdim;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int64_t k0 = k_lo; k0 < k_hi; k0 += kTile) {
    for (int idx = tid; idx < kTile * kTile; idx += kGemmThreads) {
      const int hi = idx >> 5;
      const int lo = idx & 31;
      const int64_t k = k0 + lo;
      float av = 0.0f, bv = 0.0f;
      if (k < k_hi) {
        const int bb = static_cast<int>(k / blocks);
        const int pos = static_cast<int>(k - static_cast<int64_t>(bb) * blocks);
        const int row = i0 + hi;
        if (row < rs)
          av = __fmul_rn(m[pos], stacked_code(codes, row, s, ax, bb, pos, bw,
                                              code_h, code_w));
        const int col = j0 + hi;
        if (col < rs)
          bv = stacked_code(codes, col, s, ax, bb, pos, bw, code_h, code_w);
      }
      As[lo][hi] = av;
      Bs[lo][hi] = bv;
    }
    __syncthreads();
    for (int kk = 0; kk < kTile; ++kk) {
      const float bv = Bs[kk][tx];
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] = fmaf(As[kk][ty * 4 + q], bv, acc[q]);
    }
    __syncthreads();
  }
  const int col = j0 + tx;
  if (col >= rs) return;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int row = i0 + ty * 4 + q;
    if (row < rs)
      partial[(static_cast<int64_t>(blockIdx.z) * rs + row) * rs + col] =
          acc[q];
  }
}

// grad[e] = (sum over splits, in order, of partial[split, e]) / b (K13
// passes b = 1: the sum itself)
__global__ void grad_reduce_kernel(const float* __restrict__ partial,
                                   float* __restrict__ grad, int splits,
                                   int count, float b) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  float acc = 0.0f;
  for (int sp = 0; sp < splits; ++sp)
    acc = __fadd_rn(acc, partial[static_cast<int64_t>(sp) * count + e]);
  grad[e] = acc / b;
}

// dst[e] = src[e] / b (K17: a summed statistic over the global batch)
__global__ void divide_kernel(const float* __restrict__ src,
                              float* __restrict__ dst, int count, float b) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < count) dst[e] = src[e] / b;
}

// One update iteration on the packed kernels, one block: the support
// projection, the Hessian scaling, the Frobenius rescale, the step and
// the per-kernel renormalization, in that order.
__global__ void __launch_bounds__(kUpdateThreads)
    conv_update_kernel(float* __restrict__ dstk, float* __restrict__ grad,
                       const float* __restrict__ supp,
                       const float* __restrict__ h, int cpx, int r, int s,
                       float step, float lowest, int cheap_quad, int renorm) {
  __shared__ float scratch[33];
  __shared__ float norms[kMaxKernels];
  const int rs = r * s;
  const int total = cpx * rs;
  float gpart = 0.0f, dpart = 0.0f;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    float g = grad[e];
    if (supp != nullptr) g = __fmul_rn(g, supp[e]);
    if (cheap_quad) g = g / __fadd_rn(h[(e % rs) % s], lowest);
    grad[e] = g;
    gpart = fmaf(g, g, gpart);
    const float d = dstk[e];
    dpart = fmaf(d, d, dpart);
  }
  const float gn = sqrtf(block_sum(gpart, scratch));
  const float dn = sqrtf(block_sum(dpart, scratch));
  const float ratio = dn / fmaxf(gn, 1e-30f);
  for (int e = threadIdx.x; e < total; e += blockDim.x)
    dstk[e] = __fsub_rn(dstk[e], __fmul_rn(step, __fmul_rn(grad[e], ratio)));
  if (!renorm) return;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int j = warp; j < s; j += warps) {
    float acc = 0.0f;
    for (int t = lane; t < cpx * r; t += 32) {
      const float d = dstk[static_cast<int64_t>(t) * s + j];
      acc = fmaf(d, d, acc);
    }
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) norms[j] = fmaxf(sqrtf(acc), 1e-30f);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < total; e += blockDim.x)
    dstk[e] = dstk[e] / norms[(e % rs) % s];
}

// What a conv step needs to run, fixed for a segment (K12) or a shard's
// step (K13): sizes, the solve's scratch and the gathered products.
struct ConvStep {
  int b, s, cpx, r, ax, bh, bw, code_h, code_w, blocks, chw, weights, splits;
  int num_iters, fista, power_iters;
  int64_t kdim;
  size_t code_bytes;
  const float* dstk;
  float *v, *dall, *gram, *eta, *z, *old, *partial;
  GemmArgs synth, resid, anal, corr;
  ConvTierWeights planes;  // the solve's tier and its split weights
};

// Fill *st; cudaErrorInvalidValue for sizes the kernels do not take.
// tier and tier_scratch: the solve's tier and the vtc_conv_tier_words()
// words of its split weights (null at 'highest'); route: its tier
// products' route (vtc_conv_direct's).
cudaError_t conv_step_setup(ConvStep* st, const float* dstk, float* v,
                            const float* mblk, int b, int s, int cpx, int ay,
                            int ax, int bh, int bw, float lam, int num_iters,
                            int fista, int mode, int power_iters, float* dall,
                            float* gram, float* eta, float* img, float* corr,
                            float* z, float* old, float* partial, int tier,
                            void* tier_scratch, int route) {
  const int code_h = bh - (ay - 1), code_w = bw - (ax - 1);
  if (b < 1 || s < 1 || s > kMaxKernels || cpx < 1 || ay < 1 || ax < 1 ||
      code_h < 1 || code_w < 1 || num_iters < 0 || power_iters < 0 ||
      mode < 0 || mode > 3 || tier < 0 || tier > kTierBf16x5 ||
      (tier != kTierHighest && tier_scratch == nullptr) ||
      route < kConvRouteAuto || route > kConvRouteWindow)
    return cudaErrorInvalidValue;
  ConvStep& t = *st;
  t.b = b;
  t.s = s;
  t.cpx = cpx;
  t.r = ay * ax;
  t.ax = ax;
  t.bh = bh;
  t.bw = bw;
  t.code_h = code_h;
  t.code_w = code_w;
  t.blocks = bh * bw;
  t.chw = code_h * code_w;
  t.weights = cpx * t.r * s;
  t.kdim = static_cast<int64_t>(b) * t.blocks;
  t.splits = static_cast<int>((t.kdim + kGradChunk - 1) / kGradChunk);
  t.num_iters = num_iters;
  t.fista = fista;
  t.power_iters = power_iters;
  t.code_bytes = sizeof(float) * static_cast<size_t>(b) * s * t.chw;
  t.dstk = dstk;
  t.v = v;
  t.dall = dall;
  t.gram = gram;
  t.eta = eta;
  t.z = z;
  t.old = old;
  t.partial = partial;
  t.planes = ConvTierWeights(tier, route, tier_scratch, s, cpx, t.r);

  t.synth = GemmArgs{};
  t.synth.a = dstk;
  t.synth.m = cpx;
  t.synth.k = t.r * s;
  t.synth.src = z;
  t.synth.src_c = s;
  t.synth.src_h = code_h;
  t.synth.src_w = code_w;
  t.synth.off_w = ax;
  t.synth.sign = -1;  // z[B - a]
  t.synth.nb = b;
  t.synth.out_h = bh;
  t.synth.out_w = bw;
  t.synth.epilogue = kMaskStore;
  t.synth.out = img;
  t.synth.mask = mblk;

  t.resid = t.synth;  // mask * S(dstk, codes) - xblk
  t.resid.src = old;
  t.resid.epilogue = kMaskResid;

  t.anal = GemmArgs{};
  t.anal.a = dall;
  t.anal.m = s;
  t.anal.k = t.r * cpx;
  t.anal.src_c = cpx;
  t.anal.src_h = bh;
  t.anal.src_w = bw;
  t.anal.off_w = ax;
  t.anal.sign = 1;  // y[c + a]
  t.anal.nb = b;
  t.anal.out_h = code_h;
  t.anal.out_w = code_w;
  t.anal.src = img;
  t.anal.epilogue = kProx;
  t.anal.out = z;
  t.anal.z_cur = z;
  t.anal.corr = corr;
  t.anal.old = old;
  t.anal.eta = eta;
  t.anal.lam = lam;
  t.anal.fista = fista;
  t.anal.shrink = mode;

  t.corr = t.anal;
  t.corr.epilogue = kStore;
  t.corr.out = corr;
  return power_setup(s);
}

#define VTC_CHECK(...)                \
  do {                                \
    err = (__VA_ARGS__);              \
    if (err != cudaSuccess) return err; \
  } while (0)

// A segment's early stop: the solve's stop arguments (words, eps,
// inv_count; local at a world above one) and the per-step counts, and the
// stop hook that sums local over the ranks.  words null: no stop.
struct StepStop {
  ConvStop base = {};
  int* iters = nullptr;
  SumHook hook = nullptr;
  bool hook_failed = false;

  // step k's solve: its tag and count
  ConvStop of_step(int step) const {
    ConvStop st = base;
    st.tag = static_cast<unsigned>(step) + 1u;
    st.iters = iters + step;
    return st;
  }
};

// The first half of a step, which K12 and K13 share: the flat-kernel Gram
// and the warm power refresh into v and eta, then K10's solve of the image
// blocks xs from zero codes into old.  stop: step's early stop (null or
// null words: none); a failed stop hook sets stop->hook_failed and returns
// cudaErrorUnknown.
cudaError_t refresh_and_solve(const ConvStep& st, const float* xs,
                              cudaStream_t stream, StepStop* stop = nullptr,
                              int step = 0) {
  cudaError_t err;
  dall_from_dstk_kernel<<<(st.weights + 255) / 256, 256, 0, stream>>>(
      st.dstk, st.dall, st.cpx, st.r, st.s);
  VTC_CHECK(cudaGetLastError());
  VTC_CHECK(gemm<false, true>(st.dall, st.dall, nullptr, st.gram, st.s, st.s,
                              st.r * st.cpx, stream));
  VTC_CHECK(power_refresh(st.gram, st.v, st.eta, st.s, st.power_iters,
                          stream));
  VTC_CHECK(st.planes.fold(st.dstk, st.dall, st.s, st.cpx, st.r, stream));
  GemmArgs corr = st.corr;
  corr.src = xs;
  VTC_CHECK(launch_conv_product(st.planes, corr, st.planes.all, st.chw, false,
                                stream));
  VTC_CHECK(cudaMemsetAsync(st.z, 0, st.code_bytes, stream));
  VTC_CHECK(cudaMemsetAsync(st.old, 0, st.code_bytes, stream));
  GemmArgs anal = st.anal, synth = st.synth;
  const bool stopping = stop != nullptr && stop->base.words != nullptr;
  if (stopping) anal.stop = synth.stop = stop->of_step(step);
  float t = 1.0f;
  for (int it = 0; it < st.num_iters; ++it) {
    anal.beta = st.fista ? fista_beta(&t) : 0.0f;
    anal.stop.it = it;
    VTC_CHECK(launch_conv_product(st.planes, synth, st.planes.stk, st.blocks,
                                  stopping, stream));
    VTC_CHECK(launch_conv_product(st.planes, anal, st.planes.all, st.chw,
                                  stopping, stream));
    if (stopping && anal.stop.local != nullptr) {
      if (stop->hook(it) != 0) {
        stop->hook_failed = true;
        return cudaErrorUnknown;
      }
      conv_stop_decide_kernel<<<1, 1, 0, stream>>>(anal.stop, st.eta);
      VTC_CHECK(cudaGetLastError());
    }
  }
  return cudaSuccess;
}

// out (cpx, R*s) = (left (x) code stack) / divisor, left (b, cpx, bh, bw)
// the residual or the image blocks: the split-K product, then the splits
// added in order.
cudaError_t block_gradient(const ConvStep& st, const float* left, float* out,
                           float divisor, cudaStream_t stream) {
  const dim3 grid((st.r * st.s + kTile - 1) / kTile,
                  (st.cpx + kTile - 1) / kTile, st.splits);
  block_grad_partial_kernel<<<grid, kGemmThreads, 0, stream>>>(
      left, st.old, st.partial, st.cpx, st.s, st.ax, st.r, st.bh, st.bw,
      st.code_h, st.code_w, st.kdim);
  cudaError_t err;
  VTC_CHECK(cudaGetLastError());
  grad_reduce_kernel<<<(st.weights + 255) / 256, 256, 0, stream>>>(
      st.partial, out, st.splits, st.weights, divisor);
  return cudaGetLastError();
}

// K13's second half, after refresh_and_solve left the codes in st.old: the
// shard's unaveraged statistics of the image blocks xs.  gram 0: out
// (cpx, R*s) the gradient sum; gram 1: out = bx and cm (R*s, R*s).  stat
// (s,) the code statistic.
cudaError_t shard_stats(const ConvStep& st, const float* xs, const float* mblk,
                        int gram, float* img, float* out, float* cm,
                        float* stat, cudaStream_t stream) {
  cudaError_t err;
  if (gram) {
    VTC_CHECK(block_gradient(st, xs, out, 1.0f, stream));
    const int rs = st.r * st.s;
    const dim3 grid((rs + kTile - 1) / kTile, (rs + kTile - 1) / kTile,
                    st.splits);
    block_cm_partial_kernel<<<grid, kGemmThreads, 0, stream>>>(
        st.old, mblk, st.partial, st.s, st.ax, st.r, st.bh, st.bw, st.code_h,
        st.code_w, st.kdim);
    VTC_CHECK(cudaGetLastError());
    grad_reduce_kernel<<<(rs * rs + 255) / 256, 256, 0, stream>>>(
        st.partial, cm, st.splits, rs * rs, 1.0f);
  } else {
    GemmArgs resid = st.resid;
    resid.extra = xs;
    VTC_CHECK(launch_gather_gemm(resid, st.blocks, stream));
    VTC_CHECK(block_gradient(st, img, out, 1.0f, stream));
  }
  VTC_CHECK(cudaGetLastError());
  conv_code_stat_kernel<<<st.s, kRowThreads, 0, stream>>>(st.old, stat, st.b,
                                                          st.s, st.chw);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The gradient product's K values per split: the wrapper sizes its
// partial-sum scratch with it.
int vtc_conv_train_chunk() { return kGradChunk; }

// k conv train steps on one stream, every launch enqueued before
// returning.
//
// In place: dstk (cpx, R*s), h (s,), v (s,).  xblk (k, b, cpx, bh, bw)
// the masked image blocks of every step; mblk (cpx, bh, bw) the block
// mask; supp (cpx, R*s) the real-support mask, or null when the kernels
// are stride multiples.  Scratch: dall (s, R*cpx), gram (s, s), eta (1,),
// img (b, cpx, bh, bw), corr and z (b, s, ch, cw), partial (splits, cpx,
// R*s) with splits = ceil(b*bh*bw / vtc_conv_train_chunk()), grad
// (cpx, R*s).  old (b, s, ch, cw) holds the last step's codes on return.
// mode: the shrink mode (conv_gemm.cuh); update: 0 steepest, 1 cheap
// quadratic.  stop_words: null for solves without the stop, else the
// zeroed vtc_conv_stop_words() array of the early stop at eps over a mean
// of inv_count (1 / (b s code_h code_w)), iters (k,) receiving each
// step's count.  tier / tier_scratch / route: the solves' tier, the
// vtc_conv_tier_words() words of the split weights (null at 'highest')
// and the route of their tier products (vtc_conv_direct's).
// Returns the first CUDA error code (0 on success).
int vtc_conv_train_segment(float* dstk, float* h, float* v, const float* xblk,
                           const float* mblk, const float* supp, int k, int b,
                           int s, int cpx, int ay, int ax, int bh, int bw,
                           float lam, int num_iters, float upd_step,
                           int upd_num_iters, float lowest, int fista,
                           int mode, int update, int renorm, int power_iters,
                           float* dall, float* gram, float* eta, float* img,
                           float* corr, float* z, float* old, float* partial,
                           float* grad, float eps, float inv_count,
                           unsigned long long* stop_words, int* iters,
                           int tier, void* tier_scratch, int route,
                           void* stream_ptr) {
  if (k < 0 || upd_num_iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  StepStop stop;
  stop.base.words = stop_words;
  stop.base.eps = eps;
  stop.base.inv_count = inv_count;
  stop.iters = iters;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  ConvStep st;
  cudaError_t err = conv_step_setup(
      &st, dstk, v, mblk, b, s, cpx, ay, ax, bh, bw, lam, num_iters, fista,
      mode, power_iters, dall, gram, eta, img, corr, z, old, partial, tier,
      tier_scratch, route);
  if (err != cudaSuccess) return static_cast<int>(err);
  GemmArgs resid = st.resid;
  const int64_t step_floats = static_cast<int64_t>(b) * cpx * st.blocks;
  for (int step = 0; step < k; ++step) {
    const float* xs = xblk + step * step_floats;
    err = refresh_and_solve(st, xs, stream, &stop, step);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (update == 1) {
      conv_hessian_ema_kernel<<<s, kRowThreads, 0, stream>>>(old, h, b, s,
                                                             st.chw);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    resid.extra = xs;
    for (int u = 0; u < upd_num_iters; ++u) {
      err = launch_gather_gemm(resid, st.blocks, stream);
      if (err == cudaSuccess)
        err = block_gradient(st, img, grad, static_cast<float>(b), stream);
      if (err == cudaSuccess) {
        conv_update_kernel<<<1, kUpdateThreads, 0, stream>>>(
            dstk, grad, supp, h, cpx, st.r, s, upd_step, lowest, update == 1,
            renorm);
        err = cudaGetLastError();
      }
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  return 0;
}

// K13, one shard's step: vtc_conv_train_segment's refresh and solve on the
// shard's image blocks xblk (b, cpx, bh, bw), then its unaveraged
// statistics.  dstk is read only; v (s,) is refreshed in place and eta
// (1,) receives the stepsize; codes (b, s, ch, cw) land in old.
//
// gram_stats 0: out (cpx, R*s) receives the gradient sum
//   (mask * S(dstk, codes) - xblk) (x) stack; cm is unused.
// gram_stats 1: out receives bx = xblk (x) stack and cm (R*s, R*s) the
//   masked code Gram; the caller guarantees a stride-block-uniform mask.
// stat (s,) receives sum_{b, positions} codes^2.  Scratch as
// vtc_conv_train_segment's; partial holds (splits, max(cpx, R*s), R*s)
// in the gram form.  tier / tier_scratch / route: the solve's tier, the
// vtc_conv_tier_words() words of the split weights (null at 'highest')
// and the route of its tier products (vtc_conv_direct's).
// Returns the first CUDA error code (0 on success).
int vtc_conv_solve_stats(const float* dstk, float* v, const float* xblk,
                         const float* mblk, int b, int s, int cpx, int ay,
                         int ax, int bh, int bw, float lam, int num_iters,
                         int fista, int mode, int power_iters, int gram_stats,
                         float* dall, float* gram, float* eta, float* img,
                         float* corr, float* z, float* old, float* partial,
                         float* out, float* cm, float* stat, int tier,
                         void* tier_scratch, int route, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  ConvStep st;
  cudaError_t err = conv_step_setup(
      &st, dstk, v, mblk, b, s, cpx, ay, ax, bh, bw, lam, num_iters, fista,
      mode, power_iters, dall, gram, eta, img, corr, z, old, partial, tier,
      tier_scratch, route);
  if (err == cudaSuccess) err = refresh_and_solve(st, xblk, stream);
  if (err == cudaSuccess)
    err = shard_stats(st, xblk, mblk, gram_stats, img, out, cm, stat, stream);
  return static_cast<int>(err);
}

// K17, one rank's whole data-parallel segment: k steps, each K13's refresh,
// solve and shard statistics, then the statistics summed over the ranks,
// then the replicated update from the global statistics, every launch
// enqueued from this loop on one stream.
//
// In place: dstk (cpx, R*s), h (s,), v (s,), replicated.  xblk (k, b, cpx,
// bh, bw) this rank's image blocks of every step (b its shard); mblk, supp
// and the scratch as vtc_conv_train_segment's, partial (splits, max(cpx,
// R*s), R*s) in the gram form.  comm holds the statistics the ranks sum,
// packed: gram 0 [grad_sum (cpx*R*s) | stat (s)], gram 1 [cm ((R*s)^2) |
// bx (cpx*R*s) | stat (s)].  sum_hook(step), when given, sums comm over the
// ranks in place on the stream's order (a torch.distributed all-reduce) and
// returns 0; a null hook is a world of one.  global_b: the batch summed over
// the ranks.  gram 1 updates from (dstk cm - bx) / global_b at every update
// iteration; gram 0 from grad_sum / global_b (exact at the solve dictionary,
// so one update iteration).  old holds this rank's last codes on return.
// stop_words, eps, inv_count and iters: the early stop, as
// vtc_conv_train_segment's, inv_count over the global batch; at a world
// above one stop_local (1,) takes the rank's sum of |codes - old| each
// iteration and stop_hook(it) sums it over the ranks in place (a null
// hook: a world of one, where the kernel decides on its own sum).
// tier / tier_scratch / route: the solves' tier, the vtc_conv_tier_words()
// words of the split weights (null at 'highest') and the route of their
// tier products (vtc_conv_direct's).
// Returns the first CUDA error code (0 on success), or kSumHookFailed.
int vtc_conv_dp_train_segment(
    float* dstk, float* h, float* v, const float* xblk, const float* mblk,
    const float* supp, int k, int b, int s, int cpx, int ay, int ax, int bh,
    int bw, float lam, int num_iters, float upd_step, int upd_num_iters,
    float lowest, int fista, int mode, int update, int renorm,
    int power_iters, int gram, float global_b, float* dall, float* gram_mat,
    float* eta, float* img, float* corr, float* z, float* old,
    float* partial, float* grad, float* comm, SumHook sum_hook, float eps,
    float inv_count, unsigned long long* stop_words, int* iters,
    float* stop_local, SumHook stop_hook, int tier, void* tier_scratch,
    int route, void* stream_ptr) {
  if (k < 0 || upd_num_iters < 0 || !(global_b >= 1.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  StepStop stop;
  stop.base.words = stop_words;
  stop.base.eps = eps;
  stop.base.inv_count = inv_count;
  stop.base.local = stop_hook != nullptr ? stop_local : nullptr;
  stop.iters = iters;
  stop.hook = stop_hook;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  ConvStep st;
  cudaError_t err = conv_step_setup(
      &st, dstk, v, mblk, b, s, cpx, ay, ax, bh, bw, lam, num_iters, fista,
      mode, power_iters, dall, gram_mat, eta, img, corr, z, old, partial,
      tier, tier_scratch, route);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rs = st.r * s;
  float* cm = gram ? comm : nullptr;
  float* out = gram ? comm + static_cast<int64_t>(rs) * rs : comm;
  float* stat = out + st.weights;
  const int64_t step_floats = static_cast<int64_t>(b) * cpx * st.blocks;
  const int blocks = (st.weights + 255) / 256;
  for (int step = 0; step < k; ++step) {
    const float* xs = xblk + step * step_floats;
    err = refresh_and_solve(st, xs, stream, &stop, step);
    if (stop.hook_failed) return kSumHookFailed;
    if (err == cudaSuccess)
      err = shard_stats(st, xs, mblk, gram, img, out, cm, stat, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (sum_hook != nullptr && sum_hook(step) != 0) return kSumHookFailed;
    if (update == 1) err = hessian_from_stat(stat, h, s, global_b, stream);
    for (int u = 0; u < upd_num_iters && err == cudaSuccess; ++u) {
      if (gram) {
        err = gemm<false, false>(dstk, cm, out, grad, cpx, rs, rs, stream);
        if (err == cudaSuccess)
          divide_kernel<<<blocks, 256, 0, stream>>>(grad, grad, st.weights,
                                                    global_b);
      } else {
        divide_kernel<<<blocks, 256, 0, stream>>>(out, grad, st.weights,
                                                  global_b);
      }
      if (err == cudaSuccess) err = cudaGetLastError();
      if (err == cudaSuccess) {
        conv_update_kernel<<<1, kUpdateThreads, 0, stream>>>(
            dstk, grad, supp, h, cpx, st.r, s, upd_step, lowest, update == 1,
            renorm);
        err = cudaGetLastError();
      }
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // extern "C"

#undef VTC_CHECK
