// Fused ICA train steps for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel K8: vtc_tpu/ops/pallas_ica_train.py,
// fused_ica_train_segment_pallas (:280) with its kernel _make_ica_kernel
// (:101).  Same contract: for each of the k batches (b, n) of a segment,
// with the square dictionary D (n, n) and the tracked inverse X carried
// from step to step,
//
//   refine_iters times   X = X (2I - D X)          (Newton-Schulz)
//   r = max |D X - I|
//   if r > boost_tol:    two more refreshes, r recomputed
//   r_max = max(r_max, r)                          (NaN propagates)
//   codes = batch X;  S = codes^T sign(codes);  M = S / b - I
//   upd_num_iters times  D = D + eta M D
//
// r_max, the largest post-refinement residual of the segment, is what the
// trainer's divergence guard reads (training/ica.py): a step whose
// refinement diverged must show, so both maxima propagate NaN as
// jnp.maximum does (CUDA's fmaxf drops it), and the boost test is
// NaN > tol, false, as in the TPU kernel.  The boost is decided on the
// device, so the host never waits.  sign(0) is 0.
//
// Two routes give the same bits (the C entries' route argument; the
// wrappers' private route=, ops/fused_ica_train.ROUTES):
//
// * persistent (the default, ica_segment.cuh): the whole segment is one
//   cooperative launch of ica_segment_kernel, a resident CTA per slot of
//   the card walking every step's phases with a grid barrier between
//   dependent ones (about 9 a step at refine_iters 3), the sign and the
//   natural gradient formed as the operands land in shared memory.
// * steps: the per-step kernels below, enqueued by one C loop per
//   segment on one stream (refine_and_stat, natural_gradient_kernel and
//   the update's gemm and axpy_kernel: about 20 dependent launches a
//   step, each product train_core.cuh's 32 x 32 tile kernel on 64 blocks
//   at n = 256).  The boost's two refreshes and second residual are
//   launched every step and do nothing unless the flag the first residual
//   wrote is set.  It is the persistent route's bitwise reference and
//   K9's route.
//
// Layout.  D and X (256 KB each at n = 256) with the products' operands
// exceed one block's 227 KB, and Hopper blocks run in no order, so the
// TPU kernel's VMEM residency across grid steps becomes either one
// persistent grid whose CTAs meet at grid barriers (persistent) or
// per-step kernels (steps); D, X, the flag and r_max stay in device
// memory.  X ping-pongs between two buffers (the boost's two refreshes
// leave it where it was), and on the persistent route so does D, which
// other CTAs still read while a tile of D' is written; the entries copy
// each back into the caller's buffer at the end of the segment.
// chip_smoke.py phase 40 holds the two routes bitwise equal.
//
// What bounds it on this card.  At n = 256, b = 250, refine_iters 3, a
// step is (4*3 + 2 + 2) n^3 + 4 b n^2 = 0.334 GFLOP, 5 us at the fp32 SIMT
// peak of 67 TFLOP/s; every operand fits the 50 MB L2.  The steps route
// is bound by the latency of about 20 dependent launches; the persistent
// route by its grid barriers' latency and the issue rate of each phase's
// 128 small products, not by FMA throughput.  Every product is IEEE fp32
// FMA (no TF32, no library).
//
// Also here, K9: the per-shard step of the data-parallel composition.
// Replaces vtc_tpu/ops/pallas_ica_train.py, ica_solve_stats_pallas (:226,
// kernel _make_ica_stats_kernel :189): a K8 step's refreshes, residual and
// boost (refine_and_stat below, the steps route's first half), the codes
// of one shard of the batch and its unaveraged statistic codes^T
// sign(codes); no update, which the caller runs replicated from the
// statistic summed over the shards.  The residual stays on the device, as
// r_max does in K8.  It takes the steps route, bound by the latency of its
// dependent launches.
//
// Also here, K18: a rank's whole data-parallel ICA segment.  Replaces
// vtc_tpu/ops/pallas_ica_train.py, fused_ica_dp_train_segment_pallas
// (:355, kernel _make_ica_kernel with num_devices > 1, :101).  Per step,
// K9's step on the rank's shard (the refreshes of the replicated inverse,
// the guard residual with the device-decided boost into the running
// r_max, the shard's codes and its statistic codes^T sign(codes)), then
// the host hook that sums the (n, n) statistic over the ranks
// (train_core.cuh; the TPU kernel all-reduces it in-kernel), then K8's
// update from the global statistic: M = stat / global_b - I and
// upd_num_iters x D += eta M D.  No hook at a world of one: on the
// persistent route the segment is then one launch, K8's kernel with
// global_b.  At a world above one the persistent route launches the
// kernel twice a step, its front (to the statistic, into comm) and its
// back (the update from the summed comm), the hook between them; the
// steps route keeps one C loop per segment, K17's layout.  The residual
// depends on the replicated D and X alone, so r_max is the same on every
// rank.
//
// The tiers.  Every C entry takes the tier of the refreshes and the codes
// (tier_codes.cuh; vtc_tpu's _make_ns_dot, ica_segment.cuh says what each
// computes): the persistent route launches the segment kernel's build for
// it, and refine_and_stat launches ica_segment.cuh's tier tile for the
// refreshes and the codes (ica_tier_gemm), one CTA a tile, in place of
// train_core.cuh's float32 gemm; the residual, the statistic and the
// update stay float32 on both routes.  So the two routes give the same
// bits at every tier.
#include "ica_segment.cuh"
#include "tier_codes.cuh"
#include "train_core.cuh"

namespace {

constexpr int kReduceThreads = 1024;

// max that keeps NaN, as jnp.maximum / torch.maximum do
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// One block: r = max |c| over count entries, NaN kept.  With boost given
// (the first residual of a step), *boost = r > boost_tol and r enters
// r_max unless the boost fires; the second residual (run_if = boost)
// enters r_max.
__global__ void __launch_bounds__(kReduceThreads)
    residual_kernel(const float* __restrict__ c, int count,
                    float* __restrict__ r_max, int* __restrict__ boost,
                    float boost_tol, const int* __restrict__ run_if) {
  if (run_if != nullptr && *run_if == 0) return;
  __shared__ float part[kReduceThreads];
  float m = 0.0f;
  for (int i = threadIdx.x; i < count; i += blockDim.x)
    m = nan_max(m, fabsf(c[i]));
  part[threadIdx.x] = m;
  __syncthreads();
  for (int off = blockDim.x / 2; off > 0; off >>= 1) {
    if (threadIdx.x < off)
      part[threadIdx.x] = nan_max(part[threadIdx.x], part[threadIdx.x + off]);
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const float r = part[0];
  const bool boosted = boost != nullptr && r > boost_tol;
  if (boost != nullptr) *boost = boosted ? 1 : 0;
  if (!boosted) *r_max = nan_max(*r_max, r);
}

// sgn = sign(c): -1, 0 or 1 (NaN stays NaN)
__global__ void sign_kernel(const float* __restrict__ c,
                            float* __restrict__ sgn, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  const float x = c[i];
  sgn[i] = x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : (x == 0.0f ? 0.0f : x));
}

// m = stat / b - I
__global__ void natural_gradient_kernel(const float* __restrict__ stat,
                                        float* __restrict__ m, int n,
                                        float b) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n * n) return;
  m[e] = __fsub_rn(stat[e] / b, (e / n == e % n) ? 1.0f : 0.0f);
}

// d = d + eta * p
__global__ void axpy_kernel(float* __restrict__ d,
                            const float* __restrict__ p, float eta,
                            int count) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= count) return;
  d[e] = __fadd_rn(d[e], __fmul_rn(eta, p[e]));
}

#define VTC_CHECK(...)                                    \
  do {                                                    \
    err = (__VA_ARGS__);                                  \
    if (err != cudaSuccess) return static_cast<int>(err); \
  } while (0)

// The tracked inverse ping-pongs between two (n, n) buffers: cur holds it.
struct InverseBuffers {
  float* cur;
  float* other;
};

// A tier code the entries take.
bool valid_tier(int tier) {
  return tier == kTierHighest || tier == kTierBf16 || tier == kTierBf16x3 ||
         tier == kTierBf16x5;
}

// The first half of a step, which K8 and K9 share: refine_iters
// Newton-Schulz refreshes of X, the residual max |D X - I| into r_max
// (with the device-decided boost of two more refreshes and a second
// residual when has_boost), codes = batch X, sgn = sign(codes) and
// stat = codes^T sgn, unaveraged; the refreshes and the codes at the
// tier.  The boost's two refreshes leave X in the buffer it was in.
// Returns the first CUDA error code (0 on success).
int refine_and_stat(const float* d, InverseBuffers* x, float* r_max,
                    const float* xs, const float* eye, const float* eye2,
                    int b, int n, int refine_iters, int has_boost,
                    float boost_tol, float* e, float* codes, float* sgn,
                    float* stat, int* boost, int tier, cudaStream_t stream) {
  const int nn = n * n;
  const bool tiered = tier != kTierHighest;
  cudaError_t err;
  // one refresh, X <- X (2I - D X), optionally conditional on *run_if
  auto refresh = [&](const int* run_if) -> cudaError_t {
    cudaError_t e1 =
        tiered ? ica_tier_gemm(tier, true, d, x->cur, e, n, n, n, run_if,
                               stream)
               : gemm<false, false, true>(d, x->cur, eye2, e, n, n, n, stream,
                                          run_if);
    if (e1 != cudaSuccess) return e1;
    e1 = tiered ? ica_tier_gemm(tier, false, x->cur, e, x->other, n, n, n,
                                run_if, stream)
                : gemm<false, false>(x->cur, e, nullptr, x->other, n, n, n,
                                     stream, run_if);
    float* t = x->cur;
    x->cur = x->other;
    x->other = t;
    return e1;
  };
  for (int it = 0; it < refine_iters; ++it) VTC_CHECK(refresh(nullptr));
  VTC_CHECK(gemm<false, false>(d, x->cur, eye, e, n, n, n, stream));
  residual_kernel<<<1, kReduceThreads, 0, stream>>>(
      e, nn, r_max, has_boost ? boost : nullptr, boost_tol, nullptr);
  VTC_CHECK(cudaGetLastError());
  if (has_boost) {
    VTC_CHECK(refresh(boost));
    VTC_CHECK(refresh(boost));
    VTC_CHECK(gemm<false, false>(d, x->cur, eye, e, n, n, n, stream, boost));
    residual_kernel<<<1, kReduceThreads, 0, stream>>>(e, nn, r_max, nullptr,
                                                      0.0f, boost);
    VTC_CHECK(cudaGetLastError());
  }
  VTC_CHECK(tiered ? ica_tier_gemm(tier, false, xs, x->cur, codes, b, n, n,
                                   nullptr, stream)
                   : gemm<false, false>(xs, x->cur, nullptr, codes, b, n, n,
                                        stream));
  sign_kernel<<<(b * n + 255) / 256, 256, 0, stream>>>(codes, sgn, b * n);
  VTC_CHECK(cudaGetLastError());
  VTC_CHECK(gemm<true, false>(codes, sgn, nullptr, stat, n, n, b, stream));
  return 0;
}

}  // namespace

extern "C" {

// The steps route of K8: k ICA train steps on one stream, every launch
// enqueued before returning.
//
// In place: d (n, n), x (n, n) the tracked inverse, r_max (1,) the running
// residual maximum (the caller zeroes it).  batches (k, b, n); eye and
// eye2 (n, n) hold I and 2I.  Scratch: x_alt and e (n, n), codes and sgn
// (b, n), stat, m and p (n, n), boost (1,) int.  has_boost: run the
// residual-adaptive boost at boost_tol.  tier: of the refreshes and the
// codes.  Returns the first CUDA error code (0 on success).
int vtc_ica_train_segment(float* d, float* x, float* r_max,
                          const float* batches, const float* eye,
                          const float* eye2, int k, int b, int n,
                          float stepsize, int refine_iters, int upd_num_iters,
                          int has_boost, float boost_tol, float* x_alt,
                          float* e, float* codes, float* sgn, float* stat,
                          float* m, float* p, int* boost, int tier,
                          void* stream_ptr) {
  if (k < 0 || b < 1 || n < 1 || refine_iters < 0 || upd_num_iters < 0 ||
      !valid_tier(tier))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nn = n * n;
  const float fb = static_cast<float>(b);
  InverseBuffers inv{x, x_alt};
  cudaError_t err;
  for (int step = 0; step < k; ++step) {
    const float* xs = batches + static_cast<int64_t>(step) * b * n;
    const int front_err = refine_and_stat(
        d, &inv, r_max, xs, eye, eye2, b, n, refine_iters, has_boost,
        boost_tol, e, codes, sgn, stat, boost, tier, stream);
    if (front_err != 0) return front_err;
    natural_gradient_kernel<<<(nn + 255) / 256, 256, 0, stream>>>(stat, m, n,
                                                                  fb);
    VTC_CHECK(cudaGetLastError());
    for (int u = 0; u < upd_num_iters; ++u) {
      VTC_CHECK(gemm<false, false>(m, d, nullptr, p, n, n, n, stream));
      axpy_kernel<<<(nn + 255) / 256, 256, 0, stream>>>(d, p, stepsize, nn);
      VTC_CHECK(cudaGetLastError());
    }
  }
  if (inv.cur != x)
    VTC_CHECK(cudaMemcpyAsync(x, inv.cur, sizeof(float) * nn,
                              cudaMemcpyDeviceToDevice, stream));
  return 0;
}

// K9, one shard's ICA step: the refreshes, residual and boost of
// vtc_ica_train_segment, then codes = batch X of the shard batch (b, n)
// and its unaveraged statistic stat = codes^T sign(codes) (n, n).  No
// update: the caller sums stat over the shards and updates the replicated
// dictionary.  d is read only; x (n, n) is refreshed in place; res (1,),
// zeroed by the caller, receives the post-refinement residual (NaN kept).
// Scratch: x_alt and e (n, n), codes and sgn (b, n), boost (1,) int.
// tier: of the refreshes and the codes.  Returns the first CUDA error code.
int vtc_ica_solve_stats(const float* d, float* x, float* res,
                        const float* batch, const float* eye,
                        const float* eye2, int b, int n, int refine_iters,
                        int has_boost, float boost_tol, float* x_alt,
                        float* e, float* codes, float* sgn, float* stat,
                        int* boost, int tier, void* stream_ptr) {
  if (b < 1 || n < 1 || refine_iters < 0 || !valid_tier(tier))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  InverseBuffers inv{x, x_alt};
  cudaError_t err;
  const int front_err = refine_and_stat(
      d, &inv, res, batch, eye, eye2, b, n, refine_iters, has_boost,
      boost_tol, e, codes, sgn, stat, boost, tier, stream);
  if (front_err != 0) return front_err;
  if (inv.cur != x)
    VTC_CHECK(cudaMemcpyAsync(x, inv.cur, sizeof(float) * n * n,
                              cudaMemcpyDeviceToDevice, stream));
  return 0;
}

// The steps route of K18: one rank's data-parallel ICA segment of k steps
// on its shard batches (k, b, n).  In place: d (n, n), x (n, n) the
// tracked inverse, r_max (1,) the running residual maximum (the caller
// zeroes it), all replicated.  comm (n, n) receives each step's unaveraged statistic,
// summed over the ranks by sum_hook (when given) before the update;
// global_b is the batch over all ranks.  eye, eye2, the scratch and tier
// as vtc_ica_train_segment's.  Returns the first CUDA error code (0 on
// success), or kSumHookFailed.
int vtc_ica_dp_train_segment(float* d, float* x, float* r_max,
                             const float* batches, const float* eye,
                             const float* eye2, int k, int b, int n,
                             float stepsize, int refine_iters,
                             int upd_num_iters, int has_boost,
                             float boost_tol, float global_b, float* x_alt,
                             float* e, float* codes, float* sgn, float* m,
                             float* p, int* boost, float* comm,
                             SumHook sum_hook, int tier, void* stream_ptr) {
  if (k < 0 || b < 1 || n < 1 || refine_iters < 0 || upd_num_iters < 0 ||
      !(global_b >= 1.0f) || !valid_tier(tier))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int nn = n * n;
  InverseBuffers inv{x, x_alt};
  cudaError_t err;
  for (int step = 0; step < k; ++step) {
    const float* xs = batches + static_cast<int64_t>(step) * b * n;
    const int front_err = refine_and_stat(
        d, &inv, r_max, xs, eye, eye2, b, n, refine_iters, has_boost,
        boost_tol, e, codes, sgn, comm, boost, tier, stream);
    if (front_err != 0) return front_err;
    if (sum_hook != nullptr && sum_hook(step) != 0) return kSumHookFailed;
    natural_gradient_kernel<<<(nn + 255) / 256, 256, 0, stream>>>(
        comm, m, n, global_b);
    VTC_CHECK(cudaGetLastError());
    for (int u = 0; u < upd_num_iters; ++u) {
      VTC_CHECK(gemm<false, false>(m, d, nullptr, p, n, n, n, stream));
      axpy_kernel<<<(nn + 255) / 256, 256, 0, stream>>>(d, p, stepsize, nn);
      VTC_CHECK(cudaGetLastError());
    }
  }
  if (inv.cur != x)
    VTC_CHECK(cudaMemcpyAsync(x, inv.cur, sizeof(float) * nn,
                              cudaMemcpyDeviceToDevice, stream));
  return 0;
}

// The persistent route's layout: out[0..3] = tile rows, tile columns,
// k-slice depth and threads of ica_segment_kernel (ica_segment.cuh).
void vtc_ica_segment_layout(int* out) {
  out[0] = kSegTileM;
  out[1] = kSegTileN;
  out[2] = kSegSlice;
  out[3] = kSegThreads;
}

// The current device's SM count and ica_segment_kernel's resident CTAs
// per SM, as seg_grid reads them (0 when the device cannot be read).
int vtc_ica_segment_sm_count() { return seg_sm_count(); }
int vtc_ica_segment_blocks_per_sm() { return seg_blocks_per_sm(); }

// CTAs of the persistent route's launches for an (n, n) dictionary and
// batches of b on the current device: the size of its partials scratch.
int vtc_ica_segment_grid(int n, int b) {
  if (n < 1 || b < 1) return 0;
  return seg_grid(n, b, seg_sm_count(), seg_blocks_per_sm());
}

// The persistent route of K8 and K18: k ICA train steps as cooperative
// launches of ica_segment_kernel on one stream, every launch enqueued
// before returning.  In place: d (n, n), x (n, n) the tracked inverse,
// r_max (1,) the running residual maximum (the caller zeroes it).
// batches (k, b, n).  stat_div divides the statistic: b for K8, global_b
// for K18.  Scratch: d_alt, x_alt and e (n, n), codes (b, n), stat (n, n)
// (K18's comm, which sum_hook sums over the ranks; null without sum_hook),
// partials (grid,), barrier (1,) unsigned.  grid: the launches' CTAs, 0 for
// vtc_ica_segment_grid(n, b) (another count is for checks and tools).
// Without sum_hook the segment is one launch; with it each step is a front
// launch (to the statistic), sum_hook(step), then a back launch (the
// update).  tier: the build of the kernel (its refreshes and codes).
// Returns the first CUDA error code (0 on success; a grid the card cannot
// hold at once is refused, cudaErrorCooperativeLaunchTooLarge), or
// kSumHookFailed.
int vtc_ica_persistent_segment(float* d, float* x, float* r_max,
                               const float* batches, int k, int b, int n,
                               float stepsize, int refine_iters,
                               int upd_num_iters, int has_boost,
                               float boost_tol, float stat_div, float* d_alt,
                               float* x_alt, float* e, float* codes,
                               float* stat, float* partials,
                               unsigned* barrier, int grid,
                               SumHook sum_hook, int tier, void* stream_ptr) {
  if (k < 0 || b < 1 || n < 1 || refine_iters < 0 || upd_num_iters < 0 ||
      grid < 0 || !(stat_div >= 1.0f) ||
      (sum_hook != nullptr && stat == nullptr) || !valid_tier(tier))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  if (grid == 0) grid = vtc_ica_segment_grid(n, b);
  SegmentArgs a{d,     d_alt, x,        x_alt, e,      codes,  stat,
                partials, r_max, barrier,  batches,
                k,     b,     n,        refine_iters, upd_num_iters,
                has_boost, kSegFront | kSegBack,
                boost_tol, stepsize, stat_div};
  // where D and X are after a launch of `steps` steps running `parts`
  auto advance = [&](int steps, int parts) {
    if ((parts & kSegFront) && (steps & 1) && (refine_iters & 1)) {
      float* t = a.x;
      a.x = a.x_alt;
      a.x_alt = t;
    }
    if ((parts & kSegBack) && (steps & 1) && (upd_num_iters & 1)) {
      float* t = a.d;
      a.d = a.d_alt;
      a.d_alt = t;
    }
  };
  cudaError_t err;
  if (sum_hook == nullptr) {
    if (k > 0) VTC_CHECK(launch_ica_segment(a, grid, tier, stream));
    advance(k, a.parts);
  } else {
    a.steps = 1;
    for (int step = 0; step < k; ++step) {
      a.batches = batches + static_cast<int64_t>(step) * b * n;
      a.parts = kSegFront;
      VTC_CHECK(launch_ica_segment(a, grid, tier, stream));
      advance(1, a.parts);
      if (sum_hook(step) != 0) return kSumHookFailed;
      a.parts = kSegBack;
      VTC_CHECK(launch_ica_segment(a, grid, tier, stream));
      advance(1, a.parts);
    }
  }
  const size_t bytes = sizeof(float) * n * n;
  if (a.x != x)
    VTC_CHECK(cudaMemcpyAsync(x, a.x, bytes, cudaMemcpyDeviceToDevice,
                              stream));
  if (a.d != d)
    VTC_CHECK(cudaMemcpyAsync(d, a.d, bytes, cudaMemcpyDeviceToDevice,
                              stream));
  return 0;
}

#undef VTC_CHECK

}  // extern "C"
