// Fused fully-connected train steps for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel K2: vtc_tpu/ops/pallas_train_step.py,
// fused_train_segment_pallas (:1442) with its single-tile kernel
// _make_kernel (:396) and its batch-tiled kernel _make_tiled_kernel
// (:728).  Same contract: for each of the k batches X (b, n) of a segment,
// with the dictionary D (s, n), the Hessian-diagonal EMA h (s,) and the
// warm eigenvector v carried from step to step,
//
//   G = D D^T                       power Gram: D^T D when s > n
//   v = v / |v|; power_iters times v = v P / |v P|;  eta = 1 / ((v P) . v)
//   c = X D^T
//   codes = FISTA / ISTA, num_iters iterations (K1's kernel, reused)
//   h = 0.99 h + (sum_b codes^2 * (1/b)) / 100          (cheap quadratic)
//   upd_num_iters times:
//     resid = codes D - X ; grad = codes^T resid * (1/b) [/ (h + lowest)]
//     D = D - step * grad ; rows renormalized, D_i / max(|D_i|, 1e-30)
//
// Layout.  The Pallas kernel keeps D, h and v resident in VMEM across
// the sequential grid cells of one launch.  Hopper blocks run in parallel
// and in no order, and D (256 KB at s = n = 256) with its Gram does not
// fit one block's 227 KB, so this port runs per-step kernels from a host
// loop over the segment: the C entry vtc_train_segment enqueues every
// launch of all k steps on one stream.  D, h, v and eta stay in device
// memory between launches; the host never reads eta and never waits.
// The JAX batch-tiled variant exists only because of VMEM: here every
// batch size runs the single-tile semantics (the whole batch in one
// step), which the tiled kernel reproduces in exact arithmetic.
//
// What bounds it on this card.  Per flagship step (b = 250, s = n = 256,
// 25 iterations) the products outside the solve are about 0.13 GFLOP
// (G, c, resid, grad) against 0.8 GFLOP in FISTA, and every operand fits
// the 50 MB L2.  The solve is K1's: at this batch launch_solve routes it
// to the thread-block-cluster kernel (fista_core.cuh): clusters of 8
// CTAs, 14 clusters of 18 rows (112 CTAs) at b = 250, each CTA's slice of
// G resident in its shared memory, where the classic kernel ran 16 blocks
// on 16 of the 132 SMs.  Its iterations are bound by the product's
// instruction issue in the few warps a CTA has, then the cluster's code
// exchange and barrier; the small kernels here are bound by launch
// latency.  What the design does about
// it: the products use one simple fp32 SIMT tile (32 x 32 outputs, 256
// threads, 4 outputs each) with transpose flags and a fused "- X", so
// five products share one kernel; the power refresh is one block.
// Capturing the segment in a CUDA graph or running it as a persistent
// kernel is later work (ROADMAP.md).
//
// The kernels (the fp32 SIMT product, the power refresh, the Hessian EMA
// and the row update) live in train_core.cuh, which K6 shares, and the
// solve in fista_core.cuh.
//
// Also here, K3: the per-shard solve+stats step of the data-parallel
// composition.  Replaces vtc_tpu/ops/pallas_train_step.py,
// fused_solve_stats_pallas (:940, kernel _make_solve_stats_kernel :854):
// the same refresh and solve as a K2 step on one shard of the batch, then
// instead of the update the shard's unaveraged statistics
//
//   C = codes^T codes (s, s);  B = codes^T X (s, n);  stat = sum_b codes^2
//
// which the caller sums over the shards (one all-reduce between launches,
// where the TPU composition runs one psum) before the replicated update
// (C D' - B) / global_b.  One C entry, vtc_solve_stats, enqueues the step;
// its first half is K2's own (refresh_and_solve below), and C and B are
// two more calls of the fp32 product, each entry one thread's sum over the
// rows in order: no atomics, since C D' - B cancels.  It is bound as K2
// is, by the solve; a shard of half the batch runs on half as many
// clusters, each with the same work per iteration.
//
// Also here, K15: a rank's whole data-parallel fc segment.  Replaces
// vtc_tpu/ops/pallas_dp_train.py, fused_dp_train_segment_pallas (:310,
// kernel _make_dp_kernel :129).  vtc_dp_train_segment runs, per step, K3's
// step on the rank's shard (refresh_and_solve and gram_form_stats, into
// one packed buffer [C (s, s) | B (s, n) | stat (s)]), then the host hook
// that sums that buffer over the ranks (train_core.cuh; where the TPU
// kernel all-reduces it over remote DMA, in-kernel), then K2's update from
// the global statistics: the Hessian EMA from the summed stat and, per
// update iteration, grad = C D - B by the fp32 product with its fused
// "- X", D -= step * grad / global_b [/ (h + lowest)], rows renormalized
// with vtc_tpu's 1e-30 floor.  The whole segment is enqueued from one C
// loop, K17's layout (fused_conv_train_step.cu): at a world of one there
// is no hook and no host work per step.  Per step it does K3's work plus
// 2 upd_num_iters s^2 n for C D, so it is bound as K3 is, by the solve.
// Its early stop (vtc_tpu :206-248) is batch-global: at a world of one
// every step's solve takes K2's stop route (the cluster kernel's stop
// warp at b 250); above one the classic route with a host hook an
// iteration (fista_core.cuh, "The early stop"), every rank at one count.
// K3 and K15 take vtc_tpu's tiers as K2 does (pallas_train_step.py:854-925,
// pallas_dp_train.py:129-190): the solve on fista_tier.cuh's kernel, at
// 'bf16' c as one bf16 pass; the statistics and the update stay fp32.  A
// tier's stop takes the tier plan's route at a world of one (one launch
// on the resident layout at b 250) and the classic route above it.
#include "train_core.cuh"

extern "C" int vtc_fused_fista(const float* gram, const float* corr,
                               const float* init, const float* eta,
                               float lam, int num_iters, int b, int s,
                               int sk, int sc, int fista, int mode,
                               float* gn_scratch, float* state_scratch,
                               float* out, int route, int* taken, float eps,
                               float inv_count, void* stop_words, int* iters,
                               unsigned tag, float* stop_local,
                               SumHook stop_hook, int tier,
                               void* stream_ptr);

namespace {

#define VTC_CHECK(...)                                    \
  do {                                                    \
    err = (__VA_ARGS__);                                  \
    if (err != cudaSuccess) return static_cast<int>(err); \
  } while (0)

// The first half of a step, which K2, K3 and K15 share: G = D D^T (and
// D^T D when s > n), the warm power refresh into v and eta, c = X D^T and
// the solve into codes, with stop's early stop as step `step`.  At a tier
// other than 'highest' (vtc_fused_fista's) the solve runs it, and at
// 'bf16' c is one bf16 pass: X and D rounded to bf16 into round_scratch
// ((b + s) n floats) before the fp32 product.  The Gram and the refresh
// stay fp32 in every tier (pallas_train_step.py:400-409).  Returns the
// first CUDA error code (0 on success).
int refresh_and_solve(const float* d, float* v, const float* xs, int b, int s,
                      int n, float lam, int num_iters, int fista, int mode,
                      int power_iters, float* gram, float* pgram, float* corr,
                      float* codes, float* eta, int sk, int sc,
                      float* gn_scratch, float* state_scratch,
                      void* stream_ptr, const SegmentStop& stop = {},
                      int step = 0, int tier = 0,
                      float* round_scratch = nullptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int dim = s > n ? n : s;
  const float* power_gram = s > n ? pgram : gram;
  cudaError_t err;
  VTC_CHECK(gemm<false, true>(d, d, nullptr, gram, s, s, n, stream));
  if (s > n)
    VTC_CHECK(gemm<true, false>(d, d, nullptr, pgram, n, n, s, stream));
  VTC_CHECK(power_refresh(power_gram, v, eta, dim, power_iters, stream));
  const float* cx = xs;
  const float* cd = d;
  if (tier == kTierBf16) {
    if (round_scratch == nullptr) return cudaErrorInvalidValue;
    float* xr = round_scratch;
    float* dr = round_scratch + static_cast<int64_t>(b) * n;
    VTC_CHECK(round_bf16(xs, xr, static_cast<int64_t>(b) * n, stream));
    VTC_CHECK(round_bf16(d, dr, static_cast<int64_t>(s) * n, stream));
    cx = xr;
    cd = dr;
  }
  VTC_CHECK(gemm<false, true>(cx, cd, nullptr, corr, b, s, n, stream));
  return vtc_fused_fista(  // the shape's own route; classic across ranks
      gram, corr, nullptr, eta, lam, num_iters, b, s, sk, sc, fista, mode,
      gn_scratch, state_scratch, codes, 0, nullptr, stop.eps, stop.inv_count,
      stop.words, stop.step_iters(step),
      SegmentStop::step_tag(step, num_iters), stop.local, stop.hook, tier,
      stream_ptr);
}

}  // namespace

extern "C" {

// Bytes of dynamic shared memory the power refresh takes for a Gram of
// size dim (the wrapper checks it against the block's budget).
int vtc_power_smem_bytes(int dim) { return power_smem_bytes(dim); }

// k train steps on one stream, every launch enqueued before returning.
//
// In place: d (s, n), h (s,), v (dim,) with dim = min(s, n).
// x (k, b, n).  Scratch: gram (s, s); pgram (n, n) when s > n, else
// unused; corr (b, s); resid (b, n); grad (s, n); eta (1,); K1's gn
// (sk, sc) and state (see vtc_fused_fista).  codes (b, s) holds the last
// step's codes on return.  mode: K1's shrink mode; update: 0 steepest,
// 1 cheap quadratic.  The early stop of every step's solve: eps >= 0
// turns it on (vtc_fused_fista's), with inv_count = 1 / (b s), the zeroed
// stop_words of vtc_fista_stop_words and iters (k,), each step's count;
// the Hessian EMA and the update take the stopped codes.  tier: the
// solve's (vtc_fused_fista's: 0 'highest', 1 bf16, 2 bf16x3, 3 bf16x5;
// gn_scratch, state_scratch and the stop words sized for it), and at 1 c
// as one bf16 pass through round_scratch ((b + s) n floats; else unused).
// Returns the first CUDA error code (0 on success).
int vtc_train_segment(float* d, float* h, float* v, const float* x, int k,
                      int b, int s, int n, float lam, int num_iters,
                      float upd_step, int upd_num_iters, float lowest,
                      int fista, int mode, int update, int renorm,
                      int power_iters, float inv_b, float* gram,
                      float* pgram, float* corr, float* codes, float* resid,
                      float* grad, float* eta, int sk, int sc,
                      float* gn_scratch, float* state_scratch, float eps,
                      float inv_count, void* stop_words, int* iters,
                      int tier, float* round_scratch, void* stream_ptr) {
  if (k < 0 || b <= 0 || s <= 0 || n <= 0 || num_iters < 0 ||
      upd_num_iters < 0 || power_iters < 0 || (s > n && pgram == nullptr) ||
      (eps >= 0.0f && (stop_words == nullptr || iters == nullptr)) ||
      (tier == kTierBf16 && round_scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const SegmentStop stop{eps, inv_count, stop_words, iters};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = power_setup(s > n ? n : s);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int step = 0; step < k; ++step) {
    const float* xs = x + static_cast<int64_t>(step) * b * n;
    const int solve_err = refresh_and_solve(
        d, v, xs, b, s, n, lam, num_iters, fista, mode, power_iters, gram,
        pgram, corr, codes, eta, sk, sc, gn_scratch, state_scratch,
        stream_ptr, stop, step, tier, round_scratch);
    if (solve_err != 0) return solve_err;
    if (update == 1) VTC_CHECK(hessian_ema(codes, h, b, s, inv_b, stream));
    for (int u = 0; u < upd_num_iters; ++u) {
      VTC_CHECK(gemm<false, false>(codes, d, xs, resid, b, n, s, stream));
      VTC_CHECK(gemm<true, false>(codes, resid, nullptr, grad, s, n, b,
                                   stream));
      VTC_CHECK(update_rows<false>(d, grad, h, AlignmentReg{}, s, n, inv_b,
                                   upd_step, lowest, update == 1,
                                   renorm != 0, stream));
    }
  }
  return 0;
}

// K3, one shard's step: the refresh and the solve of vtc_train_segment on
// the shard x (b, n), then the shard's unaveraged update statistics
// cmat = codes^T codes (s, s), bmat = codes^T x (s, n) and
// stat = sum_b codes^2 (s,).  No update: the caller sums the statistics
// over the shards and updates the replicated dictionary.  d is read only;
// v (dim,) is refreshed in place and eta (1,) receives the stepsize;
// scratch, tier and round_scratch as vtc_train_segment's: the solve at the
// tier and at 'bf16' c as one bf16 pass, the statistics fp32 in every
// tier (they feed the cancelling C D' - B; pallas_train_step.py:859-865).
// Returns the first CUDA error code.
int vtc_solve_stats(const float* d, float* v, const float* x, int b, int s,
                    int n, float lam, int num_iters, int fista, int mode,
                    int power_iters, float* gram, float* pgram, float* corr,
                    float* codes, float* cmat, float* bmat, float* stat,
                    float* eta, int sk, int sc, float* gn_scratch,
                    float* state_scratch, int tier, float* round_scratch,
                    void* stream_ptr) {
  if (b <= 0 || s <= 0 || n <= 0 || num_iters < 0 || power_iters < 0 ||
      (s > n && pgram == nullptr) ||
      (tier == kTierBf16 && round_scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = power_setup(s > n ? n : s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int solve_err = refresh_and_solve(
      d, v, x, b, s, n, lam, num_iters, fista, mode, power_iters, gram, pgram,
      corr, codes, eta, sk, sc, gn_scratch, state_scratch, stream_ptr, {}, 0,
      tier, round_scratch);
  if (solve_err != 0) return solve_err;
  VTC_CHECK(gram_form_stats(codes, x, cmat, bmat, stat, b, s, n, stream));
  return 0;
}

// K15, one rank's data-parallel segment of k steps on its shard
// x (k, b, n).  In place: d (s, n), h (s,), v (dim,), replicated.
// comm (s*s + s*n + s,) receives each step's packed statistics
// [C | B | stat]; sum_hook(step), when given, sums it over the ranks
// before the update.  global_b is the batch over all ranks.  Scratch as
// vtc_train_segment's (gram, pgram, corr, grad, eta, gn, state); codes
// (b, s) holds the last step's codes of the shard on return.  The early
// stop of every step's solve, over the global batch: eps >= 0 turns it on,
// with inv_count = 1 / (global_b s) and iters (k,) each step's count; at a
// world of one (no stop_hook) the stop_words of vtc_fista_stop_words and
// K2's stop route, else the classic route's words, stop_local (1,) and
// stop_hook(iteration), which sums stop_local over the ranks
// (vtc_fused_fista's; state_scratch required).  tier and round_scratch:
// the solves' tier and at 'bf16' c as one bf16 pass, as vtc_train_segment's;
// the statistics and the update stay fp32 (pallas_dp_train.py:256-258); a
// tier's stop at one rank takes the tier plan's route (stop_words of
// vtc_fista_tier_plan's route), across ranks the classic route's.  Returns the first CUDA error code
// (0 on success; cudaErrorUnknown for a failed stop_hook), or
// kSumHookFailed for a failed sum_hook.
int vtc_dp_train_segment(float* d, float* h, float* v, const float* x, int k,
                         int b, int s, int n, float lam, int num_iters,
                         float upd_step, int upd_num_iters, float lowest,
                         int fista, int mode, int update, int renorm,
                         int power_iters, float global_b, float* gram,
                         float* pgram, float* corr, float* codes, float* grad,
                         float* eta, int sk, int sc, float* gn_scratch,
                         float* state_scratch, float* comm, SumHook sum_hook,
                         float eps, float inv_count, void* stop_words,
                         int* iters, float* stop_local, SumHook stop_hook,
                         int tier, float* round_scratch, void* stream_ptr) {
  if (k < 0 || b <= 0 || s <= 0 || n <= 0 || num_iters < 0 ||
      upd_num_iters < 0 || power_iters < 0 || !(global_b >= 1.0f) ||
      (s > n && pgram == nullptr) ||
      (eps >= 0.0f && (stop_words == nullptr || iters == nullptr)) ||
      (tier == kTierBf16 && round_scratch == nullptr) ||
      (stop_hook != nullptr && (stop_local == nullptr ||
                                state_scratch == nullptr || !(eps >= 0.0f))))
    return static_cast<int>(cudaErrorInvalidValue);
  const SegmentStop stop{eps,       inv_count,
                         stop_words, iters,
                         stop_hook != nullptr ? stop_local : nullptr,
                         stop_hook};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = power_setup(s > n ? n : s);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* cmat = comm;
  float* bmat = comm + static_cast<int64_t>(s) * s;
  float* stat = bmat + static_cast<int64_t>(s) * n;
  const float inv_b = 1.0f / global_b;
  for (int step = 0; step < k; ++step) {
    const float* xs = x + static_cast<int64_t>(step) * b * n;
    const int solve_err = refresh_and_solve(
        d, v, xs, b, s, n, lam, num_iters, fista, mode, power_iters, gram,
        pgram, corr, codes, eta, sk, sc, gn_scratch, state_scratch,
        stream_ptr, stop, step, tier, round_scratch);
    if (solve_err != 0) return solve_err;
    VTC_CHECK(gram_form_stats(codes, xs, cmat, bmat, stat, b, s, n, stream));
    if (sum_hook != nullptr && sum_hook(step) != 0) return kSumHookFailed;
    if (update == 1)
      VTC_CHECK(hessian_from_stat(stat, h, s, global_b, stream));
    for (int u = 0; u < upd_num_iters; ++u) {
      VTC_CHECK(gemm<false, false>(cmat, d, bmat, grad, s, n, s, stream));
      VTC_CHECK(update_rows<false>(d, grad, h, AlignmentReg{}, s, n, inv_b,
                                   upd_step, lowest, update == 1,
                                   renorm != 0, stream));
    }
  }
  return 0;
}

#undef VTC_CHECK

}  // extern "C"
