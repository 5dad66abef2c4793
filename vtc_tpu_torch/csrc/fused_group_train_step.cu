// Fused subspace (group-sparse) train steps for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel K6: vtc_tpu/ops/pallas_train_step.py,
// fused_group_train_segment_pallas (:1283) with its kernel
// _make_group_kernel (:539), the group prox K5 inside.  Same contract:
// for each of the k batches X (b, n) of a segment, with the dictionary
// D (s, n), the Hessian-diagonal EMA h (s,) and the warm eigenvector v
// (min(GM, n),) carried from step to step, and the groups packed into
// G windows of M slots (GM = G * M),
//
//   Dg = gsel D                 (GM, n): member rows, zero rows for padding
//   Gg = Dg Dg^T                power Gram: Dg^T Dg when GM > n
//   v = v / |v|; power_iters times v = v P / |v P|;  eta = 1 / ((v P) . v)
//   c = X Dg^T
//   gcodes = group FISTA / ISTA, num_iters iterations (K4's kernel)
//   codes = gcodes gsel         (b, s): duplicated memberships summed
//   h = 0.99 h + (sum_b codes^2 * (1/b)) / 100          (cheap quadratic)
//   upd_num_iters times:
//     resid = codes D - X ; grad = codes^T resid * (1/b)
//     [+ penalty (S D - rowsum(S o C) D), C = D D^T, S = comem o sign(C)]
//     [/ (h + lowest)] ; D = D - step * grad ; rows renormalized
//
// Layout: K2's (fused_train_step.cu).  Per-step kernels that one C loop
// per segment enqueues on one stream; D, h, v and eta stay in device
// memory and the host never waits inside a segment.  The products are
// K2's fp32 SIMT product kernel, the refresh is K2's one-block power
// kernel, the solve is K4's kernel through vtc_fused_group_fista, and the
// Hessian EMA and row update are K2's (train_core.cuh).
//
// The group structure.  The TPU kernel makes every ragged operation an
// MXU product against 0/1 matrices (gsel (GM, s), expand (GM, G)).  Here
// they are index lists built on the host once per segment:
//  * the grouped build is a row gather, sel[r] the member of slot r or
//    -1 for padding (a zero row); skipped when the groups tile range(s)
//    in order, where Dg is D (the TPU kernel's gsel_identity);
//  * the unpack is a fixed-order gather-sum: code j adds its slots in
//    ascending order, sum_idx (s, R) padded with GM; no atomics, so the
//    result does not depend on scheduling; skipped with the build;
//  * expand has no counterpart: K4's prox takes the window M.
//
// The anti-alignment regularizer (alignment_penalty != 0, unit-norm
// form): per update iteration C = D D^T and S D are two more products on
// K2's kernel, S = comem o sign(C) an elementwise pass over the static
// co-membership counts, and rowsum(S o C) is taken inside the row update.
// Every product is fp32 on the CUDA cores, in every tier; sign(C) of
// near-orthogonal atoms can flip between fp32 and fp64, so the
// regularized step is held to its plain version at small sizes.
//
// What bounds it on this card: as K2, the group solve, which takes the
// cluster kernel at the flagship's b = 250 (112 CTAs, the group prox in
// registers for M in {1, 2, 4}; fista_core.cuh); the build, unpack and
// regularizer passes are bound by launch latency.
//
// Also here, K7: the per-shard group solve+stats step of the data-parallel
// composition.  Replaces vtc_tpu/ops/pallas_train_step.py,
// fused_group_solve_stats_pallas (:1112, kernel
// _make_group_solve_stats_kernel :1010): a K6 step's grouped refresh,
// group solve and summed codes on one shard of the batch
// (group_refresh_and_solve below, K6's own first half), then instead of
// the update the shard's unaveraged C = codes^T codes, B = codes^T X and
// stat = sum_b codes^2 over the summed (b, s) codes (train_core.cuh's
// gram_form_stats, fixed order, no atomics).  The regularizer needs only
// the replicated dictionary, so it stays with the caller's update.
//
// Also here, K16: a rank's whole data-parallel subspace segment.  Replaces
// vtc_tpu/ops/pallas_group_dp_train.py, fused_group_dp_train_segment_pallas
// (:300, kernel _make_group_dp_kernel :94).  vtc_group_dp_train_segment
// runs, per step, K7's step on the rank's shard (the row gather, the
// grouped Gram, the power refresh, K4's group solve, the summed codes and
// the statistics, packed [C (s, s) | B (s, n) | stat (s)]), then the host
// hook that sums the packed buffer over the ranks (train_core.cuh), then
// K6's update from the global statistics: the Hessian EMA from the summed
// stat and, per update iteration, grad = C D - B, the anti-alignment
// regularizer on the replicated dictionary (K6's sign mask and row update)
// and the step with vtc_tpu's 1e-30 renorm floor.  One C loop per segment,
// K17's layout; no hook at a world of one.  Bound as K7 is, by the group
// solve.  Its early stop (vtc_tpu :189-229) is K15's, on the grouped
// codes: K6's stop route at a world of one, the classic route with a host
// hook an iteration above one.  K7 and K16 take K6's tiers, but for the
// unpack at 'bf16': K7's is a bf16 product with no identity shortcut
// (pallas_train_step.py:1074), so it rounds every code slot on the
// identity layout too, where K16, as K6, keeps the solve's codes.
#include "train_core.cuh"

extern "C" int vtc_fused_group_fista(const float* gram, const float* corr,
                                     const float* init, const float* eta,
                                     float lam, int num_iters, int b, int gm,
                                     int group_size, int sk, int sc,
                                     int fista, int hard, float* gn_scratch,
                                     float* state_scratch, float* out,
                                     int route, int* taken, float eps,
                                     float inv_count, void* stop_words,
                                     int* iters, unsigned tag,
                                     float* stop_local, SumHook stop_hook,
                                     int tier, void* stream_ptr);

namespace {

// dg (rows, n): row r is d's row sel[r], or zeros where sel[r] < 0.
__global__ void gather_rows_kernel(const float* __restrict__ d,
                                   const int* __restrict__ sel,
                                   float* __restrict__ dg, int rows, int n) {
  const int64_t total = static_cast<int64_t>(rows) * n;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(idx / n);
    const int src = sel[r];
    dg[idx] = src >= 0 ? d[static_cast<int64_t>(src) * n + (idx - r * n)]
                       : 0.0f;
  }
}

// codes (b, s): code j of each row sums that row's slots sum_idx[j, :]
// of gcodes (b, gm), in order, up to the first index >= gm; with round
// each slot rounded to bf16 first (the unpack's bf16 pass at the tier
// 'bf16', pallas_train_step.py:691).
__global__ void sum_slots_kernel(const float* __restrict__ gcodes,
                                 const int* __restrict__ sum_idx,
                                 float* __restrict__ codes, int b, int s,
                                 int gm, int width, bool round) {
  const int64_t total = static_cast<int64_t>(b) * s;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = idx / s;
    const int j = static_cast<int>(idx - row * s);
    const float* g = gcodes + row * gm;
    float acc = 0.0f;
    for (int r = 0; r < width; ++r) {
      const int slot = sum_idx[j * width + r];
      if (slot >= gm) break;
      acc += round ? round_to_bf16(g[slot]) : g[slot];
    }
    codes[idx] = acc;
  }
}

#define VTC_CHECK(...)                                    \
  do {                                                    \
    err = (__VA_ARGS__);                                  \
    if (err != cudaSuccess) return static_cast<int>(err); \
  } while (0)

// The first half of a step, which K6, K7 and K16 share: the grouped
// dictionary (a row gather unless the groups tile range(s) in order, sel
// == nullptr), its Gram (and Dg^T Dg when gm > n), the warm power refresh
// into v and eta, c = X Dg^T, the group solve into gcodes (with stop's
// early stop as step `step`) and the duplicate-summed (b, s) codes.
// Those land in codes, or stay in gcodes when sum_idx is null.  tier: the
// group solve's (vtc_fused_group_fista's); at 'bf16' c is one bf16 pass
// through round_scratch ((b + gm) n floats) and the unpack rounds each
// slot, as K2's.  The identity layout has no unpack, so its codes stay
// unrounded (K6's and K16's gsel_identity shortcut), unless round_identity
// (K7's unpack, a bf16 product with no shortcut, pallas_train_step.py
// :1074): then codes receives bf16(gcodes).  Returns the first CUDA error
// code (0 on success).
int group_refresh_and_solve(const float* d, float* v, const float* xs, int b,
                            int s, int n, int gm, int group_size,
                            const int* sel, const int* sum_idx, int sum_width,
                            float lam, int num_iters, int fista, int hard,
                            int power_iters, float* dg, float* gram,
                            float* pgram, float* corr, float* gcodes,
                            float* codes, float* eta, int sk, int sc,
                            float* gn_scratch, float* state_scratch,
                            void* stream_ptr,
                            const SegmentStop& stop = {},
                            int step = 0, int tier = 0,
                            float* round_scratch = nullptr,
                            bool round_identity = false) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool identity = sel == nullptr;
  const int dim = gm > n ? n : gm;
  const float* grouped = identity ? d : dg;
  const float* power_gram = gm > n ? pgram : gram;
  cudaError_t err;
  if (!identity) {
    gather_rows_kernel<<<pass_grid(static_cast<int64_t>(gm) * n),
                         kPassThreads, 0, stream>>>(d, sel, dg, gm, n);
    VTC_CHECK(cudaGetLastError());
  }
  VTC_CHECK(gemm<false, true>(grouped, grouped, nullptr, gram, gm, gm, n,
                              stream));
  if (gm > n)
    VTC_CHECK(gemm<true, false>(grouped, grouped, nullptr, pgram, n, n, gm,
                                stream));
  VTC_CHECK(power_refresh(power_gram, v, eta, dim, power_iters, stream));
  const bool bf16_pass = tier == kTierBf16;
  const float* cx = xs;
  if (bf16_pass) {
    if (round_scratch == nullptr) return cudaErrorInvalidValue;
    float* xr = round_scratch;
    float* dr = round_scratch + static_cast<int64_t>(b) * n;
    VTC_CHECK(round_bf16(xs, xr, static_cast<int64_t>(b) * n, stream));
    VTC_CHECK(round_bf16(grouped, dr, static_cast<int64_t>(gm) * n, stream));
    cx = xr;
    grouped = dr;
  }
  VTC_CHECK(gemm<false, true>(cx, grouped, nullptr, corr, b, gm, n, stream));
  const int solve_err = vtc_fused_group_fista(  // classic across ranks
      gram, corr, nullptr, eta, lam, num_iters, b, gm, group_size, sk, sc,
      fista, hard, gn_scratch, state_scratch, gcodes, 0, nullptr, stop.eps,
      stop.inv_count, stop.words, stop.step_iters(step),
      SegmentStop::step_tag(step, num_iters), stop.local, stop.hook, tier,
      stream_ptr);
  if (solve_err != 0) return solve_err;
  if (!identity) {
    sum_slots_kernel<<<pass_grid(static_cast<int64_t>(b) * s), kPassThreads,
                       0, stream>>>(gcodes, sum_idx, codes, b, s, gm,
                                    sum_width, bf16_pass);
    VTC_CHECK(cudaGetLastError());
  } else if (bf16_pass && round_identity) {
    if (codes == nullptr) return cudaErrorInvalidValue;
    VTC_CHECK(round_bf16(gcodes, codes, static_cast<int64_t>(b) * s, stream));
  }
  return 0;
}

// The arguments the group structure must satisfy (both entries).
bool group_args_ok(int b, int s, int n, int gm, int num_iters,
                   int power_iters, const int* sel, const int* sum_idx,
                   int sum_width, const float* dg, const float* pgram,
                   const float* codes) {
  const bool identity = sel == nullptr;
  return b > 0 && s > 0 && n > 0 && gm > 0 && num_iters >= 0 &&
         power_iters >= 0 && identity == (sum_idx == nullptr) &&
         (!identity || gm == s) &&
         (identity || (dg != nullptr && codes != nullptr && sum_width >= 1)) &&
         (gm <= n || pgram != nullptr);
}

}  // namespace

extern "C" {

// k subspace train steps on one stream, every launch enqueued before
// returning.
//
// In place: d (s, n), h (s,), v (dim,) with dim = min(gm, n).  x (k, b, n).
// Group structure: gm = G * group_size packed slots; sel (gm,) and
// sum_idx (s, sum_width) int32 on the device, both null when the groups
// tile range(s) in order (then gm == s and Dg = D).  comem (s, s) the
// zero-diagonal co-membership counts, or null for no regularizer.
// Scratch: dg (gm, n) unless sel is null; gram (gm, gm); pgram (n, n)
// when gm > n; corr (b, gm); gcodes (b, gm); codes (b, s) unless sum_idx
// is null; resid (b, n); grad (s, n); cmat, smat (s, s) and sd (s, n)
// with comem; eta (1,); K4's gn (sk, sc) and state (see
// vtc_fused_group_fista).  The last step's summed codes are in codes, or
// in gcodes when sum_idx is null.  update: 0 steepest, 1 cheap
// quadratic.  The early stop of every step's group solve: eps >= 0 turns
// it on, with inv_count = 1 / (b gm), the zeroed stop_words of
// vtc_fista_stop_words and iters (k,), each step's count; the Hessian EMA
// and the update take the stopped codes.  tier and round_scratch ((b + gm)
// n floats at 'bf16', else unused): the group solve's tier and K2's bf16
// pass of c (group_refresh_and_solve).  Returns the first CUDA error code
// (0 on success).
int vtc_group_train_segment(
    float* d, float* h, float* v, const float* x, int k, int b, int s,
    int n, int gm, int group_size, const int* sel, const int* sum_idx,
    int sum_width, const float* comem, float penalty, float lam,
    int num_iters, float upd_step, int upd_num_iters, float lowest,
    int fista, int hard, int update, int renorm, int power_iters,
    float inv_b, float* dg, float* gram, float* pgram, float* corr,
    float* gcodes, float* codes, float* resid, float* grad, float* cmat,
    float* smat, float* sd, float* eta, int sk, int sc, float* gn_scratch,
    float* state_scratch, float eps, float inv_count, void* stop_words,
    int* iters, int tier, float* round_scratch, void* stream_ptr) {
  if (k < 0 || upd_num_iters < 0 ||
      !group_args_ok(b, s, n, gm, num_iters, power_iters, sel, sum_idx,
                     sum_width, dg, pgram, codes) ||
      (comem != nullptr &&
       (cmat == nullptr || smat == nullptr || sd == nullptr)) ||
      (eps >= 0.0f && (stop_words == nullptr || iters == nullptr)) ||
      (tier == kTierBf16 && round_scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const SegmentStop stop{eps, inv_count, stop_words, iters};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* step_codes = sel == nullptr ? gcodes : codes;
  cudaError_t err = power_setup(gm > n ? n : gm);
  if (err != cudaSuccess) return static_cast<int>(err);
  for (int step = 0; step < k; ++step) {
    const float* xs = x + static_cast<int64_t>(step) * b * n;
    const int solve_err = group_refresh_and_solve(
        d, v, xs, b, s, n, gm, group_size, sel, sum_idx, sum_width, lam,
        num_iters, fista, hard, power_iters, dg, gram, pgram, corr, gcodes,
        codes, eta, sk, sc, gn_scratch, state_scratch, stream_ptr, stop,
        step, tier, round_scratch);
    if (solve_err != 0) return solve_err;
    if (update == 1)
      VTC_CHECK(hessian_ema(step_codes, h, b, s, inv_b, stream));
    for (int u = 0; u < upd_num_iters; ++u) {
      VTC_CHECK(gemm<false, false>(step_codes, d, xs, resid, b, n, s,
                                   stream));
      VTC_CHECK(gemm<true, false>(step_codes, resid, nullptr, grad, s, n, b,
                                  stream));
      if (comem == nullptr) {
        VTC_CHECK(update_rows<false>(d, grad, h, AlignmentReg{}, s, n, inv_b,
                                     upd_step, lowest, update == 1,
                                     renorm != 0, stream));
        continue;
      }
      VTC_CHECK(gemm<false, true>(d, d, nullptr, cmat, s, s, n, stream));
      sign_mask_kernel<<<pass_grid(static_cast<int64_t>(s) * s),
                         kPassThreads, 0, stream>>>(
          comem, cmat, smat, static_cast<int64_t>(s) * s);
      VTC_CHECK(cudaGetLastError());
      VTC_CHECK(gemm<false, false>(smat, d, nullptr, sd, s, n, s, stream));
      VTC_CHECK(update_rows<true>(d, grad, h,
                                  AlignmentReg{sd, smat, cmat, penalty}, s,
                                  n, inv_b, upd_step, lowest, update == 1,
                                  renorm != 0, stream));
    }
  }
  return 0;
}

// K7, one shard's subspace step: the grouped refresh and the group solve
// of vtc_group_train_segment on the shard x (b, n), the codes summed back
// to (b, s), then the shard's unaveraged update statistics over those
// summed codes: cmat = codes^T codes (s, s), bmat = codes^T x (s, n),
// stat = sum_b codes^2 (s,).  No update and no regularizer: both run on
// the replicated dictionary after the caller has summed the statistics
// over the shards.  d is read only; v (dim,) is refreshed in place and
// eta (1,) receives the stepsize; the group structure and the scratch are
// vtc_group_train_segment's.  tier and round_scratch as there: the group
// solve at the tier, at 'bf16' c as one bf16 pass and every code slot
// rounded to bf16 by the unpack, the identity layout's too (into codes,
// then required); C, B and stat fp32 in every tier.  The summed codes are
// in codes, or in gcodes when sum_idx is null and they are not rounded.
// Returns the first CUDA error code.
int vtc_group_solve_stats(
    const float* d, float* v, const float* x, int b, int s, int n, int gm,
    int group_size, const int* sel, const int* sum_idx, int sum_width,
    float lam, int num_iters, int fista, int hard, int power_iters,
    float* dg, float* gram, float* pgram, float* corr, float* gcodes,
    float* codes, float* cmat, float* bmat, float* stat, float* eta, int sk,
    int sc, float* gn_scratch, float* state_scratch, int tier,
    float* round_scratch, void* stream_ptr) {
  const bool rounded = tier == kTierBf16;
  if (!group_args_ok(b, s, n, gm, num_iters, power_iters, sel, sum_idx,
                     sum_width, dg, pgram, codes) ||
      (rounded && (round_scratch == nullptr || codes == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err = power_setup(gm > n ? n : gm);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int solve_err = group_refresh_and_solve(
      d, v, x, b, s, n, gm, group_size, sel, sum_idx, sum_width, lam,
      num_iters, fista, hard, power_iters, dg, gram, pgram, corr, gcodes,
      codes, eta, sk, sc, gn_scratch, state_scratch, stream_ptr, {}, 0, tier,
      round_scratch, true);
  if (solve_err != 0) return solve_err;
  VTC_CHECK(gram_form_stats(sel == nullptr && !rounded ? gcodes : codes, x,
                            cmat, bmat, stat, b, s, n, stream));
  return 0;
}

// K16, one rank's data-parallel subspace segment of k steps on its shard
// x (k, b, n).  In place: d (s, n), h (s,), v (dim,), replicated.  The
// group structure and the solve's scratch are vtc_group_train_segment's;
// comem (s, s), or null for no regularizer, with ddt (D D^T) and smat
// (s, s) and sd (s, n) its scratch.  comm (s*s + s*n + s,) receives each step's
// packed statistics [C | B | stat], summed over the ranks by sum_hook
// (when given) before the update; global_b is the batch over all ranks.
// grad (s, n).  The last step's summed codes of the shard are in codes, or
// in gcodes when sum_idx is null.  The early stop of every step's group
// solve: eps, inv_count = 1 / (global_b gm), stop_words, iters (k,),
// stop_local and stop_hook as vtc_dp_train_segment's.  tier and
// round_scratch as vtc_group_train_segment's: the identity layout keeps
// its unrounded codes at 'bf16' (vtc_tpu's K16, pallas_group_dp_train.py
// :230-231), where K7 rounds them.  Returns the first CUDA error code (0
// on success; cudaErrorUnknown for a failed stop_hook), or kSumHookFailed
// for a failed sum_hook.
int vtc_group_dp_train_segment(
    float* d, float* h, float* v, const float* x, int k, int b, int s,
    int n, int gm, int group_size, const int* sel, const int* sum_idx,
    int sum_width, const float* comem, float penalty, float lam,
    int num_iters, float upd_step, int upd_num_iters, float lowest,
    int fista, int hard, int update, int renorm, int power_iters,
    float global_b, float* dg, float* gram, float* pgram, float* corr,
    float* gcodes, float* codes, float* grad, float* ddt, float* smat,
    float* sd, float* eta, int sk, int sc, float* gn_scratch,
    float* state_scratch, float* comm, SumHook sum_hook, float eps,
    float inv_count, void* stop_words, int* iters, float* stop_local,
    SumHook stop_hook, int tier, float* round_scratch, void* stream_ptr) {
  if (k < 0 || upd_num_iters < 0 || !(global_b >= 1.0f) ||
      (tier == kTierBf16 && round_scratch == nullptr) ||
      !group_args_ok(b, s, n, gm, num_iters, power_iters, sel, sum_idx,
                     sum_width, dg, pgram, codes) ||
      (comem != nullptr &&
       (ddt == nullptr || smat == nullptr || sd == nullptr)) ||
      (eps >= 0.0f && (stop_words == nullptr || iters == nullptr)) ||
      (stop_hook != nullptr && (stop_local == nullptr ||
                                state_scratch == nullptr || !(eps >= 0.0f))))
    return static_cast<int>(cudaErrorInvalidValue);
  const SegmentStop stop{eps,       inv_count,
                         stop_words, iters,
                         stop_hook != nullptr ? stop_local : nullptr,
                         stop_hook};
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  float* step_codes = sel == nullptr ? gcodes : codes;
  cudaError_t err = power_setup(gm > n ? n : gm);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* cmat = comm;
  float* bmat = comm + static_cast<int64_t>(s) * s;
  float* stat = bmat + static_cast<int64_t>(s) * n;
  const float inv_b = 1.0f / global_b;
  for (int step = 0; step < k; ++step) {
    const float* xs = x + static_cast<int64_t>(step) * b * n;
    const int solve_err = group_refresh_and_solve(
        d, v, xs, b, s, n, gm, group_size, sel, sum_idx, sum_width, lam,
        num_iters, fista, hard, power_iters, dg, gram, pgram, corr, gcodes,
        codes, eta, sk, sc, gn_scratch, state_scratch, stream_ptr, stop,
        step, tier, round_scratch);
    if (solve_err != 0) return solve_err;
    VTC_CHECK(gram_form_stats(step_codes, xs, cmat, bmat, stat, b, s, n,
                              stream));
    if (sum_hook != nullptr && sum_hook(step) != 0) return kSumHookFailed;
    if (update == 1)
      VTC_CHECK(hessian_from_stat(stat, h, s, global_b, stream));
    for (int u = 0; u < upd_num_iters; ++u) {
      VTC_CHECK(gemm<false, false>(cmat, d, bmat, grad, s, n, s, stream));
      if (comem == nullptr) {
        VTC_CHECK(update_rows<false>(d, grad, h, AlignmentReg{}, s, n, inv_b,
                                     upd_step, lowest, update == 1,
                                     renorm != 0, stream));
        continue;
      }
      VTC_CHECK(gemm<false, true>(d, d, nullptr, ddt, s, s, n, stream));
      sign_mask_kernel<<<pass_grid(static_cast<int64_t>(s) * s),
                         kPassThreads, 0, stream>>>(
          comem, ddt, smat, static_cast<int64_t>(s) * s);
      VTC_CHECK(cudaGetLastError());
      VTC_CHECK(gemm<false, false>(smat, d, nullptr, sd, s, n, s, stream));
      VTC_CHECK(update_rows<true>(d, grad, h,
                                  AlignmentReg{sd, smat, ddt, penalty}, s, n,
                                  inv_b, upd_step, lowest, update == 1,
                                  renorm != 0, stream));
    }
  }
  return 0;
}

#undef VTC_CHECK

}  // extern "C"
