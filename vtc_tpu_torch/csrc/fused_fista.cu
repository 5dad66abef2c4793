// Fused fully-connected ISTA/FISTA solve for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel K1: vtc_tpu/ops/pallas_fista.py,
// fista_solve_pallas (:156) / _make_kernel (:44).  Same contract: with
// G = D D^T (s, s) and c = X D^T (b, s) computed outside the kernel,
// every row of the batch runs num_iters iterations of
//
//   codes = shrink(z + z @ (-eta G) + eta c, lam * eta)
//
// with soft / nonneg-soft / hard / nonneg-hard shrinkage, FISTA or ISTA
// momentum, an optional warm start and the optional batch-global early
// stop (pallas_fista.py:107-130).  The three kernels (the classic
// layout, the bitwise reference and the route of what the others cannot
// hold; the eight-CTA cluster layout for small batches; the wide cluster
// layout for batches that fill the card), the route between them, what
// bounds each and what its design does about it are in fista_core.cuh,
// which K4 shares: this file instantiates their elementwise-shrink
// variants, with the stop and without.  The tiers other than 'highest'
// (bf16x5, bf16x3, bf16) run fista_tier.cuh's bf16 tensor-core kernel.
#include "fista_tier.cuh"

extern "C" {

// Layout constants, read by the Python wrappers to size their scratch.
int vtc_fista_rows() { return kRows; }
int vtc_fista_chunk() { return kChunk; }
int vtc_fista_col_block() { return kColBlock; }
int vtc_fista_slice_bytes() {
  return 2 * kSliceFloats * static_cast<int>(sizeof(float));
}
int vtc_fista_cluster() { return kCluster; }
int vtc_fista_cluster_max_rows() { return kClusterMaxRows; }

// The current device's SM count, as the route reads it, and its cluster
// slots (clusters resident at one CTA per SM, or minus the CUDA error).
int vtc_fista_sm_count() { return device_sm_count(); }
int vtc_fista_cluster_slots() { return cluster_slots(); }

// The route launch_solve takes on this device for b rows of s codes in
// groups of group_size (1: elementwise): 1 classic, 2 cluster, 3 wide.
int vtc_fista_route(int b, int s, int group_size) {
  const int sk = (s + kChunk - 1) / kChunk * kChunk;
  return solve_route(b, sk, group_size, device_sm_count());
}

// The rows per cluster the cluster kernel takes for that shape on this
// device, or minus the CUDA error of reading its cluster slots.
int vtc_fista_cluster_rows(int b, int s, int group_size) {
  const int sk = (s + kChunk - 1) / kChunk * kChunk;
  const int slots = cluster_slots();
  return slots < 0 ? slots : cluster_rows(b, sk, group_size, slots);
}

// The route launch_solve takes with the early stop for that shape on this
// device (stop_route: 1 classic, 2 cluster, 3 wide) and the 64-bit words of
// the stop's device array there, or minus the CUDA error of reading the
// slots.
int vtc_fista_stop_route(int b, int s, int group_size) {
  return device_stop_route(b, (s + kChunk - 1) / kChunk * kChunk,
                           group_size);
}
int64_t vtc_fista_stop_words(int b, int s, int group_size) {
  int64_t words = 0;
  const int route = device_stop_route(
      b, (s + kChunk - 1) / kChunk * kChunk, group_size, &words);
  return route < 0 ? route : words;
}

// The tier kernel's layout for s codes at tier (1 bf16, 2 bf16x3, 3
// bf16x5): the floats of gn scratch its planes take, and whether a block's
// state fits its shared memory (else the wrappers pass state scratch).
int64_t vtc_fista_tier_gn_floats(int s, int tier) {
  const int sk = (s + kChunk - 1) / kChunk * kChunk;
  const int sc = (s + kColBlock - 1) / kColBlock * kColBlock;
  return tier_gn_floats(tier, sk, sc);
}
int vtc_fista_tier_state_in_smem(int s, int tier) {
  return tier_state_in_smem(tier, (s + kChunk - 1) / kChunk * kChunk) ? 1 : 0;
}

// cudaOccupancyMaxActiveClusters of the (FISTA, soft) cluster kernel for
// s codes at rows rows per cluster, or minus the CUDA error.
int vtc_fista_cluster_occupancy(int s, int rows) {
  const int sk = (s + kChunk - 1) / kChunk * kChunk;
  return cluster_occupancy<true, kSoft, false>(sk, 1, rows);
}

// The wide kernel's cluster size for s codes in groups of group_size (0:
// its layout does not fit), and its rows per cluster for b such rows on
// this device (or minus the CUDA error of reading its cluster slots).
int vtc_fista_wide_cluster(int s, int group_size) {
  return wide_cluster((s + kChunk - 1) / kChunk * kChunk, group_size);
}
int vtc_fista_wide_rows(int b, int s, int group_size) {
  return wide_device_rows(b, (s + kChunk - 1) / kChunk * kChunk,
                          group_size);
}

// The clusters of cluster_size wide-kernel CTAs this device holds at one
// CTA per SM, or minus the CUDA error.
int vtc_fista_wide_slots(int cluster_size) { return wide_slots(cluster_size); }

// gram (s, s), corr (b, s), init (b, s) or null, eta (1,) on the device.
// gn_scratch (sk, sc); state_scratch (ceil(b / rows), 4, rows, sk) or
// null to keep the state in shared memory (both used by the classic
// route only); out (b, s).  route: 0 the shape's own (solve_route),
// 1 the classic kernel, 2 the cluster kernel, 3 the wide kernel (1-3
// force a kernel, for checks and tools); taken, unless null, receives the
// route launched.  The early stop: eps >= 0 turns it on (a negative eps
// or NaN is the build without it), with inv_count = 1 / (b s),
// stop_words (vtc_fista_stop_words 64-bit words, zeroed once and then
// reused with rising tags), iters (one int: the iterations run) and tag
// (>= 1; a later solve on the same words takes a tag past tag +
// num_iters); on the classic route it needs state_scratch.  Across
// ranks (K15 at a world above one) stop_local (1,) and stop_hook: the
// classic route an iteration a launch, the last block leaving the rank's
// sum of |codes - old| in stop_local, then stop_hook(iteration), which
// sums it over the ranks in stream order, then the decision; inv_count
// is then over the global batch and stop_words the classic route's
// (the first launch of a solve clears the flag).  Both null at one rank.
// tier: 0 'highest' (the routes above), 1 bf16, 2 bf16x3, 3 bf16x5: the
// tier kernel (route 0 only, taken 4), gn_scratch then of
// vtc_fista_tier_gn_floats floats, state_scratch null only where
// vtc_fista_tier_state_in_smem, the stop on the classic stop route (its
// words: vtc_fista_stop_words's classic count, kStopCtlWords +
// ceil(b / rows)), across ranks too (stop_local and stop_hook as above).
// Returns the CUDA error code of the launches (0 on success;
// cudaErrorUnknown when stop_hook failed).
int vtc_fused_fista(const float* gram, const float* corr, const float* init,
                    const float* eta, float lam, int num_iters, int b, int s,
                    int sk, int sc, int fista, int mode, float* gn_scratch,
                    float* state_scratch, float* out, int route, int* taken,
                    float eps, float inv_count, void* stop_words, int* iters,
                    unsigned tag, float* stop_local, RankHook stop_hook,
                    int tier, void* stream_ptr) {
  if (!solve_args_ok(b, s, num_iters, sk, sc) || mode < 0 || mode > 3 ||
      route < kRouteAuto || route > kRouteWide || tier < kTierHighest ||
      tier > kTierBf16x5 ||
      (eps >= 0.0f && (stop_words == nullptr || iters == nullptr ||
                       tag == 0)) ||
      ((stop_local == nullptr) != (stop_hook == nullptr)) ||
      (stop_hook != nullptr && (!(eps >= 0.0f) || state_scratch == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  SolveStop stop_args;
  const SolveStop* stop = solve_stop(&stop_args, eps, inv_count, stop_words,
                                     iters, tag, stop_local, stop_hook);
  cudaError_t err;
#define VTC_LAUNCH(F, M)                                                     \
  launch_solve<F, M, false>(gram, corr, init, eta, lam, num_iters, b, s, sk, \
                            sc, 1, gn_scratch, state_scratch, out, route,    \
                            taken, stream, stop, tier)
  if (fista) {
    switch (mode) {
      case kSoft: err = VTC_LAUNCH(true, kSoft); break;
      case kSoftNonneg: err = VTC_LAUNCH(true, kSoftNonneg); break;
      case kHard: err = VTC_LAUNCH(true, kHard); break;
      default: err = VTC_LAUNCH(true, kHardNonneg); break;
    }
  } else {
    switch (mode) {
      case kSoft: err = VTC_LAUNCH(false, kSoft); break;
      case kSoftNonneg: err = VTC_LAUNCH(false, kSoftNonneg); break;
      case kHard: err = VTC_LAUNCH(false, kHard); break;
      default: err = VTC_LAUNCH(false, kHardNonneg); break;
    }
  }
#undef VTC_LAUNCH
  return static_cast<int>(err);
}

}  // extern "C"
