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

// The plan of a solve at tier (1 bf16, 2 bf16x3, 3 bf16x5) of b rows of s
// codes in groups of group_size on this device, for route (0: the shape's
// own, tier_route's, or with stop its stop route; 4-6 forced) with the
// stop or not (stop) and across ranks or not (ranks): plan[0] the route
// (4 fista_tier_kernel, 5 the tier cluster route, 6 the tier wide route),
// then on a resident route the CTAs a cluster, the rows a cluster, its
// buffers of z terms and the card's slots for clusters of that size.  Returns 0 or the CUDA error
// (cudaErrorInvalidValue for a forced route that does not fit).
int vtc_fista_tier_plan(int b, int s, int group_size, int tier, int route,
                        int stop, int ranks, int* plan) {
  if (b <= 0 || s <= 0 || tier < kTierBf16 || tier > kTierBf16x5)
    return static_cast<int>(cudaErrorInvalidValue);
  TierPlan got;
  const cudaError_t err = device_tier_plan(
      b, s, (s + kChunk - 1) / kChunk * kChunk, group_size, tier, route,
      stop != 0, ranks != 0, &got);
  plan[0] = got.route;
  plan[1] = got.cluster;
  plan[2] = got.rows;
  plan[3] = got.bufs;
  plan[4] = got.slots;
  return static_cast<int>(err);
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

// The solves vtc_fused_fista has launched on each route (0-6) since the
// last reset: every caller's, K2's, K3's and K15's steps among them.
static long long route_launches[kRouteTierWide + 1];
long long vtc_fista_route_launches(int route) {
  return route >= 0 && route <= kRouteTierWide ? route_launches[route] : -1;
}
void vtc_fista_reset_route_launches() {
  for (long long& count : route_launches) count = 0;
}

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
// tier routes (route 0, the shape's own, or 4-6, forced: taken 4
// fista_tier_kernel, 5 the tier cluster route, 6 the tier wide route;
// vtc_fista_tier_plan gives the route and its stop words, kStopCtlWords +
// ceil(b / rows) on route 4, two a CTA on 5 and 6); gn_scratch then of
// vtc_fista_tier_gn_floats floats, state_scratch null only where
// vtc_fista_tier_state_in_smem (both used by route 4 only); across ranks
// the stop takes route 4 (stop_local and stop_hook as above).  Every
// launch adds one to route_launches[taken].  Returns the CUDA error code
// of the launches (0 on success; cudaErrorUnknown when stop_hook failed).
int vtc_fused_fista(const float* gram, const float* corr, const float* init,
                    const float* eta, float lam, int num_iters, int b, int s,
                    int sk, int sc, int fista, int mode, float* gn_scratch,
                    float* state_scratch, float* out, int route, int* taken,
                    float eps, float inv_count, void* stop_words, int* iters,
                    unsigned tag, float* stop_local, RankHook stop_hook,
                    int tier, void* stream_ptr) {
  if (!solve_args_ok(b, s, num_iters, sk, sc, route, tier) || mode < 0 ||
      mode > 3 ||
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
  int route_taken = kRouteAuto;
#define VTC_LAUNCH(F, M)                                                     \
  launch_solve<F, M, false>(gram, corr, init, eta, lam, num_iters, b, s, sk, \
                            sc, 1, gn_scratch, state_scratch, out, route,    \
                            &route_taken, stream, stop, tier)
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
  if (err == cudaSuccess) ++route_launches[route_taken];
  if (taken != nullptr) *taken = route_taken;
  return static_cast<int>(err);
}

}  // extern "C"
