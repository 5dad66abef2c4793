// Fused subspace (group) ISTA/FISTA solve for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel K4: vtc_tpu/ops/pallas_group_fista.py,
// group_fista_solve_pallas (:168) / _make_kernel (:54), with the group
// prox K5 (pallas_train_step.py, _make_group_prox :248 and
// roll_prox_window :227) inside.  Same contract: with G = Dg Dg^T
// (GM, GM) and c = X Dg^T (b, GM) of the grouped dictionary Dg computed
// outside the kernel (pallas_group_fista.py:214-216), every row of the
// packed (b, G*M) codes runs num_iters iterations of
//
//   codes = group_prox(z + z @ (-eta G) + eta c, lam * eta)
//
// with FISTA or ISTA momentum, an optional packed warm start and the
// optional batch-global early stop over the b*G*M packed entries
// (pallas_group_fista.py:105-130).  Group g
// is the window of slots [g*M, (g+1)*M); the slots a short group pads are
// zero rows of Dg, so they stay exactly zero and add nothing to a norm,
// and the TPU kernel's 0/1 membership operand has no counterpart.  One
// prox serves every M, with the semantics of thresholds.group_shrink
// (IEEE sqrtf and division, norm 0 -> 1; hard: norm < t -> 0): the TPU's
// two forms (rsqrt on power-of-two windows, membership matmuls
// otherwise) agree with it to 1e-6.
//
// The kernels are K1's (fista_core.cuh) with the group prox as their
// epilogue.  The classic kernel writes the pre-prox rows to the block's
// state, synchronises, and runs one pass over (row, group) pairs.  The
// cluster kernel, which takes the small batches, keeps a thread's four
// neighbouring columns in registers: for M in {1, 2, 4} they hold whole
// groups, so it takes each group's norm and scale there, with no barrier
// and no second pass; an M that divides a CTA's columns but not 4 takes
// one CTA-local shared-memory pass, and an M that does not divide them
// is routed to the classic kernel (solve_route).  The wide kernel, which
// takes the batches that fill the card, has the same four-column
// register prox and takes only M in {1, 2, 4}; other M at those batches
// stay on the classic kernel.  The tiers other than 'highest' run
// fista_tier.cuh's bf16 tensor-core kernel at every M, its group prox
// rounding as vtc_tpu's _make_prox_dots where M is not a power of two.
#include "fista_tier.cuh"

extern "C" {

// The solves vtc_fused_group_fista has launched on each route (0-6)
// since the last reset: K4's, K6's, K7's and K16's among them.
static long long route_launches[kRouteTierWide + 1];
long long vtc_group_fista_route_launches(int route) {
  return route >= 0 && route <= kRouteTierWide ? route_launches[route] : -1;
}
void vtc_group_fista_reset_route_launches() {
  for (long long& count : route_launches) count = 0;
}

// gram (gm, gm), corr (b, gm), init (b, gm) or null, eta (1,) on the
// device, gm = groups * group_size.  gn_scratch (sk, sc); state_scratch
// (ceil(b / rows), 4, rows, sk) or null to keep the state in shared
// memory (the sizes of vtc_fused_fista); out (b, gm).  hard: 0 soft,
// 1 hard group thresholding.  route, taken and the early stop (eps,
// inv_count = 1 / (b gm), stop_words, iters, tag, and across ranks, for
// K16, stop_local and stop_hook) and tier as in vtc_fused_fista.  Returns
// the CUDA error code (0 on success).
int vtc_fused_group_fista(const float* gram, const float* corr,
                          const float* init, const float* eta, float lam,
                          int num_iters, int b, int gm, int group_size,
                          int sk, int sc, int fista, int hard,
                          float* gn_scratch, float* state_scratch, float* out,
                          int route, int* taken, float eps, float inv_count,
                          void* stop_words, int* iters, unsigned tag,
                          float* stop_local, RankHook stop_hook, int tier,
                          void* stream_ptr) {
  if (!solve_args_ok(b, gm, num_iters, sk, sc, route, tier) ||
      group_size < 1 || gm % group_size != 0 ||
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
#define VTC_LAUNCH(F, M)                                                    \
  launch_solve<F, M, true>(gram, corr, init, eta, lam, num_iters, b, gm, sk, \
                           sc, group_size, gn_scratch, state_scratch, out,  \
                           route, &route_taken, stream, stop, tier)
  if (fista)
    err = hard ? VTC_LAUNCH(true, kHard) : VTC_LAUNCH(true, kSoft);
  else
    err = hard ? VTC_LAUNCH(false, kHard) : VTC_LAUNCH(false, kSoft);
#undef VTC_LAUNCH
  if (err == cudaSuccess) ++route_launches[route_taken];
  if (taken != nullptr) *taken = route_taken;
  return static_cast<int>(err);
}

}  // extern "C"
