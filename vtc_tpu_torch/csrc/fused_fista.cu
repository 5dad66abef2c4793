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
// momentum and an optional warm start.  The kernel, what bounds it and
// what its design does about it are in fista_core.cuh, which K4 shares:
// this file instantiates its elementwise-shrink variants.
#include "fista_core.cuh"

extern "C" {

// Layout constants, read by the Python wrappers to size their scratch.
int vtc_fista_rows() { return kRows; }
int vtc_fista_chunk() { return kChunk; }
int vtc_fista_col_block() { return kColBlock; }
int vtc_fista_slice_bytes() {
  return 2 * kSliceFloats * static_cast<int>(sizeof(float));
}

// gram (s, s), corr (b, s), init (b, s) or null, eta (1,) on the device.
// gn_scratch (sk, sc); state_scratch (ceil(b / rows), 4, rows, sk) or
// null to keep the state in shared memory; out (b, s).
// Returns the CUDA error code of the launches (0 on success).
int vtc_fused_fista(const float* gram, const float* corr, const float* init,
                    const float* eta, float lam, int num_iters, int b, int s,
                    int sk, int sc, int fista, int mode, float* gn_scratch,
                    float* state_scratch, float* out, void* stream_ptr) {
  if (!solve_args_ok(b, s, num_iters, sk, sc) || mode < 0 || mode > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  cudaError_t err;
#define VTC_LAUNCH(F, M)                                                     \
  launch_solve<F, M, false>(gram, corr, init, eta, lam, num_iters, b, s, sk, \
                            sc, 1, gn_scratch, state_scratch, out, stream)
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
