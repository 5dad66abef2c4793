// Direct-formulation convolutional ISTA/FISTA solve for Hopper (sm_90a),
// CUDA C++.
//
// Replaces the TPU kernel K10: vtc_tpu/ops/pallas_conv_direct.py,
// conv_direct_solve_pallas (:355) / _make_kernel (:255).  Same contract:
// in stride-block space (the padded image cut into sv x sh blocks, the
// kernels zero-extended to a multiple of the stride and cut into
// R = (khp/sv)*(kwp/sh) parts Dpart[a] of (s, c*sv*sh)), every sample
// runs num_iters iterations of
//
//   img[B]    = mblk[B] * sum_a Dpart[a]^T z[B - a]     (synthesis, masked)
//   grad[c]   = sum_a Dpart[a] img[c + a] - corr[c]     (analysis)
//   codes     = shrink(z - eta * grad, lam * eta)
//   z         = codes + beta_k (codes - old) (FISTA) or codes (ISTA)
//
// with corr = A(mask * X) computed once per solve by the analysis
// product, as the TPU kernel computes it in-kernel (:278-284).
//
// What bounds it here.  Both products are deep (R*s = R*c*sv*sh = 256 at
// the flagship: 64 kernels of 16x16 at stride 8) and cost 2*64*256 FLOPs
// per image block or code position: 73.6 MFLOP per sample-iteration at
// 272x272 images, about 4.4 ms for 40 images and 100 iterations at the
// 67 TFLOP/s fp32 SIMT peak.  The state moves 23 MB per batch of 40, so
// the solve is bound by operations, not bytes; but each iteration's
// epilogues read and write about 100 MB of state (the analysis reads z,
// corr and old and writes z and old), which the GEMM must stream in
// coalesced runs to stay near its FMA rate.
//
// Layout.  One sample's state (z, old, corr and its image blocks, 1.1 MB
// at the flagship) does not fit the 227 KB a block may hold, so the TPU
// kernel's residency cannot be copied: the state lives in device memory
// (45 MB at batch 40, near the 50 MB L2) and the host enqueues two
// kernels per iteration from one C loop, never waiting inside a solve.
// Each is conv_gemm.cuh's tiled gathered GEMM over every position (64 x
// 128 tiles, 8 x 8 fp32 FMA outputs a thread, a two-stage cp.async ring,
// the k offsets in a shared-memory table; 64-wide tiles at small
// batches): the synthesis over every image block with the mask in its
// epilogue, then the analysis over every code position with the shrink
// and the momentum in its epilogue, each written through shared memory
// in coalesced rows.  The analysis reads only the image blocks and
// rewrites z at its own positions, so z is updated in place.  A
// cooperative kernel with a grid barrier per iteration, or a cluster
// that keeps a sample in distributed shared memory, is later work.
//
// The early stop (vtc_tpu's :307-334): with stop words every launch of
// the loop is its STOP build (conv_gemm.cuh, "The early stop").  The loop
// still enqueues all num_iters iterations without waiting; the analysis
// launch of each iteration decides on the device, and the launches after
// a stop return at entry, leaving the codes of the last iteration run in
// old and the count in *iters.
// The precision tiers (vtc_tpu's mxu_precision, :263-269): at a tier
// other than 'highest' the weights are split into bf16 planes once per
// solve and the three products (corr, the synthesis and the analysis) run
// conv_gemm_tier.cuh's bf16 tensor-core GEMM with the same epilogues and
// early stop, on the window route where conv_tier_plan sends them (the
// flagship's every product), else gather_gemm_tier, bitwise alike; the
// mask, the prox, the momentum and the stop test stay float32.
// tests/test_torch_port_conv.py and tests/test_torch_port_conv_tiers.py
// hold the plain version of this layout to vtc_tpu's kernel;
// chip_smoke.py holds this kernel to it.
#include "conv_gemm.cuh"
#include "conv_gemm_tier.cuh"

extern "C" {

// dstk (cpx, R*s) and dall (s, R*cpx) packed weights; mblk (cpx, bh, bw)
// block mask; xblk (b, cpx, bh, bw) masked image blocks; eta (1,) on the
// device.  img (b, cpx, bh, bw) and corr (b, s, ch, cw) are scratch; z
// and old (b, s, ch, cw) hold the initial codes on entry, and old holds
// the codes on return.  stop_words: null for the loop without the stop,
// else the zeroed conv_stop_words() array of the early stop at eps over
// a mean of inv_count (1 / (b s code_h code_w)), with iters (1,)
// receiving the count.  tier: 'highest' (kTierHighest) or a tier of
// tier_codes.cuh, with tier_scratch the vtc_conv_tier_words() words of
// the split weights (null at 'highest'); route: the tier products' route
// (0 the plan's; 1 gather_gemm_tier or 2 the window route forced, for
// checks, a product the forced route cannot take failing).  Returns the
// CUDA error of the launches.
int vtc_conv_direct(const float* dstk, const float* dall, const float* mblk,
                    const float* xblk, const float* eta, float lam,
                    int num_iters, int b, int s, int cpx, int ay, int ax,
                    int bh, int bw, int fista, int mode, float* img,
                    float* corr, float* z, float* old, float eps,
                    float inv_count, unsigned long long* stop_words,
                    int* iters, int tier, void* tier_scratch, int route,
                    void* stream_ptr) {
  const int code_h = bh - (ay - 1), code_w = bw - (ax - 1);
  if (b < 1 || s < 1 || cpx < 1 || ay < 1 || ax < 1 || code_h < 1 ||
      code_w < 1 || num_iters < 0 || mode < 0 || mode > 3 || tier < 0 ||
      tier > kTierBf16x5 || (tier != kTierHighest && tier_scratch == nullptr) ||
      route < kConvRouteAuto || route > kConvRouteWindow)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int r = ay * ax;

  GemmArgs synth = {};
  synth.a = dstk;
  synth.m = cpx;
  synth.k = r * s;
  synth.src = z;
  synth.src_c = s;
  synth.src_h = code_h;
  synth.src_w = code_w;
  synth.off_w = ax;
  synth.sign = -1;  // z[B - a]
  synth.nb = b;
  synth.out_h = bh;
  synth.out_w = bw;
  synth.epilogue = kMaskStore;
  synth.out = img;
  synth.mask = mblk;

  GemmArgs anal = {};
  anal.a = dall;
  anal.m = s;
  anal.k = r * cpx;
  anal.src_c = cpx;
  anal.src_h = bh;
  anal.src_w = bw;
  anal.off_w = ax;
  anal.sign = 1;  // y[c + a]
  anal.nb = b;
  anal.out_h = code_h;
  anal.out_w = code_w;

  // at a tier, the weights' planes, once per solve
  const ConvTierWeights planes(tier, route, tier_scratch, s, cpx, r);
  cudaError_t err = planes.fold(dstk, dall, s, cpx, r, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  // corr = A(mask * X), once per solve
  GemmArgs corr_args = anal;
  corr_args.src = xblk;
  corr_args.epilogue = kStore;
  corr_args.out = corr;
  err = launch_conv_product(planes, corr_args, planes.all, code_h * code_w,
                            false, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  anal.src = img;
  anal.epilogue = kProx;
  anal.out = z;
  anal.z_cur = z;
  anal.corr = corr;
  anal.old = old;
  anal.eta = eta;
  anal.lam = lam;
  anal.fista = fista;
  anal.shrink = mode;
  const bool stop = stop_words != nullptr;
  if (stop) {
    synth.stop.words = anal.stop.words = stop_words;
    anal.stop.iters = iters;
    anal.stop.eps = eps;
    anal.stop.inv_count = inv_count;
    synth.stop.tag = anal.stop.tag = 1u;
  }
  float t = 1.0f;
  for (int it = 0; it < num_iters; ++it) {
    anal.beta = fista ? fista_beta(&t) : 0.0f;
    anal.stop.it = it;
    err = launch_conv_product(planes, synth, planes.stk, bh * bw, stop,
                              stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_conv_product(planes, anal, planes.all, code_h * code_w, stop,
                              stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

// The 64-bit words of the conv solves' stop array for s codes at
// `positions` code positions (b * code_h * code_w).
long long vtc_conv_stop_words(int s, long long positions) {
  return conv_stop_words(s, positions);
}

// The 32-bit words of a conv solve's split weights at a tier (0 at
// 'highest'): dstk's (cpx x R*s) planes and dall's (s x R*cpx).
long long vtc_conv_tier_words(int tier, int s, int cpx, int r) {
  return conv_tier_words(tier, cpx, r * s) + conv_tier_words(tier, s, r * cpx);
}

// The largest K (R*s or R*cpx) the tier kernel takes: its offset table's.
int vtc_conv_tier_max_k() { return kTableMaxK; }

// The tier GEMM's plan (conv_gemm_tier.cuh's conv_tier_plan) of a product
// of m rows, depth k over src_c channels, off_w offsets a row, nb images
// of out_h x out_w positions at tier on sm_count SMs (0: this card's): out
// receives the route (1 gather_gemm_tier, 2 window), rows a tile,
// m-blocks, tiles, grid and shared memory a CTA.
void vtc_conv_tier_plan(int m, int k, int src_c, int off_w, int out_h,
                        int out_w, int nb, int tier, int sm_count,
                        long long* out) {
  const ConvTierPlan plan =
      conv_tier_plan(m, k, src_c, off_w, out_h, out_w, nb, tier,
                     sm_count > 0 ? sm_count : gemm_sm_count());
  const long long values[6] = {plan.route, plan.rows, plan.mblocks,
                               plan.tiles, plan.grid, plan.smem};
  for (int i = 0; i < 6; ++i) out[i] = values[i];
}

// The window kernel's registers, local (spill) bytes a thread and CTAs an
// SM (the occupancy API) at `smem` bytes of dynamic shared memory, into
// out[0..2]; returns the CUDA error of the queries.
int vtc_conv_window_attrs(int tier, int stop, int64_t smem, int* out) {
  cudaFuncAttributes attr = {};
  const void* fn = nullptr;
#define VTC_FN(T)                                                         \
  fn = stop ? reinterpret_cast<const void*>(conv_window_gemm<T, true>)    \
            : reinterpret_cast<const void*>(conv_window_gemm<T, false>)
  switch (tier) {
    case kTierBf16: VTC_FN(kTierBf16); break;
    case kTierBf16x3: VTC_FN(kTierBf16x3); break;
    case kTierBf16x5: VTC_FN(kTierBf16x5); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef VTC_FN
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kWinSmem));
  int ctas = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &ctas, fn, kWinThreads, static_cast<size_t>(smem));
  out[0] = attr.numRegs;
  out[1] = static_cast<int>(attr.localSizeBytes);
  out[2] = ctas;
  return static_cast<int>(err);
}

// The tier products launched on each route (1, 2) since the last reset,
// by every conv entry of the library; and the reset.
long long vtc_conv_tier_route_launches(int route) {
  return route >= 1 && route <= 2 ? vtc_conv_tier_route_count[route] : -1;
}
void vtc_conv_tier_reset_route_launches() {
  for (long long& count : vtc_conv_tier_route_count) count = 0;
}

// One tier GEMM over every position, for checks and tools: a (m x k fp32)
// split at tier into planes (vtc_conv_tier_product_words(tier, m, k)
// words), then C = a src[gather] on `route` (0 the plan's, 1, 2) with the
// epilogue and its inputs as GemmArgs names them; stop_words non-null:
// the STOP build at iteration `it` (tag 1, eps over inv_count, the count
// into iters).  Returns the CUDA error of the launches.
int vtc_conv_tier_product(int route, int tier, const float* a, int m, int k,
                          const float* src, int src_c, int src_h, int src_w,
                          int off_w, int sign, int off_y0, int off_x0, int nb,
                          int out_h, int out_w, int epilogue, float* out,
                          const float* mask, const float* z_cur,
                          const float* corr, const float* extra, float* old,
                          const float* eta, float lam, float beta, int fista,
                          int shrink, void* planes,
                          unsigned long long* stop_words, int* iters,
                          float eps, float inv_count, int it,
                          void* stream_ptr) {
  if (tier < kTierBf16 || tier > kTierBf16x5 || planes == nullptr ||
      m < 1 || k < 1 || src_c < 1 || k % src_c != 0 || off_w < 1 ||
      nb < 1 || out_h < 1 || out_w < 1 ||
      (stop_words != nullptr && (iters == nullptr || epilogue != kProx)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  uint32_t* words = static_cast<uint32_t*>(planes);
  cudaError_t err = fold_conv_tier(tier, a, m, k, words, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  GemmArgs p = {};
  p.a = a;
  p.m = m;
  p.k = k;
  p.src = src;
  p.src_c = src_c;
  p.src_h = src_h;
  p.src_w = src_w;
  p.off_w = off_w;
  p.sign = sign;
  p.off_y0 = off_y0;
  p.off_x0 = off_x0;
  p.nb = nb;
  p.out_h = out_h;
  p.out_w = out_w;
  p.epilogue = epilogue;
  p.out = out;
  p.mask = mask;
  p.z_cur = z_cur;
  p.corr = corr;
  p.extra = extra;
  p.old = old;
  p.eta = eta;
  p.lam = lam;
  p.beta = beta;
  p.fista = fista;
  p.shrink = shrink;
  if (stop_words != nullptr) {
    p.stop.words = stop_words;
    p.stop.iters = iters;
    p.stop.eps = eps;
    p.stop.inv_count = inv_count;
    p.stop.tag = 1u;
    p.stop.it = it;
  }
  if (!tier_gemm_fits(p)) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_conv_tier_route(
      route, tier, p, words, stop_words != nullptr, stream));
}

// The 32-bit words of one product's split weights (m x k) at a tier.
long long vtc_conv_tier_product_words(int tier, int m, int k) {
  return conv_tier_words(tier, m, k);
}

}  // extern "C"
