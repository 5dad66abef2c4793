// Fused convolutional train steps for Hopper (sm_90a), CUDA C++.
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
// gathered implicit GEMM of conv_gemm.cuh for corr, the synthesis (mask
// in the epilogue) and the analysis (shrink and momentum in the
// epilogue).  The update's synthesis is the same GEMM with the residual
// epilogue.  The batch is one tile: the TPU kernel's batch tiles and its
// gram-form tile accumulators (:501-516) exist for VMEM only and have no
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
#include "conv_gemm.cuh"
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

// h[j] = 0.99 h[j] + (sum_{b, y, x} codes[b, j, y, x]^2 / b) / 100, one
// block per kernel j, summed in a fixed order.
__global__ void __launch_bounds__(kRowThreads)
    conv_hessian_ema_kernel(const float* __restrict__ codes,
                            float* __restrict__ h, int b, int s, int chw) {
  __shared__ float scratch[33];
  const int j = blockIdx.x;
  const int count = b * chw;
  float acc = 0.0f;
  for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
    const int bb = idx / chw;
    const float c =
        codes[(static_cast<int64_t>(bb) * s + j) * chw + (idx - bb * chw)];
    acc = fmaf(c, c, acc);
  }
  const float total = block_sum(acc, scratch);
  if (threadIdx.x == 0)
    h[j] = __fadd_rn(__fmul_rn(0.99f, h[j]),
                     (total / static_cast<float>(b)) / 100.0f);
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
        if (col < rs) {
          const int a = col / s;
          const int j = col - a * s;
          const int by = pos / bw;
          const int y = by - a / ax;
          const int x = (pos - by * bw) - a % ax;
          if (y >= 0 && y < code_h && x >= 0 && x < code_w)
            bv = codes[((static_cast<int64_t>(bb) * s + j) * code_h + y) *
                           code_w + x];
        }
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

// grad[e] = (sum over splits, in order, of partial[split, e]) / b
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
// quadratic.  Returns the first CUDA error code (0 on success).
int vtc_conv_train_segment(float* dstk, float* h, float* v, const float* xblk,
                           const float* mblk, const float* supp, int k, int b,
                           int s, int cpx, int ay, int ax, int bh, int bw,
                           float lam, int num_iters, float upd_step,
                           int upd_num_iters, float lowest, int fista,
                           int mode, int update, int renorm, int power_iters,
                           float* dall, float* gram, float* eta, float* img,
                           float* corr, float* z, float* old, float* partial,
                           float* grad, void* stream_ptr) {
  const int code_h = bh - (ay - 1), code_w = bw - (ax - 1);
  if (k < 0 || b < 1 || s < 1 || s > kMaxKernels || cpx < 1 || ay < 1 ||
      ax < 1 || code_h < 1 || code_w < 1 || num_iters < 0 ||
      upd_num_iters < 0 || power_iters < 0 || mode < 0 || mode > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int r = ay * ax;
  const int blocks = bh * bw;
  const int chw = code_h * code_w;
  const int64_t kdim = static_cast<int64_t>(b) * blocks;
  const int splits = static_cast<int>((kdim + kGradChunk - 1) / kGradChunk);
  const int weights = cpx * r * s;
  const size_t code_bytes = sizeof(float) * static_cast<size_t>(b) * s * chw;
  cudaError_t err = power_setup(s);
  if (err != cudaSuccess) return static_cast<int>(err);

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
  synth.lines = kAll;
  synth.epilogue = kMaskStore;
  synth.out = img;
  synth.mask = mblk;

  GemmArgs resid = synth;  // mask * S(dstk, codes) - xblk
  resid.src = old;
  resid.epilogue = kMaskResid;

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
  anal.lines = kAll;
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

  GemmArgs corr_args = anal;
  corr_args.epilogue = kStore;
  corr_args.out = corr;

  const dim3 grad_grid((r * s + kTile - 1) / kTile, (cpx + kTile - 1) / kTile,
                       splits);
#define VTC_CHECK(...)                                    \
  do {                                                    \
    err = (__VA_ARGS__);                                  \
    if (err != cudaSuccess) return static_cast<int>(err); \
  } while (0)
#define VTC_LAUNCHED() VTC_CHECK(cudaGetLastError())
  for (int step = 0; step < k; ++step) {
    const float* xs = xblk + static_cast<int64_t>(step) * b * cpx * blocks;
    // the stepsize: flat-kernel Gram and the warm power refresh
    dall_from_dstk_kernel<<<(weights + 255) / 256, 256, 0, stream>>>(
        dstk, dall, cpx, r, s);
    VTC_LAUNCHED();
    VTC_CHECK(gemm<false, true>(dall, dall, nullptr, gram, s, s, r * cpx,
                                stream));
    VTC_CHECK(power_refresh(gram, v, eta, s, power_iters, stream));
    // the solve (K10's), from zero codes
    corr_args.src = xs;
    VTC_CHECK(launch_gather_gemm(corr_args, 1, chw, stream));
    VTC_CHECK(cudaMemsetAsync(z, 0, code_bytes, stream));
    VTC_CHECK(cudaMemsetAsync(old, 0, code_bytes, stream));
    float t = 1.0f;
    for (int it = 0; it < num_iters; ++it) {
      anal.beta = fista ? fista_beta(&t) : 0.0f;
      VTC_CHECK(launch_gather_gemm(synth, 1, blocks, stream));
      VTC_CHECK(launch_gather_gemm(anal, 1, chw, stream));
    }
    if (update == 1) {
      conv_hessian_ema_kernel<<<s, kRowThreads, 0, stream>>>(old, h, b, s,
                                                             chw);
      VTC_LAUNCHED();
    }
    resid.extra = xs;
    for (int u = 0; u < upd_num_iters; ++u) {
      VTC_CHECK(launch_gather_gemm(resid, 1, blocks, stream));
      block_grad_partial_kernel<<<grad_grid, kGemmThreads, 0, stream>>>(
          img, old, partial, cpx, s, ax, r, bh, bw, code_h, code_w, kdim);
      VTC_LAUNCHED();
      grad_reduce_kernel<<<(weights + 255) / 256, 256, 0, stream>>>(
          partial, grad, splits, weights, static_cast<float>(b));
      VTC_LAUNCHED();
      conv_update_kernel<<<1, kUpdateThreads, 0, stream>>>(
          dstk, grad, supp, h, cpx, r, s, upd_step, lowest, update == 1,
          renorm);
      VTC_LAUNCHED();
    }
  }
#undef VTC_LAUNCHED
#undef VTC_CHECK
  return 0;
}

}  // extern "C"
