// The per-step kernels shared by K2 (fused_train_step.cu, fc train
// segments), K6 (fused_group_train_step.cu, subspace train segments), K8
// (fused_ica_train_step.cu, ICA segments; the product only), K12
// (fused_conv_train_step.cu, conv segments; the product and the power
// refresh) and K19 (fused_code_shard_train_step.cu, residual-form
// segments; the product tile, the power refresh, the Hessian EMA, the row
// update and the sign mask), by the per-shard solve+stats steps K3, K7
// and K9 beside K2, K6 and K8 (the gram-form statistics), and by the
// whole-segment data-parallel loops K15, K16, K17 and K18 (the host hook's
// contract and the Hessian EMA from a summed statistic), for Hopper
// (sm_90a).  Included by each: everything here has internal linkage.
//
// Precision.  Every product is IEEE fp32 FMA on the CUDA cores: no TF32,
// no tensor cores, no library call.  The update gradient is a small
// difference of large products, so it stays full fp32, as it does in
// every tier of the TPU kernels (pallas_train_step.py:400-409).  Square
// roots and divisions are IEEE sqrtf and '/', no rsqrt intrinsics.
// At the tier 'bf16' K2 and K6 take c = X D^T as one bf16 pass
// (pallas_train_step.py:411, :588): round_bf16 rounds both operands to
// bf16 values first, and the fp32 product of those values is that pass
// (each term exact in fp32, the sum fp32).
// Ragged shapes are masked inside every kernel.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tier_codes.cuh"

namespace {

constexpr int kTile = 32;        // output tile edge and depth of a k-slice
constexpr int kGemmThreads = 256;  // 32 columns x 8 row groups of 4
constexpr int kPowerThreads = 1024;
constexpr int kRowThreads = 256;

// acc[r] += the sum over k in [k_begin, k_end) of op(A)[i, k] op(B)[k, j]
// for the thread's output column j = j0 + (tid & 31) and rows
// i = i0 + (tid >> 5) * 4 + r: one 32 x 32 output tile of the fp32 SIMT
// product, 256 threads of 4 outputs.  TA: A is stored (K, M); otherwise
// (M, K).  TB: B is stored (N, K); otherwise (K, N).  All row-major and
// contiguous.  The sum over k runs in order, one FMA per term; every
// thread of the block must call it.
template <bool TA, bool TB>
__device__ __forceinline__ void gemm_tile(const float* __restrict__ A,
                                          const float* __restrict__ B,
                                          int M, int N, int K, int i0,
                                          int j0, int k_begin, int k_end,
                                          float acc[4]) {
  __shared__ float As[kTile][kTile + 1];  // As[k][i]
  __shared__ float Bs[kTile][kTile + 1];  // Bs[k][j]
  const int tid = threadIdx.x;
  const int tx = tid & 31;   // output column within the tile
  const int ty = tid >> 5;   // owns output rows ty*4 .. ty*4+3
  for (int k0 = k_begin; k0 < k_end; k0 += kTile) {
    // neighbouring threads read neighbouring addresses in both layouts
    for (int idx = tid; idx < kTile * kTile; idx += kGemmThreads) {
      const int hi = idx >> 5;
      const int lo = idx & 31;
      {
        const int ii = TA ? lo : hi;
        const int kk = TA ? hi : lo;
        const int i = i0 + ii;
        const int k = k0 + kk;
        float a = 0.0f;
        if (i < M && k < k_end)
          a = TA ? A[static_cast<int64_t>(k) * M + i]
                 : A[static_cast<int64_t>(i) * K + k];
        As[kk][ii] = a;
      }
      {
        const int jj = TB ? hi : lo;
        const int kk = TB ? lo : hi;
        const int j = j0 + jj;
        const int k = k0 + kk;
        float bv = 0.0f;
        if (j < N && k < k_end)
          bv = TB ? B[static_cast<int64_t>(j) * K + k]
                  : B[static_cast<int64_t>(k) * N + j];
        Bs[kk][jj] = bv;
      }
    }
    __syncthreads();
    const int kn = k_end - k0 < kTile ? k_end - k0 : kTile;
    for (int kk = 0; kk < kn; ++kk) {
      const float bv = Bs[kk][tx];
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[r] = fmaf(As[kk][ty * 4 + r], bv, acc[r]);
    }
    __syncthreads();
  }
}

// C (M, N) = op(A) (M, K) @ op(B) (K, N), minus X (M, N) when X is given
// (NEG: X minus the product), with gemm_tile's layouts.  With run_if
// given, the launch does nothing unless *run_if is nonzero (a branch
// decided on the device, K8's boost).
template <bool TA, bool TB, bool NEG = false>
__global__ void __launch_bounds__(kGemmThreads)
    gemm_kernel(const float* __restrict__ A, const float* __restrict__ B,
                const float* __restrict__ X, float* __restrict__ C, int M,
                int N, int K, const int* __restrict__ run_if) {
  if (run_if != nullptr && *run_if == 0) return;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  gemm_tile<TA, TB>(A, B, M, N, K, i0, j0, 0, K, acc);

  const int j = j0 + tx;
  if (j >= N) return;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    if (i < M) {
      const int64_t at = static_cast<int64_t>(i) * N + j;
      if (X == nullptr) C[at] = acc[r];
      else C[at] = NEG ? X[at] - acc[r] : acc[r] - X[at];
    }
  }
}

template <bool TA, bool TB, bool NEG = false>
cudaError_t gemm(const float* A, const float* B, const float* X, float* C,
                 int M, int N, int K, cudaStream_t stream,
                 const int* run_if = nullptr) {
  const dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile);
  gemm_kernel<TA, TB, NEG><<<grid, kGemmThreads, 0, stream>>>(
      A, B, X, C, M, N, K, run_if);
  return cudaGetLastError();
}

// Sum of x over the block; every thread gets the total.  scratch holds
// one float per warp plus one for the result.
__device__ float block_sum(float x, float* scratch) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  __syncthreads();  // scratch may still be read from the previous call
  if (lane == 0) scratch[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float y = lane < warps ? scratch[lane] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      y += __shfl_down_sync(0xffffffffu, y, off);
    if (lane == 0) scratch[32] = y;
  }
  __syncthreads();
  return scratch[32];
}

// w = P v for the symmetric (dim, dim) Gram P: one warp per row.
__device__ void gram_matvec(const float* __restrict__ P, const float* v,
                            float* w, int dim) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  for (int j = warp; j < dim; j += warps) {
    const float* row = P + static_cast<int64_t>(j) * dim;
    float acc = 0.0f;
    for (int i = lane; i < dim; i += 32) acc = fmaf(row[i], v[i], acc);
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) w[j] = acc;
  }
  __syncthreads();
}

// Bytes of dynamic shared memory the power refresh takes for a Gram of
// size dim.
inline int power_smem_bytes(int dim) {
  return static_cast<int>((2 * static_cast<int64_t>(dim) + 33) *
                          sizeof(float));
}

// The warm Lipschitz refresh, one block: v = v / |v|, then iters times
// v = P v / |P v|; eta = 1 / ((P v) . v).  v is read and written in
// place; eta[0] receives the stepsize.
__global__ void __launch_bounds__(kPowerThreads)
    power_kernel(const float* __restrict__ P, float* __restrict__ v_io,
                 float* __restrict__ eta, int dim, int iters) {
  extern __shared__ float smem[];
  float* v = smem;
  float* w = smem + dim;
  float* scratch = smem + 2 * dim;  // 33 floats
  float part = 0.0f;
  for (int j = threadIdx.x; j < dim; j += blockDim.x) {
    const float x = v_io[j];
    v[j] = x;
    part = fmaf(x, x, part);
  }
  float norm = sqrtf(block_sum(part, scratch));
  for (int j = threadIdx.x; j < dim; j += blockDim.x) v[j] = v[j] / norm;
  __syncthreads();
  for (int it = 0; it < iters; ++it) {
    gram_matvec(P, v, w, dim);
    part = 0.0f;
    for (int j = threadIdx.x; j < dim; j += blockDim.x)
      part = fmaf(w[j], w[j], part);
    norm = sqrtf(block_sum(part, scratch));
    for (int j = threadIdx.x; j < dim; j += blockDim.x) v[j] = w[j] / norm;
    __syncthreads();
  }
  gram_matvec(P, v, w, dim);
  part = 0.0f;
  for (int j = threadIdx.x; j < dim; j += blockDim.x) {
    part = fmaf(w[j], v[j], part);
    v_io[j] = v[j];
  }
  const float eig = block_sum(part, scratch);
  if (threadIdx.x == 0) eta[0] = 1.0f / eig;
}

// Opt the power kernel into the dynamic shared memory of dim, once per
// segment.
cudaError_t power_setup(int dim) {
  return cudaFuncSetAttribute(power_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              power_smem_bytes(dim));
}

cudaError_t power_refresh(const float* P, float* v, float* eta, int dim,
                          int iters, cudaStream_t stream) {
  power_kernel<<<1, kPowerThreads, power_smem_bytes(dim), stream>>>(
      P, v, eta, dim, iters);
  return cudaGetLastError();
}

// h = 0.99 h + (sum_b codes^2 * inv_b) / 100, one thread per column.
__global__ void hessian_ema_kernel(const float* __restrict__ codes,
                                   float* __restrict__ h, int b, int s,
                                   float inv_b) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= s) return;
  float acc = 0.0f;
  for (int r = 0; r < b; ++r) {
    const float c = codes[static_cast<int64_t>(r) * s + j];
    acc = fmaf(c, c, acc);
  }
  h[j] = 0.99f * h[j] + (acc * inv_b) / 100.0f;
}

cudaError_t hessian_ema(const float* codes, float* h, int b, int s,
                        float inv_b, cudaStream_t stream) {
  hessian_ema_kernel<<<(s + 255) / 256, 256, 0, stream>>>(codes, h, b, s,
                                                          inv_b);
  return cudaGetLastError();
}

// The whole-segment data-parallel loops (K15-K18) run each step's solve
// and statistics, then call the host hook, int sum_hook(int step), which
// sums the packed statistics over the ranks in place, in stream order
// (where the TPU kernels all-reduce them over remote DMA, in-kernel), then
// the replicated update.  A mesh of one rank passes no hook.  A hook that
// reports a failure (nonzero) ends the segment with kSumHookFailed; the
// hook's caller holds the error.
using SumHook = int (*)(int);
constexpr int kSumHookFailed = -1;

// The solve's early stop through K2's, K6's, K15's and K16's segments:
// eps (< 0: none) and inv_count of the C entries' stop (vtc_fused_fista),
// the zeroed words and one count per step; step k's solve takes the tags
// from 1 + k (num_iters + 1), so one set of words serves the segment.
// Across ranks (K15 and K16 at a world above one) local (1,) takes the
// rank's share each iteration and hook(iteration) sums it over the ranks
// (vtc_fused_fista's stop_local and stop_hook); both null at one rank.
struct SegmentStop {
  float eps = -1.0f;
  float inv_count = 0.0f;
  void* words = nullptr;
  int* iters = nullptr;
  float* local = nullptr;
  SumHook hook = nullptr;

  int* step_iters(int step) const {
    return iters == nullptr ? nullptr : iters + step;
  }
  static unsigned step_tag(int step, int num_iters) {
    return 1u + static_cast<unsigned>(step) * (num_iters + 1u);
  }
};

// K19 across devices sums several buffers a step, each over its own mesh
// axis: int axis_sum_hook(int step, int which), ``which`` naming the
// buffer (fused_code_shard_train_step.cu, enum SumWhich); the same
// failure rule.
using AxisSumHook = int (*)(int, int);

// h[j] = 0.99 h[j] + (stat[j] / b) / 100, the Hessian EMA from a code
// statistic summed over the ranks, b the global batch (K15-K17, and K19
// with a data axis); the product and the sum rounded apart, as the plain
// version's two ops.
__global__ void hessian_from_stat_kernel(const float* __restrict__ stat,
                                         float* __restrict__ h, int s,
                                         float b) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < s)
    h[j] = __fadd_rn(__fmul_rn(0.99f, h[j]), (stat[j] / b) / 100.0f);
}

cudaError_t hessian_from_stat(const float* stat, float* h, int s, float b,
                              cudaStream_t stream) {
  hessian_from_stat_kernel<<<(s + 255) / 256, 256, 0, stream>>>(stat, h, s,
                                                                b);
  return cudaGetLastError();
}

// stat[j] = sum_b codes[b, j]^2, unaveraged, one thread per column adding
// the rows in order (the Hessian statistic of the per-shard solve+stats
// kernels K3 and K7: summed over the shards before it enters the EMA).
__global__ void column_sumsq_kernel(const float* __restrict__ codes,
                                    float* __restrict__ stat, int b, int s) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= s) return;
  float acc = 0.0f;
  for (int r = 0; r < b; ++r) {
    const float c = codes[static_cast<int64_t>(r) * s + j];
    acc = fmaf(c, c, acc);
  }
  stat[j] = acc;
}

cudaError_t column_sumsq(const float* codes, float* stat, int b, int s,
                         cudaStream_t stream) {
  column_sumsq_kernel<<<(s + 255) / 256, 256, 0, stream>>>(codes, stat, b, s);
  return cudaGetLastError();
}

// C = codes^T codes (s, s), B = codes^T X (s, n) and stat = sum_b codes^2
// (s,) of one shard's (b, s) codes and (b, n) batch, unaveraged: the
// gram-form update statistics of K3 and K7.  Each entry is one thread's
// sum over the b rows in order, so the result does not depend on
// scheduling: they feed the cancellation-prone C D' - B.
cudaError_t gram_form_stats(const float* codes, const float* x, float* cmat,
                            float* bmat, float* stat, int b, int s, int n,
                            cudaStream_t stream) {
  cudaError_t err =
      gemm<true, false>(codes, codes, nullptr, cmat, s, s, b, stream);
  if (err != cudaSuccess) return err;
  err = gemm<true, false>(codes, x, nullptr, bmat, s, n, b, stream);
  if (err != cudaSuccess) return err;
  return column_sumsq(codes, stat, b, s, stream);
}

// The anti-alignment regularizer's operands of one update iteration
// (K6 only): sd = S D (s, n), smat = S = comem o sign(C) (s, s) and
// cmat = C = D D^T (s, s).
struct AlignmentReg {
  const float* sd;
  const float* smat;
  const float* cmat;
  float penalty;
};

// One block per dictionary row i:
//   g = grad_i * inv_b  [+ penalty (sd_i - rowsum(S o C)_i D_i)]
//       [/ (h_i + lowest)]
//   D_i -= step * g;  then D_i / max(|D_i|, 1e-30) when renormalizing,
// the order of operations of pallas_train_step.py:522-531 and :702-720.
template <bool CHEAP_QUAD, bool RENORM, bool REG>
__global__ void __launch_bounds__(kRowThreads)
    update_rows_kernel(float* __restrict__ d, const float* __restrict__ grad,
                       const float* __restrict__ h, AlignmentReg reg, int s,
                       int n, float inv_b, float step, float lowest) {
  __shared__ float scratch[33];
  const int64_t i = blockIdx.x;
  float* row = d + i * n;
  const float* g_row = grad + i * n;
  const float scale = CHEAP_QUAD ? h[i] + lowest : 1.0f;
  float row_sc = 0.0f;
  if (REG) {
    float part = 0.0f;
    for (int j = threadIdx.x; j < s; j += blockDim.x)
      part = fmaf(reg.smat[i * s + j], reg.cmat[i * s + j], part);
    row_sc = block_sum(part, scratch);
  }
  float part = 0.0f;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float g = g_row[j] * inv_b;
    if (REG) g = g + reg.penalty * (reg.sd[i * n + j] - row_sc * row[j]);
    if (CHEAP_QUAD) g = g / scale;
    const float x = row[j] - step * g;
    row[j] = x;
    part = fmaf(x, x, part);
  }
  if (!RENORM) return;
  const float norm = fmaxf(sqrtf(block_sum(part, scratch)), 1e-30f);
  for (int j = threadIdx.x; j < n; j += blockDim.x) row[j] = row[j] / norm;
}

template <bool REG>
cudaError_t update_rows(float* d, const float* grad, const float* h,
                        AlignmentReg reg, int s, int n, float inv_b,
                        float step, float lowest, bool cheap_quad,
                        bool renorm, cudaStream_t stream) {
#define VTC_UPDATE(C, R)                                                   \
  update_rows_kernel<C, R, REG><<<s, kRowThreads, 0, stream>>>(            \
      d, grad, h, reg, s, n, inv_b, step, lowest)
  if (cheap_quad && renorm) VTC_UPDATE(true, true);
  else if (cheap_quad) VTC_UPDATE(true, false);
  else if (renorm) VTC_UPDATE(false, true);
  else VTC_UPDATE(false, false);
#undef VTC_UPDATE
  return cudaGetLastError();
}

// Grid of a grid-stride elementwise pass over total entries.
constexpr int kPassThreads = 256;

unsigned pass_grid(int64_t total) {
  const int64_t blocks = (total + kPassThreads - 1) / kPassThreads;
  return static_cast<unsigned>(blocks < 4096 ? blocks : 4096);
}

__device__ __forceinline__ float round_to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// dst = src rounded to bf16 (to nearest even), as floats, over count
// entries.
__global__ void round_bf16_kernel(const float* __restrict__ src,
                                  float* __restrict__ dst, int64_t count) {
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       idx < count; idx += static_cast<int64_t>(gridDim.x) * blockDim.x)
    dst[idx] = round_to_bf16(src[idx]);
}

cudaError_t round_bf16(const float* src, float* dst, int64_t count,
                       cudaStream_t stream) {
  round_bf16_kernel<<<pass_grid(count), kPassThreads, 0, stream>>>(src, dst,
                                                                   count);
  return cudaGetLastError();
}

// smat = comem o sign(cmat), elementwise over count entries (the
// anti-alignment regularizer's sign mask).
__global__ void sign_mask_kernel(const float* __restrict__ comem,
                                 const float* __restrict__ cmat,
                                 float* __restrict__ smat, int64_t count) {
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       idx < count; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float c = cmat[idx];
    smat[idx] = c > 0.0f ? comem[idx] : (c < 0.0f ? -comem[idx] : 0.0f);
  }
}

}  // namespace
