// The ISTA/FISTA solve kernel shared by K1 (fused_fista.cu, the fc
// solve) and K4 (fused_group_fista.cu, the subspace solve), for Hopper
// (sm_90a).  Included by each: everything here has internal linkage, and
// each file instantiates the variants it launches.
//
// Contract.  With G (s, s) and c (b, s) computed outside the kernel,
// every row of the batch runs num_iters iterations of
//
//   codes = prox(z + z @ (-eta G) + eta c, lam * eta)
//   fista: t' = (1 + sqrt(1 + 4 t^2)) / 2 ; z = codes + ((t-1)/t') (codes - old)
//   ista:  z = codes
//   old = codes
//
// with an optional warm start that seeds both z and old.  The prox is
// elementwise (K1: soft / nonneg-soft / hard / nonneg-hard shrinkage) or
// the group prox (K4, the TPU's K5): the s codes are s / M groups of M
// contiguous slots, and each group is scaled by max(1 - t / |g|, 0)
// (norm 0 -> 1, vtc_tpu thresholds.group_shrink) or, hard, zeroed when
// |g| < t.  No early stop (the batch-global stop test needs a reduction
// across blocks every iteration) and no reduced-precision tier: products
// are IEEE fp32 FMAs on the CUDA cores.
//
// What bounds it on this card.  Rows are independent and t_k is a scalar
// every block recomputes identically, so one launch runs every iteration
// with no grid-wide synchronisation.  Per iteration a block of kRows rows
// does kRows * s * s FMAs and must read all of G (256 KB at s = 256),
// which does not fit its shared memory.  So the kernel is bound by fp32
// FMA throughput on the CUDA cores, plus the L2 reads of G: once per block
// per iteration, kRows rows of reuse per byte.
//
// What the design does about it.
//  * eta is folded into G once per solve (fold_gram_kernel), and eta c is
//    folded once per block, as pallas_fista.py:89-95 does; the iteration
//    keeps JAX's association, (z + z @ (-eta G)) + eta c.
//  * The block's state (z twice for ping-pong, old, eta c) lives in shared
//    memory when it fits the block's budget and in a global scratch slice
//    owned by the block otherwise; the same code addresses both.
//  * G streams from L2 in kChunk x kColBlock slices through a two-deep
//    cp.async ring.  G is constant, so the ring runs across iteration
//    boundaries: the first slice of the next iteration is in flight while
//    the last slice of this one is multiplied.
//  * Each thread keeps a 4 x 4 register tile of the product: 4 rows and 4
//    neighbouring columns, read as float4 from shared memory (z rows are
//    a broadcast within a warp; G slices are conflict-free 16-byte reads).
//  * The group prox needs every slot of a group before it can scale any,
//    and a group may cross the 4-column thread tiles and the column
//    blocks.  So the group kernel writes the pre-prox row into the next
//    z buffer, synchronises, and then runs one pass over (row, group)
//    pairs that takes each group's norm and scales, and moves, its slots.
//  * Ragged edges are masked in the kernel: G is copied into a zero-padded
//    (sk, sc) scratch and the padded codes stay exactly zero.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;   // 64 column threads x 4 row threads
constexpr int kRows = 16;       // batch rows per block (4 per row thread)
constexpr int kColBlock = 256;  // columns per column block (4 per thread)
constexpr int kChunk = 32;      // depth of one streamed slice of G
constexpr int kSliceFloats = kChunk * kColBlock;

enum Shrink { kSoft = 0, kSoftNonneg = 1, kHard = 2, kHardNonneg = 3 };

template <int MODE>
__device__ __forceinline__ float shrink(float x, float t) {
  if (MODE == kSoft) return x - fminf(fmaxf(x, -t), t);  // sign(x) max(|x|-t, 0)
  if (MODE == kSoftNonneg) return fmaxf(x - t, 0.0f);
  if (MODE == kHard) return fabsf(x) < t ? 0.0f : x;
  return x < t ? 0.0f : x;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// gn = -eta * G, zero-padded from (s, s) to (sk, sc).
__global__ void fold_gram_kernel(const float* __restrict__ gram,
                                 const float* __restrict__ eta_ptr,
                                 float* __restrict__ gn, int s, int sk,
                                 int sc) {
  const float neg_eta = -(*eta_ptr);
  const int64_t total = static_cast<int64_t>(sk) * sc;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(idx / sc);
    const int c = static_cast<int>(idx - static_cast<int64_t>(r) * sc);
    gn[idx] = (r < s && c < s)
                  ? neg_eta * gram[static_cast<int64_t>(r) * s + c]
                  : 0.0f;
  }
}

// Issue the cp.async copies of slice q of gn into dst and commit them as
// one group.  Slice q covers rows [kc*kChunk, +kChunk) and columns
// [cb*kColBlock, +kColBlock), with cb = q / nk and kc = q % nk.
__device__ __forceinline__ void load_slice(const float* __restrict__ gn,
                                           int q, int nk, int sc,
                                           float* dst) {
  const int cb = q / nk;
  const int kc = q - cb * nk;
  const float* src =
      gn + static_cast<int64_t>(kc * kChunk) * sc + cb * kColBlock;
  constexpr int kVecPerRow = kColBlock / 4;
  for (int i = threadIdx.x; i < kChunk * kVecPerRow; i += kThreads) {
    const int r = i / kVecPerRow;
    const int v = i - r * kVecPerRow;
    cp_async16(dst + r * kColBlock + v * 4,
               src + static_cast<int64_t>(r) * sc + v * 4);
  }
  cp_async_commit();
}

// The momentum step of one code: z' = code + beta (code - old), with
// explicit roundings (no contraction into an FMA), as JAX rounds it.
template <bool FISTA>
__device__ __forceinline__ float momentum(float code, float old,
                                          float beta) {
  return FISTA ? __fadd_rn(code, __fmul_rn(beta, __fsub_rn(code, old)))
               : code;
}

// The group prox over the block's rows.  zn holds the pre-prox values of
// every slot; each (row, group) pair takes its group's norm, scales the
// slots and applies the momentum in place, and records the codes in old.
// IEEE sqrtf and division, the zero-norm guard of
// thresholds.group_shrink, and for HARD norm < t -> 0.
template <bool FISTA, bool HARD>
__device__ __forceinline__ void group_prox(float* zn, float* old, int s,
                                           int sk, int group_size,
                                           float t, float beta) {
  const int groups = s / group_size;
  for (int p = threadIdx.x; p < kRows * groups; p += kThreads) {
    const int r = p / groups;
    const int at = r * sk + (p - r * groups) * group_size;
    float sq = 0.0f;
    for (int m = 0; m < group_size; ++m)
      sq = fmaf(zn[at + m], zn[at + m], sq);
    const float norm = sqrtf(sq);
    float scale;
    if (HARD) {
      scale = norm < t ? 0.0f : 1.0f;
    } else {
      const float safe = norm == 0.0f ? 1.0f : norm;
      scale = fmaxf(__fsub_rn(1.0f, __fdiv_rn(t, safe)), 0.0f);
    }
    for (int m = 0; m < group_size; ++m) {
      const float code = __fmul_rn(zn[at + m], scale);
      zn[at + m] = momentum<FISTA>(code, old[at + m], beta);
      old[at + m] = code;
    }
  }
}

// GROUP: the prox is the group prox of group_size slots (MODE kSoft or
// kHard); otherwise the elementwise shrink<MODE>.
template <bool FISTA, int MODE, bool GROUP>
__global__ void __launch_bounds__(kThreads)
    fista_kernel(const float* __restrict__ gn, const float* __restrict__ corr,
                 const float* __restrict__ init,
                 const float* __restrict__ eta_ptr, float lam, int num_iters,
                 int b, int s, int sk, int sc, int group_size,
                 float* state_global, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int tx = tid & 63;  // owns columns tx*4 .. tx*4+3 of a column block
  const int ty = tid >> 6;  // owns rows ty*4 .. ty*4+3 of the block
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int plane = kRows * sk;

  float* gbuf = smem;  // two slices of G
  float* state = state_global != nullptr
                     ? state_global + static_cast<int64_t>(blockIdx.x) * 4 *
                                          plane
                     : smem + 2 * kSliceFloats;
  float* const zbuf0 = state;  // z, ping-pong with zbuf1
  float* const zbuf1 = state + plane;
  float* old = state + 2 * plane;
  float* ec = state + 3 * plane;

  const float eta = *eta_ptr;
  const float lam_eta = lam * eta;

  for (int idx = tid; idx < plane; idx += kThreads) {
    const int r = idx / sk;
    const int j = idx - r * sk;
    const int64_t row = row0 + r;
    const bool live = row < b && j < s;
    const int64_t at = row * s + j;
    const float z0 = (live && init != nullptr) ? init[at] : 0.0f;
    zbuf0[idx] = z0;
    zbuf1[idx] = 0.0f;
    old[idx] = z0;
    ec[idx] = live ? eta * corr[at] : 0.0f;
  }
  __syncthreads();

  const int nk = sk / kChunk;
  const int ncb = sc / kColBlock;
  const int nq = nk * ncb;  // slices per iteration
  float t_k = 1.0f;
  int cur = 0;
  unsigned slice = 0;  // running slice counter; its parity picks the buffer
  if (num_iters > 0) load_slice(gn, 0, nk, sc, gbuf);

  for (int it = 0; it < num_iters; ++it) {
    float t_next = t_k;
    float beta = 0.0f;
    if (FISTA) {  // explicit roundings: no contraction into an FMA
      t_next = __fdiv_rn(
          __fadd_rn(1.0f, __fsqrt_rn(__fadd_rn(
                              1.0f, __fmul_rn(__fmul_rn(4.0f, t_k), t_k)))),
          2.0f);
      beta = __fdiv_rn(__fsub_rn(t_k, 1.0f), t_next);
    }
    const float* z = cur ? zbuf1 : zbuf0;
    float* zn = cur ? zbuf0 : zbuf1;

    for (int cb = 0; cb < ncb; ++cb) {
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;

      for (int kc = 0; kc < nk; ++kc, ++slice) {
        const float* gs = gbuf + (slice & 1) * kSliceFloats;
        const int q = cb * nk + kc;
        if (it + 1 < num_iters || q + 1 < nq) {
          load_slice(gn, (q + 1) % nq, nk, sc,
                     gbuf + ((slice + 1) & 1) * kSliceFloats);
          cp_async_wait<1>();
        } else {
          cp_async_wait<0>();
        }
        __syncthreads();

        const float* zr = z + (ty * 4) * sk + kc * kChunk;
#pragma unroll 2
        for (int k = 0; k < kChunk; k += 4) {
          float4 a[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            a[r] = *reinterpret_cast<const float4*>(zr + r * sk + k);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const float4 g = *reinterpret_cast<const float4*>(
                gs + (k + kk) * kColBlock + tx * 4);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float av = kk == 0   ? a[r].x
                               : kk == 1 ? a[r].y
                               : kk == 2 ? a[r].z
                                         : a[r].w;
              acc[r][0] = fmaf(av, g.x, acc[r][0]);
              acc[r][1] = fmaf(av, g.y, acc[r][1]);
              acc[r][2] = fmaf(av, g.z, acc[r][2]);
              acc[r][3] = fmaf(av, g.w, acc[r][3]);
            }
          }
        }
        __syncthreads();  // gs is refilled two slices from now
      }

#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = cb * kColBlock + tx * 4 + c;
          if (j < s) {
            const int idx = (ty * 4 + r) * sk + j;
            const float x = __fadd_rn(__fadd_rn(z[idx], acc[r][c]), ec[idx]);
            if (GROUP) {
              zn[idx] = x;  // pre-prox; the group pass below finishes it
            } else {
              const float code = shrink<MODE>(x, lam_eta);
              zn[idx] = momentum<FISTA>(code, old[idx], beta);
              old[idx] = code;
            }
          }
        }
      }
    }
    if (GROUP) {
      __syncthreads();  // every slot of every group is in zn
      group_prox<FISTA, MODE == kHard>(zn, old, s, sk, group_size, lam_eta,
                                       beta);
    }
    __syncthreads();  // zn complete before the next iteration reads it
    cur ^= 1;
    t_k = t_next;
  }

  for (int idx = tid; idx < plane; idx += kThreads) {
    const int r = idx / sk;
    const int j = idx - r * sk;
    const int64_t row = row0 + r;
    if (row < b && j < s) out[row * s + j] = old[idx];
  }
}

// Fold G, then launch the solve.  state_global null keeps the block's
// state in shared memory.  Returns the first CUDA error.
template <bool FISTA, int MODE, bool GROUP>
cudaError_t launch_solve(const float* gram, const float* corr,
                         const float* init, const float* eta, float lam,
                         int num_iters, int b, int s, int sk, int sc,
                         int group_size, float* gn, float* state_global,
                         float* out, cudaStream_t stream) {
  const int64_t total = static_cast<int64_t>(sk) * sc;
  const unsigned fold_grid =
      static_cast<unsigned>(total / 256 + 1 < 1024 ? total / 256 + 1 : 1024);
  fold_gram_kernel<<<fold_grid, 256, 0, stream>>>(gram, eta, gn, s, sk, sc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto kernel = fista_kernel<FISTA, MODE, GROUP>;
  size_t smem = 2 * kSliceFloats * sizeof(float);
  if (state_global == nullptr)
    smem += 4 * static_cast<size_t>(kRows) * sk * sizeof(float);
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((b + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(gn, corr, init, eta, lam,
                                           num_iters, b, s, sk, sc,
                                           group_size, state_global, out);
  return cudaGetLastError();
}

// The argument checks both entry points share.
inline bool solve_args_ok(int b, int s, int num_iters, int sk, int sc) {
  return b > 0 && s > 0 && num_iters >= 0 && sk >= s && sc >= s &&
         sk % kChunk == 0 && sc % kColBlock == 0;
}

}  // namespace
