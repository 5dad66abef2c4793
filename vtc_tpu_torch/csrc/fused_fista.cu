// Fused fully-connected ISTA/FISTA solve for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel K1: vtc_tpu/ops/pallas_fista.py,
// fista_solve_pallas (:156) / _make_kernel (:44).  Same contract: with
// G = D D^T (s, s) and c = X D^T (b, s) computed outside the kernel,
// every row of the batch runs num_iters iterations of
//
//   codes = shrink(z + z @ (-eta G) + eta c, lam * eta)
//   fista: t' = (1 + sqrt(1 + 4 t^2)) / 2 ; z = codes + ((t-1)/t') (codes - old)
//   ista:  z = codes
//   old = codes
//
// with soft / nonneg-soft / hard / nonneg-hard shrinkage and an optional
// warm start that seeds both z and old.  No early stop (the batch-global
// stop test needs a reduction across blocks every iteration) and no
// reduced-precision tier: products are IEEE fp32 FMAs on the CUDA cores.
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
//  * Ragged edges are masked in the kernel: G is copied into a zero-padded
//    (sk, sc) scratch and the padded codes stay exactly zero.
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

template <bool FISTA, int MODE>
__global__ void __launch_bounds__(kThreads)
    fista_kernel(const float* __restrict__ gn, const float* __restrict__ corr,
                 const float* __restrict__ init,
                 const float* __restrict__ eta_ptr, float lam, int num_iters,
                 int b, int s, int sk, int sc, float* state_global,
                 float* __restrict__ out) {
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
            const float code = shrink<MODE>(x, lam_eta);
            zn[idx] = FISTA ? __fadd_rn(code,
                                        __fmul_rn(beta, __fsub_rn(code,
                                                                  old[idx])))
                            : code;
            old[idx] = code;
          }
        }
      }
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

template <bool FISTA, int MODE>
cudaError_t launch(const float* gn, const float* corr, const float* init,
                   const float* eta, float lam, int num_iters, int b, int s,
                   int sk, int sc, float* state_global, float* out,
                   cudaStream_t stream) {
  auto kernel = fista_kernel<FISTA, MODE>;
  size_t smem = 2 * kSliceFloats * sizeof(float);
  if (state_global == nullptr)
    smem += 4 * static_cast<size_t>(kRows) * sk * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((b + kRows - 1) / kRows);
  kernel<<<grid, kThreads, smem, stream>>>(gn, corr, init, eta, lam,
                                           num_iters, b, s, sk, sc,
                                           state_global, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Layout constants, read by the Python wrapper to size its scratch.
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
  if (b <= 0 || s <= 0 || num_iters < 0 || sk < s || sc < s ||
      sk % kChunk != 0 || sc % kColBlock != 0 || mode < 0 || mode > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int64_t total = static_cast<int64_t>(sk) * sc;
  const unsigned fold_grid =
      static_cast<unsigned>(total / 256 + 1 < 1024 ? total / 256 + 1 : 1024);
  fold_gram_kernel<<<fold_grid, 256, 0, stream>>>(gram, eta, gn_scratch, s,
                                                  sk, sc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
#define VTC_LAUNCH(F, M)                                                   \
  launch<F, M>(gn_scratch, corr, init, eta, lam, num_iters, b, s, sk, sc, \
               state_scratch, out, stream)
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
