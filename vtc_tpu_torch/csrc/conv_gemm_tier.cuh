// The conv solves' gathered GEMM at the precision tiers, for Hopper
// (sm_90a): gather_gemm_tier, a bf16 tensor-core form of conv_gemm.cuh's
// gather_gemm_tiled, with its weight-split kernel and launchers.  Included
// by fused_conv_direct.cu (K10) and fused_conv_train_step.cu (K12, K13,
// K17) after conv_gemm.cuh, whose GemmArgs, epilogue and early stop it
// shares.
//
// Replaces the tiers of the TPU kernels K10 (vtc_tpu/ops/
// pallas_conv_direct.py, _make_kernel :255-337) and K12, K13 and K17
// (pallas_conv_train.py's tile solver _make_tile_solver :270-344, which
// the three share): their deep-contraction products are built by
// _make_deep_dot(mxu) (pallas_conv_train.py:240-267).
//
// What a tier computes.  vtc_tpu splits the weights (dstk, dall) into
// bf16 terms once per solve and the stacked source per use, and sums
// single-pass bf16 products, the weights always on the left, in float32
// in this order:
//   bf16    bf16(w) bf16(b);
//   bf16x3  w_hi b_hi + w_lo b_hi + w_hi b_lo (hi = bf16(x), lo =
//           bf16(x - hi));
//   bf16x5  w_hi b_hi + w_mid b_hi + w_hi b_mid + w_lo b_hi + w_hi b_lo
//           (the exact three-term split: mid = bf16(x - hi), lo =
//           bf16(x - hi - mid), each residual in float32).
// A product of two bf16 values is exact in float32, so the card's bf16
// tensor cores with float32 accumulation (mma.sync m16n8k16 .bf16 .f32)
// compute the same passes; only the order of the float32 sums differs.
// The three products of a solve run at the tier: corr = A(mask * X), the
// synthesis (the mask applied after the product, in float32, by the
// kMaskStore epilogue) and the analysis of the masked float32 image.  The
// update's residual and every statistic stay fp32 (conv_gemm.cuh).
//
// Contract: gather_gemm_tiled's, C[m, n] = sum_k A[m, k] src[gather(n,
// k)] over every position and K up to kTableMaxK, the
// same epilogues (epilogue_load / epilogue_store, through shared memory in
// tile_epilogue, that kernel's epilogue lines) and the same
// early stop: the STOP build reads the stop word on entry and its kProx
// launch posts its tile's share (conv_gemm.cuh, "The early stop"), so
// with STOP on the kernel computes the same bits as with it off.
//
//  * The weights: conv_tier_fold_kernel splits A (m x K fp32, row-major)
//    into the tier's terms once per solve (K12, K13, K17: once per step,
//    after the update moved dstk), each a plane of bf16 pairs in the mma
//    A fragments' order, m zero-padded to a multiple of kBM and K to a
//    multiple of 16 with exact zeros, which add nothing.  At the flagship
//    (64 x 256) a term is 32 KB, so the planes stay in L2.
//  * The source: the tiled kernel's gather, 16-deep fp32 slices of the
//    stack through the two-stage cp.async ring, zero-filled outside the
//    source; each warp splits its B fragments' elements into their bf16
//    terms as it builds them (__float2bfloat16_rn, float32 residuals).
//    Splitting is elementwise, so splitting after the gather is the
//    reference's split of the stack slice, and a zero-filled element
//    splits to exact zeros.  The A fragments of the slice come through
//    the same ring (16-byte cp.async).
//  * The product: a block of 2 x (BN / 32) warps owns a kBM x BN tile of
//    C, a warp 32 rows x 32 columns (2 m16 x 4 n8 tiles).  Each 16-deep
//    step issues the tier's passes in the reference's order, the hi x hi
//    pass into one float32 accumulator and the smaller passes into a
//    second, added before the epilogue, as fista_tier.cuh does (the small
//    passes would otherwise be rounded against the large sum at every
//    step).  The hi x hi pass of each step is summed from zero and added
//    to its accumulator with a round-to-nearest add: the tensor cores do
//    not round an accumulation to nearest, and over a 256-deep sum that
//    moved the result further from the exact pass than a float32 chain
//    does.
//  * BN = 128 (256 threads) where that gives every SM two blocks, else
//    BN = 64 (128 threads), the tiled kernel's rule.
// The tier is a template parameter (a run-time tier made ptxas spill the
// solve kernel of fista_tier.cuh), as is STOP.
//
// What bounds it on this card.  At the flagship (64 kernels of 16x16 at
// stride 8, b 40 images of 272x272) a K10 iteration's two products are
// 2 x 2 x 64 x 256 x ~45,000 = 2.9 GFLOP a pass: 3 us a pass at the
// 989 TFLOP/s bf16 rate, against about 80 MB of state an iteration (the
// image blocks and codes read and written by the two epilogues) at
// 3.35 TB/s, 24 us: bytes bound at every tier.  mma.sync with operands
// built from shared memory reaches a fraction of the tensor cores' rate,
// and the gather through 4-byte copies and the per-element split cost
// issue slots, so this simple kernel sits far from either bound.  wgmma,
// TMA loads of the stack and planes resident across a persistent grid
// are later work (ROADMAP.md).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "bf16_terms.cuh"
#include "conv_gemm.cuh"
#include "tier_codes.cuh"

namespace {

// bf16 terms of one operand at a tier: 1 at bf16, 2 at bf16x3, 3 at
// bf16x5; 0 at 'highest'.
__host__ __device__ constexpr int conv_tier_terms(int tier) {
  return tier == kTierBf16 ? 1
         : tier == kTierBf16x3 ? 2
         : tier == kTierBf16x5 ? 3
                               : 0;
}

// 32-bit words of one term's plane of an m x k weight matrix: m padded to
// kBM, k to 16, two bf16 values a word.
inline long long conv_tier_plane_words(int m, int k) {
  return static_cast<long long>((m + kBM - 1) / kBM * kBM) *
         ((k + 15) / 16 * 16) / 2;
}

// A (m x k, row-major fp32) split into TERMS planes of plane_words words
// in the A fragments' order: word w of a plane is register r (bits 0-1)
// of lane l (bits 2-6) of the 16-deep step q of the m16 tile mt, q
// fastest (tile index w >> 7 = mt * nks + q); it holds rows mt * 16 +
// (l >> 2) + 8 (r & 1) and depths 16 q + 2 (l & 3) + 8 (r >> 1) + {0, 1},
// the lower depth in the low half.  Zero outside A.
template <int TERMS>
__global__ void conv_tier_fold_kernel(const float* __restrict__ a, int m,
                                      int k, int nks, long long plane_words,
                                      uint32_t* __restrict__ planes) {
  for (long long w = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       w < plane_words; w += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int r = static_cast<int>(w & 3);
    const int l = static_cast<int>((w >> 2) & 31);
    const long long tile = w >> 7;
    const int q = static_cast<int>(tile % nks);
    const int mt = static_cast<int>(tile / nks);
    const int row = mt * 16 + (l >> 2) + 8 * (r & 1);
    const int kk = 16 * q + 2 * (l & 3) + 8 * (r >> 1);
    const bool live = row < m;
    const float v0 = live && kk < k ? a[static_cast<long long>(row) * k + kk]
                                    : 0.0f;
    const float v1 = live && kk + 1 < k
                         ? a[static_cast<long long>(row) * k + kk + 1]
                         : 0.0f;
    uint16_t t0[TERMS], t1[TERMS];
    split_bits<TERMS>(v0, t0);
    split_bits<TERMS>(v1, t1);
#pragma unroll
    for (int p = 0; p < TERMS; ++p)
      planes[p * plane_words + w] =
          static_cast<uint32_t>(t0[p]) | (static_cast<uint32_t>(t1[p]) << 16);
  }
}

// A 16-byte cp.async (the planes are whole 16-byte pieces).
__device__ __forceinline__ void gemm_cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

// The epilogue of a kBM x BN tile of C staged in shared memory cs (row
// stride BN + 4), the tile at rows m0 and positions n0, in a block of
// THREADS threads: each warp writes whole rows of C, lane l at columns
// l + 32 q, in coalesced runs, 4 outputs' inputs loaded before their
// stores; STOP: the kProx launch's share of the early stop.  These are conv_gemm.cuh's gather_gemm_tiled's epilogue
// lines, which keep their own copy there: calling this function from that
// kernel made ptxas spill 8 bytes in its BN = 64 build.
template <int BN, int THREADS, bool STOP>
__device__ __forceinline__ void tile_epilogue(const GemmArgs& p,
                                              const float* cs, int m0,
                                              long long n0, int len,
                                              long long npos) {
  constexpr int kCS = BN + 4;
  const int tid = threadIdx.x;
  const float eta = p.epilogue == kProx ? *p.eta : 0.f;
  const float thresh = __fmul_rn(p.lam, eta);
  float delta = 0.f;  // STOP: this thread's sum of |codes - old|
  constexpr int kQ = BN / 32, kR = 4 / kQ, kWarps = THREADS / 32;
  const int lane = tid % 32, warp = tid / 32;
  // this lane's columns: output offset b * M * len + t, t = y * out_w + x
  long long cbase[kQ];
  int ct[kQ];
  bool cvalid[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const long long n = n0 + lane + 32 * q;
    cvalid[q] = n < npos;
    const long long b = cvalid[q] ? n / len : 0;
    ct[q] = static_cast<int>(n - b * len);
    cbase[q] = b * p.m * len + ct[q];
  }
  for (int r0 = warp * kR; r0 < kBM; r0 += kWarps * kR) {
    EpiIn in[kR][kQ];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int m = m0 + r0 + r;
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        if (m < p.m && cvalid[q])
          in[r][q] = epilogue_load(
              p, cbase[q] + static_cast<long long>(m) * len,
              static_cast<long long>(m) * len + ct[q]);
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int m = m0 + r0 + r;
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        if (m < p.m && cvalid[q])
          epilogue_store<STOP>(p, cbase[q] + static_cast<long long>(m) * len,
                               cs[(r0 + r) * kCS + lane + 32 * q], in[r][q],
                               eta, thresh, &delta);
    }
  }
  if constexpr (STOP)
    if (p.epilogue == kProx) conv_stop_share(p.stop, delta, eta);
}

// Threads of gather_gemm_tier<BN>: 2 warps in m by BN / 32 in n.
__host__ __device__ constexpr int tier_threads(int bn) { return 2 * bn; }

// Shared memory of gather_gemm_tier<BN> at `terms` terms: the two-stage
// ring of the A fragments (terms x 4 m16 tiles x 128 words) and of the
// source slices (kBK x (BN + 4) floats), then the offset table padded to
// a whole slice; after the K loop the kBM x (BN + 4) tile of C over both.
inline size_t tier_smem_bytes(int bn, int terms, int k) {
  const size_t ring = sizeof(uint32_t) * 2 * terms * (kBM / 16) * 128 +
                      sizeof(float) * 2 * kBK * (bn + 4);
  const size_t table =
      sizeof(KOffset) * static_cast<size_t>((k + kBK - 1) / kBK * kBK);
  const size_t tile = sizeof(float) * kBM * (bn + 4);
  return ring + table > tile ? ring + table : tile;
}

// The tier GEMM over every position: a kBM x BN tile of C per block.
// planes: conv_tier_fold_kernel's TERMS planes of A, plane_words each.
template <int BN, int TIER, bool STOP>
__global__ void __launch_bounds__(tier_threads(BN))
    gather_gemm_tier(GemmArgs p, const uint32_t* __restrict__ planes,
                     long long plane_words) {
  constexpr int kTerms = conv_tier_terms(TIER);
  constexpr int kThreadsT = tier_threads(BN);
  constexpr int kBS = BN + 4, kCS = BN + 4;
  constexpr int kAWords = kTerms * (kBM / 16) * 128;  // a stage's A words
  static_assert(kTerms >= 1, "a tier, not 'highest'");
  // STOP: the stop word, tested once the offset table is built
  const unsigned long long stop_word = STOP ? conv_stop_word(p.stop) : 0;
  extern __shared__ __align__(16) float tile_smem[];
  uint32_t* as = reinterpret_cast<uint32_t*>(tile_smem);  // [2][kAWords]
  float* bs = tile_smem + 2 * kAWords;                      // [2][kBK][kBS]
  KOffset* table = reinterpret_cast<KOffset*>(bs + 2 * kBK * kBS);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 1, wn = warp >> 1;  // the warp's 32 rows, 32 columns
  const int m0 = blockIdx.y * kBM;
  const long long n0 = static_cast<long long>(blockIdx.x) * BN;
  const int len = p.out_h * p.out_w;
  const long long npos = static_cast<long long>(p.nb) * len;
  const int kpad = (p.k + kBK - 1) / kBK * kBK;
  const int nks = kpad / 16;

  for (int k = tid; k < kpad; k += kThreadsT) {
    KOffset e = {0, 0, 0};
    if (k < p.k) {
      const int o = k / p.src_c, ch = k - o * p.src_c;
      const int dy = p.sign * (o / p.off_w) + p.off_y0;
      const int dx = p.sign * (o % p.off_w) + p.off_x0;
      e.off = (ch * p.src_h + dy) * p.src_w + dx;
      e.dy = static_cast<short>(dy);
      e.dx = static_cast<short>(dx);
    }
    table[k] = e;
  }

  // the source position this thread gathers, fixed for the whole K loop:
  // column tid % BN, rows tid / BN + r * (kThreadsT / BN) of a slice
  constexpr int kRowsB = BN * kBK / kThreadsT;
  const int col = tid % BN, row0 = tid / BN;
  int gy = 0, gx = 0;
  const float* src_n = p.src;
  const bool nvalid = n0 + col < npos;
  if (nvalid) {
    const long long n = n0 + col;
    const int b = static_cast<int>(n / len);
    const int t = static_cast<int>(n - static_cast<long long>(b) * len);
    gy = t / p.out_w;
    gx = t - gy * p.out_w;
    src_n += static_cast<long long>(b) * p.src_c * p.src_h * p.src_w +
             gy * p.src_w + gx;
  }
  __syncthreads();
  if (STOP && conv_stopped(p.stop, stop_word)) return;

  // the block's A fragments of step q: for each term, its 4 m16 tiles
  const int mt0 = m0 / 16;
  auto load_slice = [&](int stage, int q) {
    uint32_t* as_s = as + stage * kAWords;
    float* bs_s = bs + stage * kBK * kBS;
    for (int c = tid; c < kTerms * (kBM / 16) * 32; c += kThreadsT) {
      const int piece = c & 31;     // 16 bytes: lane piece's 4 registers
      const int tile = (c >> 5);    // term * 4 + m16 tile of the block
      const int term = tile >> 2, mt = mt0 + (tile & 3);
      gemm_cp_async16(as_s + tile * 128 + piece * 4,
                      planes + term * plane_words +
                          ((static_cast<long long>(mt) * nks + q) * 32 +
                           piece) * 4);
    }
    const int k0 = q * kBK;
#pragma unroll
    for (int r = 0; r < kRowsB; ++r) {
      const int kk = row0 + r * (kThreadsT / BN);
      const KOffset e = table[k0 + kk];
      const bool ok = nvalid && k0 + kk < p.k &&
                      static_cast<unsigned>(gy + e.dy) <
                          static_cast<unsigned>(p.src_h) &&
                      static_cast<unsigned>(gx + e.dx) <
                          static_cast<unsigned>(p.src_w);
      gemm_cp_async4(bs_s + kk * kBS + col, ok ? src_n + e.off : p.src, ok);
    }
  };

  // the hi x hi pass's accumulator and the smaller passes'; the smaller
  // passes' (A term, B term) in vtc_tpu's order: mid hi, hi mid, lo hi,
  // hi lo (bf16x3: lo hi, hi lo)
  constexpr int kSmall = 2 * kTerms - 2;
  constexpr int kPassA[4] = {1, 0, 2, 0}, kPassB[4] = {0, 1, 0, 2};
  float acc[2][4][4], acc_lo[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = acc_lo[i][j][c] = 0.0f;

  const int kb = 2 * (lane & 3);       // the B fragment's first depth
  const int nb = wn * 32 + (lane >> 2);  // and its column in the tile
  load_slice(0, 0);
  gemm_cp_async_commit();
  for (int q = 0; q < nks; ++q) {
    // always commit, so that wait_group 1 leaves exactly slice q landed
    if (q + 1 < nks) load_slice((q + 1) & 1, q + 1);
    gemm_cp_async_commit();
    gemm_cp_async_wait1();
    __syncthreads();
    const uint32_t* as_s = as + (q & 1) * kAWords;
    const float* bs_s = bs + (q & 1) * kBK * kBS;
    uint4 a[2][kTerms];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int t = 0; t < kTerms; ++t)
        a[i][t] = *reinterpret_cast<const uint4*>(
            as_s + (t * 4 + 2 * wm + i) * 128 + lane * 4);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float* bcol = bs_s + nb + j * 8;
      uint16_t t0[kTerms], t1[kTerms], t2[kTerms], t3[kTerms];
      split_bits<kTerms>(bcol[kb * kBS], t0);
      split_bits<kTerms>(bcol[(kb + 1) * kBS], t1);
      split_bits<kTerms>(bcol[(kb + 8) * kBS], t2);
      split_bits<kTerms>(bcol[(kb + 9) * kBS], t3);
      uint2 bt[kTerms];
#pragma unroll
      for (int t = 0; t < kTerms; ++t) {
        bt[t].x = static_cast<uint32_t>(t0[t]) |
                  (static_cast<uint32_t>(t1[t]) << 16);
        bt[t].y = static_cast<uint32_t>(t2[t]) |
                  (static_cast<uint32_t>(t3[t]) << 16);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // hi x hi of this step from zero, then one round-to-nearest add
        float hh[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma_bf16(hh, a[i][0], bt[0]);
#pragma unroll
        for (int c = 0; c < 4; ++c)
          acc[i][j][c] = __fadd_rn(acc[i][j][c], hh[c]);
#pragma unroll
        for (int r = 0; r < kSmall; ++r)
          mma_bf16(acc_lo[i][j], a[i][kPassA[r]], bt[kPassB[r]]);
      }
    }
    __syncthreads();
  }

  // the tile of C through shared memory (over the ring, free after the
  // loop's last barrier): row (l >> 2) + 8 (c >> 1), column 2 (l & 3) +
  // (c & 1) of each fragment
  float* cs = tile_smem;  // [kBM][kCS]
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 32 + i * 16 + (lane >> 2) + 8 * h;
        const int c0 = wn * 32 + j * 8 + kb;
        float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
        if constexpr (kSmall > 0) {
          v0 = __fadd_rn(v0, acc_lo[i][j][2 * h]);
          v1 = __fadd_rn(v1, acc_lo[i][j][2 * h + 1]);
        }
        *reinterpret_cast<float2*>(cs + row * kCS + c0) = make_float2(v0, v1);
      }
  __syncthreads();
  tile_epilogue<BN, kThreadsT, STOP>(p, cs, m0, n0, len, npos);
}

// Whether the tier kernel takes the product: where the tiled kernel's
// offset table holds it.
inline bool tier_gemm_fits(const GemmArgs& p) {
  return tile_table_fits(p);
}

template <int BN, int TIER, bool STOP>
cudaError_t launch_tier_tiled(const GemmArgs& p, const uint32_t* planes,
                              long long positions, cudaStream_t stream) {
  constexpr int kTerms = conv_tier_terms(TIER);
  static const cudaError_t attr = cudaFuncSetAttribute(
      gather_gemm_tier<BN, TIER, STOP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(tier_smem_bytes(BN, kTerms, kTableMaxK)));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(static_cast<unsigned>((positions + BN - 1) / BN),
                  static_cast<unsigned>((p.m + kBM - 1) / kBM), 1);
  gather_gemm_tier<BN, TIER, STOP>
      <<<grid, tier_threads(BN), tier_smem_bytes(BN, kTerms, p.k), stream>>>(
          p, planes, conv_tier_plane_words(p.m, p.k));
  return cudaGetLastError();
}

template <int TIER, bool STOP>
cudaError_t launch_gather_gemm_tier_at(const GemmArgs& p,
                                       const uint32_t* planes,
                                       cudaStream_t stream) {
  const long long positions =
      static_cast<long long>(p.nb) * p.out_h * p.out_w;
  return (positions + 127) / 128 >= 2LL * gemm_sm_count()
             ? launch_tier_tiled<128, TIER, STOP>(p, planes, positions, stream)
             : launch_tier_tiled<64, TIER, STOP>(p, planes, positions, stream);
}

// One gathered GEMM over every position at a tier (kTierBf16, kTierBf16x3
// or kTierBf16x5), with planes the fold of p.a at that tier; the STOP
// build where stop is true.  cudaErrorInvalidValue for 'highest', another
// code, or a product the kernel does not take (tier_gemm_fits): it never
// runs the fp32 GEMM in the tier's place.
inline cudaError_t launch_gather_gemm_tier_stop(int tier, const GemmArgs& p,
                                                const uint32_t* planes,
                                                bool stop,
                                                cudaStream_t stream) {
  if (!tier_gemm_fits(p) || planes == nullptr) return cudaErrorInvalidValue;
#define VTC_TIER(T)                                                  \
  (stop ? launch_gather_gemm_tier_at<T, true>(p, planes, stream)    \
        : launch_gather_gemm_tier_at<T, false>(p, planes, stream))
  switch (tier) {
    case kTierBf16: return VTC_TIER(kTierBf16);
    case kTierBf16x3: return VTC_TIER(kTierBf16x3);
    case kTierBf16x5: return VTC_TIER(kTierBf16x5);
    default: return cudaErrorInvalidValue;
  }
#undef VTC_TIER
}

// Split the m x k weights a into the tier's planes (conv_tier_fold_kernel).
inline cudaError_t fold_conv_tier(int tier, const float* a, int m, int k,
                                  uint32_t* planes, cudaStream_t stream) {
  const long long words = conv_tier_plane_words(m, k);
  const int nks = (k + 15) / 16;
  const unsigned grid =
      static_cast<unsigned>(words / 256 + 1 < 1024 ? words / 256 + 1 : 1024);
  switch (tier) {
    case kTierBf16:
      conv_tier_fold_kernel<1><<<grid, 256, 0, stream>>>(a, m, k, nks, words,
                                                         planes);
      break;
    case kTierBf16x3:
      conv_tier_fold_kernel<2><<<grid, 256, 0, stream>>>(a, m, k, nks, words,
                                                         planes);
      break;
    case kTierBf16x5:
      conv_tier_fold_kernel<3><<<grid, 256, 0, stream>>>(a, m, k, nks, words,
                                                         planes);
      break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// The words of one set of planes of an m x k weight matrix at a tier.
inline long long conv_tier_words(int tier, int m, int k) {
  return conv_tier_terms(tier) * conv_tier_plane_words(m, k);
}

// A conv solve's weights at a tier: dstk (cpx x R*s) and dall (s x
// R*cpx), each split into its planes, the two sets one after the other in
// one scratch of conv_tier_words(tier, cpx, R*s) + conv_tier_words(tier,
// s, R*cpx) words.
struct ConvTierWeights {
  int tier = kTierHighest;
  uint32_t* stk = nullptr;
  uint32_t* all = nullptr;

  ConvTierWeights() = default;
  ConvTierWeights(int tier_, void* scratch, int s, int cpx, int r)
      : tier(tier_) {
    if (tier == kTierHighest) return;
    stk = static_cast<uint32_t*>(scratch);
    all = stk + conv_tier_words(tier, cpx, r * s);
  }

  // fold both from dstk and dall
  cudaError_t fold(const float* dstk, const float* dall, int s, int cpx,
                   int r, cudaStream_t stream) const {
    if (tier == kTierHighest) return cudaSuccess;
    const cudaError_t err = fold_conv_tier(tier, dstk, cpx, r * s, stk, stream);
    if (err != cudaSuccess) return err;
    return fold_conv_tier(tier, dall, s, r * cpx, all, stream);
  }
};

// One product of a conv solve over every position: the fp32 GEMM at
// 'highest', else the tier kernel with the planes given (those of p.a).
inline cudaError_t launch_conv_product(int tier, const GemmArgs& p,
                                       const uint32_t* planes, int len,
                                       bool stop, cudaStream_t stream) {
  if (tier == kTierHighest)
    return launch_gather_gemm_stop(p, len, stop, stream);
  return launch_gather_gemm_tier_stop(tier, p, planes, stop, stream);
}

}  // namespace
