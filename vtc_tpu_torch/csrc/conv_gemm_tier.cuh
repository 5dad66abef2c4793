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
// issue slots, so this simple kernel sits far from either bound.  The
// window route below (conv_window_gemm) takes every product whose window
// it can hold: the weights' planes resident, each source element read and
// split once a tile, the copies and epilogue overlapping the passes.
// wgmma and TMA are later work (ROADMAP.md).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "bf16_terms.cuh"
#include "conv_gemm.cuh"
#include "tier_codes.cuh"

// The parts a tier GEMM build runs, for tools/bench_conv_gemm.py --tier,
// which builds each: 1 the copies of the operands only (on the window
// route the pipeline's hand-overs alone), 2 and the split into bf16 terms
// (the window route: its loads and split), 3 and the mma passes, 4 (the
// default, the only build of the library) and the epilogue; 5 the window
// route's math warps alone, on windows never built (gather_gemm_tier's
// build 5 is its build 4).  Other than 4 a kernel writes nothing unless
// its work sums to a value it never takes.
#ifndef VTC_CONV_TIER_PARTS
#define VTC_CONV_TIER_PARTS 4
#endif

// The tier products launched on each route (1 gather_gemm_tier, 2 the
// window route) since the last reset: one copy for the whole library
// (a C++17 inline variable), read and reset through fused_conv_direct.cu's
// C entries.
inline long long vtc_conv_tier_route_count[3] = {0, 0, 0};

namespace {

constexpr int kConvTierParts = VTC_CONV_TIER_PARTS;

// The tier GEMM's routes: 0 the plan's (auto), 1 gather_gemm_tier, 2 the
// window route.
enum ConvTierRoute { kConvRouteAuto = 0, kConvRouteGather = 1,
                     kConvRouteWindow = 2 };

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

// The end of a parts build (kConvTierParts < 4): the split's bits and
// the accumulators kept alive by a store that the values never reach.
__device__ __forceinline__ void conv_tier_parts_sink(
    const GemmArgs& p, uint32_t sink, const float (&acc)[2][4][4],
    const float (&acc_lo)[2][4][4]) {
  float keep = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) keep += acc[i][j][c] + acc_lo[i][j][c];
  if (sink == 0x9e3779b9u || keep == 1234.5f) p.out[threadIdx.x] = keep;
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
  uint32_t sink = 0;  // the parts' builds: the split's bits
  load_slice(0, 0);
  gemm_cp_async_commit();
  for (int q = 0; q < nks; ++q) {
    // always commit, so that wait_group 1 leaves exactly slice q landed
    if (q + 1 < nks) load_slice((q + 1) & 1, q + 1);
    gemm_cp_async_commit();
    gemm_cp_async_wait1();
    __syncthreads();
    if constexpr (kConvTierParts < 2) {
      __syncthreads();
      continue;
    }
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
      if constexpr (kConvTierParts < 3) {
#pragma unroll
        for (int t = 0; t < kTerms; ++t)
          sink ^= bt[t].x ^ bt[t].y ^ a[0][t].x ^ a[1][t].w;
        continue;
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

  if constexpr (kConvTierParts < 4) {
    conv_tier_parts_sink(p, sink, acc, acc_lo);
    return;
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
// s, R*cpx) words; and the route of the solve's tier products
// (kConvRouteAuto, the plan's, or one forced, for checks).
struct ConvTierWeights {
  int tier = kTierHighest;
  int route = kConvRouteAuto;
  uint32_t* stk = nullptr;
  uint32_t* all = nullptr;

  ConvTierWeights() = default;
  ConvTierWeights(int tier_, int route_, void* scratch, int s, int cpx, int r)
      : tier(tier_), route(route_) {
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

// ---------------------------------------------------------------------------
// The window route: conv_window_gemm
// ---------------------------------------------------------------------------
// The same contract as gather_gemm_tier (C[m, n] = sum_k A[m, k]
// src[gather(n, k)], the same epilogues and the same early stop), and the
// same bits: each output's hi x hi pass of each 16-deep step [16 q, 16 q +
// 16) is summed from zero and added to acc with __fadd_rn, q ascending;
// the smaller passes go into acc_lo in the order mid hi, hi mid, lo hi, hi
// lo; the two are added once before the epilogue.  An m16n8k16 product's
// value depends only on the 16 products of each output and on its
// accumulator, not on where the operands came from, so a tile of another
// shape or position order gives the same bits.  What differs is where the
// operands come from, after gather_gemm_tier's parts (PERF.md §6: its
// copies, the split and the epilogue each cost as much as its mma passes,
// and nothing overlapped them but a second block on the SM):
//
//  * A persistent grid of one CTA an SM (fewer where there are fewer
//    tiles), rounded down to a multiple of the 64-row blocks of m: CTA c
//    keeps the m-block c % mblocks and walks the row tiles c / mblocks,
//    c / mblocks + grid / mblocks, ... of it, so no launch ends on a
//    part-full wave.
//  * Resident weights: conv_tier_fold_kernel's planes (kept: they cost
//    two small launches a solve, or a step, against 50-200 products) of
//    the CTA's m-block, copied into shared memory once a launch with
//    16-byte cp.async, in the A fragments' order.
//  * Two roles of 8 warps.  The memory warps build each tile's window and
//    write the tile of C out; the math warps run the mma passes.  The
//    window and the tile of C are double-buffered, so the memory warps
//    build tile k + 1 and write tile k - 1 while the math warps multiply
//    tile k; named barriers hand the buffers over (bar.arrive by the
//    producer, bar.sync by the consumer), none in the K loop.
//  * One source window a tile, read once, split once.  A tile is `rows`
//    whole output rows of one image (at most kWinMaxN positions).  Over
//    every offset and channel its positions read rows + off_h - 1 source
//    rows, shifted by the offsets' least dy, and out_w + off_w - 1
//    columns, shifted by the least dx.  A memory warp takes eight
//    channels, a lane window positions: it loads their values (zero
//    outside the source), five positions' 40 loads in flight before their
//    split, and writes each as the tier's bf16 terms into term planes laid
//    out [term][window position][channel] with a channel stride of src_c
//    + 8 (16 bytes of padding: eight window positions fall in eight
//    distinct 4-bank groups).  A B fragment register, two adjacent
//    channels at one position, is then one 32-bit word, and an 8 x 8 block
//    of positions by channels is one ldmatrix matrix: each 16-deep step
//    (within one offset, since src_c is a multiple of 16) reads its
//    fragments from the window at the offset's shift (a table of one int
//    a step).  So each source element is read once and split once a tile,
//    against off_h off_w copies and 2 off_h off_w splits in
//    gather_gemm_tier.
//  * A math warp owns one m16 tile by the n8 tiles wn, wn + 2, ..., wn +
//    14 of the tile (wn its column half), so a tile of 13 n8 tiles splits
//    7 / 6; it runs them in two halves of four (32 accumulator registers
//    at bf16x5), each pass over the half's four tiles in turn, and writes
//    each half's fragments into the tile of C in shared memory.  The
//    memory warps write whole rows of C from there, 16 outputs' inputs
//    loaded before their stores.
//  * STOP: the stop word is read when the launch starts and, by a memory
//    thread, before each tile's window (the math warps read the verdict
//    with the window); a kProx tile posts its share at its tile index, and
//    the tile that completes the ticket (which counts tiles) sums the
//    shares in tile order and decides.
//
// The route (conv_tier_plan, mirrored by ops/fused_conv_direct.
// conv_tier_plan): the window where src_c is a multiple of 16, K = R
// src_c is at most kTableMaxK, kWinMinOutW <= out_w <= kWinMaxN and one
// output row's buffers fit the shared memory at the tier; else
// gather_gemm_tier, which takes every shape the window route cannot hold
// and stays its bitwise reference.

constexpr int kWinThreads = 512;  // 8 math warps, then 8 memory warps
constexpr int kWinRoleThreads = kWinThreads / 2;
constexpr int kWinMaxN = 128;  // positions a tile, at most (16 n8 tiles)
constexpr int kWinMinOutW = kWindowMinOutW;  // conv_gemm.cuh's
// a CTA's dynamic shared memory: the SM's 233,472 bytes less 1 KB
// reserved a CTA and 1 KB for static memory
constexpr long long kWinSmem = 232448 - 1024;

// A tier product's route and, on the window route, its layout.
struct ConvTierPlan {
  int route = kConvRouteGather;  // kConvRouteGather or kConvRouteWindow
  int rows = 0;         // output rows a tile (0: the window cannot take it)
  int mblocks = 0;      // 64-row blocks of m
  long long tiles = 0;  // mblocks * nb * ceil(out_h / rows)
  int grid = 0;         // CTAs of the persistent grid
  long long smem = 0;   // dynamic shared memory a CTA, bytes
};

// Dynamic shared memory of a window CTA: the m-block's A planes, two
// windows' term planes, two tiles of C, the step table.
inline long long window_smem_bytes(int terms, int k, int src_c, int off_w,
                                   int off_h, int out_w, int rows) {
  const long long nks = k / 16;
  const long long wr = rows + off_h - 1, wc = out_w + off_w - 1;
  const long long a = static_cast<long long>(terms) * (kBM / 16) * nks * 512;
  const long long planes = 2LL * terms * wr * wc * (src_c + 8);
  const long long n8 = (static_cast<long long>(rows) * out_w + 7) / 8;
  const long long ctile = 4LL * kBM * (8 * n8 + 4);
  return a + 2 * planes + 2 * ctile + 4 * nks;
}

// The window plan of a tier product at `rows` output rows a tile (see
// conv_tier_plan for the arguments).
inline ConvTierPlan window_plan_at(int m, int k, int src_c, int off_w,
                                   int out_h, int out_w, int nb, int tier,
                                   int sm_count, int rows) {
  ConvTierPlan plan;
  plan.route = kConvRouteWindow;
  plan.rows = rows;
  plan.mblocks = (m + kBM - 1) / kBM;
  const long long row_tiles =
      static_cast<long long>(nb) * ((out_h + rows - 1) / rows);
  plan.tiles = plan.mblocks * row_tiles;
  const long long per_mb = sm_count / plan.mblocks;  // CTAs an m-block
  plan.grid = static_cast<int>((row_tiles < per_mb ? row_tiles : per_mb) *
                               plan.mblocks);
  plan.smem = window_smem_bytes(conv_tier_terms(tier), k, src_c, off_w,
                                (k / src_c - 1) / off_w + 1, out_w, rows);
  return plan;
}

// The route and layout of a tier product of m rows, depth k over src_c
// channels (offsets off_w a row), nb images of out_h x out_w positions, at
// tier on a card of sm_count SMs: a pure function of the shape.  The
// window route where it takes the shape (see above), at the rows a tile,
// of those that fit, whose CTA does the least work: its rounds of tiles
// and one (the pipeline's fill) times a tile's window rows, the most rows
// of equals; else gather_gemm_tier.
inline ConvTierPlan conv_tier_plan(int m, int k, int src_c, int off_w,
                                   int out_h, int out_w, int nb, int tier,
                                   int sm_count) {
  const int terms = conv_tier_terms(tier);
  const int mblocks = (m + kBM - 1) / kBM;
  if (terms == 0 || m < 1 || k < 16 || src_c < 16 || src_c % 16 != 0 ||
      k % src_c != 0 || k > kTableMaxK || off_w < 1 ||
      out_w < kWinMinOutW || out_w > kWinMaxN || out_h < 1 || nb < 1 ||
      sm_count < mblocks)
    return ConvTierPlan();
  const int off_h = (k / src_c - 1) / off_w + 1;
  int fit = kWinMaxN / out_w;
  while (fit > 0 && window_smem_bytes(terms, k, src_c, off_w, off_h, out_w,
                                      fit) > kWinSmem)
    --fit;
  if (fit == 0) return ConvTierPlan();
  const long long slots = sm_count / mblocks;
  auto work = [&](int rows) {
    const long long tiles = static_cast<long long>(nb) *
                            ((out_h + rows - 1) / rows);
    return ((tiles + slots - 1) / slots + 1) * (rows + off_h - 1);
  };
  int rows = fit;
  for (int r = fit - 1; r >= 1; --r)
    if (work(r) < work(rows)) rows = r;
  return window_plan_at(m, k, src_c, off_w, out_h, out_w, nb, tier, sm_count,
                        rows);
}

// The window kernel's launch arguments, fixed for a launch.
struct WindowArgs {
  int rows;          // output rows a tile
  int row_tiles;     // tiles an image: ceil(out_h / rows)
  int mblocks;       // 64-row blocks of m
  long long tiles;   // mblocks * nb * row_tiles
  int wr, wc, cp;    // window rows, columns, channel stride (bf16 values)
  int dymin, dxmin;  // the source row and column of window (0, 0), less
                     // the tile's first output row and 0
  int nks;           // 16-deep steps, k / 16
  int plane_elems;   // bf16 values of one term's window plane
  int ctile_off;     // byte offset of the first tile of C
  int ctile_bytes;   // bytes a tile of C
  int table_off;     // byte offset of the step table
};

// Four 8 x 8 matrices of 16-bit values from shared memory: lanes 8 i to 8
// i + 7 give the row addresses of matrix i, and r[i] receives its
// fragment (row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 in lane l).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void gemm_cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Named barrier `id` over `threads` threads: wait for all of them, or
// arrive without waiting (a producer handing a buffer to its consumers;
// the arrival orders the thread's earlier shared-memory writes before
// the consumers' reads).
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// The window kernel's named barriers: the memory warps' own, then a
// window buffer's full and free and a tile of C's full and free, two of
// each (double-buffered).
enum WindowBarrier { kBarMem = 1, kBarFull = 2, kBarFree = 4, kBarCFull = 6,
                     kBarCFree = 8 };

// The parts builds' sum of the accumulators (kConvTierParts 3 and 5).
__device__ __forceinline__ float window_parts_keep(
    const float (&acc)[4][4], const float (&acc_lo)[4][4]) {
  float keep = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) keep += acc[j][c] + acc_lo[j][c];
  return keep;
}

// A window tile's share of the early stop, in every memory thread:
// conv_stop_post's sums over the memory warps, with the tile's slot and
// the launch's tile count in place of the block's (the ticket counts
// tiles); the tile that completes the ticket sums the shares in tile order
// and decides (or, with st.local, leaves the rank's sum there) and resets
// the ticket.
__device__ __forceinline__ void window_stop_post(const ConvStop& st,
                                                 float delta, float eta,
                                                 long long slot,
                                                 long long tiles) {
  constexpr int kWarps = kWinRoleThreads / 32;
  __shared__ float warp_shares[kWarps];
  __shared__ int last;
  unsigned* const ticket = reinterpret_cast<unsigned*>(st.words + 1);
  float* const shares = reinterpret_cast<float*>(st.words + kStopCtlWords);
  const int tid = threadIdx.x % kWinRoleThreads;
  delta = conv_warp_sum(delta);
  if ((tid & 31) == 0) warp_shares[tid >> 5] = delta;
  named_sync(kBarMem, kWinRoleThreads);
  if (tid == 0) {
    float share = 0.0f;
    for (int w = 0; w < kWarps; ++w) share = __fadd_rn(share, warp_shares[w]);
    shares[slot] = share;
    // release: the share before the ticket; acquire: the last tile sees
    // every share, and passes them on to its threads at the barrier
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> arrivals(*ticket);
    last = arrivals.fetch_add(1u, cuda::memory_order_acq_rel) ==
           static_cast<unsigned>(tiles - 1);
  }
  named_sync(kBarMem, kWinRoleThreads);
  if (last) {  // the same in every memory thread
    float sum = 0.0f;
    for (long long i = tid; i < tiles; i += kWinRoleThreads)
      sum = __fadd_rn(sum, reinterpret_cast<volatile float*>(shares)[i]);
    sum = conv_warp_sum(sum);
    if ((tid & 31) == 0) warp_shares[tid >> 5] = sum;
    named_sync(kBarMem, kWinRoleThreads);
    if (tid == 0) {
      float total = 0.0f;
      for (int w = 0; w < kWarps; ++w) total = __fadd_rn(total, warp_shares[w]);
      *ticket = 0u;
      if (st.local != nullptr)
        *st.local = total;
      else
        conv_stop_decide(st, total, eta);
    }
  }
  named_sync(kBarMem, kWinRoleThreads);  // warp_shares and last are free
}

template <int TIER, bool STOP>
__global__ void __launch_bounds__(kWinThreads, 1)
    conv_window_gemm(GemmArgs p, const uint32_t* __restrict__ planes,
                     long long plane_words, WindowArgs w) {
  constexpr int kTerms = conv_tier_terms(TIER);
  static_assert(kTerms >= 1, "a tier, not 'highest'");
  constexpr int kSmall = 2 * kTerms - 2;
  constexpr int kPassA[4] = {1, 0, 2, 0}, kPassB[4] = {0, 1, 0, 2};
  constexpr int kRole = kWinRoleThreads, kRoleWarps = kRole / 32;
  constexpr int kBoth = kWinThreads;
  constexpr int kPos = 5;  // window positions a lane loads a batch
  constexpr int kER = 4;     // rows of C a memory warp's epilogue batch
  extern __shared__ __align__(16) unsigned char win_smem[];
  __shared__ int go[2];  // STOP: whether a window's tile runs
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool memory = warp >= kRoleWarps;  // else a math warp
  const int rt_tid = threadIdx.x % kRole;   // thread of the role
  const int rw = rt_tid >> 5;               // warp of the role
  if constexpr (STOP) {
    if (threadIdx.x == 0)
      go[0] = !conv_stopped(p.stop, conv_stop_word(p.stop));
    __syncthreads();
    if (!go[0]) return;
  }
  const int mb = static_cast<int>(blockIdx.x % w.mblocks);  // fixed
  const int m0 = mb * kBM;
  const int len = p.out_h * p.out_w;
  const int a_term = (kBM / 16) * w.nks * 128;  // A words a term
  uint32_t* as = reinterpret_cast<uint32_t*>(win_smem);
  uint16_t* wplanes0 = reinterpret_cast<uint16_t*>(as + kTerms * a_term);
  int* qtab = reinterpret_cast<int*>(win_smem + w.table_off);
  const int npos = w.wr * w.wc;  // window positions
  const long long chw = static_cast<long long>(p.src_h) * p.src_w;

  // the m-block's A planes, once a launch, by both roles
  const int a_pieces = a_term / 4;  // 16-byte pieces a term
  for (int c = threadIdx.x; c < kTerms * a_pieces; c += kBoth) {
    const int t = c / a_pieces, piece = c - t * a_pieces;
    gemm_cp_async16(as + t * a_term + piece * 4,
                    planes + t * plane_words +
                        static_cast<long long>(mb) * a_term + piece * 4);
  }
  gemm_cp_async_commit();
  // step q's shift into the window planes: its offset's (dy, dx) less the
  // window's origin, times the channel stride, plus its first channel
  for (int q = threadIdx.x; q < w.nks; q += kBoth) {
    const int k0 = 16 * q, o = k0 / p.src_c, c0 = k0 - o * p.src_c;
    const int dy = p.sign * (o / p.off_w) + p.off_y0;
    const int dx = p.sign * (o % p.off_w) + p.off_x0;
    qtab[q] = ((dy - w.dymin) * w.wc + (dx - w.dxmin)) * w.cp + c0;
  }
  gemm_cp_async_wait_all();
  __syncthreads();  // the A planes and the step table, for both roles

  // this CTA's row tiles of its m-block: rt0, rt0 + step, ... (n of them);
  // tile index rt * mblocks + mb, image b, first output row y0
  const long long rt0 = blockIdx.x / w.mblocks;
  const long long step = gridDim.x / w.mblocks;
  const long long rt_end = w.tiles / w.mblocks;
  const int n = rt0 < rt_end ? static_cast<int>((rt_end - rt0 + step - 1) /
                                                step)
                             : 0;
  auto tile_origin = [&](int kk, int* b, int* y0) {
    const long long rt = rt0 + kk * step;
    *b = static_cast<int>(rt / w.row_tiles);
    *y0 = static_cast<int>(rt - static_cast<long long>(*b) * w.row_tiles) *
          w.rows;
  };

  if (memory) {
    const float eta = p.epilogue == kProx ? *p.eta : 0.f;
    const float thresh = __fmul_rn(p.lam, eta);
    uint32_t sink = 0;  // the parts builds' split bits
    // the epilogue of tile kk from its tile of C
    auto epilogue = [&](int kk) {
      int b, y0;
      tile_origin(kk, &b, &y0);
      const float* cs = reinterpret_cast<const float*>(
          win_smem + w.ctile_off + (kk & 1) * w.ctile_bytes);
      const int cnt = min(w.rows, p.out_h - y0) * p.out_w;
      const int kcs = 8 * ((cnt + 7) / 8) + 4;
      const int t0 = y0 * p.out_w;
      const long long cbase = static_cast<long long>(b) * p.m * len + t0;
      float delta = 0.f;  // STOP: this thread's sum of |codes - old|
#pragma unroll 1
      for (int r0 = rw * kER; r0 < kBM; r0 += kRoleWarps * kER) {
        EpiIn in[kER][kWinMaxN / 32];
#pragma unroll
        for (int r = 0; r < kER; ++r) {
          const int m = m0 + r0 + r;
#pragma unroll
          for (int q = 0; q < kWinMaxN / 32; ++q) {
            const int col = lane + 32 * q;
            if (m < p.m && col < cnt)
              in[r][q] = epilogue_load(
                  p, cbase + static_cast<long long>(m) * len + col,
                  static_cast<long long>(m) * len + t0 + col);
          }
        }
#pragma unroll
        for (int r = 0; r < kER; ++r) {
          const int m = m0 + r0 + r;
#pragma unroll
          for (int q = 0; q < kWinMaxN / 32; ++q) {
            const int col = lane + 32 * q;
            if (m < p.m && col < cnt)
              epilogue_store<STOP>(
                  p, cbase + static_cast<long long>(m) * len + col,
                  cs[(r0 + r) * kcs + col], in[r][q], eta, thresh, &delta);
          }
        }
      }
      if constexpr (STOP)
        if (p.epilogue == kProx)
          window_stop_post(p.stop, delta, eta,
                           (rt0 + kk * step) * w.mblocks + mb, w.tiles);
    };
    for (int kk = 0; kk < n; ++kk) {
      const int buf = kk & 1;
      if (kk >= 2) named_sync(kBarFree + buf, kBoth);
      bool run = true;
      if constexpr (STOP) {
        if (rt_tid == 0)
          go[buf] = !conv_stopped(p.stop, conv_stop_word(p.stop));
        named_sync(kBarMem, kRole);
        run = go[buf];
      }
      int b, y0;
      tile_origin(kk, &b, &y0);
      uint16_t* wplanes = wplanes0 + buf * kTerms * w.plane_elems;
      // the window: a warp eight channels, a lane the window positions
      // pos = lane + 32 i, kPos of them (8 kPos loads) in flight before
      // their splits; each term's two bf16 values one word, zeros outside
      // the source
      for (int co = rw;
           run && kConvTierParts >= 2 && kConvTierParts != 5 &&
           co < p.src_c / 8;
           co += kRoleWarps) {
        const float* src0 =
            p.src + (static_cast<long long>(b) * p.src_c + 8 * co) * chw;
        uint32_t* dst = reinterpret_cast<uint32_t*>(wplanes) + 4 * co;
        for (int pos0 = 0; pos0 < npos; pos0 += 32 * kPos) {
          float v[8][kPos];
#pragma unroll
          for (int i = 0; i < kPos; ++i) {
            const int pos = pos0 + lane + 32 * i;
            const int wy = pos / w.wc, wx = pos - wy * w.wc;
            const int sy = y0 + w.dymin + wy, sx = w.dxmin + wx;
            const bool ok = pos < npos &&
                            static_cast<unsigned>(sy) <
                                static_cast<unsigned>(p.src_h) &&
                            static_cast<unsigned>(sx) <
                                static_cast<unsigned>(p.src_w);
            const long long at = static_cast<long long>(sy) * p.src_w + sx;
#pragma unroll
            for (int c = 0; c < 8; ++c)
              v[c][i] = ok ? __ldg(src0 + c * chw + at) : 0.0f;
          }
#pragma unroll
          for (int i = 0; i < kPos; ++i) {
            const int pos = pos0 + lane + 32 * i;
            if (pos >= npos) continue;
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              uint16_t t0[kTerms], t1[kTerms];
              split_bits<kTerms>(v[2 * u][i], t0);
              split_bits<kTerms>(v[2 * u + 1][i], t1);
#pragma unroll
              for (int tt = 0; tt < kTerms; ++tt) {
                const uint32_t word = static_cast<uint32_t>(t0[tt]) |
                                      (static_cast<uint32_t>(t1[tt]) << 16);
                dst[(tt * w.plane_elems + pos * w.cp) / 2 + u] = word;
                if constexpr (kConvTierParts == 2) sink ^= word;
              }
            }
          }
        }
      }
      named_arrive(kBarFull + buf, kBoth);
      if (kk >= 1 && kConvTierParts == 4) {
        const int cb = (kk - 1) & 1;
        named_sync(kBarCFull + cb, kBoth);
        epilogue(kk - 1);
        // the math warps write that tile of C again two tiles on
        if (run && kk + 1 < n) named_arrive(kBarCFree + cb, kBoth);
      }
      if (!run) return;
    }
    if (n >= 1 && kConvTierParts == 4) {
      named_sync(kBarCFull + ((n - 1) & 1), kBoth);
      epilogue(n - 1);
    }
    if constexpr (kConvTierParts == 2)
      if (sink == 0x9e3779b9u) p.out[threadIdx.x] = 0.0f;
    return;
  }

  // the math warps: a tile in two halves of four n8 tiles a warp, each
  // half's K loop from the window, then its fragments into the tile of C
  const int wm = rw & 3, wn = rw >> 2;  // the warp's m16 tile, column half
  float keep = 0.0f;  // the parts builds' sum of the accumulators
  for (int kk = 0; kk < n; ++kk) {
    const int buf = kk & 1;
    named_sync(kBarFull + buf, kBoth);
    if constexpr (STOP)
      if (!go[buf]) return;
    // the tile of C two tiles back is written out (double-buffered)
    if (kk >= 2 && kConvTierParts == 4) named_sync(kBarCFree + buf, kBoth);
    int b, y0;
    tile_origin(kk, &b, &y0);
    const int cnt = min(w.rows, p.out_h - y0) * p.out_w;  // positions
    const int n8 = (cnt + 7) / 8;                           // n8 tiles
    const int kcs = 8 * n8 + 4;
    const unsigned wbase = static_cast<unsigned>(__cvta_generic_to_shared(
        wplanes0 + buf * kTerms * w.plane_elems));
    float* cs = reinterpret_cast<float*>(win_smem + w.ctile_off +
                                         buf * w.ctile_bytes);
#pragma unroll 1
    for (int half = 0; half < 2; ++half) {
      if (wn + 8 * half >= n8) break;  // warp-uniform
      // this lane's ldmatrix rows: matrix l / 8 of pair pr is the n8 tile
      // wn + 2 (4 half + 2 pr + l / 16), channels 8 ((l / 8) % 2) on
      int lane_off[2];
#pragma unroll
      for (int pr = 0; pr < 2; ++pr) {
        int pos = 8 * (wn + 2 * (4 * half + 2 * pr + (lane >> 4))) +
                  (lane & 7);
        if (pos >= cnt) pos = 0;  // any position: its columns are not kept
        const int y = pos / p.out_w;
        lane_off[pr] = ((y * w.wc) + (pos - y * p.out_w)) * w.cp +
                       8 * ((lane >> 3) & 1);
      }
      float acc[4][4], acc_lo[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[j][c] = acc_lo[j][c] = 0.0f;
      if constexpr (kConvTierParts >= 3) {
        for (int q = 0; q < w.nks; ++q) {
          uint4 a[kTerms];
#pragma unroll
          for (int tt = 0; tt < kTerms; ++tt)
            a[tt] = *reinterpret_cast<const uint4*>(
                as + tt * a_term + (wm * w.nks + q) * 128 + lane * 4);
          const int sh = qtab[q];
          // the half's B fragments, two n8 tiles an ldmatrix
          uint2 bt[4][kTerms];
#pragma unroll
          for (int pr = 0; pr < 2; ++pr) {
            if (wn + 2 * (4 * half + 2 * pr) >= n8) continue;  // uniform
#pragma unroll
            for (int tt = 0; tt < kTerms; ++tt) {
              uint32_t r[4];
              ldmatrix_x4(r, wbase + 2u * static_cast<unsigned>(
                                         tt * w.plane_elems + lane_off[pr] +
                                         sh));
              bt[2 * pr][tt] = make_uint2(r[0], r[1]);
              bt[2 * pr + 1][tt] = make_uint2(r[2], r[3]);
            }
          }
          // each pass over the four n8 tiles in turn, so that consecutive
          // mma instructions are independent; each output still takes
          // gather_gemm_tier's passes in its order: the hi x hi pass from
          // zero, one round-to-nearest add, then the smaller passes
          bool live[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) live[j] = wn + 2 * (4 * half + j) < n8;
          float hh[4][4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int c = 0; c < 4; ++c) hh[j][c] = 0.0f;
            if (live[j]) mma_bf16(hh[j], a[0], bt[j][0]);
          }
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              acc[j][c] = __fadd_rn(acc[j][c], hh[j][c]);
#pragma unroll
          for (int r = 0; r < kSmall; ++r)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (live[j])
                mma_bf16(acc_lo[j], a[kPassA[r]], bt[j][kPassB[r]]);
        }
      }
      if constexpr (kConvTierParts != 4) {
        keep += window_parts_keep(acc, acc_lo);
        continue;
      }
      // the half's fragments into the tile of C: row (l >> 2) + 8 (c >>
      // 1), column 2 (l & 3) + (c & 1) of each
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t8 = wn + 2 * (4 * half + j);
        if (t8 >= n8) continue;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = wm * 16 + (lane >> 2) + 8 * h;
          const int col = 8 * t8 + 2 * (lane & 3);
          float v0 = acc[j][2 * h], v1 = acc[j][2 * h + 1];
          if constexpr (kSmall > 0) {
            v0 = __fadd_rn(v0, acc_lo[j][2 * h]);
            v1 = __fadd_rn(v1, acc_lo[j][2 * h + 1]);
          }
          *reinterpret_cast<float2*>(cs + row * kcs + col) =
              make_float2(v0, v1);
        }
      }
    }
    // the window is free once every math warp has multiplied it
    if (kk + 2 < n) named_arrive(kBarFree + buf, kBoth);
    if (kConvTierParts == 4) named_arrive(kBarCFull + buf, kBoth);
  }
  if constexpr (kConvTierParts != 4)
    if (keep == 1234.5f) p.out[threadIdx.x] = keep;
}

// One window launch of p on `plan` (a window plan of p's shape).
template <int TIER, bool STOP>
cudaError_t launch_conv_window(const GemmArgs& p, const uint32_t* planes,
                               const ConvTierPlan& plan, cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      conv_window_gemm<TIER, STOP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kWinSmem));
  if (attr != cudaSuccess) return attr;
  const int off_h = (p.k / p.src_c - 1) / p.off_w + 1;
  const int terms = conv_tier_terms(TIER);
  WindowArgs w;
  w.rows = plan.rows;
  w.row_tiles = (p.out_h + plan.rows - 1) / plan.rows;
  w.mblocks = plan.mblocks;
  w.tiles = plan.tiles;
  w.wr = plan.rows + off_h - 1;
  w.wc = p.out_w + p.off_w - 1;
  w.cp = p.src_c + 8;
  w.dymin = p.off_y0 + (p.sign > 0 ? 0 : -(off_h - 1));
  w.dxmin = p.off_x0 + (p.sign > 0 ? 0 : -(p.off_w - 1));
  w.nks = p.k / 16;
  w.plane_elems = w.wr * w.wc * w.cp;
  w.ctile_off = static_cast<int>(4LL * terms * (kBM / 16) * w.nks * 128 +
                                 4LL * terms * w.plane_elems);
  w.ctile_bytes = 4 * kBM * (8 * ((plan.rows * p.out_w + 7) / 8) + 4);
  w.table_off = static_cast<int>(plan.smem - 4LL * w.nks);
  conv_window_gemm<TIER, STOP>
      <<<plan.grid, kWinThreads, static_cast<size_t>(plan.smem), stream>>>(
          p, planes, conv_tier_plane_words(p.m, p.k), w);
  return cudaGetLastError();
}

inline cudaError_t launch_conv_window_stop(int tier, const GemmArgs& p,
                                           const uint32_t* planes,
                                           const ConvTierPlan& plan,
                                           bool stop, cudaStream_t stream) {
  if (plan.route != kConvRouteWindow || planes == nullptr)
    return cudaErrorInvalidValue;
#define VTC_WINDOW(T)                                                    \
  (stop ? launch_conv_window<T, true>(p, planes, plan, stream)          \
        : launch_conv_window<T, false>(p, planes, plan, stream))
  switch (tier) {
    case kTierBf16: return VTC_WINDOW(kTierBf16);
    case kTierBf16x3: return VTC_WINDOW(kTierBf16x3);
    case kTierBf16x5: return VTC_WINDOW(kTierBf16x5);
    default: return cudaErrorInvalidValue;
  }
#undef VTC_WINDOW
}

// The plan of p at tier on this card.
inline ConvTierPlan conv_tier_plan_of(const GemmArgs& p, int tier) {
  return conv_tier_plan(p.m, p.k, p.src_c, p.off_w, p.out_h, p.out_w, p.nb,
                        tier, gemm_sm_count());
}

// One tier product on `route` (kConvRouteAuto: the plan's), the STOP
// build where stop is true; counted in vtc_conv_tier_route_count.
// kConvRouteWindow on a shape the window cannot take is
// cudaErrorInvalidValue: no route gives way to another.
inline cudaError_t launch_conv_tier_route(int route, int tier,
                                          const GemmArgs& p,
                                          const uint32_t* planes,
                                          bool stop, cudaStream_t stream) {
  const ConvTierPlan plan = conv_tier_plan_of(p, tier);
  if (route == kConvRouteAuto) route = plan.route;
  if (route != kConvRouteGather && route != kConvRouteWindow)
    return cudaErrorInvalidValue;
  ++vtc_conv_tier_route_count[route];
  return route == kConvRouteWindow
             ? launch_conv_window_stop(tier, p, planes, plan, stop, stream)
             : launch_gather_gemm_tier_stop(tier, p, planes, stop, stream);
}

// One product of a conv solve over every position: the fp32 GEMM at
// 'highest', else the tier kernel on w's route with the planes given (w's
// planes of p.a).
inline cudaError_t launch_conv_product(const ConvTierWeights& w,
                                       const GemmArgs& p,
                                       const uint32_t* planes, int len,
                                       bool stop, cudaStream_t stream) {
  if (w.tier == kTierHighest)
    return launch_gather_gemm_stop(p, len, stop, stream);
  return launch_conv_tier_route(w.route, w.tier, p, planes, stop, stream);
}

}  // namespace
