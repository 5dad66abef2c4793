// The ISTA/FISTA solve at the precision tiers of K1, K4 and the solves of
// K2, K3, K6, K7, K15 and K16, for Hopper (sm_90a): two bf16 tensor-core
// kernels with the same bits, fista_tier_kernel (below, with its fold
// kernel) and fista_tier_cluster_kernel (the resident layouts, "The
// resident layouts" further down), their route and launchers.  Included
// by fused_fista.cu and fused_group_fista.cu after fista_core.cuh, whose
// launch_solve takes a tier other than kTierHighest here.
//
// Replaces the tiers of the TPU kernels K1 (vtc_tpu/ops/pallas_fista.py,
// _make_kernel :44-56), K4 (pallas_group_fista.py :54-66), K2 and K6
// (pallas_train_step.py :398-411, :541-588): their iteration product is
// built by _make_iter_dot(mxu) (pallas_train_step.py:129-169) and their
// group prox by _make_group_prox(mxu, hard, roll_m) (:248-320).
//
// What a tier computes.  vtc_tpu splits each float32 operand into bf16
// terms (round to nearest even) and sums single-pass bf16 products in
// float32:
//   bf16    one pass, bf16(z) bf16(G);
//   bf16x3  hi and lo (_split_hi_lo: hi = bf16(x), lo = bf16(x - hi)),
//           z_hi G_hi + z_lo G_hi + z_hi G_lo;
//   bf16x5  the exact three-term split (_split3: hi, mid = bf16(x - hi),
//           lo = bf16(x - hi - mid)), five of the nine cross products:
//           hi hi + mid hi + hi mid + lo hi + hi lo.
// A product of two bf16 values is exact in float32, so the card's bf16
// tensor cores with float32 accumulation (mma.sync m16n8k16 .bf16 .f32)
// compute the same passes; only the order of the float32 sums differs.
// TF32 keeps 10 explicit mantissa bits where bf16 keeps 7, so a TF32
// split would not give vtc_tpu's terms.
//
// Contract: fista_core.cuh's, codes = prox(z + z @ (-eta G) + eta c) with
// its momentum and warm start, the product at the tier.  -eta G is formed
// in float32 and then split, once per solve, as prep_gram(-eta * gram)
// (pallas_fista.py:94), by fold_tier_kernel, into bf16 planes in global
// memory (one per term of G; 128 KB each at s 256, so they stay in L2).
// The group prox at M a power of two (vtc_tpu's rotate-and-add prox,
// roll_prox_window :218-245) and at bf16x5 (the exact split of
// _make_prox_dots :172-199) sums its windows in float32: that is
// fista_core.cuh's group_prox.  At other M, bf16x3 and bf16 take
// _make_prox_dots' rounding: the window sums of the hi and lo terms of
// x^2 (bf16: of bf16(x^2)) and the scale as hi + lo (bf16: bf16(scale)).
//
// fista_tier_kernel's layout: fista_kernel's.  It is the route of every
// shape the resident layouts cannot hold (M outside {1, 2, 4}, s not a
// multiple of 16, a stop across ranks or past one resident wave) and
// their bitwise reference.  One block of kRows = 16 batch rows (the m16 of
// one mma tile) and kThreads = 256 threads, ceil(b / 16) blocks, the
// whole solve in one launch (rows are independent; t_k is a scalar every
// block recomputes).  The block's state (z twice for ping-pong, old, eta
// c; (4, 16, sk) floats) lives in shared memory when it fits beside the z
// terms, else in global scratch; with the stop it is global and the
// classic stop route (drive_classic_stop) launches the kernel once per
// iteration, so the state layout and the stop words are fista_kernel's,
// and across ranks (K15, K16) the rank's share goes to the host hook as
// fista_kernel's does.
// K1's variant (FISTA or ISTA) and shrink are run-time arguments: they
// act only in the epilogue, one branch a column block after the products,
// so 6 builds serve K1's 8 variants at 3 tiers with and without the
// stop; K4 builds its four in (launch_tier
// says why), 30 tier kernels in all.  TIER sizes the fragment and
// accumulator arrays and STOP changes the kernel's entry and exit, so
// they stay templates.
//  * Each iteration the block splits its 16 rows of z into their bf16
//    terms in shared memory, stored in the mma A fragments' order: a lane
//    reads its four registers of a 16 x 16 tile as one 16-byte load.
//  * The planes are stored in the B fragments' order: for each 8-column
//    tile and 16-deep step, 32 lanes x two registers, so a warp reads one
//    tile of a term as 256 contiguous bytes from L2.
//  * Warp w of a 256-column block owns its columns [32 w, 32 w + 32):
//    four n8 tiles.  Over the depth it issues the tier's passes per tile,
//    the hi x hi pass into one float32 accumulator and the smaller passes
//    into a second, added at the end (the small passes would otherwise be
//    rounded against the large sum at every step).
//  * The epilogue is fista_kernel's: (z + acc) + eta c, the shrink or
//    (GROUP) the pre-prox value, the momentum; the group pass after the
//    last column block; then the next z is split.
//  * Padded columns: the planes are exact zeros past s, so padded codes
//    stay +0.0f; padded rows have z = c = 0 and stay 0.
//
// What bounds it on this card.  At b 2048, s 256, the passes are
// 2 b s^2 FLOPs each, 26.8 GFLOP an iteration-hundred at bf16, against
// 989 TFLOP/s of dense bf16 tensor-core rate: 27 µs for 100 iterations
// at bf16, 81 at bf16x3, 136 at bf16x5.  mma.sync reaches a fraction of
// that rate (wgmma is the only way to all of it), and each block streams
// every plane from L2 every iteration (256 KB at bf16x3 and s 256, 32 MB
// an iteration over 128 blocks), so L2's bandwidth, not the tensor cores,
// bounds this simple kernel; the resident layouts keep the planes in
// shared memory instead.  TMA and wgmma are later work (ROADMAP.md).
#pragma once

#include <cuda_bf16.h>

#include "bf16_terms.cuh"
#include "fista_core.cuh"

namespace {

constexpr int kTierWarps = kThreads / 32;
constexpr int kTierTiles = kColBlock / 8 / kTierWarps;  // n8 tiles a warp
static_assert(kRows == 16, "a block's rows are one m16 tile");
static_assert(kTierTiles == 4, "a warp owns 32 columns of a column block");
static_assert(kChunk % 16 == 0, "sk is whole k16 steps");

// Floats of gn scratch the tier's planes take for a padded (sk, sc) -eta G:
// tier_terms bf16 planes of sk x sc, at least the classic route's sk x sc.
__host__ __device__ inline int64_t tier_gn_floats(int tier, int sk, int sc) {
  const int64_t plane = static_cast<int64_t>(sk) * sc;
  const int64_t need = (tier_terms(tier) * plane + 1) / 2;
  return need > plane ? need : plane;
}

// Bytes of shared memory the block's z terms take, and the whole dynamic
// shared memory with the state in shared memory or not.
__host__ __device__ inline int tier_terms_bytes(int tier, int sk) {
  return tier_terms(tier) * kRows * sk * static_cast<int>(sizeof(uint16_t));
}
__host__ __device__ inline int tier_smem(int tier, int sk, bool state_smem) {
  return tier_terms_bytes(tier, sk) +
         (state_smem ? 4 * kRows * sk * static_cast<int>(sizeof(float)) : 0);
}

// Whether the block's state fits its shared memory beside the z terms.
__host__ __device__ inline bool tier_state_in_smem(int tier, int sk) {
  return tier_smem(tier, sk, true) <= kSmemPerBlock;
}

// -eta G (float32, padded with zeros to (sk, sc)), split into the tier's
// terms, each a plane of sk * sc bf16 values in the B fragments' order:
// value idx of a plane is register half h (bit 0), register e (bit 1),
// lane l (bits 2-6), then the 16-deep step q and the 8-column tile j,
// j-major; it holds (k, n) = (16 q + 2 (l & 3) + 8 e + h, 8 j + (l >> 2)).
template <int TERMS>
__global__ void fold_tier_kernel(const float* __restrict__ gram,
                                 const float* __restrict__ eta_ptr,
                                 uint16_t* __restrict__ planes, int s, int sk,
                                 int sc) {
  const float neg_eta = -(*eta_ptr);
  const int nks = sk / 16;
  const int64_t plane = static_cast<int64_t>(sk) * sc;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       idx < plane; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int h = static_cast<int>(idx & 1);
    const int e = static_cast<int>((idx >> 1) & 1);
    const int l = static_cast<int>((idx >> 2) & 31);
    const int64_t tile = idx >> 7;
    const int q = static_cast<int>(tile % nks);
    const int j = static_cast<int>(tile / nks);
    const int k = 16 * q + 2 * (l & 3) + 8 * e + h;
    const int n = 8 * j + (l >> 2);
    const float v = (k < s && n < s)
                        ? neg_eta * gram[static_cast<int64_t>(k) * s + n]
                        : 0.0f;
    uint16_t t[TERMS];
    split_bits<TERMS>(v, t);
#pragma unroll
    for (int p = 0; p < TERMS; ++p) planes[p * plane + idx] = t[p];
  }
}

// Split the block's 16 rows of z (row stride sk) into the tier's terms in
// the A fragments' order: word w of a term (two bf16 values) is register r
// (bits 0-1) of lane l (bits 2-6) of the 16-deep step q; it holds rows
// (l >> 2) + 8 (r & 1) and depths 16 q + 2 (l & 3) + 8 (r >> 1) + {0, 1}.
template <int TERMS>
__device__ __forceinline__ void split_rows(const float* z, int sk,
                                           uint32_t* terms) {
  const int words = kRows * sk / 2;  // of one term
  for (int w = threadIdx.x; w < words; w += kThreads) {
    const int r = w & 3;
    const int l = (w >> 2) & 31;
    const int q = w >> 7;
    const int row = (l >> 2) + 8 * (r & 1);
    const int k = 16 * q + 2 * (l & 3) + 8 * (r >> 1);
    const float2 v = *reinterpret_cast<const float2*>(z + row * sk + k);
    uint16_t lo[TERMS], hi[TERMS];
    split_bits<TERMS>(v.x, lo);
    split_bits<TERMS>(v.y, hi);
#pragma unroll
    for (int p = 0; p < TERMS; ++p)
      terms[p * words + w] =
          static_cast<uint32_t>(lo[p]) | (static_cast<uint32_t>(hi[p]) << 16);
  }
}

// The variant as a run-time argument (fista_core.cuh's templates do the
// arithmetic).
__device__ __forceinline__ float momentum_at(bool fista, float code,
                                             float old, float beta) {
  return fista ? momentum<true>(code, old, beta)
               : momentum<false>(code, old, beta);
}

__device__ __forceinline__ float next_t_at(bool fista, float t_k,
                                           float* beta) {
  return fista ? next_t<true>(t_k, beta) : next_t<false>(t_k, beta);
}

// The group prox over the block's rows at bf16x3 or bf16 for a window M
// that is not a power of two: _make_prox_dots' rounding of the window sums
// (the bf16 terms of each x^2, summed term by term) and of the scale each
// slot receives; otherwise group_prox's.  Adds |code - old| to *delta, in
// order, when delta is set.
template <bool HARD, int TIER>
__device__ __forceinline__ void tier_group_prox(bool fista, float* zn,
                                                float* old, int s, int sk,
                                                int group_size, float t,
                                                float beta, float* delta) {
  const int groups = s / group_size;
  for (int p = threadIdx.x; p < kRows * groups; p += kThreads) {
    const int r = p / groups;
    const int at = r * sk + (p - r * groups) * group_size;
    float sq_hi = 0.0f, sq_lo = 0.0f;
    for (int m = 0; m < group_size; ++m) {
      const float sq = __fmul_rn(zn[at + m], zn[at + m]);
      const float hi = bf16_round(sq);
      sq_hi = __fadd_rn(sq_hi, hi);
      if (TIER == kTierBf16x3)
        sq_lo = __fadd_rn(sq_lo, bf16_round(__fsub_rn(sq, hi)));
    }
    const float scale = group_scale<HARD>(__fadd_rn(sq_hi, sq_lo), t);
    const float hi = bf16_round(scale);
    const float slot_scale =
        TIER == kTierBf16x3 ? __fadd_rn(hi, bf16_round(__fsub_rn(scale, hi)))
                            : hi;
    for (int m = 0; m < group_size; ++m) {
      const float code = __fmul_rn(zn[at + m], slot_scale);
      if (delta != nullptr)
        *delta = __fadd_rn(*delta, fabsf(__fsub_rn(code, old[at + m])));
      zn[at + m] = momentum_at(fista, code, old[at + m], beta);
      old[at + m] = code;
    }
  }
}

// The group pass of the tier kernel: the rounded window sums of
// tier_group_prox, or group_prox's float32 sums (M a power of two, or
// bf16x5), for the variant and the hardness given at run time.
template <int TIER>
__device__ __forceinline__ void tier_group_pass(bool fista, bool hard,
                                                float* zn, float* old, int s,
                                                int sk, int group_size,
                                                float t, float beta,
                                                float* delta) {
  if (TIER == kTierBf16x5 || (group_size & (group_size - 1)) == 0) {
    if (fista)
      hard ? group_prox<true, true>(zn, old, s, sk, group_size, t, beta, delta)
           : group_prox<true, false>(zn, old, s, sk, group_size, t, beta,
                                     delta);
    else
      hard ? group_prox<false, true>(zn, old, s, sk, group_size, t, beta,
                                     delta)
           : group_prox<false, false>(zn, old, s, sk, group_size, t, beta,
                                      delta);
  } else if (hard) {
    tier_group_prox<true, TIER>(fista, zn, old, s, sk, group_size, t, beta,
                                delta);
  } else {
    tier_group_prox<false, TIER>(fista, zn, old, s, sk, group_size, t, beta,
                                 delta);
  }
}

// The epilogue of one column block, the build of the variant and shrink
// given: x = (z + acc) + eta c over the thread's fragment values, then
// (GROUP) the pre-prox value, or the shrink, the momentum and (STOP) the
// sum of |code - old| in delta.
template <bool FISTA, int MODE, bool GROUP, bool STOP, int TERMS>
__device__ __forceinline__ void tier_epilogue(
    const float (&acc)[kTierTiles][4], const float (&acc_lo)[kTierTiles][4],
    int col0, int s, int sk, const float* z, float* zn, float* old,
    const float* ec, float lam_eta, float beta, float& delta) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int n = 0; n < kTierTiles; ++n) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int r = (lane >> 2) + 8 * (c >> 1);
      const int j = col0 + n * 8 + 2 * (lane & 3) + (c & 1);
      if (j < s) {
        const int idx = r * sk + j;
        const float prod =
            TERMS == 1 ? acc[n][c] : __fadd_rn(acc[n][c], acc_lo[n][c]);
        const float x = __fadd_rn(__fadd_rn(z[idx], prod), ec[idx]);
        if (GROUP) {
          zn[idx] = x;  // pre-prox; the group pass finishes it
        } else {
          const float code = shrink<MODE>(x, lam_eta);
          if (STOP) delta = __fadd_rn(delta, fabsf(__fsub_rn(code, old[idx])));
          zn[idx] = momentum<FISTA>(code, old[idx], beta);
          old[idx] = code;
        }
      }
    }
  }
}

// tier_epilogue for the variant and shrink given at run time: one branch
// a column block, after the products, so the product loop is built once.
template <bool GROUP, bool STOP, int TERMS>
__device__ __forceinline__ void tier_epilogue_at(
    int fista, int mode, const float (&acc)[kTierTiles][4],
    const float (&acc_lo)[kTierTiles][4], int col0, int s, int sk,
    const float* z, float* zn, float* old, const float* ec, float lam_eta,
    float beta, float& delta) {
#define VTC_EPILOGUE(F, M)                                                  \
  tier_epilogue<F, M, GROUP, STOP, TERMS>(acc, acc_lo, col0, s, sk, z, zn, \
                                          old, ec, lam_eta, beta, delta)
  if (GROUP) {
    VTC_EPILOGUE(false, kSoft);  // the pre-prox value: no variant, no shrink
  } else if (fista) {
    switch (mode) {
      case kSoft: VTC_EPILOGUE(true, kSoft); break;
      case kSoftNonneg: VTC_EPILOGUE(true, kSoftNonneg); break;
      case kHard: VTC_EPILOGUE(true, kHard); break;
      default: VTC_EPILOGUE(true, kHardNonneg); break;
    }
  } else {
    switch (mode) {
      case kSoft: VTC_EPILOGUE(false, kSoft); break;
      case kSoftNonneg: VTC_EPILOGUE(false, kSoftNonneg); break;
      case kHard: VTC_EPILOGUE(false, kHard); break;
      default: VTC_EPILOGUE(false, kHardNonneg); break;
    }
  }
#undef VTC_EPILOGUE
}

// GROUP: the group prox of group_size slots (mode kSoft or kHard);
// otherwise shrink<mode>.  TIER: kTierBf16, kTierBf16x3 or kTierBf16x5.
// gn: fold_tier_kernel's planes.  STOP: one iteration, k0, of a solve whose
// state lives in state_global from launch to launch, as fista_kernel's.
// VARIANT -1 takes the variant (fista: FISTA or ISTA) and the shrink
// (mode) from the arguments: they act only in the epilogue and the group
// pass, so one build a (TIER, STOP) serves K1's eight.  VARIANT 4 fista +
// mode builds them in (K4, see launch_tier).
template <bool GROUP, int TIER, bool STOP, int VARIANT>
__global__ void __launch_bounds__(kThreads)
    fista_tier_kernel(const float* __restrict__ gn,
                      const float* __restrict__ corr,
                      const float* __restrict__ init,
                      const float* __restrict__ eta_ptr, float lam,
                      int num_iters, int b, int s, int sk, int sc,
                      int group_size, float* state_global,
                      float* __restrict__ out, SolveStop stop, int k0,
                      int fista_arg, int mode_arg) {
  constexpr int kTerms = tier_terms(TIER);
  const int fista = VARIANT < 0 ? fista_arg : VARIANT >> 2;
  const int mode = VARIANT < 0 ? mode_arg : VARIANT & 3;
  extern __shared__ __align__(16) float smem[];
  volatile int* const stop_flag = reinterpret_cast<int*>(stop.words + 1);
  const float* const t_saved = reinterpret_cast<float*>(stop.words + 2);
  if (STOP && k0 > 0 && *stop_flag != 0) return;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * kRows;
  const int plane = kRows * sk;
  const int nks = sk / 16;
  const int term_words = plane / 2;

  uint32_t* const zt = reinterpret_cast<uint32_t*>(smem);
  float* state =
      state_global != nullptr
          ? state_global + static_cast<int64_t>(blockIdx.x) * 4 * plane
          : smem + tier_terms_bytes(TIER, sk) / static_cast<int>(sizeof(float));
  float* const zbuf0 = state;
  float* const zbuf1 = state + plane;
  float* old = state + 2 * plane;
  float* ec = state + 3 * plane;
  const uint2* const planes = reinterpret_cast<const uint2*>(gn);
  const int64_t plane_pairs = static_cast<int64_t>(sk) * sc / 4;

  const float eta = *eta_ptr;
  const float lam_eta = lam * eta;

  for (int idx = tid; idx < plane && (!STOP || k0 == 0); idx += kThreads) {
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
  int cur = STOP ? k0 & 1 : 0;
  __syncthreads();
  if (num_iters > 0) split_rows<kTerms>(cur ? zbuf1 : zbuf0, sk, zt);

  const int ncb = sc / kColBlock;
  float t_k = STOP && k0 > 0 ? *t_saved : 1.0f;
  float delta = 0.0f;  // STOP: this thread's sum of |code - old|

  for (int it = 0; it < num_iters; ++it) {
    float beta;
    const float t_next = next_t_at(fista, t_k, &beta);
    const float* z = cur ? zbuf1 : zbuf0;
    float* zn = cur ? zbuf0 : zbuf1;
    __syncthreads();  // the z terms are complete

    for (int cb = 0; cb < ncb; ++cb) {
      float acc[kTierTiles][4], acc_lo[kTierTiles][4];
#pragma unroll
      for (int n = 0; n < kTierTiles; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[n][c] = acc_lo[n][c] = 0.0f;
      const int tile0 = (cb * kColBlock + warp * 32) / 8;

#pragma unroll 2
      for (int q = 0; q < nks; ++q) {
        uint4 a[kTerms];
#pragma unroll
        for (int p = 0; p < kTerms; ++p)
          a[p] = *reinterpret_cast<const uint4*>(zt + p * term_words +
                                                 (q * 32 + lane) * 4);
#pragma unroll
        for (int n = 0; n < kTierTiles; ++n) {
          const int64_t at = (static_cast<int64_t>(tile0 + n) * nks + q) * 32 +
                             lane;
          uint2 bt[kTerms];
#pragma unroll
          for (int p = 0; p < kTerms; ++p)
            bt[p] = __ldg(planes + p * plane_pairs + at);
          mma_bf16(acc[n], a[0], bt[0]);  // hi x hi
          if constexpr (kTerms >= 2) {
            mma_bf16(acc_lo[n], a[1], bt[0]);  // mid (bf16x3: lo) x hi
            mma_bf16(acc_lo[n], a[0], bt[1]);  // hi x mid (bf16x3: lo)
          }
          if constexpr (kTerms == 3) {
            mma_bf16(acc_lo[n], a[2], bt[0]);  // lo x hi
            mma_bf16(acc_lo[n], a[0], bt[2]);  // hi x lo
          }
        }
      }

      tier_epilogue_at<GROUP, STOP, kTerms>(
          fista, mode, acc, acc_lo, cb * kColBlock + warp * 32, s, sk, z, zn,
          old, ec, lam_eta, beta, delta);
    }
    __syncthreads();  // zn complete; every warp is past its product
    if (GROUP) {
      tier_group_pass<TIER>(fista, mode == kHard, zn, old, s, sk, group_size,
                            lam_eta, beta, STOP ? &delta : nullptr);
      __syncthreads();
    }
    if (it + 1 < num_iters) split_rows<kTerms>(zn, sk, zt);
    cur ^= 1;
    t_k = t_next;
  }

  if constexpr (STOP) {
    classic_stop_decide(delta, eta, t_k, stop, k0);
  } else {
    __syncthreads();
    for (int idx = tid; idx < plane; idx += kThreads) {
      const int r = idx / sk;
      const int j = idx - r * sk;
      const int64_t row = row0 + r;
      if (row < b && j < s) out[row * s + j] = old[idx];
    }
  }
}

// ---------------------------------------------------------------------------
// The resident layouts: fista_tier_cluster_kernel
// ---------------------------------------------------------------------------
// fista_cluster_kernel's and fista_wide_kernel's ideas on the tensor cores:
// one thread-block cluster of P CTAs per tile of `rows` batch rows (a
// multiple of 16), CTA q owning the columns [q w, (q+1) w), w = sk / P.
//  * Once per solve each CTA splits its (sk, w) slice of -eta G into the
//    tier's bf16 terms, in the B fragments' order, straight into shared
//    memory (the -eta multiply is fold_tier_kernel's, so the planes are
//    its bits); they stay there.  No fold launch, no gn round trip.
//  * Each CTA holds the z terms of all the cluster's rows twice (ping-pong)
//    in the A fragments' order, or once (bufs 1: a second cluster barrier
//    before the push, where two buffers would leave the batch two waves).  Warp (mt, u) owns the m16 tile mt and the
//    16 columns q w + 16 u .. +15 (two n8 tiles); each lane keeps its C
//    fragment's z, old and eta c (8 values) in registers.
//  * An iteration: the warp's two n8 tiles of every pass from the resident
//    terms, in fista_tier_kernel's order (hi x hi into acc over the depth,
//    then mid x hi, hi x mid, lo x hi, hi x lo into acc_lo, added at the
//    end); the epilogue, the prox and the momentum in registers; then the
//    next z split into its terms (split_bits) and written, one 16-byte
//    word of each term per lane, into the other z-term buffer of every CTA
//    of the cluster (st.shared::cluster).  A lane's C fragment of two
//    neighbouring n8 tiles is exactly its A fragment of one 16-deep step,
//    so no lane needs another's values.  One cluster barrier.
//  * The group prox for M in {1, 2, 4} in registers: a lane holds two
//    neighbouring columns, and M = 4 takes its neighbour lane's two with
//    __shfl_xor; the sum of squares is group_prox's fmaf chain over m.
//    Other M (tier_group_prox's rounded windows among them) stay on
//    fista_tier_kernel.
//  * STOP: fista_cluster_kernel's stop warp (stop_warp_loop) where the
//    grid is one resident wave, in one cooperative launch.
// Every output is fista_tier_kernel's: the same mma on the same fragments
// in the same order, the same epilogue, so the codes are bitwise its.
// Where s is a multiple of 16 (a lane's two columns are both live or both
// padding) and M is in {1, 2, 4}, tier_route picks it: the tier cluster
// route for batches that leave the classic grid at most half of the SMs
// (the trainers' b 250, the shards' b 125), the tier wide route above (the
// encodes' b 2048).  Both take tier_shape's layout: the cluster size, the
// rows a cluster and the z buffers from the card's cluster slots, so the
// batch takes the fewest waves.
// What bounds it at s 256 is latency, not the tensor cores: an iteration
// is a 16-deep chain of mma per pass (bf16x5's acc_lo chain is 64 deep),
// the push and the cluster barrier.
constexpr int kTierUnit = 16;       // columns a warp owns: two n8 tiles
constexpr int kTierMaxWarps = 16;   // compute warps a CTA
constexpr int kTierMaxThreads = 32 * (kTierMaxWarps + 1);  // and the stop's
constexpr int kTierMaxCluster = 8;  // the portable cluster size

// The layout of clusters of `cluster` CTAs at rows batch rows for a padded
// depth sk, with bufs (2 or 1) buffers of z terms: w columns a CTA, its
// compute warps and threads, and its dynamic shared memory (the tier's
// planes of the (sk, w) slice and the buffers of the rows' z terms, all
// bf16).
struct TierLayout {
  int w, warps, threads, smem;
};

__host__ __device__ inline TierLayout tier_layout(int tier, int sk,
                                                  int cluster, int rows,
                                                  int bufs = 2) {
  TierLayout lay;
  lay.w = sk / cluster;
  lay.warps = rows / kRows * (lay.w / kTierUnit);
  lay.threads = 32 * lay.warps;
  lay.smem = tier_terms(tier) * (sk * lay.w + bufs * rows * sk) *
             static_cast<int>(sizeof(uint16_t));
  return lay;
}

// The most rows (a multiple of kRows) such a cluster takes within the
// warps and shared memory a block has, or 0: where M is not in {1, 2, 4},
// the slices are not whole units of kTierUnit columns, or no m16 tile fits.
__host__ __device__ inline int tier_max_rows(int tier, int sk, int group_size,
                                             int cluster, int bufs = 2) {
  if (group_size < 1 || 4 % group_size != 0 || cluster < 1 ||
      sk % (kTierUnit * cluster) != 0)
    return 0;
  int most = 0;
  for (int rows = kRows;; rows += kRows) {
    const TierLayout lay = tier_layout(tier, sk, cluster, rows, bufs);
    if (lay.warps > kTierMaxWarps || lay.smem > kSmemPerBlock) return most;
    most = rows;
  }
}

// The resident shape for a batch of b: over clusters of 1, 2, 4 and 8
// CTAs (slots[i] of 1 << i resident at one CTA an SM) and two or one
// buffers of z terms, the fewest waves at each layout's most rows, then
// the least work a CTA (rows x w), then the fewer CTAs and two buffers;
// rows the batch spread evenly over the waves, in whole m16 tiles; cluster
// 0 where no layout fits.  (On an NVIDIA H100 80GB HBM3 at 700 W an
// iteration cost about 2 µs of latency plus about 1 µs per 1,024 outputs
// a CTA, tools/bench_fista_solve.py --tier: a wave saved outweighs any
// layout's work.)
struct TierShape {
  int cluster, rows, bufs, waves;
};

__host__ __device__ inline TierShape tier_shape(int b, int tier, int sk,
                                                int group_size,
                                                const int (&slots)[4]) {
  TierShape best{0, 0, 0, 0};
  int64_t best_work = 0;
  for (int i = 0; i < 4; ++i) {
    const int cluster = 1 << i;
    for (int bufs = 2; bufs >= 1; --bufs) {
      const int most = tier_max_rows(tier, sk, group_size, cluster, bufs);
      if (most < kRows || slots[i] < 1) continue;
      const int64_t per_wave = static_cast<int64_t>(slots[i]) * most;
      const int waves = static_cast<int>((b + per_wave - 1) / per_wave);
      const int64_t per_cluster = static_cast<int64_t>(slots[i]) * waves;
      const int spread = static_cast<int>((b + per_cluster - 1) /
                                          per_cluster);
      const int rows = (spread + kRows - 1) / kRows * kRows;
      const int64_t work = static_cast<int64_t>(rows) * (sk / cluster);
      if (best.cluster == 0 || waves < best.waves ||
          (waves == best.waves && work < best_work)) {
        best = TierShape{cluster, rows, bufs, waves};
        best_work = work;
      }
    }
  }
  return best;
}

// Whether some resident layout holds one m16 tile for s codes in groups of
// group_size: s whole units of kTierUnit columns, M in {1, 2, 4}, and a
// cluster of at most kTierMaxCluster CTAs whose planes leave room for one
// buffer of 16 rows' z terms.
__host__ __device__ inline bool tier_resident_fits(int tier, int s, int sk,
                                                   int group_size) {
  if (s % kTierUnit != 0) return false;
  for (int cluster = 1; cluster <= kTierMaxCluster; cluster *= 2)
    if (tier_max_rows(tier, sk, group_size, cluster, 1) >= kRows) return true;
  return false;
}

// The route of a solve at a tier (ops/fused_fista.tier_route mirrors it):
// where a resident layout fits, the tier cluster route where the classic
// grid would fill at most half of the SMs (the trainers and shards), the
// tier wide route above (the encodes), both on tier_shape's layout; else
// fista_tier_kernel.
inline int tier_route(int b, int s, int sk, int group_size, int tier,
                      int sm_count) {
  if (!tier_resident_fits(tier, s, sk, group_size)) return kRouteTier;
  const int tiles = (b + kRows - 1) / kRows;
  return 2 * tiles <= sm_count ? kRouteTierCluster : kRouteTierWide;
}

// Whether a resident launch of clusters of `cluster` CTAs at rows rows
// takes the stop warp: one resident wave (at most slots clusters) of at
// most 32 kStopLaneWords CTAs, with room for the stop's shared memory.
__host__ __device__ inline bool tier_stop_fits(int b, int tier, int sk,
                                               int cluster, int rows,
                                               int bufs, int slots) {
  if (cluster < 1 || rows < kRows || slots < 1) return false;
  const int clusters = (b + rows - 1) / rows;
  const TierLayout lay = tier_layout(tier, sk, cluster, rows, bufs);
  return clusters <= slots && clusters * cluster <= 32 * kStopLaneWords &&
         lay.smem + stop_smem(lay.threads) <= kSmemPerBlock;
}

// A tier solve's plan: the route, and on a resident route the cluster size,
// the rows a cluster, its buffers of z terms and the card's slots for
// clusters of that size.
struct TierPlan {
  int route, cluster, rows, bufs, slots;
};

// The plan on the current device for route (kRouteAuto or a forced tier
// route), with the stop or not, and across ranks or not (the classic stop
// route only).  A stop whose resident launch would not be one wave takes
// fista_tier_kernel under kRouteAuto and is refused when forced.  Returns
// the CUDA error of reading the slots, or cudaErrorInvalidValue for a
// forced route that does not fit.
inline cudaError_t device_tier_plan(int b, int s, int sk, int group_size,
                                    int tier, int route, bool stop,
                                    bool across_ranks, TierPlan* plan) {
  *plan = TierPlan{kRouteTier, 0, 0, 0, 0};
  if (across_ranks)
    return route == kRouteAuto || route == kRouteTier ? cudaSuccess
                                                      : cudaErrorInvalidValue;
  const bool forced = route != kRouteAuto;
  if (!forced) route = tier_route(b, s, sk, group_size, tier,
                                  device_sm_count());
  if (route == kRouteTier) return cudaSuccess;
  if (!tier_resident_fits(tier, s, sk, group_size))
    return cudaErrorInvalidValue;
  int slots[4];
  for (int i = 0; i < 4; ++i) {
    slots[i] = wide_slots(1 << i);
    if (slots[i] < 0) return static_cast<cudaError_t>(-slots[i]);
  }
  const TierShape shape = tier_shape(b, tier, sk, group_size, slots);
  if (shape.cluster == 0) return cudaErrorInvalidValue;
  const int cslots = slots[shape.cluster == 1   ? 0
                           : shape.cluster == 2 ? 1
                           : shape.cluster == 4 ? 2
                                                : 3];
  if (stop && !tier_stop_fits(b, tier, sk, shape.cluster, shape.rows,
                              shape.bufs, cslots))
    return forced ? cudaErrorInvalidValue : cudaSuccess;
  *plan = TierPlan{route, shape.cluster, shape.rows, shape.bufs, cslots};
  return cudaSuccess;
}

// v1 v0 as one word of two bf16 values: v0 in the low half (the A
// fragments' lower depth), as split_rows packs them.
template <int TERMS>
__device__ __forceinline__ void split_pair(float v0, float v1,
                                           uint32_t (&w)[TERMS]) {
  uint16_t lo[TERMS], hi[TERMS];
  split_bits<TERMS>(v0, lo);
  split_bits<TERMS>(v1, hi);
#pragma unroll
  for (int p = 0; p < TERMS; ++p)
    w[p] = static_cast<uint32_t>(lo[p]) | (static_cast<uint32_t>(hi[p]) << 16);
}

// Write the 16-byte word v at byte offset at of the same buffer in the
// first count CTAs of the cluster (bases from cluster_bases).
__device__ __forceinline__ void cluster_push_words(
    const unsigned (&bases)[kTierMaxCluster], unsigned at, const uint4& v,
    int count) {
#pragma unroll
  for (int q = 0; q < kTierMaxCluster; ++q)
    if (q < count)
      asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(
                       bases[q] + at),
                   "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
                   : "memory");
}

// The prox, the momentum and (STOP) the sum of |code - old| of a lane's
// two n8 tiles (t) of C fragment values (c: columns j0 + 8 t + (c & 1),
// rows + 8 (c >> 1)), x the pre-prox values; z and old are updated in
// place, padded columns (j >= s) held at +0.0f as fista_tier_kernel
// never writes them.  GROUP: the group prox of group_size in {1, 2, 4}
// slots (MODE kSoft or kHard), group_prox's fmaf chain over m (M = 4 takes
// the neighbour lane's two columns: the lane of even (lane & 3) holds a
// group's first two).
template <bool FISTA, int MODE, bool GROUP, bool STOP>
__device__ __forceinline__ void resident_prox(const float (&x)[2][4],
                                              float (&z)[2][4],
                                              float (&old)[2][4], int j0,
                                              int s, int group_size,
                                              float lam_eta, float beta,
                                              float& delta) {
  float code[2][4];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float p0 = x[t][2 * h], p1 = x[t][2 * h + 1];
      if (GROUP) {
        constexpr bool kHardGroup = MODE == kHard;
        // every lane shuffles, so the exchange is whole-warp at every M
        const float q0 = __shfl_xor_sync(0xffffffffu, p0, 1);
        const float q1 = __shfl_xor_sync(0xffffffffu, p1, 1);
        if (group_size == 4) {
          const bool first = (threadIdx.x & 1) == 0;
          float sq = fmaf(first ? p0 : q0, first ? p0 : q0, 0.0f);
          sq = fmaf(first ? p1 : q1, first ? p1 : q1, sq);
          sq = fmaf(first ? q0 : p0, first ? q0 : p0, sq);
          sq = fmaf(first ? q1 : p1, first ? q1 : p1, sq);
          const float scale = group_scale<kHardGroup>(sq, lam_eta);
          code[t][2 * h] = __fmul_rn(p0, scale);
          code[t][2 * h + 1] = __fmul_rn(p1, scale);
        } else if (group_size == 2) {
          const float scale = group_scale<kHardGroup>(
              fmaf(p1, p1, fmaf(p0, p0, 0.0f)), lam_eta);
          code[t][2 * h] = __fmul_rn(p0, scale);
          code[t][2 * h + 1] = __fmul_rn(p1, scale);
        } else {
          code[t][2 * h] = __fmul_rn(
              p0, group_scale<kHardGroup>(fmaf(p0, p0, 0.0f), lam_eta));
          code[t][2 * h + 1] = __fmul_rn(
              p1, group_scale<kHardGroup>(fmaf(p1, p1, 0.0f), lam_eta));
        }
      } else {
        code[t][2 * h] = shrink<MODE>(p0, lam_eta);
        code[t][2 * h + 1] = shrink<MODE>(p1, lam_eta);
      }
    }
  }
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (j0 + 8 * t + (c & 1) < s) {
        if (STOP)
          delta = __fadd_rn(delta, fabsf(__fsub_rn(code[t][c], old[t][c])));
        z[t][c] = momentum<FISTA>(code[t][c], old[t][c], beta);
        old[t][c] = code[t][c];
      } else {
        z[t][c] = 0.0f;
        old[t][c] = 0.0f;
      }
    }
  }
}

// resident_prox for the variant and shrink given at run time (K1's builds;
// K4's build them in, so the switch folds away).
template <bool GROUP, bool STOP>
__device__ __forceinline__ void resident_prox_at(
    int fista, int mode, const float (&x)[2][4], float (&z)[2][4],
    float (&old)[2][4], int j0, int s, int group_size, float lam_eta,
    float beta, float& delta) {
#define VTC_PROX(F, M)                                                     \
  resident_prox<F, M, GROUP, STOP>(x, z, old, j0, s, group_size, lam_eta, \
                                   beta, delta)
  if (GROUP) {
    if (fista)
      mode == kHard ? VTC_PROX(true, kHard) : VTC_PROX(true, kSoft);
    else
      mode == kHard ? VTC_PROX(false, kHard) : VTC_PROX(false, kSoft);
  } else if (fista) {
    switch (mode) {
      case kSoft: VTC_PROX(true, kSoft); break;
      case kSoftNonneg: VTC_PROX(true, kSoftNonneg); break;
      case kHard: VTC_PROX(true, kHard); break;
      default: VTC_PROX(true, kHardNonneg); break;
    }
  } else {
    switch (mode) {
      case kSoft: VTC_PROX(false, kSoft); break;
      case kSoftNonneg: VTC_PROX(false, kSoftNonneg); break;
      case kHard: VTC_PROX(false, kHard); break;
      default: VTC_PROX(false, kHardNonneg); break;
    }
  }
#undef VTC_PROX
}

// GROUP, TIER, VARIANT: fista_tier_kernel's.  One cluster of P CTAs (the
// launch's cluster size) per rows batch rows; the layout is tier_layout's
// with bufs buffers of z terms (1: a cluster barrier before the push, so
// no CTA writes the buffer another still reads).
// STOP: the early stop, with the stop warp after the compute warps (every
// CTA of the launch resident; tier_stop_fits).  The launch bound without
// the stop warp is 16 warps, four a partition of the SM's register file,
// so ptxas may give a thread 128 registers (with it 17 warps: 96).
template <bool GROUP, int TIER, bool STOP, int VARIANT>
__global__ void __launch_bounds__(STOP ? kTierMaxThreads
                                       : kTierMaxThreads - 32, 1)
    fista_tier_cluster_kernel(const float* __restrict__ gram,
                              const float* __restrict__ corr,
                              const float* __restrict__ init,
                              const float* __restrict__ eta_ptr, float lam,
                              int num_iters, int b, int s, int sk,
                              int group_size, int rows, int bufs,
                              float* __restrict__ out, SolveStop stop,
                              int fista_arg, int mode_arg) {
  constexpr int kTerms = tier_terms(TIER);
  const int fista = VARIANT < 0 ? fista_arg : VARIANT >> 2;
  const int mode = VARIANT < 0 ? mode_arg : VARIANT & 3;
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int size = static_cast<int>(cluster.num_blocks());
  const TierLayout lay = tier_layout(TIER, sk, size, rows, bufs);
  const int w = lay.w;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int units = w / kTierUnit;  // warps a m16 tile
  const int mt = warp / units;      // the warp's m16 tile
  const int un = warp - mt * units;  // and its unit of 16 columns
  const bool stop_warp = STOP && warp >= lay.warps;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / size) * rows;
  const int nks = sk / 16;
  const int r0 = mt * kRows + (lane >> 2);  // the lane's rows r0, r0 + 8
  const int j0 = rank * w + un * kTierUnit + 2 * (lane & 3);  // first column

  // the planes (kTerms x sk x w bf16), then bufs buffers of the rows' z
  // terms (kTerms x rows x sk bf16 each); STOP: the threads' sums by
  // parity and the decision past them (stop_smem)
  uint16_t* const planes = reinterpret_cast<uint16_t*>(smem);
  const int plane_elems = sk * w;
  uint32_t* const zt = reinterpret_cast<uint32_t*>(planes + kTerms *
                                                              plane_elems);
  const int term_words = rows * sk / 2;  // one term of one buffer
  const int buf_words = kTerms * term_words;
  const int nt = lay.threads;
  float* const deltas = smem + lay.smem / static_cast<int>(sizeof(float));
  volatile int* const stop_word = reinterpret_cast<int*>(deltas + 2 * nt);

  const float eta = *eta_ptr;
  const float lam_eta = lam * eta;
  const float neg_eta = -eta;
  // the slice's planes, fold_tier_kernel's value at each (k, n): gram read
  // along n, each value stored at its B-fragment place
  for (int e = tid; e < plane_elems; e += blockDim.x) {
    const int k = e / w;
    const int nl = e - k * w;
    const int n = rank * w + nl;
    const float v = (k < s && n < s)
                        ? neg_eta * gram[static_cast<int64_t>(k) * s + n]
                        : 0.0f;
    const int kk = k & 15;
    const int l = ((kk & 7) >> 1) | ((nl & 7) << 2);
    const int idx = (kk & 1) | ((kk >> 3) << 1) | (l << 2) |
                    (((nl >> 3) * nks + (k >> 4)) << 7);
    uint16_t terms[kTerms];
    split_bits<kTerms>(v, terms);
#pragma unroll
    for (int p = 0; p < kTerms; ++p) planes[p * plane_elems + idx] = terms[p];
  }
  // the rows' z terms (the start), split_rows' words in buffer 0
  for (int wd = tid; wd < term_words; wd += blockDim.x) {
    const int r = wd & 3;
    const int l = (wd >> 2) & 31;
    const int tile = wd >> 7;  // m16 tile mt' and step q: mt' nks + q
    const int row = (tile / nks) * kRows + (l >> 2) + 8 * (r & 1);
    const int k = 16 * (tile % nks) + 2 * (l & 3) + 8 * (r >> 1);
    const int64_t grow = row0 + row;
    float v0 = 0.0f, v1 = 0.0f;
    if (init != nullptr && grow < b) {
      if (k < s) v0 = init[grow * s + k];
      if (k + 1 < s) v1 = init[grow * s + k + 1];
    }
    uint32_t words[kTerms];
    split_pair<kTerms>(v0, v1, words);
#pragma unroll
    for (int p = 0; p < kTerms; ++p) zt[p * term_words + wd] = words[p];
  }
  // the lane's z, old and eta c
  float z[2][4], old[2][4], ec[2][4];
#pragma unroll
  for (int t = 0; t < 2; ++t) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t row = row0 + r0 + 8 * (c >> 1);
      const int j = j0 + 8 * t + (c & 1);
      const bool live = !stop_warp && row < b && j < s;
      const int64_t at = row * s + j;
      z[t][c] = (live && init != nullptr) ? init[at] : 0.0f;
      old[t][c] = z[t][c];
      ec[t][c] = live ? eta * corr[at] : 0.0f;
    }
  }
  if (STOP && tid == 0) *stop_word = 0;  // no decision yet
  unsigned bases[kTierMaxCluster];  // the z-term buffers in every CTA
  cluster_bases(reinterpret_cast<const float*>(zt), bases, size);
  // every CTA of the cluster has its planes and start before any writes
  // into another's shared memory
  cluster.sync();
  if (STOP && stop_warp) {
    stop_warp_loop(num_iters, deltas, nt, eta, stop, stop_word, bufs == 1);
    return;
  }

  const uint2* const bplanes = reinterpret_cast<const uint2*>(planes);
  const int plane_pairs = plane_elems / 4;
  float t_k = 1.0f;
  int it = 0;
  for (; it < num_iters; ++it) {
    float beta;
    const float t_next = next_t_at(fista, t_k, &beta);
    const uint32_t* const za = zt + (bufs == 2 ? it & 1 : 0) * buf_words;
    float acc[2][4], acc_lo[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[t][c] = acc_lo[t][c] = 0.0f;
#pragma unroll 2
    for (int q = 0; q < nks; ++q) {
      uint4 a[kTerms];
#pragma unroll
      for (int p = 0; p < kTerms; ++p)
        a[p] = *reinterpret_cast<const uint4*>(
            za + p * term_words + ((mt * nks + q) * 32 + lane) * 4);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int at = ((2 * un + t) * nks + q) * 32 + lane;
        uint2 bt[kTerms];
#pragma unroll
        for (int p = 0; p < kTerms; ++p) bt[p] = bplanes[p * plane_pairs + at];
        mma_bf16(acc[t], a[0], bt[0]);  // hi x hi
        if constexpr (kTerms >= 2) {
          mma_bf16(acc_lo[t], a[1], bt[0]);  // mid (bf16x3: lo) x hi
          mma_bf16(acc_lo[t], a[0], bt[1]);  // hi x mid (bf16x3: lo)
        }
        if constexpr (kTerms == 3) {
          mma_bf16(acc_lo[t], a[2], bt[0]);  // lo x hi
          mma_bf16(acc_lo[t], a[0], bt[2]);  // hi x lo
        }
      }
    }
    // STOP: the decision on iteration it - 1 (old still holds its codes);
    // every CTA of the launch breaks at the same it
    if (STOP && it >= 2 && stop_decided(stop_word, it)) break;
    float x[2][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float prod = kTerms == 1 ? acc[t][c]
                                       : __fadd_rn(acc[t][c], acc_lo[t][c]);
        x[t][c] = __fadd_rn(__fadd_rn(z[t][c], prod), ec[t][c]);
      }
    float delta = 0.0f;
    resident_prox_at<GROUP, STOP>(fista, mode, x, z, old, j0, s, group_size,
                                  lam_eta, beta, delta);
    // the next z's terms: registers (t, h) of step rank w / 16 + un, as
    // one 16-byte word a term, into every CTA's other buffer
    uint32_t w00[kTerms], w01[kTerms], w10[kTerms], w11[kTerms];
    split_pair<kTerms>(z[0][0], z[0][1], w00);
    split_pair<kTerms>(z[0][2], z[0][3], w01);
    split_pair<kTerms>(z[1][0], z[1][1], w10);
    split_pair<kTerms>(z[1][2], z[1][3], w11);
    const int q_own = rank * units + un;
    const unsigned word0 =
        static_cast<unsigned>((bufs == 2 ? (it + 1) & 1 : 0) * buf_words +
                              ((mt * nks + q_own) * 32 + lane) * 4);
    if (bufs == 1) cluster.sync();  // every CTA has read this z
#pragma unroll
    for (int p = 0; p < kTerms; ++p)
      cluster_push_words(bases, (word0 + p * term_words) * 4u,
                         make_uint4(w00[p], w01[p], w10[p], w11[p]), size);
    if (STOP && stop_turn(it, num_iters)) {  // the sum, to the stop warp
      deltas[(it & 1) * nt + tid] = delta;
      named_arrive(nt + 32);
    }
    // every CTA has read this iteration's z terms and written the next
    // everywhere; the last barrier is the last remote write any CTA sees
    // (with one buffer the barrier before the push, in the stop warp's
    // loop too: stop_warp_loop's pre_barrier)
    cluster.sync();
    t_k = t_next;
  }

#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int64_t row = row0 + r0 + 8 * (c >> 1);
      const int j = j0 + 8 * t + (c & 1);
      if (row < b && j < s) out[row * s + j] = old[t][c];
    }
  if (STOP && blockIdx.x == 0 && tid == 0) *stop.iters = it;
}

// Launch the resident kernel in clusters of `cluster` CTAs at rows rows a
// cluster with bufs buffers of z terms; with stop its stop build,
// cooperatively (the caller checked tier_stop_fits).
template <bool GROUP, int TIER, int VARIANT>
cudaError_t launch_tier_resident(int fista, int mode, const float* gram,
                                 const float* corr, const float* init,
                                 const float* eta, float lam, int num_iters,
                                 int b, int s, int sk, int group_size,
                                 int cluster, int rows, int bufs, float* out,
                                 cudaStream_t stream, const SolveStop* stop) {
  if (s % kTierUnit != 0 || rows < kRows || rows % kRows != 0 ||
      (bufs != 1 && bufs != 2) ||
      rows > tier_max_rows(TIER, sk, group_size, cluster, bufs))
    return cudaErrorInvalidValue;
  const TierLayout lay = tier_layout(TIER, sk, cluster, rows, bufs);
  const unsigned grid = static_cast<unsigned>((b + rows - 1) / rows *
                                              cluster);
  if (stop == nullptr)
    return launch_clusters(
        fista_tier_cluster_kernel<GROUP, TIER, false, VARIANT>, cluster, grid,
        lay.threads, lay.smem, stream, gram, corr, init, eta, lam, num_iters,
        b, s, sk, group_size, rows, bufs, out, SolveStop{}, fista, mode);
  return launch_clusters_as(
      true, fista_tier_cluster_kernel<GROUP, TIER, true, VARIANT>, cluster,
      grid, lay.threads + 32, lay.smem + stop_smem(lay.threads), stream, gram,
      corr, init, eta, lam, num_iters, b, s, sk, group_size, rows, bufs, out,
      *stop, fista, mode);
}

// Run the solve on the tier route given (kRouteAuto: the plan's): the
// resident kernel in one launch, or fold -eta G into the tier's planes in
// gn and run fista_tier_kernel in one launch, or with stop on the classic
// stop route, an iteration a launch (state_global required there).
template <bool GROUP, int TIER, int VARIANT>
cudaError_t launch_tier_at(int fista, int mode, const float* gram,
                           const float* corr, const float* init,
                           const float* eta, float lam, int num_iters, int b,
                           int s, int sk, int sc, int group_size, float* gn,
                           float* state_global, float* out, int route,
                           int* taken, cudaStream_t stream,
                           const SolveStop* stop) {
  if (sk % 16 != 0 || sc % kColBlock != 0) return cudaErrorInvalidValue;
  TierPlan plan;
  cudaError_t err = device_tier_plan(
      b, s, sk, group_size, TIER, route, stop != nullptr,
      stop != nullptr && stop->local != nullptr, &plan);
  if (err != cudaSuccess) return err;
  if (taken != nullptr) *taken = plan.route;
  if (plan.route != kRouteTier)
    return launch_tier_resident<GROUP, TIER, VARIANT>(
        fista, mode, gram, corr, init, eta, lam, num_iters, b, s, sk,
        group_size, plan.cluster, plan.rows, plan.bufs, out, stream, stop);
  const int64_t total = static_cast<int64_t>(sk) * sc;
  const unsigned fold_grid =
      static_cast<unsigned>(total / 256 + 1 < 1024 ? total / 256 + 1 : 1024);
  fold_tier_kernel<tier_terms(TIER)><<<fold_grid, 256, 0, stream>>>(
      gram, eta, reinterpret_cast<uint16_t*>(gn), s, sk, sc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  auto plain = fista_tier_kernel<GROUP, TIER, false, VARIANT>;
  const unsigned grid = static_cast<unsigned>((b + kRows - 1) / kRows);
  if (stop != nullptr) {
    auto stopping = fista_tier_kernel<GROUP, TIER, true, VARIANT>;
    const size_t smem = tier_smem(TIER, sk, false);
    err = set_pair_smem(plain, stopping, smem);
    if (err != cudaSuccess) return err;
    return drive_classic_stop(
        [&](bool with_stop, int iters, const SolveStop& st, int k0) {
          (with_stop ? stopping : plain)<<<grid, kThreads, smem, stream>>>(
              gn, corr, init, eta, lam, iters, b, s, sk, sc, group_size,
              state_global, out, st, k0, fista, mode);
          return cudaGetLastError();
        },
        eta, num_iters, b, s, sk, state_global, out, *stop, stream);
  }
  const int smem = tier_smem(TIER, sk, state_global == nullptr);
  if (smem > kSmemPerBlock) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(plain,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  plain<<<grid, kThreads, smem, stream>>>(gn, corr, init, eta, lam, num_iters,
                                          b, s, sk, sc, group_size,
                                          state_global, out, SolveStop{}, 0,
                                          fista, mode);
  return cudaGetLastError();
}

template <bool GROUP, int VARIANT>
cudaError_t launch_tier_variant(int tier, int fista, int mode,
                                const float* gram, const float* corr,
                                const float* init, const float* eta,
                                float lam, int num_iters, int b, int s,
                                int sk, int sc, int group_size, float* gn,
                                float* state_global, float* out, int route,
                                int* taken, cudaStream_t stream,
                                const SolveStop* stop) {
#define VTC_TIER(T)                                                         \
  launch_tier_at<GROUP, T, VARIANT>(fista, mode, gram, corr, init, eta,    \
                                    lam, num_iters, b, s, sk, sc,          \
                                    group_size, gn, state_global, out,     \
                                    route, taken, stream, stop)
  switch (tier) {
    case kTierBf16: return VTC_TIER(kTierBf16);
    case kTierBf16x3: return VTC_TIER(kTierBf16x3);
    case kTierBf16x5: return VTC_TIER(kTierBf16x5);
    default: return cudaErrorInvalidValue;
  }
#undef VTC_TIER
}

// K1 passes its variant and shrink at run time: 6 builds (3 tiers, with
// and without the stop), whose ptxas registers stay within those of the
// 48 builds with them as templates (56-106, no spills).  K4 builds its
// four (FISTA or ISTA, soft or hard) in: at run time ptxas gave its group
// pass 128 registers (bf16x5 with the stop) and 4-byte spills (bf16x3),
// and its bf16x3 solve took 1.9x as long on an H100
// (tools/compare_tier_builds.py compares two such builds).
template <bool GROUP>
cudaError_t launch_tier(int tier, int fista, int mode, const float* gram,
                        const float* corr, const float* init,
                        const float* eta, float lam, int num_iters, int b,
                        int s, int sk, int sc, int group_size, float* gn,
                        float* state_global, float* out, int route,
                        int* taken, cudaStream_t stream,
                        const SolveStop* stop) {
#define VTC_VARIANT(V)                                                       \
  launch_tier_variant<GROUP, V>(tier, fista, mode, gram, corr, init, eta,   \
                                lam, num_iters, b, s, sk, sc, group_size,   \
                                gn, state_global, out, route, taken, stream, \
                                stop)
  if constexpr (!GROUP) {
    return VTC_VARIANT(-1);
  } else {
    const bool hard = mode == kHard;
    if (fista) return hard ? VTC_VARIANT(4 + kHard) : VTC_VARIANT(4 + kSoft);
    return hard ? VTC_VARIANT(kHard) : VTC_VARIANT(kSoft);
  }
#undef VTC_VARIANT
}

}  // namespace
