// The persistent residual-form FISTA solve under K19 at a code axis of 1,
// CUDA C++ for Hopper (sm_90a).
//
// Replaces, as one launch a train step, the per-iteration kernels that
// fused_code_shard_train_step.cu's C loop enqueues for the solve of the
// TPU kernel K19 (vtc_tpu/ops/pallas_code_shard_train.py: the kernel
// _make_cs_kernel :233, its FISTA body fista_body :370, under
// fused_code_sharded_train_segment_pallas :484).  The TPU kernel keeps the
// dictionary shard resident in VMEM for every iteration; the Hopper
// counterpart is one resident CTA per SM (a cooperative launch, so the card
// runs every CTA at once or refuses the launch), each holding its two
// slices of D in shared memory for the whole solve, with a grid-wide
// barrier (grid_sync.cuh) between dependent phases.
//
// Phases of one step, a grid barrier after each (cs_step_barriers):
//
//   1  prologue: z = old = 0 over the CTA's phase-B tiles; the resident D
//      slices' copies put in flight
//   per iteration:
//   A  the reconstruction's partials: for each kSplitK chunk c of the s
//      atoms, partial[c] = z[:, chunk c] D[chunk c, :], one fmaf chain per
//      output over the chunk's k in order
//   S  r = (the partials added in chunk order) - X, the per-step route's
//      split_sum, spread over every thread of the grid
//   B  u = z - eta (r D^T), one fmaf chain over k = 0 .. n-1, then the
//      prox and the momentum (grad_prox_kernel's epilogue); with a member
//      table, pre = u
//   G  with a member table only: the group prox over (row, group) pairs in
//      member order (group_prox_kernel's pass)
//   and, with upd_num_iters >= 1, the update's first residual codes D - X
//   as phases A and S with old in place of z, into r (no barrier after S:
//   the launch ends).  Later update iterations need the updated D, so the
//   C loop launches their residuals per step as before.
//
// Layout (ROADMAP's "memory shape" rule: a persistent cooperative kernel a
// step, the D slices resident).  An output tile is 32 batch rows by 64
// columns, 128 threads of 4 x 4 outputs: at b 128, s 2048, n 256 phase A
// has 8 chunks x 4 x 4 tiles and phase B 4 x 32, so each of 128 CTAs holds
// one tile of each and keeps both D slices resident (2 x 64 KB), beside a
// 32 KB staging buffer for its rows of z, old or r, which other CTAs write
// and so come through L2 each phase (copied in 32-deep k slices with
// cp.async, every slice in flight before the first computes).  A CTA
// with one phase-B tile and no member table holds its entries of z and
// old in registers for the whole solve (else it loads them under phase
// B's product).  Operands sit [row][k] in shared memory (4 floats of
// padding), so a thread reads a float4 of k for each of its rows and
// columns: 8 conflict-free 16-byte reads carry 64 FMAs.  A thread's rows are 4 apart and its columns 8
// apart (lanes along columns), so a window of up to 8 columns is one row
// of neighbouring lanes and the in-warp group norm is the per-step
// kernel's xor butterfly (lanes first, then the thread's own columns for
// windows of 16 and 32).  Where a phase's tiles outnumber the CTAs (a
// ragged or large shape, a forced small grid) or n > kCsDepth, a CTA walks
// several tiles and copies their D slices from L2 as it goes (a slice
// already in its buffer is not copied again); the bits are the same.
// Out-of-range rows, columns and k values copy as zeros and are never
// stored or summed.
//
// Same bits.  Every output is the fmaf chain, in the same k order, of the
// per-step kernels (train_core.cuh's gemm_tile), with their epilogue
// expressions and the momentum coefficients the C loop computes on the
// host (betas): so the codes, D, h, v and eta equal the per-step route's
// bit for bit.  No split of k beyond kSplitK's chunks, no reordered sum, no
// TF32.
//
// The bound at b 128, s 2048, n 256, FISTA 25: a product is 2 b s n = 134
// MFLOP, 2.0 us at the fp32 SIMT peak of 67 TFLOP/s; a step is 6.99 GFLOP,
// 0.1043 ms.  What bounds this kernel (tools/bench_code_shard_solve.py):
// a tile's FMAs read 8 floats a k for 16 FMAs a thread, and the SM's
// shared-memory pipe delivers 32 a cycle, so a phase's FMAs take twice
// their time at the FMA peak (5.5 us a 32 x 64 x 256 tile); then three
// grid barriers an iteration (about 1 us each) and the operands' L2
// latency.  The split sum is its own phase: summed by the last of a
// tile's eight CTAs instead (an atomic ticket a tile, no barrier), 16
// CTAs read 64 KB each and phase A took 26 us against 6.
//
// The early stop (a compile-time STOP build; off, the code above; vtc_tpu
// pallas_code_shard_train.py:387-431).  After iteration j the solve ends
// when (sum |codes_j - codes_{j-1}| * inv_count) / eta < eps and j > 0,
// and old holds codes_j.  In an iteration that can stop (j from 1 to the
// last but one), each thread adds |code - old| of its phase-B entries, or
// with a member table of its phase-G pairs' entries, in a fixed order;
// the CTA sums its threads (each warp's xor butterfly, then the warps in
// order) and thread 0 writes the CTA's share to its slot just before it
// arrives at the grid barrier that already ends the phase.  After that
// barrier every warp of every CTA puts the loads of the grid's slots in
// flight and goes on with the next iteration's phase A, which writes only
// the partials; after phase A's barrier it sums them in CTA order (lane l
// the slots l, l + 32, ..., then the butterfly) and takes the same
// decision from the same bits: no extra barrier, no float atomics, the
// loads' L2 latency under phase A.  Two slot sets alternate with the
// parity of j, so no CTA overwrites a share another may still read.  On a
// stop every CTA leaves the loop after that same barrier, one phase A
// computed in vain: old holds codes_j in global memory (a CTA that holds
// its z and old in registers stores both every iteration), and the
// update's first residual runs on it.  A STOP launch has at most 256
// CTAs (eight slots a lane).  A stopped step passes fewer barriers than
// cs_step_barriers counts, so the STOP build carries the barrier's base
// on the device: a launch reads it from barrier[1] before its first
// barrier, and CTA 0 writes the count it ended at there after its last,
// which every CTA has passed; the host's barrier_base is not read.  CTA 0
// writes the count of iterations to iters.  The stop costs 0.74 us an
// iteration that tests (b 128, s 2048, n 256; NVIDIA H100 80GB HBM3, 700
// W; chip_smoke.py phase 45), against 1.25 when every CTA summed the
// slots right after the barrier.
//
// The tiers (vtc_tpu _make_tier_dots, pallas_code_shard_train.py:88-117,
// used at :372-373).  At bf16x5, bf16x3 and bf16 the two products of an
// iteration, the reconstruction's partials z D (phase A) and the gradient
// r D^T (phase B), take both operands split into bf16 terms (bf16_terms.cuh)
// and the tier's single-pass products: bf16, a b; bf16x3, a_hi b_hi + a_lo
// b_hi + a_hi b_lo; bf16x5, a1 b1 + a2 b1 + a1 b2 + a3 b1 + a1 b3.  The
// split sum, the prox, the momentum, the stop and the update's first
// residual stay float32, and so do the per-step launches of the Gram, the
// power refresh and the update.  The tier is a template parameter of the
// kernel (a run-time tier made ptxas spill the fc solve's tier kernel,
// fista_tier.cuh), so 'highest' is the float32 code above, unchanged.  The
// tier tile (cs_tier_block, cs_tier_step):
//  * The same tiles, phases, barriers and grid as 'highest': each of the
//    CTA's 4 warps owns a 16 x 32 part of the 32 x 64 output tile (four
//    m16n8 tiles) and issues mma.sync m16n8k16 bf16 with float32
//    accumulation; each 16-deep step's hi x hi pass from zero, added to its
//    accumulator round-to-nearest, the smaller passes in a second one, the
//    two added at the end (ops/precision.ns_dot's sum).  A phase-A tile is
//    one kSplitK chunk's product from zero, and phase S adds the chunks in
//    order, so the plain version takes the tier product chunk by chunk
//    (precision.split_k_dot).
//  * D is constant for the whole solve, so it is split once a step: the
//    prologue splits the CTA's two resident slices into bf16 planes in
//    shared memory, TERMS planes a slice (32 KB each; kCsRowWords words a
//    row, XOR-swizzled so that the B fragments' reads are conflict-free),
//    where the float32 build copies them.  z and r change every iteration
//    and arrive as the float32 build's staging (a[32][kCsLd], cp.async),
//    each element split as the A fragments are built from it.
//  * Shared memory: the staging (33,280 B) and two slices' planes: 64 KB
//    at bf16, 128 KB at bf16x3, 192 KB at bf16x5, so 99,840 / 164,352 /
//    229,888 B of the 232,448 a CTA may opt into; one CTA an SM at every
//    tier, so the grid is 'highest''s.  The update's first residual stays a
//    float32 phase A, whose D slice (da, 66,560 B) reuses the planes' space
//    once the solve is done.
//  * z and old are read and written in global memory every iteration (no
//    entries held in registers); the in-warp window sum follows the mma
//    fragments' layout (cs_tier_b_tile).
//  * The member-table prox rounds as vtc_tpu's membership products do where
//    SolveArgs::prox_round (CsMemberSum); vtc_tpu's rotate window stays
//    float32 (the in-warp window, or a table wider than 32 exactly).
//  * The per-step route's tier kernels (fused_code_shard_train_step.cu) run
//    the same tile functions on a tile a CTA, so the routes give the same
//    bits at every tier, as at 'highest'.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "bf16_terms.cuh"  // the tiers' bf16 terms and mma.sync product
#include "grid_sync.cuh"   // the grid barrier and the cp.async helpers

namespace {

constexpr int kSplitK = 256;         // K values per split of a long-K product
constexpr int kCsTileM = 32;         // output tile rows (batch rows)
constexpr int kCsTileN = 64;         // output tile columns
constexpr int kCsDepth = 256;        // k values a tile's operands hold at once
constexpr int kCsSlice = 32;         // k values per copy group
constexpr int kCsThreads = 128;      // 4 x 4 outputs each
constexpr int kCsLd = kCsDepth + 4;  // a shared row of k values, padded

static_assert(kCsDepth == kSplitK, "a phase-A tile is one chunk deep");
static_assert(kCsThreads * 16 == kCsTileM * kCsTileN,
              "a thread holds four rows by four columns");
static_assert(kCsDepth % kCsSlice == 0 && kCsDepth / kCsSlice <= 8,
              "at most eight copy groups in flight");

enum Shrink { kSoft = 0, kSoftNonneg = 1, kHard = 2, kHardNonneg = 3 };

template <int MODE>
__device__ __forceinline__ float threshold(float x, float t) {
  if (MODE == kSoft) return x - fminf(fmaxf(x, -t), t);
  if (MODE == kSoftNonneg) return fmaxf(x - t, 0.0f);
  if (MODE == kHard) return fabsf(x) < t ? 0.0f : x;
  return x < t ? 0.0f : x;
}

// The group scale of a group of norm |g| at threshold t.
template <int MODE>
__device__ __forceinline__ float group_scale(float norm, float t) {
  if (MODE == kHard) return norm < t ? 0.0f : 1.0f;
  return norm > 0.0f ? fmaxf(__fsub_rn(1.0f, t / norm), 0.0f) : 0.0f;
}

// The FISTA / ISTA momentum: the next z from the codes and their previous
// value prev, code + beta (code - prev), or code.
__device__ __forceinline__ float momentum_z(float code, float prev,
                                            float beta, int fista) {
  return fista ? __fadd_rn(code, __fmul_rn(beta, __fsub_rn(code, prev)))
               : code;
}

// z[at] = the next z, old[at] = code, old read past the L1 (another CTA
// may have written it in this launch); returns |code - old|, the entry's
// part of the early stop's sum.
__device__ __forceinline__ float momentum_at(float* z, float* old,
                                             int64_t at, float code,
                                             float beta, int fista) {
  const float prev = __ldcg(old + at);
  z[at] = momentum_z(code, prev, beta, fista);
  old[at] = code;
  return fabsf(__fsub_rn(code, prev));
}

__host__ __device__ inline int cs_cdiv(int a, int b) { return (a + b - 1) / b; }

// Tiles of phase A (the reconstruction's partials: kSplitK chunks of s by
// (b, n) output tiles, cs_out_tiles) and of phase B ((b, s) output
// tiles).
__host__ __device__ inline int cs_out_tiles(int b, int n) {
  return cs_cdiv(b, kCsTileM) * cs_cdiv(n, kCsTileN);
}
__host__ __device__ inline int cs_tiles_a(int b, int s, int n) {
  return cs_cdiv(s, kSplitK) * cs_out_tiles(b, n);
}
__host__ __device__ inline int cs_tiles_b(int b, int s) {
  return cs_cdiv(b, kCsTileM) * cs_cdiv(s, kCsTileN);
}

// Grid barriers in one step: the prologue's, three an iteration (A, S, B;
// four with a member table) and the residual's A.
// ops/fused_code_shard_train.solve_barriers mirrors it.
__host__ __device__ inline int cs_step_barriers(int num_iters, int members,
                                                int resid) {
  return 1 + num_iters * (members ? 4 : 3) + (resid ? 1 : 0);
}

// CTAs of a launch: every CTA the card holds at once, but no more than the
// larger phase has tiles.  ops/fused_code_shard_train.solve_plan mirrors
// it.
inline int cs_grid(int b, int s, int n, int sm_count, int blocks_per_sm) {
  const int slots = sm_count * blocks_per_sm;
  const int ta = cs_tiles_a(b, s, n), tb = cs_tiles_b(b, s);
  const int tiles = ta > tb ? ta : tb;
  return slots < tiles ? slots : tiles;
}

struct SolveArgs {
  const float* x;        // (b, n) this step's batch
  const float* d;        // (s, n)
  float* z;              // (b, s) the iterate
  float* old;            // (b, s) the codes; the step's codes at the end
  float* pre;            // (b, s) the pre-prox values (member table only)
  float* partial;        // (ceil(s / kSplitK), b, n) phase A's partials
  float* r;              // (b, n) z D - X; at the end codes D - X
  const float* eta;      // (1,) the stepsize
  const float* betas;    // (num_iters,) the momentum of each iteration
  const int* members;    // (groups, width) or null
  unsigned* barrier;     // (2,) the grid barrier's arrivals, and with STOP
                         // its count at launch (carried on the device)
  unsigned barrier_base; // *barrier at launch (without STOP)
  float lam;
  int fista, mode, window, groups, width;
  int b, s, n, num_iters, resid;
  int prox_round;        // a tier build: the member-table prox rounds its
                         // sums and scale at the tier (cs_member_sum)
  // STOP: the stop test's eps and 1 / count, the CTAs' shares (2, grid)
  // by parity, and iters (1,), which receives the step's count
  float eps, inv_count;
  float* slots;
  int* iters;
};

// The dynamic shared memory of a CTA.
struct SolveSmem {
  float a[kCsTileM][kCsLd];   // rows of z, old or r: a[row][k]
  float da[kCsTileN][kCsLd];  // phase A's D: da[j][k] = D[c0 + k, j0 + j]
  float db[kCsTileN][kCsLd];  // phase B's D: db[j][k] = D[j0 + j, k0 + k]
};

// wait until at most n (0 .. 7) of this thread's copy groups are in flight
__device__ __forceinline__ void cs_wait(int n) {
  switch (n) {
    case 0: seg_cp_async_wait<0>(); break;
    case 1: seg_cp_async_wait<1>(); break;
    case 2: seg_cp_async_wait<2>(); break;
    case 3: seg_cp_async_wait<3>(); break;
    case 4: seg_cp_async_wait<4>(); break;
    case 5: seg_cp_async_wait<5>(); break;
    case 6: seg_cp_async_wait<6>(); break;
    default: seg_cp_async_wait<7>(); break;
  }
}

// The tile row of a thread's r-th output row and the tile column of its
// c-th output column: warp w covers rows 16 (w / 2) .. + 15 and columns
// 32 (w % 2) .. + 31; lane l rows l / 8 + 4 r, columns l % 8 + 8 c.
__device__ __forceinline__ int cs_row(int r) {
  return (threadIdx.x >> 6) * 16 + ((threadIdx.x & 31) >> 3) + 4 * r;
}
__device__ __forceinline__ int cs_col(int c) {
  return ((threadIdx.x >> 5) & 1) * 32 + (threadIdx.x & 7) + 8 * c;
}

// Copy slice st (k values kb + 32 st ..) of ROWS rows of src (rows r0..,
// row length ld, `rows` rows in all, k < k_end) into dst[row][32 st ..]:
// float4s along k where vec, else floats; a warp's reads are contiguous.
template <int ROWS>
__device__ __forceinline__ void cs_load_rows(float (*dst)[kCsLd],
                                             const float* src, int ld,
                                             int rows, int r0, int kb, int st,
                                             int k_end, bool vec) {
  const int ks = st * kCsSlice;
  if (vec) {
#pragma unroll
    for (int q = 0; q < ROWS * kCsSlice / 4 / kCsThreads; ++q) {
      const int idx = threadIdx.x + q * kCsThreads;
      const int row = idx / (kCsSlice / 4);
      const int kk = ks + 4 * (idx % (kCsSlice / 4));
      const int i = r0 + row, k = kb + kk;
      const bool ok = i < rows && k < k_end;
      seg_cp_async16(&dst[row][kk],
                     ok ? src + static_cast<int64_t>(i) * ld + k : src, ok);
    }
  } else {
#pragma unroll 4
    for (int q = 0; q < ROWS * kCsSlice / kCsThreads; ++q) {
      const int idx = threadIdx.x + q * kCsThreads;
      const int row = idx / kCsSlice;
      const int kk = ks + idx % kCsSlice;
      const int i = r0 + row, k = kb + kk;
      const bool ok = i < rows && k < k_end;
      seg_cp_async4(&dst[row][kk],
                    ok ? src + static_cast<int64_t>(i) * ld + k : src, ok);
    }
  }
}

// Copy slice st of phase A's D operand, D[kb + k, j0 + j] for the tile's
// 64 columns, transposed into da[j][k] (floats; a warp reads along a row
// of D).
__device__ __forceinline__ void cs_load_cols(float (*dst)[kCsLd],
                                             const float* d, int n, int j0,
                                             int kb, int st, int k_end) {
  const int ks = st * kCsSlice;
#pragma unroll 4
  for (int q = 0; q < kCsTileN * kCsSlice / kCsThreads; ++q) {
    const int idx = threadIdx.x + q * kCsThreads;
    const int j = idx % kCsTileN;
    const int kk = ks + idx / kCsTileN;
    const int col = j0 + j, k = kb + kk;
    const bool ok = col < n && k < k_end;
    seg_cp_async4(&dst[j][kk], ok ? d + static_cast<int64_t>(k) * n + col : d,
                  ok);
  }
}

__device__ __forceinline__ float cs_f4(const float4& v, int q) {
  return q == 0 ? v.x : (q == 1 ? v.y : (q == 2 ? v.z : v.w));
}

// acc[r][c] += the products of k values k .. k + 3, in k order.  Smem is
// SolveSmem, or a tier build's CsTierSmem (its update residual).
template <class Smem>
__device__ __forceinline__ void cs_fma4(const Smem& sm,
                                        const float (*bs)[kCsLd], int k,
                                        float acc[4][4]) {
  float4 av[4], bv[4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
    av[r] = *reinterpret_cast<const float4*>(&sm.a[cs_row(r)][k]);
#pragma unroll
  for (int c = 0; c < 4; ++c)
    bv[c] = *reinterpret_cast<const float4*>(&bs[cs_col(c)][k]);
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[r][c] = fmaf(cs_f4(av[r], q), cs_f4(bv[c], q), acc[r][c]);
}

// acc += the products of the kn (<= 32) k values from k0 of the buffers,
// stopping at kn as gemm_tile does.
template <class Smem>
__device__ __forceinline__ void cs_slice_fma(const Smem& sm,
                                             const float (*bs)[kCsLd], int k0,
                                             int kn, float acc[4][4]) {
  if (kn == kCsSlice) {
#pragma unroll
    for (int k4 = 0; k4 < kCsSlice; k4 += 4) cs_fma4(sm, bs, k0 + k4, acc);
    return;
  }
  int k = 0;
  for (; k + 4 <= kn; k += 4) cs_fma4(sm, bs, k0 + k, acc);
  for (; k < kn; ++k) {
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        acc[r][c] = fmaf(sm.a[cs_row(r)][k0 + k], bs[cs_col(c)][k0 + k],
                         acc[r][c]);
  }
}

// Issue the copies of a k block [kb, k_end) (at most kCsDepth values), one
// group a 32-deep slice: rows i0.. of A (a, row length lda, M rows) and,
// where load_b, the tile's D operand (TRANSPOSED: phase A's columns of D,
// j0 its first column; else phase B's rows of D, j0 its first row), which
// is otherwise already in bs.
template <bool TRANSPOSED, class Smem>
__device__ __forceinline__ void cs_issue(Smem& sm, float (*bs)[kCsLd],
                                         const float* a, int lda, int M,
                                         int i0, bool vec_a, const float* d,
                                         int s, int n, int j0, bool load_b,
                                         bool vec_d, int kb, int k_end) {
  const int slices = cs_cdiv(k_end - kb, kCsSlice);
  for (int st = 0; st < slices; ++st) {
    cs_load_rows<kCsTileM>(sm.a, a, lda, M, i0, kb, st, k_end, vec_a);
    if (load_b) {
      if (TRANSPOSED)
        cs_load_cols(bs, d, n, j0, kb, st, k_end);
      else
        cs_load_rows<kCsTileN>(bs, d, n, s, j0, kb, st, k_end, vec_d);
    }
    seg_cp_async_commit();
  }
}

// acc += the products of the k block cs_issue copied, each slice once it
// has landed.  Every thread of the CTA must call both.
template <class Smem>
__device__ __forceinline__ void cs_compute(Smem& sm,
                                           const float (*bs)[kCsLd], int kb,
                                           int k_end, float acc[4][4]) {
  const int slices = cs_cdiv(k_end - kb, kCsSlice);
  for (int st = 0; st < slices; ++st) {
    cs_wait(slices - 1 - st);
    __syncthreads();
    const int k0 = st * kCsSlice;
    const int kn = k_end - kb - k0 < kCsSlice ? k_end - kb - k0 : kCsSlice;
    cs_slice_fma(sm, bs, k0, kn, acc);
  }
  __syncthreads();  // the next block's copies reuse the buffers
}

template <bool TRANSPOSED, class Smem>
__device__ __forceinline__ void cs_block(Smem& sm, float (*bs)[kCsLd],
                                         const float* a, int lda, int M,
                                         int i0, bool vec_a, const float* d,
                                         int s, int n, int j0, bool load_b,
                                         bool vec_d, int kb, int k_end,
                                         float acc[4][4]) {
  cs_issue<TRANSPOSED>(sm, bs, a, lda, M, i0, vec_a, d, s, n, j0, load_b,
                       vec_d, kb, k_end);
  cs_compute(sm, bs, kb, k_end, acc);
}

// The copy modes of a launch: float4s where rows are whole float4s and
// every base is 16-byte aligned.
struct SolveCopy {
  bool codes, r, d;  // rows of z / old (length s), of r (n), of D (n)
  bool sum;          // the split sum: partial, x and r by float4s
};

__device__ __forceinline__ SolveCopy cs_copy_mode(const SolveArgs& p) {
  const auto aligned = [](const void* q) {
    return (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  };
  return {p.s % 4 == 0 && aligned(p.z) && aligned(p.old),
          p.n % 4 == 0 && aligned(p.r), p.n % 4 == 0 && aligned(p.d),
          p.n % 4 == 0 && aligned(p.r) && aligned(p.x) &&
              aligned(p.partial)};
}

// Phase-B tile t's row block (of kCsTileM batch rows) and column block
// (of kCsTileN atoms): neighbouring tiles take neighbouring row blocks,
// so the CTAs that read a row block of r are spread over the grid.
__device__ __forceinline__ int cs_row_block(const SolveArgs& p, int t) {
  return t % cs_cdiv(p.b, kCsTileM);
}
__device__ __forceinline__ int cs_col_block(const SolveArgs& p, int t) {
  return t / cs_cdiv(p.b, kCsTileM);
}

// The D slice phase-A tile t reads (its chunk and column block), and
// phase-B tile t's at k block kb_i.
__device__ __forceinline__ int cs_key_a(const SolveArgs& p, int t) {
  const int per = cs_out_tiles(p.b, p.n), ctn = cs_cdiv(p.n, kCsTileN);
  return (t / per) * ctn + (t % per) % ctn;
}
__device__ __forceinline__ int cs_key_b(const SolveArgs& p, int t, int kb_i) {
  return cs_col_block(p, t) * cs_cdiv(p.n, kCsDepth) + kb_i;
}

// Issue the copies of phase-A tile t's D slice, one group (the prologue
// of a resident slice).
__device__ __forceinline__ void cs_prefetch_a(SolveSmem& sm,
                                              const SolveArgs& p, int t) {
  const int per = cs_out_tiles(p.b, p.n), ctn = cs_cdiv(p.n, kCsTileN);
  const int c = t / per, j0 = ((t % per) % ctn) * kCsTileN;
  const int kb = c * kSplitK;
  const int k_end = p.s - kb < kSplitK ? p.s : kb + kSplitK;
  for (int st = 0; st < cs_cdiv(k_end - kb, kCsSlice); ++st)
    cs_load_cols(sm.da, p.d, p.n, j0, kb, st, k_end);
}

__device__ __forceinline__ void cs_prefetch_b(SolveSmem& sm,
                                              const SolveArgs& p, bool vec_d,
                                              int t) {
  const int j0 = cs_col_block(p, t) * kCsTileN;
  for (int st = 0; st < cs_cdiv(p.n, kCsSlice); ++st)
    cs_load_rows<kCsTileN>(sm.db, p.d, p.n, p.s, j0, 0, st, p.n, vec_d);
}

// Phase S: r = (the chunk partials added in chunk order) - X, the
// per-step route's split_sum, over every thread of the grid (float4s of
// four neighbouring entries where sum), past the L1.
__device__ __forceinline__ void cs_sum_phase(const SolveArgs& p,
                                             SolveCopy mode) {
  const int splits = cs_cdiv(p.s, kSplitK);
  const int64_t bn = static_cast<int64_t>(p.b) * p.n;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kCsThreads;
  const int64_t first = blockIdx.x * static_cast<int64_t>(kCsThreads) +
                        threadIdx.x;
  if (mode.sum) {
    const float4* part = reinterpret_cast<const float4*>(p.partial);
    const float4* x = reinterpret_cast<const float4*>(p.x);
    float4* r = reinterpret_cast<float4*>(p.r);
    const int64_t quads = bn / 4;
    for (int64_t e = first; e < quads; e += stride) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int sp0 = 0; sp0 < splits; sp0 += 8) {
        float4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (sp0 + u < splits) v[u] = __ldcg(part + (sp0 + u) * quads + e);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (sp0 + u >= splits) break;
          if (sp0 + u == 0) {
            acc = v[u];
          } else {
            acc.x = __fadd_rn(acc.x, v[u].x);
            acc.y = __fadd_rn(acc.y, v[u].y);
            acc.z = __fadd_rn(acc.z, v[u].z);
            acc.w = __fadd_rn(acc.w, v[u].w);
          }
        }
      }
      const float4 xv = __ldg(x + e);
      r[e] = make_float4(__fsub_rn(acc.x, xv.x), __fsub_rn(acc.y, xv.y),
                         __fsub_rn(acc.z, xv.z), __fsub_rn(acc.w, xv.w));
    }
    return;
  }
  for (int64_t e = first; e < bn; e += stride) {
    float acc = 0.0f;
    for (int sp0 = 0; sp0 < splits; sp0 += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (sp0 + u < splits) v[u] = __ldcg(p.partial + (sp0 + u) * bn + e);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        if (sp0 + u >= splits) break;
        acc = sp0 + u == 0 ? v[u] : __fadd_rn(acc, v[u]);
      }
    }
    p.r[e] = __fsub_rn(acc, p.x[e]);
  }
}

// Phase-A tile t with src (z, or old for the update's residual) as A: its
// chunk's partial.  key_a names the D slice in da.
template <class Smem>
__device__ __forceinline__ void cs_phase_a_tile(Smem& sm,
                                                const SolveArgs& p,
                                                SolveCopy mode,
                                                const float* src, int t,
                                                int& key_a) {
  const int per = cs_out_tiles(p.b, p.n), ctn = cs_cdiv(p.n, kCsTileN);
  const int c = t / per, o = t % per;
  const int i0 = (o / ctn) * kCsTileM, j0 = (o % ctn) * kCsTileN;
  const int kb = c * kSplitK;
  const int k_end = p.s - kb < kSplitK ? p.s : kb + kSplitK;
  const int key = cs_key_a(p, t);
  const bool load = key != key_a;
  key_a = key;
  float acc[4][4] = {};
  cs_block<true>(sm, sm.da, src, p.s, p.b, i0, mode.codes, p.d, p.s, p.n, j0,
                 load, false, kb, k_end, acc);
  float* part = p.partial + static_cast<int64_t>(c) * p.b * p.n;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + cs_row(r);
#pragma unroll
    for (int cc = 0; cc < 4; ++cc) {
      const int j = j0 + cs_col(cc);
      if (i < p.b && j < p.n)
        part[static_cast<int64_t>(i) * p.n + j] = acc[r][cc];
    }
  }
}

__device__ __forceinline__ float cs_threshold(int mode, float x, float t) {
  if (mode == kSoft) return threshold<kSoft>(x, t);
  if (mode == kSoftNonneg) return threshold<kSoftNonneg>(x, t);
  if (mode == kHard) return threshold<kHard>(x, t);
  return threshold<kHardNonneg>(x, t);
}

__device__ __forceinline__ float cs_group_scale(int mode, float norm,
                                                float t) {
  return mode == kHard ? group_scale<kHard>(norm, t)
                       : group_scale<kSoft>(norm, t);
}

// Phase-B tile t: u = z - eta (r D^T) and its epilogue (grad_prox_kernel's
// expressions).  key_b names the D slice in db.  zv and ov hold the
// thread's entries of z and old: where held, they are the tile's (the
// CTA's only phase-B tile, no member table) from the last iteration and
// are kept up to date; else they are loaded here.  Where share, delta
// adds |code - old| of the thread's entries (the early stop's share).
__device__ __forceinline__ void cs_phase_b_tile(SolveSmem& sm,
                                                const SolveArgs& p,
                                                SolveCopy mode, int t,
                                                float eta, float lam_eta,
                                                float beta, int& key_b,
                                                bool held, float zv[4][4],
                                                float ov[4][4], bool share,
                                                float& delta) {
  const int i0 = cs_row_block(p, t) * kCsTileM;
  const int j0 = cs_col_block(p, t) * kCsTileN;
  const int w = p.members != nullptr ? -1 : p.window;
  float acc[4][4] = {};
  const int blocks = cs_cdiv(p.n, kCsDepth);
  for (int kb_i = 0; kb_i < blocks; ++kb_i) {
    const int kb = kb_i * kCsDepth;
    const int k_end = p.n - kb < kCsDepth ? p.n : kb + kCsDepth;
    const int key = cs_key_b(p, t, kb_i);
    const bool load = key != key_b;
    key_b = key;
    cs_issue<false>(sm, sm.db, p.r, p.n, p.b, i0, mode.r, p.d, p.s, p.n, j0,
                    load, mode.d, kb, k_end);
    if (kb_i == 0 && !held) {
      // the thread's entries of z and old, loaded behind the operand's
      // copies (their L2 latency under the product)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + cs_row(r);
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int j = j0 + cs_col(c);
          const int64_t at = static_cast<int64_t>(i) * p.s + j;
          const bool inside = i < p.b && j < p.s;
          zv[r][c] = inside ? __ldcg(p.z + at) : 0.0f;
          ov[r][c] = inside && w >= 0 ? __ldcg(p.old + at) : 0.0f;
        }
      }
    }
    cs_compute(sm, sm.db, kb, k_end, acc);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + cs_row(r);
    float u[4];
    bool inside[4];
    int64_t at[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + cs_col(c);
      inside[c] = i < p.b && j < p.s;
      at[c] = static_cast<int64_t>(i) * p.s + j;
      u[c] = inside[c] ? __fsub_rn(zv[r][c], __fmul_rn(eta, acc[r][c]))
                       : 0.0f;
    }
    if (w < 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (inside[c]) p.pre[at[c]] = u[c];
      continue;
    }
    float code[4];
    if (w == 0) {
#pragma unroll
      for (int c = 0; c < 4; ++c)
        code[c] = cs_threshold(p.mode, u[c], lam_eta);
    } else {
      // the per-step kernel's butterfly: neighbouring columns sit on
      // neighbouring lanes (xor 1, 2, 4), then a thread's columns 8 apart
      // (16, 32); every lane takes part, outside entries add zeros
      float sq[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) sq[c] = __fmul_rn(u[c], u[c]);
      for (int off = 1; off < w && off < 8; off <<= 1)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          sq[c] = __fadd_rn(sq[c], __shfl_xor_sync(0xffffffffu, sq[c], off));
      if (w >= 16) {
        const float lo = __fadd_rn(sq[0], sq[1]);
        const float hi = __fadd_rn(sq[2], sq[3]);
        if (w == 16) {
          sq[0] = sq[1] = lo;
          sq[2] = sq[3] = hi;
        } else {
          sq[0] = sq[1] = sq[2] = sq[3] = __fadd_rn(lo, hi);
        }
      }
#pragma unroll
      for (int c = 0; c < 4; ++c)
        code[c] = __fmul_rn(u[c],
                            cs_group_scale(p.mode, sqrtf(sq[c]), lam_eta));
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (!inside[c]) continue;
      if (share)
        delta = __fadd_rn(delta, fabsf(__fsub_rn(code[c], ov[r][c])));
      zv[r][c] = momentum_z(code[c], ov[r][c], beta, p.fista);
      ov[r][c] = code[c];
      p.z[at[c]] = zv[r][c];
      p.old[at[c]] = code[c];
    }
  }
}

// A member-table group's sum of squares, at a tier's rounding where PT
// (its terms) > 0: each of the PT bf16 terms of u^2 summed over the members
// in order, then the terms' sums added in order (vtc_tpu's membership
// products, _make_prox_dots; ops/precision.prox_sums); PT 0 is the float32
// sum.  scale() is the group's scale as its members receive it at the tier
// (precision.prox_scale): bf16(scale), hi + lo, or itself.
template <int PT>
struct CsMemberSum {
  float acc[PT > 0 ? PT : 1] = {};
  __device__ __forceinline__ void add(float u) {
    const float uu = __fmul_rn(u, u);
    if constexpr (PT == 0) {
      acc[0] = __fadd_rn(acc[0], uu);
    } else {
      float t[PT];
      split_terms<PT>(uu, t);
#pragma unroll
      for (int q = 0; q < PT; ++q) acc[q] = __fadd_rn(acc[q], t[q]);
    }
  }
  __device__ __forceinline__ float total() const {
    float sum = acc[0];
#pragma unroll
    for (int q = 1; q < (PT > 0 ? PT : 1); ++q) sum = __fadd_rn(sum, acc[q]);
    return sum;
  }
  static __device__ __forceinline__ float scale(float v) {
    if constexpr (PT == 1) return bf16_round(v);
    if constexpr (PT == 2) {
      const float hi = bf16_round(v);
      return __fadd_rn(hi, bf16_round(__fsub_rn(v, hi)));
    }
    return v;
  }
};

// Phase G: the group prox of a member table, one thread per (row, group),
// group_prox_kernel's pass over the grid (PT: CsMemberSum's rounding);
// share and delta as cs_phase_b_tile's.
template <int PT = 0>
__device__ __forceinline__ void cs_group_phase(const SolveArgs& p,
                                               float lam_eta, float beta,
                                               bool share, float& delta) {
  const int64_t total = static_cast<int64_t>(p.b) * p.groups;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(kCsThreads) +
                     threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * kCsThreads) {
    const int64_t row = idx / p.groups;
    const int* list = p.members + (idx - row * p.groups) * p.width;
    const int64_t base = row * p.s;
    CsMemberSum<PT> sq;
    for (int m = 0; m < p.width && list[m] >= 0; ++m)
      sq.add(__ldcg(p.pre + base + list[m]));
    const float scale = CsMemberSum<PT>::scale(
        cs_group_scale(p.mode, sqrtf(sq.total()), lam_eta));
    for (int m = 0; m < p.width && list[m] >= 0; ++m) {
      // momentum_at's expressions, the share beside them
      const int64_t at = base + list[m];
      const float code = __fmul_rn(__ldcg(p.pre + at), scale);
      const float prev = __ldcg(p.old + at);
      if (share) delta = __fadd_rn(delta, fabsf(__fsub_rn(code, prev)));
      p.z[at] = momentum_z(code, prev, beta, p.fista);
      p.old[at] = code;
    }
  }
}

// The early stop (see above).  The sum of v over a warp's 32 lanes by an
// xor butterfly: the same bits in every lane.
__device__ __forceinline__ float cs_warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// Whether iteration it of num_iters can stop: from 1 (0 never stops) to
// the last but one (the last ends the loop anyway).
__device__ __forceinline__ bool cs_stop_turn(int it, int num_iters) {
  return it >= 1 && it + 1 < num_iters;
}

// Slots a lane reads in cs_stop_load: a STOP launch has at most 32 times
// as many CTAs.
constexpr int kCsStopLaneSlots = 8;

// seg_grid_sync with the CTA's share of iteration it posted first: each
// warp's butterfly of delta into shared memory before the barrier's
// __syncthreads, then thread 0 adds the warps in order and writes the
// share to its slot just before its __threadfence and arrival, so one
// fence publishes both.  Every thread calls it.
__device__ __forceinline__ void cs_grid_sync_share(const SolveArgs& p,
                                                   unsigned& target, int it,
                                                   float delta) {
  __shared__ float warp_shares[kCsThreads / 32];
  delta = cs_warp_sum(delta);
  if ((threadIdx.x & 31) == 0) warp_shares[threadIdx.x >> 5] = delta;
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    float share = 0.0f;
    for (int w = 0; w < kCsThreads / 32; ++w)
      share = __fadd_rn(share, warp_shares[w]);
    p.slots[(it & 1) * gridDim.x + blockIdx.x] = share;
    __threadfence();
    atomicAdd(p.barrier, 1u);
    unsigned spins = 0;
    while (static_cast<int>(seg_ld_acquire(p.barrier) - target) < 0) {
      if (++spins > kSegSpinLimit) __trap();
    }
  }
  __syncthreads();
}

// After that barrier, in every warp: put the loads of iteration it's
// slots in flight (lane l the slots l, l + 32, ..., past the last a zero),
// to be summed by cs_stop_test after the next phase.
__device__ __forceinline__ void cs_stop_load(const SolveArgs& p, int it,
                                             float sv[kCsStopLaneSlots]) {
  const float* slots = p.slots + (it & 1) * gridDim.x;
#pragma unroll
  for (int j = 0; j < kCsStopLaneSlots; ++j) {
    const int i = (threadIdx.x & 31) + 32 * j;
    sv[j] = i < static_cast<int>(gridDim.x) ? __ldcg(slots + i) : 0.0f;
  }
}

// The grid's shares summed in a fixed order (each lane its slots in turn,
// then the butterfly: the same bits in every warp of every CTA) and the
// stop test, (sum * inv_count) / eta < eps.
__device__ __forceinline__ bool cs_stop_test(const SolveArgs& p,
                                             const float sv[kCsStopLaneSlots],
                                             float eta) {
  float acc = sv[0];
#pragma unroll
  for (int j = 1; j < kCsStopLaneSlots; ++j) acc = __fadd_rn(acc, sv[j]);
  acc = cs_warp_sum(acc);
  return __fdiv_rn(__fmul_rn(acc, p.inv_count), eta) < p.eps;
}

// ---------------------------------------------------------------------------
// The tiers (see "The tiers" above): the tier tile of phases A and B, which
// the per-step route's tier kernels (fused_code_shard_train_step.cu) run too.
// ---------------------------------------------------------------------------

// A D slice's bf16 plane: kCsTileN rows (phase A's columns of D, phase B's
// rows) of kCsDepth k values, two to a 32-bit word (the lower k in the low
// half), the words of row j XOR-swizzled by (j & 7) << 2 so that a warp's
// B-fragment reads (rows g = lane / 4, words kw + lane % 4) hit 32 banks.
constexpr int kCsRowWords = kCsDepth / 2;
constexpr int kCsPlaneWords = kCsTileN * kCsRowWords;

__device__ __forceinline__ int cs_plane_word(int j, int kw) {
  return j * kCsRowWords + (kw ^ ((j & 7) << 2));
}

// A tier build's shared memory: the float32 staging of A's rows (as
// SolveSmem's), and the bf16 planes of SLICES D slices (phase A's, then
// phase B's), which the update residual's float32 phase-A slice reuses
// once the solve is done.
template <int TERMS, int SLICES>
struct CsTierSmem {
  float a[kCsTileM][kCsLd];
  union {
    uint32_t planes[SLICES][TERMS][kCsPlaneWords];
    float da[kCsTileN][kCsLd];
  };
};

// The shared memory of the solve kernel's build for the tier.
template <int TIER>
using CsSolveSmem =
    std::conditional_t<TIER == kTierHighest, SolveSmem,
                       CsTierSmem<tier_terms(TIER), 2>>;

// Split a D slice into its TERMS bf16 planes: element (j, k) is D[kb + k,
// j0 + j] (TRANSPOSED: phase A's chunk, j0 + j < n) or D[j0 + j, kb + k]
// (phase B's rows, j0 + j < s), k < k_end - kb; zeros past either edge, up
// to the last 16-deep step.  Every thread of the CTA calls it.
template <int TERMS, bool TRANSPOSED>
__device__ __forceinline__ void cs_split_slice(
    uint32_t (*planes)[kCsPlaneWords], const float* __restrict__ d, int s,
    int n, int j0, int kb, int k_end) {
  const int kwn = 8 * cs_cdiv(k_end - kb, 16);  // words up to the last step
  for (int idx = threadIdx.x; idx < kCsTileN * kwn; idx += kCsThreads) {
    const int j = TRANSPOSED ? idx % kCsTileN : idx / kwn;
    const int kw = TRANSPOSED ? idx / kCsTileN : idx % kwn;
    const int k = kb + 2 * kw;
    float v0 = 0.0f, v1 = 0.0f;
    if (TRANSPOSED) {
      const int col = j0 + j;
      if (col < n) {
        if (k < k_end) v0 = __ldg(d + static_cast<int64_t>(k) * n + col);
        if (k + 1 < k_end)
          v1 = __ldg(d + static_cast<int64_t>(k + 1) * n + col);
      }
    } else if (j0 + j < s) {
      const float* row = d + static_cast<int64_t>(j0 + j) * n;
      if (k < k_end) v0 = __ldg(row + k);
      if (k + 1 < k_end) v1 = __ldg(row + k + 1);
    }
    uint16_t lo[TERMS], hi[TERMS];
    split_bits<TERMS>(v0, lo);
    split_bits<TERMS>(v1, hi);
    const int w = cs_plane_word(j, kw);
#pragma unroll
    for (int q = 0; q < TERMS; ++q)
      planes[q][w] = static_cast<uint32_t>(lo[q]) |
                     (static_cast<uint32_t>(hi[q]) << 16);
  }
}

// One 16-deep step (k values k0 .. k0 + 15 of the staged block) of the
// tier product over this warp's 16 x 32 part of the 32 x 64 tile: warp w
// rows 16 (w >> 1).., columns 32 (w & 1).., four m16n8 tiles q.  A's
// fragments come from the float32 staging, each element split into its
// bf16 terms as they are built; B's from the planes.  The hi x hi pass is
// one mma from zero, added to hi round-to-nearest (the tensor cores round
// an accumulation toward zero, tools/conv_tier_rounding.py); the smaller
// passes accumulate in lo, in ops/precision.TIER_PAIRS' order.
// hi[q][e] / lo[q][e]: row 16 (w >> 1) + lane / 4 + 8 (e >> 1), column
// 32 (w & 1) + 8 q + 2 (lane & 3) + (e & 1).
template <int TERMS>
__device__ __forceinline__ void cs_tier_step(
    const float (*a)[kCsLd], const uint32_t (*planes)[kCsPlaneWords], int k0,
    float (&hi)[4][4], float (&lo)[4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int row = 16 * (warp >> 1) + g;
  const int k = k0 + 2 * t;
  uint4 af[TERMS];
  {
    uint32_t aw[TERMS][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 v = *reinterpret_cast<const float2*>(
          &a[row + 8 * (r & 1)][k + 8 * (r >> 1)]);
      uint16_t lo_bits[TERMS], hi_bits[TERMS];
      split_bits<TERMS>(v.x, lo_bits);
      split_bits<TERMS>(v.y, hi_bits);
#pragma unroll
      for (int q = 0; q < TERMS; ++q)
        aw[q][r] = static_cast<uint32_t>(lo_bits[q]) |
                   (static_cast<uint32_t>(hi_bits[q]) << 16);
    }
#pragma unroll
    for (int q = 0; q < TERMS; ++q)
      af[q] = make_uint4(aw[q][0], aw[q][1], aw[q][2], aw[q][3]);
  }
  const int kw = (k0 >> 1) + t;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int j = 32 * (warp & 1) + 8 * q + g;
    uint2 bf[TERMS];
#pragma unroll
    for (int p = 0; p < TERMS; ++p)
      bf[p] = make_uint2(planes[p][cs_plane_word(j, kw)],
                         planes[p][cs_plane_word(j, kw + 4)]);
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_bf16(c, af[0], bf[0]);
#pragma unroll
    for (int e = 0; e < 4; ++e) hi[q][e] = __fadd_rn(hi[q][e], c[e]);
    if constexpr (TERMS >= 2) {
      mma_bf16(lo[q], af[1], bf[0]);
      mma_bf16(lo[q], af[0], bf[1]);
    }
    if constexpr (TERMS == 3) {
      mma_bf16(lo[q], af[2], bf[0]);
      mma_bf16(lo[q], af[0], bf[2]);
    }
  }
}

// hi, lo += the tier product of the k block [kb, k_end) (at most kCsDepth)
// of A's rows i0.. (src, row length lda, M rows) and the planes: A's
// copies issued (one group a 32-deep slice), then where split the D slice
// split into the planes (split_fn), then each slice computed once it has
// landed.  Every thread of the CTA must call it.
template <int TERMS, class Smem, class Split>
__device__ __forceinline__ void cs_tier_block(
    Smem& sm, const uint32_t (*planes)[kCsPlaneWords], const float* src,
    int lda, int M, int i0, bool vec_a, int kb, int k_end, bool split,
    Split&& split_fn, float (&hi)[4][4], float (&lo)[4][4]) {
  const int slices = cs_cdiv(k_end - kb, kCsSlice);
  for (int st = 0; st < slices; ++st) {
    cs_load_rows<kCsTileM>(sm.a, src, lda, M, i0, kb, st, k_end, vec_a);
    seg_cp_async_commit();
  }
  if (split) split_fn();
  for (int st = 0; st < slices; ++st) {
    cs_wait(slices - 1 - st);
    __syncthreads();
    const int k0 = st * kCsSlice;
    const int kn = k_end - kb - k0 < kCsSlice ? k_end - kb - k0 : kCsSlice;
    for (int kk = 0; kk < kn; kk += 16)
      cs_tier_step<TERMS>(sm.a, planes, k0 + kk, hi, lo);
  }
  __syncthreads();  // the next block's copies reuse the buffers
}

// The value of output (q, e) of a tier tile: hi, plus lo where the tier has
// smaller passes.
template <int TERMS>
__device__ __forceinline__ float cs_tier_value(const float (&hi)[4][4],
                                               const float (&lo)[4][4], int q,
                                               int e) {
  return TERMS == 1 ? hi[q][e] : __fadd_rn(hi[q][e], lo[q][e]);
}

// Tile row and column of output (q, e) of a thread's tier fragments.
__device__ __forceinline__ int cs_tier_row(int e) {
  return 16 * (threadIdx.x >> 6) + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int cs_tier_col(int q, int e) {
  return 32 * ((threadIdx.x >> 5) & 1) + 8 * q + 2 * (threadIdx.x & 3) +
         (e & 1);
}

// Phase-A tile t at the tier with src (z) as A: its chunk's partial, the
// chunk's product from zero.  key names the D slice in the planes.
template <int TERMS, class Smem>
__device__ __forceinline__ void cs_tier_a_tile(
    Smem& sm, uint32_t (*planes)[kCsPlaneWords], const SolveArgs& p,
    SolveCopy mode, const float* src, int t, int& key) {
  const int per = cs_out_tiles(p.b, p.n), ctn = cs_cdiv(p.n, kCsTileN);
  const int c = t / per, o = t % per;
  const int i0 = (o / ctn) * kCsTileM, j0 = (o % ctn) * kCsTileN;
  const int kb = c * kSplitK;
  const int k_end = p.s - kb < kSplitK ? p.s : kb + kSplitK;
  const int slice = cs_key_a(p, t);
  const bool split = slice != key;
  key = slice;
  float hi[4][4] = {}, lo[4][4] = {};
  cs_tier_block<TERMS>(
      sm, planes, src, p.s, p.b, i0, mode.codes, kb, k_end, split,
      [&] {
        cs_split_slice<TERMS, true>(planes, p.d, p.s, p.n, j0, kb, k_end);
      },
      hi, lo);
  float* part = p.partial + static_cast<int64_t>(c) * p.b * p.n;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + cs_tier_row(e), j = j0 + cs_tier_col(q, e);
      if (i < p.b && j < p.n)
        part[static_cast<int64_t>(i) * p.n + j] =
            cs_tier_value<TERMS>(hi, lo, q, e);
    }
}

// Phase-B tile t at the tier: u = z - eta (r D^T), then the epilogue of
// cs_phase_b_tile with z and old read past the L1 (no entries held in
// registers): the prox (elementwise, the in-warp window sum, or pre = u
// for a member table) and the momentum.  A window of w columns sums its
// squares over a thread's own pair, then lanes xor 1 and 2 (windows of 4
// and 8), then the thread's m16n8 tiles (16: q, q ^ 1; 32: all four, lower
// pair first).  key, share and delta as cs_phase_b_tile's.
template <int TERMS, class Smem>
__device__ __forceinline__ void cs_tier_b_tile(
    Smem& sm, uint32_t (*planes)[kCsPlaneWords], const SolveArgs& p,
    SolveCopy mode, int t, float eta, float lam_eta, float beta, int& key,
    bool share, float& delta) {
  const int i0 = cs_row_block(p, t) * kCsTileM;
  const int j0 = cs_col_block(p, t) * kCsTileN;
  const int w = p.members != nullptr ? -1 : p.window;
  float hi[4][4] = {}, lo[4][4] = {};
  const int blocks = cs_cdiv(p.n, kCsDepth);
  for (int kb_i = 0; kb_i < blocks; ++kb_i) {
    const int kb = kb_i * kCsDepth;
    const int k_end = p.n - kb < kCsDepth ? p.n : kb + kCsDepth;
    const int slice = cs_key_b(p, t, kb_i);
    const bool split = slice != key;
    key = slice;
    cs_tier_block<TERMS>(
        sm, planes, p.r, p.n, p.b, i0, mode.r, kb, k_end, split,
        [&] {
          cs_split_slice<TERMS, false>(planes, p.d, p.s, p.n, j0, kb, k_end);
        },
        hi, lo);
  }
  float u[4][4];
  bool inside[4][4];
  int64_t at[4][4];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + cs_tier_row(e), j = j0 + cs_tier_col(q, e);
      inside[q][e] = i < p.b && j < p.s;
      at[q][e] = static_cast<int64_t>(i) * p.s + j;
      u[q][e] = inside[q][e]
                    ? __fsub_rn(__ldcg(p.z + at[q][e]),
                                __fmul_rn(eta, cs_tier_value<TERMS>(hi, lo,
                                                                    q, e)))
                    : 0.0f;
    }
  if (w < 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (inside[q][e]) p.pre[at[q][e]] = u[q][e];
    return;
  }
  float code[4][4];
  if (w == 0) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        code[q][e] = cs_threshold(p.mode, u[q][e], lam_eta);
  } else {
    // every lane takes part: outside entries add zeros
    float sq[4][4];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) sq[q][e] = __fmul_rn(u[q][e], u[q][e]);
    if (w >= 2) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int h = 0; h < 4; h += 2)
          sq[q][h] = sq[q][h + 1] = __fadd_rn(sq[q][h], sq[q][h + 1]);
    }
    for (int off = 1; off <= 2 && w >= 4 * off; off <<= 1)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sq[q][e] = __fadd_rn(sq[q][e],
                               __shfl_xor_sync(0xffffffffu, sq[q][e], off));
    if (w >= 16) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lo_pair = __fadd_rn(sq[0][e], sq[1][e]);
        const float hi_pair = __fadd_rn(sq[2][e], sq[3][e]);
        if (w == 16) {
          sq[0][e] = sq[1][e] = lo_pair;
          sq[2][e] = sq[3][e] = hi_pair;
        } else {
          sq[0][e] = sq[1][e] = sq[2][e] = sq[3][e] =
              __fadd_rn(lo_pair, hi_pair);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        code[q][e] = __fmul_rn(
            u[q][e], cs_group_scale(p.mode, sqrtf(sq[q][e]), lam_eta));
  }
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (!inside[q][e]) continue;
      const float prev = __ldcg(p.old + at[q][e]);
      if (share)
        delta = __fadd_rn(delta, fabsf(__fsub_rn(code[q][e], prev)));
      p.z[at[q][e]] = momentum_z(code[q][e], prev, beta, p.fista);
      p.old[at[q][e]] = code[q][e];
    }
}

// The prologue's split of the CTA's resident slices (cs_prefetch_a's and
// cs_prefetch_b's tiles) into its planes.
template <int TERMS, class Smem>
__device__ __forceinline__ void cs_tier_prefetch_a(Smem& sm,
                                                   const SolveArgs& p, int t) {
  const int per = cs_out_tiles(p.b, p.n), ctn = cs_cdiv(p.n, kCsTileN);
  const int c = t / per, j0 = ((t % per) % ctn) * kCsTileN;
  const int kb = c * kSplitK;
  const int k_end = p.s - kb < kSplitK ? p.s : kb + kSplitK;
  cs_split_slice<TERMS, true>(sm.planes[0], p.d, p.s, p.n, j0, kb, k_end);
}

template <int TERMS, class Smem>
__device__ __forceinline__ void cs_tier_prefetch_b(Smem& sm,
                                                   const SolveArgs& p, int t) {
  cs_split_slice<TERMS, false>(sm.planes[1], p.d, p.s, p.n,
                               cs_col_block(p, t) * kCsTileN, 0, p.n);
}

template <bool STOP = false, int TIER = kTierHighest>
__global__ void __launch_bounds__(kCsThreads, 1)
    code_shard_solve_kernel(SolveArgs p) {
  constexpr bool kTier = TIER != kTierHighest;
  constexpr int kTerms = tier_terms(TIER);
  extern __shared__ __align__(16) unsigned char cs_smem[];
  auto& sm = *reinterpret_cast<CsSolveSmem<TIER>*>(cs_smem);
  const SolveCopy mode = cs_copy_mode(p);
  const int tiles_a = cs_tiles_a(p.b, p.s, p.n);
  const int tiles_b = cs_tiles_b(p.b, p.s);
  const int grid = static_cast<int>(gridDim.x);
  // STOP: the base the last launch left (read before any CTA can arrive)
  unsigned target = STOP ? __ldcg(p.barrier + 1) : p.barrier_base;
  // the prologue: a CTA with one tile of a phase keeps its D slice for
  // the whole solve (n <= kCsDepth for phase B), copies in flight now
  // (a tier build splits them into its bf16 planes instead)
  int key_a = -1, key_b = -1;
  const int t0 = static_cast<int>(blockIdx.x);
  if (grid >= tiles_a && t0 < tiles_a) {
    if constexpr (kTier)
      cs_tier_prefetch_a<kTerms>(sm, p, t0);
    else
      cs_prefetch_a(sm, p, t0);
    key_a = cs_key_a(p, t0);
  }
  if (grid >= tiles_b && p.n <= kCsDepth && t0 < tiles_b) {
    if constexpr (kTier)
      cs_tier_prefetch_b<kTerms>(sm, p, t0);
    else
      cs_prefetch_b(sm, p, mode.d, t0);
    key_b = cs_key_b(p, t0, 0);
  }
  if constexpr (!kTier) seg_cp_async_commit();
  for (int t = t0; t < tiles_b; t += grid) {
    const int i0 = cs_row_block(p, t) * kCsTileM;
    const int j0 = cs_col_block(p, t) * kCsTileN;
    for (int e = threadIdx.x; e < kCsTileM * kCsTileN; e += kCsThreads) {
      const int i = i0 + e / kCsTileN, j = j0 + e % kCsTileN;
      if (i < p.b && j < p.s) {
        const int64_t at = static_cast<int64_t>(i) * p.s + j;
        p.z[at] = 0.0f;
        p.old[at] = 0.0f;
      }
    }
  }
  const float eta = *p.eta;
  const float lam_eta = __fmul_rn(p.lam, eta);
  // a CTA with one phase-B tile and no member table holds its entries of
  // z and old in registers for the whole solve (zero, as stored above);
  // a tier build reads them each iteration
  const bool held = !kTier && grid >= tiles_b && p.members == nullptr;
  float zv[4][4] = {}, ov[4][4] = {};
  seg_grid_sync(p.barrier, target);
  int count = p.num_iters;  // STOP: the iterations run
  // STOP: the slots of iteration `pending` (>= 0) in flight, tested after
  // the next phase A (which writes only the partials, so old still holds
  // that iteration's codes and a stop costs one phase A in vain)
  float sv[kCsStopLaneSlots];
  int pending = -1;
  for (int it = 0; it < p.num_iters; ++it) {
    for (int t = t0; t < tiles_a; t += grid) {
      if constexpr (kTier)
        cs_tier_a_tile<kTerms>(sm, sm.planes[0], p, mode, p.z, t, key_a);
      else
        cs_phase_a_tile(sm, p, mode, p.z, t, key_a);
    }
    seg_grid_sync(p.barrier, target);
    if (STOP && pending >= 0) {
      if (cs_stop_test(p, sv, eta)) {
        count = pending + 1;
        break;
      }
      pending = -1;
    }
    cs_sum_phase(p, mode);
    seg_grid_sync(p.barrier, target);
    const float beta = p.betas[it];
    // STOP: this iteration's share of |codes - old|, from phase B or G
    const bool turn = STOP && cs_stop_turn(it, p.num_iters);
    float delta = 0.0f;
    for (int t = t0; t < tiles_b; t += grid) {
      if constexpr (kTier)
        cs_tier_b_tile<kTerms>(sm, sm.planes[1], p, mode, t, eta, lam_eta,
                               beta, key_b, turn && p.members == nullptr,
                               delta);
      else
        cs_phase_b_tile(sm, p, mode, t, eta, lam_eta, beta, key_b, held, zv,
                        ov, turn && p.members == nullptr, delta);
    }
    if (p.members != nullptr) {
      seg_grid_sync(p.barrier, target);
      if (kTier && p.prox_round)
        cs_group_phase<kTier ? kTerms : 0>(p, lam_eta, beta, turn, delta);
      else
        cs_group_phase(p, lam_eta, beta, turn, delta);
    }
    if (turn) {
      cs_grid_sync_share(p, target, it, delta);
      cs_stop_load(p, it, sv);
      pending = it;
    } else {
      seg_grid_sync(p.barrier, target);
    }
  }
  if (p.resid) {
    // float32 at every tier: a tier build copies D's slices afresh into
    // its planes' space
    if constexpr (kTier) key_a = -1;
    for (int t = t0; t < tiles_a; t += grid)
      cs_phase_a_tile(sm, p, mode, p.old, t, key_a);
    seg_grid_sync(p.barrier, target);
    cs_sum_phase(p, mode);
  }
  cs_wait(0);  // no copy outlives the launch
  if (STOP && blockIdx.x == 0 && threadIdx.x == 0) {
    *p.iters = count;
    p.barrier[1] = target;  // every CTA has passed its last barrier
  }
}

// The solve kernel's build for stop and tier, and its dynamic shared
// memory.
inline const void* cs_solve_kernel(bool stop, int tier) {
#define VTC_CS_BUILD(T)                                               \
  if (tier == T)                                                      \
    return stop ? reinterpret_cast<const void*>(                      \
                      code_shard_solve_kernel<true, T>)               \
                : reinterpret_cast<const void*>(                      \
                      code_shard_solve_kernel<false, T>);
  VTC_CS_BUILD(kTierBf16)
  VTC_CS_BUILD(kTierBf16x3)
  VTC_CS_BUILD(kTierBf16x5)
#undef VTC_CS_BUILD
  return stop ? reinterpret_cast<const void*>(code_shard_solve_kernel<true>)
              : reinterpret_cast<const void*>(code_shard_solve_kernel<>);
}

inline int cs_solve_smem(int tier) {
  return static_cast<int>(
      tier == kTierBf16     ? sizeof(CsSolveSmem<kTierBf16>)
      : tier == kTierBf16x3 ? sizeof(CsSolveSmem<kTierBf16x3>)
      : tier == kTierBf16x5 ? sizeof(CsSolveSmem<kTierBf16x5>)
                            : sizeof(CsSolveSmem<kTierHighest>));
}

// The current device's SM count and the solve kernel's resident CTAs per
// SM (the least over its builds, each with its dynamic shared memory opted
// in, so that every tier and the stop launch the same grid), read once
// per device.
inline int cs_device_value(int which) {
  static int values[2][64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  int& v = values[which][dev];
  if (v == 0) {
    cudaError_t err = cudaSuccess;
    if (which == 0) {
      err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    } else {
      int least = 0;
      for (int tier = kTierHighest; tier <= kTierBf16x5 && err == cudaSuccess;
           ++tier)
        for (int stop = 0; stop < 2 && err == cudaSuccess; ++stop) {
          const void* kernel = cs_solve_kernel(stop != 0, tier);
          int each = 0;
          err = cudaFuncSetAttribute(
              kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
              cs_solve_smem(tier));
          if (err == cudaSuccess)
            err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &each, kernel, kCsThreads, cs_solve_smem(tier));
          if (err == cudaSuccess && (least == 0 || each < least))
            least = each;
        }
      v = least;
    }
    if (err != cudaSuccess) v = 0;
  }
  return v;
}

inline int cs_sm_count() { return cs_device_value(0); }
inline int cs_blocks_per_sm() { return cs_device_value(1); }

// Launch the solve kernel's build for the tier cooperatively on grid CTAs,
// its STOP build where stop.  A grid the card cannot hold at once is
// refused by the launch (cudaErrorCooperativeLaunchTooLarge), never run;
// the error is returned and taken off the runtime's last error.
inline cudaError_t launch_code_shard_solve(SolveArgs args, int grid,
                                           cudaStream_t stream,
                                           bool stop = false,
                                           int tier = kTierHighest) {
  if (grid < 1 || cs_blocks_per_sm() < 1)
    return cudaErrorInvalidConfiguration;
  void* params[] = {&args};
  const cudaError_t err = cudaLaunchCooperativeKernel(
      cs_solve_kernel(stop, tier), dim3(grid), dim3(kCsThreads), params,
      cs_solve_smem(tier), stream);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

}  // namespace
