// The persistent ICA segment kernel under K8 and K18, CUDA C++ for Hopper
// (sm_90a).
//
// Replaces, as one launch, the per-step kernels that
// fused_ica_train_step.cu's C loops enqueue for the TPU kernels K8
// (vtc_tpu/ops/pallas_ica_train.py, _make_ica_kernel :101 under
// fused_ica_train_segment_pallas :280) and K18
// (fused_ica_dp_train_segment_pallas :355).  The TPU kernel keeps D and X
// resident in VMEM across its sequential grid steps; the Hopper
// counterpart is one resident CTA per slot of the card (a cooperative
// launch, so the card runs every CTA at once or refuses the launch) that
// walks the whole segment, with a grid-wide barrier between dependent
// phases.  Every operand (D, X, E, the batch, the codes: about 1.3 MB at
// n = 256, b = 250) stays in the 50 MB L2.
//
// Phases of one step at refine_iters r and upd_num_iters u, a grid
// barrier after each (seg_step_phases):
//
//   2r   refresh: E = 2I - D X, then X' = X E (X ping-pongs)
//   1    R = D X - I (each CTA's NaN-keeping max |R| into its slot of
//        partials) and, speculatively, codes = batch X; after the barrier
//        every CTA folds the slots in one order, so all take the same
//        boost decision and the same r_max
//   5    the boost, when r > boost_tol: two refreshes, then the residual
//        and codes phase again (a branch uniform over the grid)
//   1    stat = codes^T sign(codes), K = b; sign() is applied as the B
//        operand lands in shared memory, and the epilogue stores the
//        natural gradient M = stat / div - I into E's buffer (free until
//        the next refresh)
//   u    D' = D + eta (M D); D ping-pongs, since other CTAs still read D
//
// div is b for K8 and global_b for K18.  K18 at a world above 1 splits a
// step into two launches of this kernel: the front (refreshes, residual,
// codes, the raw statistic into comm) and the back (M from the summed
// comm, one elementwise pass and a barrier, then the updates), with the
// host's sum hook between them (kSegFront, kSegBack).  The host tracks
// which buffer holds D and X between launches (fused_ica_train_step.cu).
//
// Layout.  An n x n product is 32 x 16 output tiles (128 at n = 256), a
// CTA of 128 threads, each thread two rows by two adjacent columns (four
// independent fmaf chains).  The residual and codes phase pairs tile t of
// D X with tile t of batch X, which read the same columns of X, so a
// thread there holds four rows (eight chains) and that phase has as many
// tiles as the others: at n = 256 every phase is one tile per CTA, on 128
// CTAs, one to an SM.  32-deep k slices of A (stored row by row, 4 floats
// of padding: a float4 of 4 k values is conflict-free) and of B (32 x 16)
// pass through an 8-stage ring of cp.async copies (16 bytes where rows
// are float4-aligned, past the L1; else 4), so a 256-deep tile has every
// copy in flight before its first slice computes.  Out-of-range rows,
// columns and k values copy as zeros.  A CTA loops over its share of a
// phase's tiles (tile t = blockIdx.x, + gridDim.x, ...).
//
// Same bits.  Every output element is the fmaf chain over k = 0 .. K-1
// from 0.0f that train_core.cuh's gemm_tile computes (the last, partial
// slice stops at K), with the per-step kernels' epilogue expressions: so
// D, X and r_max equal the per-step route's bit for bit.  No split-K, no
// reordered sum, no TF32.
//
// What bounds it on this card.  At n = 256, b = 250, r = 3, u = 1 a step
// is 0.334 GFLOP, 5 us at the fp32 SIMT peak of 67 TFLOP/s, with every
// operand in L2.  A phase is one small product per SM (131 kFLOP a tile)
// behind a grid barrier, so the kernel is bound by the barrier's latency
// (about 1 us on 128 CTAs) and by each SM's shared-memory pipe feeding
// its tile's FMAs (16 wavefronts of 128 bytes per 16 warp FMAs: about
// 4,096 cycles, 2.3 us a tile), not by FMA throughput; the tile's copies
// (1.5 us alone) do not overlap its FMAs (tools/bench_ica_step.py).  The
// same-bits rule fixes each output's fmaf chain, so the work cannot be
// split along k over more CTAs.
//
// The grid barrier is grid_sync.cuh's seg_grid_sync, its arrival counter
// zeroed by the host before each launch; the cp.async helpers are that
// header's too.
//
// The tiers.  K8, K9 and K18 at bf16x5, bf16x3 and bf16 build their
// refreshes (the boost's too) and the codes with vtc_tpu's _make_ns_dot
// (pallas_ica_train.py:57-83): both operands of each product split into
// bf16 terms (bf16_terms.cuh), the single-pass products summed in
// float32: bf16, a b; bf16x3, a_hi b_hi + a_lo b_hi + a_hi b_lo; bf16x5,
// a1 b1 + a2 b1 + a1 b2 + a3 b1 + a1 b3.  The guard residual D X - I,
// the statistic and the update stay float32.  The tier is a template
// parameter of the kernel (a run-time tier made ptxas spill the solve's
// tier kernel, fista_tier.cuh), so 'highest' is the float32 code above,
// unchanged.  The tier tile (seg_tier_tile_product):
//  * The same 32 x 16 output tiles, ring and copies as the float32 tile:
//    32-deep float32 slices of A and B land in shared memory by cp.async.
//  * Each of the CTA's 4 warps owns one m16n8 tile of the output (rows
//    16 (w >> 1).., columns 8 (w & 1)..) and, per 16-deep step, reads its
//    A and B fragments from the slice, splits each element into its bf16
//    terms as it builds them and issues the tier's mma.sync m16n8k16
//    passes: the hi x hi pass of each step from zero, added to its
//    accumulator with a round-to-nearest add (the tensor cores round an
//    accumulation toward zero, tools/conv_tier_rounding.py), the smaller
//    passes into a second accumulator, the two added at the end
//    (conv_gemm_tier.cuh's order, which ops/precision.ns_dot follows).
//  * The residual and codes phase keeps its tiles and its one barrier,
//    but not their pairing: tile t's rows of D X go through the float32
//    tile (the residual epilogue alone), then its rows of batch X
//    through the tier tile.  So seg_step_phases and the grid are the same
//    at every tier.
//  * The per-step route (fused_ica_train_step.cu) launches the same tier
//    tile, one CTA a tile (ica_tier_gemm), so the two routes give the
//    same bits at every tier, as at 'highest'.
// What bounds it: a tier's passes at the bf16 tensor-core rate take
// (3 refreshes x 2 + codes) x 2 n^2 (n or b) x passes FLOP, 0.2-1 us a
// step at n 256, b 250; the phases' barriers and the operand builds
// (8-byte shared reads, a split per element) bound it, as the fp32 tile's
// shared-memory pipe bounds 'highest'.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "bf16_terms.cuh"
#include "grid_sync.cuh"

namespace {

constexpr int kSegTileM = 32;      // output tile rows (of each A source)
constexpr int kSegTileN = 16;      // output tile columns
constexpr int kSegSlice = 32;      // depth of a k slice
constexpr int kSegStages = 8;      // k slices in the ring (256 deep)
constexpr int kSegThreads = 128;   // 16 row pairs x 8 column pairs
constexpr int kSegLdA = kSegSlice + 4;

static_assert(kSegThreads == (kSegTileM / 2) * (kSegTileN / 2),
              "a thread holds two rows by two columns");

// which halves of a step a launch runs
enum SegParts { kSegFront = 1, kSegBack = 2 };
// how the A operand is read: A (M, K), or A stored (K, M) (kept k-major
// in shared memory)
enum SegOperandA { kSegA = 0, kSegATransposed = 1 };
// how the B operand (K, N) is read: as stored, or its sign
enum SegOperandB { kSegB = 0, kSegBSign = 1 };
// what a tile's outputs become
enum SegEpilogue {
  kSegStore = 0,     // out = acc
  kSegTwoIMinus = 1, // out = 2I - acc
  kSegUpdate = 2,    // out = old + eta * acc
  kSegResidualCodes = 3,  // r = nan_max(r, |acc - I|) for the first A
                          // source, out = acc (the codes) for the second
  kSegNatGrad = 4,   // out = acc / div - I, the natural gradient's M
  kSegResidual = 5,  // r = nan_max(r, |acc - I|) (the tiers' residual)
};

// Tiles of an (m, n) output.
__host__ __device__ inline int seg_tiles(int m, int n) {
  return ((m + kSegTileM - 1) / kSegTileM) * ((n + kSegTileN - 1) / kSegTileN);
}

// Tiles of the residual and codes phase: a tile pairs rows i0.. of D X
// (n, n) with rows i0.. of batch X (b, n) over the same columns, which
// share the B operand X.
__host__ __device__ inline int seg_pair_tiles(int n, int b) {
  const int rows = n > b ? n : b;
  return seg_tiles(rows, n);
}

// Grid barriers in one step: r refreshes of two phases, the residual and
// codes phase, the statistic, u updates, and five more when the boost
// fires.  ops/fused_ica_train.segment_phases mirrors it.
__host__ __device__ inline int seg_step_phases(int refine_iters,
                                               int upd_num_iters,
                                               int boosted) {
  return 2 * refine_iters + 2 + upd_num_iters + (boosted ? 5 : 0);
}

// CTAs of a launch: every CTA the card holds at once (sm_count x
// blocks_per_sm), but no more than the largest phase has tiles (the
// residual and codes phase).  ops/fused_ica_train.segment_plan mirrors it.
inline int seg_grid(int n, int b, int sm_count, int blocks_per_sm) {
  const int slots = sm_count * blocks_per_sm;
  const int tiles = seg_pair_tiles(n, b);
  return slots < tiles ? slots : tiles;
}

struct SegmentArgs {
  float* d;                   // (n, n) D at entry; d_alt its other buffer
  float* d_alt;
  float* x;                   // (n, n) X at entry; x_alt its other buffer
  float* x_alt;
  float* e;                   // (n, n) 2I - D X; from the statistic to the
                              // updates, M = stat / div - I
  float* codes;               // (b, n)
  float* stat;                // (n, n) a front launch's codes^T
                              // sign(codes) (K18: comm)
  float* partials;            // (grid,) each CTA's residual max
  float* r_max;               // (1,) the running residual maximum
  unsigned* barrier;          // arrivals, zero at launch
  const float* batches;       // (steps, b, n) from this launch's first step
  int steps, b, n, refine_iters, upd_num_iters, has_boost, parts;
  float boost_tol, stepsize, stat_div;
};

// The dynamic shared memory of a CTA: the ring (A slices of up to two
// sources of 32 rows each, B slices) and the reduction slots.
struct SegSmem {
  float a[kSegStages][2 * kSegTileM][kSegLdA];  // [stage][row][k] (A
                                                // stored (K, M): [k][row])
  float b[kSegStages][kSegSlice][kSegTileN];    // b[stage][k][j]
  float red[kSegThreads / 32];
};

// max that keeps NaN, as jnp.maximum / torch.maximum do
__device__ __forceinline__ float seg_nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// sign(x): -1, 0 or 1, NaN kept (the per-step route's sign_kernel)
__device__ __forceinline__ float seg_sign(float x) {
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : (x == 0.0f ? 0.0f : x));
}

// The A operand of a tile: rows i0.. of one source, or of two (kDual:
// rows i0.. of a then of a2, M and M2 rows, in smem rows 0.. and 32..).
struct SegA {
  const float* a;
  const float* a2;
  int M, M2;
};

// How a phase's operands are copied: whole float4s (16-byte cp.async) for
// A when its rows as stored (K long, or M for A stored transposed) are a
// multiple of 4 and every source is 16-byte aligned, and for B when N is;
// single floats otherwise.
struct SegCopy {
  bool a_vec, b_vec;
};

template <int kA>
__device__ __forceinline__ SegCopy seg_copy_mode(const SegA& A,
                                                 const float* B, int N,
                                                 int K) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(A.a) |
                         reinterpret_cast<uintptr_t>(A.a2);
  const int stored = kA == kSegATransposed ? A.M : K;
  return {stored % 4 == 0 && (bits & 15) == 0,
          N % 4 == 0 && (reinterpret_cast<uintptr_t>(B) & 15) == 0};
}

// The (smem row, first k) of the q-th piece of a slice of A this thread
// copies: float4s along k (8 a row) or floats along k for A stored (M,
// K); for A stored (K, M), float4s or floats along the rows, which land
// k-major (smem row kk, column row: seg_a_at); a warp's global reads are
// contiguous in each.
template <int kA>
__device__ __forceinline__ void seg_a_slot(bool vec, int q, int& row,
                                           int& kk) {
  const int idx = threadIdx.x + q * kSegThreads;
  if (kA == kSegATransposed) {
    row = vec ? 4 * (idx % (kSegTileM / 4)) : idx % kSegTileM;
    kk = vec ? idx / (kSegTileM / 4) : idx / kSegTileM;
  } else if (vec) {
    row = idx / (kSegSlice / 4);
    kk = 4 * (idx % (kSegSlice / 4));
  } else {
    row = idx / kSegSlice;
    kk = idx % kSegSlice;
  }
}

// Where A's (row, k) of a slice sits in ring stage st: row-major for A
// stored (M, K), k-major for A stored transposed (a row of 32 floats per
// k, so that a float4 of the source's rows copies whole).
template <int kA>
__device__ __forceinline__ float* seg_a_at(SegSmem& sm, int st, int row,
                                          int kk) {
  return kA == kSegATransposed ? &sm.a[st][kk][row] : &sm.a[st][row][kk];
}

// The (k, first column) of the q-th piece of a slice of B this thread
// copies: a float4 (4 a row), or a float.
__device__ __forceinline__ void seg_b_slot(bool vec, int q, int& kk,
                                           int& jj) {
  const int idx = threadIdx.x + q * kSegThreads;
  if (vec) {
    kk = idx / (kSegTileN / 4);
    jj = 4 * (idx % (kSegTileN / 4));
  } else {
    kk = idx / kSegTileN;
    jj = idx % kSegTileN;
  }
}

// pieces of a slice a thread copies, per 32 rows of A and for B
constexpr int kSegAVecs = kSegTileM * kSegSlice / 4 / kSegThreads;   // 2
constexpr int kSegAFloats = kSegTileM * kSegSlice / kSegThreads;     // 8
constexpr int kSegBVecs = kSegSlice * kSegTileN / 4 / kSegThreads;   // 1
constexpr int kSegBFloats = kSegSlice * kSegTileN / kSegThreads;     // 4

// The global element behind smem row `row` and k of A, and whether it
// lies inside its source.
template <int kA>
__device__ __forceinline__ const float* seg_a_src(const SegA& A, int K,
                                                  int i0, int row, int k,
                                                  bool& ok) {
  const bool second = row >= kSegTileM;
  const float* base = second ? A.a2 : A.a;
  const int i = i0 + (second ? row - kSegTileM : row);
  ok = i < (second ? A.M2 : A.M) && k < K;
  if (!ok) return A.a;
  return kA == kSegATransposed ? base + static_cast<int64_t>(k) * A.M + i
                               : base + static_cast<int64_t>(i) * K + k;
}

// Issue the copies of slice k0 of A's rows i0.. (both sources when kDual)
// into ring stage st.  Out-of-range pieces are zero-filled.
template <int kA, bool kDual>
__device__ __forceinline__ void seg_load_a(SegSmem& sm, SegCopy mode, int st,
                                           const SegA& A, int K, int i0,
                                           int k0) {
  constexpr int kParts = kDual ? 2 : 1;
  if (mode.a_vec) {
#pragma unroll
    for (int q = 0; q < kParts * kSegAVecs; ++q) {
      int row, kk;
      seg_a_slot<kA>(true, q, row, kk);
      bool ok;
      const float* src = seg_a_src<kA>(A, K, i0, row, k0 + kk, ok);
      seg_cp_async16(seg_a_at<kA>(sm, st, row, kk), src, ok);
    }
  } else {
#pragma unroll 4
    for (int q = 0; q < kParts * kSegAFloats; ++q) {
      int row, kk;
      seg_a_slot<kA>(false, q, row, kk);
      bool ok;
      const float* src = seg_a_src<kA>(A, K, i0, row, k0 + kk, ok);
      seg_cp_async4(seg_a_at<kA>(sm, st, row, kk), src, ok);
    }
  }
}

// Issue the copies of slice k0 of B's columns j0.. into ring stage st.
__device__ __forceinline__ void seg_load_b(SegSmem& sm, SegCopy mode, int st,
                                           const float* __restrict__ B, int N,
                                           int K, int j0, int k0) {
  if (mode.b_vec) {
#pragma unroll
    for (int q = 0; q < kSegBVecs; ++q) {
      int kk, jj;
      seg_b_slot(true, q, kk, jj);
      const int k = k0 + kk, j = j0 + jj;
      const bool ok = k < K && j < N;
      seg_cp_async16(&sm.b[st][kk][jj],
                     ok ? B + static_cast<int64_t>(k) * N + j : B, ok);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kSegBFloats; ++q) {
      int kk, jj;
      seg_b_slot(false, q, kk, jj);
      const int k = k0 + kk, j = j0 + jj;
      const bool ok = k < K && j < N;
      seg_cp_async4(&sm.b[st][kk][jj],
                    ok ? B + static_cast<int64_t>(k) * N + j : B, ok);
    }
  }
}

// Once this thread's copies of stage st have landed: sign(B) (the
// per-step route's sign_kernel) in the elements it copied, for the
// statistic's B operand.  Padding stays zero.
template <int kB>
__device__ __forceinline__ void seg_fix_slice(SegSmem& sm, SegCopy mode,
                                              int st) {
  if (kB == kSegBSign) {
    const int pieces = mode.b_vec ? kSegBVecs : kSegBFloats;
    const int width = mode.b_vec ? 4 : 1;
    for (int q = 0; q < pieces; ++q) {
      int kk, jj;
      seg_b_slot(mode.b_vec, q, kk, jj);
      for (int e = 0; e < width; ++e)
        sm.b[st][kk][jj + e] = seg_sign(sm.b[st][kk][jj + e]);
    }
  }
}

// The smem row of a thread's r-th output row: ty and ty + 16 of the
// first source, then of the second (kDual), ty = tid / 8.
__device__ __forceinline__ int seg_row(int r) {
  return (threadIdx.x >> 3) + (kSegTileM / 2) * r;
}

// acc[r][c] += the products of k values k4 .. k4 + 3 (seg_fma4) or of the
// first kn (seg_slice_fma) of ring stage st, in k order, for the thread's
// rows seg_row(r) and columns 2 tx + c (tx = tid % 8): a k step of four
// is kRows float4 reads of A (4 kRows floats when A is kept k-major) and
// four float2 reads of B for 8 kRows FMAs.  The shared-memory pipe bounds
// it: a float4 read costs a warp four wavefronts and a float2 two, so 16
// wavefronts carry 16 FMAs at kRows 2 (a 1 x 4 register tile needs 20).
template <int kRows, int kA>
__device__ __forceinline__ void seg_fma4(const SegSmem& sm, int st, int k4,
                                         float acc[][2]) {
  const int tx = threadIdx.x & 7;
  float av[kRows][4];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (kA == kSegATransposed) {
#pragma unroll
      for (int q = 0; q < 4; ++q) av[r][q] = sm.a[st][k4 + q][seg_row(r)];
    } else {
      const float4 a =
          *reinterpret_cast<const float4*>(&sm.a[st][seg_row(r)][k4]);
      av[r][0] = a.x;
      av[r][1] = a.y;
      av[r][2] = a.z;
      av[r][3] = a.w;
    }
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float2 bv =
        *reinterpret_cast<const float2*>(&sm.b[st][k4 + q][2 * tx]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      acc[r][0] = fmaf(av[r][q], bv.x, acc[r][0]);
      acc[r][1] = fmaf(av[r][q], bv.y, acc[r][1]);
    }
  }
}

template <int kRows, int kA>
__device__ __forceinline__ void seg_slice_fma(const SegSmem& sm, int st,
                                              int kn, float acc[][2]) {
  if (kn >= kSegSlice) {
#pragma unroll 2
    for (int k4 = 0; k4 < kSegSlice; k4 += 4)
      seg_fma4<kRows, kA>(sm, st, k4, acc);
    return;
  }
  // the last slice: whole steps of four, then one k at a time, stopping
  // at K as gemm_tile does
  for (int k4 = 0; k4 + 4 <= kn; k4 += 4) seg_fma4<kRows, kA>(sm, st, k4, acc);
  const int tx = threadIdx.x & 7;
  for (int kk = kn & ~3; kk < kn; ++kk) {
    const float2 bv = *reinterpret_cast<const float2*>(&sm.b[st][kk][2 * tx]);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const float av = kA == kSegATransposed ? sm.a[st][kk][seg_row(r)]
                                             : sm.a[st][seg_row(r)][kk];
      acc[r][0] = fmaf(av, bv.x, acc[r][0]);
      acc[r][1] = fmaf(av, bv.y, acc[r][1]);
    }
  }
}

// acc[r][c] = sum over k of op(A)[row r, k] op(B)[k, j0 + 2 tx + c], one
// fmaf chain from 0 in k order, for the thread's rows (two, or four when
// kDual).  The k slices pass through a ring of kStages stages, kStages -
// 1 of them in flight while one computes (at K = 256 and 8 stages every
// copy of the tile is issued before the first wait, and no stage is
// reused within the tile).  Every thread of the CTA must call it.
template <int kA, int kB, bool kDual, int kStages = kSegStages>
__device__ __forceinline__ void seg_tile_product(SegSmem& sm, const SegA& A,
                                                 const float* __restrict__ B,
                                                 int N, int K, int i0, int j0,
                                                 float acc[][2]) {
  static_assert(kStages >= 2 && kStages <= kSegStages, "ring stages");
  constexpr int kRows = kDual ? 4 : 2;
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r][0] = acc[r][1] = 0.0f;
  const SegCopy mode = seg_copy_mode<kA>(A, B, N, K);
  const int slices = (K + kSegSlice - 1) / kSegSlice;
  auto issue = [&](int s) {
    seg_load_a<kA, kDual>(sm, mode, s % kStages, A, K, i0, s * kSegSlice);
    seg_load_b(sm, mode, s % kStages, B, N, K, j0, s * kSegSlice);
  };
  // always commit kStages - 1 groups ahead, so that the wait below leaves
  // exactly slice s landed
#pragma unroll 1
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < slices) issue(s);
    seg_cp_async_commit();
  }
#pragma unroll 1
  for (int s = 0; s < slices; ++s) {
    const int st = s % kStages;
    if (s + kStages - 1 < slices) issue(s + kStages - 1);
    seg_cp_async_commit();
    seg_cp_async_wait<kStages - 1>();
    seg_fix_slice<kB>(sm, mode, st);
    __syncthreads();
    seg_slice_fma<kRows, kA>(sm, st, K - s * kSegSlice, acc);
    // the stage is copied into again only when the ring wraps
    if (slices > kStages) __syncthreads();
  }
  __syncthreads();  // the next tile's copies reuse the ring
}

// Tile t of a phase with K-deep products over N columns, and its
// epilogue: out (A.M, N) for kSegStore, kSegTwoIMinus, kSegNatGrad (div
// the statistic's divisor) and kSegUpdate (old the current D, eta the
// stepsize); for kSegResidualCodes (A = D and the batch) the residual max
// into r and the codes into out (A.M2, N).
template <int kA, int kB, int kEpi>
__device__ __forceinline__ void seg_tile(SegSmem& sm, int t, const SegA& A,
                                         const float* __restrict__ B, int N,
                                         int K, float div,
                                         float* __restrict__ out,
                                         const float* __restrict__ old,
                                         float eta, float& r) {
  constexpr bool kDual = kEpi == kSegResidualCodes;
  constexpr int kRows = kDual ? 4 : 2;
  const int tiles_n = (N + kSegTileN - 1) / kSegTileN;
  const int i0 = (t / tiles_n) * kSegTileM;
  const int j0 = (t % tiles_n) * kSegTileN;
  float acc[kRows][2];
  seg_tile_product<kA, kB, kDual>(sm, A, B, N, K, i0, j0, acc);
#pragma unroll
  for (int rr = 0; rr < kRows; ++rr) {
    const bool codes = rr >= 2;
    const int i = i0 + (rr & 1) * (kSegTileM / 2) + (threadIdx.x >> 3);
    if (i >= (codes ? A.M2 : A.M)) continue;
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int j = j0 + 2 * (threadIdx.x & 7) + c;
      if (j >= N) continue;
      const int64_t at = static_cast<int64_t>(i) * N + j;
      if (kEpi == kSegStore || (kEpi == kSegResidualCodes && codes)) {
        out[at] = acc[rr][c];
      } else if (kEpi == kSegTwoIMinus) {
        out[at] = (i == j ? 2.0f : 0.0f) - acc[rr][c];
      } else if (kEpi == kSegResidualCodes || kEpi == kSegResidual) {
        r = seg_nan_max(r, fabsf(acc[rr][c] - (i == j ? 1.0f : 0.0f)));
      } else if (kEpi == kSegNatGrad) {
        out[at] = __fsub_rn(acc[rr][c] / div, i == j ? 1.0f : 0.0f);
      } else {
        out[at] = __fadd_rn(old[at], __fmul_rn(eta, acc[rr][c]));
      }
    }
  }
}

// The NaN-keeping max of v over the CTA; every thread gets it.
__device__ __forceinline__ float seg_block_max(float v, SegSmem& sm) {
  for (int off = 16; off > 0; off >>= 1)
    v = seg_nan_max(v, __shfl_xor_sync(0xffffffffu, v, off));
  __syncthreads();  // red may still be read from the previous call
  if ((threadIdx.x & 31) == 0) sm.red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = sm.red[0];
#pragma unroll
  for (int w = 1; w < kSegThreads / 32; ++w) r = seg_nan_max(r, sm.red[w]);
  return r;
}

// The tiles of one phase, this CTA's share.
template <int kA, int kB, int kEpi>
__device__ __forceinline__ void seg_phase(SegSmem& sm, int tiles,
                                          const SegA& A, const float* B,
                                          int N, int K, float div,
                                          float* out, const float* old,
                                          float eta, float& r) {
  for (int t = blockIdx.x; t < tiles; t += gridDim.x)
    seg_tile<kA, kB, kEpi>(sm, t, A, B, N, K, div, out, old, eta, r);
}

// A warp's A and B fragments of one 16-deep step (depth kk of ring stage
// st), each element split into its TERMS bf16 terms: a[p] register r
// holds term p of rows row + 8 (r & 1), depths kk + 2 (l & 3) + 8 (r >>
// 1) + {0, 1}; b[p] register e of depths kk + 2 (l & 3) + 8 e + {0, 1} of
// column col (the lower depth in the low half; mma.sync m16n8k16's .row
// .col layouts).
template <int TERMS>
__device__ __forceinline__ void seg_tier_fragments(const SegSmem& sm, int st,
                                                   int kk, int row, int col,
                                                   uint4 (&a)[TERMS],
                                                   uint2 (&b)[TERMS]) {
  const int k = kk + 2 * (threadIdx.x & 3);
  uint32_t aw[TERMS][4], bw[TERMS][2];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float2 v = *reinterpret_cast<const float2*>(
        &sm.a[st][row + 8 * (r & 1)][k + 8 * (r >> 1)]);
    uint16_t lo[TERMS], hi[TERMS];
    split_bits<TERMS>(v.x, lo);
    split_bits<TERMS>(v.y, hi);
#pragma unroll
    for (int p = 0; p < TERMS; ++p)
      aw[p][r] = static_cast<uint32_t>(lo[p]) |
                 (static_cast<uint32_t>(hi[p]) << 16);
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    uint16_t lo[TERMS], hi[TERMS];
    split_bits<TERMS>(sm.b[st][k + 8 * e][col], lo);
    split_bits<TERMS>(sm.b[st][k + 8 * e + 1][col], hi);
#pragma unroll
    for (int p = 0; p < TERMS; ++p)
      bw[p][e] = static_cast<uint32_t>(lo[p]) |
                 (static_cast<uint32_t>(hi[p]) << 16);
  }
#pragma unroll
  for (int p = 0; p < TERMS; ++p) {
    a[p] = make_uint4(aw[p][0], aw[p][1], aw[p][2], aw[p][3]);
    b[p] = make_uint2(bw[p][0], bw[p][1]);
  }
}

// c = the tier's product of A (M, K) and B (K, N) over this warp's m16n8
// tile of the 32 x 16 output tile at (i0, j0): c[2 h + e] is row i0 + 16
// (w >> 1) + (l >> 2) + 8 h, column j0 + 8 (w & 1) + 2 (l & 3) + e.  The
// 16-deep steps run from k = 0 in order and stop at K (the last one
// zero-filled past it); each step's hi x hi pass is one mma from zero,
// the first taken as it is and the others added round-to-nearest, the
// smaller passes accumulate in lo, and c = hi + lo.  Every thread of the
// CTA must call it.
template <int TIER>
__device__ __forceinline__ void seg_tier_tile_product(
    SegSmem& sm, const float* __restrict__ A, int M,
    const float* __restrict__ B, int N, int K, int i0, int j0,
    float (&c)[4]) {
  constexpr int kTerms = tier_terms(TIER);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = 16 * (warp >> 1) + (lane >> 2);
  const int col = 8 * (warp & 1) + (lane >> 2);
  float hi[4] = {0.0f, 0.0f, 0.0f, 0.0f}, lo[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const SegA sa{A, A, M, 0};
  const SegCopy mode = seg_copy_mode<kSegA>(sa, B, N, K);
  const int slices = (K + kSegSlice - 1) / kSegSlice;
  auto issue = [&](int s) {
    seg_load_a<kSegA, false>(sm, mode, s % kSegStages, sa, K, i0,
                             s * kSegSlice);
    seg_load_b(sm, mode, s % kSegStages, B, N, K, j0, s * kSegSlice);
  };
#pragma unroll 1
  for (int s = 0; s < kSegStages - 1; ++s) {
    if (s < slices) issue(s);
    seg_cp_async_commit();
  }
#pragma unroll 1
  for (int s = 0; s < slices; ++s) {
    const int st = s % kSegStages;
    if (s + kSegStages - 1 < slices) issue(s + kSegStages - 1);
    seg_cp_async_commit();
    seg_cp_async_wait<kSegStages - 1>();
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kSegSlice; kk += 16) {
      if (s * kSegSlice + kk >= K) break;
      uint4 a[kTerms];
      uint2 b[kTerms];
      seg_tier_fragments<kTerms>(sm, st, kk, row, col, a, b);
      float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      mma_bf16(t, a[0], b[0]);
      const bool first = s == 0 && kk == 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) hi[q] = first ? t[q] : __fadd_rn(hi[q], t[q]);
      if constexpr (kTerms >= 2) {
        mma_bf16(lo, a[1], b[0]);
        mma_bf16(lo, a[0], b[1]);
      }
      if constexpr (kTerms == 3) {
        mma_bf16(lo, a[2], b[0]);
        mma_bf16(lo, a[0], b[2]);
      }
    }
    // the stage is copied into again only when the ring wraps
    if (slices > kSegStages) __syncthreads();
  }
  __syncthreads();  // the next tile's copies reuse the ring
#pragma unroll
  for (int q = 0; q < 4; ++q) c[q] = kTerms == 1 ? hi[q] : __fadd_rn(hi[q], lo[q]);
}

// Tile t of an (M, N) output at the tier, K deep, into out: stored
// (kSegStore) or 2I - the product (kSegTwoIMinus), the float32 tile's
// epilogue expressions.
template <int TIER, int kEpi>
__device__ __forceinline__ void seg_tier_tile(SegSmem& sm, int t,
                                              const float* A, int M,
                                              const float* B, int N, int K,
                                              float* __restrict__ out) {
  static_assert(kEpi == kSegStore || kEpi == kSegTwoIMinus, "epilogue");
  const int tiles_n = (N + kSegTileN - 1) / kSegTileN;
  const int i0 = (t / tiles_n) * kSegTileM;
  const int j0 = (t % tiles_n) * kSegTileN;
  float c[4];
  seg_tier_tile_product<TIER>(sm, A, M, B, N, K, i0, j0, c);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int i = i0 + 16 * (warp >> 1) + (lane >> 2) + 8 * h;
    if (i >= M) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = j0 + 8 * (warp & 1) + 2 * (lane & 3) + e;
      if (j >= N) continue;
      const float v = c[2 * h + e];
      out[static_cast<int64_t>(i) * N + j] =
          kEpi == kSegTwoIMinus ? (i == j ? 2.0f : 0.0f) - v : v;
    }
  }
}

// One refresh, X' = X (2I - D X): two phases, at the tier.  Swaps x and
// x_alt.
template <int TIER>
__device__ __forceinline__ void seg_refresh(SegSmem& sm,
                                            const SegmentArgs& p,
                                            const float* d, float*& x,
                                            float*& x_alt, unsigned& target) {
  const int n = p.n, tiles = seg_tiles(n, n);
  if constexpr (TIER == kTierHighest) {
    float unused = 0.0f;
    seg_phase<kSegA, kSegB, kSegTwoIMinus>(sm, tiles, SegA{d, d, n, 0}, x, n,
                                           n, 1.0f, p.e, nullptr, 0.0f,
                                           unused);
    seg_grid_sync(p.barrier, target);
    seg_phase<kSegA, kSegB, kSegStore>(sm, tiles, SegA{x, x, n, 0}, p.e, n,
                                       n, 1.0f, x_alt, nullptr, 0.0f, unused);
    seg_grid_sync(p.barrier, target);
  } else {
    for (int t = blockIdx.x; t < tiles; t += gridDim.x)
      seg_tier_tile<TIER, kSegTwoIMinus>(sm, t, d, n, x, n, n, p.e);
    seg_grid_sync(p.barrier, target);
    for (int t = blockIdx.x; t < tiles; t += gridDim.x)
      seg_tier_tile<TIER, kSegStore>(sm, t, x, n, p.e, n, n, x_alt);
    seg_grid_sync(p.barrier, target);
  }
  float* tmp = x;
  x = x_alt;
  x_alt = tmp;
}

// The residual max |D X - I| (returned, the same in every CTA) and codes
// = batch X, one phase: at 'highest' of paired tiles; at a tier tile t's
// rows of D X in float32, then its rows of batch X at the tier.
template <int TIER>
__device__ __forceinline__ float seg_residual_and_codes(
    SegSmem& sm, const SegmentArgs& p, const float* d, const float* x,
    const float* xs, unsigned& target) {
  const int n = p.n;
  float r = 0.0f;
  if constexpr (TIER == kTierHighest) {
    seg_phase<kSegA, kSegB, kSegResidualCodes>(
        sm, seg_pair_tiles(n, p.b), SegA{d, xs, n, p.b}, x, n, n, 1.0f,
        p.codes, nullptr, 0.0f, r);
  } else {
    const int tiles_n = (n + kSegTileN - 1) / kSegTileN;
    for (int t = blockIdx.x; t < seg_pair_tiles(n, p.b); t += gridDim.x) {
      const int i0 = (t / tiles_n) * kSegTileM;
      if (i0 < n)
        seg_tile<kSegA, kSegB, kSegResidual>(sm, t, SegA{d, d, n, 0}, x, n,
                                             n, 1.0f, nullptr, nullptr, 0.0f,
                                             r);
      if (i0 < p.b)
        seg_tier_tile<TIER, kSegStore>(sm, t, xs, p.b, x, n, n, p.codes);
    }
  }
  r = seg_block_max(r, sm);
  if (threadIdx.x == 0) p.partials[blockIdx.x] = r;
  seg_grid_sync(p.barrier, target);
  // every CTA folds every slot in the same order, past the L1 (__ldcg)
  r = 0.0f;
  for (int g = threadIdx.x; g < static_cast<int>(gridDim.x); g += kSegThreads)
    r = seg_nan_max(r, __ldcg(p.partials + g));
  return seg_block_max(r, sm);
}

template <int TIER>
__global__ void __launch_bounds__(kSegThreads, 1)
    ica_segment_kernel(SegmentArgs p) {
  extern __shared__ __align__(16) unsigned char seg_smem[];
  SegSmem& sm = *reinterpret_cast<SegSmem*>(seg_smem);
  const int n = p.n, tnn = seg_tiles(n, n);
  unsigned target = 0;
  float r_max = *p.r_max;
  float* d = p.d;
  float* d_alt = p.d_alt;
  float* x = p.x;
  float* x_alt = p.x_alt;
  float unused = 0.0f;
  for (int step = 0; step < p.steps; ++step) {
    if (p.parts & kSegFront) {
      const float* xs = p.batches + static_cast<int64_t>(step) * p.b * n;
      for (int it = 0; it < p.refine_iters; ++it)
        seg_refresh<TIER>(sm, p, d, x, x_alt, target);
      const float r = seg_residual_and_codes<TIER>(sm, p, d, x, xs, target);
      if (p.has_boost && r > p.boost_tol) {  // NaN > tol is false
        seg_refresh<TIER>(sm, p, d, x, x_alt, target);
        seg_refresh<TIER>(sm, p, d, x, x_alt, target);
        r_max = seg_nan_max(
            r_max, seg_residual_and_codes<TIER>(sm, p, d, x, xs, target));
      } else {
        r_max = seg_nan_max(r_max, r);
      }
      // the statistic; with the update in this launch, M = stat / div - I
      // straight into e (free until the next refresh), else the raw
      // statistic into stat for the host's sum
      const SegA codes_t{p.codes, p.codes, n, 0};
      if (p.parts & kSegBack)
        seg_phase<kSegATransposed, kSegBSign, kSegNatGrad>(
            sm, tnn, codes_t, p.codes, n, p.b, p.stat_div, p.e, nullptr,
            0.0f, unused);
      else
        seg_phase<kSegATransposed, kSegBSign, kSegStore>(
            sm, tnn, codes_t, p.codes, n, p.b, 1.0f, p.stat, nullptr, 0.0f,
            unused);
      seg_grid_sync(p.barrier, target);
    }
    if (p.parts & kSegBack) {
      if (!(p.parts & kSegFront)) {
        // a back launch: M = stat / div - I from the summed statistic, the
        // per-step route's natural_gradient_kernel
        const int nn = n * n;
        for (int e = blockIdx.x * kSegThreads + threadIdx.x; e < nn;
             e += gridDim.x * kSegThreads)
          p.e[e] = __fsub_rn(p.stat[e] / p.stat_div,
                             e / n == e % n ? 1.0f : 0.0f);
        seg_grid_sync(p.barrier, target);
      }
      for (int u = 0; u < p.upd_num_iters; ++u) {
        seg_phase<kSegA, kSegB, kSegUpdate>(sm, tnn, SegA{p.e, p.e, n, 0}, d,
                                            n, n, 1.0f, d_alt, d, p.stepsize,
                                            unused);
        seg_grid_sync(p.barrier, target);
        float* tmp = d;
        d = d_alt;
        d_alt = tmp;
      }
    }
  }
  if ((p.parts & kSegFront) && blockIdx.x == 0 && threadIdx.x == 0)
    *p.r_max = r_max;
}

// A kernel of the segment kernel's shape with its dynamic shared memory
// opted in: its resident CTAs per SM into v.
template <typename Kernel>
inline cudaError_t seg_occupancy(Kernel kernel, int& v) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(sizeof(SegSmem)));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &v, kernel, kSegThreads, sizeof(SegSmem));
  return err;
}

// The current device's SM count and the segment kernel's resident CTAs
// per SM (the least over its tier builds, so that every tier launches the
// same grid; their dynamic shared memory opted in), read once per device.
inline int seg_device_value(int which) {
  static int values[2][64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  int& v = values[which][dev];
  if (v == 0) {
    cudaError_t err;
    if (which == 0) {
      err = cudaDeviceGetAttribute(&v, cudaDevAttrMultiProcessorCount, dev);
    } else {
      int each[4] = {0, 0, 0, 0};
      err = seg_occupancy(ica_segment_kernel<kTierHighest>, each[0]);
      if (err == cudaSuccess)
        err = seg_occupancy(ica_segment_kernel<kTierBf16>, each[1]);
      if (err == cudaSuccess)
        err = seg_occupancy(ica_segment_kernel<kTierBf16x3>, each[2]);
      if (err == cudaSuccess)
        err = seg_occupancy(ica_segment_kernel<kTierBf16x5>, each[3]);
      v = each[0];
      for (int t = 1; t < 4; ++t) v = each[t] < v ? each[t] : v;
    }
    if (err != cudaSuccess) v = 0;
  }
  return v;
}

inline int seg_sm_count() { return seg_device_value(0); }
inline int seg_blocks_per_sm() { return seg_device_value(1); }

// Launch the segment kernel's build for the tier cooperatively on grid
// CTAs, its barrier counter zeroed first.  A grid the card cannot hold at
// once is refused by the launch (cudaErrorCooperativeLaunchTooLarge),
// never run; the error is returned, and taken off the runtime's last
// error so that a later launch check does not report it again.
inline cudaError_t launch_ica_segment(SegmentArgs args, int grid, int tier,
                                      cudaStream_t stream) {
  if (grid < 1 || seg_blocks_per_sm() < 1)
    return cudaErrorInvalidConfiguration;
  const void* kernel =
      tier == kTierHighest ? reinterpret_cast<const void*>(
                                 ica_segment_kernel<kTierHighest>)
      : tier == kTierBf16  ? reinterpret_cast<const void*>(
                                ica_segment_kernel<kTierBf16>)
      : tier == kTierBf16x3
          ? reinterpret_cast<const void*>(ica_segment_kernel<kTierBf16x3>)
          : reinterpret_cast<const void*>(ica_segment_kernel<kTierBf16x5>);
  cudaError_t err = cudaMemsetAsync(args.barrier, 0, sizeof(unsigned),
                                    stream);
  if (err != cudaSuccess) return err;
  void* params[] = {&args};
  err = cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kSegThreads),
                                    params, sizeof(SegSmem), stream);
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// The per-step route's tier product: one CTA a 32 x 16 tile of the (M, N)
// output of A (M, K) and B (K, N), the segment kernel's tier tile and
// epilogue (so the same bits); nothing unless *run_if when it is given (a
// branch decided on the device, the boost).
template <int TIER, int kEpi>
__global__ void __launch_bounds__(kSegThreads)
    ica_tier_gemm_kernel(const float* __restrict__ A,
                         const float* __restrict__ B, float* __restrict__ out,
                         int M, int N, int K, const int* __restrict__ run_if) {
  if (run_if != nullptr && *run_if == 0) return;
  extern __shared__ __align__(16) unsigned char seg_smem[];
  SegSmem& sm = *reinterpret_cast<SegSmem*>(seg_smem);
  seg_tier_tile<TIER, kEpi>(sm, blockIdx.x, A, M, B, N, K, out);
}

template <int TIER, int kEpi>
inline cudaError_t ica_tier_gemm_at(const float* A, const float* B,
                                    float* out, int M, int N, int K,
                                    const int* run_if, cudaStream_t stream) {
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(ica_tier_gemm_kernel<TIER, kEpi>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(sizeof(SegSmem)));
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  ica_tier_gemm_kernel<TIER, kEpi><<<seg_tiles(M, N), kSegThreads,
                                     sizeof(SegSmem), stream>>>(
      A, B, out, M, N, K, run_if);
  return cudaGetLastError();
}

// out (M, N) = A (M, K) B (K, N) at the tier (kTierBf16, kTierBf16x3 or
// kTierBf16x5), stored, or 2I - the product with two_i_minus.
inline cudaError_t ica_tier_gemm(int tier, bool two_i_minus, const float* A,
                                 const float* B, float* out, int M, int N,
                                 int K, const int* run_if,
                                 cudaStream_t stream) {
  if (two_i_minus) {
    if (tier == kTierBf16)
      return ica_tier_gemm_at<kTierBf16, kSegTwoIMinus>(A, B, out, M, N, K,
                                                        run_if, stream);
    if (tier == kTierBf16x3)
      return ica_tier_gemm_at<kTierBf16x3, kSegTwoIMinus>(A, B, out, M, N, K,
                                                          run_if, stream);
    return ica_tier_gemm_at<kTierBf16x5, kSegTwoIMinus>(A, B, out, M, N, K,
                                                        run_if, stream);
  }
  if (tier == kTierBf16)
    return ica_tier_gemm_at<kTierBf16, kSegStore>(A, B, out, M, N, K, run_if,
                                                  stream);
  if (tier == kTierBf16x3)
    return ica_tier_gemm_at<kTierBf16x3, kSegStore>(A, B, out, M, N, K,
                                                    run_if, stream);
  return ica_tier_gemm_at<kTierBf16x5, kSegStore>(A, B, out, M, N, K, run_if,
                                                  stream);
}

}  // namespace
