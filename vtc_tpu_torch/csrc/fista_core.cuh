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
// |g| < t.  Here the products are IEEE fp32 FMAs on the CUDA cores: the
// tier 'highest'.  The other tiers (bf16x5, bf16x3, bf16) run
// fista_tier.cuh's bf16 tensor-core kernel, which launch_solve reaches
// with a tier argument.  The batch-global early stop is a compile-time
// flag (STOP) of each kernel; its design is in "The early stop" below.
//
// Three kernels compute that contract, and launch_solve picks one by the
// shape (solve_route below); all give the same bits.  Rows are
// independent and t_k is a scalar every block recomputes identically, so
// each runs every iteration in one launch.  Per iteration a batch of b
// rows does b * s * s FMAs; every output is one fmaf chain over k in
// ascending order from 0.0f over the zero-padded depth sk, with no
// split-K, so an iteration cannot take less than the latency of one
// sk-long chain of dependent FMAs.
//
// fista_kernel, the classic layout: one block of kRows rows per batch
// tile, ceil(b / kRows) blocks.  A block reads all of G (256 KB at
// s = 256, beyond its shared memory) every iteration, so:
//  * eta is folded into G once per solve (fold_gram_kernel), and eta c
//    once per block, as pallas_fista.py:89-95 does; the iteration keeps
//    JAX's association, (z + z @ (-eta G)) + eta c.
//  * The block's state (z twice for ping-pong, old, eta c) lives in shared
//    memory when it fits the block's budget and in a global scratch slice
//    owned by the block otherwise; the same code addresses both.
//  * G streams from L2 in kChunk x kColBlock slices through a two-deep
//    cp.async ring that runs across iteration boundaries.
//  * Each thread keeps a 4 x 4 register tile of the product (4 rows, 4
//    neighbouring columns) read as float4 from shared memory.
//  * The group prox needs every slot of a group, and a group may cross
//    the thread tiles, so the group kernel writes the pre-prox rows,
//    synchronises, and runs one pass over (row, group) pairs.
// It is the bitwise reference of the other two and the route of every
// shape their layouts cannot hold.  Its 128 blocks at b = 2048 each read
// all of G from L2 every iteration (32 MB an iteration), more than L2
// delivers in the iteration's FMA time.
//
// fista_cluster_kernel, the small-batch layout: one thread-block cluster
// of kCluster = 8 CTAs per tile of `rows` batch rows.  CTA q owns the
// columns [q w, (q+1) w) with w = sk / kCluster:
//  * its (sk, w) slice of G is copied into shared memory once per solve
//    (cp.async, every copy in flight at once) and multiplied by -eta in
//    place, fold_gram_kernel's one multiply (no fold launch, no gn round
//    trip); it stays there: nothing streams per iteration;
//  * it keeps the tile's full z rows twice (ping-pong) in shared memory;
//    old and eta c of its own columns live in the registers of the
//    thread that owns them: two rows and four neighbouring columns, so
//    each float4 of G read from shared memory feeds eight FMAs;
//  * an iteration: each thread takes its eight outputs of z @ (-eta G)
//    from shared memory, applies (z + acc) + eta c, the prox and the
//    momentum in registers, writes its next-z values into the other z
//    buffer of every CTA of the cluster through distributed shared
//    memory (st.shared::cluster), and the cluster synchronises once.
//    The buffers alternate, so no CTA writes a buffer another may still
//    read, and the last iteration's barrier is the last remote write any
//    CTA sees;
//  * the group prox is register-local for M in {1, 2, 4}: a thread's four
//    columns start at a multiple of 4, so they hold whole groups.  Other
//    M that divide w take one CTA-local shared-memory pass for the norms;
//  * rows (cluster_rows) spreads the batch over the card's cluster slots,
//    the clusters resident at one CTA per SM (15 of 8 on the 132-SM
//    NVIDIA H100 80GB HBM3, 700 W: clusters must fit a GPC): 18 rows and
//    14 clusters at b = 250, 10 rows and 13 clusters at b = 125.  (A 16th
//    cluster at b = 250 would share SMs with another and double their
//    time.)
// Its iteration is bound by the issue of the product's instructions in
// the two or three warps a CTA has (the product alone about 2.7 µs at
// b = 250 and s = 256 on an NVIDIA H100 80GB HBM3 at 700 W), then the
// DSMEM broadcast (rows * sk floats into each CTA) with the cluster
// barrier (1.2 µs, the barrier alone 0.43); tools/bench_fista_solve.py
// times each part.
//
// fista_wide_kernel, the large-batch layout: the cluster kernel's ideas
// (a resident -eta G slice, z pushed over DSMEM, one cluster barrier an
// iteration) sized for a batch that fills the card.  A cluster has the
// fewest CTAs P whose slices leave a block's shared memory room for four
// warps of rows (wide_cluster: P = 2 at sk = 256, a 128 KB slice and at
// most 48 rows; s up to 288), so a cluster takes many rows and the batch
// fills the card in one wave: 32 rows a cluster, 64 clusters, 128 CTAs at
// b = 2048 on the 132-SM card (wide_rows).  A thread owns 8 rows x 4
// neighbouring columns, so it reads 12 float4s from shared memory per
// 128 FMAs (the classic kernel's 4 x 4 tile 8 per 64); that return path
// into registers, not the FMA pipe, bounds the product (wide_product).
// old and eta c stay in registers, the thread's own z is re-read from the
// z buffer after the product.  The group prox is register-local, so the
// kernel takes M in {1, 2, 4}; other M stay on the classic route.  Per
// CTA an iteration is rows * w * sk FMAs (1.05 M at b = 2048, s = 256:
// 4.1-4.4 µs at the FMA pipe's rate, 6.9 measured) plus the push and the
// barrier (1.1 µs): 8.2 µs an iteration against fista_kernel's 17.1.
//
// The route (solve_route) is a pure function of the shape and the SM
// count: the cluster kernel where its layout fits (w a multiple of M,
// the shared memory within a block's budget) and the classic kernel
// would fill at most half of the SMs; above that the wide kernel where
// its layout fits; the classic kernel otherwise.  A launch that fails
// returns its CUDA error; no kernel stands in for another.
//
// Ragged edges are masked in all three: G is zero-padded to (sk, sc)
// (the cluster and wide kernels pad their slices in the load), and the
// padded codes stay exactly +0.0f.
//
// The early stop (STOP, vtc_tpu's pallas_fista.py:107-130).  After
// iteration k (from 0), avg = (sum |codes_k - codes_{k-1}| * inv_count) /
// eta, with codes_{-1} the start and eta read from eta_ptr on the device;
// the solve ends after iteration k when avg < eps and k > 0, and returns
// codes_k.  The sum is batch-global, so every CTA must see every CTA's
// share; it is taken in a fixed order, so every CTA reaches the same
// decision from the same bits and two runs take the same iterations.  No
// float atomics, no host read inside the loop.  With STOP off a kernel is
// the code above, bitwise and no slower.
//  * The cluster and wide kernels, where their grid is one resident wave
//    (stop_route): each CTA gets one more warp, the stop warp, which
//    computes nothing of the iteration.  In iteration k the compute
//    threads add their |code - old| (before old is overwritten) in a
//    fixed order, leave the sum in shared memory and signal a named
//    barrier without waiting (bar.arrive).  The stop warp arrives at the
//    cluster barrier at once, and while the compute threads push,
//    synchronise and form iteration k + 1's product, it sums theirs into
//    the CTA's share, posts it to the CTA's slot of a device array as one
//    64-bit word tagged with k, waits until every slot of the launch
//    carries the tag and sums the slots in a fixed order (stop_gather);
//    it writes the decision to a shared word, then waits at the barrier.
//    After that product the compute threads read the word: on a stop the
//    CTA writes old (codes_k) and leaves.  The decision lags one product,
//    which a stop computes in vain, and the exchange runs beside it.  Two
//    sets of slots alternate with the parity of k, and a slot is
//    rewritten only after every CTA has read it (a CTA posts k + 2 only
//    after all posted k + 1, which each did after reading k).  A poll
//    that spins past kStopSpinLimit traps.  Residency is checked before
//    the launch from the slots the routes already read, and the launch is
//    cooperative, so the runtime refuses a grid that is not co-resident.
//  * Every other shape (the classic route; a cluster or wide grid past one
//    wave; no room for the stop warp; M outside {1, 2, 4}): fista_kernel
//    with its state in global memory, launched once per iteration from
//    the C entry.  Each launch posts its blocks' shares, the last block to
//    arrive (an atomic ticket) sums them in block order, writes the stop
//    flag, t_{k+1} and the count; the launches after a stop read the flag
//    and exit at once, and one copy kernel writes old out.  The host
//    enqueues all of it and never waits.
//  * Across ranks (K15 and K16 at a world above one, vtc_tpu's
//    pallas_dp_train.py:206-248 and pallas_group_dp_train.py:189-229): a
//    kernel cannot wait on another process, so the solve takes the classic
//    route, and its last block leaves the rank's sum in a one-float
//    buffer instead of deciding.  The C loop calls a host hook after each
//    launch, which sums that buffer over the ranks (the same bits on every
//    rank), and stop_decide_kernel decides.  The classic and cluster
//    kernels give the same bits, so the ranks' codes are those of one
//    process's solve at the same count.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tier_codes.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;   // 64 column threads x 4 row threads
constexpr int kRows = 16;       // batch rows per block (4 per row thread)
constexpr int kColBlock = 256;  // columns per column block (4 per thread)
constexpr int kChunk = 32;      // depth of one streamed slice of G
constexpr int kSliceFloats = kChunk * kColBlock;
constexpr int kCluster = 8;     // CTAs per cluster (the portable size)
constexpr int kClusterMaxRows = 32;  // batch rows per cluster, 2 a thread
constexpr int kClusterMaxThreads = 512;
constexpr int kSmemPerBlock = 232448;  // a block's opt-in shared memory
constexpr int kWideRowsPerThread = 8;  // the wide kernel's thread tile: 8
                                       // rows x 4 neighbouring columns
constexpr int kWideMaxThreads = 256;   // so up to 255 registers a thread
constexpr int kWideMinThreads = 128;   // four warps: one per SM partition
constexpr int kWideMaxCluster = 8;     // the portable cluster size
// sk (a multiple of kChunk) splits into kCluster slices of whole float4s
static_assert(kChunk % (4 * kCluster) == 0, "cluster slices of 4 columns");
constexpr unsigned kStopSpinLimit = 1u << 26;  // polls of a slot, then trap
constexpr int kStopLaneWords = 8;  // slots per lane in stop_gather, so a
                                   // stop launch has at most 256 CTAs
constexpr int kStopCtlWords = 3;  // the classic route's words before its
                                  // blocks' shares: ticket, flag, t

enum Route {
  kRouteAuto = 0,
  kRouteClassic = 1,
  kRouteCluster = 2,
  kRouteWide = 3,
  // the tiers other than 'highest' (fista_tier.cuh): fista_tier_kernel,
  // then its resident layouts for small batches and for batches that fill
  // the card; at a tier 0 picks one by tier_route, and 4-6 force one (for
  // checks and tools)
  kRouteTier = 4,
  kRouteTierCluster = 5,
  kRouteTierWide = 6
};

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

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
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

// The scale of one group from its sum of squares: IEEE sqrtf and
// division, the zero-norm guard of thresholds.group_shrink, and for HARD
// norm < t -> 0.  Both kernels call it, so they agree bit for bit.
template <bool HARD>
__device__ __forceinline__ float group_scale(float sq, float t) {
  const float norm = sqrtf(sq);
  if (HARD) return norm < t ? 0.0f : 1.0f;
  const float safe = norm == 0.0f ? 1.0f : norm;
  return fmaxf(__fsub_rn(1.0f, __fdiv_rn(t, safe)), 0.0f);
}

// FISTA's t_{k+1} = (1 + sqrt(1 + 4 t_k^2)) / 2 and beta = (t_k - 1) /
// t_{k+1}, with explicit roundings (no contraction into an FMA); ISTA
// keeps t and has beta 0.
template <bool FISTA>
__device__ __forceinline__ float next_t(float t_k, float* beta) {
  if (!FISTA) {
    *beta = 0.0f;
    return t_k;
  }
  const float t_next = __fdiv_rn(
      __fadd_rn(1.0f, __fsqrt_rn(__fadd_rn(
                          1.0f, __fmul_rn(__fmul_rn(4.0f, t_k), t_k)))),
      2.0f);
  *beta = __fdiv_rn(__fsub_rn(t_k, 1.0f), t_next);
  return t_next;
}

// The group prox over the block's rows.  zn holds the pre-prox values of
// every slot; each (row, group) pair takes its group's norm, scales the
// slots and applies the momentum in place, and records the codes in old.
// Adds |code - old| of its slots to *delta, in order, when delta is set.
template <bool FISTA, bool HARD>
__device__ __forceinline__ void group_prox(float* zn, float* old, int s,
                                           int sk, int group_size,
                                           float t, float beta,
                                           float* delta = nullptr) {
  const int groups = s / group_size;
  for (int p = threadIdx.x; p < kRows * groups; p += kThreads) {
    const int r = p / groups;
    const int at = r * sk + (p - r * groups) * group_size;
    float sq = 0.0f;
    for (int m = 0; m < group_size; ++m)
      sq = fmaf(zn[at + m], zn[at + m], sq);
    const float scale = group_scale<HARD>(sq, t);
    for (int m = 0; m < group_size; ++m) {
      const float code = __fmul_rn(zn[at + m], scale);
      if (delta != nullptr)
        *delta = __fadd_rn(*delta, fabsf(__fsub_rn(code, old[at + m])));
      zn[at + m] = momentum<FISTA>(code, old[at + m], beta);
      old[at + m] = code;
    }
  }
}

// A host hook that sums a device buffer over the ranks in stream order
// and returns 0, or nonzero on a failure (train_core.cuh's SumHook).
using RankHook = int (*)(int);

// The early stop's arguments (see "The early stop" above).  words: the
// zeroed device array of stop_words() 64-bit words, reused from solve to
// solve with rising tags; iters receives the iterations the solve ran;
// the solve's slot for iteration k carries the tag tag + k (tag >= 1).
struct SolveStop {
  float eps;
  float inv_count;  // 1 / (b s), or 1 / (b G M) for groups; the global b
  unsigned long long* words;
  int* iters;
  unsigned tag;
  // the classic route across ranks (K15, K16 at a world above one): the
  // last block leaves the rank's sum in local, undecided, and hook(k)
  // sums it over the ranks after each launch; both null at one rank
  float* local = nullptr;
  RankHook hook = nullptr;
};

// A share v posted with its tag as one 64-bit word (so a reader sees both
// or neither), and a relaxed read of one, both at the device's scope.
__device__ __forceinline__ void stop_post(unsigned long long* p, unsigned tag,
                                          float v) {
  const unsigned long long word =
      (static_cast<unsigned long long>(tag) << 32) | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(word)
               : "memory");
}

__device__ __forceinline__ unsigned long long stop_load(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// The sum of v over the 32 lanes of a warp by an xor butterfly: the same
// bits in every lane (each level adds the same two values), and from run
// to run.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// In one whole warp: wait until each of the count (<= 32 kStopLaneWords)
// words at p carries tag, then sum their shares in a fixed order (lane i
// adds the words i, i + 32, ... in turn, then warp_sum).  Every warp that
// calls it on the same words gets the same bits.  Each round of polls
// puts every read of the words not yet posted in flight at once, so a
// round costs one trip to L2 however many words a lane waits for; a slot
// still unposted after kStopSpinLimit rounds traps.
__device__ __forceinline__ float stop_gather(const unsigned long long* p,
                                             int count, unsigned tag) {
  const int lane = threadIdx.x & 31;
  const unsigned long long posted = static_cast<unsigned long long>(tag)
                                    << 32;
  unsigned long long w[kStopLaneWords];
#pragma unroll
  for (int j = 0; j < kStopLaneWords; ++j)
    w[j] = lane + 32 * j < count ? stop_load(p + lane + 32 * j) : posted;
  for (unsigned spins = 0;; ++spins) {
    bool ready = true;
#pragma unroll
    for (int j = 0; j < kStopLaneWords; ++j)
      ready = ready && static_cast<unsigned>(w[j] >> 32) == tag;
    if (ready) break;
    if (spins > kStopSpinLimit) __trap();
#pragma unroll
    for (int j = 0; j < kStopLaneWords; ++j)
      if (static_cast<unsigned>(w[j] >> 32) != tag)
        w[j] = stop_load(p + lane + 32 * j);
  }
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < kStopLaneWords; ++j)
    acc = __fadd_rn(acc, __uint_as_float(static_cast<unsigned>(w[j])));
  return warp_sum(acc);
}

// The stop test on a batch-global sum of |codes_k - codes_{k-1}|, as
// vtc_tpu associates it: (sum * inv_count) / eta < eps (k > 0 is the
// caller's).
__device__ __forceinline__ bool stop_test(float sum, float eta,
                                          const SolveStop& stop) {
  return __fdiv_rn(__fmul_rn(sum, stop.inv_count), eta) < stop.eps;
}

// The cluster and wide kernels' stop builds keep, past their layouts in
// dynamic shared memory, each thread's sum of |code - old| by the parity
// of the iteration (nt = whole warps of compute threads), then the
// decision word: (it << 1) | stop, the stop warp's verdict on iteration
// it - 1, read in iteration it.  stop_smem is its size in bytes.
__host__ __device__ inline int stop_smem(int threads) {
  return (2 * ((threads + 31) / 32 * 32) + 4) * static_cast<int>(
                                                   sizeof(float));
}

// The named block barrier on which the compute threads hand their sums to
// the stop warp (bar.arrive: they do not wait), and the cluster barrier in
// two halves, so the stop warp arrives before its gather and waits after.
constexpr int kStopBarrier = 1;

__device__ __forceinline__ void named_arrive(int count) {
  asm volatile("bar.arrive %0, %1;" ::"r"(kStopBarrier), "r"(count)
               : "memory");
}

__device__ __forceinline__ void named_sync(int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(kStopBarrier), "r"(count)
               : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;" ::: "memory");
}

// Whether iteration it of num_iters hands its sums to the stop warp: from
// k = 1 (k = 0 never stops) to the last but one (the last ends the loop).
__device__ __forceinline__ bool stop_turn(int it, int num_iters) {
  return it >= 1 && it + 1 < num_iters;
}

// The stop warp's whole loop in a cluster or wide kernel, in step with the
// compute threads' iterations (one cluster barrier each).  In an iteration
// that hands its sums over, it waits for them (named_sync) and arrives at
// the cluster barrier at once, so the compute threads' barrier waits on
// nothing of the stop; then, while they push, synchronise and form the
// next product, it forms the CTA's share (the threads' sums in thread
// order, lane by lane, then warp_sum), posts it with its tag, gathers
// every CTA's share (stop_gather) and writes the decision for the next
// iteration, and waits at the barrier.  (The sums alternate by parity:
// the compute threads write the next iteration's while it reads these.)
// It leaves where the compute threads break: after a stop.  pre_barrier:
// the compute threads meet at one more cluster barrier an iteration,
// before their push (fista_tier.cuh's one-buffer layout), which the stop
// warp passes first.
__device__ __forceinline__ void stop_warp_loop(int num_iters,
                                               const float* deltas, int nt,
                                               float eta,
                                               const SolveStop& stop,
                                               volatile int* word,
                                               bool pre_barrier = false) {
  const int lane = threadIdx.x & 31;
  bool stopping = false;
  for (int it = 0; it < num_iters && !stopping; ++it) {
    if (pre_barrier) {
      cluster_arrive();
      cluster_wait();
    }
    if (!stop_turn(it, num_iters)) {
      cluster_arrive();
      cluster_wait();
      continue;
    }
    named_sync(nt + 32);
    cluster_arrive();
    const float* dk = deltas + (it & 1) * nt;
    float v = 0.0f;
    for (int i = lane; i < nt; i += 32) v = __fadd_rn(v, dk[i]);
    const float share = warp_sum(v);
    unsigned long long* slots = stop.words + (it & 1) * gridDim.x;
    if (lane == 0) stop_post(slots + blockIdx.x, stop.tag + it, share);
    stopping = stop_test(stop_gather(slots, gridDim.x, stop.tag + it), eta,
                         stop);
    if (lane == 0) *word = ((it + 1) << 1) | (stopping ? 1 : 0);
    cluster_wait();
  }
}

// The stop warp's decision on iteration it - 1, waited for in shared
// memory: true on a stop.  (A wait past kStopSpinLimit polls traps.)
__device__ __forceinline__ bool stop_decided(const volatile int* word,
                                             int it) {
  int w = *word;
  unsigned spins = 0;
  while ((w >> 1) != it) {
    if (++spins > kStopSpinLimit) __trap();
    w = *word;
  }
  return (w & 1) != 0;
}

// GROUP: the prox is the group prox of group_size slots (MODE kSoft or
// kHard); otherwise the elementwise shrink<MODE>.  STOP: one iteration,
// k0, of a solve whose state lives in state_global from launch to launch
// (k0 = 0 loads it); a launch after a stop exits at once, and the last
// block of each launch takes the stop test (see "The early stop"); out is
// written by stop_writeout_kernel after the last launch.
// The end of a classic STOP launch, iteration k0 (every thread of the
// block): the block's share of |codes - old| (its warps' sums in warp
// order), then the last block to arrive (an atomic ticket) sums the shares
// in block order and decides, or across ranks leaves the sum in
// stop.local; it saves t_{k0+1} for the next launch.
__device__ __forceinline__ void classic_stop_decide(float delta, float eta,
                                                    float t_k,
                                                    const SolveStop& stop,
                                                    int k0) {
  unsigned* const ticket = reinterpret_cast<unsigned*>(stop.words);
  volatile int* const stop_flag = reinterpret_cast<int*>(stop.words + 1);
  float* const t_saved = reinterpret_cast<float*>(stop.words + 2);
  float* const shares = reinterpret_cast<float*>(stop.words + kStopCtlWords);
  const int tid = threadIdx.x;
  __shared__ float warp_shares[kThreads / 32];
  __shared__ bool last;
  delta = warp_sum(delta);
  if ((tid & 31) == 0) warp_shares[tid >> 5] = delta;
  __syncthreads();
  if (tid == 0) {
    float share = 0.0f;
    for (int w = 0; w < kThreads / 32; ++w)
      share = __fadd_rn(share, warp_shares[w]);
    shares[blockIdx.x] = share;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && tid < 32) {
    __threadfence();
    float sum = 0.0f;
    for (int i = tid; i < static_cast<int>(gridDim.x); i += 32)
      sum = __fadd_rn(sum, reinterpret_cast<volatile float*>(shares)[i]);
    sum = warp_sum(sum);
    if (tid == 0) {
      if (stop.local != nullptr) {
        *stop.local = sum;  // summed over the ranks, then decided
      } else {
        *stop_flag = k0 > 0 && stop_test(sum, eta, stop) ? 1 : 0;
        *stop.iters = k0 + 1;
      }
      *t_saved = t_k;
      *ticket = 0u;
    }
  }
}

template <bool FISTA, int MODE, bool GROUP, bool STOP = false>
__global__ void __launch_bounds__(kThreads)
    fista_kernel(const float* __restrict__ gn, const float* __restrict__ corr,
                 const float* __restrict__ init,
                 const float* __restrict__ eta_ptr, float lam, int num_iters,
                 int b, int s, int sk, int sc, int group_size,
                 float* state_global, float* __restrict__ out,
                 SolveStop stop = {}, int k0 = 0) {
  extern __shared__ __align__(16) float smem[];
  volatile int* const stop_flag = reinterpret_cast<int*>(stop.words + 1);
  const float* const t_saved = reinterpret_cast<float*>(stop.words + 2);
  if (STOP && k0 > 0 && *stop_flag != 0) return;
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
  __syncthreads();

  const int nk = sk / kChunk;
  const int ncb = sc / kColBlock;
  const int nq = nk * ncb;  // slices per iteration
  float t_k = STOP && k0 > 0 ? *t_saved : 1.0f;
  int cur = STOP ? k0 & 1 : 0;
  float delta = 0.0f;  // STOP: this thread's sum of |code - old|
  unsigned slice = 0;  // running slice counter; its parity picks the buffer
  if (num_iters > 0) load_slice(gn, 0, nk, sc, gbuf);

  for (int it = 0; it < num_iters; ++it) {
    float beta;
    const float t_next = next_t<FISTA>(t_k, &beta);
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
              if (STOP)
                delta = __fadd_rn(delta, fabsf(__fsub_rn(code, old[idx])));
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
                                       beta, STOP ? &delta : nullptr);
    }
    __syncthreads();  // zn complete before the next iteration reads it
    cur ^= 1;
    t_k = t_next;
  }

  if constexpr (STOP) {
    classic_stop_decide(delta, eta, t_k, stop, k0);
  } else {
    for (int idx = tid; idx < plane; idx += kThreads) {
      const int r = idx / sk;
      const int j = idx - r * sk;
      const int64_t row = row0 + r;
      if (row < b && j < s) out[row * s + j] = old[idx];
    }
  }
}

// The classic route across ranks: the decision of iteration k on the sum
// over the ranks in *stop.local, one thread, as the last block decides at
// one rank; nothing once the solve stopped (k = 0 clears the flag).
__global__ void stop_decide_kernel(SolveStop stop,
                                   const float* __restrict__ eta_ptr, int k) {
  volatile int* const stop_flag = reinterpret_cast<int*>(stop.words + 1);
  if (k > 0 && *stop_flag != 0) return;
  *stop_flag = k > 0 && stop_test(*stop.local, *eta_ptr, stop) ? 1 : 0;
  *stop.iters = k + 1;
}

// The classic stop route's output: old of every live entry of the blocks'
// global state (ceil(b / kRows), 4, kRows, sk) into out (b, s).
__global__ void stop_writeout_kernel(const float* __restrict__ state, int b,
                                     int s, int sk, float* __restrict__ out) {
  const int64_t total = static_cast<int64_t>(b) * s;
  const int64_t plane = static_cast<int64_t>(kRows) * sk;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = idx / s;
    const int64_t blk = row / kRows;
    out[idx] = state[blk * 4 * plane + 2 * plane + (row - blk * kRows) * sk +
                     (idx - row * s)];
  }
}

// Threads of a STOP launch of a kernel with `threads` compute threads:
// the compute warps, then the stop warp.
__host__ __device__ inline int stop_threads(int threads) {
  return (threads + 31) / 32 * 32 + 32;
}

// The cluster kernel's layout for a padded depth sk and rows batch rows
// per cluster (even): w columns per CTA, z rows of ldz floats (4 past
// sk, so the rows a warp reads fall on different banks), one thread per
// (row pair, 4 columns), and the dynamic shared memory: the G slice, two
// z buffers and, for a group prox whose M does not divide 4, the staged
// pre-prox slice and its group scales.
struct ClusterLayout {
  int w, ldz, threads, smem;
};

__host__ __device__ inline ClusterLayout cluster_layout(int sk,
                                                        int group_size,
                                                        int rows) {
  ClusterLayout lay;
  lay.w = sk / kCluster;
  lay.ldz = sk + 4;
  lay.threads = rows / 2 * (lay.w / 4);
  int floats = sk * lay.w + 2 * rows * lay.ldz;
  if (4 % group_size != 0 && lay.w % group_size == 0)
    floats += rows * lay.w + rows * (lay.w / group_size);
  lay.smem = floats * static_cast<int>(sizeof(float));
  return lay;
}

// The most rows (even, at most kClusterMaxRows) a cluster can take for
// sk padded codes in groups of group_size (1: elementwise) within a
// block's thread and shared-memory budgets, or 0 where a group would
// cross two CTAs' columns or not even two rows fit.
__host__ __device__ inline int cluster_max_rows(int sk, int group_size) {
  if (group_size < 1 || (sk / kCluster) % group_size != 0) return 0;
  for (int rows = kClusterMaxRows; rows >= 2; rows -= 2) {
    const ClusterLayout lay = cluster_layout(sk, group_size, rows);
    if (lay.threads <= kClusterMaxThreads && lay.smem <= kSmemPerBlock)
      return rows;
  }
  return 0;
}

// Rows per cluster for a batch of b: as few as spread the batch over the
// card's cluster slots (the clusters resident at one CTA per SM), so
// each CTA has an SM of its own, within cluster_max_rows.
__host__ __device__ inline int cluster_rows(int b, int sk, int group_size,
                                            int slots) {
  const int spread = slots > 0 ? slots : 1;
  const int per_slot = (b + spread - 1) / spread;
  const int rows = per_slot < 2 ? 2 : (per_slot + 1) / 2 * 2;
  const int most = cluster_max_rows(sk, group_size);
  return rows > most ? most : rows;
}

// The wide kernel's layout for a padded depth sk, clusters of `cluster`
// CTAs and rows batch rows per cluster (a multiple of
// kWideRowsPerThread): w columns per CTA, z rows of ldz floats (4 past sk:
// the next four k's reads past a row's end stay in the buffer), one
// thread per (8 rows, 4 columns), and the dynamic shared memory: the G
// slice and two z buffers.
struct WideLayout {
  int w, ldz, threads, smem;
};

__host__ __device__ inline WideLayout wide_layout(int sk, int cluster,
                                                  int rows) {
  WideLayout lay;
  lay.w = sk / cluster;
  lay.ldz = sk + 4;
  lay.threads = rows / kWideRowsPerThread * (lay.w / 4);
  lay.smem = (sk * lay.w + 2 * rows * lay.ldz) * static_cast<int>(
                                                     sizeof(float));
  return lay;
}

// The most rows (a multiple of kWideRowsPerThread) a cluster of `cluster`
// CTAs takes for sk padded codes in groups of group_size within a block's
// thread and shared-memory budgets, or 0: where a group is not whole in a
// thread's four columns (4 % M != 0), the slices are not whole float4s,
// or not even one thread tile of rows fits.
__host__ __device__ inline int wide_max_rows(int sk, int group_size,
                                             int cluster) {
  if (group_size < 1 || 4 % group_size != 0 || cluster < 1 ||
      sk % (4 * cluster) != 0)
    return 0;
  const int per_row = sk / cluster / 4;  // column threads
  const int by_threads = kWideMaxThreads / per_row * kWideRowsPerThread;
  const int free_floats =
      kSmemPerBlock / static_cast<int>(sizeof(float)) - sk * (sk / cluster);
  const int by_smem = free_floats < 0 ? 0
                                      : free_floats / (2 * (sk + 4)) /
                                            kWideRowsPerThread *
                                            kWideRowsPerThread;
  return by_threads < by_smem ? by_threads : by_smem;
}

// The wide kernel's cluster size for that shape: the fewest CTAs (1, 2, 4
// or 8) whose slices leave shared memory for kWideMinThreads threads'
// tiles of rows, or 0 where none does and the shape stays on the classic
// route.  (With fewer than four warps a CTA leaves SM partitions without
// FMAs to issue, and at s 320 and above the slices leave room for fewer
// rows than that in every cluster size.)
__host__ __device__ inline int wide_cluster(int sk, int group_size) {
  for (int cluster = 1; cluster <= kWideMaxCluster; cluster *= 2) {
    const int rows = wide_max_rows(sk, group_size, cluster);
    if (wide_layout(sk, cluster, rows).threads >= kWideMinThreads)
      return cluster;
  }
  return 0;
}

// Rows per cluster for a batch of b when the card holds slots clusters of
// wide_cluster's size at one CTA per SM: the fewest waves the most rows
// allow, the batch spread evenly over them, rounded up to whole thread
// tiles; 0 where the layout does not fit.
__host__ __device__ inline int wide_rows(int b, int sk, int group_size,
                                         int slots) {
  const int cluster = wide_cluster(sk, group_size);
  if (cluster == 0) return 0;
  const int most = wide_max_rows(sk, group_size, cluster);
  const int spread = slots > 0 ? slots : 1;
  const int64_t per_wave = static_cast<int64_t>(spread) * most;
  const int waves = static_cast<int>((b + per_wave - 1) / per_wave);
  const int64_t per_cluster = static_cast<int64_t>(spread) * waves;
  const int rows = static_cast<int>((b + per_cluster - 1) / per_cluster);
  return (rows + kWideRowsPerThread - 1) / kWideRowsPerThread *
         kWideRowsPerThread;
}

// The route: the cluster kernel where its layout fits and the classic
// kernel's ceil(b / kRows) blocks would fill at most half of the SMs;
// above that the wide kernel where its layout fits; the classic kernel
// otherwise.  ops/fused_fista.solve_route mirrors it.
inline int solve_route(int b, int sk, int group_size, int sm_count) {
  const int tiles = (b + kRows - 1) / kRows;
  if (2 * tiles <= sm_count)
    return cluster_max_rows(sk, group_size) >= 2 ? kRouteCluster
                                                 : kRouteClassic;
  return wide_cluster(sk, group_size) > 0 ? kRouteWide : kRouteClassic;
}

// The current device's SM count, read once per device.
inline int device_sm_count() {
  static int counts[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0 &&
      cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    counts[dev] = 0;
  return counts[dev];
}

// The cluster kernel's pieces, which tools/bench_fista_solve.cu also
// times on their own.

// Copy the (rows, width) block at src (row stride ld, live where row <
// live_rows and column < live_cols) into dst (row stride dld) with
// cp.async, zero elsewhere; width is a multiple of 4.  Each thread walks
// its float4s with a running (row, float4) pair, so no division per
// element, and every copy is in flight at once: the caller commits and
// waits.  A whole float4 moves as one 16-byte copy where the source rows
// are 16-byte aligned (ld a multiple of 4) and it is all live.
__device__ __forceinline__ void cluster_copy_in(const float* src, int ld,
                                                int live_rows, int live_cols,
                                                float* dst, int dld, int rows,
                                                int width) {
  const int per_row = width / 4;
  const int step = blockDim.x;
  int r = threadIdx.x / per_row;
  int c4 = threadIdx.x - r * per_row;
  const int dr = step / per_row, dc = step - dr * per_row;
  for (; r < rows;) {
    float* d = dst + r * dld + c4 * 4;
    const int col = c4 * 4;
    if (src != nullptr && r < live_rows && col + 3 < live_cols &&
        ld % 4 == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
      cp_async16(d, src + static_cast<int64_t>(r) * ld + col);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (src != nullptr && r < live_rows && col + i < live_cols)
          cp_async4(d + i, src + static_cast<int64_t>(r) * ld + col + i);
        else
          d[i] = 0.0f;
      }
    }
    r += dr;
    c4 += dc;
    if (c4 >= per_row) {
      c4 -= per_row;
      ++r;
    }
  }
}

// gs (sk, w) = -eta G for the columns [rank w, (rank+1) w), zero-padded,
// and the tile's z rows (init, zero-padded) into zbuf: every copy in
// flight at once, then fold_gram_kernel's one multiply on the live
// entries in place (padding stays +0.0f).
__device__ __forceinline__ void cluster_load(
    const float* __restrict__ gram, const float* __restrict__ init,
    float neg_eta, int b, int s, int sk, int w, int rank, int64_t row0,
    int rows, int ldz, float* gs, float* zbuf) {
  const int g_cols = s - rank * w;  // live columns of this CTA's slice
  cluster_copy_in(gram + rank * w, s, s, g_cols, gs, w, sk, w);
  const int z_rows = b - row0 < rows ? static_cast<int>(b - row0) : rows;
  cluster_copy_in(init == nullptr ? nullptr : init + row0 * s, s, z_rows, s,
                  zbuf, ldz, rows, sk);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  const int per_row = w / 4, step = blockDim.x;
  int k = threadIdx.x / per_row;
  int c4 = threadIdx.x - k * per_row;
  const int dk = step / per_row, dc = step - dk * per_row;
  for (; k < s;) {
    float4* p = reinterpret_cast<float4*>(gs + k * w + c4 * 4);
    float4 v = *p;
    const int col = c4 * 4;
    if (col < g_cols) v.x = neg_eta * v.x;
    if (col + 1 < g_cols) v.y = neg_eta * v.y;
    if (col + 2 < g_cols) v.z = neg_eta * v.z;
    if (col + 3 < g_cols) v.w = neg_eta * v.w;
    *p = v;
    k += dk;
    c4 += dc;
    if (c4 >= per_row) {
      c4 -= per_row;
      ++k;
    }
  }
}

// acc[r][c] = sum_k zr[r ldz + k] gcol[k w + c], r < 2, c < 4: eight fmaf
// chains over k in ascending order from 0.0f (fista_kernel's order).  Per
// four k a thread reads one float4 of each z row and four float4 of G,
// each G float4 serving both rows.  (Issuing the next four k's reads
// before this four's FMAs, or holding the z float4s in an array, measured
// slower on an NVIDIA H100 80GB HBM3 at 700 W: 3.4-4.2 against 2.7-3.2
// µs an iteration at b = 250, tools/bench_fista_solve.py.)
__device__ __forceinline__ void cluster_product(const float* zr, int ldz,
                                                const float* gcol, int sk,
                                                int w, float (&acc)[2][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < sk; k += 4) {
    const float4 a0 = *reinterpret_cast<const float4*>(zr + k);
    const float4 a1 = *reinterpret_cast<const float4*>(zr + ldz + k);
    const float* g = gcol + k * w;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 gv = *reinterpret_cast<const float4*>(g + kk * w);
      const float v0 = kk == 0 ? a0.x : kk == 1 ? a0.y : kk == 2 ? a0.z : a0.w;
      const float v1 = kk == 0 ? a1.x : kk == 1 ? a1.y : kk == 2 ? a1.z : a1.w;
      acc[0][0] = fmaf(v0, gv.x, acc[0][0]);
      acc[0][1] = fmaf(v0, gv.y, acc[0][1]);
      acc[0][2] = fmaf(v0, gv.z, acc[0][2]);
      acc[0][3] = fmaf(v0, gv.w, acc[0][3]);
      acc[1][0] = fmaf(v1, gv.x, acc[1][0]);
      acc[1][1] = fmaf(v1, gv.y, acc[1][1]);
      acc[1][2] = fmaf(v1, gv.z, acc[1][2]);
      acc[1][3] = fmaf(v1, gv.w, acc[1][3]);
    }
  }
}

// bases[q]: the shared::cluster address of local in the CTA of cluster
// rank q (mapa), for cluster_push; ranks at or past count are left unset
// (count is the cluster's size, at most N).
template <int N>
__device__ __forceinline__ void cluster_bases(const float* local,
                                              unsigned (&bases)[N],
                                              int count = N) {
  const unsigned own =
      static_cast<unsigned>(__cvta_generic_to_shared(local));
#pragma unroll
  for (int q = 0; q < N; ++q)
    if (q < count)
      asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
                   : "=r"(bases[q])
                   : "r"(own), "r"(q));
}

// Write v at byte offset at of the same buffer in every CTA of the
// cluster (its first count ranks) through distributed shared memory.
template <int N>
__device__ __forceinline__ void cluster_push(const unsigned (&bases)[N],
                                             unsigned at, float4 v,
                                             int count = N) {
#pragma unroll
  for (int q = 0; q < N; ++q)
    if (q < count)
      asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};"
                   ::"r"(bases[q] + at), "f"(v.x), "f"(v.y), "f"(v.z),
                   "f"(v.w)
                   : "memory");
}

// The group prox of a row's four columns, which hold 4 / M whole groups:
// code = x * scale of its group, in registers.
template <int M, bool HARD>
__device__ __forceinline__ void register_group_prox(const float (&x)[4],
                                                    float t,
                                                    float (&code)[4]) {
#pragma unroll
  for (int g = 0; g < 4; g += M) {
    float sq = 0.0f;
#pragma unroll
    for (int m = 0; m < M; ++m) sq = fmaf(x[g + m], x[g + m], sq);
    const float scale = group_scale<HARD>(sq, t);
#pragma unroll
    for (int m = 0; m < M; ++m) code[g + m] = __fmul_rn(x[g + m], scale);
  }
}

// GROUP: the group prox of group_size slots (MODE kSoft or kHard), in
// registers for M in {1, 2, 4}, else through one CTA-local pass over the
// staged slice (M divides w); otherwise the elementwise shrink<MODE>.
// One cluster of kCluster CTAs per rows batch rows; the CTA of cluster
// rank q owns the columns [q w, (q+1) w), its thread (ty, tx) the rows
// 2 ty and 2 ty + 1 and the columns q w + 4 tx .. +3.  STOP: the early
// stop, with the stop warp after the compute warps (stop_threads; M in
// {1, 2, 4} only, and every CTA of the launch resident).
template <bool FISTA, int MODE, bool GROUP, bool STOP = false>
__global__ void __launch_bounds__(kClusterMaxThreads)
    fista_cluster_kernel(const float* __restrict__ gram,
                         const float* __restrict__ corr,
                         const float* __restrict__ init,
                         const float* __restrict__ eta_ptr, float lam,
                         int num_iters, int b, int s, int sk, int group_size,
                         int rows, float* __restrict__ out,
                         SolveStop stop = {}) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const ClusterLayout lay = cluster_layout(sk, group_size, rows);
  const int w = lay.w, ldz = lay.ldz;
  const int tid = threadIdx.x;
  const int ty = tid / (w / 4);
  const int tx = tid - ty * (w / 4);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / kCluster) * rows;
  const int j0 = rank * w + tx * 4;  // the thread's first column
  const int plane = rows * ldz;      // one z buffer
  // STOP: the threads past lay.threads hold no rows; the last warp is the
  // stop warp
  const bool compute = !STOP || tid < lay.threads;
  const bool stop_warp = STOP && tid >= (lay.threads + 31) / 32 * 32;

  float* gs = smem;                  // (sk, w): -eta G, this CTA's columns
  float* zbuf = gs + sk * w;         // two (rows, ldz) z buffers
  float* pre = zbuf + 2 * plane;     // shared pass: (rows, w) pre-prox
  float* scl = pre + rows * w;       // shared pass: (rows, w / M) scales
  // STOP: past the layout, the threads' sums by parity and the decision
  // (stop_smem)
  const int nt = (lay.threads + 31) / 32 * 32;
  float* deltas = smem + lay.smem / sizeof(float);
  volatile int* stop_word = reinterpret_cast<int*>(deltas + 2 * nt);

  const float eta = *eta_ptr;
  const float lam_eta = lam * eta;
  cluster_load(gram, init, -eta, b, s, sk, w, rank, row0, rows, ldz, gs,
               zbuf);
  // this thread's rows and columns of z, old and eta c
  float zown[2][4], old[2][4], ec[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t row = row0 + 2 * ty + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool live = compute && row < b && j0 + c < s;
      const int64_t at = row * s + j0 + c;
      zown[r][c] = (live && init != nullptr) ? init[at] : 0.0f;
      old[r][c] = zown[r][c];
      ec[r][c] = live ? eta * corr[at] : 0.0f;
    }
  }
  if (STOP && tid == 0) *stop_word = 0;  // no decision yet
  unsigned bases[kCluster];  // zbuf in every CTA of the cluster
  cluster_bases(zbuf, bases);
  // every CTA of the cluster has started (and its z rows are loaded)
  // before any writes into another's shared memory
  cluster.sync();
  if (STOP && stop_warp) {
    stop_warp_loop(num_iters, deltas, nt, eta, stop, stop_word);
    return;
  }

  float t_k = 1.0f;
  int it = 0;
  for (; it < num_iters; ++it) {
    float beta;
    const float t_next = next_t<FISTA>(t_k, &beta);
    const int cur = it & 1;
    float acc[2][4], x[2][4], code[2][4];
    if (compute)
      cluster_product(zbuf + cur * plane + 2 * ty * ldz, ldz, gs + tx * 4,
                      sk, w, acc);
    // STOP: the decision on iteration it - 1 (old still holds its codes);
    // every CTA of the launch breaks at the same it
    if (STOP && it >= 2 && stop_decided(stop_word, it)) break;
    float delta = 0.0f;
    if (compute) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          x[r][c] = __fadd_rn(__fadd_rn(zown[r][c], acc[r][c]), ec[r][c]);
      if (GROUP) {
        constexpr bool kHardGroup = MODE == kHard;
        if (group_size == 4) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            register_group_prox<4, kHardGroup>(x[r], lam_eta, code[r]);
        } else if (group_size == 2) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            register_group_prox<2, kHardGroup>(x[r], lam_eta, code[r]);
        } else if (group_size == 1 || STOP) {
#pragma unroll
          for (int r = 0; r < 2; ++r)
            register_group_prox<1, kHardGroup>(x[r], lam_eta, code[r]);
        } else {
          const int per_row = w / group_size;
#pragma unroll
          for (int r = 0; r < 2; ++r)
            *reinterpret_cast<float4*>(pre + (2 * ty + r) * w + tx * 4) =
                make_float4(x[r][0], x[r][1], x[r][2], x[r][3]);
          __syncthreads();
          for (int p = tid; p < rows * per_row; p += blockDim.x) {
            const int r = p / per_row;
            const float* g = pre + r * w + (p - r * per_row) * group_size;
            float sq = 0.0f;
            for (int m = 0; m < group_size; ++m) sq = fmaf(g[m], g[m], sq);
            scl[p] = group_scale<kHardGroup>(sq, lam_eta);
          }
          __syncthreads();
#pragma unroll
          for (int r = 0; r < 2; ++r)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              code[r][c] = __fmul_rn(
                  x[r][c],
                  scl[(2 * ty + r) * per_row + (tx * 4 + c) / group_size]);
        }
      } else {
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            code[r][c] = shrink<MODE>(x[r][c], lam_eta);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // padded columns stay +0.0f, as fista_kernel never writes them
          const bool col = j0 + c < s;
          if (STOP)  // padded entries add exact zeros
            delta = __fadd_rn(delta, fabsf(__fsub_rn(code[r][c], old[r][c])));
          zown[r][c] = col ? momentum<FISTA>(code[r][c], old[r][c], beta)
                           : 0.0f;
          old[r][c] = col ? code[r][c] : 0.0f;
        }
        const int at = (cur ^ 1) * plane + (2 * ty + r) * ldz + j0;
        cluster_push(bases, static_cast<unsigned>(at) * 4u,
                     make_float4(zown[r][0], zown[r][1], zown[r][2],
                                 zown[r][3]));
      }
    }
    if (STOP && stop_turn(it, num_iters)) {  // the sum, to the stop warp
      deltas[(it & 1) * nt + tid] = delta;
      named_arrive(nt + 32);
    }
    // every CTA has read z and written the next z everywhere: the next
    // iteration reads it and overwrites this one's.  The last barrier is
    // also the one after which no CTA writes into another, so each may
    // then exit.  (After a stop's break, none has written since the
    // last.)
    cluster.sync();
    t_k = t_next;
  }

  if (compute) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int64_t row = row0 + 2 * ty + r;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (row < b && j0 + c < s) out[row * s + j0 + c] = old[r][c];
    }
  }
  if (STOP && blockIdx.x == 0 && tid == 0) *stop.iters = it;
}

// The wide kernel's product: acc[r][c] = sum_k zr[r ldz + k] gcol[k w + c]
// for its 8 rows and 4 columns, 32 fmaf chains over k in ascending order
// from 0.0f (fista_kernel's order).  Per four k a thread reads one float4
// of each z row (the warp's lanes share the address: a broadcast) and
// one float4 of G for each k.  What bounds it is the shared memory's
// return path into registers, 128 bytes a cycle an SM: a warp's float4
// read writes 512 bytes of registers, broadcast or not, so the tile's 12
// float4s per 128 FMAs take 1.5 times the FMA pipe's time.  SK > 0
// compiles the strides of clusters of two CTAs at sk = SK (w = SK / 2,
// ldz = SK + 4) into the loop; 0 reads them at run time.  On an NVIDIA
// H100 80GB HBM3 at 700 W at b = 2048, s = 256 (tools/
// bench_fista_solve.py): 6.9 µs alone with the strides compiled in,
// 7.8 read at run time; loading the next four k's float4s before this
// four's FMAs measured 7.7 and 7.9 (an iteration 8.4 and 9.0 against
// 8.2).
static_assert(kWideRowsPerThread == 8, "wide_product's tile has 8 rows");
constexpr int kWideFixedDepth = 256;  // the flagship's sk, compiled in
template <int SK>
__device__ __forceinline__ void wide_product(const float* zr, int ldz,
                                             const float* gcol, int sk,
                                             int w, float (&acc)[8][4]) {
  if (SK > 0) {
    sk = SK;
    w = SK / 2;
    ldz = SK + 4;
  }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[r][c] = 0.0f;
#pragma unroll 2
  for (int k = 0; k < sk; k += 4) {
    float4 a[8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      a[r] = *reinterpret_cast<const float4*>(zr + r * ldz + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 g = *reinterpret_cast<const float4*>(gcol + (k + kk) * w);
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float v = kk == 0   ? a[r].x
                        : kk == 1 ? a[r].y
                        : kk == 2 ? a[r].z
                                  : a[r].w;
        acc[r][0] = fmaf(v, g.x, acc[r][0]);
        acc[r][1] = fmaf(v, g.y, acc[r][1]);
        acc[r][2] = fmaf(v, g.z, acc[r][2]);
        acc[r][3] = fmaf(v, g.w, acc[r][3]);
      }
    }
  }
}

// GROUP: the group prox of group_size slots in {1, 2, 4} (MODE kSoft or
// kHard), in registers; otherwise the elementwise shrink<MODE>.  SK:
// wide_product's compiled strides (launch_wide passes kWideFixedDepth
// for sk 256 in clusters of two, else 0).  One cluster of P =
// wide_cluster CTAs per rows batch rows; the CTA of cluster rank q owns
// the columns [q w, (q+1) w), its thread (ty, tx) the rows 8 ty .. 8 ty
// + 7 and the columns q w + 4 tx .. +3.  The iteration is
// fista_cluster_kernel's: the product from the resident slice, the prox
// and momentum in registers, the thread's next-z float4s pushed into the
// other z buffer of every CTA of the cluster, one cluster barrier.  STOP:
// the early stop, as fista_cluster_kernel's.
template <bool FISTA, int MODE, bool GROUP, int SK, bool STOP = false>
__global__ void __launch_bounds__(kWideMaxThreads, 1)
    fista_wide_kernel(const float* __restrict__ gram,
                      const float* __restrict__ corr,
                      const float* __restrict__ init,
                      const float* __restrict__ eta_ptr, float lam,
                      int num_iters, int b, int s, int sk, int group_size,
                      int rows, float* __restrict__ out,
                      SolveStop stop = {}) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int size = static_cast<int>(cluster.num_blocks());
  const WideLayout lay = wide_layout(sk, size, rows);
  const int w = lay.w, ldz = lay.ldz;
  const int tid = threadIdx.x;
  const int ty = tid / (w / 4);
  const int tx = tid - ty * (w / 4);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x / size) * rows;
  const int r0 = kWideRowsPerThread * ty;  // the thread's first row
  const int j0 = rank * w + tx * 4;        // and first column
  const int plane = rows * ldz;            // one z buffer
  // STOP: the threads past lay.threads hold no rows; the last warp is the
  // stop warp
  const bool compute = !STOP || tid < lay.threads;
  const bool stop_warp = STOP && tid >= (lay.threads + 31) / 32 * 32;

  float* gs = smem;           // (sk, w): -eta G, this CTA's columns
  float* zbuf = gs + sk * w;  // two (rows, ldz) z buffers
  // STOP: past the layout, the threads' sums by parity and the decision
  // (stop_smem)
  const int nt = (lay.threads + 31) / 32 * 32;
  float* deltas = smem + lay.smem / sizeof(float);
  volatile int* stop_word = reinterpret_cast<int*>(deltas + 2 * nt);

  const float eta = *eta_ptr;
  const float lam_eta = lam * eta;
  cluster_load(gram, init, -eta, b, s, sk, w, rank, row0, rows, ldz, gs,
               zbuf);
  // this thread's rows and columns of old and eta c
  float old[8][4], ec[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int64_t row = row0 + r0 + r;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const bool live = compute && row < b && j0 + c < s;
      const int64_t at = row * s + j0 + c;
      old[r][c] = (live && init != nullptr) ? init[at] : 0.0f;
      ec[r][c] = live ? eta * corr[at] : 0.0f;
    }
  }
  if (STOP && tid == 0) *stop_word = 0;  // no decision yet
  unsigned bases[kWideMaxCluster];  // zbuf in every CTA of the cluster
  cluster_bases(zbuf, bases, size);
  // every CTA of the cluster has started (and its z rows are loaded)
  // before any writes into another's shared memory
  cluster.sync();
  if (STOP && stop_warp) {
    stop_warp_loop(num_iters, deltas, nt, eta, stop, stop_word);
    return;
  }

  float t_k = 1.0f;
  int it = 0;
  for (; it < num_iters; ++it) {
    float beta;
    const float t_next = next_t<FISTA>(t_k, &beta);
    const int cur = it & 1;
    const float* zr = zbuf + cur * plane + r0 * ldz;
    float acc[8][4];
    if (compute) wide_product<SK>(zr, ldz, gs + tx * 4, sk, w, acc);
    // STOP: the decision on iteration it - 1 (old still holds its codes);
    // every CTA of the launch breaks at the same it
    if (STOP && it >= 2 && stop_decided(stop_word, it)) break;
    float delta, dcol[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (compute) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        // the thread's own z, as it pushed it (or as loaded)
        const float4 zo =
            *reinterpret_cast<const float4*>(zr + r * ldz + j0);
        float x[4], code[4], zn[4];
        x[0] = __fadd_rn(__fadd_rn(zo.x, acc[r][0]), ec[r][0]);
        x[1] = __fadd_rn(__fadd_rn(zo.y, acc[r][1]), ec[r][1]);
        x[2] = __fadd_rn(__fadd_rn(zo.z, acc[r][2]), ec[r][2]);
        x[3] = __fadd_rn(__fadd_rn(zo.w, acc[r][3]), ec[r][3]);
        if (GROUP) {
          constexpr bool kHardGroup = MODE == kHard;
          if (group_size == 4)
            register_group_prox<4, kHardGroup>(x, lam_eta, code);
          else if (group_size == 2)
            register_group_prox<2, kHardGroup>(x, lam_eta, code);
          else
            register_group_prox<1, kHardGroup>(x, lam_eta, code);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c) code[c] = shrink<MODE>(x[c], lam_eta);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          // padded columns stay +0.0f, as fista_kernel never writes them
          const bool col = j0 + c < s;
          if (STOP)  // a column's sum over the rows; padding adds zeros
            dcol[c] = __fadd_rn(dcol[c], fabsf(__fsub_rn(code[c], old[r][c])));
          zn[c] = col ? momentum<FISTA>(code[c], old[r][c], beta) : 0.0f;
          old[r][c] = col ? code[c] : 0.0f;
        }
        const int at = (cur ^ 1) * plane + (r0 + r) * ldz + j0;
        cluster_push(bases, static_cast<unsigned>(at) * 4u,
                     make_float4(zn[0], zn[1], zn[2], zn[3]), size);
      }
    }
    if (STOP && stop_turn(it, num_iters)) {  // the sum, to the stop warp
      delta = __fadd_rn(__fadd_rn(dcol[0], dcol[1]),
                        __fadd_rn(dcol[2], dcol[3]));
      deltas[(it & 1) * nt + tid] = delta;
      named_arrive(nt + 32);
    }
    // every CTA has read z and written the next z everywhere: the next
    // iteration reads it and overwrites this one's.  The last barrier is
    // also the one after which no CTA writes into another, so each may
    // then exit.  (After a stop's break, none has written since the
    // last.)
    cluster.sync();
    t_k = t_next;
  }

  if (compute) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int64_t row = row0 + r0 + r;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (row < b && j0 + c < s) out[row * s + j0 + c] = old[r][c];
    }
  }
  if (STOP && blockIdx.x == 0 && tid == 0) *stop.iters = it;
}

// A launch of grid CTAs of threads threads in clusters of `size`, with
// smem bytes of dynamic shared memory on stream; the configuration points
// at attrs, which this fills with the cluster size and, when cooperative,
// the cooperative flag (the runtime then refuses a grid whose CTAs cannot
// all be resident at once).
inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute (&attrs)[2],
                                         int size, unsigned grid,
                                         unsigned threads, int smem,
                                         cudaStream_t stream,
                                         bool cooperative = false) {
  attrs[0].id = cudaLaunchAttributeClusterDimension;
  attrs[0].val.clusterDim.x = size;
  attrs[0].val.clusterDim.y = 1;
  attrs[0].val.clusterDim.z = 1;
  attrs[1].id = cudaLaunchAttributeCooperative;
  attrs[1].val.cooperative = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(grid);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = stream;
  config.attrs = attrs;
  config.numAttrs = cooperative ? 2 : 1;
  return config;
}

// Launch kernel(args...) in that configuration after raising its dynamic
// shared-memory limit to smem; the first CUDA error of the two, or of the
// launch check.
template <typename... Params, typename... Args>
cudaError_t launch_clusters_as(bool cooperative, void (*kernel)(Params...),
                               int size, unsigned grid, unsigned threads,
                               int smem, cudaStream_t stream, Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t config =
      cluster_config(attrs, size, grid, threads, smem, stream, cooperative);
  err = cudaLaunchKernelEx(&config, kernel, args...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <typename... Params, typename... Args>
cudaError_t launch_clusters(void (*kernel)(Params...), int size,
                            unsigned grid, unsigned threads, int smem,
                            cudaStream_t stream, Args... args) {
  return launch_clusters_as(false, kernel, size, grid, threads, smem, stream,
                            args...);
}

// How many clusters of `size` CTAs of kernel, at threads threads and smem
// bytes of dynamic shared memory, can be resident at once
// (cudaOccupancyMaxActiveClusters), or minus the CUDA error.
template <typename... Params>
int resident_clusters(void (*kernel)(Params...), int size, unsigned threads,
                      int smem) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return -static_cast<int>(err);
  cudaLaunchAttribute attrs[2];
  const cudaLaunchConfig_t config =
      cluster_config(attrs, size, size, threads, smem, nullptr);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &config);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

// The number of clusters of `size` CTAs of kernel the current device
// holds at one CTA per SM (resident_clusters at a whole SM's shared
// memory), read once per device into cache; minus the CUDA error on
// failure.
template <typename... Params>
int device_slots(void (*kernel)(Params...), int size, int (&cache)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (dev < 0 || dev >= 64) return -static_cast<int>(cudaErrorInvalidDevice);
  if (cache[dev] > 0) return cache[dev];
  const int clusters = resident_clusters(kernel, size, 128, kSmemPerBlock);
  if (clusters < 0) return clusters;
  if (clusters < 1) return -static_cast<int>(cudaErrorInvalidConfiguration);
  cache[dev] = clusters;
  return clusters;
}

// The cluster kernel's slots: clusters of kCluster CTAs at one CTA per SM.
inline int cluster_slots() {
  static int slots[64] = {};
  return device_slots(fista_cluster_kernel<true, kSoft, false>, kCluster,
                      slots);
}

// Whether the cluster kernel's stop build takes b rows of sk padded codes
// in groups of group_size on a card of `slots` cluster slots: the group
// prox in registers (M in {1, 2, 4}), the grid one resident wave (at most
// slots clusters, so every CTA has an SM) of at most 32 kStopLaneWords
// CTAs, and room for the stop warp and its shared memory.
__host__ __device__ inline bool cluster_stop_fits(int b, int sk,
                                                  int group_size, int slots) {
  if (group_size < 1 || 4 % group_size != 0 || slots < 1) return false;
  const int rows = cluster_rows(b, sk, group_size, slots);
  if (rows < 2) return false;
  const int clusters = (b + rows - 1) / rows;
  const ClusterLayout lay = cluster_layout(sk, group_size, rows);
  return clusters <= slots && clusters * kCluster <= 32 * kStopLaneWords &&
         stop_threads(lay.threads) <= kClusterMaxThreads &&
         lay.smem + stop_smem(lay.threads) <= kSmemPerBlock;
}

// The same for the wide kernel's stop build, on a card of `slots` clusters
// of wide_cluster's size.
__host__ __device__ inline bool wide_stop_fits(int b, int sk, int group_size,
                                               int slots) {
  const int cluster = wide_cluster(sk, group_size);
  if (cluster == 0 || slots < 1) return false;
  const int rows = wide_rows(b, sk, group_size, slots);
  const int clusters = (b + rows - 1) / rows;
  const WideLayout lay = wide_layout(sk, cluster, rows);
  return clusters <= slots && clusters * cluster <= 32 * kStopLaneWords &&
         stop_threads(lay.threads) <= kWideMaxThreads &&
         lay.smem + stop_smem(lay.threads) <= kSmemPerBlock;
}

// The route of a solve with the early stop (ops/fused_fista.stop_route
// mirrors it): solve_route's cluster or wide kernel where its stop build
// fits, else the classic route, launched an iteration at a time.
// wide_slots counts clusters of wide_cluster's size.
inline int stop_route(int b, int sk, int group_size, int sm_count,
                      int cluster_slots, int wide_slots) {
  const int route = solve_route(b, sk, group_size, sm_count);
  if (route == kRouteCluster &&
      cluster_stop_fits(b, sk, group_size, cluster_slots))
    return kRouteCluster;
  if (route == kRouteWide && wide_stop_fits(b, sk, group_size, wide_slots))
    return kRouteWide;
  return kRouteClassic;
}

// The 64-bit words of the stop's device array on a route: two slots per
// CTA of a cluster or wide launch, or the classic route's three control
// words and one share per block.
inline int64_t stop_words(int route, int b, int sk, int group_size,
                          int cluster_slots, int wide_slots) {
  if (route == kRouteCluster) {
    const int rows = cluster_rows(b, sk, group_size, cluster_slots);
    return rows < 2 ? 0 : 2 * static_cast<int64_t>((b + rows - 1) / rows) *
                              kCluster;
  }
  if (route == kRouteWide) {
    const int rows = wide_rows(b, sk, group_size, wide_slots);
    return rows < 1 ? 0 : 2 * static_cast<int64_t>((b + rows - 1) / rows) *
                              wide_cluster(sk, group_size);
  }
  return kStopCtlWords + static_cast<int64_t>((b + kRows - 1) / kRows);
}

// Launch the cluster kernel: kCluster CTAs per cluster_rows batch rows;
// with stop, its stop build, cooperatively, where cluster_stop_fits.
template <bool FISTA, int MODE, bool GROUP>
cudaError_t launch_cluster(const float* gram, const float* corr,
                           const float* init, const float* eta, float lam,
                           int num_iters, int b, int s, int sk,
                           int group_size, float* out, cudaStream_t stream,
                           const SolveStop* stop = nullptr) {
  if (cluster_max_rows(sk, group_size) < 2) return cudaErrorInvalidValue;
  const int slots = cluster_slots();
  if (slots < 0) return static_cast<cudaError_t>(-slots);
  const int rows = cluster_rows(b, sk, group_size, slots);
  const ClusterLayout lay = cluster_layout(sk, group_size, rows);
  const unsigned grid = static_cast<unsigned>((b + rows - 1) / rows *
                                              kCluster);
  if (stop == nullptr)
    return launch_clusters(fista_cluster_kernel<FISTA, MODE, GROUP>,
                           kCluster, grid, lay.threads, lay.smem, stream,
                           gram, corr, init, eta, lam, num_iters, b, s, sk,
                           group_size, rows, out, SolveStop{});
  if (!cluster_stop_fits(b, sk, group_size, slots))
    return cudaErrorInvalidValue;
  return launch_clusters_as(
      true, fista_cluster_kernel<FISTA, MODE, GROUP, true>, kCluster, grid,
      stop_threads(lay.threads), lay.smem + stop_smem(lay.threads), stream,
      gram, corr,
      init, eta, lam, num_iters, b, s, sk, group_size, rows, out, *stop);
}

// How many clusters of the cluster kernel can be resident at once for sk
// padded codes at rows rows per cluster, or minus the CUDA error.
template <bool FISTA, int MODE, bool GROUP>
int cluster_occupancy(int sk, int group_size, int rows) {
  if (rows < 2 || rows > cluster_max_rows(sk, group_size))
    return -static_cast<int>(cudaErrorInvalidValue);
  const ClusterLayout lay = cluster_layout(sk, group_size, rows);
  return resident_clusters(fista_cluster_kernel<FISTA, MODE, GROUP>,
                           kCluster, lay.threads, lay.smem);
}

// The wide kernel's slots: clusters of `cluster` CTAs (1, 2, 4 or 8) at
// one CTA per SM.
inline int wide_slots(int cluster) {
  static int slots[kWideMaxCluster + 1][64] = {};
  if (cluster < 1 || cluster > kWideMaxCluster)
    return -static_cast<int>(cudaErrorInvalidValue);
  return device_slots(fista_wide_kernel<true, kSoft, false, 0>, cluster,
                      slots[cluster]);
}

// The wide kernel's rows per cluster for that shape on the current
// device, or minus the CUDA error of reading its slots (0 where the
// layout does not fit).
inline int wide_device_rows(int b, int sk, int group_size) {
  const int cluster = wide_cluster(sk, group_size);
  if (cluster == 0) return 0;
  const int slots = wide_slots(cluster);
  return slots < 0 ? slots : wide_rows(b, sk, group_size, slots);
}

// Launch the wide kernel: wide_cluster CTAs per wide_rows batch rows;
// with stop, its stop build, cooperatively, where wide_stop_fits.
template <bool FISTA, int MODE, bool GROUP>
cudaError_t launch_wide(const float* gram, const float* corr,
                        const float* init, const float* eta, float lam,
                        int num_iters, int b, int s, int sk, int group_size,
                        float* out, cudaStream_t stream,
                        const SolveStop* stop = nullptr) {
  const int cluster = wide_cluster(sk, group_size);
  if (cluster == 0) return cudaErrorInvalidValue;
  const int slots = wide_slots(cluster);
  if (slots < 0) return static_cast<cudaError_t>(-slots);
  const int rows = wide_rows(b, sk, group_size, slots);
  const WideLayout lay = wide_layout(sk, cluster, rows);
  const unsigned grid =
      static_cast<unsigned>((b + rows - 1) / rows * cluster);
  const bool fixed = sk == kWideFixedDepth && cluster == 2;
  if (stop == nullptr)
    return launch_clusters(
        fixed ? fista_wide_kernel<FISTA, MODE, GROUP, kWideFixedDepth>
              : fista_wide_kernel<FISTA, MODE, GROUP, 0>,
        cluster, grid, lay.threads, lay.smem, stream, gram, corr, init, eta,
        lam, num_iters, b, s, sk, group_size, rows, out, SolveStop{});
  if (!wide_stop_fits(b, sk, group_size, slots)) return cudaErrorInvalidValue;
  return launch_clusters_as(
      true,
      fixed ? fista_wide_kernel<FISTA, MODE, GROUP, kWideFixedDepth, true>
            : fista_wide_kernel<FISTA, MODE, GROUP, 0, true>,
      cluster, grid, stop_threads(lay.threads),
      lay.smem + stop_smem(lay.threads), stream,
      gram, corr, init, eta, lam, num_iters, b, s, sk, group_size, rows, out,
      *stop);
}

// stop_route and stop_words on the current device: the route (or minus
// the CUDA error of reading the slots), and its words through *words
// unless null.
inline int device_stop_route(int b, int sk, int group_size,
                             int64_t* words = nullptr) {
  const int cslots = cluster_slots();
  if (cslots < 0) return cslots;
  const int cluster = wide_cluster(sk, group_size);
  const int wslots = cluster == 0 ? 1 : wide_slots(cluster);
  if (wslots < 0) return wslots;
  const int route =
      stop_route(b, sk, group_size, device_sm_count(), cslots, wslots);
  if (words != nullptr)
    *words = stop_words(route, b, sk, group_size, cslots, wslots);
  return route;
}

// The classic route with the stop: fista_kernel's stop build once per
// iteration on the blocks' global state (gn folded), then the copy of old
// into out.  With no iteration, the plain kernel writes the start out and
// the count is 0.  Across ranks (stop.local and stop.hook): after each
// launch stop.hook(k) sums *stop.local over the ranks and
// stop_decide_kernel decides, so every rank makes the same num_iters hook
// calls and stops at the same count; a failed hook returns
// cudaErrorUnknown (the hook keeps its own error).
//
// The loop is drive_classic_stop's.  It takes a launcher:
// launch(with_stop, iterations, stop, k0) launches the build without
// (false) or with (true) the stop on ceil(b / kRows) blocks, their shared
// memory attribute already set, so that fista_tier.cuh's kernel, whose
// state layout is fista_kernel's, runs on the same route.
template <class Launch>
cudaError_t drive_classic_stop(const Launch& launch, const float* eta,
                               int num_iters, int b, int s, int sk,
                               float* state_global, float* out,
                               const SolveStop& stop, cudaStream_t stream) {
  if (state_global == nullptr) return cudaErrorInvalidValue;
  cudaError_t err;
  if (num_iters == 0) {
    err = launch(false, 0, SolveStop{}, 0);
    if (err != cudaSuccess) return err;
    return cudaMemsetAsync(stop.iters, 0, sizeof(int), stream);
  }
  // the ticket starts at 0 whatever the words held before
  err = cudaMemsetAsync(stop.words, 0, sizeof(unsigned long long), stream);
  if (err != cudaSuccess) return err;
  for (int k = 0; k < num_iters; ++k) {
    err = launch(true, 1, stop, k);
    if (err != cudaSuccess) return err;
    if (stop.hook != nullptr) {
      if (stop.hook(k) != 0) return cudaErrorUnknown;
      stop_decide_kernel<<<1, 1, 0, stream>>>(stop, eta, k);
      err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
  }
  const int64_t total = static_cast<int64_t>(b) * s;
  const unsigned copy_grid =
      static_cast<unsigned>(total / 256 + 1 < 1024 ? total / 256 + 1 : 1024);
  stop_writeout_kernel<<<copy_grid, 256, 0, stream>>>(state_global, b, s, sk,
                                                      out);
  return cudaGetLastError();
}

// Set the dynamic shared memory attribute of a kernel pair (the builds
// without and with the stop).
template <class Kernel>
cudaError_t set_pair_smem(Kernel plain, Kernel stopping, size_t smem) {
  cudaError_t err = cudaFuncSetAttribute(
      plain, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(stopping,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <bool FISTA, int MODE, bool GROUP>
cudaError_t launch_classic_stop(const float* gn, const float* corr,
                                const float* init, const float* eta,
                                float lam, int num_iters, int b, int s,
                                int sk, int sc, int group_size,
                                float* state_global, float* out,
                                const SolveStop& stop, cudaStream_t stream) {
  auto plain = fista_kernel<FISTA, MODE, GROUP>;
  auto stopping = fista_kernel<FISTA, MODE, GROUP, true>;
  const size_t smem = 2 * kSliceFloats * sizeof(float);
  cudaError_t err = set_pair_smem(plain, stopping, smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = static_cast<unsigned>((b + kRows - 1) / kRows);
  return drive_classic_stop(
      [&](bool with_stop, int iters, const SolveStop& st, int k0) {
        (with_stop ? stopping : plain)<<<grid, kThreads, smem, stream>>>(
            gn, corr, init, eta, lam, iters, b, s, sk, sc, group_size,
            state_global, out, st, k0);
        return cudaGetLastError();
      },
      eta, num_iters, b, s, sk, state_global, out, stop, stream);
}

// The solve at a tier other than 'highest' (fista_tier.cuh, which every
// file that instantiates launch_solve includes) on the tier route given
// (kRouteAuto: tier_route's, or with stop its stop route), the route
// taken in *taken unless it is null: the resident cluster or wide layout
// in one launch, or fold_tier_kernel and fista_tier_kernel in one launch,
// or with stop on the classic stop route.
template <bool GROUP>
cudaError_t launch_tier(int tier, int fista, int mode, const float* gram,
                        const float* corr, const float* init,
                        const float* eta, float lam, int num_iters, int b,
                        int s, int sk, int sc, int group_size, float* gn,
                        float* state_global, float* out, int route,
                        int* taken, cudaStream_t stream,
                        const SolveStop* stop);

// Launch the solve on the route given (kRouteAuto: solve_route's, or with
// stop stop_route's), and store the route taken in *taken unless it is
// null.  The classic route folds G into gn first (the other two fold
// their slices themselves); state_global null keeps its blocks' state in
// shared memory (the classic route with stop needs it).  stop null is the
// flag-off build.  A stop across ranks (stop->local) takes the classic
// route: a CUDA kernel cannot wait on another process, so no resident
// route takes it.  A tier other than kTierHighest takes fista_tier.cuh's
// routes (route kRouteAuto or one of kRouteTier, kRouteTierCluster and
// kRouteTierWide; gn then holds the bf16 planes of fista_tier.cuh's
// tier_gn_floats where fista_tier_kernel runs); across ranks its stop
// is the classic stop route's, whose state layout fista_tier_kernel
// shares.  Returns the first CUDA error.
template <bool FISTA, int MODE, bool GROUP>
cudaError_t launch_solve(const float* gram, const float* corr,
                         const float* init, const float* eta, float lam,
                         int num_iters, int b, int s, int sk, int sc,
                         int group_size, float* gn, float* state_global,
                         float* out, int route, int* taken,
                         cudaStream_t stream,
                         const SolveStop* stop = nullptr,
                         int tier = kTierHighest) {
  if (tier != kTierHighest) {
    if ((route != kRouteAuto && route < kRouteTier) ||
        (stop != nullptr && stop->local != nullptr && stop->hook == nullptr))
      return cudaErrorInvalidValue;
    return launch_tier<GROUP>(tier, FISTA, MODE, gram, corr, init, eta, lam,
                              num_iters, b, s, sk, sc, group_size, gn,
                              state_global, out, route, taken, stream, stop);
  }
  if (route > kRouteWide) return cudaErrorInvalidValue;
  if (stop != nullptr && stop->local != nullptr) {
    if (stop->hook == nullptr ||
        (route != kRouteAuto && route != kRouteClassic))
      return cudaErrorInvalidValue;
    route = kRouteClassic;
  }
  if (route == kRouteAuto) {
    route = stop == nullptr
                ? solve_route(b, sk, group_size, device_sm_count())
                : device_stop_route(b, sk, group_size);
    if (route < 0) return static_cast<cudaError_t>(-route);
  }
  if (taken != nullptr) *taken = route;
  if (route == kRouteCluster)
    return launch_cluster<FISTA, MODE, GROUP>(gram, corr, init, eta, lam,
                                              num_iters, b, s, sk,
                                              group_size, out, stream, stop);
  if (route == kRouteWide)
    return launch_wide<FISTA, MODE, GROUP>(gram, corr, init, eta, lam,
                                           num_iters, b, s, sk, group_size,
                                           out, stream, stop);
  if (route != kRouteClassic) return cudaErrorInvalidValue;
  const int64_t total = static_cast<int64_t>(sk) * sc;
  const unsigned fold_grid =
      static_cast<unsigned>(total / 256 + 1 < 1024 ? total / 256 + 1 : 1024);
  fold_gram_kernel<<<fold_grid, 256, 0, stream>>>(gram, eta, gn, s, sk, sc);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (stop != nullptr)
    return launch_classic_stop<FISTA, MODE, GROUP>(
        gn, corr, init, eta, lam, num_iters, b, s, sk, sc, group_size,
        state_global, out, *stop, stream);
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
                                           group_size, state_global, out,
                                           SolveStop{}, 0);
  return cudaGetLastError();
}

// The argument checks both entry points share: the shape, and the route
// (0-3 at 'highest', 0 or 4-6 at another tier) and the tier.
inline bool solve_args_ok(int b, int s, int num_iters, int sk, int sc,
                          int route, int tier) {
  return b > 0 && s > 0 && num_iters >= 0 && sk >= s && sc >= s &&
         sk % kChunk == 0 && sc % kColBlock == 0 && tier >= kTierHighest &&
         tier <= kTierBf16x5 && route >= kRouteAuto &&
         (tier == kTierHighest ? route <= kRouteWide
                               : route == kRouteAuto ||
                                     (route >= kRouteTier &&
                                      route <= kRouteTierWide));
}

// The early stop of a C entry's arguments: null (the flag-off build)
// unless eps >= 0, else *stop filled from them.
inline const SolveStop* solve_stop(SolveStop* stop, float eps,
                                   float inv_count, void* words, int* iters,
                                   unsigned tag, float* local,
                                   RankHook hook) {
  if (!(eps >= 0.0f)) return nullptr;
  *stop = SolveStop{eps, inv_count, static_cast<unsigned long long*>(words),
                    iters, tag, local, hook};
  return stop;
}

}  // namespace
