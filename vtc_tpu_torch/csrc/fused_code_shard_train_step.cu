// Residual-form train steps for big dictionaries, Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel K19: vtc_tpu/ops/pallas_code_shard_train.py,
// fused_code_sharded_train_segment_pallas (:484) with its kernel
// _make_cs_kernel (:233), at a code axis of size 1 and across devices (see
// "Across ranks" below).  Same contract: for
// each of the k batches X (b, n) of a segment, with the dictionary D (s, n),
// s > n, the Hessian-diagonal EMA h (s,) and the eigenvector v (n,) of the
// n x n Gram carried from step to step,
//
//   P = D^T D                                  (n, n), never D D^T
//   v = v / |v|; power_iters times v = v P / |v P|;  eta = 1 / ((v P) . v)
//   z = old = 0; num_iters times:
//     r = z D - X                              (b, n)
//     codes = prox(z - eta (r D^T), lam eta)   (b, s)
//     fista: t' = (1 + sqrt(1 + 4 t^2)) / 2;
//            z = codes + ((t-1)/t') (codes - old)
//     ista:  z = codes
//     old = codes
//   h = 0.99 h + (sum_b codes^2 * (1/b)) / 100          (cheap quadratic)
//   upd_num_iters times:
//     resid = codes D - X ; grad = codes^T resid * (1/b)
//     [+ penalty (S D - rowsum(S o C) D), C = D D^T, S = comem o sign(C)]
//     [/ (h + lowest)] ; D = D - step * grad ; rows renormalized
//
// The prox: the elementwise shrinkage (soft, nonnegative, hard), or the
// group-norm shrinkage over a disjoint partition of the s rows, each group
// scaled by max(1 - t / |g|, 0) (hard: zeroed when |g| < t).
//
// Layout: K2's (fused_train_step.cu).  Per-step kernels that one C loop per
// segment enqueues on one stream; D (2 MB at s 2048, n 256), z and old
// (1 MB each at b 128) and r (128 KB) stay in device memory, which L2
// (50 MB) holds, and the host never waits inside a segment.  Two routes
// give the same bits.  At one rank the step's solve (every FISTA
// iteration) and the update's first residual are one cooperative launch
// of code_shard_solve.cuh's code_shard_solve_kernel, the D slices
// resident in shared memory; the Gram, the power refresh and the update
// stay per-step launches.  The per-step route below (about 3 launches an
// iteration) is its bitwise reference and the route across ranks, where
// the hook runs between launches.
//
// What bounds it on this card.  A FISTA iteration is two products of
// 2 b s n FLOPs each (134 MFLOP at b 128, s 2048, n 256), 6.7 GFLOP per
// step at 25 iterations against 0.1 GFLOP of update: operations bound,
// about 0.1 ms per step at the fp32 SIMT peak.  What the design does:
//  * r = z D has a long K (s) and a small output (b x n): the shared 32 x 32
//    tile would run only 32 blocks on 132 SMs.  So it is split over s in
//    fixed chunks of kSplitK into partial sums (b x n each), and a second
//    pass adds them in order and subtracts X -- deterministic, no atomics,
//    as K12's gradient product (fused_conv_train_step.cu).  The update's
//    residual and the power Gram D^T D (K = s again) take the same split.
//  * codes = prox(z - eta r D^T) is one product kernel (b x s output, K = n)
//    with the prox and the momentum in its epilogue: each thread owns its
//    entries of z and old, so both update in place.
//  * The group prox does not port the TPU kernel's membership products
//    (2 b s g FLOPs, as much as a main product at 512 groups).  Where the
//    groups are contiguous blocks of M rows, M a power of two up to 32,
//    a group's entries sit on M neighbouring lanes of one warp in the
//    product tile, so its norm is an xor-shuffle sum in the epilogue.
//    Any other partition takes a member table: the epilogue writes the
//    pre-prox values, and one pass over (row, group) pairs takes each
//    group's norm in member order, scales its entries and moves them.
//  * At 'highest' every product is IEEE fp32 FMA on the CUDA cores
//    (train_core.cuh's tile): no TF32, no tensor cores, no library call.
//    The epilogue's arithmetic is explicitly rounded (__fmul_rn,
//    __fsub_rn, ...), so no FMA contraction changes it against the plain
//    version.
//  * At a tier (bf16x5, bf16x3, bf16; vtc_tpu _make_tier_dots, :88-117)
//    z D and r D^T run code_shard_solve.cuh's tier tile on the bf16 tensor
//    cores, one CTA a 32 x 64 tile (cs_tier_recon_kernel,
//    cs_tier_grad_kernel), so this route stays the persistent route's
//    bitwise reference; the split sum, the prox, the Gram, the refresh
//    and the update stay fp32, and the member-table prox rounds its sums
//    and scale at the tier where vtc_tpu's membership products do
//    (prox_round, group_prox_kernel's PT).
//
// Across ranks (vtc_tpu's 'code' axis above 1, optionally with a 'data'
// axis): each rank holds s rows of the dictionary (its row shard, of a
// global s * code_ranks) and b patches (its batch shard, of a global
// b * data_ranks), and the sums vtc_tpu exchanges by remote DMA inside
// its kernel (K14) become calls of the host hook between launches, each
// summing a device buffer over one axis in place, in stream order:
//  * the partial Gram D_l^T D_l, over 'code', once a step, before the
//    power refresh (vtc_tpu sums the power_iters + 1 vectors v D_l^T D_l
//    instead: the same quantity, since v P = sum_l v D_l^T D_l);
//  * the partial reconstruction z_l D_l (and the update's codes_l D_l),
//    over 'code', every iteration, before X is subtracted, as vtc_tpu
//    sums first and subtracts after;
//  * with a data axis, the Hessian statistic sum_b codes^2 and the row
//    gradient codes_l^T resid, over 'data'.
// Every rank receives the same bytes from each sum, so the stepsize, the
// eigenvector and the rows of a shard stay bitwise equal on the ranks
// that hold them.  With no hook (one rank) the launches are the ones
// above, unchanged.
//
// The early stop (vtc_tpu :387-431): after iteration j > 0 a step's solve
// ends when (sum |codes - old| over every rank's rows and batch shard) *
// inv_count / eta < eps, inv_count = 1 / stop_count (vtc_tpu :557-566).
// On the persistent route it is code_shard_solve.cuh's STOP build.  On the
// per-step route the solve's launches take the stop's arguments (CsStop,
// its words null without the stop: one uniform test at entry) and read a
// tagged stop word on entry (K12's design, conv_gemm.cuh): the prox
// launch of each iteration (grad_prox_kernel, or group_prox_kernel with a
// member table) adds |code - old| over each thread's entries in a fixed
// order, each block posts its share, and the last block to arrive (an
// acquire-release ticket) sums the shares in block order and, at one
// rank, writes the step's stop word (its tag, the count, the stop bit)
// and the count.
// Across ranks it leaves the rank's sum in a one-float buffer instead;
// the C loop sums that buffer through the hook over 'code', then over
// 'data' (vtc_tpu's order, :396-414), and cs_stop_decide_kernel decides,
// so every rank makes the same hook calls and stops at the same count.
// Every launch of a stopped step's solve returns at entry; step k's tag
// is k + 1, so one zeroed set of words serves the segment.
#include <cuda/atomic>
#include <vector>

#include "train_core.cuh"
#include "code_shard_solve.cuh"

namespace {

// The per-step route's early stop (see above).  words: [0] the stop word,
// [1] the ticket, then one share (a float) per block of the prox launch
// (vtc_code_shard_stop_words).
struct CsStop {
  unsigned long long* words;
  int* iters;       // receives the step's count
  float* local;     // across ranks: the rank's sum goes here, undecided
  float eps;
  float inv_count;  // 1 / stop_count
  unsigned tag;     // the step's tag, >= 1
  int it;           // the launch's iteration j
};
constexpr int kCsStopCtlWords = 2;

// Whether the step of st has stopped: its word carries st's tag and the
// stop bit (never without the stop, st.words null).  Every thread of a
// block reads the same word, written before the launch began, so a block
// returns whole.
__device__ __forceinline__ bool cs_stopped(const CsStop& st) {
  if (st.words == nullptr) return false;
  const unsigned long long w =
      *reinterpret_cast<volatile unsigned long long*>(st.words);
  return static_cast<unsigned>(w >> 32) == st.tag && (w & 1ull);
}

// Iteration st.it's decision on the sum over the rows and the batch: the
// count, then the word with the stop bit where (sum * inv_count) / eta <
// eps and j > 0.
__device__ __forceinline__ void cs_stop_decide(const CsStop& st, float sum,
                                               float eta) {
  const bool stop = st.it > 0 &&
                    __fdiv_rn(__fmul_rn(sum, st.inv_count), eta) < st.eps;
  *st.iters = st.it + 1;
  *reinterpret_cast<volatile unsigned long long*>(st.words) =
      (static_cast<unsigned long long>(st.tag) << 32) |
      (static_cast<unsigned long long>(st.it + 1) << 1) |
      (stop ? 1ull : 0ull);
}

// A prox launch's end, in every thread of the block: the block's share
// (its warps' butterflies in warp order) to its slot, then the last block
// to arrive sums the slots (thread t the slots t, t + blockDim.x, ... in
// turn, then its warps in order) and decides, or leaves the rank's sum in
// st.local.  That block resets the ticket for the next launch.
__device__ __forceinline__ void cs_stop_share(const CsStop& st, float delta,
                                              float eta) {
  __shared__ float warp_shares[32];
  __shared__ bool last;
  unsigned* const ticket = reinterpret_cast<unsigned*>(st.words + 1);
  float* const shares = reinterpret_cast<float*>(st.words + kCsStopCtlWords);
  const int tid = threadIdx.x;
  const unsigned blocks = gridDim.x * gridDim.y;
  delta = cs_warp_sum(delta);
  if ((tid & 31) == 0) warp_shares[tid >> 5] = delta;
  __syncthreads();
  if (tid == 0) {
    float share = 0.0f;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
      share = __fadd_rn(share, warp_shares[w]);
    shares[blockIdx.y * gridDim.x + blockIdx.x] = share;
    // release: the share before the ticket; acquire: the last block sees
    // every share, and passes them on to its threads at the barrier
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> arrivals(*ticket);
    last = arrivals.fetch_add(1u, cuda::memory_order_acq_rel) == blocks - 1;
  }
  __syncthreads();
  if (!last) return;  // the same in every thread of the block
  float sum = 0.0f;
  for (unsigned i = tid; i < blocks; i += blockDim.x)
    sum = __fadd_rn(sum, reinterpret_cast<volatile float*>(shares)[i]);
  sum = cs_warp_sum(sum);
  if ((tid & 31) == 0) warp_shares[tid >> 5] = sum;
  __syncthreads();
  if (tid == 0) {
    float total = 0.0f;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
      total = __fadd_rn(total, warp_shares[w]);
    *ticket = 0u;
    if (st.local != nullptr)
      *st.local = total;
    else
      cs_stop_decide(st, total, eta);
  }
}

// Across ranks: the decision of iteration st.it on the sum over the ranks
// in *st.local, one thread; nothing once the step stopped.
__global__ void cs_stop_decide_kernel(CsStop st, const float* eta) {
  if (cs_stopped(st)) return;
  cs_stop_decide(st, *st.local, *eta);
}

// partial[blockIdx.z] (M, N) = op(A) op(B) summed over the split's K values
// [blockIdx.z * kSplitK, +kSplitK), train_core.cuh's layouts.
template <bool TA, bool TB>
__device__ __forceinline__ void split_product(const float* __restrict__ A,
                                              const float* __restrict__ B,
                                              float* __restrict__ partial,
                                              int M, int N, int K) {
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  const int k_begin = blockIdx.z * kSplitK;
  const int k_end = K - k_begin < kSplitK ? K : k_begin + kSplitK;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  gemm_tile<TA, TB>(A, B, M, N, K, i0, j0, k_begin, k_end, acc);
  const int j = j0 + (threadIdx.x & 31);
  if (j >= N) return;
  float* out = partial + static_cast<int64_t>(blockIdx.z) * M * N;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + (threadIdx.x >> 5) * 4 + r;
    if (i < M) out[static_cast<int64_t>(i) * N + j] = acc[r];
  }
}

// out[e] = (sum over the splits, in order, of partial[split, e]) - x[e]
// (no subtraction when x is null), for e < count.
__device__ __forceinline__ void split_sum(const float* __restrict__ partial,
                                          const float* __restrict__ x,
                                          float* __restrict__ out,
                                          int splits, int64_t count) {
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       e < count; e += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    float acc = partial[e];
    for (int sp = 1; sp < splits; ++sp)
      acc = __fadd_rn(acc, partial[static_cast<int64_t>(sp) * count + e]);
    out[e] = x == nullptr ? acc : __fsub_rn(acc, x[e]);
  }
}

// Which buffer a call of the axis hook sums, and over which axis.
enum SumWhich {
  kSumGram = 0,   // pgram (n, n) over 'code'
  kSumRecon = 1,  // rbuf (b, n) over 'code': z_l D_l or codes_l D_l
  kSumStat = 2,   // stat (s,) over 'data': sum_b codes^2
  kSumGrad = 3,   // grad (s, n) over 'data': codes_l^T resid
  kSumStopCode = 4,  // the stop's local (1,) over 'code'
  kSumStopData = 5,  // the stop's local (1,) over 'data', after 'code'
};

// r[e] = r[e] - x[e]: X subtracted from a reconstruction summed over ranks.
// With the stop (st.words set): nothing once st's step stopped (so in
// every kernel of the solve below).
__global__ void subtract_x_kernel(float* __restrict__ r,
                                  const float* __restrict__ x,
                                  int64_t count, CsStop st = {}) {
  if (cs_stopped(st)) return;
  for (int64_t e = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                   threadIdx.x;
       e < count; e += static_cast<int64_t>(gridDim.x) * blockDim.x)
    r[e] = __fsub_rn(r[e], x[e]);
}

// One kernel name per product, so that a trace splits the step's time:
// the reconstruction z D, the update's residual codes D, the power Gram.
__global__ void __launch_bounds__(kGemmThreads)
    recon_partial_kernel(const float* z, const float* d, float* partial,
                         int b, int s, int n, CsStop st = {}) {
  if (cs_stopped(st)) return;
  split_product<false, false>(z, d, partial, b, n, s);
}

__global__ void __launch_bounds__(kGemmThreads)
    resid_partial_kernel(const float* codes, const float* d, float* partial,
                         int b, int s, int n) {
  split_product<false, false>(codes, d, partial, b, n, s);
}

__global__ void __launch_bounds__(kGemmThreads)
    pgram_partial_kernel(const float* d, float* partial, int s, int n) {
  split_product<true, false>(d, d, partial, n, n, s);
}

__global__ void recon_sum_kernel(const float* partial, const float* x,
                                 float* out, int splits, int64_t count,
                                 CsStop st = {}) {
  if (cs_stopped(st)) return;
  split_sum(partial, x, out, splits, count);
}

__global__ void resid_sum_kernel(const float* partial, const float* x,
                                 float* out, int splits, int64_t count) {
  split_sum(partial, x, out, splits, count);
}

__global__ void pgram_sum_kernel(const float* partial, float* out,
                                 int splits, int64_t count) {
  split_sum(partial, nullptr, out, splits, count);
}

// The FISTA / ISTA iteration after r = z D - X.
struct IterArgs {
  const float* r;    // (b, n)
  const float* d;    // (s, n)
  float* z;          // (b, s): the iterate, replaced by the next one
  float* old;        // (b, s): the previous codes, replaced by the codes
  float* pre;        // (b, s): the pre-prox values (WINDOW < 0 only)
  const float* eta;  // (1,)
  float lam;
  float beta;        // momentum (t - 1) / t' of this iteration
  int fista;
  int b, s, n;
};

// momentum_at on p's z and old; returns |code - old|.
__device__ __forceinline__ float momentum(const IterArgs& p, int64_t at,
                                          float code) {
  return momentum_at(p.z, p.old, at, code, p.beta, p.fista);
}

// u = z - eta (r D^T), a 32 x 32 tile of (b, s) per block, then
//   WINDOW == 0: codes = threshold<MODE>(u, lam eta) and the momentum;
//   WINDOW > 0:  the group prox of contiguous blocks of WINDOW columns
//                (xor-shuffle norms over WINDOW lanes) and the momentum;
//   WINDOW < 0:  pre = u, for group_prox_kernel.
// STOP (the stop's build, st.words set): with WINDOW >= 0 the block's
// |code - old| goes to cs_stop_share.  A compile-time flag in this tile
// kernel, unlike the pass kernels' test at entry: with the share's code
// behind a runtime test ptxas gave the build without the stop 32
// registers in place of 40, and a fc step of the per-step route took
// 1,045 us in place of 952 (NVIDIA H100 80GB HBM3, 700 W;
// tools/bench_code_shard_solve.cu).
template <int MODE, int WINDOW, bool STOP>
__global__ void __launch_bounds__(kGemmThreads)
    grad_prox_kernel(IterArgs p, CsStop st) {
  if (STOP && cs_stopped(st)) return;
  constexpr bool share = STOP && WINDOW >= 0;
  const int tx = threadIdx.x & 31;
  const int ty = threadIdx.x >> 5;
  const int i0 = blockIdx.y * kTile;
  const int j0 = blockIdx.x * kTile;
  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  gemm_tile<false, true>(p.r, p.d, p.b, p.s, p.n, i0, j0, 0, p.n, acc);
  const float eta = *p.eta;
  const float lam_eta = __fmul_rn(p.lam, eta);
  const int j = j0 + tx;
  float delta = 0.0f;  // with the stop: this thread's |code - old|
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty * 4 + r;
    const bool inside = i < p.b && j < p.s;
    const int64_t at = static_cast<int64_t>(i) * p.s + j;
    const float u =
        inside ? __fsub_rn(p.z[at], __fmul_rn(eta, acc[r])) : 0.0f;
    if (WINDOW < 0) {
      if (inside) p.pre[at] = u;
    } else if (WINDOW == 0) {
      if (inside) {
        const float moved = momentum(p, at, threshold<MODE>(u, lam_eta));
        if (share) delta = __fadd_rn(delta, moved);
      }
    } else {
      // every lane takes part: outside entries add zeros
      float sq = __fmul_rn(u, u);
#pragma unroll
      for (int off = 1; off < WINDOW; off <<= 1)
        sq = __fadd_rn(sq, __shfl_xor_sync(0xffffffffu, sq, off));
      if (inside) {
        const float moved = momentum(
            p, at, __fmul_rn(u, group_scale<MODE>(sqrtf(sq), lam_eta)));
        if (share) delta = __fadd_rn(delta, moved);
      }
    }
  }
  if constexpr (share) cs_stop_share(st, delta, eta);
}

// The group prox of any partition: one thread per (row, group); members
// (groups, width) lists each group's rows ascending, padded with -1.  PT >
// 0: the sums and the scale rounded at a tier as vtc_tpu's membership
// products round them (code_shard_solve.cuh's CsMemberSum).  With the stop
// the block's |code - old| goes to cs_stop_share.
template <int MODE, int PT = 0>
__global__ void group_prox_kernel(IterArgs p, const int* __restrict__ members,
                                  int groups, int width, CsStop st) {
  if (cs_stopped(st)) return;
  const bool share = st.words != nullptr;
  const float eta = *p.eta;
  const float lam_eta = __fmul_rn(p.lam, eta);
  float delta = 0.0f;  // with the stop: this thread's |code - old|
  const int64_t total = static_cast<int64_t>(p.b) * groups;
  for (int64_t idx = blockIdx.x * static_cast<int64_t>(blockDim.x) +
                     threadIdx.x;
       idx < total; idx += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int64_t row = idx / groups;
    const int* list = members + (idx - row * groups) * width;
    const int64_t base = row * p.s;
    CsMemberSum<PT> sq;
    for (int m = 0; m < width && list[m] >= 0; ++m)
      sq.add(p.pre[base + list[m]]);
    const float scale =
        CsMemberSum<PT>::scale(group_scale<MODE>(sqrtf(sq.total()), lam_eta));
    for (int m = 0; m < width && list[m] >= 0; ++m) {
      const float moved = momentum(
          p, base + list[m], __fmul_rn(p.pre[base + list[m]], scale));
      if (share) delta = __fadd_rn(delta, moved);
    }
  }
  if (share) cs_stop_share(st, delta, eta);
}

// One FISTA iteration's prox launches after r is formed, with st's stop
// for its step and iteration (none: st.words null).
cudaError_t launch_iteration(const IterArgs& p, int mode, int window,
                             const int* members, int groups, int width,
                             cudaStream_t stream, const CsStop& st = {}) {
  const dim3 grid((p.s + kTile - 1) / kTile, (p.b + kTile - 1) / kTile);
  const bool stopping = st.words != nullptr;
#define VTC_ITER(M, W)                                                 \
  do {                                                                 \
    void (*kernel)(IterArgs, CsStop) = grad_prox_kernel<M, W, false>;  \
    if (stopping) kernel = grad_prox_kernel<M, W, true>;               \
    kernel<<<grid, kGemmThreads, 0, stream>>>(p, st);                  \
  } while (0)
  const bool hard = mode == kHard;
  if (members != nullptr) {
    VTC_ITER(kSoft, -1);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    const unsigned blocks = pass_grid(static_cast<int64_t>(p.b) * groups);
    if (hard)
      group_prox_kernel<kHard><<<blocks, kPassThreads, 0, stream>>>(
          p, members, groups, width, st);
    else
      group_prox_kernel<kSoft><<<blocks, kPassThreads, 0, stream>>>(
          p, members, groups, width, st);
  } else if (window == 0) {
    if (mode == kSoft) VTC_ITER(kSoft, 0);
    else if (mode == kSoftNonneg) VTC_ITER(kSoftNonneg, 0);
    else if (mode == kHard) VTC_ITER(kHard, 0);
    else VTC_ITER(kHardNonneg, 0);
  } else {
#define VTC_WINDOW(W)                   \
  if (window == W) {                    \
    if (hard) VTC_ITER(kHard, W);       \
    else VTC_ITER(kSoft, W);            \
  }
    VTC_WINDOW(1)
    VTC_WINDOW(2)
    VTC_WINDOW(4)
    VTC_WINDOW(8)
    VTC_WINDOW(16)
    VTC_WINDOW(32)
#undef VTC_WINDOW
  }
#undef VTC_ITER
  return cudaGetLastError();
}

// The per-step route at a tier: the persistent solve's tier tiles
// (code_shard_solve.cuh), one CTA a tile, so both routes give the same
// bits.  cs_tier_recon_kernel: phase-A tile blockIdx.x, the partials of z
// D; cs_tier_grad_kernel: phase-B tile blockIdx.x, u = z - eta (r D^T) and
// its epilogue (a member table: pre = u, for group_prox_kernel), with STOP
// the block's share to cs_stop_share.  Each splits its D slice afresh.
template <int TIER>
using CsStepSmem = CsTierSmem<tier_terms(TIER), 1>;

template <int TIER>
__global__ void __launch_bounds__(kCsThreads)
    cs_tier_recon_kernel(SolveArgs p, CsStop st) {
  if (cs_stopped(st)) return;
  extern __shared__ __align__(16) unsigned char cs_step_smem[];
  auto& sm = *reinterpret_cast<CsStepSmem<TIER>*>(cs_step_smem);
  int key = -1;
  cs_tier_a_tile<tier_terms(TIER)>(sm, sm.planes[0], p, cs_copy_mode(p), p.z,
                                   blockIdx.x, key);
}

template <int TIER, bool STOP>
__global__ void __launch_bounds__(kCsThreads)
    cs_tier_grad_kernel(SolveArgs p, float beta, CsStop st) {
  if (STOP && cs_stopped(st)) return;
  extern __shared__ __align__(16) unsigned char cs_step_smem[];
  auto& sm = *reinterpret_cast<CsStepSmem<TIER>*>(cs_step_smem);
  const bool share = STOP && p.members == nullptr;
  const float eta = *p.eta;
  float delta = 0.0f;
  int key = -1;
  cs_tier_b_tile<tier_terms(TIER)>(sm, sm.planes[0], p, cs_copy_mode(p),
                                   blockIdx.x, eta, __fmul_rn(p.lam, eta),
                                   beta, key, share, delta);
  if (share) cs_stop_share(st, delta, eta);
}

// Launch KERNEL on blocks CTAs with the per-step tier smem of TIER, its
// dynamic shared memory opted in once a device.
template <int TIER, auto KERNEL, class... Args>
cudaError_t cs_tier_launch(int blocks, cudaStream_t stream, Args... args) {
  static bool opted[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  constexpr int smem = static_cast<int>(sizeof(CsStepSmem<TIER>));
  if (!opted[dev]) {
    err = cudaFuncSetAttribute(
        KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted[dev] = true;
  }
  KERNEL<<<blocks, kCsThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int TIER>
cudaError_t cs_tier_iteration_at(const SolveArgs& sa, const IterArgs& p,
                                 int mode, int prox_round, const int* members,
                                 int groups, int width, cudaStream_t stream,
                                 const CsStop& st, bool recon) {
  if (recon)
    return cs_tier_launch<TIER, cs_tier_recon_kernel<TIER>>(
        cs_tiles_a(sa.b, sa.s, sa.n), stream, sa, st);
  const int blocks = cs_tiles_b(sa.b, sa.s);
  cudaError_t err =
      st.words != nullptr
          ? cs_tier_launch<TIER, cs_tier_grad_kernel<TIER, true>>(
                blocks, stream, sa, p.beta, st)
          : cs_tier_launch<TIER, cs_tier_grad_kernel<TIER, false>>(
                blocks, stream, sa, p.beta, st);
  if (err != cudaSuccess || members == nullptr) return err;
  const unsigned pass = pass_grid(static_cast<int64_t>(p.b) * groups);
  constexpr int kPt = tier_terms(TIER);
  if (mode == kHard) {
    if (prox_round)
      group_prox_kernel<kHard, kPt><<<pass, kPassThreads, 0, stream>>>(
          p, members, groups, width, st);
    else
      group_prox_kernel<kHard><<<pass, kPassThreads, 0, stream>>>(
          p, members, groups, width, st);
  } else if (prox_round) {
    group_prox_kernel<kSoft, kPt><<<pass, kPassThreads, 0, stream>>>(
        p, members, groups, width, st);
  } else {
    group_prox_kernel<kSoft><<<pass, kPassThreads, 0, stream>>>(
        p, members, groups, width, st);
  }
  return cudaGetLastError();
}

// One launch of the per-step route at the tier: with recon the partials of
// z D (cs_tier_recon_kernel), else the iteration's prox launches after r is
// formed (cs_tier_grad_kernel, then group_prox_kernel with a member table,
// its sums rounded where prox_round).
cudaError_t cs_tier_iteration(int tier, const SolveArgs& sa,
                              const IterArgs& p, int mode, int prox_round,
                              const int* members, int groups, int width,
                              cudaStream_t stream, const CsStop& st,
                              bool recon) {
  if (tier == kTierBf16)
    return cs_tier_iteration_at<kTierBf16>(sa, p, mode, prox_round, members,
                                           groups, width, stream, st, recon);
  if (tier == kTierBf16x3)
    return cs_tier_iteration_at<kTierBf16x3>(sa, p, mode, prox_round,
                                             members, groups, width, stream,
                                             st, recon);
  return cs_tier_iteration_at<kTierBf16x5>(sa, p, mode, prox_round, members,
                                           groups, width, stream, st, recon);
}

}  // namespace

extern "C" {

// K values per split of the long-K products: the wrapper sizes its
// partial-sum scratch with it.
int vtc_code_shard_split_k() { return kSplitK; }

// The persistent solve's layout (code_shard_solve.cuh): kCsTileM,
// kCsTileN, kCsDepth, kCsSlice, kCsThreads, kSplitK.
void vtc_code_shard_layout(int* out) {
  out[0] = kCsTileM;
  out[1] = kCsTileN;
  out[2] = kCsDepth;
  out[3] = kCsSlice;
  out[4] = kCsThreads;
  out[5] = kSplitK;
}

int vtc_code_shard_sm_count() { return cs_sm_count(); }
int vtc_code_shard_blocks_per_sm() { return cs_blocks_per_sm(); }

// The persistent solve's dynamic shared memory at the tier (bytes), and
// the most a CTA of the current device may opt into.
int vtc_code_shard_smem(int tier) { return cs_solve_smem(tier); }
int vtc_code_shard_smem_limit() {
  int dev = 0, limit = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return limit;
}

// The persistent solve's CTAs at (b, s, n) on the current device (0 for
// an empty shape).
int vtc_code_shard_grid(int b, int s, int n) {
  if (b < 1 || s < 1 || n < 1) return 0;
  return cs_grid(b, s, n, cs_sm_count(), cs_blocks_per_sm());
}

// Grid barriers in one step of the persistent solve.
int vtc_code_shard_barriers(int num_iters, int members, int resid) {
  return cs_step_barriers(num_iters, members, resid);
}

// The 64-bit words of the per-step route's stop at (b, s) with groups
// member-table groups (0: none): the stop word, the ticket and one share
// per block of the iteration's prox launch.
int64_t vtc_code_shard_stop_words(int b, int s, int groups) {
  const int64_t blocks =
      groups > 0 ? pass_grid(static_cast<int64_t>(b) * groups)
                 : static_cast<int64_t>((s + kTile - 1) / kTile) *
                       ((b + kTile - 1) / kTile);
  return kCsStopCtlWords + blocks;
}

// k residual-form train steps on one stream, every launch enqueued before
// returning.
//
// In place: d (s, n), h (s,), v (n,), the rank's shards; x (k, b, n).  The
// global dictionary has more rows than columns: s * code_ranks > n.  The
// prox:
// window > 0 (1, 2, 4, ..., 32) for groups that are contiguous blocks of
// window rows; else members (groups, width) int32 on the device for any
// other partition; else (both 0 / null) the elementwise shrinkage of mode
// (0 soft, 1 nonnegative soft, 2 hard, 3 nonnegative hard; groups take 0
// or 2).  comem (s, s) the co-membership counts, or null for no
// regularizer.  Scratch: pgram (n, n); partial (ceil(s / kSplitK) *
// max(b, n) * n); rbuf (b, n); z, old (b, s); pre (b, s) with members;
// grad (s, n); cmat, smat (s, s) and sd (s, n) with comem; eta (1,).  The
// last step's codes are in old on return.  update: 0 steepest, 1 cheap
// quadratic.  inv_b is 1 / (b * data_ranks).  Across ranks (code_ranks or
// data_ranks above 1) hook sums the buffers of SumWhich in place, stat
// (s,) being the Hessian statistic's scratch with data_ranks above 1.
//
// persistent 0 runs each FISTA iteration as per-step launches (the route
// the hook needs between them); 1 runs a step's solve and the update's
// first residual as one cooperative launch of code_shard_solve_kernel on
// grid CTAs (0: vtc_code_shard_grid), one rank only, with betas
// (num_iters,) and barrier (2,) unsigned device scratch.
// Both give the same bits.
//
// The early stop of every step's solve: eps >= 0 turns it on, with
// inv_count = 1 / stop_count and iters (k,), each step's count; the
// persistent route takes stop_slots (2 * grid floats), the per-step route
// the zeroed stop_words of vtc_code_shard_stop_words and, across ranks,
// stop_local (1,), which the hook sums as kSumStopCode and kSumStopData.
// tier (tier_codes.cuh) is the tier of the solve's two products on both
// routes (kTierHighest: the float32 kernels); prox_round (a tier with a
// member table only) rounds the member-table prox's sums and scale at the
// tier, as vtc_tpu's membership products do (its rotate window, and a
// table that stands for it, stays float32).
// Returns the first CUDA error code (0 on success; a grid the card cannot
// hold at once is refused, cudaErrorCooperativeLaunchTooLarge), or
// kSumHookFailed.
int vtc_code_shard_train_segment(
    float* d, float* h, float* v, const float* x, int k, int b, int s, int n,
    int window, const int* members, int groups, int width,
    const float* comem, float penalty, float lam, int num_iters,
    float upd_step, int upd_num_iters, float lowest, int fista, int mode,
    int update, int renorm, int power_iters, float inv_b, float* pgram,
    float* partial, float* rbuf, float* z, float* old, float* pre,
    float* grad, float* cmat, float* smat, float* sd, float* eta,
    int code_ranks, int data_ranks, float* stat, AxisSumHook hook,
    int persistent, int grid, float* betas, unsigned* barrier, float eps,
    float inv_count, void* stop_words, int* iters, float* stop_slots,
    float* stop_local, int tier, int prox_round, void* stream_ptr) {
  const bool code_sum = code_ranks > 1;
  const bool data_sum = data_ranks > 1;
  const bool stopping = eps >= 0.0f;
  if (k < 0 || b <= 0 || s <= 0 || n <= 0 || code_ranks < 1 ||
      data_ranks < 1 || static_cast<int64_t>(s) * code_ranks <= n ||
      ((code_sum || data_sum) && hook == nullptr) ||
      (data_sum && stat == nullptr) || num_iters < 0 ||
      upd_num_iters < 0 || power_iters < 0 || mode < 0 || mode > 3 ||
      window < 0 || window > 32 || (window & (window - 1)) != 0 ||
      (window > 0 && (members != nullptr || s % window != 0)) ||
      (members != nullptr && (pre == nullptr || groups < 1 || width < 1)) ||
      (comem != nullptr &&
       (cmat == nullptr || smat == nullptr || sd == nullptr)) ||
      grid < 0 ||
      (persistent && (code_sum || data_sum || barrier == nullptr ||
                      (num_iters > 0 && betas == nullptr))) ||
      (stopping &&
       (iters == nullptr || (persistent && stop_slots == nullptr) ||
        (!persistent && stop_words == nullptr) ||
        ((code_sum || data_sum) && stop_local == nullptr))) ||
      tier < kTierHighest || tier > kTierBf16x5 ||
      (prox_round && (tier == kTierHighest || members == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int splits = (s + kSplitK - 1) / kSplitK;
  const int64_t codes_bytes = sizeof(float) * static_cast<int64_t>(b) * s;
  const dim3 bn_grid((n + kTile - 1) / kTile, (b + kTile - 1) / kTile,
                     splits);
  const dim3 nn_grid((n + kTile - 1) / kTile, (n + kTile - 1) / kTile,
                     splits);
  const int64_t bn = static_cast<int64_t>(b) * n;
  const int64_t nn = static_cast<int64_t>(n) * n;
  cudaError_t err = power_setup(n);
  if (err != cudaSuccess) return static_cast<int>(err);
#define VTC_CHECK(...)                                    \
  do {                                                    \
    err = (__VA_ARGS__);                                  \
    if (err != cudaSuccess) return static_cast<int>(err); \
  } while (0)
#define VTC_LAUNCHED() VTC_CHECK(cudaGetLastError())
#define VTC_SUM(WHICH) \
  if (hook(step, WHICH) != 0) return kSumHookFailed
  // the momentum of each iteration, the same floats on both routes
  std::vector<float> beta_of(num_iters);
  float t = 1.0f;
  for (int iter = 0; iter < num_iters; ++iter) {
    const float t_next = (1.0f + sqrtf(1.0f + 4.0f * t * t)) / 2.0f;
    beta_of[iter] = (t - 1.0f) / t_next;
    t = t_next;
  }
  IterArgs it = {};
  it.r = rbuf;
  it.d = d;
  it.z = z;
  it.old = old;
  it.pre = pre;
  it.eta = eta;
  it.lam = lam;
  it.fista = fista;
  it.b = b;
  it.s = s;
  it.n = n;
  // the solve's arguments: the persistent launch's, and the per-step
  // route's tier kernels'
  SolveArgs sa = {};
  unsigned barrier_base = 0;
  if (persistent && k > 0) {
    if (grid == 0) grid = vtc_code_shard_grid(b, s, n);
    if (stopping && grid > 32 * kCsStopLaneSlots)
      return static_cast<int>(cudaErrorInvalidConfiguration);
    if (num_iters > 0)
      VTC_CHECK(cudaMemcpyAsync(betas, beta_of.data(),
                                sizeof(float) * num_iters,
                                cudaMemcpyHostToDevice, stream));
    VTC_CHECK(cudaMemsetAsync(barrier, 0, 2 * sizeof(unsigned), stream));
  }
  {
    sa.d = d;
    sa.z = z;
    sa.old = old;
    sa.pre = pre;
    sa.partial = partial;
    sa.r = rbuf;
    sa.eta = eta;
    sa.betas = betas;
    sa.members = members;
    sa.barrier = barrier;
    sa.lam = lam;
    sa.fista = fista;
    sa.mode = mode;
    sa.window = window;
    sa.groups = groups;
    sa.width = width;
    sa.b = b;
    sa.s = s;
    sa.n = n;
    sa.num_iters = num_iters;
    sa.resid = upd_num_iters > 0;
    sa.eps = eps;
    sa.inv_count = inv_count;
    sa.slots = stop_slots;
    sa.prox_round = prox_round;
  }
  CsStop stop = {};  // the per-step route's early stop
  if (stopping && !persistent) {
    stop.words = static_cast<unsigned long long*>(stop_words);
    stop.local = code_sum || data_sum ? stop_local : nullptr;
    stop.eps = eps;
    stop.inv_count = inv_count;
  }
  for (int step = 0; step < k; ++step) {
    const float* xs = x + static_cast<int64_t>(step) * b * n;
    // the stepsize: the n x n Gram and the warm power refresh
    pgram_partial_kernel<<<nn_grid, kGemmThreads, 0, stream>>>(d, partial, s,
                                                                n);
    VTC_LAUNCHED();
    pgram_sum_kernel<<<pass_grid(nn), kPassThreads, 0, stream>>>(
        partial, pgram, splits, nn);
    VTC_LAUNCHED();
    if (code_sum) VTC_SUM(kSumGram);
    VTC_CHECK(power_refresh(pgram, v, eta, n, power_iters, stream));
    if (persistent) {
      // the solve and the update's first residual, one launch
      sa.x = xs;
      sa.barrier_base = barrier_base;
      sa.iters = stopping ? iters + step : nullptr;
      // with the stop the kernel carries the base on the device: a
      // stopped step passes fewer barriers than cs_step_barriers counts
      VTC_CHECK(launch_code_shard_solve(sa, grid, stream, stopping, tier));
      barrier_base += static_cast<unsigned>(
          cs_step_barriers(num_iters, members != nullptr, sa.resid) * grid);
    } else {
      // the solve, from zero codes
      VTC_CHECK(cudaMemsetAsync(z, 0, codes_bytes, stream));
      VTC_CHECK(cudaMemsetAsync(old, 0, codes_bytes, stream));
      if (stopping && num_iters == 0)
        VTC_CHECK(cudaMemsetAsync(iters + step, 0, sizeof(int), stream));
      stop.iters = stopping ? iters + step : nullptr;
      stop.tag = static_cast<unsigned>(step) + 1u;
      for (int iter = 0; iter < num_iters; ++iter) {
        it.beta = beta_of[iter];
        stop.it = iter;
        if (tier != kTierHighest) {
          sa.x = xs;
          VTC_CHECK(cs_tier_iteration(tier, sa, it, mode, prox_round,
                                      members, groups, width, stream, stop,
                                      true));
        } else {
          recon_partial_kernel<<<bn_grid, kGemmThreads, 0, stream>>>(
              z, d, partial, b, s, n, stop);
          VTC_LAUNCHED();
        }
        recon_sum_kernel<<<pass_grid(bn), kPassThreads, 0, stream>>>(
            partial, code_sum ? nullptr : xs, rbuf, splits, bn, stop);
        VTC_LAUNCHED();
        if (code_sum) {
          VTC_SUM(kSumRecon);
          subtract_x_kernel<<<pass_grid(bn), kPassThreads, 0, stream>>>(
              rbuf, xs, bn, stop);
          VTC_LAUNCHED();
        }
        if (tier != kTierHighest)
          VTC_CHECK(cs_tier_iteration(tier, sa, it, mode, prox_round,
                                      members, groups, width, stream, stop,
                                      false));
        else
          VTC_CHECK(launch_iteration(it, mode, window, members, groups,
                                     width, stream, stop));
        if (stop.local != nullptr) {
          // the rank's share over 'code', then over 'data', then decided
          if (code_sum) VTC_SUM(kSumStopCode);
          if (data_sum) VTC_SUM(kSumStopData);
          cs_stop_decide_kernel<<<1, 1, 0, stream>>>(stop, eta);
          VTC_LAUNCHED();
        }
      }
    }
    if (update == 1 && data_sum) {
      VTC_CHECK(column_sumsq(old, stat, b, s, stream));
      VTC_SUM(kSumStat);
      VTC_CHECK(hessian_from_stat(stat, h, s,
                                  static_cast<float>(b) * data_ranks,
                                  stream));
    } else if (update == 1) {
      VTC_CHECK(hessian_ema(old, h, b, s, inv_b, stream));
    }
    for (int u = 0; u < upd_num_iters; ++u) {
      // the persistent route's launch left the first residual in rbuf
      if (!persistent || u > 0) {
        resid_partial_kernel<<<bn_grid, kGemmThreads, 0, stream>>>(
            old, d, partial, b, s, n);
        VTC_LAUNCHED();
        resid_sum_kernel<<<pass_grid(bn), kPassThreads, 0, stream>>>(
            partial, code_sum ? nullptr : xs, rbuf, splits, bn);
        VTC_LAUNCHED();
        if (code_sum) {
          VTC_SUM(kSumRecon);
          subtract_x_kernel<<<pass_grid(bn), kPassThreads, 0, stream>>>(
              rbuf, xs, bn);
          VTC_LAUNCHED();
        }
      }
      VTC_CHECK(gemm<true, false>(old, rbuf, nullptr, grad, s, n, b, stream));
      if (data_sum) VTC_SUM(kSumGrad);
      if (comem == nullptr) {
        VTC_CHECK(update_rows<false>(d, grad, h, AlignmentReg{}, s, n, inv_b,
                                     upd_step, lowest, update == 1,
                                     renorm != 0, stream));
        continue;
      }
      VTC_CHECK(gemm<false, true>(d, d, nullptr, cmat, s, s, n, stream));
      sign_mask_kernel<<<pass_grid(static_cast<int64_t>(s) * s),
                         kPassThreads, 0, stream>>>(
          comem, cmat, smat, static_cast<int64_t>(s) * s);
      VTC_LAUNCHED();
      VTC_CHECK(gemm<false, false>(smat, d, nullptr, sd, s, n, s, stream));
      VTC_CHECK(update_rows<true>(d, grad, h,
                                  AlignmentReg{sd, smat, cmat, penalty}, s,
                                  n, inv_b, upd_step, lowest, update == 1,
                                  renorm != 0, stream));
    }
  }
#undef VTC_SUM
#undef VTC_LAUNCHED
#undef VTC_CHECK
  return 0;
}

}  // extern "C"
