// Gathered fp32 GEMM for the convolutional solves (K10 and K11) and the
// conv train steps (K12, K13 and K17), CUDA C++ for Hopper (sm_90a).
//
// Every product of the conv iteration is one shape:
//
//   C[m, n] = sum_k A[m, k] * src[b(n), k % C, Y(n) + oy(k), X(n) + ox(k)]
//
// with A a small weight matrix (s or c*sv*sh rows, a few hundred deep),
// n a code or image-block position (b, Y, X) and k = o * C + ch running
// over the offsets o of a tile's neighbourhood and the channels ch of the
// source.  Reads outside the source are zeros.  K10's synthesis, its
// analysis and its corr = A(mask * X), K12's residual, and K11's Gram
// operator are all instances: they differ in A, in the offset decode of
// k, in which positions n run and in the epilogue, one __device__
// function every kernel calls.
//
// Implicit GEMMs, no materialized shifted stack, plain fp32 FMA on the
// SIMT units (no tensor cores, no TF32, no library):
//
// * gather_gemm_tiled, for K up to kTableMaxK: a 64 x BN tile of C per
//   block of 128 threads, BN = 128 (8 x 8 outputs a thread, as two
//   4-wide groups in m and in n, so a k step is 4 conflict-free float4
//   shared reads for 64 FMAs) or, when 128-wide tiles would not give
//   every SM two blocks, BN = 64 (4 x 8 a thread).  16-deep slices of A
//   and of the gathered source pass through a two-stage cp.async ring:
//   slice k+1 is copied while slice k is computed.  Every gathered
//   element is one 4-byte cp.async whose source size is 0 where the
//   position lies outside the source, n >= N or k >= K (a zero fill, no
//   branch around the copy).  The offset decode of k (source offset of
//   (channel, dy, dx), and dy, dx for the bounds test) is a table in
//   shared memory, built once per block.
// * gather_gemm, for larger K (K10's and K12's products where R * s or
//   R * c*sv*sh exceeds kTableMaxK): a 64 x 64 tile (256 threads, 4 x 4
//   each), synchronous 16-deep slices.  No configuration of the repo
//   reaches it; chip_smoke.py phases 13 and 44 run K10 at K = 4,320 (480
//   kernels of 12x12 at stride 4) to hold it to the plain version.
// * gram_class_gemm (conv_gram_tiles.cuh), K11's operator: the tiled
//   kernel's tile and ring over a plan of positions grouped by border
//   class, one to four passes a tile, any K.
//
// Each sums every output over k in increasing order with one fmaf chain
// from 0, so for the same inputs they give the same bits.
// launch_gather_gemm picks between the first two.
//
// The early stop (STOP, vtc_tpu's pallas_conv_direct.py:307-334 and
// pallas_conv_train.py:320-344).  After iteration k (from 0) a solve
// stops when (sum |codes_k - codes_{k-1}| * inv_count) / eta < eps and
// k > 0, and returns codes_k.  The conv state lives in device memory and
// the host enqueues every iteration's launches without waiting, so the
// stop is a word in device memory that the launches still queued read:
//  * the kProx launch of iteration k adds |codes - old| over each
//    thread's outputs in a fixed order, sums its block's threads in a
//    fixed order into one share per tile, and the last block to arrive
//    (an acquire-release atomic ticket) sums the shares in a fixed order
//    and writes the solve's stop word (its tag, the count k + 1
//    and the stop bit) and the count.  No float atomics: every run takes
//    the same decision from the same bits;
//  * every STOP launch of the solve (synthesis, analysis, K11's one
//    launch) reads the word on entry and, once the word
//    carries the solve's tag and the stop bit, returns before it reads or
//    writes any state (the read's latency hides behind the block's
//    set-up).  old then holds codes_k.
// A word tagged by another solve (a lower tag) reads as no stop, so one
// zeroed set of words serves every solve of a segment.  With STOP off the
// kernels are the code above, bitwise and no slower.  K17 at a world
// above one leaves the rank's sum in stop.local instead of deciding; the
// C loop sums it over the ranks and conv_stop_decide_kernel decides.
#pragma once

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <cstdlib>

// Internal linkage: each .cu that includes this gets its own copy.
namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;
// gather_gemm_tiled: threads per block, and the largest K its offset
// table (8 bytes an entry) takes
constexpr int kTileThreads = 128;
constexpr int kTableMaxK = 4096;
// the narrowest output row the tier GEMM's window route takes (a tile is
// one or more whole rows), which sizes the stop's shares
constexpr int kWindowMinOutW = 16;

// epilogues: what a block does with its tile of C at output index idx
enum Epilogue {
  kStore = 0,          // out = acc
  kMaskStore = 1,      // out = acc * mask[m, Y, X]
  kProx = 5,           // the ISTA/FISTA update, see below
  kMaskResid = 6,      // out = acc * mask[m, Y, X] - extra[idx] (K12)
};

// shrink modes, as ops/thresholds.select (nonneg, hard)
enum Shrink { kSoft = 0, kSoftNonneg = 1, kHard = 2, kHardNonneg = 3 };

// The early stop's arguments (see "The early stop" above).  words: the
// zeroed device array of conv_stop_words() 64-bit words, word 0 the stop
// word, word 1 the ticket, the shares (one float a tile) after them.
struct ConvStop {
  unsigned long long* words;
  int* iters;      // receives the iterations the solve ran
  float* local;    // or null; else the rank's sum goes here, undecided
  float eps;
  float inv_count;  // 1 / (b s code_h code_w), the global b across ranks
  unsigned tag;     // the solve's tag, >= 1, rising from solve to solve
  int it;           // the launch's iteration k
};

constexpr int kStopCtlWords = 2;  // the stop word and the ticket

struct GemmArgs {
  // A, (m x k) row-major
  const float* a;
  int m, k;
  // gathered source (nb, src_c, src_h, src_w); offset o = k / src_c sits
  // at (sign * (o / off_w) + off_y0, sign * (o % off_w) + off_x0)
  const float* src;
  int src_c, src_h, src_w;
  int off_w, sign, off_y0, off_x0;
  // output (nb, m, out_h, out_w), every position
  int nb, out_h, out_w;
  int epilogue;
  float* out;
  const float* mask;    // kMaskStore: (m, out_h, out_w)
  // kProx: out receives the next z; g = acc - corr,
  // codes = shrink(z_cur - eta * g, lam * eta), written to old
  const float* z_cur;
  const float* corr;
  const float* extra;   // kMaskResid: the subtrahend
  float* old;
  const float* eta;
  float lam, beta;
  int fista, shrink;
  ConvStop stop;  // STOP builds only
};

__device__ __forceinline__ float shrink_value(float x, float t, int mode) {
  switch (mode) {
    case kSoft: {
      float v = fmaxf(__fsub_rn(fabsf(x), t), 0.f);
      return x > 0.f ? v : (x < 0.f ? -v : 0.f);
    }
    case kSoftNonneg: return fmaxf(__fsub_rn(x, t), 0.f);
    case kHard: return fabsf(x) < t ? 0.f : x;
    default: return x < t ? 0.f : x;
  }
}

// Position n of the output, (b, y, x) with n = (b * out_h + y) * out_w
// + x, or false past the last one.
__device__ __forceinline__ bool decode_position(const GemmArgs& p,
                                                long long n, int len, int* b,
                                                int* y, int* x) {
  if (n >= static_cast<long long>(p.nb) * len) return false;
  *b = static_cast<int>(n / len);
  const int t = static_cast<int>(n - static_cast<long long>(*b) * len);
  *y = t / p.out_w;
  *x = t - *y * p.out_w;
  return true;
}

// The epilogue, one function pair every kernel calls.  epilogue_load
// reads what the epilogue needs at output index idx (mask index midx);
// epilogue_store combines it with v = C[m, n] and writes.  A
// kernel may load several outputs' inputs before storing any: outputs
// never share an index.  eta and thresh = lam * eta are read once per
// block (kProx).
struct EpiIn {
  float v0, v1, v2;
};

__device__ __forceinline__ EpiIn epilogue_load(const GemmArgs& p,
                                               long long idx,
                                               long long midx) {
  EpiIn in = {0.f, 0.f, 0.f};
  switch (p.epilogue) {
    case kMaskStore: in.v0 = p.mask[midx]; break;
    case kMaskResid:
      in.v0 = p.mask[midx];
      in.v1 = p.extra[idx];
      break;
    case kProx:
      in.v0 = p.z_cur[idx];
      in.v1 = p.corr[idx];
      in.v2 = p.old[idx];
      break;
    default: break;
  }
  return in;
}

// STOP: a kProx output also adds |codes - old| to *delta.
template <bool STOP = false>
__device__ __forceinline__ void epilogue_store(const GemmArgs& p,
                                               long long idx, float v,
                                               const EpiIn& in, float eta,
                                               float thresh,
                                               float* delta = nullptr) {
  switch (p.epilogue) {
    case kStore: p.out[idx] = v; break;
    case kMaskStore: p.out[idx] = v * in.v0; break;
    case kMaskResid: p.out[idx] = __fsub_rn(__fmul_rn(v, in.v0), in.v1); break;
    default: {
      const float g = __fsub_rn(v, in.v1);
      const float codes =
          shrink_value(__fsub_rn(in.v0, __fmul_rn(eta, g)), thresh, p.shrink);
      const float next =
          p.fista ? __fadd_rn(codes, __fmul_rn(p.beta, __fsub_rn(codes, in.v2)))
                  : codes;
      if constexpr (STOP)
        *delta = __fadd_rn(*delta, fabsf(__fsub_rn(codes, in.v2)));
      p.old[idx] = codes;
      p.out[idx] = next;
    }
  }
}

// The early stop (see above).  The solve's stop word, and whether it
// says the solve of st has stopped: it carries st's tag and the stop bit.
// Every thread of a block reads the same word, written before the launch
// began, so a block returns whole.
__device__ __forceinline__ unsigned long long conv_stop_word(
    const ConvStop& st) {
  return *reinterpret_cast<volatile unsigned long long*>(st.words);
}

__device__ __forceinline__ bool conv_stopped(const ConvStop& st,
                                             unsigned long long w) {
  return static_cast<unsigned>(w >> 32) == st.tag && (w & 1ull);
}

// The sum of v over the 32 lanes of a warp by an xor butterfly: the same
// bits in every lane, and from run to run.
__device__ __forceinline__ float conv_warp_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, m));
  return v;
}

// Iteration st.it's decision on the batch-global sum of |codes - old|:
// the count, then the word with the stop bit where (sum * inv_count) /
// eta < eps and k > 0, as vtc_tpu associates it.
__device__ __forceinline__ void conv_stop_decide(const ConvStop& st,
                                                 float sum, float eta) {
  const bool stop = st.it > 0 &&
                    __fdiv_rn(__fmul_rn(sum, st.inv_count), eta) < st.eps;
  *st.iters = st.it + 1;
  *reinterpret_cast<volatile unsigned long long*>(st.words) =
      (static_cast<unsigned long long>(st.tag) << 32) |
      (static_cast<unsigned long long>(st.it + 1) << 1) |
      (stop ? 1ull : 0ull);
}

// A kProx STOP launch's end, in every thread of the block: the block's
// share (its warps' sums in warp order) to slot `slot` of the shares and
// zeros to the count - 1 slots after it (count 0: no slot), then the last
// block to arrive sums the slots (thread t the slots t, t + blockDim.x,
// ... in turn, then its warps in warp order) and decides (or, with
// st.local, leaves the rank's sum there).  The ticket is reset for the
// next launch by that block.  The slots of a launch, one a block, are
// each written by one block.
__device__ __forceinline__ void conv_stop_post(const ConvStop& st,
                                               float delta, float eta,
                                               long long slot, int count) {
  __shared__ float warp_shares[32];
  __shared__ bool last;
  unsigned* const ticket = reinterpret_cast<unsigned*>(st.words + 1);
  float* const shares = reinterpret_cast<float*>(st.words + kStopCtlWords);
  const int tid = threadIdx.x;
  const unsigned tiles = gridDim.x * gridDim.y * gridDim.z;
  delta = conv_warp_sum(delta);
  if ((tid & 31) == 0) warp_shares[tid >> 5] = delta;
  __syncthreads();
  if (tid == 0) {
    float share = 0.0f;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w)
      share = __fadd_rn(share, warp_shares[w]);
    for (int q = 0; q < count; ++q) shares[slot + q] = q ? 0.0f : share;
    // release: the share before the ticket; acquire: the last block sees
    // every share, and passes them on to its threads at the barrier
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> arrivals(*ticket);
    last = arrivals.fetch_add(1u, cuda::memory_order_acq_rel) == tiles - 1;
  }
  __syncthreads();
  if (!last) return;  // the same in every thread of the block
  float sum = 0.0f;
  for (unsigned i = tid; i < tiles; i += blockDim.x)
    sum = __fadd_rn(sum, reinterpret_cast<volatile float*>(shares)[i]);
  sum = conv_warp_sum(sum);
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
      conv_stop_decide(st, total, eta);
  }
}

// conv_stop_post of a block of a tiled grid, to its own slot.
__device__ __forceinline__ void conv_stop_share(const ConvStop& st,
                                                float delta, float eta) {
  conv_stop_post(st, delta, eta,
                 (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                     blockIdx.x,
                 1);
}

// K17 at a world above one: the decision of iteration st.it on the sum
// over the ranks in *st.local, one thread; nothing once the solve stopped.
__global__ void conv_stop_decide_kernel(ConvStop st, const float* eta) {
  if (conv_stopped(st, conv_stop_word(st))) return;
  conv_stop_decide(st, *st.local, *eta);
}

template <bool STOP = false>
__global__ void __launch_bounds__(kThreads) gather_gemm(GemmArgs p) {
  // STOP: the stop word, tested before the K loop
  const unsigned long long stop_word = STOP ? conv_stop_word(p.stop) : 0;
  __shared__ __align__(16) float as[kBK][kBM + 4];
  __shared__ __align__(16) float bs[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM;
  const long long n0 = static_cast<long long>(blockIdx.x) * kBN;
  const int len = p.out_h * p.out_w;
  const float* a = p.a;

  // the source position this thread gathers, fixed for the whole K loop
  const int bn = tid % kBN;
  int gb = 0, gy = 0, gx = 0;
  const bool gvalid = decode_position(p, n0 + bn, len, &gb, &gy, &gx);
  const float* src_b =
      p.src + static_cast<long long>(gb) * p.src_c * p.src_h * p.src_w;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  const int ty = tid / 16, tx = tid % 16;

  // this thread's B rows k = k0 + tid / kBN + r * (kThreads / kBN): their
  // offset o, channel ch and source shift, advanced by kBK per K step
  // without a division unless o changes
  constexpr int kRowsB = (kBN * kBK) / kThreads;
  int b_ch[kRowsB], b_o[kRowsB], b_dy[kRowsB], b_dx[kRowsB];
#pragma unroll
  for (int r = 0; r < kRowsB; ++r) {
    const int k = tid / kBN + r * (kThreads / kBN);
    b_o[r] = k / p.src_c;
    b_ch[r] = k - b_o[r] * p.src_c;
    b_dy[r] = p.sign * (b_o[r] / p.off_w) + p.off_y0;
    b_dx[r] = p.sign * (b_o[r] % p.off_w) + p.off_x0;
  }

  if (STOP && conv_stopped(p.stop, stop_word)) return;
  for (int k0 = 0; k0 < p.k; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < (kBM * kBK) / kThreads; ++r) {
      const int e = tid + r * kThreads;
      const int mm = e / kBK, kk = e % kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      as[kk][mm] = (gm < p.m && gk < p.k)
                       ? a[static_cast<long long>(gm) * p.k + gk]
                       : 0.f;
    }
#pragma unroll
    for (int r = 0; r < kRowsB; ++r) {
      const int kk = tid / kBN + r * (kThreads / kBN);
      float v = 0.f;
      if (gvalid && k0 + kk < p.k) {
        const int y = gy + b_dy[r], x = gx + b_dx[r];
        if (y >= 0 && y < p.src_h && x >= 0 && x < p.src_w)
          v = src_b[(static_cast<long long>(b_ch[r]) * p.src_h + y) *
                        p.src_w + x];
      }
      bs[kk][bn] = v;
      b_ch[r] += kBK;
      if (b_ch[r] >= p.src_c) {
        do {
          b_ch[r] -= p.src_c;
          ++b_o[r];
        } while (b_ch[r] >= p.src_c);
        b_dy[r] = p.sign * (b_o[r] / p.off_w) + p.off_y0;
        b_dx[r] = p.sign * (b_o[r] % p.off_w) + p.off_x0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float eta = p.epilogue == kProx ? *p.eta : 0.f;
  const float thresh = __fmul_rn(p.lam, eta);
  float delta = 0.f;  // STOP: this thread's sum of |codes - old|
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int b, y, x;
    if (!decode_position(p, n0 + tx * 4 + j, len, &b, &y, &x))
      continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m >= p.m) continue;
      const long long midx = (static_cast<long long>(m) * p.out_h + y) *
                                 p.out_w + x;
      const long long idx =
          ((static_cast<long long>(b) * p.m + m) * p.out_h + y) * p.out_w + x;
      epilogue_store<STOP>(p, idx, acc[i][j], epilogue_load(p, idx, midx),
                           eta, thresh, &delta);
    }
  }
  if constexpr (STOP)
    if (p.epilogue == kProx) conv_stop_share(p.stop, delta, eta);
}

// One entry of gather_gemm_tiled's offset table: k's source offset
// (ch * src_h + dy) * src_w + dx, and dy, dx for the bounds test.
struct __align__(8) KOffset {
  int off;
  short dy, dx;
};

// A 4-byte cp.async; where copy is false it reads nothing and writes a
// zero (a source size of 0), so gmem need only be a valid address.
__device__ __forceinline__ void gemm_cp_async4(float* smem, const float* gmem,
                                               bool copy) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(copy ? 4 : 0));
}

__device__ __forceinline__ void gemm_cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void gemm_cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Shared memory of gather_gemm_tiled<BN>: the two-stage ring of A
// (kBK x (kBM + 4)) and source (kBK x (BN + 4)) slices, then the offset
// table padded to a whole slice; after the K loop the kBM x (BN + 4) tile
// of C over both.
inline size_t tile_smem_bytes(int bn, int k) {
  const size_t ring =
      sizeof(float) * (2 * kBK * (kBM + 4) + 2 * kBK * (bn + 4));
  const size_t table =
      sizeof(KOffset) * static_cast<size_t>((k + kBK - 1) / kBK * kBK);
  const size_t tile = sizeof(float) * kBM * (bn + 4);
  return ring + table > tile ? ring + table : tile;
}

// The tiled GEMM: a kBM x BN tile of C per block, each of the
// 128 threads holding 4 * TM rows (TM groups of 4, kBM / TM apart) by 8
// columns (2 groups of 4, BN / 2 apart).  BN = 128 takes TM = 2, BN = 64
// TM = 1.
template <int BN, int TM, bool STOP = false>
__global__ void __launch_bounds__(kTileThreads) gather_gemm_tiled(GemmArgs p) {
  static_assert(kTileThreads == (kBM / (4 * TM)) * (BN / 8), "thread grid");
  // STOP: the stop word, tested once the offset table is built
  const unsigned long long stop_word = STOP ? conv_stop_word(p.stop) : 0;
  constexpr int kAS = kBM + 4, kBS = BN + 4, kCS = BN + 4;
  extern __shared__ __align__(16) float tile_smem[];
  float* as = tile_smem;                  // [2][kBK][kAS]
  float* bs = as + 2 * kBK * kAS;         // [2][kBK][kBS]
  KOffset* table = reinterpret_cast<KOffset*>(bs + 2 * kBK * kBS);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM;
  const long long n0 = static_cast<long long>(blockIdx.x) * BN;
  const int len = p.out_h * p.out_w;
  const long long npos = static_cast<long long>(p.nb) * len;
  const int kpad = (p.k + kBK - 1) / kBK * kBK;

  for (int k = tid; k < kpad; k += kTileThreads) {
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
  // column tid % BN, rows tid / BN + r * (kTileThreads / BN) of a slice
  constexpr int kRowsB = BN * kBK / kTileThreads;
  constexpr int kRowsA = kBM * kBK / kTileThreads;
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

  // copy slice k0 of A (transposed) and of the gathered source to stage
  auto load_slice = [&](int stage, int k0) {
    float* as_s = as + stage * kBK * kAS;
    float* bs_s = bs + stage * kBK * kBS;
#pragma unroll
    for (int r = 0; r < kRowsA; ++r) {
      const int e = tid + r * kTileThreads;
      const int mm = e / kBK, kk = e % kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      const bool ok = gm < p.m && gk < p.k;
      gemm_cp_async4(as_s + kk * kAS + mm,
                     ok ? p.a + static_cast<long long>(gm) * p.k + gk : p.a,
                     ok);
    }
#pragma unroll
    for (int r = 0; r < kRowsB; ++r) {
      const int kk = row0 + r * (kTileThreads / BN);
      const KOffset e = table[k0 + kk];
      const bool ok = nvalid && k0 + kk < p.k &&
                      static_cast<unsigned>(gy + e.dy) <
                          static_cast<unsigned>(p.src_h) &&
                      static_cast<unsigned>(gx + e.dx) <
                          static_cast<unsigned>(p.src_w);
      gemm_cp_async4(bs_s + kk * kBS + col, ok ? src_n + e.off : p.src, ok);
    }
  };

  float acc[4 * TM][8];
#pragma unroll
  for (int i = 0; i < 4 * TM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int ty = tid / (BN / 8), tx = tid % (BN / 8);

  const int slices = kpad / kBK;
  if (slices > 0) load_slice(0, 0);
  gemm_cp_async_commit();
  for (int t = 0; t < slices; ++t) {
    // always commit, so that wait_group 1 leaves exactly slice t landed
    if (t + 1 < slices) load_slice((t + 1) & 1, (t + 1) * kBK);
    gemm_cp_async_commit();
    gemm_cp_async_wait1();
    __syncthreads();
    const float* as_s = as + (t & 1) * kBK * kAS;
    const float* bs_s = bs + (t & 1) * kBK * kBS;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float ar[4 * TM], br[8];
#pragma unroll
      for (int g = 0; g < TM; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(
            as_s + kk * kAS + g * (kBM / TM) + ty * 4);
        ar[4 * g] = v.x;
        ar[4 * g + 1] = v.y;
        ar[4 * g + 2] = v.z;
        ar[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(
            bs_s + kk * kBS + h * (BN / 2) + tx * 4);
        br[4 * h] = v.x;
        br[4 * h + 1] = v.y;
        br[4 * h + 2] = v.z;
        br[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < 4 * TM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

  // The epilogue: the tile goes through shared memory (over the ring,
  // free after the loop's last barrier) so that each warp writes whole
  // rows of C, lane l at columns l + 32 q, in coalesced runs, 4 outputs'
  // inputs loaded before their stores.
  float* cs = tile_smem;  // [kBM][kCS]
#pragma unroll
  for (int i = 0; i < 4 * TM; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(
          cs + ((i / 4) * (kBM / TM) + ty * 4 + (i % 4)) * kCS +
          h * (BN / 2) + tx * 4) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                      acc[i][4 * h + 3]);
  __syncthreads();
  const float eta = p.epilogue == kProx ? *p.eta : 0.f;
  const float thresh = __fmul_rn(p.lam, eta);
  float delta = 0.f;  // STOP: this thread's sum of |codes - old|
  constexpr int kQ = BN / 32, kR = 4 / kQ, kWarps = kTileThreads / 32;
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

// gather_gemm_tiled<BN, TM> over every position, its dynamic shared
// memory allowed up to the table's cap on first use.
template <int BN, int TM, bool STOP = false>
cudaError_t launch_tiled(const GemmArgs& p, long long positions,
                         cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      gather_gemm_tiled<BN, TM, STOP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(tile_smem_bytes(BN, kTableMaxK)));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(static_cast<unsigned>((positions + BN - 1) / BN),
                  static_cast<unsigned>((p.m + kBM - 1) / kBM), 1);
  gather_gemm_tiled<BN, TM, STOP><<<grid, kTileThreads,
                                    tile_smem_bytes(BN, p.k), stream>>>(p);
  return cudaGetLastError();
}

// The SM count of the current device, read once (0 if the query fails:
// the launch then reports the device's error).
inline int gemm_sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n;
  }();
  return sms;
}

// Whether the offset table holds this product: K within its cap, the
// shifts within a short and one sample's source within an int.
inline bool tile_table_fits(const GemmArgs& p) {
  const int reach = p.k / p.src_c / p.off_w + 1;
  return p.k <= kTableMaxK && reach + abs(p.off_y0) < 32767 &&
         p.off_w + abs(p.off_x0) < 32767 &&
         static_cast<long long>(p.src_c) * p.src_h * p.src_w < (1LL << 31);
}

// Launch one gathered GEMM over every position of p (nb * len); returns
// the launch's CUDA error.  The tiled kernel takes it where its offset
// table fits, 128 positions a block where that gives every SM two
// blocks, else 64; larger K takes gather_gemm.  STOP: the kernels' stop
// builds with p.stop (see "The early stop").
template <bool STOP = false>
cudaError_t launch_gather_gemm(const GemmArgs& p, int len,
                               cudaStream_t stream) {
  const long long positions = static_cast<long long>(p.nb) * len;
  if (tile_table_fits(p)) {
    return (positions + 127) / 128 >= 2LL * gemm_sm_count()
               ? launch_tiled<128, 2, STOP>(p, positions, stream)
               : launch_tiled<64, 1, STOP>(p, positions, stream);
  }
  const dim3 grid(static_cast<unsigned>((positions + kBN - 1) / kBN),
                  static_cast<unsigned>((p.m + kBM - 1) / kBM), 1);
  gather_gemm<STOP><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// The 64-bit words of a stop's device array for a kProx product over
// `tiles` blocks: the control words and one share a block, two to a word.
inline long long conv_stop_words_for(long long tiles) {
  return kStopCtlWords + (tiles + 1) / 2;
}

// The same for a product of m rows over `positions` positions, at the
// smallest tiles any route takes: 64 x 64 here, one output row of at least
// kWindowMinOutW positions on the tier GEMM's window route
// (conv_gemm_tier.cuh).
inline long long conv_stop_words(int m, long long positions) {
  return conv_stop_words_for((positions + kWindowMinOutW - 1) /
                             kWindowMinOutW * ((m + kBM - 1) / kBM));
}

// A gathered GEMM with or without its stop build: the stop build where
// stop is true.
inline cudaError_t launch_gather_gemm_stop(const GemmArgs& p, int len,
                                           bool stop, cudaStream_t stream) {
  return stop ? launch_gather_gemm<true>(p, len, stream)
              : launch_gather_gemm<false>(p, len, stream);
}

// FISTA momentum of iteration with t_k = *t, in float32 as the plain
// loop computes it (ops/solver.fista_momentum); advances *t.
inline float fista_beta(float* t) {
  const float t_next = (1.0f + sqrtf(1.0f + 4.0f * *t * *t)) / 2.0f;
  const float beta = (*t - 1.0f) / t_next;
  *t = t_next;
  return beta;
}

}  // namespace
