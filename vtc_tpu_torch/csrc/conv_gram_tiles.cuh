// K11's Gram operator as one class-tiled gathered GEMM an iteration,
// CUDA C++ for Hopper (sm_90a).
//
// The gram-form conv iteration (fused_conv_fista.cu) applies
//
//   L(z)[p] = sum_o G_int[o] z[p + o] - rows[p] - cols[p] + corners[p]
//
// where rows, cols and corners are the same product with another weight
// matrix, on the few code positions whose tiles touch the masked border.
// Every code position has one class: interior; special row i (one of
// the P rows of spec_py); special column j; corner (i, j).  A position's
// class fixes which weight matrices its sum needs (its passes): G_int
// alone; G_rows[i] or G_cols[j], then G_int; G_rows[i], G_cols[j],
// G_corn[i, j], then G_int.  A plan made once per geometry
// (ops/fused_conv_fista.class_plan) lists the positions grouped by class,
// each class padded to whole tiles, gives each tile its class, and lists
// the work items: one (tile, pass) each, the passes of the tiles with
// more than one first.  gram_class_gemm runs every item of an iteration
// in one launch, a block an item: a 64 x kGramBN tile of C through one K
// pass, with the tiled kernel's (conv_gemm.cuh, gather_gemm_tiled) thread
// layout at its 64-wide tile (4 x 8 outputs a thread), 16-deep slices
// and two-stage cp.async ring.  Every block does the same work, so the
// blocks of a launch end together, where a tile that ran its passes in
// one block would hold the launch for 4 interior tiles' time.  Tiles of
// 64 positions (kGramBN) fit 4 blocks an SM, where the tiled kernel's
// 128-wide tile fits 3 (PERF.md §6 has both times).  A single-pass
// tile's block runs the epilogue itself.  A block of a tile with more passes writes its
// accumulator to a scratch slot and takes a ticket; the tile's last block
// to arrive reads every pass back, combines them and runs the epilogue.
//
// Bits.  Each pass is one fmaf chain over k in increasing order from 0,
// into its own accumulator, as gather_gemm and gather_gemm_tiled sum every
// product (the zero-filled tail of the last slice included), and the
// passes combine in a fixed order whichever block arrives last, as the
// earlier four-launch loop combined its launches through a correction
// buffer:
//   extra = -rows                                  (row and corner classes)
//   extra = extra - cols,  or 0 - cols where P > 0, -cols where P = 0
//   extra = extra + corners                        (corner class)
//   g     = (acc_int + extra) - corr,  acc_int + 0 for the interior where
//           the operator has any special line, acc_int where it has none
// then the kProx epilogue's shrink and momentum (conv_gemm.cuh).  So the
// codes are bitwise those of the loop of a row launch, a column launch, a
// corner launch and the interior launch, at every iteration count.
//
// Any K.  K = O * s (O offsets of s channels).  The decode of k = o * s +
// ch keeps an O-entry table of source offsets in shared memory and walks
// o and ch with the slices, so no K-sized table bounds it: at s > 512
// (K above conv_gemm.cuh's kTableMaxK) K11 runs this kernel too.
//
// The early stop.  The STOP build reads the stop word on entry, returns
// once the solve has stopped, and posts each tile's share of |codes -
// old| (conv_gemm.cuh, "The early stop"): the block that runs a tile's
// epilogue writes the share to the slot of the tile's first item and
// zeros to its other items' slots, so the shares sit in the same slots
// whichever block arrived last; the last block of the launch decides.
#pragma once

#include "conv_gemm.cuh"

namespace {

// A tile's class word: bit 0 special row, bit 1 special column, the row's
// index i in spec_py at bits 2-15 and the column's j at bits 16-29.
constexpr int kGramRow = 1;
constexpr int kGramCol = 2;
constexpr int kGramIndexBits = 14;
constexpr int kGramMaxLines = 1 << kGramIndexBits;
// A work item: tile << kGramPassBits | pass
constexpr int kGramPassBits = 2;
// positions a tile
constexpr int kGramBN = 64;

// The weights and the plan of one gram-form solve.
struct GramTiles {
  const float* gint;   // (s, O*s): A[i, o*s + j] = G_int[o][i][j]
  const float* grows;  // (P, s, O*s), or null where P = 0
  const float* gcols;  // (Q, s, O*s), or null where Q = 0
  const float* gcorn;  // (P*Q, s, O*s), corner (i, j) at i*Q + j
  const int* slots;    // (tiles * kGramBN,) (b * h + y) * w + x, or -1
  const int* tile_class;  // (tiles,) class words
  const int* items;    // (items,) work items, a tile's passes in order
  float* scratch;      // (ceil(s / kBM), multi_items, kBM * kGramBN)
  unsigned* tickets;   // (ceil(s / kBM), tiles), zero between launches
  int tiles, multi_items;  // items below multi_items have a scratch slot
  int num_p, num_q;
  int offsets;  // O
};

// Shared memory of gram_class_gemm: the ring and the O-entry offset
// table, or the staged tile of C over them after the K loop.
inline size_t gram_smem_bytes(int offsets) {
  const size_t ring =
      sizeof(float) * (2 * kBK * (kBM + 4) + 2 * kBK * (kGramBN + 4));
  const size_t table = sizeof(KOffset) * static_cast<size_t>(offsets);
  const size_t tile = sizeof(float) * kBM * (kGramBN + 4);
  return ring + table > tile ? ring + table : tile;
}

// The stop's 64-bit words for a launch of `items` work items of s rows.
inline long long gram_stop_words(int s, long long items) {
  return conv_stop_words_for(items * ((s + kBM - 1) / kBM));
}

// One pass of a tile's weights: A of the tile's class for pass `pass`
// (rows, columns, corner, then G_int; npass passes).
__device__ __forceinline__ const float* gram_pass_weights(
    const GramTiles& g, long long mat, bool is_row, int npass, int ci,
    int cj, int pass) {
  if (pass == npass - 1) return g.gint;
  if (!is_row) return g.gcols + cj * mat;
  if (pass == 0) return g.grows + ci * mat;
  if (pass == 1) return g.gcols + cj * mat;
  return g.gcorn + (static_cast<long long>(ci) * g.num_q + cj) * mat;
}

// p: the kProx product (src the current codes, m = src_c = s, k = O * s,
// off_w = 2 rx + 1, off_y0 = -ry, off_x0 = -rx, sign 1, out_h x out_w the
// codes, extra unused); g: the weights and plan.  Grid (items, ceil(s /
// kBM)).
template <bool STOP = false>
__global__ void __launch_bounds__(kTileThreads)
    gram_class_gemm(GemmArgs p, GramTiles g) {
  constexpr int BN = kGramBN;
  static_assert(kTileThreads == (kBM / 4) * (BN / 8), "thread grid");
  // STOP: the stop word, tested once the offset table is built
  const unsigned long long stop_word = STOP ? conv_stop_word(p.stop) : 0;
  constexpr int kAS = kBM + 4, kBS = BN + 4, kCS = BN + 4;
  extern __shared__ __align__(16) float gram_smem[];
  __shared__ bool last;
  float* as = gram_smem;                  // [2][kBK][kAS]
  float* bs = as + 2 * kBK * kAS;         // [2][kBK][kBS]
  KOffset* table = reinterpret_cast<KOffset*>(bs + 2 * kBK * kBS);
  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int len = p.out_h * p.out_w;
  const int plane = p.src_h * p.src_w;

  for (int o = tid; o < g.offsets; o += kTileThreads) {
    const int dy = o / p.off_w + p.off_y0, dx = o % p.off_w + p.off_x0;
    table[o] = {dy * p.src_w + dx, static_cast<short>(dy),
                static_cast<short>(dx)};
  }

  // the item's tile, its class and this pass's weights
  const int item = g.items[blockIdx.x];
  const int tile = item >> kGramPassBits;
  const int pass = item & ((1 << kGramPassBits) - 1);
  const int cls = g.tile_class[tile];
  const bool is_row = cls & kGramRow, is_col = cls & kGramCol;
  const int ci = (cls >> 2) & (kGramMaxLines - 1);
  const int cj = (cls >> (2 + kGramIndexBits)) & (kGramMaxLines - 1);
  const int npass = 1 + is_row + is_col + (is_row && is_col);
  const long long mat = static_cast<long long>(p.m) * p.k;
  const float* a = gram_pass_weights(g, mat, is_row, npass, ci, cj, pass);
  const long long n0 = static_cast<long long>(tile) * BN;

  // the source position this thread gathers, fixed for the whole K loop:
  // column tid % BN, rows tid / BN + r * (kTileThreads / BN) of a slice
  constexpr int kStep = kTileThreads / BN;
  constexpr int kRowsB = BN * kBK / kTileThreads;
  constexpr int kRowsA = kBM * kBK / kTileThreads;
  const int col = tid % BN, row0 = tid / BN;
  const int pos = g.slots[n0 + col];
  const bool nvalid = pos >= 0;
  int gy = 0, gx = 0;
  const float* src_n = p.src;
  if (nvalid) {
    const int b = pos / len, t = pos - b * len;
    gy = t / p.out_w;
    gx = t - gy * p.out_w;
    src_n += static_cast<long long>(b) * p.src_c * plane + gy * p.src_w + gx;
  }
  __syncthreads();
  if (STOP && conv_stopped(p.stop, stop_word)) return;

  // copy slice k0 = o0 * s + ch0 of A (transposed) and of the gathered
  // source to stage
  auto load_slice = [&](int stage, int k0, int o0, int ch0) {
    float* as_s = as + stage * kBK * kAS;
    float* bs_s = bs + stage * kBK * kBS;
#pragma unroll
    for (int r = 0; r < kRowsA; ++r) {
      const int e = tid + r * kTileThreads;
      const int mm = e / kBK, kk = e % kBK;
      const int gm = m0 + mm, gk = k0 + kk;
      const bool ok = gm < p.m && gk < p.k;
      gemm_cp_async4(as_s + kk * kAS + mm,
                     ok ? a + static_cast<long long>(gm) * p.k + gk : a, ok);
    }
    int o = o0, ch = ch0 + row0;
    while (ch >= p.src_c) {
      ch -= p.src_c;
      ++o;
    }
#pragma unroll
    for (int r = 0; r < kRowsB; ++r) {
      if (r > 0) {
        ch += kStep;
        while (ch >= p.src_c) {
          ch -= p.src_c;
          ++o;
        }
      }
      const int kk = row0 + r * kStep;
      const bool kin = k0 + kk < p.k;
      const KOffset e = table[kin ? o : 0];
      const bool ok = nvalid && kin &&
                      static_cast<unsigned>(gy + e.dy) <
                          static_cast<unsigned>(p.src_h) &&
                      static_cast<unsigned>(gx + e.dx) <
                          static_cast<unsigned>(p.src_w);
      gemm_cp_async4(bs_s + kk * kBS + col,
                     ok ? src_n + ch * plane + e.off : p.src, ok);
    }
  };

  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const int ty = tid / (BN / 8), tx = tid % (BN / 8);

  // the K loop; the loader's k0 = ld_o * s + ld_ch runs one slice ahead
  const int slices = (p.k + kBK - 1) / kBK;
  int ld_o = 0, ld_ch = 0;
  load_slice(0, 0, 0, 0);
  gemm_cp_async_commit();
  for (int t = 0; t < slices; ++t) {
    // always commit, so that wait_group 1 leaves exactly slice t landed
    if (t + 1 < slices) {
      ld_ch += kBK;
      while (ld_ch >= p.src_c) {
        ld_ch -= p.src_c;
        ++ld_o;
      }
      load_slice((t + 1) & 1, (t + 1) * kBK, ld_o, ld_ch);
    }
    gemm_cp_async_commit();
    gemm_cp_async_wait1();
    __syncthreads();
    const float* as_s = as + (t & 1) * kBK * kAS;
    const float* bs_s = bs + (t & 1) * kBK * kBS;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float ar[4], br[8];
      const float4 va =
          *reinterpret_cast<const float4*>(as_s + kk * kAS + ty * 4);
      ar[0] = va.x;
      ar[1] = va.y;
      ar[2] = va.z;
      ar[3] = va.w;
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
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

  // A tile of several passes: post this pass, and leave the rest to the
  // tile's last block, which reads the passes back in order and combines
  // them (see "Bits").  The interior: acc_int, + 0 where there are lines.
  const bool lines = g.num_p > 0 || g.num_q > 0;
  // the stop's slot: the tile's first item's
  const long long slot = static_cast<long long>(blockIdx.y) * gridDim.x +
                         blockIdx.x - pass;
  if (npass > 1) {
    constexpr int kSlot = kBM * BN;
    float* const mine =
        g.scratch +
        (static_cast<long long>(blockIdx.y) * g.multi_items + blockIdx.x) *
            kSlot;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mine[(i * 8 + j) * kTileThreads + tid] = acc[i][j];
    __threadfence();
    __syncthreads();
    unsigned* const ticket =
        g.tickets + static_cast<long long>(blockIdx.y) * g.tiles + tile;
    if (tid == 0) {
      // release: the pass before the ticket; acquire: the last block sees
      // every pass, and passes them on to its threads at the barrier
      cuda::atomic_ref<unsigned, cuda::thread_scope_device> arrivals(*ticket);
      last = arrivals.fetch_add(1u, cuda::memory_order_acq_rel) ==
             static_cast<unsigned>(npass - 1);
      if (last) *ticket = 0u;
    }
    __syncthreads();
    if (!last) {
      // the launch's stop still counts this block, without a share
      if constexpr (STOP) conv_stop_post(p.stop, 0.f, *p.eta, 0, 0);
      return;
    }
    const float* const first = mine - static_cast<long long>(pass) * kSlot;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int at = (i * 8 + j) * kTileThreads + tid;
        float extra = 0.f;
        int q = 0;
        if (is_row) extra = -__ldcg(first + q++ * kSlot + at);  // rows
        if (is_col) {
          const float v = __ldcg(first + q++ * kSlot + at);
          extra = is_row ? __fsub_rn(extra, v)
                         : (g.num_p > 0 ? __fsub_rn(0.f, v) : -v);
        }
        if (is_row && is_col)
          extra = __fadd_rn(extra, __ldcg(first + q++ * kSlot + at));
        acc[i][j] = __fadd_rn(__ldcg(first + q * kSlot + at), extra);
      }
  } else if (lines) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = __fadd_rn(acc[i][j], 0.f);
  }

  // the kProx epilogue of gather_gemm_tiled: the tile goes through shared
  // memory (over the ring, free after the loop's last barrier) so that
  // each warp writes whole rows of C, lane l at columns l + 32 q, its
  // inputs loaded before the stores
  float* cs = gram_smem;  // [kBM][kCS]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(cs + (ty * 4 + i) * kCS + h * (BN / 2) +
                                 tx * 4) =
          make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2],
                      acc[i][4 * h + 3]);
  __syncthreads();
  const float eta = *p.eta;
  const float thresh = __fmul_rn(p.lam, eta);
  float delta = 0.f;  // STOP: this thread's sum of |codes - old|
  constexpr int kQ = BN / 32, kR = 4 / kQ, kWarps = kTileThreads / 32;
  const int lane = tid % 32, warp = tid / 32;
  // this lane's columns: output offset b * M * len + t
  long long cbase[kQ];
  bool cvalid[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int n = g.slots[n0 + lane + 32 * q];
    cvalid[q] = n >= 0;
    const int b = cvalid[q] ? n / len : 0;
    cbase[q] = static_cast<long long>(b) * p.m * len + (n - b * len);
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
              p, cbase[q] + static_cast<long long>(m) * len, 0);
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
  if constexpr (STOP) conv_stop_post(p.stop, delta, eta, slot, npass);
}

// One launch of gram_class_gemm<STOP> over `items` work items, its
// dynamic shared memory allowed for O offsets where it needs more than
// the default.
template <bool STOP>
cudaError_t launch_gram_at(const GemmArgs& p, const GramTiles& g, int items,
                           cudaStream_t stream) {
  const size_t smem = gram_smem_bytes(g.offsets);
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        gram_class_gemm<STOP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (attr != cudaSuccess) return attr;
  }
  const dim3 grid(static_cast<unsigned>(items),
                  static_cast<unsigned>((p.m + kBM - 1) / kBM), 1);
  gram_class_gemm<STOP><<<grid, kTileThreads, smem, stream>>>(p, g);
  return cudaGetLastError();
}

// K11's launch: the stop build where stop is true.
inline cudaError_t launch_gram_class_gemm(const GemmArgs& p,
                                          const GramTiles& g, int items,
                                          bool stop, cudaStream_t stream) {
  return stop ? launch_gram_at<true>(p, g, items, stream)
              : launch_gram_at<false>(p, g, items, stream);
}

}  // namespace
