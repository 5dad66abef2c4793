// Gathered fp32 GEMM for the convolutional solves (K10 and K11) and the
// conv train step (K12), CUDA C++ for Hopper (sm_90a).
//
// Every product of the conv iteration is one shape:
//
//   C[m, n] = sum_k A[m, k] * src[b(n), k % C, Y(n) + oy(k), X(n) + ox(k)]
//
// with A a small weight matrix (s or c*sv*sh rows, a few hundred deep),
// n a code or image-block position (b, Y, X) and k = o * C + ch running
// over the offsets o of a tile's neighbourhood and the channels ch of the
// source.  Reads outside the source are zeros.  K10's synthesis, its
// analysis and its corr = A(mask * X), and K11's interior operator and
// its border corrections are all instances: they differ in A, in the
// offset decode of k, in which positions n run (all of them, one code
// row, one code column or one corner per grid z) and in the epilogue.
//
// The kernel is an implicit GEMM with no materialized shifted stack: a
// block computes a 64 x 64 tile of C in registers (256 threads, 4 x 4
// each), staging 16-deep slices of A and of the gathered source in
// shared memory.  Each thread gathers one fixed position n for the whole
// K loop, so consecutive threads read consecutive pixels.  Plain fp32
// FMA on the SIMT units: no tensor cores, no TF32, no library.
#pragma once

#include <cuda_runtime.h>

// Internal linkage: each .cu that includes this gets its own copy.
namespace {

constexpr int kBM = 64;
constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kThreads = 256;

// epilogues: what a block does with its tile of C at output index idx
enum Epilogue {
  kStore = 0,          // out = acc
  kMaskStore = 1,      // out = acc * mask[m, Y, X]
  kNegStore = 2,       // out = -acc
  kNegStoreKeepRows = 3,  // out = (row_flag[Y] ? out : 0) - acc
  kAdd = 4,            // out += acc
  kProx = 5,           // the ISTA/FISTA update, see below
  kMaskResid = 6,      // out = acc * mask[m, Y, X] - extra[idx] (K12)
};

// which output positions a grid z index runs over
enum Lines {
  kAll = 0,    // every (Y, X) of the output
  kRow = 1,    // Y = line_y[z], every X
  kCol = 2,    // X = line_x[z], every Y
  kPoint = 3,  // (line_y[z / lines_q], line_x[z % lines_q])
};

// shrink modes, as ops/thresholds.select (nonneg, hard)
enum Shrink { kSoft = 0, kSoftNonneg = 1, kHard = 2, kHardNonneg = 3 };

struct GemmArgs {
  // A of grid z: a + z * a_line_stride, (m x k) row-major
  const float* a;
  long long a_line_stride;
  int m, k;
  // gathered source (nb, src_c, src_h, src_w); offset o = k / src_c sits
  // at (sign * (o / off_w) + off_y0, sign * (o % off_w) + off_x0)
  const float* src;
  int src_c, src_h, src_w;
  int off_w, sign, off_y0, off_x0;
  // output (nb, m, out_h, out_w) and the positions of each grid z
  int nb, out_h, out_w;
  int lines, lines_q;
  const int* line_y;
  const int* line_x;
  int epilogue;
  float* out;
  const float* mask;    // kMaskStore: (m, out_h, out_w)
  const int* row_flag;  // kNegStoreKeepRows: (out_h,)
  // kProx: out receives the next z; g = acc (+ extra) - corr,
  // codes = shrink(z_cur - eta * g, lam * eta), written to old
  const float* z_cur;
  const float* corr;
  const float* extra;   // or null; kMaskResid: the subtrahend
  float* old;
  const float* eta;
  float lam, beta;
  int fista, shrink;
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

// Positions of grid z: their count and the fixed row / column.
__device__ __forceinline__ int line_length(const GemmArgs& p, int line,
                                           int* ly, int* lx) {
  switch (p.lines) {
    case kRow: *ly = p.line_y[line]; *lx = 0; return p.out_w;
    case kCol: *ly = 0; *lx = p.line_x[line]; return p.out_h;
    case kPoint:
      *ly = p.line_y[line / p.lines_q];
      *lx = p.line_x[line % p.lines_q];
      return 1;
    default: *ly = 0; *lx = 0; return p.out_h * p.out_w;
  }
}

__device__ __forceinline__ bool decode_position(const GemmArgs& p,
                                                long long n, int len, int ly,
                                                int lx, int* b, int* y,
                                                int* x) {
  if (n >= static_cast<long long>(p.nb) * len) return false;
  *b = static_cast<int>(n / len);
  const int t = static_cast<int>(n - static_cast<long long>(*b) * len);
  switch (p.lines) {
    case kRow: *y = ly; *x = t; break;
    case kCol: *y = t; *x = lx; break;
    case kPoint: *y = ly; *x = lx; break;
    default: *y = t / p.out_w; *x = t - *y * p.out_w; break;
  }
  return true;
}

__global__ void __launch_bounds__(kThreads) gather_gemm(GemmArgs p) {
  __shared__ __align__(16) float as[kBK][kBM + 4];
  __shared__ __align__(16) float bs[kBK][kBN + 4];
  const int tid = threadIdx.x;
  const int line = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const long long n0 = static_cast<long long>(blockIdx.x) * kBN;
  int ly, lx;
  const int len = line_length(p, line, &ly, &lx);
  const float* a = p.a + line * p.a_line_stride;

  // the source position this thread gathers, fixed for the whole K loop
  const int bn = tid % kBN;
  int gb = 0, gy = 0, gx = 0;
  const bool gvalid = decode_position(p, n0 + bn, len, ly, lx, &gb, &gy, &gx);
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
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int b, y, x;
    if (!decode_position(p, n0 + tx * 4 + j, len, ly, lx, &b, &y, &x))
      continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m >= p.m) continue;
      const long long idx =
          ((static_cast<long long>(b) * p.m + m) * p.out_h + y) * p.out_w + x;
      const float v = acc[i][j];
      switch (p.epilogue) {
        case kStore: p.out[idx] = v; break;
        case kMaskStore:
          p.out[idx] =
              v * p.mask[(static_cast<long long>(m) * p.out_h + y) * p.out_w +
                         x];
          break;
        case kNegStore: p.out[idx] = -v; break;
        case kNegStoreKeepRows:
          p.out[idx] = __fsub_rn(p.row_flag[y] ? p.out[idx] : 0.f, v);
          break;
        case kAdd: p.out[idx] = __fadd_rn(p.out[idx], v); break;
        case kMaskResid:
          p.out[idx] = __fsub_rn(
              __fmul_rn(v, p.mask[(static_cast<long long>(m) * p.out_h + y) *
                                      p.out_w + x]),
              p.extra[idx]);
          break;
        default: {
          float g = p.extra ? __fadd_rn(v, p.extra[idx]) : v;
          g = __fsub_rn(g, p.corr[idx]);
          const float codes = shrink_value(
              __fsub_rn(p.z_cur[idx], __fmul_rn(eta, g)), thresh, p.shrink);
          const float next =
              p.fista ? __fadd_rn(codes,
                                  __fmul_rn(p.beta, __fsub_rn(codes,
                                                              p.old[idx])))
                      : codes;
          p.old[idx] = codes;
          p.out[idx] = next;
        }
      }
    }
  }
}

// Launch one gathered GEMM over `lines` grid z indices of `len`
// positions each; returns the launch's CUDA error.
inline cudaError_t launch_gather_gemm(const GemmArgs& p, int lines, int len,
                                      cudaStream_t stream) {
  const long long positions = static_cast<long long>(p.nb) * len;
  const dim3 grid(static_cast<unsigned>((positions + kBN - 1) / kBN),
                  static_cast<unsigned>((p.m + kBM - 1) / kBM),
                  static_cast<unsigned>(lines));
  gather_gemm<<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
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
