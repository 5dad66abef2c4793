// Gram-form convolutional ISTA/FISTA solve for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel K11: vtc_tpu/ops/pallas_conv_fista.py,
// conv_fista_solve_pallas (:229) / _make_kernel (:99).  Same contract:
// with the code-space Gram operator of ops/conv_gram.py (the O offset
// matrices G_int and the row, column and corner corrections, built
// outside the kernel) and corr = A(mask * X) computed outside it, as the
// TPU kernel takes them from XLA (:271-278), every sample runs num_iters
// iterations of
//
//   L(z)[p]  = sum_o G_int[o] z[p + o] - rows - columns + corners
//   codes    = shrink(z - eta * (L(z) - corr), lam * eta)
//   z        = codes + beta_k (codes - old) (FISTA) or codes (ISTA)
//
// It serves the geometries K10's gate turns away (c*sv*sh or s above
// 512), where the image-block products would be wider than the code-space
// ones.
//
// What bounds it here.  The interior operator costs 2*O*s^2 FLOPs per
// code position, O = (2*ry+1)(2*rx+1) offsets: 80 MFLOP per sample-
// iteration at the flagship geometry (9 offsets, s = 64, 33x33 codes),
// about 4.8 ms for 40 samples and 100 iterations at the 67 TFLOP/s fp32
// SIMT peak, plus the border corrections on the few special rows and
// columns.  The codes move 11 MB per array at batch 40: bound by
// operations.
//
// Layout.  G_int alone is O*s*s floats (147 KB at s = 64) and the
// corrections add P + Q + P*Q more of the same, so G cannot stay in one
// block's shared memory beside the state, and one sample's state does
// not fit either.  As in K10, the state lives in device memory and one C
// loop enqueues the iteration's kernels, each an instance of the
// gathered implicit GEMM of conv_gemm.cuh that streams 16-deep slices of
// G through shared memory: the row corrections (one grid z per special
// row, written negated to a correction buffer), the column corrections
// (added there), the corners, then the interior operator over every code
// position with the correction buffer, the shrink and the momentum in
// its epilogue.  The TPU kernel's 0/1 selection-matrix products for the
// columns (:145-153) are a Mosaic workaround: here a column is a strided
// read.  The interior product gathers z around each position while the
// epilogue writes the next z, so z is double-buffered.
// tests/test_torch_port_conv.py holds the plain version to vtc_tpu's
// kernel; chip_smoke.py holds this kernel to it and to K10.
#include "conv_gemm.cuh"

extern "C" {

// gint (s, O*s); grows (P, s, O*s); gcols (Q, s, O*s); gcorn (P*Q, s, O*s)
// with A[i, o*s + j] = G[o][i][j]; spec_py (P,), spec_px (Q,) and
// row_flag (ch,) ints; corr (b, s, ch, cw); eta (1,) on the device.
// corrbuf (b, s, ch, cw) is zero on entry; z and z2 are the two code
// buffers, z and old holding the initial codes on entry.  Returns the
// CUDA error of the launches; the codes are in old.
int vtc_conv_fista(const float* gint, const float* grows, const float* gcols,
                   const float* gcorn, const int* spec_py, const int* spec_px,
                   const int* row_flag, int num_p, int num_q,
                   const float* corr, const float* eta, float lam,
                   int num_iters, int b, int s, int code_h, int code_w,
                   int ry, int rx, int fista, int mode, float* corrbuf,
                   float* z, float* z2, float* old, void* stream_ptr) {
  if (b < 1 || s < 1 || code_h < 1 || code_w < 1 || ry < 0 || rx < 0 ||
      num_p < 0 || num_q < 0 || num_iters < 0 || mode < 0 || mode > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int offsets = (2 * ry + 1) * (2 * rx + 1);

  GemmArgs base = {};
  base.m = s;
  base.k = offsets * s;
  base.a_line_stride = static_cast<long long>(s) * offsets * s;
  base.src_c = s;
  base.src_h = code_h;
  base.src_w = code_w;
  base.off_w = 2 * rx + 1;
  base.sign = 1;  // z[p + o]
  base.off_y0 = -ry;
  base.off_x0 = -rx;
  base.nb = b;
  base.out_h = code_h;
  base.out_w = code_w;
  base.line_y = spec_py;
  base.line_x = spec_px;
  base.lines_q = num_q > 0 ? num_q : 1;
  base.out = corrbuf;
  base.row_flag = row_flag;

  GemmArgs rows = base, cols = base, corners = base, interior = base;
  rows.a = grows;
  rows.lines = kRow;
  rows.epilogue = kNegStore;
  cols.a = gcols;
  cols.lines = kCol;
  cols.epilogue = num_p > 0 ? kNegStoreKeepRows : kNegStore;
  corners.a = gcorn;
  corners.lines = kPoint;
  corners.epilogue = kAdd;
  interior.a = gint;
  interior.a_line_stride = 0;
  interior.lines = kAll;
  interior.epilogue = kProx;
  interior.corr = corr;
  interior.extra = (num_p > 0 || num_q > 0) ? corrbuf : nullptr;
  interior.old = old;
  interior.eta = eta;
  interior.lam = lam;
  interior.fista = fista;
  interior.shrink = mode;

  float* cur = z;
  float* next = z2;
  float t = 1.0f;
  cudaError_t err;
  for (int it = 0; it < num_iters; ++it) {
    rows.src = cols.src = corners.src = interior.src = cur;
    if (num_p > 0) {
      err = launch_gather_gemm(rows, num_p, code_w, stream);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (num_q > 0) {
      err = launch_gather_gemm(cols, num_q, code_h, stream);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    if (num_p > 0 && num_q > 0) {
      err = launch_gather_gemm(corners, num_p * num_q, 1, stream);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    interior.beta = fista ? fista_beta(&t) : 0.0f;
    interior.z_cur = cur;
    interior.out = next;
    err = launch_gather_gemm(interior, 1, code_h * code_w, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    float* tmp = cur;
    cur = next;
    next = tmp;
  }
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
