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
// columns (2, 3 or 4 products a position instead of 1).  The codes move
// 11 MB per array at batch 40: bound by operations.
//
// Layout.  G_int alone is O*s*s floats (147 KB at s = 64) and the
// corrections add P + Q + P*Q more of the same, so G cannot stay in one
// block's shared memory beside the state, and one sample's state does
// not fit either.  As in K10, the state lives in device memory and one C
// loop enqueues the iterations, each ONE launch of gram_class_gemm
// (conv_gram_tiles.cuh): the code positions, grouped by border class in a
// plan the wrapper builds once per geometry, run in 64 x 64 tiles of one
// class each, a block for each of a tile's passes (the
// interior operator and its class's corrections) through the tiled GEMM's
// cp.async ring, the tile's last block combining them before the shrink
// and the momentum of its epilogue.  Its codes are bitwise those
// of the earlier loop of four launches an iteration (rows, columns and
// corners into a correction buffer, then the interior), whose border
// lines ran on the slow gather_gemm.  The TPU kernel's 0/1 selection-
// matrix products for the columns (:145-153) are a Mosaic workaround:
// here a column is a strided read.  The product gathers z around each
// position while the epilogue writes the next z, so z is double-buffered.
//
// The early stop (vtc_tpu's run(formulation='gram') rule, the same as
// K10's): with stop words every launch is the STOP build (conv_gemm.cuh,
// "The early stop"); its last block decides, and every launch after a
// stop returns at entry.  The launch writes the codes to old every
// iteration, so old holds those of the last iteration run wherever the
// ping-pong of z stood.
// tests/test_torch_port_conv.py holds the plain version to vtc_tpu's
// kernel, tests/test_torch_port_conv_gram_tiles.py the plan and the
// passes' order; chip_smoke.py holds this kernel to the plain version and
// to K10.
#include "conv_gram_tiles.cuh"

extern "C" {

// gint (s, O*s); grows (P, s, O*s); gcols (Q, s, O*s); gcorn (P*Q, s, O*s)
// with A[i, o*s + j] = G[o][i][j] (null where P or Q is 0); slots (tiles
// * 64,), tile_class (tiles,) and items (n_items,) the plan of
// ops/fused_conv_fista.class_plan (the first multi_items items those of
// tiles of several passes); scratch
// (ceil(s / 64) * multi_items * 64 * 64 floats) and tickets
// (ceil(s / 64) * tiles, zeroed); corr (b, s, ch, cw); eta (1,) on the
// device.  z and z2 are the two code buffers, z and old holding the
// initial codes on entry.  stop_words, eps, inv_count and iters: the early
// stop, as vtc_conv_direct's (null words: none; vtc_conv_gram_stop_words
// of them).  Returns the CUDA error of the launches; the codes are in old.
int vtc_conv_fista(const float* gint, const float* grows, const float* gcols,
                   const float* gcorn, const int* slots,
                   const int* tile_class, const int* items, float* scratch,
                   unsigned* tickets, int tiles, int n_items,
                   int multi_items, int num_p, int num_q,
                   const float* corr, const float* eta, float lam,
                   int num_iters, int b, int s, int code_h, int code_w,
                   int ry, int rx, int fista, int mode, float* z, float* z2,
                   float* old, float eps, float inv_count,
                   unsigned long long* stop_words, int* iters,
                   void* stream_ptr) {
  if (b < 1 || s < 1 || code_h < 1 || code_w < 1 || ry < 0 || rx < 0 ||
      num_p < 0 || num_q < 0 || num_p >= kGramMaxLines ||
      num_q >= kGramMaxLines || num_iters < 0 || mode < 0 || mode > 3 ||
      tiles < 1 || n_items < tiles || multi_items < 0 ||
      multi_items > n_items)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int offsets = (2 * ry + 1) * (2 * rx + 1);

  GemmArgs p = {};
  p.m = s;
  p.k = offsets * s;
  p.src_c = s;
  p.src_h = code_h;
  p.src_w = code_w;
  p.off_w = 2 * rx + 1;
  p.sign = 1;  // z[p + o]
  p.off_y0 = -ry;
  p.off_x0 = -rx;
  p.nb = b;
  p.out_h = code_h;
  p.out_w = code_w;
  p.epilogue = kProx;
  p.corr = corr;
  p.old = old;
  p.eta = eta;
  p.lam = lam;
  p.fista = fista;
  p.shrink = mode;
  const GramTiles g = {gint, grows, gcols, gcorn, slots, tile_class, items,
                       scratch, tickets, tiles, multi_items, num_p, num_q,
                       offsets};
  const bool stop = stop_words != nullptr;
  if (stop) {
    p.stop.words = stop_words;
    p.stop.tag = 1u;
    p.stop.iters = iters;
    p.stop.eps = eps;
    p.stop.inv_count = inv_count;
  }
  float* cur = z;
  float* next = z2;
  float t = 1.0f;
  for (int it = 0; it < num_iters; ++it) {
    p.src = p.z_cur = cur;
    p.out = next;
    p.beta = fista ? fista_beta(&t) : 0.0f;
    p.stop.it = it;
    const cudaError_t err = launch_gram_class_gemm(p, g, n_items, stop, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    float* tmp = cur;
    cur = next;
    next = tmp;
  }
  return static_cast<int>(cudaSuccess);
}

// The 64-bit words of a gram-form solve's stop array: s codes over a plan
// of n_items work items.
long long vtc_conv_gram_stop_words(int s, long long n_items) {
  return gram_stop_words(s, n_items);
}

}  // extern "C"
