// Direct-formulation convolutional ISTA/FISTA solve for Hopper (sm_90a),
// CUDA C++.
//
// Replaces the TPU kernel K10: vtc_tpu/ops/pallas_conv_direct.py,
// conv_direct_solve_pallas (:355) / _make_kernel (:255).  Same contract:
// in stride-block space (the padded image cut into sv x sh blocks, the
// kernels zero-extended to a multiple of the stride and cut into
// R = (khp/sv)*(kwp/sh) parts Dpart[a] of (s, c*sv*sh)), every sample
// runs num_iters iterations of
//
//   img[B]    = mblk[B] * sum_a Dpart[a]^T z[B - a]     (synthesis, masked)
//   grad[c]   = sum_a Dpart[a] img[c + a] - corr[c]     (analysis)
//   codes     = shrink(z - eta * grad, lam * eta)
//   z         = codes + beta_k (codes - old) (FISTA) or codes (ISTA)
//
// with corr = A(mask * X) computed once per solve by the analysis
// product, as the TPU kernel computes it in-kernel (:278-284).
//
// What bounds it here.  Both products are deep (R*s = R*c*sv*sh = 256 at
// the flagship: 64 kernels of 16x16 at stride 8) and cost 2*64*256 FLOPs
// per image block or code position: 73.6 MFLOP per sample-iteration at
// 272x272 images, about 4.4 ms for 40 images and 100 iterations at the
// 67 TFLOP/s fp32 SIMT peak.  The state moves 23 MB per batch of 40, so
// the solve is bound by operations, not bytes.
//
// Layout.  One sample's state (z, old, corr and its image blocks, 1.1 MB
// at the flagship) does not fit the 227 KB a block may hold, so the TPU
// kernel's residency cannot be copied: the state lives in device memory
// (45 MB at batch 40, near the 50 MB L2) and the host enqueues two
// kernels per iteration from one C loop, never waiting inside a solve.
// Each is the gathered implicit GEMM of conv_gemm.cuh (64 x 64 register
// tiles, fp32 FMA): the synthesis over every image block with the mask
// in its epilogue, then the analysis over every code position with the
// shrink and the momentum in its epilogue.  The analysis reads only the
// image blocks and rewrites z at its own positions, so z is updated in
// place.  A cooperative kernel with a grid barrier per iteration, or a
// cluster that keeps a sample in distributed shared memory, is later
// work.  tests/test_torch_port_conv.py holds the plain version of this
// layout to vtc_tpu's kernel; chip_smoke.py holds this kernel to it.
#include "conv_gemm.cuh"

extern "C" {

// dstk (cpx, R*s) and dall (s, R*cpx) packed weights; mblk (cpx, bh, bw)
// block mask; xblk (b, cpx, bh, bw) masked image blocks; eta (1,) on the
// device.  img (b, cpx, bh, bw) and corr (b, s, ch, cw) are scratch; z
// and old (b, s, ch, cw) hold the initial codes on entry, and old holds
// the codes on return.  Returns the CUDA error of the launches.
int vtc_conv_direct(const float* dstk, const float* dall, const float* mblk,
                    const float* xblk, const float* eta, float lam,
                    int num_iters, int b, int s, int cpx, int ay, int ax,
                    int bh, int bw, int fista, int mode, float* img,
                    float* corr, float* z, float* old, void* stream_ptr) {
  const int code_h = bh - (ay - 1), code_w = bw - (ax - 1);
  if (b < 1 || s < 1 || cpx < 1 || ay < 1 || ax < 1 || code_h < 1 ||
      code_w < 1 || num_iters < 0 || mode < 0 || mode > 3)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int r = ay * ax;

  GemmArgs synth = {};
  synth.a = dstk;
  synth.m = cpx;
  synth.k = r * s;
  synth.src = z;
  synth.src_c = s;
  synth.src_h = code_h;
  synth.src_w = code_w;
  synth.off_w = ax;
  synth.sign = -1;  // z[B - a]
  synth.nb = b;
  synth.out_h = bh;
  synth.out_w = bw;
  synth.lines = kAll;
  synth.epilogue = kMaskStore;
  synth.out = img;
  synth.mask = mblk;

  GemmArgs anal = {};
  anal.a = dall;
  anal.m = s;
  anal.k = r * cpx;
  anal.src_c = cpx;
  anal.src_h = bh;
  anal.src_w = bw;
  anal.off_w = ax;
  anal.sign = 1;  // y[c + a]
  anal.nb = b;
  anal.out_h = code_h;
  anal.out_w = code_w;
  anal.lines = kAll;

  // corr = A(mask * X), once per solve
  GemmArgs corr_args = anal;
  corr_args.src = xblk;
  corr_args.epilogue = kStore;
  corr_args.out = corr;
  cudaError_t err = launch_gather_gemm(corr_args, 1, code_h * code_w, stream);
  if (err != cudaSuccess) return static_cast<int>(err);

  anal.src = img;
  anal.epilogue = kProx;
  anal.out = z;
  anal.z_cur = z;
  anal.corr = corr;
  anal.old = old;
  anal.eta = eta;
  anal.lam = lam;
  anal.fista = fista;
  anal.shrink = mode;
  float t = 1.0f;
  for (int it = 0; it < num_iters; ++it) {
    anal.beta = fista ? fista_beta(&t) : 0.0f;
    err = launch_gather_gemm(synth, 1, bh * bw, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = launch_gather_gemm(anal, 1, code_h * code_w, stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaSuccess);
}

}  // extern "C"
