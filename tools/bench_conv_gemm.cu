// Times the conv family's two gathered GEMM kernels alone
// (vtc_tpu_torch/csrc/conv_gemm.cuh) at K10's flagship shapes: 64 kernels
// of 16x16 at stride 8 on 272x272 images (2 x 2 kernel parts, 34 x 34
// image blocks, 33 x 33 codes), at batches 40 and 5.  For each batch it
// runs the synthesis (mask epilogue) and the analysis (shrink and FISTA
// momentum epilogue) through launch_gather_gemm, which picks the tiled
// kernel, and through the line kernel gather_gemm launched directly, and
// prints the mean ms per launch over 50 launches and the achieved
// TFLOP/s.  Built and run by tools/bench_conv_gemm.py.
#include <cstdio>
#include <vector>

#include "conv_gemm.cuh"

namespace {

float* device_random(size_t n, unsigned seed) {
  std::vector<float> h(n);
  for (auto& x : h) {
    seed = seed * 1664525u + 1013904223u;
    x = ((seed >> 8) & 0xffff) / 65536.f - 0.5f;
  }
  float* d = nullptr;
  cudaMalloc(&d, n * sizeof(float));
  cudaMemcpy(d, h.data(), n * sizeof(float), cudaMemcpyHostToDevice);
  return d;
}

}  // namespace

int main() {
  const int b = 40, s = 64, cpx = 64, ax = 2, r = 4, bh = 34, bw = 34;
  const int ch = bh - 1, cw = bw - 1, reps = 50;
  GemmArgs synth = {};
  synth.a = device_random(static_cast<size_t>(cpx) * r * s, 1);
  synth.m = cpx;
  synth.k = r * s;
  synth.src = device_random(static_cast<size_t>(b) * s * ch * cw, 2);
  synth.src_c = s;
  synth.src_h = ch;
  synth.src_w = cw;
  synth.off_w = ax;
  synth.sign = -1;
  synth.out_h = bh;
  synth.out_w = bw;
  synth.lines = kAll;
  synth.epilogue = kMaskStore;
  synth.out = device_random(static_cast<size_t>(b) * cpx * bh * bw, 3);
  synth.mask = device_random(static_cast<size_t>(cpx) * bh * bw, 4);
  GemmArgs anal = {};
  anal.a = device_random(static_cast<size_t>(s) * r * cpx, 5);
  anal.m = s;
  anal.k = r * cpx;
  anal.src = synth.out;
  anal.src_c = cpx;
  anal.src_h = bh;
  anal.src_w = bw;
  anal.off_w = ax;
  anal.sign = 1;
  anal.out_h = ch;
  anal.out_w = cw;
  anal.lines = kAll;
  anal.epilogue = kProx;
  anal.out = const_cast<float*>(synth.src);
  anal.z_cur = synth.src;
  anal.corr = device_random(static_cast<size_t>(b) * s * ch * cw, 6);
  anal.old = device_random(static_cast<size_t>(b) * s * ch * cw, 7);
  float* eta = device_random(1, 8);
  anal.eta = eta;
  anal.lam = 0.05f;
  anal.beta = 0.3f;
  anal.fista = 1;
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  for (int batch : {40, 5}) {
    synth.nb = anal.nb = batch;
    for (const GemmArgs* p : {&synth, &anal}) {
      const int len = p->out_h * p->out_w;
      const long long positions = static_cast<long long>(batch) * len;
      const dim3 grid((positions + kBN - 1) / kBN, (p->m + kBM - 1) / kBM, 1);
      float ms[2];
      for (int line = 0; line < 2; ++line) {
        for (int i = 0; i <= reps; ++i) {
          if (i == 1) cudaEventRecord(start);
          if (line)
            gather_gemm<<<grid, kThreads>>>(*p);
          else
            launch_gather_gemm(*p, 1, len, 0);
        }
        cudaEventRecord(stop);
        cudaEventSynchronize(stop);
        cudaEventElapsedTime(&ms[line], start, stop);
        ms[line] /= reps;
      }
      const double flops = 2.0 * p->m * p->k * positions;
      const cudaError_t err = cudaGetLastError();
      std::printf(
          "b %2d %-9s M %d K %d N %lld: tiled %.4f ms (%.2f TFLOP/s), line "
          "kernel %.4f ms (%.2f TFLOP/s)%s%s\n",
          batch, p == &synth ? "synthesis" : "analysis", p->m, p->k,
          positions, ms[0], flops / ms[0] / 1e9, ms[1], flops / ms[1] / 1e9,
          err == cudaSuccess ? "" : " CUDA error: ",
          err == cudaSuccess ? "" : cudaGetErrorString(err));
      if (err != cudaSuccess) return 1;
    }
  }
  return 0;
}
