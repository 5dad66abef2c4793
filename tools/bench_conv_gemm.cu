// Times the conv family's gathered GEMM kernels alone
// (vtc_tpu_torch/csrc/conv_gemm.cuh, conv_gram_tiles.cuh).  At K10's
// flagship shapes, 64 kernels of 16x16 at stride 8 on 272x272 images (2 x
// 2 kernel parts, 34 x 34 image blocks, 33 x 33 codes), at batches 40 and
// 5, it runs the synthesis (mask epilogue) and the analysis (shrink and
// FISTA momentum epilogue) through launch_gather_gemm, which picks the
// tiled kernel, and through gather_gemm (the kernel of K above 4,096)
// launched directly.  Then K11's gram_class_gemm, one launch of a solve's
// iteration, at the flagship (b 40, s 64, 33 x 33 codes), at the serving
// geometry of 64 kernels of 3x32x32 at stride 16 (b 40, s 64, 17 x 17
// codes) and at s 576 (b 8, 33 x 33 codes): 9 offsets (K 9 s), special
// rows and columns the first and last, in the plans that
// ops/fused_conv_fista.class_plan makes, which tools/bench_conv_gemm.py
// writes to the file named by the first argument.  It prints the mean ms
// per launch over 50 launches and the achieved TFLOP/s.  Built and run by
// tools/bench_conv_gemm.py.
// With --tier as the first argument it times the tier GEMM's routes
// instead (conv_gemm_tier.cuh): gather_gemm_tier and the window route,
// each forced, at the flagship's three products (corr = A(mask * X), the
// synthesis, the analysis), b 40, b 20 (K13's shard) and b 5 (the full
// build: b 5 to 40 in steps of 5), at bf16, bf16x3 and bf16x5, with each
// kernel's registers, spill and CTAs an SM.  Built once per
// VTC_CONV_TIER_PARTS (1 the copies, 2 and the split, 3 and the mma
// passes, 4 and the epilogue; 5 the window route's math warps alone) by
// tools/bench_conv_gemm.py --tier.
#include <cstdio>
#include <cstring>
#include <vector>

#include "conv_gemm_tier.cuh"
#include "conv_gram_tiles.cuh"

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

int* device_ints(const std::vector<int>& h) {
  int* d = nullptr;
  cudaMalloc(&d, h.size() * sizeof(int));
  cudaMemcpy(d, h.data(), h.size() * sizeof(int), cudaMemcpyHostToDevice);
  return d;
}

// The int32 values of a file, as tools/bench_conv_gemm.py writes K11's
// plans (empty where it cannot be read).
std::vector<int> read_ints(const char* path) {
  std::vector<int> v;
  if (FILE* f = std::fopen(path, "rb")) {
    int x;
    while (std::fread(&x, sizeof(int), 1, f) == 1) v.push_back(x);
    std::fclose(f);
  }
  return v;
}

const char* const kTierNames[] = {"highest", "bf16", "bf16x3", "bf16x5"};
// build 5 times the window route alone (gather_gemm_tier's is its build 4)
constexpr bool kConvParts5 = kConvTierParts == 5;

// registers, local (spill) bytes and CTAs an SM of one kernel
template <typename Kernel>
void print_kernel(const char* name, Kernel kernel, int threads, size_t smem) {
  cudaFuncAttributes attr = {};
  cudaFuncGetAttributes(&attr, kernel);
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  int ctas = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel, threads, smem);
  std::printf("%s: %d registers, %zu bytes local, %zu bytes shared, %d "
              "CTAs an SM at %d threads\n", name, attr.numRegs,
              static_cast<size_t>(attr.localSizeBytes), smem, ctas, threads);
}

template <int TIER>
void print_tier_kernels() {
  // the window kernel at the flagship analysis's plan
  constexpr int kTerms = conv_tier_terms(TIER);
  const ConvTierPlan win = conv_tier_plan(64, 256, 64, 2, 33, 33, 40, TIER,
                                          gemm_sm_count());
  char wname[128];
  std::snprintf(wname, sizeof(wname), "conv_window_gemm<%s>",
                kTierNames[TIER]);
  print_kernel(wname, conv_window_gemm<TIER, false>, kWinThreads,
               static_cast<size_t>(win.smem));
  char name[128];
  std::snprintf(name, sizeof(name), "gather_gemm_tier<128, %s>",
                kTierNames[TIER]);
  print_kernel(name, gather_gemm_tier<128, TIER, false>, tier_threads(128),
               tier_smem_bytes(128, kTerms, 256));
  std::snprintf(name, sizeof(name), "gather_gemm_tier<64, %s>",
                kTierNames[TIER]);
  print_kernel(name, gather_gemm_tier<64, TIER, false>, tier_threads(64),
               tier_smem_bytes(64, kTerms, 256));
}

// The words in which the window route's outputs (out, and old under
// kProx) differ from gather_gemm_tier's, from the same inputs.
int tier_bitwise(int tier, const GemmArgs& p, const uint32_t* planes,
                 cudaError_t* err) {
  const size_t n = static_cast<size_t>(p.nb) * p.m * p.out_h * p.out_w;
  const bool prox = p.epilogue == kProx;
  std::vector<float> old_in(prox ? n : 0), want(n), want_old(prox ? n : 0),
      got(n), got_old(prox ? n : 0);
  if (prox)
    cudaMemcpy(old_in.data(), p.old, n * 4, cudaMemcpyDeviceToHost);
  for (int route : {kConvRouteGather, kConvRouteWindow}) {
    if (prox)
      cudaMemcpy(p.old, old_in.data(), n * 4, cudaMemcpyHostToDevice);
    if (*err == cudaSuccess)
      *err = launch_conv_tier_route(route, tier, p, planes, false, 0);
    if (*err == cudaSuccess) *err = cudaDeviceSynchronize();
    std::vector<float>& out = route == kConvRouteGather ? want : got;
    cudaMemcpy(out.data(), p.out, n * 4, cudaMemcpyDeviceToHost);
    if (prox)
      cudaMemcpy((route == kConvRouteGather ? want_old : got_old).data(),
                 p.old, n * 4, cudaMemcpyDeviceToHost);
  }
  if (prox) cudaMemcpy(p.old, old_in.data(), n * 4, cudaMemcpyHostToDevice);
  int differ = 0;
  for (size_t i = 0; i < n; ++i) {
    const bool d = std::memcmp(&want[i], &got[i], 4) != 0;
    const bool d_old = prox && std::memcmp(&want_old[i], &got_old[i], 4) != 0;
    if ((d || d_old) && differ < 3)
      std::printf("  differs at %zu (b %zu, m %zu, position %zu): %.9g / "
                  "%.9g%s\n", i, i / (n / p.nb), i % (n / p.nb) /
                  (p.out_h * p.out_w), i % (p.out_h * p.out_w), want[i],
                  got[i], d_old ? " (old too)" : "");
    differ += d + d_old;
  }
  return *err == cudaSuccess ? differ : -1;
}

// The tier routes' times (see above): mean ms a launch over `reps`.
int tier_main(int reps) {
  const int s = 64, cpx = 64, ax = 2, r = 4, bh = 34, bw = 34;
  const int ch = bh - 1, cw = bw - 1, bmax = 40;
  print_tier_kernels<kTierBf16>();
  print_tier_kernels<kTierBf16x3>();
  print_tier_kernels<kTierBf16x5>();
  const float* dstk = device_random(static_cast<size_t>(cpx) * r * s, 1);
  const float* dall = device_random(static_cast<size_t>(s) * r * cpx, 5);
  uint32_t* planes = nullptr;
  cudaMalloc(&planes, sizeof(uint32_t) *
                          (conv_tier_words(kTierBf16x5, cpx, r * s) +
                           conv_tier_words(kTierBf16x5, s, r * cpx)));
  GemmArgs synth = {};
  synth.a = dstk;
  synth.m = cpx;
  synth.k = r * s;
  synth.src = device_random(static_cast<size_t>(bmax) * s * ch * cw, 2);
  synth.src_c = s;
  synth.src_h = ch;
  synth.src_w = cw;
  synth.off_w = ax;
  synth.sign = -1;
  synth.out_h = bh;
  synth.out_w = bw;
  synth.epilogue = kMaskStore;
  synth.out = device_random(static_cast<size_t>(bmax) * cpx * bh * bw, 3);
  synth.mask = device_random(static_cast<size_t>(cpx) * bh * bw, 4);
  GemmArgs anal = {};
  anal.a = dall;
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
  anal.epilogue = kProx;
  anal.out = device_random(static_cast<size_t>(bmax) * s * ch * cw, 9);
  anal.z_cur = synth.src;
  anal.corr = device_random(static_cast<size_t>(bmax) * s * ch * cw, 6);
  anal.old = device_random(static_cast<size_t>(bmax) * s * ch * cw, 7);
  anal.eta = device_random(1, 8);
  anal.lam = 0.05f;
  anal.beta = 0.3f;
  anal.fista = 1;
  GemmArgs corr = anal;
  corr.src = device_random(static_cast<size_t>(bmax) * cpx * bh * bw, 10);
  corr.epilogue = kStore;
  corr.out = device_random(static_cast<size_t>(bmax) * s * ch * cw, 11);
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  // a route's mean ms a launch over reps: the plan's (route 1 or 2), or
  // the window route on another layout (route 0 with `alt`)
  auto time_route = [&](int route, int tier, const GemmArgs& p,
                        const uint32_t* pl, const ConvTierPlan* alt,
                        cudaError_t* err) {
    float ms = 0.f;
    for (int i = 0; i <= reps && *err == cudaSuccess; ++i) {
      if (i == 1) cudaEventRecord(start);
      *err = alt ? launch_conv_window_stop(tier, p, pl, *alt, false, 0)
                 : launch_conv_tier_route(route, tier, p, pl, false, 0);
    }
    cudaEventRecord(stop);
    cudaEventSynchronize(stop);
    cudaEventElapsedTime(&ms, start, stop);
    if (*err == cudaSuccess) *err = cudaGetLastError();
    return ms / reps;
  };
  bool bad = false;  // a route differed from the other
  for (int tier = kTierBf16; tier <= kTierBf16x5; ++tier) {
    const ConvTierWeights w(tier, kConvRouteAuto, planes, s, cpx, r);
    cudaError_t err = w.fold(dstk, dall, s, cpx, r, 0);
    const std::vector<int> batches =
        kConvTierParts == 4 ? std::vector<int>{40, 35, 30, 25, 20, 15, 10, 5}
                            : std::vector<int>{40, 20, 5};
    for (int batch : batches) {
      for (GemmArgs* p : {&corr, &synth, &anal}) {
        p->nb = batch;
        const uint32_t* pl = p == &synth ? w.stk : w.all;
        const int len = p->out_h * p->out_w;
        const double flops = 2.0 * p->m * p->k * batch * len;
        const char* what = p == &corr ? "corr" : p == &synth ? "synthesis"
                                                             : "analysis";
        const ConvTierPlan plan = conv_tier_plan_of(*p, tier);
        if (kConvTierParts == 4 && err == cudaSuccess) {
          const int differ = tier_bitwise(tier, *p, pl, &err);
          std::printf("%-6s b %2d %-9s: the window route's outputs differ "
                      "from gather_gemm_tier's in %d words\n",
                      kTierNames[tier], batch, what, differ);
          bad = bad || differ != 0;
        }
        for (int route = kConvParts5 ? kConvRouteWindow : kConvRouteGather;
             route <= kConvRouteWindow; ++route) {
          const float ms = time_route(route, tier, *p, pl, nullptr, &err);
          std::printf("parts %d %-6s b %2d %-9s M %d K %d N %d: %-16s %.4f "
                      "ms (%.2f TFLOP/s a pass)", kConvTierParts,
                      kTierNames[tier], batch, what, p->m, p->k, batch * len,
                      route == kConvRouteGather ? "gather_gemm_tier"
                                                : "window",
                      ms, flops / ms / 1e9);
          if (route == kConvRouteWindow)
            std::printf(" [plan: %d rows, %lld tiles, grid %d, %lld B]",
                        plan.rows, plan.tiles, plan.grid, plan.smem);
          std::printf("\n");
        }
        // the window route's other layouts: 1 to 3 rows a tile
        for (int rows = 1; rows <= kWinMaxN / p->out_w && kConvTierParts == 4;
             ++rows) {
          const ConvTierPlan alt = window_plan_at(
              p->m, p->k, p->src_c, p->off_w, p->out_h, p->out_w, batch, tier,
              gemm_sm_count(), rows);
          if (alt.smem > kWinSmem || rows == plan.rows) continue;
          const float ms = time_route(0, tier, *p, pl, &alt, &err);
          std::printf("parts 4 %-6s b %2d %-9s window at %d rows (grid %d, "
                      "%lld tiles): %.4f ms\n", kTierNames[tier], batch, what,
                      rows, alt.grid, alt.tiles, ms);
        }
      }
    }
    if (err != cudaSuccess) {
      std::printf("CUDA error: %s\n", cudaGetErrorString(err));
      return 1;
    }
  }
  return bad ? 1 : 0;
}

}  // namespace

int main(int argc, char** argv) {
  if (argc > 1 && std::strcmp(argv[1], "--tier") == 0) return tier_main(50);
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
            launch_gather_gemm(*p, len, 0);
        }
        cudaEventRecord(stop);
        cudaEventSynchronize(stop);
        cudaEventElapsedTime(&ms[line], start, stop);
        ms[line] /= reps;
      }
      const double flops = 2.0 * p->m * p->k * positions;
      const cudaError_t err = cudaGetLastError();
      std::printf(
          "b %2d %-9s M %d K %d N %lld: tiled %.4f ms (%.2f TFLOP/s), "
          "gather_gemm %.4f ms (%.2f TFLOP/s)%s%s\n",
          batch, p == &synth ? "synthesis" : "analysis", p->m, p->k,
          positions, ms[0], flops / ms[0] / 1e9, ms[1], flops / ms[1] / 1e9,
          err == cudaSuccess ? "" : " CUDA error: ",
          err == cudaSuccess ? "" : cudaGetErrorString(err));
      if (err != cudaSuccess) return 1;
    }
  }
  // K11's iteration: 9 offsets, the plans of argv[1]: per geometry b, s,
  // n (n x n codes), tiles, items, multi_items, then the slots, class
  // words and work items
  const int offsets = 9;
  const std::vector<int> plans = argc > 1 ? read_ints(argv[1])
                                          : std::vector<int>();
  if (argc > 1 && plans.empty()) {
    std::fprintf(stderr, "cannot read the plans of %s\n", argv[1]);
    return 1;
  }
  for (size_t at = 0; at < plans.size();) {
    const int gb = plans[at], gs = plans[at + 1], n = plans[at + 2];
    const int n_tiles = plans[at + 3], n_items = plans[at + 4];
    const int multi = plans[at + 5];
    at += 6;
    const std::vector<int> slots(plans.begin() + at,
                                 plans.begin() + at + n_tiles * kGramBN);
    at += slots.size();
    const std::vector<int> words(plans.begin() + at,
                                 plans.begin() + at + n_tiles);
    at += n_tiles;
    const std::vector<int> items(plans.begin() + at,
                                 plans.begin() + at + n_items);
    at += n_items;
    const int m_tiles = (gs + kBM - 1) / kBM;
    const size_t mat = static_cast<size_t>(gs) * offsets * gs;
    const size_t codes = static_cast<size_t>(gb) * gs * n * n;
    const size_t n_tickets = words.size() * m_tiles;
    unsigned* tickets = nullptr;
    cudaMalloc(&tickets, n_tickets * sizeof(unsigned));
    cudaMemset(tickets, 0, n_tickets * sizeof(unsigned));
    const GramTiles g = {device_random(mat, 11),
                         device_random(2 * mat, 12),
                         device_random(2 * mat, 13),
                         device_random(4 * mat, 14),
                         device_ints(slots),
                         device_ints(words),
                         device_ints(items),
                         device_random(static_cast<size_t>(m_tiles) * multi *
                                           kBM * kGramBN, 19),
                         tickets,
                         static_cast<int>(words.size()),
                         multi,
                         2,
                         2,
                         offsets};
    GemmArgs p = {};
    p.m = gs;
    p.k = offsets * gs;
    p.src = device_random(codes, 15);
    p.src_c = gs;
    p.src_h = p.src_w = p.out_h = p.out_w = n;
    p.off_w = 3;
    p.sign = 1;
    p.off_y0 = p.off_x0 = -1;
    p.nb = gb;
    p.epilogue = kProx;
    p.out = device_random(codes, 16);
    p.z_cur = p.src;
    p.corr = device_random(codes, 17);
    p.old = device_random(codes, 18);
    p.eta = eta;
    p.lam = 0.05f;
    p.beta = 0.3f;
    p.fista = 1;
    cudaError_t err = cudaSuccess;
    for (int i = 0; i <= reps && err == cudaSuccess; ++i) {
      if (i == 1) cudaEventRecord(start);
      err = launch_gram_class_gemm(p, g, n_items, false, 0);
    }
    cudaEventRecord(stop);
    cudaEventSynchronize(stop);
    float ms = 0.f;
    cudaEventElapsedTime(&ms, start, stop);
    ms /= reps;
    if (err == cudaSuccess) err = cudaGetLastError();
    // the operator's work: G_int at every position, a correction a
    // position of the special rows and columns, the corners once more
    const double flops = 2.0 * offsets * gs * gs * gb *
                         (n * n + 2 * n + 2 * n + 4);
    std::printf(
        "gram_class_gemm b %d s %d K %d codes %dx%d, %d tiles of %d, %d "
        "items: %.4f ms (%.2f TFLOP/s)%s%s\n",
        gb, gs, p.k, n, n, n_tiles, kGramBN, n_items, ms,
        flops / ms / 1e9,
        err == cudaSuccess ? "" : " CUDA error: ",
        err == cudaSuccess ? "" : cudaGetErrorString(err));
    if (err != cudaSuccess) return 1;
  }
  return 0;
}
