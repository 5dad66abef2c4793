// Times K19's residual-form train step on its two routes alone
// (vtc_tpu_torch/csrc/fused_code_shard_train_step.cu and
// code_shard_solve.cuh) at bench.py's big-dictionary shape: s 2048, n 256,
// b 128, FISTA 25, warm power 2, cheap-quadratic update at 0.1, lambda
// 0.008; fc and 512 contiguous groups of 4.  The dictionary has unit rows
// drawn from N(0, 1); the batches are N(0, 1), as bench.py's randn rows.
// It prints:
//
//   * for each route, us a step (the slope between segments of 5 and 25
//     steps), in turns steps, persistent, persistent, steps; and whether
//     the two routes' D, h, v, codes and eta are bitwise equal after a
//     5-step segment;
//   * us an iteration of each route: the slope of a 20-step segment's
//     time from FISTA 5 to FISTA 25;
//   * the persistent kernel's phases alone, each repeated on its grid with
//     a grid barrier after every repetition, less the barrier: phase A
//     (the reconstruction's partials), its product alone (no store), phase
//     S (the split sum) and phase B (the product, the prox and the
//     momentum; fc and groups of 4);
//   * us a grid barrier alone on the solve's grid;
//   * the solve kernel's grid and CTAs per SM.
//
// Built and run by tools/bench_code_shard_solve.py.
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

#include "fused_code_shard_train_step.cu"

namespace {

constexpr int kS = 2048;
constexpr int kN = 256;
constexpr int kB = 128;
constexpr int kIters = 25;
constexpr int kWindow = 4;
constexpr float kLam = 0.008f;
constexpr float kStep = 0.1f;

#define BENCH_CHECK(call)                                                 \
  do {                                                                    \
    const cudaError_t e_ = (call);                                        \
    if (e_ != cudaSuccess) {                                              \
      std::fprintf(stderr, "%s:%d %s\n", __FILE__, __LINE__,              \
                   cudaGetErrorString(e_));                               \
      std::exit(1);                                                       \
    }                                                                     \
  } while (0)

float* device_copy(const std::vector<float>& h) {
  float* d = nullptr;
  BENCH_CHECK(cudaMalloc(&d, sizeof(float) * h.size()));
  BENCH_CHECK(cudaMemcpy(d, h.data(), sizeof(float) * h.size(),
                         cudaMemcpyHostToDevice));
  return d;
}

float* device_zeros(size_t count) {
  float* d = nullptr;
  BENCH_CHECK(cudaMalloc(&d, sizeof(float) * count));
  BENCH_CHECK(cudaMemset(d, 0, sizeof(float) * count));
  return d;
}

std::vector<float> fetch(const float* d, size_t count) {
  std::vector<float> h(count);
  BENCH_CHECK(cudaMemcpy(h.data(), d, sizeof(float) * count,
                         cudaMemcpyDeviceToHost));
  return h;
}

struct Problem {
  std::vector<float> d0, v0, batches;
};

struct Buffers {
  float *d, *h, *v, *x, *pgram, *partial, *rbuf, *z, *old, *grad, *eta,
      *betas;
  unsigned* barrier;
};

constexpr int kLong = 25, kShort = 5;

Buffers make_buffers(const Problem& pr) {
  Buffers b{};
  b.d = device_copy(pr.d0);
  b.h = device_zeros(kS);
  b.v = device_copy(pr.v0);
  b.x = device_copy(pr.batches);
  b.pgram = device_zeros(kN * kN);
  b.partial = device_zeros(static_cast<size_t>(kS / kSplitK) * kN * kN);
  b.rbuf = device_zeros(kB * kN);
  b.z = device_zeros(kB * kS);
  b.old = device_zeros(kB * kS);
  b.grad = device_zeros(kS * kN);
  b.eta = device_zeros(1);
  b.betas = device_zeros(kIters);
  BENCH_CHECK(cudaMalloc(&b.barrier, 2 * sizeof(unsigned)));
  return b;
}

void reset(const Buffers& b, const Problem& pr) {
  BENCH_CHECK(cudaMemcpy(b.d, pr.d0.data(), sizeof(float) * kS * kN,
                         cudaMemcpyHostToDevice));
  BENCH_CHECK(cudaMemcpy(b.v, pr.v0.data(), sizeof(float) * kN,
                         cudaMemcpyHostToDevice));
  BENCH_CHECK(cudaMemset(b.h, 0, sizeof(float) * kS));
}

// One segment of k steps on a route (0 steps, 1 persistent), window 0
// (fc) or kWindow.
int run(const Buffers& b, int route, int k, int window, int iters,
        int grid = 0) {
  return vtc_code_shard_train_segment(
      b.d, b.h, b.v, b.x, k, kB, kS, kN, window, nullptr, 0, 0, nullptr,
      0.0f, kLam, iters, kStep, 1, 0.001f, 1, 0, 1, 1, 2, 1.0f / kB,
      b.pgram, b.partial, b.rbuf, b.z, b.old, nullptr, b.grad, nullptr,
      nullptr, nullptr, b.eta, 1, 1, nullptr, nullptr, route, grid, b.betas,
      b.barrier, -1.0f, 0.0f, nullptr, nullptr, nullptr, nullptr, nullptr);
}

float time_segment(const Buffers& b, const Problem& pr, int route, int k,
                   int window, int iters, int reps = 3) {
  cudaEvent_t t0, t1;
  BENCH_CHECK(cudaEventCreate(&t0));
  BENCH_CHECK(cudaEventCreate(&t1));
  float best = 1e30f;
  for (int r = 0; r <= reps; ++r) {
    reset(b, pr);
    BENCH_CHECK(cudaDeviceSynchronize());
    BENCH_CHECK(cudaEventRecord(t0));
    if (run(b, route, k, window, iters) != 0) {
      std::fprintf(stderr, "route %d launch failed\n", route);
      std::exit(1);
    }
    BENCH_CHECK(cudaEventRecord(t1));
    BENCH_CHECK(cudaEventSynchronize(t1));
    float ms = 0.0f;
    BENCH_CHECK(cudaEventElapsedTime(&ms, t0, t1));
    if (r > 0 && ms < best) best = ms;
  }
  BENCH_CHECK(cudaEventDestroy(t0));
  BENCH_CHECK(cudaEventDestroy(t1));
  return best;
}

// The solve kernel's parts, reps times on its grid, a grid barrier after
// each: what = 0 phase A (product and partial store), 1 phase A's product
// alone (stored only if it is not finite, which it is), 2 phase S (the
// split sum), 3 phase B (product, prox, momentum), 4 nothing (the barrier
// alone), 5 phase A's FMAs alone (on whatever shared memory holds), 6
// phase A's copies alone (issued, then all waited for), 7 phase B's
// product with a plain store of its outputs (no prox, no momentum; into
// the partials' buffer), 8 phase B's copies alone, 9 phase B's FMAs alone,
// 10 phase B's product (as 7) with z's rows (row length s, read by 4
// CTAs a block, as phase A's) in place of r's (read by 32).
// The D slices are resident as in the solve.
template <int kWhat>
__global__ void __launch_bounds__(kCsThreads, 1)
    phase_kernel(SolveArgs p, int reps) {
  extern __shared__ __align__(16) unsigned char ph_smem[];
  SolveSmem& sm = *reinterpret_cast<SolveSmem*>(ph_smem);
  const SolveCopy mode = cs_copy_mode(p);
  const int tiles_a = cs_tiles_a(p.b, p.s, p.n);
  const int tiles_b = cs_tiles_b(p.b, p.s);
  const int grid = static_cast<int>(gridDim.x);
  const int t0 = static_cast<int>(blockIdx.x);
  unsigned target = p.barrier_base;
  int key_a = -1, key_b = -1;
  if (grid >= tiles_a && t0 < tiles_a) {
    cs_prefetch_a(sm, p, t0);
    key_a = cs_key_a(p, t0);
  }
  if (grid >= tiles_b && t0 < tiles_b) {
    cs_prefetch_b(sm, p, mode.d, t0);
    key_b = cs_key_b(p, t0, 0);
  }
  seg_cp_async_commit();
  const float eta = *p.eta;
  const float lam_eta = __fmul_rn(p.lam, eta);
  const int per = cs_out_tiles(p.b, p.n), ctn = cs_cdiv(p.n, kCsTileN);
  const bool held = grid >= tiles_b;
  float zv[4][4] = {}, ov[4][4] = {};
  float no_share = 0.0f;  // phase B without the early stop's share
  for (int it = 0; it < reps; ++it) {
    if (kWhat == 0) {
      for (int t = t0; t < tiles_a; t += grid)
        cs_phase_a_tile(sm, p, mode, p.z, t, key_a);
    } else if (kWhat == 1) {
      for (int t = t0; t < tiles_a; t += grid) {
        const int c = t / per, o = t % per;
        const int i0 = (o / ctn) * kCsTileM, j0 = (o % ctn) * kCsTileN;
        const int kb = c * kSplitK;
        const int key = cs_key_a(p, t);
        const bool load = key != key_a;
        key_a = key;
        float acc[4][4] = {};
        cs_block<true>(sm, sm.da, p.z, p.s, p.b, i0, mode.codes, p.d, p.s,
                       p.n, j0, load, false, kb, kb + kSplitK, acc);
        float* part = p.partial + static_cast<int64_t>(c) * p.b * p.n;
        for (int r = 0; r < 4; ++r)
          for (int cc = 0; cc < 4; ++cc)
            if (!isfinite(acc[r][cc]))
              part[static_cast<int64_t>(i0 + cs_row(r)) * p.n + j0 +
                   cs_col(cc)] = acc[r][cc];
      }
    } else if (kWhat == 2) {
      cs_sum_phase(p, mode);
    } else if (kWhat == 7 || kWhat == 10) {
      if (t0 < tiles_b) {
        const int i0 = cs_row_block(p, t0) * kCsTileM;
        const int j0 = cs_col_block(p, t0) * kCsTileN;
        float acc[4][4] = {};
        if (kWhat == 7)
          cs_block<false>(sm, sm.db, p.r, p.n, p.b, i0, mode.r, p.d, p.s,
                          p.n, j0, false, mode.d, 0, p.n, acc);
        else
          cs_block<false>(sm, sm.db, p.z + (t0 % 8) * kCsDepth, p.s, p.b, i0,
                          mode.codes, p.d, p.s, p.n, j0, false, mode.d, 0,
                          p.n, acc);
        for (int r = 0; r < 4; ++r)
          for (int cc = 0; cc < 4; ++cc)
            p.partial[static_cast<int64_t>(i0 + cs_row(r)) * p.s + j0 +
                      cs_col(cc)] = acc[r][cc];
      }
    } else if (kWhat == 8) {
      if (t0 < tiles_b) {
        cs_issue<false>(sm, sm.db, p.r, p.n, p.b,
                        cs_row_block(p, t0) * kCsTileM, mode.r, p.d, p.s,
                        p.n, cs_col_block(p, t0) * kCsTileN, false,
                        mode.d, 0, p.n);
        cs_wait(0);
        __syncthreads();
      }
    } else if (kWhat == 5 || kWhat == 9) {
      float acc[4][4] = {};
      for (int st = 0; st < kSplitK / kCsSlice; ++st)
        cs_slice_fma(sm, kWhat == 5 ? sm.da : sm.db, st * kCsSlice,
                     kCsSlice, acc);
      __syncthreads();
      for (int r = 0; r < 4; ++r)
        for (int cc = 0; cc < 4; ++cc)
          if (!isfinite(acc[r][cc])) p.partial[threadIdx.x] = acc[r][cc];
    } else if (kWhat == 6) {
      if (t0 < tiles_a) {
        const int o = t0 % per;
        const int kb = (t0 / per) * kSplitK;
        cs_issue<true>(sm, sm.da, p.z, p.s, p.b, (o / ctn) * kCsTileM,
                       mode.codes, p.d, p.s, p.n, (o % ctn) * kCsTileN,
                       false, false, kb, kb + kSplitK);
        cs_wait(0);
        __syncthreads();
      }
    } else if (kWhat == 3) {
      for (int t = t0; t < tiles_b; t += grid)
        cs_phase_b_tile(sm, p, mode, t, eta, lam_eta, 0.5f, key_b, held,
                        zv, ov, false,
                        no_share);
    }
    seg_grid_sync(p.barrier, target);
  }
  cs_wait(0);
}

template <int kWhat>
float time_phase(const Buffers& b, int window, int reps, int grid) {
  SolveArgs a{};
  a.x = b.x;
  a.d = b.d;
  a.z = b.z;
  a.old = b.old;
  a.partial = b.partial;
  a.r = b.rbuf;
  a.eta = b.eta;
  a.betas = b.betas;
  a.barrier = b.barrier;
  a.lam = kLam;
  a.fista = 1;
  a.window = window;
  a.b = kB;
  a.s = kS;
  a.n = kN;
  a.num_iters = kIters;
  auto kernel = phase_kernel<kWhat>;
  BENCH_CHECK(cudaFuncSetAttribute(kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(sizeof(SolveSmem))));
  cudaEvent_t t0, t1;
  BENCH_CHECK(cudaEventCreate(&t0));
  BENCH_CHECK(cudaEventCreate(&t1));
  float best = 1e30f;
  for (int r = 0; r < 4; ++r) {
    BENCH_CHECK(cudaMemset(b.barrier, 0, sizeof(unsigned)));
    void* params[] = {&a, &reps};
    BENCH_CHECK(cudaEventRecord(t0));
    BENCH_CHECK(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(kernel), dim3(grid), dim3(kCsThreads),
        params, sizeof(SolveSmem), nullptr));
    BENCH_CHECK(cudaEventRecord(t1));
    BENCH_CHECK(cudaEventSynchronize(t1));
    float ms = 0.0f;
    BENCH_CHECK(cudaEventElapsedTime(&ms, t0, t1));
    if (r > 0 && ms < best) best = ms;
  }
  return 1e3f * best / reps;
}

}  // namespace

int main() {
  std::mt19937 gen(15);
  std::normal_distribution<float> normal(0.0f, 1.0f);
  Problem pr;
  pr.d0.resize(static_cast<size_t>(kS) * kN);
  for (int i = 0; i < kS; ++i) {
    double sq = 0.0;
    for (int j = 0; j < kN; ++j) {
      const float u = normal(gen);
      pr.d0[i * kN + j] = u;
      sq += static_cast<double>(u) * u;
    }
    const float inv = static_cast<float>(1.0 / std::sqrt(sq));
    for (int j = 0; j < kN; ++j) pr.d0[i * kN + j] *= inv;
  }
  pr.v0.assign(kN, 1.0f);
  pr.batches.resize(static_cast<size_t>(kLong) * kB * kN);
  for (float& v : pr.batches) v = normal(gen);
  Buffers b = make_buffers(pr);
  const int grid = vtc_code_shard_grid(kB, kS, kN);
  std::printf("solve kernel: grid %d CTAs, %d CTAs per SM, %d SMs; %zu "
              "bytes of shared memory a CTA; phases A %d, B %d tiles; "
              "barriers a step at FISTA %d: %d\n",
              grid, vtc_code_shard_blocks_per_sm(), vtc_code_shard_sm_count(),
              sizeof(SolveSmem), cs_tiles_a(kB, kS, kN), cs_tiles_b(kB, kS),
              kIters, cs_step_barriers(kIters, 0, 1));

  const char* names[2] = {"steps", "persistent"};
  bool all_same = true;
  for (int window : {0, kWindow}) {
    const char* label = window ? "grouped 512x4" : "fc";
    std::vector<float> out[2][5];
    for (int route = 0; route < 2; ++route) {
      reset(b, pr);
      if (run(b, route, kShort, window, kIters) != 0) return 1;
      BENCH_CHECK(cudaDeviceSynchronize());
      out[route][0] = fetch(b.d, static_cast<size_t>(kS) * kN);
      out[route][1] = fetch(b.h, kS);
      out[route][2] = fetch(b.v, kN);
      out[route][3] = fetch(b.old, static_cast<size_t>(kB) * kS);
      out[route][4] = fetch(b.eta, 1);
    }
    bool same = true;
    for (int w = 0; w < 5; ++w)
      same = same && std::memcmp(out[0][w].data(), out[1][w].data(),
                                 sizeof(float) * out[0][w].size()) == 0;
    all_same = all_same && same;
    std::printf("%s: bitwise equal after %d steps (D, h, v, codes, eta): "
                "%s\n", label, kShort, same ? "yes" : "NO");
    float slope[2] = {0.0f, 0.0f};
    for (int route : {0, 1, 1, 0}) {
      const float s = time_segment(b, pr, route, kShort, window, kIters);
      const float l = time_segment(b, pr, route, kLong, window, kIters);
      const float us = 1e3f * (l - s) / (kLong - kShort);
      slope[route] += 0.5f * us;
      std::printf("%s, %-10s route: %.4f ms / %d steps, %.4f ms / %d "
                  "steps: %.3f us a step\n",
                  label, names[route], s, kShort, l, kLong, us);
    }
    std::printf("%s us a step (mean of the two turns): steps %.3f, "
                "persistent %.3f (%.2fx)\n",
                label, slope[0], slope[1], slope[0] / slope[1]);
    for (int route : {0, 1}) {
      const float lo = time_segment(b, pr, route, 20, window, 5);
      const float hi = time_segment(b, pr, route, 20, window, kIters);
      std::printf("%s, %-10s route: FISTA 5 -> %d over 20 steps: %.4f -> "
                  "%.4f ms: %.3f us an iteration\n",
                  label, names[route], kIters, lo, hi,
                  1e3f * (hi - lo) / (20.0f * (kIters - 5)));
    }
  }

  // the phases alone, on the state a segment left
  reset(b, pr);
  if (run(b, 1, kShort, 0, kIters) != 0) return 1;
  BENCH_CHECK(cudaDeviceSynchronize());
  constexpr int kReps = 400;
  const float barrier = time_phase<4>(b, 0, kReps, grid);
  const float pa = time_phase<0>(b, 0, kReps, grid);
  const float pa_prod = time_phase<1>(b, 0, kReps, grid);
  const float ps = time_phase<2>(b, 0, kReps, grid);
  const float pb = time_phase<3>(b, 0, kReps, grid);
  const float pb_w = time_phase<3>(b, kWindow, kReps, grid);
  std::printf("grid barrier alone (%d CTAs): %.3f us\n", grid, barrier);
  const float fmas = time_phase<5>(b, 0, kReps, grid);
  const float copies = time_phase<6>(b, 0, kReps, grid);
  const float pb_prod = time_phase<7>(b, 0, kReps, grid);
  const float pb_copies = time_phase<8>(b, 0, kReps, grid);
  const float pb_fmas = time_phase<9>(b, 0, kReps, grid);
  const float pb_z = time_phase<10>(b, 0, kReps, grid);
  std::printf("phase A %.3f us (its product alone %.3f: FMAs alone %.3f, "
              "copies alone %.3f); phase S %.3f us; phase B fc %.3f us "
              "(its product with a plain store %.3f: FMAs alone %.3f, "
              "copies alone %.3f; with z's rows as A %.3f), window %d %.3f "
              "us; each less the barrier\n",
              pa - barrier, pa_prod - barrier, fmas - barrier,
              copies - barrier, ps - barrier, pb - barrier,
              pb_prod - barrier, pb_fmas - barrier, pb_copies - barrier,
              pb_z - barrier, kWindow, pb_w - barrier);
  return all_same ? 0 : 2;
}
