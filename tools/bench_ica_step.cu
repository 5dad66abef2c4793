// Times the ICA train step's two routes alone
// (vtc_tpu_torch/csrc/fused_ica_train_step.cu and ica_segment.cuh) at
// chip_smoke.py's ICA shape: n = 256, b = 250, refine_iters 3,
// upd_num_iters 1, the boost armed at 1e-6 (and off, once), stepsize
// 0.001.  The dictionary is I + 0.01 U (U uniform in
// [-1, 1] / sqrt(n)) and the inverse seed I - 0.01 U; the batches are
// uniform in [-1, 1].  It prints:
//
//   * for each route, ms per step over segments of 25 and 225 steps and
//     µs per step (the slope between the two), in turns steps,
//     persistent, persistent, steps; and whether the two routes' D, X and
//     r_max are bitwise equal after a 25-step segment;
//   * µs per phase of the persistent kernel: the slope of its step time
//     from refine_iters 3 to 5 over the four refresh phases that adds;
//   * µs per grid barrier: a kernel of empty phases on the segment
//     kernel's grid (the barrier alone);
//   * the segment kernel's grid and CTAs per SM.
//
// Built and run by tools/bench_ica_step.py.
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <random>
#include <vector>

#include "fused_ica_train_step.cu"

namespace {

constexpr int kN = 256;
constexpr int kB = 250;
constexpr float kStep = 0.001f;
constexpr float kBoostTol = 1e-6f;

#define BENCH_CHECK(call)                                                 \
  do {                                                                    \
    const cudaError_t e_ = (call);                                        \
    if (e_ != cudaSuccess) {                                              \
      std::fprintf(stderr, "%s:%d %s\n", __FILE__, __LINE__,              \
                   cudaGetErrorString(e_));                               \
      std::exit(1);                                                       \
    }                                                                     \
  } while (0)

// Where the CTAs of a launch shaped as the segment kernel's land: the SM
// of each block.
__global__ void __launch_bounds__(kSegThreads) smid_kernel(int* sm_of) {
  if (threadIdx.x == 0) {
    int id;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
    sm_of[blockIdx.x] = id;
  }
}

// A kernel of num empty phases: the grid barrier alone.
__global__ void __launch_bounds__(kSegThreads)
    barrier_kernel(unsigned* counter, int num, float* out) {
  unsigned target = 0;
  for (int i = 0; i < num; ++i) seg_grid_sync(counter, target);
  if (threadIdx.x == 0) out[blockIdx.x] = static_cast<float>(target);
}

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

struct Problem {
  std::vector<float> d0, x0, batches;
};

struct Buffers {
  float *d, *x, *r_max, *batches, *eye, *eye2, *x_alt, *d_alt, *e, *codes,
      *sgn, *stat, *m, *p, *partials;
  int* boost;
  unsigned* barrier;
};

Buffers make_buffers(const Problem& pr, int grid) {
  Buffers b{};
  b.d = device_copy(pr.d0);
  b.x = device_copy(pr.x0);
  b.r_max = device_zeros(1);
  b.batches = device_copy(pr.batches);
  std::vector<float> eye(kN * kN, 0.0f), eye2(kN * kN, 0.0f);
  for (int i = 0; i < kN; ++i) {
    eye[i * kN + i] = 1.0f;
    eye2[i * kN + i] = 2.0f;
  }
  b.eye = device_copy(eye);
  b.eye2 = device_copy(eye2);
  b.x_alt = device_zeros(kN * kN);
  b.d_alt = device_zeros(kN * kN);
  b.e = device_zeros(kN * kN);
  b.codes = device_zeros(kB * kN);
  b.sgn = device_zeros(kB * kN);
  b.stat = device_zeros(kN * kN);
  b.m = device_zeros(kN * kN);
  b.p = device_zeros(kN * kN);
  b.partials = device_zeros(grid);
  BENCH_CHECK(cudaMalloc(&b.boost, sizeof(int)));
  BENCH_CHECK(cudaMemset(b.boost, 0, sizeof(int)));
  BENCH_CHECK(cudaMalloc(&b.barrier, sizeof(unsigned)));
  return b;
}

// Reset D, X and r_max to the problem's start.
void reset(const Buffers& b, const Problem& pr) {
  BENCH_CHECK(cudaMemcpy(b.d, pr.d0.data(), sizeof(float) * kN * kN,
                         cudaMemcpyHostToDevice));
  BENCH_CHECK(cudaMemcpy(b.x, pr.x0.data(), sizeof(float) * kN * kN,
                         cudaMemcpyHostToDevice));
  BENCH_CHECK(cudaMemset(b.r_max, 0, sizeof(float)));
}

// One segment of k steps on a route (0 steps, 1 persistent on grid CTAs,
// 0 for the shape's own grid).
int run(const Buffers& b, int route, int k, int refine, int grid = 0,
        int upd = 1, int boost = 1) {
  if (route == 0)
    return vtc_ica_train_segment(b.d, b.x, b.r_max, b.batches, b.eye, b.eye2,
                                 k, kB, kN, kStep, refine, upd, boost,
                                 kBoostTol, b.x_alt, b.e, b.codes, b.sgn,
                                 b.stat, b.m, b.p, b.boost, kTierHighest,
                                 nullptr);
  return vtc_ica_persistent_segment(
      b.d, b.x, b.r_max, b.batches, k, kB, kN, kStep, refine, upd, boost,
      kBoostTol, static_cast<float>(kB), b.d_alt, b.x_alt, b.e, b.codes,
      b.stat, b.partials, b.barrier, grid, nullptr, kTierHighest, nullptr);
}

// ms of one segment of k steps, the best of reps after a warm-up.
float time_segment(const Buffers& b, const Problem& pr, int route, int k,
                   int refine, int reps, int grid = 0, int upd = 1,
                   int boost = 1) {
  cudaEvent_t t0, t1;
  BENCH_CHECK(cudaEventCreate(&t0));
  BENCH_CHECK(cudaEventCreate(&t1));
  float best = 1e30f;
  for (int r = 0; r <= reps; ++r) {
    reset(b, pr);
    BENCH_CHECK(cudaDeviceSynchronize());
    BENCH_CHECK(cudaEventRecord(t0));
    if (run(b, route, k, refine, grid, upd, boost) != 0) {
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

std::vector<float> fetch(const float* d, size_t count) {
  std::vector<float> h(count);
  BENCH_CHECK(cudaMemcpy(h.data(), d, sizeof(float) * count,
                         cudaMemcpyDeviceToHost));
  return h;
}

// The parts of a tile, each CTA on its own tile of an n x n product
// (D X), num times, no grid barrier: what = 0 the whole product, 1 its
// copies alone (the ring and its waits), 2 its FMAs alone (on whatever
// the ring holds), 3 the product, its store and a grid barrier (a refresh
// phase).
template <int kWhat>
__global__ void __launch_bounds__(kSegThreads)
    part_kernel(const float* A, const float* B, float* out, int num,
                unsigned* counter) {
  extern __shared__ __align__(16) unsigned char part_smem[];
  SegSmem& sm = *reinterpret_cast<SegSmem*>(part_smem);
  unsigned target = 0;
  float acc[2][2] = {};
  const SegA a{A, A, kN, 0};
  const int tiles_n = kN / kSegTileN;
  const int i0 = (blockIdx.x / tiles_n) * kSegTileM;
  const int j0 = (blockIdx.x % tiles_n) * kSegTileN;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  for (int it = 0; it < num; ++it) {
    if (kWhat == 0 || kWhat == 3) {
      seg_tile_product<kSegA, kSegB, false>(sm, a, B, kN, kN, i0, j0, acc);
    } else if (kWhat == 1) {
      const SegCopy mode = seg_copy_mode<kSegA>(a, B, kN, kN);
      for (int s = 0; s < kN / kSegSlice; ++s) {
        seg_load_a<kSegA, false>(sm, mode, s, a, kN, i0, s * kSegSlice);
        seg_load_b(sm, mode, s, B, kN, kN, j0, s * kSegSlice);
        seg_cp_async_commit();
      }
      seg_cp_async_wait<0>();
      __syncthreads();
      acc[0][0] += sm.a[it % kSegStages][ty][0];
    } else {
      for (int s = 0; s < kN / kSegSlice; ++s)
        seg_slice_fma<2, kSegA>(sm, s % kSegStages, kSegSlice, acc);
      __syncthreads();
    }
    if (kWhat == 3) {
      for (int r = 0; r < 2; ++r)
        for (int c = 0; c < 2; ++c)
          out[(i0 + ty + 16 * r) * kN + j0 + 2 * tx + c] = acc[r][c];
      seg_grid_sync(counter, target);
    }
  }
  for (int r = 0; r < 2; ++r)
    for (int c = 0; c < 2; ++c)
      out[(i0 + ty + 16 * r) * kN + j0 + 2 * tx + c] = acc[r][c];
}

// The other two tiles alone, num times on 128 CTAs: what = 0 the
// statistic's (codes^T sign(codes), A k-major, K = b), 1 the residual and
// codes phase's pair (D X with batch X, four rows a thread).
template <int kWhat>
__global__ void __launch_bounds__(kSegThreads)
    other_tile_kernel(const float* d, const float* x, const float* batch,
                      const float* codes, float* out, int num) {
  extern __shared__ __align__(16) unsigned char other_smem[];
  SegSmem& sm = *reinterpret_cast<SegSmem*>(other_smem);
  float acc[4][2] = {};
  const int tiles_n = kN / kSegTileN;
  const int i0 = (blockIdx.x / tiles_n) * kSegTileM;
  const int j0 = (blockIdx.x % tiles_n) * kSegTileN;
  for (int it = 0; it < num; ++it) {
    if (kWhat == 0)
      seg_tile_product<kSegATransposed, kSegBSign, false>(
          sm, SegA{codes, codes, kN, 0}, codes, kN, kB, i0, j0, acc);
    else if (kWhat == 1)
      seg_tile_product<kSegA, kSegB, true>(sm, SegA{d, batch, kN, kB}, x, kN,
                                           kN, i0, j0, acc);
    else if (kWhat == 2)  // the statistic's tile without the sign
      seg_tile_product<kSegATransposed, kSegB, false>(
          sm, SegA{codes, codes, kN, 0}, codes, kN, kB, i0, j0, acc);
    else if (kWhat == 3)  // a row-major A tile at K 252
      seg_tile_product<kSegA, kSegB, false>(sm, SegA{d, d, kN, 0}, x, kN, 252,
                                            i0, j0, acc);
    else if (kWhat == 4)  // the D X tile on a ring of 3 stages
      seg_tile_product<kSegA, kSegB, false, 3>(sm, SegA{d, d, kN, 0}, x, kN,
                                               kN, i0, j0, acc);
    else if (kWhat == 5)  // the D X tile on a ring of 4 stages
      seg_tile_product<kSegA, kSegB, false, 4>(sm, SegA{d, d, kN, 0}, x, kN,
                                               kN, i0, j0, acc);
    else {
      // 6: every copy, one wait, then every FMA; 7: the copies issued while
      // the FMAs run on what the ring holds, no wait (contention alone)
      const SegA a{d, d, kN, 0};
      const SegCopy mode = seg_copy_mode<kSegA>(a, x, kN, kN);
      for (int s = 0; s < kSegStages; ++s) {
        seg_load_a<kSegA, false>(sm, mode, s, a, kN, i0, s * kSegSlice);
        seg_load_b(sm, mode, s, x, kN, kN, j0, s * kSegSlice);
        seg_cp_async_commit();
        if (kWhat == 7) seg_slice_fma<2, kSegA>(sm, s, kSegSlice, acc);
      }
      seg_cp_async_wait<0>();
      __syncthreads();
      if (kWhat == 6)
        for (int s = 0; s < kSegStages; ++s)
          seg_slice_fma<2, kSegA>(sm, s, kSegSlice, acc);
      __syncthreads();
    }
  }
  float total = 0.0f;
  for (int r = 0; r < 4; ++r) total += acc[r][0] + acc[r][1];
  out[blockIdx.x * kSegThreads + threadIdx.x] = total;
}

template <int kWhat>
float time_other(const Buffers& b, int num) {
  BENCH_CHECK(cudaFuncSetAttribute(other_tile_kernel<kWhat>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(sizeof(SegSmem))));
  cudaEvent_t t0, t1;
  BENCH_CHECK(cudaEventCreate(&t0));
  BENCH_CHECK(cudaEventCreate(&t1));
  float best = 1e30f;
  for (int r = 0; r < 3; ++r) {
    BENCH_CHECK(cudaEventRecord(t0));
    other_tile_kernel<kWhat><<<seg_tiles(kN, kN), kSegThreads,
                               sizeof(SegSmem)>>>(b.d, b.x, b.batches,
                                                  b.batches, b.e, num);
    BENCH_CHECK(cudaGetLastError());
    BENCH_CHECK(cudaEventRecord(t1));
    BENCH_CHECK(cudaEventSynchronize(t1));
    float ms = 0.0f;
    BENCH_CHECK(cudaEventElapsedTime(&ms, t0, t1));
    if (ms < best) best = ms;
  }
  return 1e3f * best / num;
}

template <int kWhat>
float time_part(const Buffers& b, int num) {
  BENCH_CHECK(cudaFuncSetAttribute(part_kernel<kWhat>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(sizeof(SegSmem))));
  cudaEvent_t t0, t1;
  BENCH_CHECK(cudaEventCreate(&t0));
  BENCH_CHECK(cudaEventCreate(&t1));
  const float* A = b.d;
  const float* B = b.x;
  float* out = b.e;
  unsigned* counter = b.barrier;
  float best = 1e30f;
  for (int r = 0; r < 3; ++r) {
    BENCH_CHECK(cudaMemset(b.barrier, 0, sizeof(unsigned)));
    void* params[] = {&A, &B, &out, &num, &counter};
    BENCH_CHECK(cudaEventRecord(t0));
    BENCH_CHECK(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(part_kernel<kWhat>),
        dim3(seg_tiles(kN, kN)), dim3(kSegThreads), params, sizeof(SegSmem),
        nullptr));
    BENCH_CHECK(cudaEventRecord(t1));
    BENCH_CHECK(cudaEventSynchronize(t1));
    float ms = 0.0f;
    BENCH_CHECK(cudaEventElapsedTime(&ms, t0, t1));
    if (ms < best) best = ms;
  }
  return 1e3f * best / num;
}

}  // namespace

int main() {
  std::mt19937 gen(14);
  std::uniform_real_distribution<float> uni(-1.0f, 1.0f);
  Problem pr;
  pr.d0.assign(kN * kN, 0.0f);
  pr.x0.assign(kN * kN, 0.0f);
  const float scale = 0.01f / std::sqrt(static_cast<float>(kN));
  for (int i = 0; i < kN; ++i)
    for (int j = 0; j < kN; ++j) {
      const float u = scale * uni(gen);
      pr.d0[i * kN + j] = (i == j ? 1.0f : 0.0f) + u;
      pr.x0[i * kN + j] = (i == j ? 1.0f : 0.0f) - u;
    }
  constexpr int kLong = 225, kShort = 25;
  pr.batches.resize(static_cast<size_t>(kLong) * kB * kN);
  for (float& v : pr.batches) v = uni(gen);

  const int grid = vtc_ica_segment_grid(kN, kB);
  std::printf("segment kernel: grid %d CTAs, %d CTAs per SM, %d SMs; "
              "phases a step at refine 3, upd 1: %d\n",
              grid, vtc_ica_segment_blocks_per_sm(),
              vtc_ica_segment_sm_count(), seg_step_phases(3, 1, 0));
  Buffers b = make_buffers(pr, grid);

  // the same bits: a 25-step segment on each route
  std::vector<float> out[2][3];
  for (int route = 0; route < 2; ++route) {
    reset(b, pr);
    if (run(b, route, kShort, 3) != 0) return 1;
    BENCH_CHECK(cudaDeviceSynchronize());
    out[route][0] = fetch(b.d, kN * kN);
    out[route][1] = fetch(b.x, kN * kN);
    out[route][2] = fetch(b.r_max, 1);
  }
  bool same = true;
  for (int w = 0; w < 3; ++w)
    same = same && std::memcmp(out[0][w].data(), out[1][w].data(),
                               sizeof(float) * out[0][w].size()) == 0;
  std::printf("bitwise equal after %d steps (D, X, r_max): %s; r_max %.9g\n",
              kShort, same ? "yes" : "NO", out[1][2][0]);

  const char* names[2] = {"steps", "persistent"};
  float slope[2] = {0.0f, 0.0f};
  for (int route : {0, 1, 1, 0}) {
    const float s = time_segment(b, pr, route, kShort, 3, 3);
    const float l = time_segment(b, pr, route, kLong, 3, 3);
    const float us = 1e3f * (l - s) / (kLong - kShort);
    slope[route] += 0.5f * us;
    std::printf("%-10s route: %.4f ms / %d steps, %.4f ms / %d steps: "
                "%.3f us a step\n",
                names[route], s, kShort, l, kLong, us);
  }
  std::printf("us a step (mean of the two turns): steps %.3f, persistent "
              "%.3f (%.2fx)\n",
              slope[0], slope[1], slope[0] / slope[1]);

  // the boost off: its residual test at 1e-6 sits near the fp32 floor at
  // n = 256, so on these inputs it fires on some steps (14 phases there)
  for (int route : {0, 1}) {
    const float l = time_segment(b, pr, route, kLong, 3, 3, 0, 1, 0);
    const float s = time_segment(b, pr, route, kShort, 3, 3, 0, 1, 0);
    std::printf("%-10s route, boost off: %.3f us a step\n", names[route],
                1e3f * (l - s) / (kLong - kShort));
  }

  // a refresh phase: refine 5 against refine 3 adds four phases a step
  const float r3 = time_segment(b, pr, 1, kLong, 3, 3);
  const float r5 = time_segment(b, pr, 1, kLong, 5, 3);
  std::printf("persistent, refine 3 -> 5: %.4f -> %.4f ms / %d steps: "
              "%.3f us a refresh phase; %.3f us a phase on average at "
              "refine 3 (%d phases)\n",
              r3, r5, kLong, 1e3f * (r5 - r3) / (4.0f * kLong),
              1e3f * r3 / (kLong * seg_step_phases(3, 1, 0)),
              seg_step_phases(3, 1, 0));

  // an update phase: upd 3 against upd 1 adds two phases a step; the
  // residual with the codes and the statistic are what is left of a step
  const float u3 = time_segment(b, pr, 1, kLong, 3, 3, 0, 3);
  const float refresh_us = 1e3f * (r5 - r3) / (4.0f * kLong);
  const float update_us = 1e3f * (u3 - r3) / (2.0f * kLong);
  std::printf("persistent, upd 1 -> 3: %.4f -> %.4f ms / %d steps: %.3f us "
              "an update phase; the residual and codes phase with the "
              "statistic phase %.3f us a step\n",
              r3, u3, kLong, update_us,
              1e3f * r3 / kLong - 6.0f * refresh_us - update_us);

  // the grid: the shape's own against one CTA an SM, in turns
  const int sms = vtc_ica_segment_sm_count();
  for (int g : {grid, sms, sms, grid}) {
    const float l = time_segment(b, pr, 1, kLong, 3, 3, g);
    const float s = time_segment(b, pr, 1, kShort, 3, 3, g);
    std::printf("persistent on %d CTAs: %.3f us a step\n", g,
                1e3f * (l - s) / (kLong - kShort));
  }

  // where a launch of the segment kernel's shape puts its CTAs
  int* sm_of = nullptr;
  BENCH_CHECK(cudaMalloc(&sm_of, sizeof(int) * grid));
  BENCH_CHECK(cudaFuncSetAttribute(smid_kernel,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(sizeof(SegSmem))));
  void* sm_params[] = {&sm_of};
  BENCH_CHECK(cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(smid_kernel), dim3(grid),
      dim3(kSegThreads), sm_params, sizeof(SegSmem), nullptr));
  BENCH_CHECK(cudaDeviceSynchronize());
  std::vector<int> placed(grid);
  BENCH_CHECK(cudaMemcpy(placed.data(), sm_of, sizeof(int) * grid,
                         cudaMemcpyDeviceToHost));
  for (int first : {seg_tiles(kN, kN), grid}) {
    std::vector<int> seen(1024, 0);
    int distinct = 0;
    for (int c = 0; c < first; ++c) distinct += seen[placed[c] & 1023]++ == 0;
    std::printf("CTAs 0..%d of a %d-CTA launch sit on %d distinct SMs\n",
                first - 1, grid, distinct);
  }

  // a tile's parts, on 128 CTAs (one n x n phase's tiles)
  std::printf("a D X tile (n %d) on %d CTAs, us: product %.3f, copies "
              "alone %.3f, FMAs alone %.3f; product, store and grid "
              "barrier %.3f\n",
              kN, seg_tiles(kN, kN), time_part<0>(b, 200),
              time_part<1>(b, 200), time_part<2>(b, 200),
              time_part<3>(b, 200));

  std::printf("the statistic's tile (K %d, A k-major, sign(B)) %.3f us, "
              "without the sign %.3f us; a row-major A tile at K 252 %.3f "
              "us; the residual and codes pair %.3f us (alone, 128 CTAs)\n",
              kB, time_other<0>(b, 200), time_other<2>(b, 200),
              time_other<3>(b, 200), time_other<1>(b, 200));
  std::printf("the D X tile: every copy, one wait, every FMA %.3f us; the "
              "copies issued under the FMAs, no wait %.3f us\n",
              time_other<6>(b, 200), time_other<7>(b, 200));
  std::printf("the D X tile's product on a ring of 3 stages %.3f us, of 4 "
              "%.3f us, of %d %.3f us (alone, 128 CTAs)\n",
              time_other<4>(b, 200), time_other<5>(b, 200), kSegStages,
              time_part<0>(b, 200));

  // the barrier alone, on the segment kernel's grid and on one CTA an SM
  float* sink = device_zeros(grid);
  cudaEvent_t t0, t1;
  BENCH_CHECK(cudaEventCreate(&t0));
  BENCH_CHECK(cudaEventCreate(&t1));
  for (int num : {1000, 1000, 10000, -1000}) {
    const int g = num < 0 ? sms : grid;
    num = num < 0 ? -num : num;
    BENCH_CHECK(cudaMemset(b.barrier, 0, sizeof(unsigned)));
    void* params[] = {&b.barrier, &num, &sink};
    BENCH_CHECK(cudaEventRecord(t0));
    BENCH_CHECK(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(barrier_kernel), dim3(g),
        dim3(kSegThreads), params, 0, nullptr));
    BENCH_CHECK(cudaEventRecord(t1));
    BENCH_CHECK(cudaEventSynchronize(t1));
    float ms = 0.0f;
    BENCH_CHECK(cudaEventElapsedTime(&ms, t0, t1));
    std::printf("grid barrier alone (%d CTAs): %d barriers in %.4f ms, "
                "%.3f us each\n",
                g, num, ms, 1e3f * ms / num);
  }
  return same ? 0 : 2;
}
