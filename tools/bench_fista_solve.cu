// Times the fc/subspace solve's kernels alone
// (vtc_tpu_torch/csrc/fista_core.cuh) at s = 256, FISTA, and the parts of
// the cluster and wide kernels' iterations on their own.  For each batch
// it runs fista_kernel (the classic route, its fold included) and the
// route the batch takes (fista_cluster_kernel at b 125 and 250,
// fista_wide_kernel at b 1100, 2048 and 4096) through launch_solve,
// elementwise soft and with the group prox at M = 4, at 25 and 125
// iterations, and prints ms per solve and µs per iteration (the slope
// between the two counts), and whether the two kernels' codes are
// bitwise equal.  Then, on that kernel's layout and grid, the pieces of
// an iteration:
//   barrier   one cluster.sync() per iteration;
//   exchange  each thread's values written into every CTA of the
//             cluster (cluster_push), then the barrier;
//   product   the CTA's slice of z @ (-eta G) (cluster_product or
//             wide_product) from its resident G slice, with a block
//             barrier between iterations.
// Then the early stop (the "The early stop" of fista_core.cuh): the same
// solve on the route the stop takes at that batch (stop_route) with eps 0,
// which never stops, so it runs every iteration with the stop's work (µs
// per iteration beside the build without it, codes bitwise equal), and
// the stop's exchange alone on the cluster and wide grids:
//   stop exchange  per iteration one warp of every CTA posts its tagged
//                  share and gathers all the launch's (stop_gather), then
//                  the block synchronises: what the stop warp does while
//                  the compute warps form the product.
// With the argument "tier" it times the tier layouts instead
// (fista_tier.cuh): at each tier, b 125, 250 and 2048, elementwise and
// with groups of 4, FISTA, fista_tier_kernel (its fold included) and
// fista_tier_cluster_kernel in each candidate layout of clusters of 1, 2,
// 4 or 8 CTAs, 16, 32 or 64 rows a cluster and one or two buffers of z
// terms that fits (one buffer only where two do not), with its waves on
// this card: ms at 25 and 125 iterations, µs per iteration, and whether
// the codes are bitwise fista_tier_kernel's; the layout tier_shape picks
// is marked.
// Built and run by tools/bench_fista_solve.py.
#include <cmath>
#include <cstdio>
#include <cstring>
#include <vector>

// fista_core.cuh, with the tier kernel that its launch_solve reaches
#include "fista_tier.cuh"

namespace {

constexpr int kS = 256;

// One cluster.sync() per iteration, or the exchange and the barrier: each
// thread's two rows of four values written into every CTA of the cluster.
template <bool PUSH>
__global__ void __launch_bounds__(kClusterMaxThreads)
    exchange_kernel(int num_iters, int sk, int rows, float* out) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const ClusterLayout lay = cluster_layout(sk, 1, rows);
  const int ty = threadIdx.x / (lay.w / 4);
  const int tx = threadIdx.x - ty * (lay.w / 4);
  const int plane = rows * lay.ldz;
  float* zbuf = smem + sk * lay.w;
  unsigned bases[kCluster];
  cluster_bases(zbuf, bases);
  float4 v = make_float4(rank, ty, tx, 0.0f);
  cluster.sync();
  for (int it = 0; it < num_iters; ++it) {
    if (PUSH) {
      for (int r = 0; r < 2; ++r)
        cluster_push(bases,
                     4u * static_cast<unsigned>(
                              ((it & 1) ^ 1) * plane +
                              (2 * ty + r) * lay.ldz + rank * lay.w + tx * 4),
                     v);
    }
    cluster.sync();
    v.w += 1.0f;
  }
  if (threadIdx.x == 0)
    out[blockIdx.x] = zbuf[(num_iters & 1) * plane] + v.w;
}

// The product alone: the resident G slice times the thread's two z rows,
// the eight outputs written back into the other local z buffer.
__global__ void __launch_bounds__(kClusterMaxThreads)
    product_kernel(const float* __restrict__ gram, int num_iters, int s,
                   int sk, int rows, float* out) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const ClusterLayout lay = cluster_layout(sk, 1, rows);
  const int ty = threadIdx.x / (lay.w / 4);
  const int tx = threadIdx.x - ty * (lay.w / 4);
  const int plane = rows * lay.ldz;
  float* gs = smem;
  float* zbuf = gs + sk * lay.w;
  cluster_load(gram, nullptr, -0.01f, rows, s, sk, lay.w, rank, 0, rows,
               lay.ldz, gs, zbuf);
  for (int idx = threadIdx.x; idx < 2 * plane; idx += blockDim.x)
    zbuf[idx] = 0.01f;
  __syncthreads();
  float acc[2][4];
  for (int it = 0; it < num_iters; ++it) {
    const float* z = zbuf + (it & 1) * plane;
    float* zn = zbuf + ((it & 1) ^ 1) * plane;
    cluster_product(z + 2 * ty * lay.ldz, lay.ldz, gs + tx * 4, sk, lay.w,
                    acc);
    for (int r = 0; r < 2; ++r)
      *reinterpret_cast<float4*>(zn + (2 * ty + r) * lay.ldz +
                                 rank * lay.w + tx * 4) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = zbuf[(num_iters & 1) * plane];
}

// The wide kernel's parts: one cluster.sync() per iteration, or the
// exchange and the barrier (each thread's 8 rows of four values written
// into every CTA of the cluster).
template <bool PUSH>
__global__ void __launch_bounds__(kWideMaxThreads, 1)
    wide_exchange_kernel(int num_iters, int sk, int rows, float* out) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int size = static_cast<int>(cluster.num_blocks());
  const WideLayout lay = wide_layout(sk, size, rows);
  const int ty = threadIdx.x / (lay.w / 4);
  const int tx = threadIdx.x - ty * (lay.w / 4);
  const int plane = rows * lay.ldz;
  float* zbuf = smem + sk * lay.w;
  unsigned bases[kWideMaxCluster];
  cluster_bases(zbuf, bases, size);
  float4 v = make_float4(rank, ty, tx, 0.0f);
  cluster.sync();
  for (int it = 0; it < num_iters; ++it) {
    if (PUSH) {
      for (int r = 0; r < kWideRowsPerThread; ++r)
        cluster_push(bases,
                     4u * static_cast<unsigned>(
                              ((it & 1) ^ 1) * plane +
                              (kWideRowsPerThread * ty + r) * lay.ldz +
                              rank * lay.w + tx * 4),
                     v, size);
    }
    cluster.sync();
    v.w += 1.0f;
  }
  if (threadIdx.x == 0)
    out[blockIdx.x] = zbuf[(num_iters & 1) * plane] + v.w;
}

// The wide product alone: the resident G slice times the thread's 8 z
// rows, the 32 outputs written back into the other local z buffer.
__global__ void __launch_bounds__(kWideMaxThreads, 1)
    wide_product_kernel(const float* __restrict__ gram, int num_iters, int s,
                        int sk, int rows, float* out) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int size = static_cast<int>(cluster.num_blocks());
  const WideLayout lay = wide_layout(sk, size, rows);
  const int ty = threadIdx.x / (lay.w / 4);
  const int tx = threadIdx.x - ty * (lay.w / 4);
  const int r0 = kWideRowsPerThread * ty;
  const int plane = rows * lay.ldz;
  float* gs = smem;
  float* zbuf = gs + sk * lay.w;
  cluster_load(gram, nullptr, -0.01f, rows, s, sk, lay.w, rank, 0, rows,
               lay.ldz, gs, zbuf);
  for (int idx = threadIdx.x; idx < 2 * plane; idx += blockDim.x)
    zbuf[idx] = 0.01f;
  __syncthreads();
  float acc[8][4];
  for (int it = 0; it < num_iters; ++it) {
    const float* z = zbuf + (it & 1) * plane;
    float* zn = zbuf + ((it & 1) ^ 1) * plane;
    if (sk == kWideFixedDepth && size == 2)  // launch_wide's choice
      wide_product<kWideFixedDepth>(z + r0 * lay.ldz, lay.ldz, gs + tx * 4,
                                    sk, lay.w, acc);
    else
      wide_product<0>(z + r0 * lay.ldz, lay.ldz, gs + tx * 4, sk, lay.w,
                      acc);
    for (int r = 0; r < 8; ++r)
      *reinterpret_cast<float4*>(zn + (r0 + r) * lay.ldz + rank * lay.w +
                                 tx * 4) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = zbuf[(num_iters & 1) * plane];
}

// The stop's exchange alone: per iteration warp 0 of every CTA posts a
// tagged share and gathers every CTA's, then the block synchronises.
__global__ void stop_exchange_kernel(int num_iters, SolveStop stop,
                                     float* out) {
  float acc = 0.0f;
  for (int it = 0; it < num_iters; ++it) {
    if (threadIdx.x < 32) {
      unsigned long long* slots = stop.words + (it & 1) * gridDim.x;
      if (threadIdx.x == 0)
        stop_post(slots + blockIdx.x, stop.tag + it, 1.0f + acc);
      acc = stop_gather(slots, gridDim.x, stop.tag + it);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = acc;
}

// Launch a part on the wide kernel's grid, layout and shared memory.
template <typename... Params, typename... Args>
cudaError_t launch_on_wide(void (*kernel)(Params...), int b, int sk,
                           int cluster, int rows, Args... args) {
  const WideLayout lay = wide_layout(sk, cluster, rows);
  return launch_clusters(kernel, cluster, (b + rows - 1) / rows * cluster,
                         lay.threads, lay.smem, nullptr, args...);
}

// Launch a part on the cluster kernel's grid, layout and shared memory.
template <typename... Params, typename... Args>
cudaError_t launch_on_clusters(void (*kernel)(Params...), int b, int sk,
                               int rows, Args... args) {
  const ClusterLayout lay = cluster_layout(sk, 1, rows);
  return launch_clusters(kernel, kCluster, (b + rows - 1) / rows * kCluster,
                         lay.threads, lay.smem, nullptr, args...);
}

float* to_device(const std::vector<float>& h) {
  float* d = nullptr;
  cudaMalloc(&d, h.size() * sizeof(float));
  cudaMemcpy(d, h.data(), h.size() * sizeof(float), cudaMemcpyHostToDevice);
  return d;
}

// ms per call of fn over reps calls, after one warm-up call.
template <typename F>
float time_ms(F fn, int reps) {
  cudaEvent_t start, stop;
  cudaEventCreate(&start);
  cudaEventCreate(&stop);
  fn();
  cudaEventRecord(start);
  for (int i = 0; i < reps; ++i) fn();
  cudaEventRecord(stop);
  cudaEventSynchronize(stop);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, start, stop);
  cudaEventDestroy(start);
  cudaEventDestroy(stop);
  return ms / reps;
}

unsigned lcg(unsigned& seed) {
  seed = seed * 1664525u + 1013904223u;
  return seed >> 8;
}

}  // namespace

int tier_main(const float* gram_d, const float* corr_d, const float* eta_d,
              float lam, int s, int sk, int sc, float* gn, float* out_a,
              float* out_b, std::vector<float>& ha, std::vector<float>& hb,
              int reps);

int main(int argc, char** argv) {
  const int s = kS, n = 256, bmax = 4096, reps = 20;
  const int sk = (s + kChunk - 1) / kChunk * kChunk;
  const int sc = (s + kColBlock - 1) / kColBlock * kColBlock;
  // a unit-norm random dictionary D (s, n), sparse mixtures X = A D plus
  // noise, G = D D^T and c = X D^T in double, eta = 1 / |G|_2
  unsigned seed = 12345u;
  auto uniform = [&]() { return (lcg(seed) & 0xffff) / 65536.0 - 0.5; };
  std::vector<double> d(static_cast<size_t>(s) * n);
  for (int i = 0; i < s; ++i) {
    double norm = 0.0;
    for (int j = 0; j < n; ++j) {
      d[i * n + j] = uniform();
      norm += d[i * n + j] * d[i * n + j];
    }
    for (int j = 0; j < n; ++j) d[i * n + j] /= std::sqrt(norm);
  }
  std::vector<float> gram(static_cast<size_t>(s) * s);
  for (int i = 0; i < s; ++i)
    for (int j = 0; j < s; ++j) {
      double acc = 0.0;
      for (int k = 0; k < n; ++k) acc += d[i * n + k] * d[j * n + k];
      gram[i * s + j] = static_cast<float>(acc);
    }
  std::vector<double> v(s, 1.0), u(s);
  double lmax = 0.0;
  for (int it = 0; it < 200; ++it) {
    double norm = 0.0;
    for (int i = 0; i < s; ++i) {
      u[i] = 0.0;
      for (int j = 0; j < s; ++j) u[i] += gram[i * s + j] * v[j];
      norm += u[i] * u[i];
    }
    lmax = std::sqrt(norm);
    for (int i = 0; i < s; ++i) v[i] = u[i] / lmax;
  }
  std::vector<float> corr(static_cast<size_t>(bmax) * s);
  std::vector<double> x(n);
  for (int r = 0; r < bmax; ++r) {
    for (int j = 0; j < n; ++j) x[j] = 0.02 * uniform();
    for (int a = 0; a < 5; ++a) {
      const int atom = lcg(seed) % s;
      const double coef = 2.0 * uniform();
      for (int j = 0; j < n; ++j) x[j] += coef * d[atom * n + j];
    }
    for (int i = 0; i < s; ++i) {
      double acc = 0.0;
      for (int j = 0; j < n; ++j) acc += x[j] * d[i * n + j];
      corr[static_cast<size_t>(r) * s + i] = static_cast<float>(acc);
    }
  }
  const float eta_h = static_cast<float>(1.0 / lmax), lam = 0.008f;
  float* gram_d = to_device(gram);
  float* corr_d = to_device(corr);
  float* eta_d = to_device(std::vector<float>(1, eta_h));
  float *gn, *out_a, *out_b, *sink;
  // the classic route's -eta G, or the tier planes (tier_gn_floats)
  cudaMalloc(&gn, static_cast<size_t>(tier_gn_floats(kTierBf16x5, sk, sc)) *
                      sizeof(float));
  cudaMalloc(&out_a, static_cast<size_t>(bmax) * s * sizeof(float));
  cudaMalloc(&out_b, static_cast<size_t>(bmax) * s * sizeof(float));
  cudaMalloc(&sink, static_cast<size_t>(bmax) * kCluster * sizeof(float));
  // the stop's words (tags rise from call to call), count and the classic
  // route's global state
  unsigned long long* stop_words_d;
  int* iters_d;
  float* state_d;
  unsigned tag = 1;
  cudaMalloc(&stop_words_d, 4096 * sizeof(unsigned long long));
  cudaMemset(stop_words_d, 0, 4096 * sizeof(unsigned long long));
  cudaMalloc(&iters_d, sizeof(int));
  cudaMalloc(&state_d, static_cast<size_t>((bmax + kRows - 1) / kRows) * 4 *
                           kRows * sk * sizeof(float));
  std::vector<float> ha(static_cast<size_t>(bmax) * s),
      hb(static_cast<size_t>(bmax) * s);
  if (argc > 1 && std::strcmp(argv[1], "tier") == 0)
    return tier_main(gram_d, corr_d, eta_d, lam, s, sk, sc, gn, out_a, out_b,
                     ha, hb, reps);
  const int slots = cluster_slots();
  std::printf("s %d: sk %d, clusters of %d CTAs, w %d; %d SMs, %d cluster "
              "slots (clusters resident at one CTA per SM)\n",
              s, sk, kCluster, sk / kCluster, device_sm_count(), slots);
  if (slots < 1) return 1;
  bool ok = true;
  for (int b : {125, 250, 1100, 2048, 4096}) {
    const int route = solve_route(b, sk, 1, device_sm_count());
    const bool wide = route == kRouteWide;
    const char* name = wide ? "fista_wide_kernel" : "fista_cluster_kernel";
    for (int group : {0, 4}) {
      float ms[2][2];
      for (int which_route = 0; which_route < 2; ++which_route) {
        float* out = which_route ? out_b : out_a;
        const int r = which_route ? route : kRouteClassic;
        for (int which = 0; which < 2; ++which) {
          const int iters = which ? 125 : 25;
          auto run = [&]() {
            return group ? launch_solve<true, kSoft, true>(
                               gram_d, corr_d, nullptr, eta_d, lam, iters, b,
                               s, sk, sc, group, gn, nullptr, out, r, nullptr,
                               0)
                         : launch_solve<true, kSoft, false>(
                               gram_d, corr_d, nullptr, eta_d, lam, iters, b,
                               s, sk, sc, 1, gn, nullptr, out, r, nullptr, 0);
          };
          ms[which_route][which] = time_ms(run, reps);
          const cudaError_t err = cudaGetLastError();
          if (err != cudaSuccess) {
            std::printf("CUDA error: %s\n", cudaGetErrorString(err));
            return 1;
          }
        }
      }
      // the last calls (125 iterations) of both routes, compared
      cudaMemcpy(ha.data(), out_a, static_cast<size_t>(b) * s * 4,
                 cudaMemcpyDeviceToHost);
      cudaMemcpy(hb.data(), out_b, static_cast<size_t>(b) * s * 4,
                 cudaMemcpyDeviceToHost);
      int differ = 0, nonzero = 0;
      for (size_t i = 0; i < static_cast<size_t>(b) * s; ++i) {
        differ += std::memcmp(&ha[i], &hb[i], 4) != 0;
        nonzero += ha[i] != 0.0f;
      }
      ok = ok && differ == 0;
      std::printf(
          "b %4d %-11s FISTA: fista_kernel %.4f ms at 25 it, %.4f at 125, "
          "%.3f us/it; %s %.4f, %.4f, %.3f us/it; codes %s (%d of %d "
          "differ, %d nonzero)\n",
          b, group ? "group M 4" : "elementwise", ms[0][0], ms[0][1],
          (ms[0][1] - ms[0][0]) * 10.0f, name, ms[1][0], ms[1][1],
          (ms[1][1] - ms[1][0]) * 10.0f,
          differ ? "DIFFER" : "bitwise equal", differ, b * s, nonzero);
    }
    int rows, cluster, threads, smem, resident;
    if (wide) {
      cluster = wide_cluster(sk, 1);
      rows = wide_device_rows(b, sk, 1);
      const WideLayout lay = wide_layout(sk, cluster, rows);
      threads = lay.threads;
      smem = lay.smem;
      resident = wide_slots(cluster);
    } else {
      cluster = kCluster;
      rows = cluster_rows(b, sk, 1, slots);
      const ClusterLayout lay = cluster_layout(sk, 1, rows);
      threads = lay.threads;
      smem = lay.smem;
      resident = cluster_occupancy<true, kSoft, false>(sk, 1, rows);
    }
    std::printf(
        "b %4d %s layout: clusters of %d CTAs, %d rows a cluster, %d "
        "clusters (%d CTAs), %d threads, %d bytes of shared memory, %d "
        "clusters resident at once\n",
        b, name, cluster, rows, (b + rows - 1) / rows,
        (b + rows - 1) / rows * cluster, threads, smem, resident);
    float parts[3][2];
    for (int which = 0; which < 2; ++which) {
      const int iters = which ? 125 : 25;
      for (int part = 0; part < 3; ++part) {
        auto run = [&]() {
          if (wide) {
            if (part == 0)
              return launch_on_wide(wide_exchange_kernel<false>, b, sk,
                                    cluster, rows, iters, sk, rows, sink);
            if (part == 1)
              return launch_on_wide(wide_exchange_kernel<true>, b, sk,
                                    cluster, rows, iters, sk, rows, sink);
            return launch_on_wide(wide_product_kernel, b, sk, cluster, rows,
                                  static_cast<const float*>(gram_d), iters, s,
                                  sk, rows, sink);
          }
          if (part == 0)
            return launch_on_clusters(exchange_kernel<false>, b, sk, rows,
                                      iters, sk, rows, sink);
          if (part == 1)
            return launch_on_clusters(exchange_kernel<true>, b, sk, rows,
                                      iters, sk, rows, sink);
          return launch_on_clusters(product_kernel, b, sk, rows,
                                    static_cast<const float*>(gram_d), iters,
                                    s, sk, rows, sink);
        };
        parts[part][which] = time_ms(run, reps);
      }
    }
    // the early stop: the stop route at eps 0 (never stops) against the
    // same route without it, and the exchange alone on the route's grid
    {
      int64_t words = 0;
      const int sroute = device_stop_route(b, sk, 1, &words);
      const char* sname = sroute == kRouteWide      ? "fista_wide_kernel"
                          : sroute == kRouteCluster ? "fista_cluster_kernel"
                                                    : "fista_kernel";
      for (int group : {0, 4}) {
        // in turns: without, with, with, without; each the mean of its two
        float sms[2][2] = {{0.0f, 0.0f}, {0.0f, 0.0f}};
        for (int turn = 0; turn < 4; ++turn) {
          const int with = turn == 1 || turn == 2;
          float* out = with ? out_b : out_a;
          for (int which = 0; which < 2; ++which) {
            const int iters = which ? 125 : 25;
            auto run = [&]() {
              SolveStop stop{0.0f, 1.0f / (static_cast<float>(b) * s),
                             stop_words_d, iters_d, tag};
              tag += iters + 1;
              const SolveStop* sp = with ? &stop : nullptr;
              return group ? launch_solve<true, kSoft, true>(
                                 gram_d, corr_d, nullptr, eta_d, lam, iters,
                                 b, s, sk, sc, group, gn, state_d, out,
                                 sroute, nullptr, 0, sp)
                           : launch_solve<true, kSoft, false>(
                                 gram_d, corr_d, nullptr, eta_d, lam, iters,
                                 b, s, sk, sc, 1, gn, state_d, out, sroute,
                                 nullptr, 0, sp);
            };
            sms[with][which] += 0.5f * time_ms(run, reps);
            const cudaError_t err = cudaGetLastError();
            if (err != cudaSuccess) {
              std::printf("CUDA error: %s\n", cudaGetErrorString(err));
              return 1;
            }
          }
        }
        cudaMemcpy(ha.data(), out_a, static_cast<size_t>(b) * s * 4,
                   cudaMemcpyDeviceToHost);
        cudaMemcpy(hb.data(), out_b, static_cast<size_t>(b) * s * 4,
                   cudaMemcpyDeviceToHost);
        int differ = 0;
        for (size_t i = 0; i < static_cast<size_t>(b) * s; ++i)
          differ += std::memcmp(&ha[i], &hb[i], 4) != 0;
        ok = ok && differ == 0;
        const float off = (sms[0][1] - sms[0][0]) * 10.0f;
        const float on = (sms[1][1] - sms[1][0]) * 10.0f;
        std::printf(
            "b %4d %-11s early stop on %s (%lld words): without %.3f us/it, "
            "with (eps 0, never stops) %.3f us/it, the stop %.3f us/it "
            "(in turns, means of two; ms at 25 / 125 it: %.4f / %.4f, "
            "%.4f / %.4f); codes %s\n",
            b, group ? "group M 4" : "elementwise", sname,
            static_cast<long long>(words), off, on, on - off, sms[0][0],
            sms[0][1], sms[1][0], sms[1][1],
            differ ? "DIFFER" : "bitwise equal");
      }
      if (sroute != kRouteClassic) {
        const int cluster = wide ? wide_cluster(sk, 1) : kCluster;
        const int rows = wide ? wide_device_rows(b, sk, 1)
                              : cluster_rows(b, sk, 1, slots);
        const unsigned grid = (b + rows - 1) / rows * cluster;
        float xs[2];
        for (int which = 0; which < 2; ++which) {
          const int iters = which ? 125 : 25;
          auto run = [&]() {
            SolveStop stop{0.0f, 1.0f, stop_words_d, iters_d, tag};
            tag += iters + 1;
            return launch_clusters_as(true, stop_exchange_kernel, cluster,
                                      grid, 128, 0, nullptr, iters, stop,
                                      sink);
          };
          xs[which] = time_ms(run, reps);
        }
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) {
          std::printf("CUDA error: %s\n", cudaGetErrorString(err));
          return 1;
        }
        std::printf("b %4d the stop's exchange alone on %u CTAs: %.3f us/it "
                    "(ms at 25 / 125 it: %.4f / %.4f)\n",
                    b, grid, (xs[1] - xs[0]) * 10.0f, xs[0], xs[1]);
      }
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
      std::printf("CUDA error: %s\n", cudaGetErrorString(err));
      return 1;
    }
    std::printf(
        "b %4d parts of a %s iteration: barrier %.3f us/it, exchange and "
        "barrier %.3f us/it, product %.3f us/it (ms at 25 / 125 it: %.4f / "
        "%.4f, %.4f / %.4f, %.4f / %.4f)\n",
        b, name, (parts[0][1] - parts[0][0]) * 10.0f,
        (parts[1][1] - parts[1][0]) * 10.0f,
        (parts[2][1] - parts[2][0]) * 10.0f, parts[0][0], parts[0][1],
        parts[1][0], parts[1][1], parts[2][0], parts[2][1]);
  }
  return ok ? 0 : 2;
}

// The tier layouts' candidates (see the header comment).
int tier_main(const float* gram_d, const float* corr_d, const float* eta_d,
              float lam, int s, int sk, int sc, float* gn, float* out_a,
              float* out_b, std::vector<float>& ha, std::vector<float>& hb,
              int reps) {
  bool ok = true;
  const char* names[] = {"", "bf16", "bf16x3", "bf16x5"};
  for (int tier = kTierBf16; tier <= kTierBf16x5; ++tier) {
    for (int b : {125, 250, 2048}) {
      TierPlan plan;
      if (device_tier_plan(b, s, sk, 1, tier, kRouteAuto, false, false,
                           &plan) != cudaSuccess)
        return 1;
      for (int group : {1, 4}) {
        // fista_tier_kernel through launch_tier, forced
        auto classic = [&](int iters) {
          return group == 1
                     ? launch_tier<false>(tier, 1, kSoft, gram_d, corr_d,
                                          nullptr, eta_d, lam, iters, b, s,
                                          sk, sc, 1, gn, nullptr, out_a,
                                          kRouteTier, nullptr, 0, nullptr)
                     : launch_tier<true>(tier, 1, kSoft, gram_d, corr_d,
                                         nullptr, eta_d, lam, iters, b, s,
                                         sk, sc, group, gn, nullptr, out_a,
                                         kRouteTier, nullptr, 0, nullptr);
        };
        float base[2];
        for (int which = 0; which < 2; ++which) {
          const int iters = which ? 125 : 25;
          base[which] = time_ms([&]() { return classic(iters); }, reps);
        }
        cudaMemcpy(ha.data(), out_a, static_cast<size_t>(b) * s * 4,
                   cudaMemcpyDeviceToHost);
        std::printf("%s b %4d M %d fista_tier_kernel: %.4f ms at 25 it, "
                    "%.4f at 125, %.3f us/it\n",
                    names[tier], b, group, base[0], base[1],
                    (base[1] - base[0]) * 10.0f);
        for (int cluster : {1, 2, 4, 8}) {
          const int slots = wide_slots(cluster);
          for (int rows : {16, 32, 64}) {
            for (int bufs : {2, 1}) {
              const int most = tier_max_rows(tier, sk, group, cluster, bufs);
              const int clusters = (b + rows - 1) / rows;
              if (rows > most || slots < 1) continue;
              const int waves = (clusters + slots - 1) / slots;
              if (bufs == 1 && rows <= tier_max_rows(tier, sk, group,
                                                     cluster, 2))
                continue;  // one buffer only where two do not fit
              auto resident = [&](int iters) {
#define VTC_RES(T)                                                          \
  (group == 1 ? launch_tier_resident<false, T, -1>(                         \
                    1, kSoft, gram_d, corr_d, nullptr, eta_d, lam, iters, b, \
                    s, sk, 1, cluster, rows, bufs, out_b, 0, nullptr)       \
              : launch_tier_resident<true, T, 4 + kSoft>(                   \
                    1, kSoft, gram_d, corr_d, nullptr, eta_d, lam, iters, b, \
                    s, sk, group, cluster, rows, bufs, out_b, 0, nullptr))
                return tier == kTierBf16     ? VTC_RES(kTierBf16)
                       : tier == kTierBf16x3 ? VTC_RES(kTierBf16x3)
                                             : VTC_RES(kTierBf16x5);
#undef VTC_RES
              };
              float ms[2];
              for (int which = 0; which < 2; ++which) {
                const int iters = which ? 125 : 25;
                ms[which] = time_ms([&]() { return resident(iters); }, reps);
              }
              const cudaError_t err = cudaGetLastError();
              if (err != cudaSuccess) {
                std::printf("CUDA error: %s\n", cudaGetErrorString(err));
                return 1;
              }
              cudaMemcpy(hb.data(), out_b, static_cast<size_t>(b) * s * 4,
                         cudaMemcpyDeviceToHost);
              int differ = 0;
              for (size_t i = 0; i < static_cast<size_t>(b) * s; ++i)
                differ += std::memcmp(&ha[i], &hb[i], 4) != 0;
              ok = ok && differ == 0;
              const bool picked = plan.route != kRouteTier &&
                                  plan.cluster == cluster &&
                                  plan.rows == rows && plan.bufs == bufs;
              std::printf(
                  "%s b %4d M %d resident P %d rows %2d bufs %d (%d "
                  "clusters in %d waves, %d warps, %d B): %.4f ms at 25 it, "
                  "%.4f at 125, %.3f us/it; codes %s%s\n",
                  names[tier], b, group, cluster, rows, bufs, clusters, waves,
                  tier_layout(tier, sk, cluster, rows, bufs).warps,
                  tier_layout(tier, sk, cluster, rows, bufs).smem, ms[0],
                  ms[1], (ms[1] - ms[0]) * 10.0f,
                  differ ? "DIFFER" : "bitwise equal",
                  picked ? "  <- tier_route's plan" : "");
            }
          }
        }
      }
    }
  }
  return ok ? 0 : 2;
}
