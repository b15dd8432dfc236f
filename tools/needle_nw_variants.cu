// Times src/repro_torch/csrc/needle_nw.cu at the main path's size (needle
// 2048 10: the chevron's 128 blocks of 16 threads over a 2049 x 2049 score
// matrix) beside the kernel it replaced and variants of its design, on one
// CUDA card, so that the choices its source note makes rest on a
// measurement:
//   old        the kernel it replaced: a thread a cell in the chevron's
//              own CTAs of 16 threads, launched plainly;
//   new        the shipped kernel (the cells on CTAs of 128 threads),
//              launched plainly: the mapping without the attribute;
//   kernel     the shipped launch through launch_needle_nw: the same
//              CTAs as a programmatic dependent launch;
//   W<t>       the shipped kernel as a programmatic dependent launch on
//              CTAs of t threads (W16: the chevron's own blocks);
//   empty      an empty kernel of the shipped CTAs, launched plainly;
//   empty_pdl  the same as a programmatic dependent launch: with `empty`,
//              the floor under any kernel of these CTAs.
// Each variant gives four figures, each the median over five turns:
//   ms        one launch on the longest diagonal (d = n + 1) between two
//             CUDA events after a spin that covers its enqueue, median of
//             25 runs after 5 warm-ups: chip_smoke.py's `ms`;
//   pace_us   512 back-to-back launches on the longest diagonal between
//             two events after a spin that covers their enqueue, over
//             512, median of 5 runs: chip_smoke.py's `pace_us`;
//   chain_us  the whole wavefront, the 2n - 1 = 4095 launches of d = 2 to
//             2n, each followed by a one-thread kernel that adds 1 to the
//             diagonal in device memory (the chain's update in device
//             mode), timed as pace_us in windows of 256 steps (the
//             chain's 8190 launches at once outgrow the stream's queue,
//             and the host's enqueue then paces them), summed, over 4095;
//   graph_us  the same 8190 launches captured once into a CUDA graph (the
//             kernel's launches as programmatic edges where it has the
//             attribute), one replay between two events, over 4095.
// `enqueue_us` is the host's time a launch of the pace run; the spin is
// four times the run's enqueue.  Every variant but the empty ones must
// equal the old kernel bit for bit: the longest diagonal after the pace
// run and the whole matrix after the chain and the replay.  Build and run
// from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/needle_nw_variants tools/needle_nw_variants.cu \
//     && build/needle_nw_variants
#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <random>
#include <string>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/needle_nw.cu"

namespace variants {

constexpr int kTurns = 5, kRuns = 25, kWarm = 5;
constexpr int kPace = 512, kPaceRuns = 5, kSegment = 256;
constexpr int kN = 2048, kPenalty = 10, kBlock = 16;
constexpr double kMaxClockHz = 2e9;

#define CHECK(x)                                                        \
  do {                                                                  \
    cudaError_t e_ = (x);                                               \
    if (e_ != cudaSuccess) {                                            \
      std::fprintf(stderr, "%s:%d %s\n", __FILE__, __LINE__,            \
                   cudaGetErrorString(e_));                             \
      std::exit(1);                                                     \
    }                                                                   \
  } while (0)

// the kernel this redesign replaced, as it was
__global__ void old_needle_nw(int* score, const int* __restrict__ sim,
                              const int* __restrict__ diag, int n,
                              int penalty) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int d = diag[0];
  const int lo = max(1, d - n);
  const int hi = min(n, d - 1);
  if (t > hi - lo) return;
  const int i = t + lo;
  const int j = d - i;
  const size_t w = (size_t)n + 1;
  const int dv = score[(i - 1) * w + (j - 1)] + sim[(i - 1) * (size_t)n + (j - 1)];
  const int up = score[(i - 1) * w + j] - penalty;
  const int lf = score[i * w + (j - 1)] - penalty;
  score[i * w + j] = max(dv, max(up, lf));
}

__global__ void empty(int) {}

// the chain's update in device mode: diag + 1
__global__ void next_diag(int* diag) { diag[0] += 1; }

__global__ void spin(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

template <typename K, typename... A>
void launch_ex(K kern, int ctas, int threads, bool pdl, cudaStream_t s,
               A... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = pdl ? 1 : 0;
  CHECK(cudaLaunchKernelEx(&cfg, kern, args...));
}

float median(std::vector<float> v) {
  std::sort(v.begin(), v.end());
  return v[v.size() / 2];
}

using Launch = std::function<void(cudaStream_t, int*, const int*, int*)>;

struct Variant {
  std::string name;
  Launch launch;
  bool computes;
};

struct Run {
  std::vector<float> ms, pace, chain, graph, enqueue;
};

// the time (ms) between two events around f() on s, after a spin of
// `cycles`; before() runs first, outside the window
float window(cudaStream_t s, long long cycles,
             const std::function<void()>& before,
             const std::function<void()>& f) {
  cudaEvent_t e0, e1;
  CHECK(cudaEventCreate(&e0));
  CHECK(cudaEventCreate(&e1));
  before();
  spin<<<1, 1, 0, s>>>(cycles);
  CHECK(cudaEventRecord(e0, s));
  f();
  CHECK(cudaEventRecord(e1, s));
  CHECK(cudaEventSynchronize(e1));
  CHECK(cudaGetLastError());
  float ms;
  CHECK(cudaEventElapsedTime(&ms, e0, e1));
  CHECK(cudaEventDestroy(e0));
  CHECK(cudaEventDestroy(e1));
  return ms;
}

// the host's seconds to enqueue f() on s
double enqueue_s(cudaStream_t s, const std::function<void()>& f) {
  CHECK(cudaStreamSynchronize(s));
  const auto t0 = std::chrono::steady_clock::now();
  f();
  const auto t1 = std::chrono::steady_clock::now();
  CHECK(cudaStreamSynchronize(s));
  return std::chrono::duration<double>(t1 - t0).count();
}

int run() {
  const int n = kN, grid = n / kBlock, w = n + 1;
  const int cells = w * w, diags = 2 * n - 1;
  std::vector<int> init(cells, 0), sim(n * n);
  std::mt19937 gen(42);
  std::uniform_int_distribution<int> draw(-3, 3);
  for (int& v : sim) v = draw(gen);
  for (int k = 0; k <= n; ++k) init[k] = init[k * w] = -kPenalty * k;
  // the matrix the longest diagonal's launches see: every cell before it
  std::vector<int> before(init);
  for (int d = 2; d <= n; ++d)
    for (int i = std::max(1, d - n); i <= std::min(n, d - 1); ++i) {
      const int j = d - i;
      before[i * w + j] = std::max(
          before[(i - 1) * w + j - 1] + sim[(i - 1) * n + j - 1],
          std::max(before[(i - 1) * w + j] - kPenalty,
                   before[i * w + j - 1] - kPenalty));
    }
  int *score, *pristine, *start, *simd, *diag;
  CHECK(cudaMalloc(&score, cells * 4));
  CHECK(cudaMalloc(&pristine, cells * 4));
  CHECK(cudaMalloc(&start, cells * 4));
  CHECK(cudaMalloc(&simd, n * n * 4));
  CHECK(cudaMalloc(&diag, 4));
  CHECK(cudaMemcpy(pristine, before.data(), cells * 4,
                   cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(start, init.data(), cells * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(simd, sim.data(), n * n * 4, cudaMemcpyHostToDevice));
  cudaStream_t s;
  CHECK(cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking));
  const int longest = n + 1, two = 2;

  const int ctas = (grid * kBlock + kCtaThreads - 1) / kCtaThreads;
  auto cells_at = [=](int threads, bool pdl) -> Launch {
    const int c = (grid * kBlock + threads - 1) / threads;
    return [=](cudaStream_t st, int* sc, const int* si, int* dg) {
      launch_ex(needle_nw_cells, c, threads, pdl, st, sc, si,
                (const int*)dg, n, kPenalty, grid * kBlock);
    };
  };
  std::vector<Variant> vs = {
      {"old",
       [=](cudaStream_t st, int* sc, const int* si, int* dg) {
         old_needle_nw<<<grid, kBlock, 0, st>>>(sc, si, dg, n, kPenalty);
       },
       true},
      {"new", cells_at(kCtaThreads, false), true},
      {"kernel",
       [=](cudaStream_t st, int* sc, const int* si, int* dg) {
         CHECK((cudaError_t)launch_needle_nw(sc, si, dg, n, kPenalty, grid,
                                             kBlock, ctas, st));
       },
       true},
  };
  for (int t : {16, 32, 64, 256, 512})
    vs.push_back({"W" + std::to_string(t), cells_at(t, true), true});
  vs.push_back({"empty",
                [=](cudaStream_t st, int*, const int*, int*) {
                  launch_ex(empty, ctas, kCtaThreads, false, st, 0);
                },
                false});
  vs.push_back({"empty_pdl",
                [=](cudaStream_t st, int*, const int*, int*) {
                  launch_ex(empty, ctas, kCtaThreads, true, st, 0);
                },
                false});

  auto set_diag = [&](const int* d) {
    CHECK(cudaMemcpyAsync(diag, d, 4, cudaMemcpyHostToDevice, s));
  };
  auto restore = [&](const int* from) {
    CHECK(cudaMemcpyAsync(score, from, cells * 4, cudaMemcpyDeviceToDevice,
                          s));
  };
  auto fetch = [&] {
    std::vector<int> o(cells);
    CHECK(cudaStreamSynchronize(s));
    CHECK(cudaMemcpy(o.data(), score, cells * 4, cudaMemcpyDeviceToHost));
    return o;
  };
  const int nv = (int)vs.size();
  std::vector<Run> runs(nv);
  std::vector<cudaGraphExec_t> graphs(nv, nullptr);
  std::vector<int> want_diag, want_all;
  int bad = 0;
  for (int turn = 0; turn < kTurns; ++turn) {
    for (int v = 0; v < nv; ++v) {
      const Variant& var = vs[v];
      auto one = [&] { var.launch(s, score, simd, diag); };
      auto pace = [&] {
        for (int k = 0; k < kPace; ++k) one();
      };
      auto steps = [&](int k) {
        for (int d = 0; d < k; ++d) {
          one();
          next_diag<<<1, 1, 0, s>>>(diag);
        }
      };
      auto chain = [&] { steps(diags); };
      // ms: one launch on the longest diagonal
      restore(pristine);
      set_diag(&longest);
      std::vector<float> ts;
      for (int r = 0; r < kWarm + kRuns; ++r) {
        const float t = window(s, 1000000, [] {}, one);
        if (r >= kWarm) ts.push_back(t);
      }
      runs[v].ms.push_back(median(ts));
      // pace_us: kPace launches back to back on the longest diagonal
      restore(pristine);
      const double enq = enqueue_s(s, pace);
      runs[v].enqueue.push_back(enq / kPace * 1e6);
      const long long cycles = (long long)(4 * enq * kMaxClockHz) + 1000000;
      ts.clear();
      for (int r = 0; r < kPaceRuns; ++r)
        ts.push_back(window(s, cycles, [] {}, pace) * 1e3f / kPace);
      runs[v].pace.push_back(median(ts));
      if (turn == 0 && var.computes) {
        const std::vector<int> got = fetch();
        std::vector<int> d;
        for (int i = 1; i <= n; ++i) d.push_back(got[i * w + longest - i]);
        if (var.name == "old") want_diag = d;
        if (d != want_diag)
          ++bad, std::printf("MISMATCH pace %s\n", var.name.c_str());
      }
      // chain_us: the whole wavefront, launches and updates, in windows
      restore(start);
      set_diag(&two);
      const double enq_seg = enqueue_s(s, [&] { steps(kSegment); });
      const long long seg_cycles =
          (long long)(4 * enq_seg * kMaxClockHz) + 1000000;
      restore(start);
      set_diag(&two);
      float total = 0;
      for (int done = 0; done < diags; done += kSegment) {
        const int k = std::min(kSegment, diags - done);
        total += window(s, seg_cycles, [] {}, [&] { steps(k); });
      }
      runs[v].chain.push_back(total * 1e3f / diags);
      if (turn == 0 && var.computes) {
        const std::vector<int> got = fetch();
        if (var.name == "old") want_all = got;
        if (got != want_all)
          ++bad, std::printf("MISMATCH chain %s\n", var.name.c_str());
      }
      // graph_us: the same launches captured once, one replay
      if (!graphs[v]) {
        cudaGraph_t g;
        CHECK(cudaStreamBeginCapture(s, cudaStreamCaptureModeThreadLocal));
        chain();
        CHECK(cudaStreamEndCapture(s, &g));
        CHECK(cudaGraphInstantiate(&graphs[v], g, 0));
        CHECK(cudaGraphDestroy(g));
      }
      CHECK(cudaGraphUpload(graphs[v], s));
      runs[v].graph.push_back(
          window(s, 10000000,
                 [&] {
                   restore(start);
                   set_diag(&two);
                 },
                 [&] { CHECK(cudaGraphLaunch(graphs[v], s)); }) *
          1e3f / diags);
      if (turn == 0 && var.computes && fetch() != want_all)
        ++bad, std::printf("MISMATCH graph %s\n", var.name.c_str());
    }
  }
  std::printf("\nneedle_nw n = %d: the chevron's %d blocks of %d, the "
              "kernel's %d CTAs of %d; medians of %d turns\n",
              n, grid, kBlock, ctas, kCtaThreads, kTurns);
  std::printf("  %-10s %10s %9s %9s %9s %11s\n", "variant", "ms",
              "pace_us", "chain_us", "graph_us", "enqueue_us");
  for (int v = 0; v < nv; ++v)
    std::printf("  %-10s %10.6f %9.4f %9.4f %9.4f %11.4f\n",
                vs[v].name.c_str(), median(runs[v].ms),
                median(runs[v].pace), median(runs[v].chain),
                median(runs[v].graph), median(runs[v].enqueue));
  for (int v = 0; v < nv; ++v) {
    std::printf("  %-10s turns pace_us", vs[v].name.c_str());
    for (float t : runs[v].pace) std::printf(" %.4f", t);
    std::printf(" chain_us");
    for (float t : runs[v].chain) std::printf(" %.4f", t);
    std::printf("\n");
  }
  for (cudaGraphExec_t g : graphs) CHECK(cudaGraphExecDestroy(g));
  CHECK(cudaStreamDestroy(s));
  for (int* p : {score, pristine, start, simd, diag}) CHECK(cudaFree(p));
  return bad;
}

}  // namespace variants

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("card: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const int bad = variants::run();
  std::printf("\nneedle_nw_variants: %s\n",
              bad ? "MISMATCH"
                  : "every variant equals the old kernel bit for bit");
  return bad ? 1 : 0;
}
