// Times src/repro_torch/csrc/pathfinder.cu at the main path's size
// (pathfinder 100000 100 20: the chevron's 1,563 blocks of 64 over rows of
// 100,000 columns, 99 launches) beside the kernel it replaced and variants
// of its design, on one CUDA card, so that the choices its source note
// makes rest on a measurement:
//   old        the kernel it replaced: CTAs of 64 threads, src staged in
//              a __shared__ halo behind a barrier, then row[0], then the
//              wall; launched plainly;
//   new        the shipped kernel (stencil1d's mapping, 16-byte accesses),
//              launched plainly: the mapping without the attribute;
//   kernel     the shipped launch through launch_pathfinder: the same as a
//              programmatic dependent launch;
//   scalar     the shipped kernel's one-int path (its path for cols % 4 !=
//              0 or a buffer off 16 bytes) on the same buffers, as a
//              programmatic dependent launch;
//   empty      an empty kernel of the shipped CTAs, launched plainly;
//   empty_pdl  the same as a programmatic dependent launch: with `empty`,
//              the floor under any kernel of these CTAs.
// Each variant gives four figures, each the median over five turns:
//   ms        one launch on the first row between two CUDA events after a
//             spin that covers its enqueue, median of 25 runs after 5
//             warm-ups: chip_smoke.py's `ms`;
//   pace_us   99 back-to-back launches on the first row between two events
//             after a spin that covers their enqueue, over 99, median of 5
//             runs: chip_smoke.py's `pace_us`;
//   chain_us  the whole chain as device mode runs it: 99 launches, each
//             followed by the update's two kernels (dst of the next row
//             zeroed, row[0] + 1 in device memory), src and dst swapped
//             between rows, timed as pace_us, over 99;
//   graph_us  the same launches captured once into a CUDA graph, one
//             replay between two events, over 99.
// `enqueue_us` is the host's time a launch of the pace run; the spin is
// four times the run's enqueue.  Every variant but the empty ones must
// equal the old kernel bit for bit: dst after the pace run, and the last
// row after the chain and the replay.  Build and run from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/pathfinder_variants tools/pathfinder_variants.cu \
//     && build/pathfinder_variants
#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <random>
#include <string>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/pathfinder.cu"

namespace variants {

constexpr int kTurns = 5, kRuns = 25, kWarm = 5, kPaceRuns = 5;
constexpr int kCols = 100000, kRows = 100;
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
#define PF_BLOCK 64
__global__ void old_pathfinder(const int* __restrict__ wall,
                               const int* __restrict__ src, int* dst,
                               const int* __restrict__ row, int rows,
                               int cols) {
  __shared__ int s[PF_BLOCK + 2];
  const int tid = threadIdx.x;
  const int col = blockIdx.x * PF_BLOCK + tid;
  const int c = min(max(col, 0), cols - 1);
  s[tid + 1] = src[c];
  if (tid == 0) s[0] = src[min(max(col - 1, 0), cols - 1)];
  if (tid == PF_BLOCK - 1) s[PF_BLOCK + 1] = src[min(max(col + 1, 0), cols - 1)];
  __syncthreads();
  int r = row[0];
  if (r < 0) r += rows;                 // gather rule: wrap once, clamp
  r = min(max(r, 0), rows - 1);
  const int best = min(min(s[tid], s[tid + 1]), s[tid + 2]);
  if (col < cols) dst[col] = wall[(size_t)r * cols + c] + best;
}

__global__ void empty(int) {}

// the chain's update in device mode: row + 1
__global__ void next_row(int* row) { row[0] += 1; }

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

using Launch = std::function<void(cudaStream_t, const int*, const int*,
                                  int*, const int*)>;

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
  const int cols = kCols, rows = kRows, grid = (cols + PF_BLOCK - 1) / PF_BLOCK;
  const int steps = rows - 1;
  const size_t bytes = (size_t)cols * 4;
  std::vector<int> wall((size_t)rows * cols);
  std::mt19937 gen(42);
  std::uniform_int_distribution<int> draw(0, 9);
  for (int& v : wall) v = draw(gen);
  int *walld, *a, *b, *row;
  CHECK(cudaMalloc(&walld, wall.size() * 4));
  CHECK(cudaMalloc(&a, bytes));
  CHECK(cudaMalloc(&b, bytes));
  CHECK(cudaMalloc(&row, 4));
  CHECK(cudaMemcpy(walld, wall.data(), wall.size() * 4,
                   cudaMemcpyHostToDevice));
  cudaStream_t s;
  CHECK(cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking));
  const int one_row = 1;
  // the first launch's state: src the wall's row 0, dst zero, row 1
  auto reset = [&] {
    CHECK(cudaMemcpyAsync(a, walld, bytes, cudaMemcpyDeviceToDevice, s));
    CHECK(cudaMemsetAsync(b, 0, bytes, s));
    CHECK(cudaMemcpyAsync(row, &one_row, 4, cudaMemcpyHostToDevice, s));
  };
  auto fetch = [&](const int* p) {
    std::vector<int> o(cols);
    CHECK(cudaStreamSynchronize(s));
    CHECK(cudaMemcpy(o.data(), p, bytes, cudaMemcpyDeviceToHost));
    return o;
  };

  const int ctas = (cols + pathfinder_cta_cols() - 1) / pathfinder_cta_cols();
  auto rows_at = [=](bool vec, bool pdl) -> Launch {
    return [=](cudaStream_t st, const int* w, const int* src, int* dst,
               const int* r) {
      const int m = std::min(cols, grid * PF_BLOCK);
      if (vec)
        launch_ex(pathfinder_rows<true>, ctas, kWarps * 32, pdl, st, w, src,
                  dst, r, rows, cols, m);
      else
        launch_ex(pathfinder_rows<false>, ctas, kWarps * 32, pdl, st, w,
                  src, dst, r, rows, cols, m);
    };
  };
  std::vector<Variant> vs = {
      {"old",
       [=](cudaStream_t st, const int* w, const int* src, int* dst,
           const int* r) {
         old_pathfinder<<<grid, PF_BLOCK, 0, st>>>(w, src, dst, r, rows,
                                                   cols);
       },
       true},
      {"new", rows_at(true, false), true},
      {"kernel",
       [=](cudaStream_t st, const int* w, const int* src, int* dst,
           const int* r) {
         CHECK((cudaError_t)launch_pathfinder(w, src, dst, r, rows, cols,
                                              grid, ctas, st));
       },
       true},
      {"scalar", rows_at(false, true), true},
      {"empty",
       [=](cudaStream_t st, const int*, const int*, int*, const int*) {
         launch_ex(empty, ctas, kWarps * 32, false, st, 0);
       },
       false},
      {"empty_pdl",
       [=](cudaStream_t st, const int*, const int*, int*, const int*) {
         launch_ex(empty, ctas, kWarps * 32, true, st, 0);
       },
       false},
  };

  const int nv = (int)vs.size();
  std::vector<Run> runs(nv);
  std::vector<cudaGraphExec_t> graphs(nv, nullptr);
  std::vector<int> want_row, want_last;
  // after an odd number of steps the last row lies in b, else in a
  int* last = steps % 2 ? b : a;
  int bad = 0;
  for (int turn = 0; turn < kTurns; ++turn) {
    for (int v = 0; v < nv; ++v) {
      const Variant& var = vs[v];
      auto one = [&] { var.launch(s, walld, a, b, row); };
      auto pace = [&] {
        for (int k = 0; k < steps; ++k) one();
      };
      auto chain = [&] {
        int *src = a, *dst = b;
        for (int k = 0; k < steps; ++k) {
          var.launch(s, walld, src, dst, row);
          std::swap(src, dst);
          CHECK(cudaMemsetAsync(dst, 0, bytes, s));
          next_row<<<1, 1, 0, s>>>(row);
        }
      };
      // ms: one launch on the first row
      reset();
      std::vector<float> ts;
      for (int r = 0; r < kWarm + kRuns; ++r) {
        const float t = window(s, 1000000, [] {}, one);
        if (r >= kWarm) ts.push_back(t);
      }
      runs[v].ms.push_back(median(ts));
      // pace_us: the first row's launch, steps times back to back
      reset();
      const double enq = enqueue_s(s, pace);
      runs[v].enqueue.push_back(enq / steps * 1e6);
      const long long cycles = (long long)(4 * enq * kMaxClockHz) + 1000000;
      ts.clear();
      for (int r = 0; r < kPaceRuns; ++r)
        ts.push_back(window(s, cycles, [] {}, pace) * 1e3f / steps);
      runs[v].pace.push_back(median(ts));
      if (turn == 0 && var.computes) {
        const std::vector<int> got = fetch(b);
        if (var.name == "old") want_row = got;
        if (got != want_row)
          ++bad, std::printf("MISMATCH pace %s\n", var.name.c_str());
      }
      // chain_us: the rows in turn, with the updates between them
      reset();
      const double enq_chain = enqueue_s(s, chain);
      runs[v].chain.push_back(
          window(s, (long long)(4 * enq_chain * kMaxClockHz) + 1000000,
                 reset, chain) *
          1e3f / steps);
      if (turn == 0 && var.computes) {
        const std::vector<int> got = fetch(last);
        if (var.name == "old") want_last = got;
        if (got != want_last)
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
          window(s, 10000000, reset,
                 [&] { CHECK(cudaGraphLaunch(graphs[v], s)); }) *
          1e3f / steps);
      if (turn == 0 && var.computes && fetch(last) != want_last)
        ++bad, std::printf("MISMATCH graph %s\n", var.name.c_str());
    }
  }
  std::printf("\npathfinder %d x %d: the chevron's %d blocks of %d, the "
              "kernel's %d CTAs of %d columns; medians of %d turns\n",
              cols, rows, grid, PF_BLOCK, ctas, pathfinder_cta_cols(),
              kTurns);
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
  for (int* p : {walld, a, b, row}) CHECK(cudaFree(p));
  return bad;
}

}  // namespace variants

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("card: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const int bad = variants::run();
  std::printf("\npathfinder_variants: %s\n",
              bad ? "MISMATCH"
                  : "every variant equals the old kernel bit for bit");
  return bad ? 1 : 0;
}
