// Times src/repro_torch/csrc/reverse.cu at the main path's size (the
// paper's Listing 3 at CUDA's widest block: one block of 1,024 threads over
// d[1024], 1,024 ints of extern shared memory) beside the kernel it
// replaced and variants of its design, on one CUDA card, so that the
// choices its source note makes rest on a measurement:
//   old          the kernel it replaced: one CTA of the block's threads
//                staging d in extern __shared__ memory, a barrier a pass,
//                the grid's passes in turn, launched plainly;
//   new          the shipped kernel (the closed form, one CTA of the
//                shipped width), launched plainly: the mapping without the
//                attribute;
//   kernel       the shipped launch through launch_reverse: the same CTA
//                as a programmatic dependent launch;
//   W<w>v, W<w>i the shipped kernel as a programmatic dependent launch on a
//                CTA of w warps, with the 16-byte path where the launcher
//                would take it (v) or one int a lane throughout (i);
//   empty        an empty kernel of the shipped CTA, launched plainly;
//   empty_pdl    the same as a programmatic dependent launch: with `empty`,
//                the floor under any kernel of this CTA.
// Each variant gives these figures, each the median over five turns:
//   ms         one launch (grid 1) between two CUDA events after a spin
//              that covers its enqueue, median of 25 runs after 5
//              warm-ups: chip_smoke.py's `ms`;
//   pace_us    511 back-to-back launches on one buffer (an odd count of an
//              involution, so the buffer ends as after one launch) between
//              two events after a spin that covers their enqueue, over
//              511, median of 5 runs: chip_smoke.py's `pace_us`;
//   rows_us    8 back-to-back launches, each on a buffer of its own (the
//              form api.launch_batch gives a batch's rows), between two
//              events after a spin, median of 25 runs, over 8.
// `enqueue_us` is the host's time a launch of the pace run; the spin is
// four times the run's enqueue.  Every variant but the empty ones must
// equal the old kernel bit for bit after one launch at grid 1, 2 and 3 on
// (block, extent) = (1024, 1024), (1000, 1028) (a window of 972 cells
// from 28, the 16-byte path with a tail of one-int pairs), (1000, 1029)
// (a window of 971 from 29: the one-int path and a middle cell) and
// (512, 1536) (zeros only), after the pace run and on each of the 8 rows.
// Build and run from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/reverse_variants tools/reverse_variants.cu \
//     && build/reverse_variants
#include <algorithm>
#include <chrono>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <random>
#include <string>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/reverse.cu"

namespace variants {

constexpr int kTurns = 5, kRuns = 25, kWarm = 5;
constexpr int kPace = 511, kPaceRuns = 5, kRows = 8;
constexpr int kN = 1024, kBlock = 1024, kExtent = 1024;
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
__global__ void old_reverse(int* d, int ns, int passes) {
  extern __shared__ int s[];
  const int t = threadIdx.x;
  for (int i = blockDim.x + t; i < ns; i += blockDim.x) s[i] = 0;
  for (int pass = 0; pass < passes; ++pass) {
    if (pass) __syncthreads();
    s[t] = d[t];
    __syncthreads();
    d[t] = s[ns - 1 - t];
  }
}

__global__ void empty(int) {}

__global__ void spin(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

template <typename K, typename... A>
void launch_ex(K kern, int threads, bool pdl, cudaStream_t s, A... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
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

// one launch: d, grid, block, extent (ints)
using Launch = std::function<void(cudaStream_t, int*, int, int, int)>;

struct Variant {
  std::string name;
  Launch launch;
  bool computes;
};

struct Run {
  std::vector<float> ms, pace, enqueue, rows;
};

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

double enqueue_s(cudaStream_t s, const std::function<void()>& f) {
  CHECK(cudaStreamSynchronize(s));
  const auto t0 = std::chrono::steady_clock::now();
  f();
  const auto t1 = std::chrono::steady_clock::now();
  CHECK(cudaStreamSynchronize(s));
  return std::chrono::duration<double>(t1 - t0).count();
}

std::vector<int> fetch(const int* p, int n) {
  std::vector<int> v(n);
  CHECK(cudaMemcpy(v.data(), p, n * 4, cudaMemcpyDeviceToHost));
  return v;
}

int run() {
  std::vector<std::vector<int>> inputs(kRows, std::vector<int>(kN));
  std::mt19937 gen(42);
  std::uniform_int_distribution<int> val(0, 99);
  for (auto& in : inputs)
    for (int& x : in) x = val(gen);
  // d and the rows, each on a 16-byte boundary (cudaMalloc's 256)
  std::vector<int*> rows(kRows);
  for (int*& r : rows) CHECK(cudaMalloc(&r, kN * 4));
  int* d = rows[0];
  cudaStream_t s;
  CHECK(cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking));
  auto load = [&] {
    for (int r = 0; r < kRows; ++r)
      CHECK(cudaMemcpyAsync(rows[r], inputs[r].data(), kN * 4,
                            cudaMemcpyHostToDevice, s));
  };

  const int threads = kCtaWarps * 32;
  auto closed = [](int w, bool pdl, bool vec) -> Launch {
    return [=](cudaStream_t st, int* x, int grid, int block, int ns) {
      if (vec && vec_ok(x, block, ns))
        launch_ex(reverse_kernel<true>, 32 * w, pdl, st, x, block, ns,
                  grid & 1);
      else
        launch_ex(reverse_kernel<false>, 32 * w, pdl, st, x, block, ns,
                  grid & 1);
    };
  };
  std::vector<Variant> vs = {
      {"old",
       [](cudaStream_t st, int* x, int grid, int block, int ns) {
         old_reverse<<<1, block, ns * 4, st>>>(x, ns, grid);
       },
       true},
      {"new", closed(kCtaWarps, false, true), true},
      {"kernel",
       [](cudaStream_t st, int* x, int grid, int block, int ns) {
         CHECK((cudaError_t)launch_reverse(x, grid, block, (size_t)ns * 4,
                                           st));
       },
       true},
  };
  for (int w : {1, 2, 4, 8}) {
    vs.push_back({"W" + std::to_string(w) + "v", closed(w, true, true), true});
    vs.push_back({"W" + std::to_string(w) + "i", closed(w, true, false),
                  true});
  }
  vs.push_back({"empty",
                [=](cudaStream_t st, int*, int, int, int) {
                  launch_ex(empty, threads, false, st, 0);
                },
                false});
  vs.push_back({"empty_pdl",
                [=](cudaStream_t st, int*, int, int, int) {
                  launch_ex(empty, threads, true, st, 0);
                },
                false});

  const int nv = (int)vs.size();
  const int shapes[][2] = {{1024, 1024}, {1000, 1028}, {1000, 1029},
                           {512, 1536}};
  // bits: one launch at each grid and shape, against the old kernel
  int bad = 0;
  for (const auto& sh : shapes) {
    for (int grid = 1; grid <= 3; ++grid) {
      std::vector<int> want;
      for (const Variant& v : vs) {
        if (!v.computes) continue;
        load();
        v.launch(s, d, grid, sh[0], sh[1]);
        CHECK(cudaStreamSynchronize(s));
        const std::vector<int> got = fetch(d, kN);
        if (v.name == "old") want = got;
        if (got != want)
          ++bad, std::printf("MISMATCH %s at grid %d, block %d, extent %d\n",
                             v.name.c_str(), grid, sh[0], sh[1]);
      }
    }
  }
  std::vector<Run> runs(nv);
  std::vector<int> want_pace;
  std::vector<std::vector<int>> want_rows(kRows);
  for (int turn = 0; turn < kTurns; ++turn) {
    for (int v = 0; v < nv; ++v) {
      const Variant& var = vs[v];
      auto one = [&] { var.launch(s, d, 1, kBlock, kExtent); };
      auto pace = [&] {
        for (int i = 0; i < kPace; ++i) one();
      };
      auto batch = [&] {
        for (int r = 0; r < kRows; ++r)
          var.launch(s, rows[r], 1, kBlock, kExtent);
      };
      if (turn == 0 && var.computes) {
        load();
        pace();
        CHECK(cudaStreamSynchronize(s));
        const std::vector<int> got = fetch(d, kN);
        if (var.name == "old") want_pace = got;
        if (got != want_pace)
          ++bad, std::printf("MISMATCH %s after the pace run\n",
                             var.name.c_str());
        load();
        batch();
        CHECK(cudaStreamSynchronize(s));
        for (int r = 0; r < kRows; ++r) {
          const std::vector<int> row = fetch(rows[r], kN);
          if (var.name == "old") want_rows[r] = row;
          if (row != want_rows[r])
            ++bad, std::printf("MISMATCH %s on row %d\n", var.name.c_str(),
                               r);
        }
      }
      load();
      std::vector<float> ts;
      for (int r = 0; r < kWarm + kRuns; ++r) {
        const float t = window(s, 1000000, [] {}, one);
        if (r >= kWarm) ts.push_back(t);
      }
      runs[v].ms.push_back(median(ts));
      const double enq = enqueue_s(s, pace);
      runs[v].enqueue.push_back(enq / kPace * 1e6);
      const long long cycles = (long long)(4 * enq * kMaxClockHz) + 1000000;
      ts.clear();
      for (int r = 0; r < kPaceRuns; ++r)
        ts.push_back(window(s, cycles, [] {}, pace) * 1e3f / kPace);
      runs[v].pace.push_back(median(ts));
      ts.clear();
      for (int r = 0; r < kWarm + kRuns; ++r) {
        const float t = window(s, 1000000, [] {}, batch);
        if (r >= kWarm) ts.push_back(t * 1e3f / kRows);
      }
      runs[v].rows.push_back(median(ts));
    }
  }
  std::printf("\nreverse block %d, extent %d ints, grid 1: the shipped CTA "
              "of %d threads; medians of %d turns\n",
              kBlock, kExtent, threads, kTurns);
  std::printf("  %-10s %10s %9s %11s %9s\n", "variant", "ms", "pace_us",
              "enqueue_us", "rows_us");
  for (int v = 0; v < nv; ++v)
    std::printf("  %-10s %10.6f %9.4f %11.4f %9.4f\n", vs[v].name.c_str(),
                median(runs[v].ms), median(runs[v].pace),
                median(runs[v].enqueue), median(runs[v].rows));
  for (int v = 0; v < nv; ++v) {
    std::printf("  %-10s turns pace_us", vs[v].name.c_str());
    for (float t : runs[v].pace) std::printf(" %.4f", t);
    std::printf(" rows_us");
    for (float t : runs[v].rows) std::printf(" %.4f", t);
    std::printf("\n");
  }
  CHECK(cudaStreamDestroy(s));
  for (int* r : rows) CHECK(cudaFree(r));
  return bad;
}

}  // namespace variants

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("card: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const int bad = variants::run();
  std::printf("\nreverse_variants: %s\n",
              bad ? "MISMATCH"
                  : "every variant equals the old kernel bit for bit");
  return bad ? 1 : 0;
}
