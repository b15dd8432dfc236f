// Times src/repro_torch/csrc/nn.cu at the main path's size (nn filelist_4
// -r 5 -lat 30 -lng 90: 65,536 records, the chevron's 256 blocks of 256,
// a select of 1 x 256, k = 5) beside the kernels it replaced and variants
// of its design, on one CUDA card, so that the choices its source note
// makes rest on a measurement:
//   old        the kernels it replaced: a record a thread in the
//              chevron's CTAs of 256 with a __shared__ tree behind 8
//              barriers, the select one CTA of 256 reading step[0] after
//              its tree, both launched plainly;
//   new        the shipped kernels (a warp a logical block, the select
//              one warp), launched plainly: the mapping without the
//              attribute;
//   kernel     the shipped launches through launch_nn_reduce and
//              launch_nn_select: programmatic dependent launches;
//   W<w>       the shipped kernels as programmatic dependent launches,
//              nn_reduce on CTAs of w warps;
//   empty      an empty kernel of the shipped CTAs in each kernel's place,
//              launched plainly;
//   empty_pdl  the same as programmatic dependent launches: with `empty`,
//              the floor under any kernels of these CTAs.
// Each variant gives these figures, each the median over five turns:
//   ms_r, ms_s     one nn_reduce (nn_select) launch between two CUDA
//                  events after a spin that covers its enqueue, median of
//                  25 runs after 5 warm-ups: chip_smoke.py's `ms`;
//   pace_r, pace_s 512 back-to-back launches of the one kernel on fixed
//                  inputs (both are idempotent there) between two events
//                  after a spin that covers their enqueue, over 512,
//                  median of 5 runs: chip_smoke.py's `pace_us`;
//   chain_us       the entry's five iterations, each nn_reduce -> nn_select
//                  -> a one-thread kernel that adds 1 to step (the chain's
//                  update in device mode), streamed between two events
//                  after a spin, median of 25 runs from the entry's first
//                  state, over 5: a microsecond figure an iteration;
//   graph_us       the same 15 launches captured once into a CUDA graph
//                  (the kernels' launches as programmatic edges where they
//                  have the attribute), one replay, median of 25, over 5.
// `enqueue_us` is the host's time an nn_reduce launch of its pace run; the
// spin is four times the run's enqueue.  Every variant but the empty ones
// must equal the old kernels bit for bit on two inputs, the records as
// drawn and the same with lat NaN at record 0, at record 845 (t = 77 of
// block 3, a lane's third register) and across block 5: pval and pidx
// after one nn_reduce, and out_d, out_i and taken after the five
// iterations streamed and replayed.  Build and run from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/nn_variants tools/nn_variants.cu && build/nn_variants
#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <random>
#include <string>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/nn.cu"

namespace variants {

constexpr int kTurns = 5, kRuns = 25, kWarm = 5;
constexpr int kPace = 512, kPaceRuns = 5;
constexpr int kN = 65536, kBlock = 256, kGrid = kN / kBlock, kK = 5;
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

// the kernels this redesign replaced, as they were
__device__ __forceinline__ void old_argmin_tree(float* sv, int* si) {
  const int t = threadIdx.x;
  __syncthreads();
  for (int off = blockDim.x / 2; off >= 1; off >>= 1) {
    if (t < off) {
      const float v1 = sv[t], v2 = sv[t + off];
      const int i1 = si[t], i2 = si[t + off];
      if (v2 < v1 || (v2 == v1 && i2 < i1)) {
        sv[t] = v2;
        si[t] = i2;
      }
    }
    __syncthreads();
  }
}

__global__ void old_nn_reduce(const float* __restrict__ lat,
                              const float* __restrict__ lng,
                              const float* __restrict__ target,
                              const int* __restrict__ taken, float* pval,
                              int* pidx, int n, int n_pval, int n_pidx) {
  __shared__ float sv[1024];
  __shared__ int si[1024];
  const int t = threadIdx.x;
  const long long i = (long long)blockIdx.x * blockDim.x + t;
  const int g = i < n ? (int)i : n - 1;
  const float dx = __fsub_rn(lat[g], target[0]);
  const float dy = __fsub_rn(lng[g], target[1]);
  const float d = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  sv[t] = (i < n && taken[g] == 0) ? d : CUDART_INF_F;
  si[t] = g;
  old_argmin_tree(sv, si);
  if (t == 0) {
    if ((int)blockIdx.x < n_pval) pval[blockIdx.x] = sv[0];
    if ((int)blockIdx.x < n_pidx) pidx[blockIdx.x] = si[0];
  }
}

__global__ void old_nn_select(const float* __restrict__ pval,
                              const int* __restrict__ pidx,
                              const int* __restrict__ step, float* out_d,
                              int* out_i, int* taken, int n_out_d,
                              int n_out_i, int n_taken) {
  __shared__ float sv[1024];
  __shared__ int si[1024];
  const int t = threadIdx.x;
  sv[t] = pval[t];
  si[t] = pidx[t];
  old_argmin_tree(sv, si);
  if (t == 0) {
    const int s = step[0];
    const int od = wrap_or_drop(s, n_out_d), oi = wrap_or_drop(s, n_out_i);
    const int tk = wrap_or_drop(si[0], n_taken);
    if (od >= 0) out_d[od] = sv[0];
    if (oi >= 0) out_i[oi] = si[0];
    if (tk >= 0) taken[tk] = 1;
  }
}

__global__ void empty(int) {}

// the chain's update in device mode: step + 1
__global__ void next_step(int* step) { step[0] += 1; }

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

struct Bufs {
  float *lat, *lng, *target, *pval, *out_d;
  int *taken, *pidx, *out_i, *step;
};

using Launch = std::function<void(cudaStream_t, const Bufs&)>;

struct Variant {
  std::string name;
  Launch reduce, select;
  bool computes;
};

struct Run {
  std::vector<float> ms_r, ms_s, pace_r, pace_s, chain, graph, enqueue;
};

// what a variant leaves: pval, pidx after one reduce; out_d, out_i,
// taken after the chain
struct Result {
  std::vector<float> pval, out_d;
  std::vector<int> pidx, out_i, taken;
  bool operator!=(const Result& o) const {
    auto bits = [](const std::vector<float>& a, const std::vector<float>& b) {
      return a.size() == b.size() &&
             std::memcmp(a.data(), b.data(), a.size() * 4) == 0;
    };
    return !(bits(pval, o.pval) && bits(out_d, o.out_d) && pidx == o.pidx &&
             out_i == o.out_i && taken == o.taken);
  }
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
  const int n = kN, grid = kGrid;
  // the entry's records: lat in [0, 90), lng in [0, 180), target (30, 90)
  std::vector<float> lat(n), lng(n);
  std::mt19937 gen(42);
  std::uniform_real_distribution<float> dlat(0.0f, 90.0f), dlng(0.0f, 180.0f);
  for (int i = 0; i < n; ++i) lat[i] = dlat(gen), lng[i] = dlng(gen);
  std::vector<float> lat_nan(lat);
  lat_nan[0] = lat_nan[3 * kBlock + 77] = NAN;
  for (int t = 0; t < kBlock; ++t) lat_nan[5 * kBlock + t] = NAN;
  const float target[2] = {30.0f, 90.0f};

  Bufs b;
  float* lat_nan_d;
  CHECK(cudaMalloc(&b.lat, n * 4));
  CHECK(cudaMalloc(&lat_nan_d, n * 4));
  CHECK(cudaMalloc(&b.lng, n * 4));
  CHECK(cudaMalloc(&b.target, 8));
  CHECK(cudaMalloc(&b.taken, n * 4));
  CHECK(cudaMalloc(&b.pval, grid * 4));
  CHECK(cudaMalloc(&b.pidx, grid * 4));
  CHECK(cudaMalloc(&b.out_d, kK * 4));
  CHECK(cudaMalloc(&b.out_i, kK * 4));
  CHECK(cudaMalloc(&b.step, 4));
  float* lat_d = b.lat;
  CHECK(cudaMemcpy(lat_d, lat.data(), n * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(lat_nan_d, lat_nan.data(), n * 4,
                   cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(b.lng, lng.data(), n * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(b.target, target, 8, cudaMemcpyHostToDevice));
  cudaStream_t s;
  CHECK(cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking));

  const int threads = kCtaWarps * 32;
  auto reduce_at = [=](int w, bool pdl) -> Launch {
    const int c = (int)nn_reduce_ctas_of(grid, kBlock, w * 32);
    return [=](cudaStream_t st, const Bufs& x) {
      launch_ex(nn_reduce_kernel<kBlock>, c, w * 32, pdl, st,
                (const float*)x.lat, (const float*)x.lng,
                (const float*)x.target, (const int*)x.taken, x.pval, x.pidx,
                n, grid, grid, grid);
    };
  };
  auto select_new = [=](bool pdl) -> Launch {
    return [=](cudaStream_t st, const Bufs& x) {
      launch_ex(nn_select_kernel<kGrid>, 1, 32, pdl, st,
                (const float*)x.pval, (const int*)x.pidx,
                (const int*)x.step, x.out_d, x.out_i, x.taken, kK, kK, n);
    };
  };
  const int ctas = (int)nn_reduce_ctas_of(grid, kBlock, threads);
  auto empty_of = [=](int c, int t, bool pdl) -> Launch {
    return [=](cudaStream_t st, const Bufs&) {
      launch_ex(empty, c, t, pdl, st, 0);
    };
  };
  std::vector<Variant> vs = {
      {"old",
       [=](cudaStream_t st, const Bufs& x) {
         old_nn_reduce<<<grid, kBlock, 0, st>>>(x.lat, x.lng, x.target,
                                                x.taken, x.pval, x.pidx, n,
                                                grid, grid);
       },
       [=](cudaStream_t st, const Bufs& x) {
         old_nn_select<<<1, grid, 0, st>>>(x.pval, x.pidx, x.step, x.out_d,
                                           x.out_i, x.taken, kK, kK, n);
       },
       true},
      {"new", reduce_at(kCtaWarps, false), select_new(false), true},
      {"kernel",
       [=](cudaStream_t st, const Bufs& x) {
         CHECK((cudaError_t)launch_nn_reduce(x.lat, x.lng, x.target, x.taken,
                                             x.pval, x.pidx, n, grid, grid,
                                             grid, kBlock, st));
       },
       [=](cudaStream_t st, const Bufs& x) {
         CHECK((cudaError_t)launch_nn_select(x.pval, x.pidx, x.step, x.out_d,
                                             x.out_i, x.taken, kK, kK, n, 1,
                                             grid, st));
       },
       true},
  };
  for (int w : {1, 2, 4, 8})
    vs.push_back({"W" + std::to_string(w), reduce_at(w, true),
                  select_new(true), true});
  vs.push_back({"empty", empty_of(ctas, threads, false),
                empty_of(1, 32, false), false});
  vs.push_back({"empty_pdl", empty_of(ctas, threads, true),
                empty_of(1, 32, true), false});

  // the entry's first state: nothing taken, step 0, the outputs zero
  auto reset = [&] {
    CHECK(cudaMemsetAsync(b.taken, 0, n * 4, s));
    CHECK(cudaMemsetAsync(b.step, 0, 4, s));
    CHECK(cudaMemsetAsync(b.out_d, 0, kK * 4, s));
    CHECK(cudaMemsetAsync(b.out_i, 0, kK * 4, s));
    CHECK(cudaMemsetAsync(b.pval, 0, grid * 4, s));
    CHECK(cudaMemsetAsync(b.pidx, 0, grid * 4, s));
  };
  auto fetch_partials = [&](Result& r) {
    CHECK(cudaStreamSynchronize(s));
    r.pval.resize(grid), r.pidx.resize(grid);
    CHECK(cudaMemcpy(r.pval.data(), b.pval, grid * 4,
                     cudaMemcpyDeviceToHost));
    CHECK(cudaMemcpy(r.pidx.data(), b.pidx, grid * 4,
                     cudaMemcpyDeviceToHost));
  };
  auto fetch_outputs = [&](Result& r) {
    CHECK(cudaStreamSynchronize(s));
    r.out_d.resize(kK), r.out_i.resize(kK), r.taken.resize(n);
    CHECK(cudaMemcpy(r.out_d.data(), b.out_d, kK * 4,
                     cudaMemcpyDeviceToHost));
    CHECK(cudaMemcpy(r.out_i.data(), b.out_i, kK * 4,
                     cudaMemcpyDeviceToHost));
    CHECK(cudaMemcpy(r.taken.data(), b.taken, n * 4,
                     cudaMemcpyDeviceToHost));
  };
  const int nv = (int)vs.size();
  std::vector<Run> runs(nv);
  // each variant's graph of the chain, on the records as drawn and with NaN
  std::vector<cudaGraphExec_t> graphs(2 * nv, nullptr);
  Result want[2];
  int bad = 0;
  for (int turn = 0; turn < kTurns; ++turn) {
    for (int v = 0; v < nv; ++v) {
      const Variant& var = vs[v];
      auto chain = [&] {
        for (int it = 0; it < kK; ++it) {
          var.reduce(s, b);
          var.select(s, b);
          next_step<<<1, 1, 0, s>>>(b.step);
        }
      };
      auto graph_of = [&](int which) {
        cudaGraphExec_t& g = graphs[2 * v + which];
        if (!g) {
          cudaGraph_t gr;
          CHECK(cudaStreamBeginCapture(s, cudaStreamCaptureModeThreadLocal));
          chain();
          CHECK(cudaStreamEndCapture(s, &gr));
          CHECK(cudaGraphInstantiate(&g, gr, 0));
          CHECK(cudaGraphDestroy(gr));
        }
        return g;
      };
      // bits, turn 0: both inputs, one reduce, the chain, its replay
      if (turn == 0 && var.computes) {
        for (int which = 0; which < 2; ++which) {
          b.lat = which ? lat_nan_d : lat_d;
          const char* input = which ? "nan" : "drawn";
          Result got;
          reset();
          var.reduce(s, b);
          fetch_partials(got);
          reset();
          chain();
          fetch_outputs(got);
          if (var.name == "old") want[which] = got;
          if (got != want[which])
            ++bad, std::printf("MISMATCH %s streamed on the %s input\n",
                               var.name.c_str(), input);
          Result replayed = got;
          reset();
          CHECK(cudaGraphLaunch(graph_of(which), s));
          fetch_outputs(replayed);
          if (replayed != want[which])
            ++bad, std::printf("MISMATCH %s replayed on the %s input\n",
                               var.name.c_str(), input);
        }
        b.lat = lat_d;
      }
      auto time_one = [&](const Launch& one, std::vector<float>& ms_out,
                          std::vector<float>& pace_out,
                          std::vector<float>* enq_out) {
        std::vector<float> ts;
        for (int r = 0; r < kWarm + kRuns; ++r) {
          const float t = window(s, 1000000, [] {}, [&] { one(s, b); });
          if (r >= kWarm) ts.push_back(t);
        }
        ms_out.push_back(median(ts));
        auto pace = [&] {
          for (int k = 0; k < kPace; ++k) one(s, b);
        };
        const double enq = enqueue_s(s, pace);
        if (enq_out) enq_out->push_back(enq / kPace * 1e6);
        const long long cycles = (long long)(4 * enq * kMaxClockHz) + 1000000;
        ts.clear();
        for (int r = 0; r < kPaceRuns; ++r)
          ts.push_back(window(s, cycles, [] {}, pace) * 1e3f / kPace);
        pace_out.push_back(median(ts));
      };
      // ms and pace_us: nn_reduce from the first state, then nn_select on
      // the partials it left (step 0)
      reset();
      var.reduce(s, b);
      time_one(var.reduce, runs[v].ms_r, runs[v].pace_r, &runs[v].enqueue);
      time_one(var.select, runs[v].ms_s, runs[v].pace_s, nullptr);
      // chain_us: the five iterations streamed from the first state
      std::vector<float> ts;
      const double enq = enqueue_s(s, chain);
      const long long cycles = (long long)(4 * enq * kMaxClockHz) + 1000000;
      for (int r = 0; r < kWarm + kRuns; ++r) {
        const float t = window(s, cycles, reset, chain);
        if (r >= kWarm) ts.push_back(t * 1e3f / kK);
      }
      runs[v].chain.push_back(median(ts));
      // graph_us: one replay of the same launches
      cudaGraphExec_t g = graph_of(0);
      CHECK(cudaGraphUpload(g, s));
      ts.clear();
      for (int r = 0; r < kWarm + kRuns; ++r) {
        const float t = window(s, 1000000, reset,
                               [&] { CHECK(cudaGraphLaunch(g, s)); });
        if (r >= kWarm) ts.push_back(t * 1e3f / kK);
      }
      runs[v].graph.push_back(median(ts));
    }
  }
  std::printf("\nnn n = %d, k = %d: the chevron's %d blocks of %d and a "
              "select of 1 x %d; nn_reduce's %d CTAs of %d, nn_select's 1 "
              "of 32; medians of %d turns\n",
              n, kK, grid, kBlock, grid, ctas, threads, kTurns);
  std::printf("  %-10s %10s %10s %9s %9s %9s %9s %11s\n", "variant", "ms_r",
              "ms_s", "pace_r", "pace_s", "chain_us", "graph_us",
              "enqueue_us");
  for (int v = 0; v < nv; ++v)
    std::printf("  %-10s %10.6f %10.6f %9.4f %9.4f %9.4f %9.4f %11.4f\n",
                vs[v].name.c_str(), median(runs[v].ms_r),
                median(runs[v].ms_s), median(runs[v].pace_r),
                median(runs[v].pace_s), median(runs[v].chain),
                median(runs[v].graph), median(runs[v].enqueue));
  for (int v = 0; v < nv; ++v) {
    std::printf("  %-10s turns pace_r", vs[v].name.c_str());
    for (float t : runs[v].pace_r) std::printf(" %.4f", t);
    std::printf(" pace_s");
    for (float t : runs[v].pace_s) std::printf(" %.4f", t);
    std::printf(" chain_us");
    for (float t : runs[v].chain) std::printf(" %.4f", t);
    std::printf("\n");
  }
  for (cudaGraphExec_t g : graphs)
    if (g) CHECK(cudaGraphExecDestroy(g));
  CHECK(cudaStreamDestroy(s));
  for (void* p : {(void*)lat_d, (void*)lat_nan_d, (void*)b.lng,
                  (void*)b.target, (void*)b.taken, (void*)b.pval,
                  (void*)b.pidx, (void*)b.out_d, (void*)b.out_i,
                  (void*)b.step})
    CHECK(cudaFree(p));
  return bad;
}

}  // namespace variants

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("card: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const int bad = variants::run();
  std::printf("\nnn_variants: %s\n",
              bad ? "MISMATCH"
                  : "every variant equals the old kernels bit for bit");
  return bad ? 1 : 0;
}
