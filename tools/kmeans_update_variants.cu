// Times src/repro_torch/csrc/kmeans.cu's kmeans_update at the main path's
// size (kmeans -o -i kdd_cup: 494,080 points, k = 4, the chevron's 7,720
// blocks of 64 for assign and 4 blocks of 8 for update) beside the kernel
// it replaced and variants of its design, on one CUDA card, so that the
// choices its source note makes rest on a measurement:
//   old        the kernel it replaced: the chevron's k blocks of 8, thread
//              0 of each reading count[c] and only then the sums,
//              launched plainly;
//   new        the shipped kernel (a lane a cluster, one round trip),
//              launched plainly: the mapping without the attribute;
//   kernel     the shipped launch through launch_kmeans_update: the same
//              CTA as a programmatic dependent launch;
//   W<w>       the shipped kernel as a programmatic dependent launch on
//              CTAs of w warps (the lanes past k return at once);
//   empty      an empty kernel of the shipped CTA, launched plainly;
//   empty_pdl  the same as a programmatic dependent launch: with `empty`,
//              the floor under any kernel of this CTA.
// Each variant gives these figures, each the median over five turns:
//   ms         one update launch on the sums one assign leaves, between
//              two CUDA events after a spin that covers its enqueue,
//              median of 25 runs after 5 warm-ups: chip_smoke.py's `ms`;
//   pace_us    512 back-to-back update launches on those sums (the
//              update is idempotent there) between two events after a
//              spin that covers their enqueue, over 512, median of 5
//              runs: chip_smoke.py's `pace_us`;
//   chain_us   the entry's three iterations, each four zero fills (one
//              plain launch a buffer, as the chain's torch.zeros_like) ->
//              assign -> update, streamed between two events after a spin,
//              median of 25 runs from the entry's first state, over 3: a
//              microsecond figure an iteration;
//   graph_us   the same 18 launches captured once into a CUDA graph (the
//              update's launches as programmatic edges where it has the
//              attribute), one replay, median of 25, over 3;
//   chain_trig, graph_trig  the same with assign signalling
//              griddepcontrol.launch_dependents once its loads are issued
//              (assign_regs<4, true>), so that a dependent update's CTA
//              may start before assign's CTAs have all finished.
// `enqueue_us` is the host's time an update launch of the pace run; the
// spin is four times the run's enqueue.  Every variant but the empty ones
// must equal the old kernel bit for bit: cx and cy after one update on
// the drawn inputs, every buffer after the three iterations streamed and
// replayed with and without the trigger, and, at k = 100 on CTAs of its
// own width, counts of 0, negative, 1 and above 2^24 with NaN and +-0
// sums: there the old kernel's cx and cy for every count >= 0, and the
// reference's rule (divide by max(count, 1), keep the centroid where the
// count is 0) for the negative ones, which the old kernel divided by.
// Build and run from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/kmeans_update_variants tools/kmeans_update_variants.cu \
//     && build/kmeans_update_variants
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

#include "../src/repro_torch/csrc/kmeans.cu"

namespace variants {

constexpr int kTurns = 5, kRuns = 25, kWarm = 5;
constexpr int kPace = 512, kPaceRuns = 5, kIters = 3;
constexpr int kN = 494080, kK = 4, kBlock = 64, kGrid = kN / kBlock;
constexpr int kEdgeK = 100;               // the edge input's clusters
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
__global__ void old_kmeans_update(const float* __restrict__ sumx,
                                  const float* __restrict__ sumy,
                                  const int* __restrict__ count, float* cx,
                                  float* cy, int k) {
  const int c = blockIdx.x;
  if (threadIdx.x != 0 || c >= k) return;
  const int cnt = count[c];
  if (cnt == 0) return;
  const float safe = __int2float_rn(cnt);
  cx[c] = __fdiv_rn(sumx[c], safe);
  cy[c] = __fdiv_rn(sumy[c], safe);
}

__global__ void empty(int) {}

// a zero fill of one buffer, as the chain's torch.zeros_like
__global__ void fill_zero(int* p, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) p[i] = 0;
}

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

struct Dev {
  float *px, *py, *cx, *cy, *sumx, *sumy;
  int *assign, *changed, *count;
};

// an update launch over k clusters
using Update = std::function<void(cudaStream_t, const Dev&, int k)>;

struct Variant {
  std::string name;
  Update update;
  bool computes;
};

struct Run {
  std::vector<float> ms, pace, enqueue, chain, graph, chain_trig, graph_trig;
};

// the buffers a run leaves
struct State {
  std::vector<float> cx, cy, sumx, sumy;
  std::vector<int> assign, changed, count;
  bool operator==(const State& o) const {
    auto bits = [](const std::vector<float>& a, const std::vector<float>& b) {
      return a.size() == b.size() &&
             std::memcmp(a.data(), b.data(), a.size() * 4) == 0;
    };
    return bits(cx, o.cx) && bits(cy, o.cy) && bits(sumx, o.sumx) &&
           bits(sumy, o.sumy) && assign == o.assign &&
           changed == o.changed && count == o.count;
  }
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

template <typename T>
std::vector<T> fetch(const T* p, int n) {
  std::vector<T> v(n);
  CHECK(cudaMemcpy(v.data(), p, n * sizeof(T), cudaMemcpyDeviceToHost));
  return v;
}

// The edge input at kEdgeK clusters: counts of 0, negative, 1 and above
// 2^24 (exact and not), sums with NaN and +-0, each cluster's centroid a
// value no update computes.  Holds every variant's cx, cy against the old
// kernel's where the count is >= 0 and against the reference's rule where
// it is negative; returns the mismatches.
int edge_check(const std::vector<Variant>& vs, cudaStream_t s) {
  const int k = kEdgeK;
  const int counts[] = {0, -2, 3, 5, 1, -1, 1 << 24, (1 << 24) + 1,
                        (1 << 25) + 3, -(1 << 25) - 3, 7, 0x7fffffff,
                        -0x7fffffff - 1};
  const float sums[] = {6.0f, 5.0f, 9.0f, 10.0f, 0.0f, -0.0f, NAN,
                        -NAN, 1e30f, -1e-30f, 3.0f, 16777217.0f, 123.25f};
  std::vector<float> sx(k), sy(k), cx0(k), cy0(k);
  std::vector<int> cnt(k);
  for (int c = 0; c < k; ++c) {
    cnt[c] = counts[c % 13];
    sx[c] = sums[c % 13];
    sy[c] = sums[(c * 7 + 3) % 13];
    cx0[c] = -1000.0f - c;
    cy0[c] = 2000.0f + c;
  }
  Dev d{};
  CHECK(cudaMalloc(&d.sumx, k * 4));
  CHECK(cudaMalloc(&d.sumy, k * 4));
  CHECK(cudaMalloc(&d.count, k * 4));
  CHECK(cudaMalloc(&d.cx, k * 4));
  CHECK(cudaMalloc(&d.cy, k * 4));
  CHECK(cudaMemcpy(d.sumx, sx.data(), k * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(d.sumy, sy.data(), k * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(d.count, cnt.data(), k * 4, cudaMemcpyHostToDevice));
  int bad = 0;
  std::vector<float> old_x, old_y;
  for (const Variant& v : vs) {
    if (!v.computes) continue;
    CHECK(cudaMemcpy(d.cx, cx0.data(), k * 4, cudaMemcpyHostToDevice));
    CHECK(cudaMemcpy(d.cy, cy0.data(), k * 4, cudaMemcpyHostToDevice));
    v.update(s, d, k);
    CHECK(cudaStreamSynchronize(s));
    const std::vector<float> gx = fetch(d.cx, k), gy = fetch(d.cy, k);
    if (v.name == "old") old_x = gx, old_y = gy;
    int differ = 0, f7 = 0;
    for (int c = 0; c < k; ++c) {
      const float safe = (float)std::max(cnt[c], 1);
      const float want[2] = {cnt[c] == 0 ? cx0[c] : sx[c] / safe,
                             cnt[c] == 0 ? cy0[c] : sy[c] / safe};
      const float got[2] = {gx[c], gy[c]};
      const float old[2] = {old_x[c], old_y[c]};
      for (int j = 0; j < 2; ++j) {
        const bool rule = std::isnan(want[j])
                              ? std::isnan(got[j])
                              : std::memcmp(&want[j], &got[j], 4) == 0;
        if (cnt[c] < 0) {
          f7 += std::memcmp(&old[j], &want[j], 4) != 0;
          if (v.name != "old" && !rule) ++differ;
        } else if (std::memcmp(&old[j], &got[j], 4) != 0 || !rule) {
          ++differ;
        }
      }
    }
    if (differ)
      ++bad, std::printf("MISMATCH %s on the edge counts: %d values\n",
                         v.name.c_str(), differ);
    if (v.name == "old")
      std::printf("  edge counts (k = %d): the old kernel differs from the "
                  "reference's rule in %d values, all at negative counts\n",
                  k, f7);
  }
  for (void* p : {(void*)d.sumx, (void*)d.sumy, (void*)d.count,
                  (void*)d.cx, (void*)d.cy})
    CHECK(cudaFree(p));
  return bad;
}

int run() {
  const int n = kN, k = kK;
  // the entry's points: a centre each, plus integer offsets in [-4, 4]
  const float centers[4][2] = {{10, 10}, {40, 12}, {12, 44}, {44, 40}};
  std::vector<float> px(n), py(n);
  std::mt19937 gen(42);
  std::uniform_int_distribution<int> which(0, k - 1), off(-4, 4);
  for (int i = 0; i < n; ++i) {
    const int w = which(gen);
    px[i] = centers[w][0] + off(gen);
    py[i] = centers[w][1] + off(gen);
  }
  Dev b{};
  CHECK(cudaMalloc(&b.px, n * 4));
  CHECK(cudaMalloc(&b.py, n * 4));
  CHECK(cudaMalloc(&b.assign, n * 4));
  CHECK(cudaMalloc(&b.cx, k * 4));
  CHECK(cudaMalloc(&b.cy, k * 4));
  CHECK(cudaMalloc(&b.sumx, k * 4));
  CHECK(cudaMalloc(&b.sumy, k * 4));
  CHECK(cudaMalloc(&b.count, k * 4));
  CHECK(cudaMalloc(&b.changed, 4));
  CHECK(cudaMemcpy(b.px, px.data(), n * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(b.py, py.data(), n * 4, cudaMemcpyHostToDevice));
  cudaStream_t s;
  CHECK(cudaStreamCreateWithFlags(&s, cudaStreamNonBlocking));

  const int ctas = update_ctas_of(k), threads = update_threads_of(k);
  auto at_width = [](int w, bool pdl) -> Update {
    return [=](cudaStream_t st, const Dev& x, int kk) {
      launch_ex(kmeans_update_kernel, (kk + 32 * w - 1) / (32 * w), 32 * w,
                pdl, st, (const float*)x.sumx, (const float*)x.sumy,
                (const int*)x.count, x.cx, x.cy, kk);
    };
  };
  std::vector<Variant> vs = {
      {"old",
       [](cudaStream_t st, const Dev& x, int kk) {
         old_kmeans_update<<<kk, 8, 0, st>>>(x.sumx, x.sumy, x.count, x.cx,
                                             x.cy, kk);
       },
       true},
      {"new",
       [](cudaStream_t st, const Dev& x, int kk) {
         launch_ex(kmeans_update_kernel, update_ctas_of(kk),
                   update_threads_of(kk), false, st, (const float*)x.sumx,
                   (const float*)x.sumy, (const int*)x.count, x.cx, x.cy,
                   kk);
       },
       true},
      {"kernel",
       [](cudaStream_t st, const Dev& x, int kk) {
         CHECK((cudaError_t)launch_kmeans_update(x.sumx, x.sumy, x.count,
                                                 x.cx, x.cy, kk, 8, st));
       },
       true},
  };
  for (int w : {1, 2, 4, 8})
    vs.push_back({"W" + std::to_string(w), at_width(w, true), true});
  vs.push_back({"empty",
                [=](cudaStream_t st, const Dev&, int) {
                  launch_ex(empty, ctas, threads, false, st, 0);
                },
                false});
  vs.push_back({"empty_pdl",
                [=](cudaStream_t st, const Dev&, int) {
                  launch_ex(empty, ctas, threads, true, st, 0);
                },
                false});

  int bad = edge_check(vs, s);

  const Bufs ab{b.px, b.py, b.cx, b.cy, b.assign, b.changed, b.sumx,
                b.sumy, b.count};
  const int actas = (n + kThreads * kPoints - 1) / (kThreads * kPoints);
  auto assign = [&](bool trigger) {
    if (trigger)
      assign_regs<kK, true><<<actas, kThreads, 0, s>>>(ab, (long long)n);
    else
      assign_regs<kK, false><<<actas, kThreads, 0, s>>>(ab, (long long)n);
  };
  auto fills = [&] {
    fill_zero<<<1, 32, 0, s>>>(b.changed, 1);
    fill_zero<<<1, 32, 0, s>>>((int*)b.sumx, k);
    fill_zero<<<1, 32, 0, s>>>((int*)b.sumy, k);
    fill_zero<<<1, 32, 0, s>>>(b.count, k);
  };
  // the entry's first state: each centroid one of the first k points, no
  // point assigned yet, the sums zero
  auto reset = [&] {
    CHECK(cudaMemcpyAsync(b.cx, b.px, k * 4, cudaMemcpyDeviceToDevice, s));
    CHECK(cudaMemcpyAsync(b.cy, b.py, k * 4, cudaMemcpyDeviceToDevice, s));
    CHECK(cudaMemsetAsync(b.assign, 0, n * 4, s));
    fills();
  };
  auto state = [&] {
    CHECK(cudaStreamSynchronize(s));
    State r;
    r.cx = fetch(b.cx, k), r.cy = fetch(b.cy, k);
    r.sumx = fetch(b.sumx, k), r.sumy = fetch(b.sumy, k);
    r.assign = fetch(b.assign, n), r.changed = fetch(b.changed, 1);
    r.count = fetch(b.count, k);
    return r;
  };
  const int nv = (int)vs.size();
  std::vector<Run> runs(nv);
  std::vector<cudaGraphExec_t> graphs(2 * nv, nullptr);
  State want_one, want_chain;
  for (int turn = 0; turn < kTurns; ++turn) {
    for (int v = 0; v < nv; ++v) {
      const Variant& var = vs[v];
      auto chain = [&](bool trigger) {
        return [&, trigger] {
          for (int it = 0; it < kIters; ++it) {
            fills();
            assign(trigger);
            var.update(s, b, k);
          }
        };
      };
      auto graph_of = [&](bool trigger) {
        cudaGraphExec_t& g = graphs[2 * v + trigger];
        if (!g) {
          cudaGraph_t gr;
          CHECK(cudaStreamBeginCapture(s, cudaStreamCaptureModeThreadLocal));
          chain(trigger)();
          CHECK(cudaStreamEndCapture(s, &gr));
          CHECK(cudaGraphInstantiate(&g, gr, 0));
          CHECK(cudaGraphDestroy(gr));
        }
        return g;
      };
      // bits, turn 0: one update on the drawn sums; the chain streamed
      // and replayed, with and without the trigger
      if (turn == 0 && var.computes) {
        reset();
        assign(false);
        var.update(s, b, k);
        const State one = state();
        if (var.name == "old") want_one = one;
        if (!(one == want_one))
          ++bad, std::printf("MISMATCH %s: one update\n", var.name.c_str());
        for (bool trigger : {false, true}) {
          reset();
          chain(trigger)();
          const State streamed = state();
          if (var.name == "old" && !trigger) want_chain = streamed;
          if (!(streamed == want_chain))
            ++bad, std::printf("MISMATCH %s: chain streamed, trigger %d\n",
                               var.name.c_str(), (int)trigger);
          reset();
          CHECK(cudaGraphLaunch(graph_of(trigger), s));
          if (!(state() == want_chain))
            ++bad, std::printf("MISMATCH %s: chain replayed, trigger %d\n",
                               var.name.c_str(), (int)trigger);
        }
      }
      // ms and pace_us: update on the sums one assign leaves
      reset();
      assign(false);
      auto one = [&] { var.update(s, b, k); };
      std::vector<float> ts;
      for (int r = 0; r < kWarm + kRuns; ++r) {
        const float t = window(s, 1000000, [] {}, one);
        if (r >= kWarm) ts.push_back(t);
      }
      runs[v].ms.push_back(median(ts));
      auto pace = [&] {
        for (int i = 0; i < kPace; ++i) one();
      };
      double enq = enqueue_s(s, pace);
      runs[v].enqueue.push_back(enq / kPace * 1e6);
      long long cycles = (long long)(4 * enq * kMaxClockHz) + 1000000;
      ts.clear();
      for (int r = 0; r < kPaceRuns; ++r)
        ts.push_back(window(s, cycles, [] {}, pace) * 1e3f / kPace);
      runs[v].pace.push_back(median(ts));
      // chain_us and graph_us, without and with assign's trigger
      for (bool trigger : {false, true}) {
        const auto streamed = chain(trigger);
        enq = enqueue_s(s, streamed);
        cycles = (long long)(4 * enq * kMaxClockHz) + 1000000;
        ts.clear();
        for (int r = 0; r < kWarm + kRuns; ++r) {
          const float t = window(s, cycles, reset, streamed);
          if (r >= kWarm) ts.push_back(t * 1e3f / kIters);
        }
        (trigger ? runs[v].chain_trig : runs[v].chain).push_back(median(ts));
        cudaGraphExec_t g = graph_of(trigger);
        CHECK(cudaGraphUpload(g, s));
        ts.clear();
        for (int r = 0; r < kWarm + kRuns; ++r) {
          const float t = window(s, 1000000, reset,
                                 [&] { CHECK(cudaGraphLaunch(g, s)); });
          if (r >= kWarm) ts.push_back(t * 1e3f / kIters);
        }
        (trigger ? runs[v].graph_trig : runs[v].graph).push_back(median(ts));
      }
    }
  }
  std::printf("\nkmeans n = %d, k = %d: assign's %d CTAs of %d, update's "
              "%d CTA of %d; %d iterations; medians of %d turns\n",
              n, k, actas, kThreads, ctas, threads, kIters, kTurns);
  std::printf("  %-10s %10s %9s %11s %9s %9s %11s %11s\n", "variant", "ms",
              "pace_us", "enqueue_us", "chain_us", "graph_us", "chain_trig",
              "graph_trig");
  for (int v = 0; v < nv; ++v)
    std::printf("  %-10s %10.6f %9.4f %11.4f %9.4f %9.4f %11.4f %11.4f\n",
                vs[v].name.c_str(), median(runs[v].ms),
                median(runs[v].pace), median(runs[v].enqueue),
                median(runs[v].chain), median(runs[v].graph),
                median(runs[v].chain_trig), median(runs[v].graph_trig));
  for (int v = 0; v < nv; ++v) {
    std::printf("  %-10s turns pace_us", vs[v].name.c_str());
    for (float t : runs[v].pace) std::printf(" %.4f", t);
    std::printf(" chain_us");
    for (float t : runs[v].chain) std::printf(" %.4f", t);
    std::printf(" chain_trig");
    for (float t : runs[v].chain_trig) std::printf(" %.4f", t);
    std::printf(" graph_us");
    for (float t : runs[v].graph) std::printf(" %.4f", t);
    std::printf(" graph_trig");
    for (float t : runs[v].graph_trig) std::printf(" %.4f", t);
    std::printf("\n");
  }
  for (cudaGraphExec_t g : graphs)
    if (g) CHECK(cudaGraphExecDestroy(g));
  CHECK(cudaStreamDestroy(s));
  for (void* p : {(void*)b.px, (void*)b.py, (void*)b.assign, (void*)b.cx,
                  (void*)b.cy, (void*)b.sumx, (void*)b.sumy, (void*)b.count,
                  (void*)b.changed})
    CHECK(cudaFree(p));
  return bad;
}

}  // namespace variants

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("card: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const int bad = variants::run();
  std::printf("\nkmeans_update_variants: %s\n",
              bad ? "MISMATCH"
                  : "every variant equals the old kernel bit for bit, and "
                    "the reference's rule at negative counts");
  return bad ? 1 : 0;
}
