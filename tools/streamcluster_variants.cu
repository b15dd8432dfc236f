// Times src/repro_torch/csrc/streamcluster.cu at the main path's size
// (sc_gpu's 65,536 points, the chevron's 1,024 blocks of 64, k = 20), at
// k = 1,024 (the most centres in shared bins) and at k = 4,096 (the
// global atomics), beside the kernel it replaced and variants of its
// design, on one CUDA card, so that the choices its source note makes
// rest on a measurement:
//   old      the earlier kernel: one point a thread on the chevron's
//            grid, two global atomics (csave, dirty) a switcher, one
//            atomicAdd on gain a warp;
//   empty    an empty kernel of the shipped kernel's CTA count: the
//            launch and the timing's floor;
//   kernel   the shipped kernel through launch_streamcluster;
//   P<p>     the shipped design at p points a thread (CTAs of 256; P1 is
//            the one-point-a-thread variant, 256 CTAs at 65,536 points;
//            shared bins, so only up to STREAMCLUSTER_SHARED_K);
//   global   the shipped points a thread with the old kernel's direct
//            global atomics on csave and dirty (the path for k past
//            STREAMCLUSTER_SHARED_K).
// The inputs are the entry's draw (coordinates in [0, 100), assign in
// [0, k)).  Every variant must equal the old kernel bit for bit in gain,
// csave, dirty, ndirty and switched.  The written buffers are zeroed
// before each run, outside the timed window.  Each line gives the median
// of 25 CUDA-event runs after 5 warm-ups, a spin on the card covering the
// enqueue; five turns, then each variant's median of its turns.  Build and
// run from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/streamcluster_variants tools/streamcluster_variants.cu \
//     && build/streamcluster_variants
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <utility>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/streamcluster.cu"

namespace variants {

constexpr int kTurns = 5, kRuns = 25, kWarm = 5;
constexpr int kN = 65536, kOldBlock = 64;

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
__global__ void old_streamcluster(
    const int* __restrict__ px, const int* __restrict__ py,
    const int* __restrict__ cx, const int* __restrict__ cy,
    const int* __restrict__ cand, const int* __restrict__ assign, int* gain,
    int* csave, int* dirty, int* ndirty, int* switched, int n, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int save = 0;
  if (i < n) {
    const int a = assign[i];
    int c = a < 0 ? a + k : a;
    c = min(max(c, 0), k - 1);
    const int x = px[i], y = py[i];
    const int dcur = (x - cx[c]) * (x - cx[c]) + (y - cy[c]) * (y - cy[c]);
    const int dcand = (x - cand[0]) * (x - cand[0])
                      + (y - cand[1]) * (y - cand[1]);
    if (dcand < dcur) {
      save = dcur - dcand;
      switched[i] = 1;
      if (a >= 0 && a < k) {
        atomicAdd(&csave[a], save);
        if (atomicCAS(&dirty[a], 0, 1) == 0) atomicAdd(ndirty, 1);
      }
    }
  }
  const int warp_sum = __reduce_add_sync(0xffffffffu, save);
  if ((threadIdx.x & 31) == 0 && warp_sum != 0) atomicAdd(gain, warp_sum);
}

__global__ void empty() {}

__global__ void spin(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

float median(std::vector<float> v) {
  std::sort(v.begin(), v.end());
  return v[v.size() / 2];
}

float time_ms(const std::function<void()>& f,
              const std::function<void()>& before) {
  cudaEvent_t e0, e1;
  CHECK(cudaEventCreate(&e0));
  CHECK(cudaEventCreate(&e1));
  std::vector<float> ts;
  for (int i = 0; i < kWarm + kRuns; ++i) {
    before();
    spin<<<1, 1>>>(200000);
    CHECK(cudaEventRecord(e0));
    f();
    CHECK(cudaEventRecord(e1));
    CHECK(cudaEventSynchronize(e1));
    float ms;
    CHECK(cudaEventElapsedTime(&ms, e0, e1));
    if (i >= kWarm) ts.push_back(ms);
  }
  CHECK(cudaGetLastError());
  CHECK(cudaEventDestroy(e0));
  CHECK(cudaEventDestroy(e1));
  return median(ts);
}

// The written buffers after a launch.
struct Out {
  std::vector<int> csave, dirty, switched;
  int gain = 0, ndirty = 0;
  bool operator==(const Out& o) const {
    return gain == o.gain && ndirty == o.ndirty && csave == o.csave &&
           dirty == o.dirty && switched == o.switched;
  }
};

using Fn = std::function<void(const Bufs&)>;

template <int P, bool SHARED>
std::pair<std::string, Fn> design_at(int k) {
  char name[32];
  if (SHARED)
    std::snprintf(name, sizeof name, "P%d", P);
  else
    std::snprintf(name, sizeof name, "global");
  return {name, [k](const Bufs& b) {
            const int ctas = (kN + kThreads * P - 1) / (kThreads * P);
            streamcluster_points<P, SHARED>
                <<<ctas, kThreads, SHARED ? 2 * k * sizeof(int) : 0>>>(
                    b, kN, k);
          }};
}

int run(int k) {
  std::vector<int> host(5 * kN + 2 * k + 2);
  int* px = host.data();
  int* py = px + kN;
  int* assign = py + kN;
  int* cx = assign + kN;
  int* cy = cx + k;
  int* cand = cy + k;
  srand(42);
  for (int i = 0; i < kN; ++i)
    px[i] = rand() % 100, py[i] = rand() % 100, assign[i] = rand() % k;
  for (int c = 0; c < k; ++c) cx[c] = rand() % 100, cy[c] = rand() % 100;
  cand[0] = rand() % 100, cand[1] = rand() % 100;
  int *d_in, *gain, *csave, *dirty, *ndirty, *switched;
  const size_t in_ints = 3 * (size_t)kN + 2 * k + 2;
  CHECK(cudaMalloc(&d_in, in_ints * 4));
  CHECK(cudaMalloc(&gain, 4));
  CHECK(cudaMalloc(&ndirty, 4));
  CHECK(cudaMalloc(&csave, k * 4));
  CHECK(cudaMalloc(&dirty, k * 4));
  CHECK(cudaMalloc(&switched, kN * 4));
  CHECK(cudaMemcpy(d_in, px, in_ints * 4, cudaMemcpyHostToDevice));
  const Bufs b{d_in, d_in + kN, d_in + 3 * kN, d_in + 3 * kN + k,
               d_in + 3 * kN + 2 * k, d_in + 2 * kN, gain, csave, dirty,
               ndirty, switched};
  auto restore = [&] {
    CHECK(cudaMemsetAsync(gain, 0, 4));
    CHECK(cudaMemsetAsync(ndirty, 0, 4));
    CHECK(cudaMemsetAsync(csave, 0, k * 4));
    CHECK(cudaMemsetAsync(dirty, 0, k * 4));
    CHECK(cudaMemsetAsync(switched, 0, kN * 4));
  };
  auto fetch = [&] {
    Out o;
    o.csave.resize(k);
    o.dirty.resize(k);
    o.switched.resize(kN);
    CHECK(cudaMemcpy(&o.gain, gain, 4, cudaMemcpyDeviceToHost));
    CHECK(cudaMemcpy(&o.ndirty, ndirty, 4, cudaMemcpyDeviceToHost));
    CHECK(cudaMemcpy(o.csave.data(), csave, k * 4, cudaMemcpyDeviceToHost));
    CHECK(cudaMemcpy(o.dirty.data(), dirty, k * 4, cudaMemcpyDeviceToHost));
    CHECK(cudaMemcpy(o.switched.data(), switched, kN * 4,
                     cudaMemcpyDeviceToHost));
    return o;
  };
  const int old_grid = kN / kOldBlock;
  const int ctas = (kN + streamcluster_cta_points() - 1) /
                   streamcluster_cta_points();
  std::vector<std::pair<std::string, Fn>> vs = {
      {"old",
       [=](const Bufs& b) {
         old_streamcluster<<<old_grid, kOldBlock>>>(
             b.px, b.py, b.cx, b.cy, b.cand, b.assign, b.gain, b.csave,
             b.dirty, b.ndirty, b.switched, kN, k);
       }},
      {"empty", [=](const Bufs&) { empty<<<ctas, kThreads>>>(); }},
      {"kernel",
       [=](const Bufs& b) {
         CHECK((cudaError_t)launch_streamcluster(
             b.px, b.py, b.cx, b.cy, b.cand, b.assign, b.gain, b.csave,
             b.dirty, b.ndirty, b.switched, kN, k, old_grid, kOldBlock,
             ctas, nullptr));
       }},
      design_at<kPoints, false>(k),
  };
  if (k <= STREAMCLUSTER_SHARED_K)      // the shared bins hold k centres
    for (auto v : {design_at<1, true>(k), design_at<2, true>(k),
                   design_at<4, true>(k), design_at<8, true>(k)})
      vs.push_back(v);
  const int nv = (int)vs.size();
  int bad = 0;
  Out want;
  std::vector<std::vector<float>> ts(nv);
  for (int turn = 0; turn < kTurns; ++turn) {
    for (int v = 0; v < nv; ++v) {
      const std::string& name = vs[v].first;
      restore();
      vs[v].second(b);
      CHECK(cudaDeviceSynchronize());
      if (turn == 0 && name == "old") want = fetch();
      if (turn == 0 && name != "empty" && !(fetch() == want))
        ++bad, std::printf("MISMATCH k=%d %s\n", k, name.c_str());
      ts[v].push_back(time_ms([&] { vs[v].second(b); }, restore));
    }
  }
  int switchers = 0;
  for (int s : want.switched) switchers += s;
  const double bytes = 4.0 * (3.0 * kN + 2 * k + 2 + switchers + 2 + 2 * k);
  std::printf("\n%d points, k = %d, %d switchers, ndirty %d (kernel: %d "
              "CTAs; bound %.6f ms at 3.35 TB/s)\n",
              kN, k, switchers, want.ndirty, ctas, bytes / 3.35e12 * 1e3);
  for (int v = 0; v < nv; ++v)
    std::printf("  %-8s %9.6f ms\n", vs[v].first.c_str(), median(ts[v]));
  for (void* p : {(void*)d_in, (void*)gain, (void*)csave, (void*)dirty,
                  (void*)ndirty, (void*)switched})
    CHECK(cudaFree(p));
  return bad;
}

}  // namespace variants

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("card: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const int bad = variants::run(20) + variants::run(STREAMCLUSTER_SHARED_K) +
                  variants::run(4096);
  std::printf("\nstreamcluster_variants: %s\n",
              bad ? "MISMATCH"
                  : "every variant equals the old kernel bit for bit");
  return bad ? 1 : 0;
}
