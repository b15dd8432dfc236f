// Times the assign kernel of src/repro_torch/csrc/kmeans.cu at the main
// path's size (kmeans -o -i kdd_cup: 494,080 2-D points, the chevron's
// 7,720 blocks of 64) with k = 4, and with k = 32 (the shared-bin path),
// beside the kernel it replaced and variants of its design, on one CUDA
// card, so that the choices its source note makes rest on a measurement:
//   old          the earlier kernel: a CTA of 64 threads a logical block,
//                one point a thread, a shuffle tree per cluster, one
//                __shared__ atomic per warp and cluster, then one global
//                atomicAdd per CTA and bin;
//   old partials the same, its global atomics replaced by stores of each
//                CTA's partials to scratch: what the block starts cost
//                without the contended atomics;
//   empty        an empty kernel of the shipped kernel's CTA count: the
//                launch and the timing's floor;
//   kernel       the shipped kernel through launch_kmeans_assign (CTAs of
//                256 threads, 4 points a thread, partials in registers);
//   T<t> P<p>    the design written again with CTAs of t threads and p
//                points a thread (T256 P4 is the shipped shape);
//   bins         the shipped shared-bin kernel (the path for k > 8) at
//                k = 4, beside registers.
// The inputs are the entry's: integer-valued coordinates around four
// centres, the first k points as centroids, assign all 0.  Every variant
// must equal the host's answer bit for bit (assign, the moved count, the
// sums and the counts: integer-valued sums are exact in any order), the
// old partials once the host adds them.  The written buffers are restored
// before each run, outside the timed window.  Each line gives the median
// of 25 CUDA-event runs after 5 warm-ups, a spin on the card covering the
// enqueue; five turns, then each variant's median of its turns.  Build and
// run from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/kmeans_assign_variants tools/kmeans_assign_variants.cu \
//     && build/kmeans_assign_variants
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <utility>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/kmeans.cu"

namespace variants {

constexpr int kTurns = 5, kRuns = 25, kWarm = 5;
constexpr int kN = 494080, kOldBlock = 64;

#define CHECK(x)                                                        \
  do {                                                                  \
    cudaError_t e_ = (x);                                               \
    if (e_ != cudaSuccess) {                                            \
      std::fprintf(stderr, "%s:%d %s\n", __FILE__, __LINE__,            \
                   cudaGetErrorString(e_));                             \
      std::exit(1);                                                     \
    }                                                                   \
  } while (0)

// the kernel this redesign replaced, as it was; PARTIALS stores each
// CTA's bins and moved count to part[blockIdx.x][3 k + 1] instead
template <bool PARTIALS>
__global__ void old_assign(const float* __restrict__ px,
                           const float* __restrict__ py,
                           const float* __restrict__ cx,
                           const float* __restrict__ cy, int* assign,
                           int* changed, float* sumx, float* sumy,
                           int* count, int n, int k, float* part) {
  __shared__ float bx[KMEANS_MAX_K], by[KMEANS_MAX_K];
  __shared__ int bn[KMEANS_MAX_K];
  const int t = threadIdx.x;
  for (int c = t; c < k; c += blockDim.x) {
    bx[c] = 0.0f;
    by[c] = 0.0f;
    bn[c] = 0;
  }
  const long long i = (long long)blockIdx.x * blockDim.x + t;
  const bool valid = i < n;
  const int g = valid ? (int)i : n - 1;
  const float x = px[g], y = py[g];
  int best = 0;
  float bestd = dist2(x, y, cx[0], cy[0]);
  for (int c = 1; c < k; ++c) {
    const float d = dist2(x, y, cx[c], cy[c]);
    if (d < bestd) {
      best = c;
      bestd = d;
    }
  }
  const int moved = valid && assign[g] != best;
  if (valid) assign[i] = best;
  __syncthreads();
  const bool lead = (t & 31) == 0;
  for (int c = 0; c < k; ++c) {
    const bool mine = valid && best == c;
    const int wn = __reduce_add_sync(0xffffffffu, mine ? 1 : 0);
    const float wx = warp_sum(mine ? x : 0.0f);
    const float wy = warp_sum(mine ? y : 0.0f);
    if (lead && wn) {
      atomicAdd(&bx[c], wx);
      atomicAdd(&by[c], wy);
      atomicAdd(&bn[c], wn);
    }
  }
  const int nmoved = __syncthreads_count(moved);
  float* mine = part + (size_t)blockIdx.x * (3 * k + 1);
  for (int c = t; c < k; c += blockDim.x) {
    if (PARTIALS) {
      mine[c] = bx[c], mine[k + c] = by[c], mine[2 * k + c] = (float)bn[c];
    } else if (bn[c]) {
      atomicAdd(&sumx[c], bx[c]);
      atomicAdd(&sumy[c], by[c]);
      atomicAdd(&count[c], bn[c]);
    }
  }
  if (t == 0) {
    if (PARTIALS)
      mine[3 * k] = (float)nmoved;
    else if (nmoved)
      atomicAdd(changed, nmoved);
  }
}

// the shipped register design with T threads a CTA and P points a thread
template <int K, int T, int P>
__global__ void __launch_bounds__(T) design(Bufs b, long long m) {
  constexpr int W = T / 32;
  __shared__ float wx[W][K], wy[W][K];
  __shared__ int wn[W][K], wm[W];
  float ccx[K], ccy[K], sx[K], sy[K];
  int sn[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    ccx[c] = b.cx[c], ccy[c] = b.cy[c];
    sx[c] = 0.0f, sy[c] = 0.0f, sn[c] = 0;
  }
  const long long first = (long long)blockIdx.x * T * P + threadIdx.x;
  float x[P], y[P];
  int old[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const long long i = first + (long long)j * T;
    if (i < m) x[j] = b.px[i], y[j] = b.py[i], old[j] = b.assign[i];
  }
  int moved = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const long long i = first + (long long)j * T;
    if (i >= m) continue;
    int best = 0;
    float bestd = dist2(x[j], y[j], ccx[0], ccy[0]);
#pragma unroll
    for (int c = 1; c < K; ++c) {
      const float d = dist2(x[j], y[j], ccx[c], ccy[c]);
      if (d < bestd) {
        best = c;
        bestd = d;
      }
    }
    moved += old[j] != best;
    b.assign[i] = best;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const bool mine = best == c;
      sx[c] += mine ? x[j] : 0.0f;
      sy[c] += mine ? y[j] : 0.0f;
      sn[c] += mine;
    }
  }
  const int t = threadIdx.x, warp = t >> 5;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float ax = warp_sum(sx[c]), ay = warp_sum(sy[c]);
    const int an = warp_sum(sn[c]);
    if ((t & 31) == 0) wx[warp][c] = ax, wy[warp][c] = ay, wn[warp][c] = an;
  }
  moved = warp_sum(moved);
  if ((t & 31) == 0) wm[warp] = moved;
  __syncthreads();
  if (t < K) {
    float sx1 = 0.0f, sy1 = 0.0f;
    int n = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) sx1 += wx[w][t], sy1 += wy[w][t], n += wn[w][t];
    if (n) {
      atomicAdd(&b.sumx[t], sx1);
      atomicAdd(&b.sumy[t], sy1);
      atomicAdd(&b.count[t], n);
    }
  }
  if (t == T - 1) {
    int n = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) n += wm[w];
    if (n) atomicAdd(b.changed, n);
  }
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

// The host's answer: assign, the moved count, sums and counts.
struct Answer {
  std::vector<int> assign, count;
  std::vector<float> sumx, sumy;
  int changed = 0;
};

Answer host_answer(const std::vector<float>& px, const std::vector<float>& py,
                   int k) {
  Answer a;
  a.assign.resize(px.size());
  a.count.assign(k, 0);
  std::vector<double> sx(k, 0.0), sy(k, 0.0);
  for (size_t i = 0; i < px.size(); ++i) {
    int best = 0;
    float bestd = 0.0f;
    for (int c = 0; c < k; ++c) {
      const float dx = px[i] - px[c], dy = py[i] - py[c];
      const float dxx = dx * dx, dyy = dy * dy;
      const float d = dxx + dyy;
      if (c == 0 || d < bestd) best = c, bestd = d;
    }
    a.assign[i] = best;
    a.changed += best != 0;
    sx[best] += px[i], sy[best] += py[i], ++a.count[best];
  }
  for (int c = 0; c < k; ++c)
    a.sumx.push_back((float)sx[c]), a.sumy.push_back((float)sy[c]);
  return a;
}

template <typename T>
bool same(const std::vector<T>& a, const std::vector<T>& b) {
  return a.size() == b.size() &&
         std::memcmp(a.data(), b.data(), a.size() * sizeof(T)) == 0;
}

using Fn = std::function<void(const Bufs&)>;

template <int K, int T, int P>
std::pair<std::string, Fn> design_at() {
  char name[32];
  std::snprintf(name, sizeof name, "T%d P%d", T, P);
  return {name, [](const Bufs& b) {
            const int ctas = (kN + T * P - 1) / (T * P);
            design<K, T, P><<<ctas, T>>>(b, kN);
          }};
}

int run(int k) {
  std::vector<float> px(kN), py(kN);
  const float centres[4][2] = {{10, 10}, {40, 12}, {12, 44}, {44, 40}};
  srand(42);
  for (int i = 0; i < kN; ++i) {
    const int w = rand() % 4;
    px[i] = centres[w][0] + (float)(rand() % 9 - 4);
    py[i] = centres[w][1] + (float)(rand() % 9 - 4);
  }
  const Answer want = host_answer(px, py, k);
  const int old_grid = kN / kOldBlock;
  float *dpx, *dpy, *dcx, *dcy, *sumx, *sumy, *part;
  int *assign, *changed, *count;
  CHECK(cudaMalloc(&dpx, kN * 4));
  CHECK(cudaMalloc(&dpy, kN * 4));
  CHECK(cudaMalloc(&assign, kN * 4));
  CHECK(cudaMalloc(&dcx, k * 4));
  CHECK(cudaMalloc(&dcy, k * 4));
  CHECK(cudaMalloc(&sumx, k * 4));
  CHECK(cudaMalloc(&sumy, k * 4));
  CHECK(cudaMalloc(&count, k * 4));
  CHECK(cudaMalloc(&changed, 4));
  CHECK(cudaMalloc(&part, (size_t)old_grid * (3 * k + 1) * 4));
  CHECK(cudaMemcpy(dpx, px.data(), kN * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(dpy, py.data(), kN * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(dcx, px.data(), k * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(dcy, py.data(), k * 4, cudaMemcpyHostToDevice));
  const Bufs b{dpx, dpy, dcx, dcy, assign, changed, sumx, sumy, count};
  auto restore = [&] {
    CHECK(cudaMemsetAsync(assign, 0, kN * 4));
    CHECK(cudaMemsetAsync(sumx, 0, k * 4));
    CHECK(cudaMemsetAsync(sumy, 0, k * 4));
    CHECK(cudaMemsetAsync(count, 0, k * 4));
    CHECK(cudaMemsetAsync(changed, 0, 4));
  };
  const int ctas = (kN + kmeans_assign_cta_points() - 1) /
                   kmeans_assign_cta_points();
  std::vector<std::pair<std::string, Fn>> vs = {
      {"old",
       [=](const Bufs& b) {
         old_assign<false><<<old_grid, kOldBlock>>>(
             b.px, b.py, b.cx, b.cy, b.assign, b.changed, b.sumx, b.sumy,
             b.count, kN, k, part);
       }},
      {"old partials",
       [=](const Bufs& b) {
         old_assign<true><<<old_grid, kOldBlock>>>(
             b.px, b.py, b.cx, b.cy, b.assign, b.changed, b.sumx, b.sumy,
             b.count, kN, k, part);
       }},
      {"empty", [=](const Bufs&) { empty<<<ctas, 256>>>(); }},
      {"kernel",
       [=](const Bufs& b) {
         CHECK((cudaError_t)launch_kmeans_assign(
             b.px, b.py, b.cx, b.cy, b.assign, b.changed, b.sumx, b.sumy,
             b.count, kN, k, old_grid, kOldBlock, ctas, nullptr));
       }},
  };
  if (k == 4) {
    for (auto v : {design_at<4, 128, 4>(), design_at<4, 128, 8>(),
                   design_at<4, 128, 16>(), design_at<4, 256, 4>(),
                   design_at<4, 256, 8>(), design_at<4, 256, 16>(),
                   design_at<4, 512, 4>(), design_at<4, 512, 8>(),
                   design_at<4, 512, 16>()})
      vs.push_back(v);
    vs.push_back({"bins", [=](const Bufs& b) {
                    assign_bins<<<ctas, 256>>>(b, kN, 4);
                  }});
  }
  const int nv = (int)vs.size();
  int bad = 0;
  std::vector<std::vector<float>> ts(nv);
  for (int turn = 0; turn < kTurns; ++turn) {
    for (int v = 0; v < nv; ++v) {
      const std::string& name = vs[v].first;
      restore();
      vs[v].second(b);
      CHECK(cudaDeviceSynchronize());
      if (turn == 0 && name != "empty") {
        Answer got;
        got.assign.resize(kN);
        got.count.resize(k);
        got.sumx.resize(k);
        got.sumy.resize(k);
        CHECK(cudaMemcpy(got.assign.data(), assign, kN * 4,
                         cudaMemcpyDeviceToHost));
        if (name == "old partials") {
          std::vector<float> p((size_t)old_grid * (3 * k + 1));
          CHECK(cudaMemcpy(p.data(), part, p.size() * 4,
                           cudaMemcpyDeviceToHost));
          std::vector<double> s(3 * k + 1, 0.0);
          for (int g = 0; g < old_grid; ++g)
            for (int e = 0; e < 3 * k + 1; ++e)
              s[e] += p[(size_t)g * (3 * k + 1) + e];
          for (int c = 0; c < k; ++c) {
            got.sumx[c] = (float)s[c];
            got.sumy[c] = (float)s[k + c];
            got.count[c] = (int)s[2 * k + c];
          }
          got.changed = (int)s[3 * k];
        } else {
          CHECK(cudaMemcpy(got.count.data(), count, k * 4,
                           cudaMemcpyDeviceToHost));
          CHECK(cudaMemcpy(got.sumx.data(), sumx, k * 4,
                           cudaMemcpyDeviceToHost));
          CHECK(cudaMemcpy(got.sumy.data(), sumy, k * 4,
                           cudaMemcpyDeviceToHost));
          CHECK(cudaMemcpy(&got.changed, changed, 4, cudaMemcpyDeviceToHost));
        }
        if (!same(got.assign, want.assign) || !same(got.count, want.count) ||
            !same(got.sumx, want.sumx) || !same(got.sumy, want.sumy) ||
            got.changed != want.changed)
          ++bad, std::printf("MISMATCH k=%d %s\n", k, name.c_str());
      }
      ts[v].push_back(time_ms([&] { vs[v].second(b); }, restore));
    }
  }
  std::printf("\n%d points, k = %d (kernel: %d CTAs; bound %.6f ms at "
              "3.35 TB/s)\n",
              kN, k, ctas, 4.0 * (4.0 * kN + 8 * k + 2) / 3.35e12 * 1e3);
  for (int v = 0; v < nv; ++v)
    std::printf("  %-14s %9.6f ms\n", vs[v].first.c_str(), median(ts[v]));
  for (void* p : {(void*)dpx, (void*)dpy, (void*)dcx, (void*)dcy,
                  (void*)sumx, (void*)sumy, (void*)part, (void*)assign,
                  (void*)changed, (void*)count})
    CHECK(cudaFree(p));
  return bad;
}

}  // namespace variants

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("card: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const int bad = variants::run(4) + variants::run(32);
  std::printf("\nkmeans_assign_variants: %s\n",
              bad ? "MISMATCH"
                  : "every variant equals the host's answer bit for bit");
  return bad ? 1 : 0;
}
