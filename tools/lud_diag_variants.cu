// Times src/repro_torch/csrc/lud_diag.cu at the main path's size (lud on
// 2048.dat: 128 diagonal tiles of 16 x 16, the chevron's 128 blocks of 16)
// and at b = 32 (64 tiles of 32, one tile a warp), beside the kernel it
// replaced and variants of its design, on one CUDA card, so that the
// choices its source note makes rest on a measurement:
//   old      the earlier kernel: one thread a row of a __shared__ tile,
//            a __syncthreads() a step, only the columns c > k updated;
//   empty    an empty kernel of the shipped kernel's CTAs: the launch and
//            the timing's floor;
//   copy     the shipped mapping's load and store with no steps;
//   kernel   the shipped kernel through launch_lud_diag;
//   T<t>W<w> the shipped design at t tiles a warp (32 / P or 1) and w
//            warps a CTA (T2W1 at b = 16 is the shipped mapping);
//   first    the design's first text: the steps kept to k < b - 1 and the
//            columns to c < b by guards on the runtime b, the rows below
//            the pivot updated inside a branch;
//   guard    those guards, with the shipped select;
//   branch   the shipped unguarded steps, with the branch;
//   scalar   the shipped kernel's one-float loads and stores (its path for
//            b % 4 != 0 or a buffer off 16 bytes) on the same buffers.
// The last four run the shipped mapping.
// The inputs are the entry's draw (0.1 x a normal draw plus 4 on each
// tile's diagonal, so every pivot is finite and far from 0).  Every
// variant but empty and copy must equal the old kernel bit for bit; copy
// must equal the input.  lu is zeroed before each run, outside the timed
// window.  Each line gives the median of 25 CUDA-event runs after 5
// warm-ups, a spin on the card covering the enqueue; five turns, then each
// variant's median of its turns.  -Xptxas -v prints every instantiation's
// registers and spills (lud_diag_warp<32, true> at b = 32), and
// cuobjdump -sass build/lud_diag_variants its code.  Build and run
// from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/lud_diag_variants tools/lud_diag_variants.cu \
//     && build/lud_diag_variants
#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <random>
#include <string>
#include <utility>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/lud_diag.cu"

namespace variants {

constexpr int kTurns = 5, kRuns = 25, kWarm = 5;
constexpr int kRowsAll = 2048;             // 2048.dat

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
__global__ void old_lud_diag(const float* __restrict__ a, float* lu, int b) {
  __shared__ float s[LUD_MAX_B][LUD_MAX_B + 1];
  const int i = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * b * b;
  for (int e = i; e < b * b; e += b) s[e / b][e % b] = a[base + e];
  __syncthreads();
  for (int k = 0; k < b - 1; ++k) {
    if (i > k) {
      const float m = s[i][k] / s[k][k];
      for (int c = k + 1; c < b; ++c)
        s[i][c] = __fsub_rn(s[i][c], __fmul_rn(m, s[k][c]));
      s[i][k] = m;
    }
    __syncthreads();
  }
  for (int e = i; e < b * b; e += b) lu[base + e] = s[e / b][e % b];
}

// the shipped mapping's load and store, no steps (b % 4 == 0, float4s)
__global__ void copy_rows(const float* __restrict__ a, float* __restrict__ lu,
                          int b, int tiles, int lanes, int per_warp) {
  const int lane = threadIdx.x & 31;
  const int seg = lane / lanes, i = lane % lanes;
  const long long t =
      ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) *
          per_warp + seg;
  if (seg >= per_warp || t >= tiles || i >= b) return;
  const size_t row = ((size_t)t * b + i) * b;
  for (int c = 0; c < b; c += 4)
    *reinterpret_cast<float4*>(lu + row + c) =
        *reinterpret_cast<const float4*>(a + row + c);
}

// the shipped design's text with two knobs: GUARD keeps the steps to
// k < b - 1 and the columns to c < b by runtime guards on b (the design's
// first text, with BRANCH); BRANCH updates only the rows below the pivot
// inside a branch, in place of the shipped select
template <int MB, bool GUARD, bool BRANCH>
__global__ void __launch_bounds__(256)
    lud_knobs(const float* __restrict__ a, float* __restrict__ lu, int b,
              int tiles, int lanes, int per_warp) {
  const int lane = threadIdx.x & 31;
  const int seg = lane / lanes, i = lane % lanes;
  const long long t =
      ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) *
          per_warp + seg;
  const bool live = seg < per_warp && t < tiles && i < b;
  const size_t row = ((size_t)t * b + i) * b;
  float r[MB];
#pragma unroll
  for (int c = 0; c < MB; ++c) r[c] = 1.0f;
  if (live) {
#pragma unroll
    for (int c = 0; c < MB; c += 4)
      if (c < b) {
        const float4 v = *reinterpret_cast<const float4*>(a + row + c);
        r[c] = v.x, r[c + 1] = v.y, r[c + 2] = v.z, r[c + 3] = v.w;
      }
  }
#pragma unroll
  for (int k = 0; k < MB - 1; ++k) {
    if (GUARD && k >= b - 1) break;
    const float piv = __shfl_sync(kFull, r[k], k, lanes);
    float u[MB];
#pragma unroll
    for (int c = k + 1; c < MB; ++c)
      if (!GUARD || c < b) u[c] = __shfl_sync(kFull, r[c], k, lanes);
    const bool below = live && i > k;
    if (!BRANCH) {
      const float m = __fdiv_rn(r[k], piv);
      const float z = __fmul_rn(m, 0.0f);
#pragma unroll
      for (int c = k + 1; c < MB; ++c)
        if (!GUARD || c < b) {
          const float v = __fsub_rn(r[c], __fmul_rn(m, u[c]));
          r[c] = below ? v : r[c];
        }
#pragma unroll
      for (int c = 0; c < k; ++c) {
        const float v = __fsub_rn(r[c], z);
        r[c] = below ? v : r[c];
      }
      r[k] = below ? m : r[k];
    } else if (below) {
      const float m = __fdiv_rn(r[k], piv);
      const float z = __fmul_rn(m, 0.0f);
#pragma unroll
      for (int c = 0; c < k; ++c) r[c] = __fsub_rn(r[c], z);
#pragma unroll
      for (int c = k + 1; c < MB; ++c)
        if (!GUARD || c < b) r[c] = __fsub_rn(r[c], __fmul_rn(m, u[c]));
      r[k] = m;
    }
  }
  if (live) {
#pragma unroll
    for (int c = 0; c < MB; c += 4)
      if (c < b)
        *reinterpret_cast<float4*>(lu + row + c) =
            make_float4(r[c], r[c + 1], r[c + 2], r[c + 3]);
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

using Fn = std::function<void(const float*, float*)>;

int run(int b) {
  const int tiles = kRowsAll / b, n = tiles * b * b;
  const int lanes = tile_lanes(b);
  std::vector<float> host(n);
  std::mt19937 gen(42);
  std::normal_distribution<float> normal;
  for (int e = 0; e < n; ++e) {
    host[e] = 0.1f * normal(gen);
    if ((e / b) % b == e % b) host[e] += 4.0f;   // a tile's diagonal
  }
  float *a, *lu;
  CHECK(cudaMalloc(&a, n * 4));
  CHECK(cudaMalloc(&lu, n * 4));
  CHECK(cudaMemcpy(a, host.data(), n * 4, cudaMemcpyHostToDevice));
  auto restore = [&] { CHECK(cudaMemsetAsync(lu, 0, n * 4)); };
  auto fetch = [&] {
    std::vector<float> o(n);
    CHECK(cudaMemcpy(o.data(), lu, n * 4, cudaMemcpyDeviceToHost));
    return o;
  };
  const int ctas = (tiles + lud_diag_cta_tiles(b) - 1) / lud_diag_cta_tiles(b);
  std::vector<std::pair<std::string, Fn>> vs = {
      {"old",
       [=](const float* a, float* lu) {
         old_lud_diag<<<tiles, b>>>(a, lu, b);
       }},
      {"empty", [=](const float*, float*) { empty<<<ctas, 32 * kWarps>>>(); }},
      {"copy",
       [=](const float* a, float* lu) {
         copy_rows<<<ctas, 32 * kWarps>>>(a, lu, b, tiles, lanes,
                                          32 / lanes);
       }},
      {"kernel",
       [=](const float* a, float* lu) {
         CHECK((cudaError_t)launch_lud_diag(a, lu, b, tiles, ctas, nullptr));
       }},
  };
  std::vector<int> packs = {32 / lanes};
  if (lanes < 32) packs.push_back(1);    // at b > 16 one tile a warp only
  for (int per_warp : packs)
    for (int warps : {1, 4, 8}) {
      char name[32];
      std::snprintf(name, sizeof name, "T%dW%d", per_warp, warps);
      const int per_cta = per_warp * warps;
      const int c = (tiles + per_cta - 1) / per_cta;
      vs.push_back({name, [=](const float* a, float* lu) {
                      start(a, lu, b, tiles, c, warps, per_warp, nullptr);
                    }});
    }
  auto knobs = [&](const char* label, auto kern) {
    const int per_warp = 32 / lanes, c = (tiles + per_warp - 1) / per_warp;
    vs.push_back({label, [=](const float* a, float* lu) {
                    kern<<<c, 32>>>(a, lu, b, tiles, lanes, per_warp);
                  }});
  };
  if (b == 16) {
    knobs("first", lud_knobs<16, true, true>);
    knobs("guard", lud_knobs<16, true, false>);
    knobs("branch", lud_knobs<16, false, true>);
    knobs("scalar", lud_diag_warp<16, false>);
  } else {
    knobs("first", lud_knobs<32, true, true>);
    knobs("guard", lud_knobs<32, true, false>);
    knobs("branch", lud_knobs<32, false, true>);
    knobs("scalar", lud_diag_warp<32, false>);
  }
  const int nv = (int)vs.size();
  int bad = 0;
  std::vector<float> want;
  std::vector<std::vector<float>> ts(nv);
  for (int turn = 0; turn < kTurns; ++turn) {
    for (int v = 0; v < nv; ++v) {
      const std::string& name = vs[v].first;
      restore();
      vs[v].second(a, lu);
      CHECK(cudaDeviceSynchronize());
      if (turn == 0 && name == "old") want = fetch();
      if (turn == 0 && name != "empty") {
        const std::vector<float> got = fetch();
        const std::vector<float>& ref = name == "copy" ? host : want;
        if (std::memcmp(got.data(), ref.data(), n * 4))
          ++bad, std::printf("MISMATCH b=%d %s\n", b, name.c_str());
      }
      ts[v].push_back(time_ms([&] { vs[v].second(a, lu); }, restore));
    }
  }
  const double bytes = 2.0 * 4.0 * n;
  std::printf("\n%d tiles of %d x %d (kernel: %d CTAs of %d warps, %d "
              "tiles a warp; bound %.6f ms at 3.35 TB/s)\n",
              tiles, b, b, ctas, kWarps, 32 / lanes,
              bytes / 3.35e12 * 1e3);
  for (int v = 0; v < nv; ++v)
    std::printf("  %-8s %9.6f ms\n", vs[v].first.c_str(), median(ts[v]));
  CHECK(cudaFree(a));
  CHECK(cudaFree(lu));
  return bad;
}

}  // namespace variants

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("card: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const int bad = variants::run(16) + variants::run(32);
  std::printf("\nlud_diag_variants: %s\n",
              bad ? "MISMATCH"
                  : "every variant equals the old kernel bit for bit");
  return bad ? 1 : 0;
}
