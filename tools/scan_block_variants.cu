// Times src/repro_torch/csrc/scan_block.cu at the main path's n = 2^24
// float32 values (the chevron's 131,072 blocks of 128) and at blocks of
// 1024, 256, 32 and 16, beside the kernel it replaced and variants of its
// design, on one CUDA card, so that the choices its source note makes rest
// on a measurement:
//   old        the earlier kernel: a CTA of B threads a logical block, one
//              value a thread in __shared__, 2 log2(B) + 1 barriers;
//   kernel     the shipped kernel through launch_scan_block (a warp a
//              logical block, value j of lane l is thread 32 j + l), on
//              16-byte aligned buffers and on x and y 4 bytes off a
//              16-byte boundary;
//   group4     (B >= 128) the shipped levels over groups of W = 4
//              consecutive threads a lane: value (g, i) of lane l is
//              thread 128 g + 4 l + i, a float4 a lane and group;
//   blocked    (B >= 256) the same with W = B/32: lane l holds threads
//              B/32 l ... B/32 l + B/32 - 1, float4s a lane;
//   W<k>       the kernel's layout in CTAs of k warps (W8 is the shipped
//              shape);
//   copy       cudaMemcpyAsync of x into y: the same bytes read and
//              written, with no scan.
// Every variant and the old kernel must equal the kernel bit for bit.
// Each line gives the median of 25 CUDA-event runs after 5 warm-ups, a
// spin on the card covering the enqueue; five turns, then each variant's
// median of its turns and its rate over the 8 bytes a value moves.  Build
// and run from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/scan_block_variants tools/scan_block_variants.cu \
//     && build/scan_block_variants
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <utility>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/scan_block.cu"

namespace variants {

constexpr int kTurns = 5, kRuns = 25, kWarm = 5;
constexpr int kN = 1 << 24;

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
__global__ void old_scan(const float* __restrict__ x, float* y) {
  __shared__ float s[1024];
  const int t = threadIdx.x;
  const size_t gid = (size_t)blockIdx.x * blockDim.x + t;
  float v = x[gid];
  s[t] = v;
  __syncthreads();
  for (int d = 1; d < (int)blockDim.x; d <<= 1) {
    const float add = t >= d ? s[t - d] : 0.0f;
    __syncthreads();
    v = __fadd_rn(v, add);
    s[t] = v;
    __syncthreads();
  }
  y[gid] = v;
}

// one lane's W consecutive values: float4s when W % 4 == 0, else one
// access of 4 W bytes (W = 1 or 2)
template <int W>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int q = 0; q < W; q += 4) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(p + q));
      v[q] = t.x; v[q + 1] = t.y; v[q + 2] = t.z; v[q + 3] = t.w;
    }
  } else if constexpr (W == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}
template <int W>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (W % 4 == 0) {
#pragma unroll
    for (int q = 0; q < W; q += 4)
      *reinterpret_cast<float4*>(p + q) =
          make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// The reference's levels over one logical block of 32 E threads held by a
// warp in groups of W, value (g, i) of lane `lane` at v[W g + i] (thread
// 32 W g + W lane + i); W = 1 is the shipped scan_warp's layout.  Pairs
// within a group are in-lane; a pair k lanes down is one rotating
// __shfl_sync, the source sending group g - 1's value where it wraps.
template <int E, int W>
__device__ __forceinline__ void scan_grouped(float (&v)[E], int lane) {
  constexpr int G = E / W;
#pragma unroll
  for (int lv = 0; lv < log2_of(32 * E); ++lv) {
    const int d = 1 << lv;
    float o[E];
#pragma unroll
    for (int j = 0; j < E; ++j) o[j] = v[j];
#pragma unroll
    for (int g = 0; g < G; ++g) {
#pragma unroll
      for (int i = 0; i < W; ++i) {
        const int j = W * g + i;
        if (d >= 32 * W) {               // this lane, d / 32 W groups down
          const int m = d / (32 * W);
          v[j] = __fadd_rn(o[j], g >= m ? at(o, j - W * m) : 0.0f);
        } else if (i >= d) {             // this lane's group
          v[j] = __fadd_rn(o[j], at(o, j - d));
        } else {                         // k lanes down, its value r
          const int k = (d - i + W - 1) / W, r = i - d + k * W;
          const float wrap = g ? at(o, j - i + r - W) : 0.0f;
          const float send = lane + k >= 32 ? wrap : o[j - i + r];
          v[j] = __fadd_rn(o[j], __shfl_sync(kFull, send, (lane - k) & 31));
        }
      }
    }
  }
}

// the variants: W-wide groups in CTAs of NW warps
template <int E, int W, int NW>
__global__ void __launch_bounds__(NW * 32)
    design(const float* __restrict__ x, float* __restrict__ y, int grid) {
  const int lane = threadIdx.x % 32;
  const long long bid = (long long)blockIdx.x * NW + threadIdx.x / 32;
  if (bid >= grid) return;
  const long long base = bid * 32 * E + W * lane;
  float v[E];
#pragma unroll
  for (int g = 0; g < E / W; ++g) load<W>(x + base + 32 * W * g, &v[W * g]);
  scan_grouped<E, W>(v, lane);
#pragma unroll
  for (int g = 0; g < E / W; ++g) store<W>(y + base + 32 * W * g, &v[W * g]);
}

__global__ void spin(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

struct Bufs {
  const float* x;
  float* y;
};

float median(std::vector<float> v) {
  std::sort(v.begin(), v.end());
  return v[v.size() / 2];
}

float time_ms(const std::function<void()>& f) {
  cudaEvent_t e0, e1;
  CHECK(cudaEventCreate(&e0));
  CHECK(cudaEventCreate(&e1));
  std::vector<float> ts;
  for (int i = 0; i < kWarm + kRuns; ++i) {
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

using Fn = std::function<void(const Bufs&)>;

int ctas_of(int grid, int block, int warps) {
  const long long w = ((long long)grid * std::min(block, 32) + 31) / 32;
  return (int)((w + warps - 1) / warps);
}

template <int E, int W, int NW>
std::pair<std::string, Fn> variant(const char* name, int grid) {
  const int ctas = ctas_of(grid, 32 * E, NW);
  return {name, [=](const Bufs& b) {
            design<E, W, NW><<<ctas, NW * 32>>>(b.x, b.y, grid);
          }};
}

// the variants that apply at block B = 32 E (E = 0: B = 16)
template <int E>
std::vector<std::pair<std::string, Fn>> variants_of(int grid) {
  std::vector<std::pair<std::string, Fn>> vs;
  if constexpr (E >= 4) vs.push_back(variant<E, 4, 8>("group4", grid));
  if constexpr (E >= 8) vs.push_back(variant<E, E, 8>("blocked", grid));
  if constexpr (E == 4) {
    vs.push_back(variant<E, 1, 4>("W4", grid));
    vs.push_back(variant<E, 1, 8>("W8", grid));
    vs.push_back(variant<E, 1, 16>("W16", grid));
  }
  return vs;
}

int run(int block, std::vector<std::pair<std::string, Fn>> extra) {
  const size_t n = kN;
  const int grid = kN / block;
  std::vector<float> hx(n);
  srand(42);
  for (size_t i = 0; i < n; ++i)
    hx[i] = 2.0f * (float)rand() / RAND_MAX - 1.0f;
  for (size_t i = 0; i < 64; ++i) hx[i] = -0.0f;
  // x, y, and the same two 4 bytes past a 16-byte boundary
  float *x, *y, *x1, *y1, *ref;
  for (float** b : {&x, &y, &ref}) CHECK(cudaMalloc(b, n * 4));
  for (float** b : {&x1, &y1}) CHECK(cudaMalloc(b, n * 4 + 16));
  x1 += 1, y1 += 1;
  CHECK(cudaMemcpy(x, hx.data(), n * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(x1, hx.data(), n * 4, cudaMemcpyHostToDevice));
  const int ctas = ctas_of(grid, block, kWarps);
  CHECK((cudaError_t)launch_scan_block(x, ref, grid, block, nullptr));
  std::vector<float> want(n), got(n);
  CHECK(cudaMemcpy(want.data(), ref, n * 4, cudaMemcpyDeviceToHost));

  std::vector<std::pair<std::string, Fn>> vs = {
      {"old",
       [=](const Bufs& b) { old_scan<<<grid, block>>>(b.x, b.y); }},
      {"kernel",
       [=](const Bufs& b) {
         CHECK((cudaError_t)launch_scan_block(b.x, b.y, grid, block,
                                              nullptr));
       }},
  };
  vs.insert(vs.end(), extra.begin(), extra.end());
  vs.push_back({"copy", [=](const Bufs& b) {
                  CHECK(cudaMemcpyAsync(b.y, b.x, n * 4,
                                        cudaMemcpyDeviceToDevice));
                }});
  const int nv = (int)vs.size();
  int bad = 0;
  std::vector<std::vector<float>> ts(nv + 1);
  for (int turn = 0; turn < kTurns; ++turn) {
    for (int v = 0; v <= nv; ++v) {
      // the last is the shipped kernel on buffers 4 bytes off
      const bool off = v == nv;
      const Bufs b = off ? Bufs{x1, y1} : Bufs{x, y};
      const Fn& f = vs[off ? 1 : v].second;
      CHECK(cudaMemset(b.y, 0, n * 4));
      f(b);
      CHECK(cudaDeviceSynchronize());
      if (turn == 0 && (off || vs[v].first != "copy")) {
        CHECK(cudaMemcpy(got.data(), b.y, n * 4, cudaMemcpyDeviceToHost));
        if (std::memcmp(got.data(), want.data(), n * 4) != 0)
          ++bad, std::printf("MISMATCH block %d %s\n", block,
                             off ? "kernel off16" : vs[v].first.c_str());
      }
      ts[v].push_back(time_ms([&] { f(b); }));
    }
  }
  std::printf("\nn = %d, block %d, grid %d (kernel: %d CTAs; bound %.6f ms "
              "at 3.35 TB/s)\n", kN, block, grid, ctas,
              8.0 * n / 3.35e12 * 1e3);
  for (int v = 0; v <= nv; ++v) {
    const float m = median(ts[v]);
    std::printf("  %-14s %9.6f ms  %7.1f GB/s\n",
                v == nv ? "kernel off16" : vs[v].first.c_str(), m,
                8.0 * n / (m * 1e-3) / 1e9);
  }
  for (float* b : {x, y, ref}) CHECK(cudaFree(b));
  for (float* b : {x1, y1}) CHECK(cudaFree(b - 1));
  return bad;
}

}  // namespace variants

int main() {
  using namespace variants;
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("card: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const int bad = run(128, variants_of<4>(kN / 128)) +
                  run(1024, variants_of<32>(kN / 1024)) +
                  run(256, variants_of<8>(kN / 256)) +
                  run(32, variants_of<1>(kN / 32)) +
                  run(16, variants_of<0>(kN / 16));
  std::printf("\nscan_block_variants: %s\n",
              bad ? "MISMATCH"
                  : "every variant and the old kernel equal the kernel bit "
                    "for bit");
  return bad ? 1 : 0;
}
