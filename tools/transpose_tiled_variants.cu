// Times src/repro_torch/csrc/transpose_tiled.cu at the main path's
// 4096 x 4096 float32 (262,144 logical 8 x 8 tiles) beside the kernel it
// replaced and variants of its design, on one CUDA card, so that the
// choices its source note makes rest on a measurement:
//   8x8 block     the earlier kernel: a CTA of 64 threads a logical tile,
//                 an unpadded 8 x 8 __shared__ tile, one float a thread;
//   kernel        the shipped kernel through its launcher (64 x 64
//                 squares, 256 threads, four float4s a thread, rows
//                 padded by one float), 16-byte aligned, and with x and y
//                 4 bytes off (one float an access, sixteen a thread);
//   T<t> v<n> p<p> t<k>
//                 the kernel's design written again (square_kernel
//                 below) at squares t (32, 64), n floats an access (1,
//                 4), padding p (0, 1) and k threads a CTA (128, 256):
//                 t^2 / k floats a thread in flight; T64 v4 p1 t256 is
//                 the shipped kernel's shape;
//   memcpy        cudaMemcpyAsync of the same 67 MB device to device, the
//                 card's own copy, as a yardstick for reads and writes.
// Each turn times every variant as the median of 25 CUDA-event runs after
// 5 warm-ups and checks its y against the earlier kernel's, bit for bit;
// five turns, then each variant's median of its five medians and its rate
// over the 134 MB moved.  Build and run from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/transpose_tiled_variants tools/transpose_tiled_variants.cu \
//     && build/transpose_tiled_variants
#include <algorithm>
#include <cstdio>
#include <cstring>
#include <functional>
#include <string>
#include <utility>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/transpose_tiled.cu"

namespace variants {

constexpr int kH = 4096, kW = 4096, kTurns = 5;

// the kernel this redesign replaced, as it was
__global__ void block_8x8(const float* __restrict__ x, float* y, int h,
                          int w) {
  __shared__ float t[8][8];
  const int ty = threadIdx.x / 8, tx = threadIdx.x % 8;
  const int ntx = w / 8;
  const int by = blockIdx.x / ntx, bx = blockIdx.x % ntx;
  t[ty][tx] = x[(size_t)(by * 8 + ty) * w + bx * 8 + tx];
  __syncthreads();
  y[(size_t)(bx * 8 + ty) * h + by * 8 + tx] = t[tx][ty];
}

// the shipped kernel's design written again with its square T, floats an
// access VEC, padding PAD and threads NT as parameters (the shipped
// kernel fixes T = 64, PAD = 1 and NT = 256)
template <int T, int VEC, int PAD, int NT>
__global__ void __launch_bounds__(NT)
    square_kernel(const float* __restrict__ x, float* __restrict__ y, int h,
                  int w, int grid) {
  using V = typename Vec<VEC>::type;
  constexpr int kLanes = kSub / VEC;
  constexpr int kRows = NT / kLanes;
  static_assert(T % kSub == 0 && kSub % kRows == 0 && kLogical % VEC == 0,
                "the passes must tile the square");
  constexpr int kPasses = kSub / kRows;
  constexpr int kSubs = T / kSub;
  constexpr int kItems = kSubs * kSubs * kPasses;
  __shared__ float t[T][T + PAD];

  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * T, c0 = blockIdx.x * T;
  const int lr = tid / kLanes, lc = (tid % kLanes) * VEC;
  V v[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int s = u / kPasses;
    const int r = (s / kSubs) * kSub + (u % kPasses) * kRows + lr;
    const int c = (s % kSubs) * kSub + lc;
    if (r0 + r < h && c0 + c < w)
      v[u] = *reinterpret_cast<const V*>(x + (size_t)(r0 + r) * w + c0 + c);
    else
      v[u] = V{};
  }
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int s = u / kPasses;
    const int r = (s / kSubs) * kSub + (u % kPasses) * kRows + lr;
    const int c = (s % kSubs) * kSub + lc;
#pragma unroll
    for (int e = 0; e < VEC; ++e) t[r][c + e] = Vec<VEC>::get(v[u], e);
  }
  __syncthreads();
  const long long tiles_w = w / kLogical;
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int s = u / kPasses;
    const int a = (s / kSubs) * kSub + (u % kPasses) * kRows + lr;
    const int b = (s % kSubs) * kSub + lc;
    const int xr = r0 + b, xc = c0 + a;
    if (xr < h && xc < w &&
        (xr / kLogical) * tiles_w + xc / kLogical < grid) {
      float f[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = t[b + e][a];
      *reinterpret_cast<V*>(y + (size_t)xc * h + xr) = Vec<VEC>::make(f);
    }
  }
}

template <int T, int VEC, int PAD, int NT>
void square(const float* x, float* y) {
  square_kernel<T, VEC, PAD, NT>
      <<<dim3(kW / T, kH / T), NT>>>(x, y, kH, kW, (kH / 8) * (kW / 8));
}

template <class F>
float median_ms(F f) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int i = 0; i < 5; ++i) f();
  std::vector<float> ts;
  for (int r = 0; r < 25; ++r) {
    cudaEventRecord(e0);
    f();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    ts.push_back(ms);
  }
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  std::sort(ts.begin(), ts.end());
  return ts[ts.size() / 2];
}

}  // namespace variants

int main() {
  using namespace variants;
  const size_t count = (size_t)kH * kW, bytes = count * 4;
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("device: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  std::vector<float> host(count + 4), want(count), got(count);
  srand(42);
  for (auto& v : host) v = rand() / (float)RAND_MAX * 8 - 4;
  float *x, *y, *ref;
  cudaMalloc(&x, bytes + 16);
  cudaMalloc(&y, bytes + 16);
  cudaMalloc(&ref, bytes);
  cudaMemcpy(x, host.data(), bytes + 16, cudaMemcpyHostToDevice);
  // the earlier kernel's y, at offset 0 and at 4 bytes off
  std::vector<float> want_off(count);
  block_8x8<<<(kH / 8) * (kW / 8), 64>>>(x, ref, kH, kW);
  cudaMemcpy(want.data(), ref, bytes, cudaMemcpyDeviceToHost);
  block_8x8<<<(kH / 8) * (kW / 8), 64>>>(x + 1, ref, kH, kW);
  cudaMemcpy(want_off.data(), ref, bytes, cudaMemcpyDeviceToHost);

  using Launch = std::function<void(const float*, float*)>;
  const int grid = (kH / 8) * (kW / 8), side = transpose_tiled_side();
  const std::vector<std::pair<std::string, std::pair<int, Launch>>> runs = {
      {"8x8 block", {0, [&](const float* xp, float* yp) {
         block_8x8<<<grid, 64>>>(xp, yp, kH, kW);
       }}},
      {"kernel", {0, [&](const float* xp, float* yp) {
         launch_transpose_tiled(xp, yp, kH, kW, grid, kW / side, kH / side,
                                nullptr);
       }}},
      {"kernel, 4 bytes off", {1, [&](const float* xp, float* yp) {
         launch_transpose_tiled(xp, yp, kH, kW, grid, kW / side, kH / side,
                                nullptr);
       }}},
      {"T64 v4 p1 t256", {0, Launch(square<64, 4, 1, 256>)}},
      {"T64 v4 p0 t256", {0, Launch(square<64, 4, 0, 256>)}},
      {"T64 v4 p1 t128", {0, Launch(square<64, 4, 1, 128>)}},
      {"T64 v1 p1 t256", {0, Launch(square<64, 1, 1, 256>)}},
      {"T32 v4 p1 t256", {0, Launch(square<32, 4, 1, 256>)}},
      {"T32 v4 p0 t256", {0, Launch(square<32, 4, 0, 256>)}},
      {"T32 v4 p1 t128", {0, Launch(square<32, 4, 1, 128>)}},
      {"T32 v1 p1 t256", {0, Launch(square<32, 1, 1, 256>)}},
      {"memcpy", {-1, [&](const float* xp, float* yp) {
         cudaMemcpyAsync(yp, xp, bytes, cudaMemcpyDeviceToDevice);
       }}},
  };
  std::vector<std::vector<float>> times(runs.size());
  for (int turn = 0; turn < kTurns; ++turn) {
    for (size_t i = 0; i < runs.size(); ++i) {
      const int off = std::max(runs[i].second.first, 0);
      const Launch& f = runs[i].second.second;
      cudaMemset(y, 0, bytes + 16);
      const float ms = median_ms([&] { f(x + off, y + off); });
      cudaMemcpy(got.data(), y + off, bytes, cudaMemcpyDeviceToHost);
      const char* bits = "-";
      if (runs[i].second.first >= 0)
        bits = memcmp(got.data(), off ? want_off.data() : want.data(),
                      bytes) == 0
                   ? "equal"
                   : "DIFFER";
      printf("turn %d  %-22s %.5f ms  bits %s  %s\n", turn,
             runs[i].first.c_str(), ms, bits,
             cudaGetErrorString(cudaGetLastError()));
      times[i].push_back(ms);
    }
  }
  for (size_t i = 0; i < runs.size(); ++i) {
    std::vector<float> t = times[i];
    std::sort(t.begin(), t.end());
    const float ms = t[t.size() / 2];
    printf("median of %d  %-22s %.5f ms  %.3f TB/s\n", kTurns,
           runs[i].first.c_str(), ms, 2.0 * bytes / ms / 1e9);
  }
  return 0;
}
