// Times src/repro_torch/csrc/reduce_warp.cu at n = 2^24, B = 256 beside
// variants of its design, on one CUDA card, so that the choice its source
// note makes rests on a measurement.  All are one warp a logical block in
// CTAs of 256 threads and compute the reference's butterflies:
//   kernel     the shipped kernel through its launcher: coalesced loads,
//              the first butterflies level by level on all 8 registers,
//              an unrolled select of warp t's sum into lane t (40 + 5
//              shuffles a block);
//   split      coalesced loads, the first butterflies' levels 16, 8, 4
//              splitting the registers between the lanes (a lane keeps
//              half, sends the other half and adds its partner's value of
//              each register it keeps), then levels 2, 1 and one shuffle
//              to gather the warps' sums (7 + 2 + 1 + 5 shuffles);
//   positions  lane l holds positions (l % 4) + 4 i of the reference's
//              warp l / 4, so levels 16, 8 and 4 are register adds and
//              the warp loads 16 bytes from each of 8 lines (2 + 1 + 5
//              shuffles).
// Each line gives the median of 25 CUDA-event runs after 5 warm-ups, the
// rate over the 67 MB read, and how many sums differ in any bit from the
// kernel's; the variants run five times, in turns.  Build and run from the
// repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//     -o build/reduce_warp_variants tools/reduce_warp_variants.cu \
//     && build/reduce_warp_variants
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/reduce_warp.cu"

namespace variants {

constexpr int kBlock = 256, kNw = 8;
constexpr unsigned kMask = 0xffffffffu;

__device__ __forceinline__ float butterfly(float v) {
#pragma unroll
  for (int off = 16; off >= 1; off /= 2)
    v = __fadd_rn(v, __shfl_xor_sync(kMask, v, off));
  return v;
}

__global__ void __launch_bounds__(kBlock)
    split(const float* __restrict__ x, float* __restrict__ out, int n,
          int grid) {
  const int lane = threadIdx.x % 32;
  const long long bid = (long long)blockIdx.x * (kBlock / 32) +
                        threadIdx.x / 32;
  if (bid >= grid) return;
  float v[kNw];
#pragma unroll
  for (int j = 0; j < kNw; ++j) {
    const long long gid = bid * 32 * kNw + 32LL * j + lane;
    v[j] = gid < n ? __ldg(x + gid) : 0.0f;
  }
  // c registers left: a lane with bit off clear keeps j, sends j + c/2
#pragma unroll
  for (int c = kNw, off = 16; c >= 2; c /= 2, off /= 2) {
    const bool hi = lane & off;
#pragma unroll
    for (int j = 0; j < c / 2; ++j) {
      const float keep = hi ? v[j + c / 2] : v[j];
      const float send = hi ? v[j] : v[j + c / 2];
      v[j] = __fadd_rn(keep, __shfl_xor_sync(kMask, send, off));
    }
  }
  // lane l now holds warp l / 4's partial
  float s = __fadd_rn(v[0], __shfl_xor_sync(kMask, v[0], 2));
  s = __fadd_rn(s, __shfl_xor_sync(kMask, s, 1));
  s = __shfl_sync(kMask, s, (lane * 4) % 32);
  s = butterfly(lane < kNw ? s : 0.0f);
  if (lane == 0) out[bid] = s;
}

__global__ void __launch_bounds__(kBlock)
    positions(const float* __restrict__ x, float* __restrict__ out, int n,
              int grid) {
  const int lane = threadIdx.x % 32;
  const long long bid = (long long)blockIdx.x * (kBlock / 32) +
                        threadIdx.x / 32;
  if (bid >= grid) return;
  const long long base = bid * 32 * kNw + 32 * (lane / 4) + lane % 4;
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const long long gid = base + 4 * i;
    v[i] = gid < n ? __ldg(x + gid) : 0.0f;
  }
  // level 16 pairs register i with i + 4, level 8 i with i + 2, 4 0 with 1
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __fadd_rn(v[i], v[i + 4]);
#pragma unroll
  for (int i = 0; i < 2; ++i) v[i] = __fadd_rn(v[i], v[i + 2]);
  float s = __fadd_rn(v[0], v[1]);
  s = __fadd_rn(s, __shfl_xor_sync(kMask, s, 2));
  s = __fadd_rn(s, __shfl_xor_sync(kMask, s, 1));
  s = __shfl_sync(kMask, s, (lane * 4) % 32);
  s = butterfly(lane < kNw ? s : 0.0f);
  if (lane == 0) out[bid] = s;
}

template <typename F>
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
  std::sort(ts.begin(), ts.end());
  return ts[ts.size() / 2];
}

}  // namespace variants

int main() {
  using namespace variants;
  const int n = 1 << 24, grid = n / kBlock;
  const size_t bytes = (size_t)n * 4;
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("device: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  std::vector<float> host(n), want(grid), got(grid);
  srand(42);
  for (auto& v : host) v = rand() / (float)RAND_MAX * 2 - 1;
  float *x, *out;
  cudaMalloc(&x, bytes);
  cudaMalloc(&out, grid * 4);
  cudaMemcpy(x, host.data(), bytes, cudaMemcpyHostToDevice);
  auto shipped = [&] {
    launch_reduce_warp(x, out, n, grid, grid, kBlock, nullptr);
  };
  shipped();
  cudaMemcpy(want.data(), out, grid * 4, cudaMemcpyDeviceToHost);
  auto report = [&](const char* name, float ms) {
    cudaMemcpy(got.data(), out, grid * 4, cudaMemcpyDeviceToHost);
    int differ = 0;
    for (int i = 0; i < grid; ++i)
      differ += std::memcmp(&got[i], &want[i], 4) != 0;
    printf("%-10s %.5f ms  %.3f TB/s  %d sums differ  %s\n", name, ms,
           bytes / ms / 1e9, differ, cudaGetErrorString(cudaGetLastError()));
  };
  const unsigned ctas = grid / (kBlock / 32);
  for (int rep = 0; rep < 5; ++rep) {
    report("kernel", median_ms(shipped));
    cudaMemset(out, 0, grid * 4);
    report("split", median_ms([&] {
      split<<<ctas, kBlock>>>(x, out, n, grid);
    }));
    cudaMemset(out, 0, grid * 4);
    report("positions", median_ms([&] {
      positions<<<ctas, kBlock>>>(x, out, n, grid);
    }));
  }
  return 0;
}
