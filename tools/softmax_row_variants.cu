// Times src/repro_torch/csrc/softmax_row.cu at the main path's 131,072
// rows of 128 beside the kernel it replaced and a variant of its design,
// on one CUDA card, so that the choices its source note makes rest on a
// measurement:
//   block a row   the earlier kernel: a block of 128 threads a row, one
//                 value a thread, two barriers;
//   kernel        the shipped kernel through its launcher (a warp a row,
//                 one float4 a lane), 16-byte aligned, and with x and y 4
//                 bytes off (one float an access);
//   rows2, rows4  the same design with two or four rows a warp, all their
//                 loads issued before the first max (rows_a_warp below).
// Each line gives the median of 25 CUDA-event runs after 5 warm-ups, the
// rate over the 134 MB moved, and the max abs error against a float64
// softmax of the same rows; the variants run in turns, five times.  Build
// and run from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//     -o build/softmax_row_variants tools/softmax_row_variants.cu \
//     && build/softmax_row_variants
#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/softmax_row.cu"

namespace variants {

constexpr int kRows = 131072, kB = 128;

__global__ void block_a_row(const float* __restrict__ x, float* y) {
  __shared__ float wmax[32];
  __shared__ float wsum[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t at = (size_t)blockIdx.x * blockDim.x + t;
  const float v = x[at];
  float m = v;
  for (int off = 16; off >= 1; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) wmax[warp] = m;
  __syncthreads();
  m = wmax[0];
  for (int i = 1; i < nwarps; ++i) m = fmaxf(m, wmax[i]);
  const float p = expf(__fsub_rn(v, m));
  float sum = p;
  for (int off = 16; off >= 1; off >>= 1)
    sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
  if (lane == 0) wsum[warp] = sum;
  __syncthreads();
  sum = wsum[0];
  for (int i = 1; i < nwarps; ++i) sum = __fadd_rn(sum, wsum[i]);
  y[at] = __fdiv_rn(p, sum);
}

// the kernel's design at B = 128 (one float4 a lane), R rows a warp
template <int R>
__global__ void __launch_bounds__(kThreads)
    rows_a_warp(const float* __restrict__ x, float* __restrict__ y) {
  const int lane = threadIdx.x % 32;
  const size_t row0 = ((size_t)blockIdx.x * kWarps + threadIdx.x / 32) * R;
  float4 v[R];
#pragma unroll
  for (int r = 0; r < R; ++r)
    v[r] = __ldg(reinterpret_cast<const float4*>(x + (row0 + r) * kB) +
                 lane);
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float m = fmaxf(fmaxf(v[r].x, v[r].y), fmaxf(v[r].z, v[r].w));
#pragma unroll
    for (int off = 16; off >= 1; off /= 2)
      m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
    v[r] = make_float4(expf(__fsub_rn(v[r].x, m)), expf(__fsub_rn(v[r].y, m)),
                       expf(__fsub_rn(v[r].z, m)),
                       expf(__fsub_rn(v[r].w, m)));
    float sum = __fadd_rn(__fadd_rn(__fadd_rn(v[r].x, v[r].y), v[r].z),
                          v[r].w);
#pragma unroll
    for (int off = 16; off >= 1; off /= 2)
      sum = __fadd_rn(sum, __shfl_xor_sync(kFull, sum, off));
    v[r] = make_float4(__fdiv_rn(v[r].x, sum), __fdiv_rn(v[r].y, sum),
                       __fdiv_rn(v[r].z, sum), __fdiv_rn(v[r].w, sum));
    reinterpret_cast<float4*>(y + (row0 + r) * kB)[lane] = v[r];
  }
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
  const size_t count = (size_t)kRows * kB, bytes = count * 4;
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("device: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  std::vector<float> host(count + 1), got(count);
  std::vector<double> want(count + 1);
  srand(42);
  for (auto& v : host) v = rand() / (float)RAND_MAX * 8 - 4;
  // float64 softmax of the rows at offset 0 and at offset 1
  auto exact = [&](int off, std::vector<double>& out) {
    for (size_t r = 0; r < kRows; ++r) {
      const float* row = host.data() + off + r * kB;
      const double m = *std::max_element(row, row + kB);
      double s = 0;
      for (int i = 0; i < kB; ++i) s += std::exp((double)row[i] - m);
      for (int i = 0; i < kB; ++i)
        out[r * kB + i] = std::exp((double)row[i] - m) / s;
    }
  };
  std::vector<double> want_off(count);
  exact(0, want);
  exact(1, want_off);
  float *x, *y;
  cudaMalloc(&x, bytes + 16);
  cudaMalloc(&y, bytes + 16);
  cudaMemcpy(x, host.data(), bytes + 4, cudaMemcpyHostToDevice);
  auto run = [&](const char* name, int off, auto launch) {
    cudaMemset(y, 0, bytes + 16);
    const float ms = median_ms([&] { launch(x + off, y + off); });
    cudaMemcpy(got.data(), y + off, bytes, cudaMemcpyDeviceToHost);
    const std::vector<double>& w = off ? want_off : want;
    double err = 0;
    for (size_t i = 0; i < count; ++i)
      err = std::max(err, std::fabs(got[i] - w[i]));
    printf("%-22s %.5f ms  %.3f TB/s  max_abs_err %.3g  %s\n", name, ms,
           2.0 * bytes / ms / 1e9, err,
           cudaGetErrorString(cudaGetLastError()));
  };
  for (int rep = 0; rep < 5; ++rep) {
    run("block a row", 0, [&](const float* xp, float* yp) {
      block_a_row<<<kRows, kB>>>(xp, yp);
    });
    run("kernel", 0, [&](const float* xp, float* yp) {
      launch_softmax_row(xp, yp, kRows, kB, nullptr);
    });
    run("kernel, 4 bytes off", 1, [&](const float* xp, float* yp) {
      launch_softmax_row(xp, yp, kRows, kB, nullptr);
    });
    run("rows2", 0, [&](const float* xp, float* yp) {
      rows_a_warp<2><<<kRows / (2 * kWarps), kThreads>>>(xp, yp);
    });
    run("rows4", 0, [&](const float* xp, float* yp) {
      rows_a_warp<4><<<kRows / (4 * kWarps), kThreads>>>(xp, yp);
    });
  }
  return 0;
}
