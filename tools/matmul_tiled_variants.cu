// Times src/repro_torch/csrc/matmul_tiled.cu at 2048^3 beside variants of
// its design, on one CUDA card, so that the choices its source note makes
// rest on a measurement:
//   kernel            the shipped kernel through its launcher, 16-byte
//                     aligned, and with a and b 4 bytes off (scalar loads);
//   slice8/slice16    the same design without the edge masks, k-slices of
//                     one or two 8-deep k-tiles (rounding per k-tile);
//   slice8 fma        no partial: the products go straight into the
//                     accumulator (another rounding than the reference's),
//                     under __launch_bounds__(256, 1) and (256, 2).
// Each line gives the median of 25 CUDA-event runs after 5 warm-ups, the
// rate, and the max abs error against a float64 sum of the same product;
// the variants run twice, in turns.  Build and run from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 \
//     -o build/matmul_tiled_variants tools/matmul_tiled_variants.cu \
//     && build/matmul_tiled_variants
#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/matmul_tiled.cu"

namespace variants {

constexpr int kM = 128, kN = 128, kBlock = 256, kPad = 4;

// KT k-tiles a slice; ROUND: the reference's per-k-tile partial and
// __fadd_rn; MINB: __launch_bounds__'s CTAs an SM.  m, n multiples of 128.
template <int KT, bool ROUND, int MINB>
__global__ void __launch_bounds__(kBlock, MINB)
    mm(const float* __restrict__ a, const float* __restrict__ b,
       float* __restrict__ c, int n, int k) {
  constexpr int kK = 8 * KT;
  __shared__ __align__(16) float sa[2][kK][kM + kPad];
  __shared__ __align__(16) float sb[2][kK][kN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kM, n0 = blockIdx.x * kN;
  const int ar = tid / 2, ak = (tid % 2) * 4;
  const int bk = tid / 32, bn = (tid % 32) * 4;
  const float* ap = a + (size_t)(m0 + ar) * k + ak;
  const float* bp = b + (size_t)bk * n + n0 + bn;
  float4 ra[KT], rb[KT];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      ra[t] = __ldg(reinterpret_cast<const float4*>(ap + k0 + 8 * t));
      rb[t] = __ldg(
          reinterpret_cast<const float4*>(bp + (size_t)(k0 + 8 * t) * n));
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      sa[buf][8 * t + ak + 0][ar] = ra[t].x;
      sa[buf][8 * t + ak + 1][ar] = ra[t].y;
      sa[buf][8 * t + ak + 2][ar] = ra[t].z;
      sa[buf][8 * t + ak + 3][ar] = ra[t].w;
      *reinterpret_cast<float4*>(&sb[buf][8 * t + bk][bn]) = rb[t];
    }
  };
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  fetch(0);
  stash(0);
  __syncthreads();
  const int slices = k / kK;
  for (int s = 0; s < slices; ++s) {
    const int cur = s & 1;
    if (s + 1 < slices) fetch((s + 1) * kK);
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      float part[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = ROUND ? 0.0f : acc[i][j];
#pragma unroll
      for (int kk = 8 * t; kk < 8 * t + 8; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&sa[cur][kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&sa[cur][kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&sb[cur][kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&sb[cur][kk][64 + tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            part[i][j] = fmaf(av[i], bv[j], part[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = ROUND ? __fadd_rn(acc[i][j], part[i][j]) : part[i][j];
    }
    if (s + 1 < slices) stash(cur ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(c + (size_t)row * n + n0 + h * 64 + tx * 4) =
          make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                      acc[i][h * 4 + 3]);
  }
}

__global__ void exact(const float* a, const float* b, float* c, int n, int k) {
  const int row = blockIdx.y * 16 + threadIdx.y;
  const int col = blockIdx.x * 16 + threadIdx.x;
  double s = 0;
  for (int i = 0; i < k; ++i)
    s += (double)a[(size_t)row * k + i] * b[(size_t)i * n + col];
  c[(size_t)row * n + col] = (float)s;
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
  const int N = 2048;
  const size_t count = (size_t)N * N, bytes = count * 4;
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("device: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  std::vector<float> host(count + 4), want(count), got(count);
  float *a, *b, *c, *ref;
  cudaMalloc(&a, bytes + 16);
  cudaMalloc(&b, bytes + 16);
  cudaMalloc(&c, bytes);
  cudaMalloc(&ref, bytes);
  srand(42);
  for (float* buf : {a, b}) {
    for (auto& v : host) v = rand() / (float)RAND_MAX * 2 - 1;
    cudaMemcpy(buf, host.data(), bytes + 16, cudaMemcpyHostToDevice);
  }
  auto report = [&](const char* name, float ms, const float* exact_c) {
    double err = 0;
    cudaMemcpy(got.data(), c, bytes, cudaMemcpyDeviceToHost);
    cudaMemcpy(want.data(), exact_c, bytes, cudaMemcpyDeviceToHost);
    for (size_t i = 0; i < count; ++i)
      err = std::max(err, (double)std::fabs(got[i] - want[i]));
    printf("%-24s %.5f ms  %.2f TFLOP/s  max_abs_err %.3g  %s\n", name, ms,
           2.0 * N * N * (double)N / ms / 1e9, err,
           cudaGetErrorString(cudaGetLastError()));
  };
  const dim3 ctas(N / kN, N / kM);
  auto variant = [&](const char* name, auto kern) {
    cudaMemset(c, 0, bytes);
    report(name, median_ms([&] { kern<<<ctas, kBlock>>>(a, b, c, N, N); }),
           ref);
  };
  // the shipped kernel on a, b at off floats past their aligned bases
  auto shipped = [&](const char* name, int off, const float* exact_c) {
    cudaMemset(c, 0, bytes);
    report(name, median_ms([&] {
      launch_matmul_tiled(a + off, b + off, c, N, N, N, (N / 8) * (N / 8),
                          ctas.x, ctas.y, nullptr);
    }), exact_c);
  };
  float* ref_off;
  cudaMalloc(&ref_off, bytes);
  exact<<<dim3(N / 16, N / 16), dim3(16, 16)>>>(a, b, ref, N, N);
  exact<<<dim3(N / 16, N / 16), dim3(16, 16)>>>(a + 1, b + 1, ref_off, N, N);
  for (int rep = 0; rep < 2; ++rep) {
    shipped("kernel", 0, ref);
    shipped("kernel, 4 bytes off", 1, ref_off);
    variant("slice8", mm<1, true, 1>);
    variant("slice16", mm<2, true, 1>);
    variant("slice8 fma, 1 CTA/SM", mm<1, false, 1>);
    variant("slice8 fma, 2 CTA/SM", mm<1, false, 2>);
  }
  return 0;
}
