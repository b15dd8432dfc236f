// Times src/repro_torch/csrc/matmul.cu's float32 kernel at the main path's
// [8192, 2048] @ [2048, 8192] beside the kernel it replaced and variants
// of its design, on one CUDA card, so that the choices its source note
// makes rest on a measurement:
//   scalar loads  the earlier kernel: 128 x 128 tiles, 8 x 8 outputs a
//                 thread, 16-deep slices, a and b loaded one guarded
//                 element at a time into one __shared__ buffer, two
//                 barriers a slice;
//   kernel        the shipped kernel through its launcher (16-byte loads
//                 issued a slice ahead, two buffers, one barrier a slice
//                 of 16, __launch_bounds__(256, 2)): the instantiation
//                 of whole tiles (nothing clamped or masked); at M - 1
//                 rows, the ragged one (clamps and masks); with a and b
//                 4 bytes off, the one of one element an access;
//   copy          the kernel's design at whole tiles written again (mm
//                 below, one template for the variants): it shows how far
//                 nvcc's code for two texts of one design can differ;
//   no bound      the copy at __launch_bounds__(256) alone;
//   guarded       the copy with the first slice's loads behind
//                 `if (K > 0)`;
//   slice8        the copy with slices of 8;
//   256x128       CTA tiles of 256 x 128, 16 x 8 outputs a thread, one
//                 CTA an SM, slices of 16 and of 8.
// Each line gives the median of 25 CUDA-event runs after 5 warm-ups, the
// rate, and the max abs error against a float64 sum of the same product
// over the first 128 rows; the variants run in turns, three times.  Build
// and run from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/matmul_variants tools/matmul_variants.cu \
//     && build/matmul_variants
#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/matmul.cu"

namespace variants {

constexpr int M = 8192, K = 2048, N = 8192, kCheckRows = 128;
constexpr int kOldBM = 128, kOldBN = 128, kOldBK = 16;

__global__ void __launch_bounds__(kThreads)
    scalar_loads(const float* __restrict__ a, const float* __restrict__ b,
                 float* __restrict__ c, int M, int N, int K) {
  __shared__ __align__(16) float sa[kOldBK][kOldBM];
  __shared__ __align__(16) float sb[kOldBK][kOldBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kOldBM, n0 = blockIdx.x * kOldBN;
  const int ar = tid / 2, ak = (tid % 2) * 8;
  const int bk = tid / 16, bn = (tid % 16) * 8;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kOldBK) {
    const int gm = m0 + ar, gk = k0 + bk;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ka = k0 + ak + i, gn = n0 + bn + i;
      sa[ak + i][ar] = (gm < M && ka < K) ? a[(size_t)gm * K + ka] : 0.0f;
      sb[bk][bn + i] = (gk < K && gn < N) ? b[(size_t)gk * N + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kOldBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sa[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sa[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sb[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sb[k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < N) c[(size_t)row * N + col] = acc[i][j];
    }
  }
}

// kTM rows a thread (8 or 16: CTA tiles of 128 or 256 rows x 128
// columns), kBK-deep slices (8 or 16), kMinBlocks __launch_bounds__'s
// CTAs an SM, kGuard the first slice behind `if (K > 0)`; shared memory
// is dynamic, 2 kBK (16 kTM + 4) floats of a and 2 kBK 128 of b.  M a
// multiple of 16 kTM, N of 128, K of kBK.
template <int kTM, int kBK, int kMinBlocks, bool kGuard = false>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    mm(const float* __restrict__ a, const float* __restrict__ b,
       float* __restrict__ c, int N, int K) {
  constexpr int kBM = 16 * kTM, kLdA = kBM + kPadA, kAR = kBM / 128;
  constexpr int kAK = kBK / 8;
  extern __shared__ __align__(16) float smem[];
  float* const sa = smem;                       // [2][kBK][kLdA], k-major
  float* const sb = smem + 2 * kBK * kLdA;      // [2][kBK][kBN]
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int ar = tid % 16 + 16 * (tid / 32), ak = 4 * ((tid / 16) % 2);
  const int bk = tid / 32, bn = 4 * (tid % 32);
  float4 ra[kAR][kAK], rb[kAK];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kAK; ++j) {
#pragma unroll
      for (int q = 0; q < kAR; ++q)
        ra[q][j] = __ldg(reinterpret_cast<const float4*>(
            a + (size_t)(m0 + ar + 128 * q) * K + k0 + ak + 8 * j));
      rb[j] = __ldg(reinterpret_cast<const float4*>(
          b + (size_t)(k0 + bk + 8 * j) * N + n0 + bn));
    }
  };
  auto stash = [&](int buf) {
#pragma unroll
    for (int j = 0; j < kAK; ++j) {
#pragma unroll
      for (int q = 0; q < kAR; ++q) {
        float* col = sa + (buf * kBK + ak + 8 * j) * kLdA + ar + 128 * q;
        col[0 * kLdA] = ra[q][j].x;
        col[1 * kLdA] = ra[q][j].y;
        col[2 * kLdA] = ra[q][j].z;
        col[3 * kLdA] = ra[q][j].w;
      }
      *reinterpret_cast<float4*>(sb + (buf * kBK + bk + 8 * j) * kBN + bn) =
          rb[j];
    }
  };
  float acc[kTM][8];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  if (!kGuard || K > 0) {
    fetch(0);
    stash(0);
  }
  __syncthreads();
  for (int k0 = 0, cur = 0; k0 < K; k0 += kBK, cur ^= 1) {
    const bool next = k0 + kBK < K;
    if (next) fetch(k0 + kBK);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float* sak = sa + (cur * kBK + k) * kLdA + ty * 4;
      const float* sbk = sb + (cur * kBK + k) * kBN + tx * 4;
      float av[kTM], bv[8];
#pragma unroll
      for (int q = 0; q < kTM / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(sak + 64 * q);
        av[4 * q] = v.x; av[4 * q + 1] = v.y;
        av[4 * q + 2] = v.z; av[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 v = *reinterpret_cast<const float4*>(sbk + 64 * h);
        bv[4 * h] = v.x; bv[4 * h + 1] = v.y;
        bv[4 * h + 2] = v.z; bv[4 * h + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (next) stash(cur ^ 1);
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    float* crow = c + (size_t)(m0 + 64 * (i / 4) + ty * 4 + i % 4) * N;
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<float4*>(crow + n0 + h * 64 + tx * 4) =
          make_float4(acc[i][h * 4], acc[i][h * 4 + 1], acc[i][h * 4 + 2],
                      acc[i][h * 4 + 3]);
  }
}

template <int kTM, int kBK, int kMinBlocks, bool kGuard = false>
void start_mm(const float* a, const float* b, float* c) {
  auto kernel = mm<kTM, kBK, kMinBlocks, kGuard>;
  constexpr int bytes = (2 * kBK * (16 * kTM + kPadA) + 2 * kBK * kBN) * 4;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
  kernel<<<dim3(N / kBN, M / (16 * kTM)), kThreads, bytes>>>(a, b, c, N, K);
}

// c's first kCheckRows rows in float64
__global__ void exact(const float* a, const float* b, double* c) {
  const int row = blockIdx.y, col = blockIdx.x * 256 + threadIdx.x;
  double s = 0;
  for (int i = 0; i < K; ++i)
    s += (double)a[(size_t)row * K + i] * b[(size_t)i * N + col];
  c[(size_t)row * N + col] = s;
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
  const size_t na = (size_t)M * K, nb = (size_t)K * N, nc = (size_t)M * N;
  const size_t check = (size_t)kCheckRows * N;
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("device: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  std::vector<float> host(std::max(na, nb) + 4), got(check);
  std::vector<double> want(check), want_off(check);
  float *a, *b, *c;
  double* ref;
  cudaMalloc(&a, na * 4 + 16);
  cudaMalloc(&b, nb * 4 + 16);
  cudaMalloc(&c, nc * 4);
  cudaMalloc(&ref, check * 8);
  srand(42);
  for (auto& v : host) v = rand() / (float)RAND_MAX * 2 - 1;
  cudaMemcpy(a, host.data(), na * 4 + 16, cudaMemcpyHostToDevice);
  for (auto& v : host) v = rand() / (float)RAND_MAX * 2 - 1;
  cudaMemcpy(b, host.data(), nb * 4 + 16, cudaMemcpyHostToDevice);
  const dim3 rows(N / 256, kCheckRows);
  exact<<<rows, 256>>>(a, b, ref);
  cudaMemcpy(want.data(), ref, check * 8, cudaMemcpyDeviceToHost);
  exact<<<rows, 256>>>(a + 1, b + 1, ref);
  cudaMemcpy(want_off.data(), ref, check * 8, cudaMemcpyDeviceToHost);
  auto run = [&](const char* name, int off, auto launch) {
    cudaMemset(c, 0, nc * 4);
    const float ms = median_ms([&] { launch(a + off, b + off); });
    cudaMemcpy(got.data(), c, check * 4, cudaMemcpyDeviceToHost);
    const std::vector<double>& w = off ? want_off : want;
    double err = 0;
    for (size_t i = 0; i < check; ++i)
      err = std::max(err, std::fabs(got[i] - w[i]));
    printf("%-22s %.5f ms  %.2f TFLOP/s  max_abs_err %.3g  %s\n", name, ms,
           2.0 * M * N * (double)K / ms / 1e9, err,
           cudaGetErrorString(cudaGetLastError()));
  };
  const dim3 ctas(N / kOldBN, M / kOldBM);
  auto variant = [&](const char* name, auto start_fn) {
    run(name, 0, [&](const float* ap, const float* bp) {
      start_fn(ap, bp, c);
    });
  };
  for (int rep = 0; rep < 3; ++rep) {
    run("scalar loads", 0, [&](const float* ap, const float* bp) {
      scalar_loads<<<ctas, kThreads>>>(ap, bp, c, M, N, K);
    });
    run("kernel", 0, [&](const float* ap, const float* bp) {
      launch_matmul(ap, bp, c, M, N, K, 0, nullptr);
    });
    run("kernel, M - 1 rows", 0, [&](const float* ap, const float* bp) {
      launch_matmul(ap, bp, c, M - 1, N, K, 0, nullptr);
    });
    run("kernel, 4 bytes off", 1, [&](const float* ap, const float* bp) {
      launch_matmul(ap, bp, c, M, N, K, 0, nullptr);
    });
    variant("copy", start_mm<8, 16, 2>);
    variant("no bound", start_mm<8, 16, 1>);
    variant("guarded", start_mm<8, 16, 2, true>);
    variant("slice8", start_mm<8, 8, 2>);
    variant("256x128", start_mm<16, 16, 1>);
    variant("256x128 slice8", start_mm<16, 8, 1>);
  }
  return 0;
}
