// Times src/repro_torch/csrc/vecadd.cu at the main path's n = 2^24 (the
// chevron's 131,072 blocks of 128) beside the kernel it replaced and
// variants of its design, on one CUDA card, so that the choices its source
// note makes rest on a measurement:
//   element    the earlier kernel (vecadd_kernel, still the launcher's
//              path for buffers off a 16-byte boundary) at the chevron's
//              grid and block: one element a thread;
//   kernel     the shipped kernel through its launcher, 16-byte aligned,
//              and with a, b and c 4 bytes off a 16-byte boundary;
//   vec2       the shipped kernel (vecadd_vec_kernel, two float4s a
//              thread in 8,192 CTAs of 256) launched directly;
//   vec1/4     its design at one or four float4s a thread in CTAs of 256
//              (16,384 or 4,096 CTAs; blocked below, the tail left out);
//   T x vecU   the same at other CTA widths T and float4s a thread U;
//   stride     a grid-stride loop of one float4 a thread a step, in 8
//              CTAs of 256 an SM;
//   stream     vec2 with streaming cache hints (__ldcs, __stcs): no
//              element is read twice, and the 201 MB are four times L2.
// Each line gives the median of 25 CUDA-event runs after 5 warm-ups, the
// rate over the 201 MB moved, and how many elements of c differ in any bit
// from a + b added on the host in float32; the variants run in turns, five
// times.  Build and run from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/vecadd_variants tools/vecadd_variants.cu \
//     && build/vecadd_variants
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/vecadd.cu"

namespace variants {

constexpr int kN = 1 << 24, kBlock = 128, kGrid = kN / kBlock;

__device__ __forceinline__ float4 add4(float4 x, float4 y) {
  return make_float4(__fadd_rn(x.x, y.x), __fadd_rn(x.y, y.y),
                     __fadd_rn(x.z, y.z), __fadd_rn(x.w, y.w));
}

// n4 float4s, each thread a float4 a step of the whole grid
__global__ void __launch_bounds__(kThreads)
    stride(const float4* __restrict__ a, const float4* __restrict__ b,
           float4* c, long long n4) {
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n4;
       i += (long long)gridDim.x * kThreads)
    c[i] = add4(a[i], b[i]);
}

// two float4s a thread, loads and stores that do not stay in L1 or L2
__global__ void __launch_bounds__(kThreads)
    stream(const float4* __restrict__ a, const float4* __restrict__ b,
           float4* c) {
  const long long i = (long long)blockIdx.x * kThreads * 2 + threadIdx.x;
  const float4 a0 = __ldcs(a + i), a1 = __ldcs(a + i + kThreads);
  const float4 b0 = __ldcs(b + i), b1 = __ldcs(b + i + kThreads);
  __stcs(c + i, add4(a0, b0));
  __stcs(c + i + kThreads, add4(a1, b1));
}

// the kernel's design at T threads a CTA, U float4s a thread (n a
// multiple of 4 T U)
template <int T, int U>
__global__ void __launch_bounds__(T)
    blocked(const float4* __restrict__ a, const float4* __restrict__ b,
            float4* c) {
  const long long first = (long long)blockIdx.x * T * U + threadIdx.x;
  float4 va[U], vb[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    va[u] = a[first + T * u];
    vb[u] = b[first + T * u];
  }
#pragma unroll
  for (int u = 0; u < U; ++u) c[first + T * u] = add4(va[u], vb[u]);
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
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  std::sort(ts.begin(), ts.end());
  return ts[ts.size() / 2];
}

}  // namespace variants

int main() {
  using namespace variants;
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  const size_t bytes = (size_t)kN * 4;
  printf("device: %s, %d SMs; n = %d; kernel ctas %d\n", prop.name,
         prop.multiProcessorCount, kN, vecadd_ctas(kN, kGrid, kBlock));
  std::vector<float> ha(kN + 1), hb(kN + 1), got(kN);
  srand(42);
  for (auto& v : ha) v = rand() / (float)RAND_MAX * 8 - 4;
  for (auto& v : hb) v = rand() / (float)RAND_MAX * 8 - 4;
  float *a, *b, *c;
  cudaMalloc(&a, bytes + 16);
  cudaMalloc(&b, bytes + 16);
  cudaMalloc(&c, bytes + 16);
  cudaMemcpy(a, ha.data(), bytes + 4, cudaMemcpyHostToDevice);
  cudaMemcpy(b, hb.data(), bytes + 4, cudaMemcpyHostToDevice);
  const int sm_ctas = 8 * prop.multiProcessorCount;
  auto run = [&](int rep, const char* name, int off, auto launch) {
    cudaMemset(c, 0, bytes + 16);
    const float ms = median_ms([&] { launch(a + off, b + off, c + off); });
    const cudaError_t err = cudaGetLastError();
    cudaMemcpy(got.data(), c + off, bytes, cudaMemcpyDeviceToHost);
    long long differ = 0;
    for (int i = 0; i < kN; ++i) {
      const float want = ha[i + off] + hb[i + off];
      differ += memcmp(&got[i], &want, 4) != 0;
    }
    printf("turn %d %-20s %.5f ms  %.3f TB/s  differ %lld  %s\n", rep, name,
           ms, 3.0 * bytes / ms / 1e9, differ, cudaGetErrorString(err));
  };
  using F4 = float4;
  for (int rep = 0; rep < 5; ++rep) {
    run(rep, "element", 0, [&](const float* x, const float* y, float* z) {
      vecadd_kernel<<<kGrid, kBlock>>>(x, y, z, kN);
    });
    run(rep, "kernel", 0, [&](const float* x, const float* y, float* z) {
      launch_vecadd(x, y, z, kN, kGrid, kBlock, nullptr);
    });
    run(rep, "kernel, 4 bytes off", 1,
        [&](const float* x, const float* y, float* z) {
          launch_vecadd(x, y, z, kN, kGrid, kBlock, nullptr);
        });
    run(rep, "vec1", 0, [&](const float* x, const float* y, float* z) {
      blocked<kThreads, 1><<<kN / 4 / kThreads, kThreads>>>(
          (const F4*)x, (const F4*)y, (F4*)z);
    });
    run(rep, "vec2", 0, [&](const float* x, const float* y, float* z) {
      vecadd_vec_kernel<<<kN / 8 / kThreads, kThreads>>>(x, y, z, kN);
    });
    run(rep, "vec4", 0, [&](const float* x, const float* y, float* z) {
      blocked<kThreads, 4><<<kN / 16 / kThreads, kThreads>>>(
          (const F4*)x, (const F4*)y, (F4*)z);
    });
    run(rep, "128 x vec4", 0, [&](const float* x, const float* y, float* z) {
      blocked<128, 4><<<kN / 4 / 512, 128>>>((const F4*)x, (const F4*)y,
                                             (F4*)z);
    });
    run(rep, "512 x vec2", 0, [&](const float* x, const float* y, float* z) {
      blocked<512, 2><<<kN / 4 / 1024, 512>>>((const F4*)x, (const F4*)y,
                                              (F4*)z);
    });
    run(rep, "1024 x vec1", 0, [&](const float* x, const float* y, float* z) {
      blocked<1024, 1><<<kN / 4 / 1024, 1024>>>((const F4*)x, (const F4*)y,
                                                (F4*)z);
    });
    run(rep, "256 x vec8", 0, [&](const float* x, const float* y, float* z) {
      blocked<256, 8><<<kN / 4 / 2048, 256>>>((const F4*)x, (const F4*)y,
                                              (F4*)z);
    });
    run(rep, "stride", 0, [&](const float* x, const float* y, float* z) {
      stride<<<sm_ctas, kThreads>>>((const F4*)x, (const F4*)y, (F4*)z,
                                    kN / 4);
    });
    run(rep, "stream", 0, [&](const float* x, const float* y, float* z) {
      stream<<<kN / 8 / kThreads, kThreads>>>((const F4*)x, (const F4*)y,
                                              (F4*)z);
    });
  }
  return 0;
}
