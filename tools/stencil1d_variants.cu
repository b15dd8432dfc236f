// Times src/repro_torch/csrc/stencil1d.cu at the main path's n = 2^24
// float32 values (the chevron's 131,072 blocks of 128), beside the kernel
// it replaced and variants of its design, on one CUDA card, so that the
// choices its source note makes rest on a measurement:
//   old        the earlier kernel: a CTA of 128 threads a logical block,
//              one element a thread, a __shared__ halo loaded by the edge
//              threads behind one barrier;
//   kernel     the shipped kernel through launch_stencil1d (8 warps a
//              CTA, a warp 128 elements, four adjacent ones a lane read
//              one float an access, neighbours by shuffle), on 16-byte
//              aligned buffers and on x and y 4 bytes off a 16-byte
//              boundary;
//   F<f> W<k>  the design read and written as f float4s a lane (a warp
//              128 f elements, float4 j of lane l at 128 j + 4 l) in CTAs
//              of k warps (F1 W8 is the shipped shape in float4s);
//   copy       cudaMemcpyAsync of x into y: the same bytes read and
//              written, with no stencil.
// Every variant and the old kernel must equal `cell` (one element a
// thread, clamped loads, the shipped arithmetic) bit for bit, as must the
// kernel at n = 2^24 - 3 (the last lane's four elements ragged).
// Each line gives the median of 25 CUDA-event runs after 5 warm-ups, a
// spin on the card covering the enqueue; five turns, then each variant's
// median of its turns and its rate over the 8 bytes an element moves.
// Build and run from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/stencil1d_variants tools/stencil1d_variants.cu \
//     && build/stencil1d_variants
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <utility>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/stencil1d.cu"

namespace variants {

constexpr int kTurns = 5, kRuns = 25, kWarm = 5;
constexpr int kBlock = 128;

#define CHECK(x)                                                        \
  do {                                                                  \
    cudaError_t e_ = (x);                                               \
    if (e_ != cudaSuccess) {                                            \
      std::fprintf(stderr, "%s:%d %s\n", __FILE__, __LINE__,            \
                   cudaGetErrorString(e_));                             \
      std::exit(1);                                                     \
    }                                                                   \
  } while (0)

__device__ __forceinline__ float clamped(const float* __restrict__ x,
                                         long long i, int n) {
  return x[i < 0 ? 0 : (i >= n ? n - 1 : i)];
}

// the kernel this redesign replaced, as it was
__global__ void old_stencil(const float* __restrict__ x, float* y, int n) {
  __shared__ float s[1024 + 2];
  const int t = threadIdx.x;
  const long long gid = (long long)blockIdx.x * blockDim.x + t;
  s[t + 1] = clamped(x, gid, n);
  if (t == 0) s[0] = clamped(x, gid - 1, n);
  if (t == (int)blockDim.x - 1) s[blockDim.x + 1] = clamped(x, gid + 1, n);
  __syncthreads();
  if (gid < n)
    y[gid] = __fadd_rn(__fadd_rn(__fmul_rn(0.25f, s[t]),
                                 __fmul_rn(0.5f, s[t + 1])),
                       __fmul_rn(0.25f, s[t + 2]));
}

// one element a thread, clamped loads, the shipped arithmetic: the
// reference
__global__ void cell(const float* __restrict__ x, float* y, int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    y[i] = stencil(clamped(x, i - 1, n), x[i], clamped(x, i + 1, n));
}

// the shipped design with F float4s a lane and W warps a CTA (n a
// multiple of 128 F W here, buffers aligned)
template <int F, int W>
__global__ void __launch_bounds__(W * 32)
    design(const float* __restrict__ x, float* y, int n) {
  const int lane = threadIdx.x & 31;
  const long long w0 =
      ((long long)blockIdx.x * W + threadIdx.x / 32) * 128 * F;
  float c[F][4];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const float4 q =
        *reinterpret_cast<const float4*>(x + w0 + 128 * f + 4 * lane);
    c[f][0] = q.x, c[f][1] = q.y, c[f][2] = q.z, c[f][3] = q.w;
  }
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const long long i0 = w0 + 128 * f + 4 * lane;
    float we = __shfl_up_sync(0xffffffffu, c[f][3], 1);
    float ea = __shfl_down_sync(0xffffffffu, c[f][0], 1);
    if (lane == 0) we = x[i0 > 0 ? i0 - 1 : 0];
    if (lane == 31) ea = x[min(i0 + 4, n - 1LL)];
    float out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[e] = stencil(e ? c[f][e - 1] : we, c[f][e],
                       e < 3 ? c[f][e + 1] : ea);
    *reinterpret_cast<float4*>(y + i0) =
        make_float4(out[0], out[1], out[2], out[3]);
  }
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

using Fn = std::function<void(const Bufs&, int)>;

template <int F, int W>
std::pair<std::string, Fn> variant() {
  char name[32];
  std::snprintf(name, sizeof name, "F%d W%d", F, W);
  return {name, [](const Bufs& b, int n) {
            design<F, W><<<n / (128 * F * W), W * 32>>>(b.x, b.y, n);
          }};
}

int ctas_of(int n) {
  return (n + stencil1d_cta_elems() - 1) / stencil1d_cta_elems();
}

void launch(const Bufs& b, int n) {
  const int grid = (n + kBlock - 1) / kBlock;
  CHECK((cudaError_t)launch_stencil1d(b.x, b.y, n, grid, kBlock, ctas_of(n),
                                      nullptr));
}

// the kernel against `cell` at n (once, untimed); 1 if they differ
int check(const float* x, float* y, float* ref, int n) {
  std::vector<float> want(n), got(n);
  cell<<<(n + 127) / 128, 128>>>(x, ref, n);
  CHECK(cudaMemset(y, 0, (size_t)n * 4));
  launch(Bufs{x, y}, n);
  CHECK(cudaDeviceSynchronize());
  CHECK(cudaMemcpy(want.data(), ref, (size_t)n * 4, cudaMemcpyDeviceToHost));
  CHECK(cudaMemcpy(got.data(), y, (size_t)n * 4, cudaMemcpyDeviceToHost));
  if (std::memcmp(got.data(), want.data(), (size_t)n * 4) == 0) return 0;
  std::printf("MISMATCH n = %d kernel\n", n);
  return 1;
}

int run(int n) {
  std::vector<float> hx(n);
  srand(42);
  for (int i = 0; i < n; ++i) hx[i] = 2.0f * (float)rand() / RAND_MAX - 1.0f;
  // x, y, and the same two 4 bytes past a 16-byte boundary
  float *x, *y, *x1, *y1, *ref;
  for (float** b : {&x, &y, &ref}) CHECK(cudaMalloc(b, (size_t)n * 4));
  for (float** b : {&x1, &y1}) CHECK(cudaMalloc(b, (size_t)n * 4 + 16));
  x1 += 1, y1 += 1;
  CHECK(cudaMemcpy(x, hx.data(), (size_t)n * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(x1, hx.data(), (size_t)n * 4, cudaMemcpyHostToDevice));
  int bad = check(x, y, ref, n) + check(x, y, ref, n - 3);
  cell<<<(n + 127) / 128, 128>>>(x, ref, n);
  std::vector<float> want(n), got(n);
  CHECK(cudaMemcpy(want.data(), ref, (size_t)n * 4, cudaMemcpyDeviceToHost));

  const int ctas = ctas_of(n);
  std::vector<std::pair<std::string, Fn>> vs = {
      {"old",
       [](const Bufs& b, int n) {
         old_stencil<<<(n + kBlock - 1) / kBlock, kBlock>>>(b.x, b.y, n);
       }},
      {"kernel", launch},
      variant<1, 8>(), variant<2, 8>(), variant<1, 4>(), variant<1, 16>(),
      variant<2, 4>(), variant<2, 16>(),
      {"copy",
       [](const Bufs& b, int n) {
         CHECK(cudaMemcpyAsync(b.y, b.x, (size_t)n * 4,
                               cudaMemcpyDeviceToDevice));
       }},
  };
  const int nv = (int)vs.size();
  std::vector<std::vector<float>> ts(nv + 1);
  for (int turn = 0; turn < kTurns; ++turn) {
    for (int v = 0; v <= nv; ++v) {
      // the last is the shipped kernel on buffers 4 bytes off
      const bool off = v == nv;
      const Bufs b = off ? Bufs{x1, y1} : Bufs{x, y};
      const Fn& f = vs[off ? 1 : v].second;
      CHECK(cudaMemset(b.y, 0, (size_t)n * 4));
      f(b, n);
      CHECK(cudaDeviceSynchronize());
      if (turn == 0 && (off || vs[v].first != "copy")) {
        CHECK(cudaMemcpy(got.data(), b.y, (size_t)n * 4,
                         cudaMemcpyDeviceToHost));
        if (std::memcmp(got.data(), want.data(), (size_t)n * 4) != 0)
          ++bad, std::printf("MISMATCH n = %d %s\n", n,
                             off ? "kernel off16" : vs[v].first.c_str());
      }
      ts[v].push_back(time_ms([&] { f(b, n); }));
    }
  }
  std::printf("\nn = %d, block %d (kernel: %d CTAs; bound %.6f ms at 3.35 "
              "TB/s)\n", n, kBlock, ctas, 8.0 * n / 3.35e12 * 1e3);
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
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("card: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const int bad = variants::run(1 << 24);
  std::printf("\nstencil1d_variants: %s\n",
              bad ? "MISMATCH"
                  : "every variant, the old kernel and the kernel at a "
                    "ragged n equal `cell` bit for bit");
  return bad ? 1 : 0;
}
