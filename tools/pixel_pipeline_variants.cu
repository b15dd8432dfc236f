// Times src/repro_torch/csrc/pixel_pipeline.cu at the main path's n = 2^24
// float32 pixels in [0.5, 2) (the chevron's 131,072 blocks of 128), beside
// the kernel it replaced and variants of its design, on one CUDA card, so
// that the choices its source note makes rest on a measurement:
//   old        the earlier kernel: a CTA of 128 threads a logical block,
//              one element a thread, logf into a __shared__ cell, two
//              barriers, expf of the cell;
//   kernel     the shipped kernel through launch_pixel_pipeline (8 warps
//              a CTA, a warp 128 elements, four adjacent ones a lane read
//              one float an access), on 16-byte aligned buffers and on img
//              and out 4 bytes off a 16-byte boundary;
//   one W<k>   the shipped design in CTAs of k warps;
//   float4 W8  the design read and written as one float4 a lane;
//   copy       cudaMemcpyAsync of img into out: the same bytes read and
//              written, with no arithmetic.
// Every variant, the kernel off 16 bytes and the kernel at n = 2^24 - 3
// (the last lane's four elements ragged) must equal the old kernel bit for
// bit.  Each line gives the median of 25 CUDA-event runs after 5
// warm-ups, a spin on the card covering the enqueue; five turns, then each
// variant's median of its turns and its rate over the 8 bytes an element
// moves.  Build and run from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/pixel_pipeline_variants tools/pixel_pipeline_variants.cu \
//     && build/pixel_pipeline_variants
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <utility>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/pixel_pipeline.cu"

namespace variants {

constexpr int kTurns = 5, kRuns = 25, kWarm = 5;
constexpr int kBlock = 128;
constexpr float kC0 = 0.85f, kC1 = 0.1f;

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
__global__ void old_pixel(const float* __restrict__ img, float* out,
                          float c0, float c1) {
  __shared__ float buf[1024];
  const int t = threadIdx.x;
  const size_t gid = (size_t)blockIdx.x * blockDim.x + t;
  buf[t] = logf(img[gid]);
  __syncthreads();
  buf[t] = __fadd_rn(__fmul_rn(buf[t], c0), c1);
  __syncthreads();
  out[gid] = expf(buf[t]);
}

// the design read and written as one float4 a lane (n a multiple of 1024,
// buffers aligned)
__global__ void __launch_bounds__(256)
    float4_lane(const float* __restrict__ img, float* out, float c0,
                float c1) {
  const long long i0 = ((long long)blockIdx.x * 8 + threadIdx.x / 32) * 128 +
                       (threadIdx.x & 31) * 4;
  const float4 q = *reinterpret_cast<const float4*>(img + i0);
  *reinterpret_cast<float4*>(out + i0) =
      make_float4(pixel(q.x, c0, c1), pixel(q.y, c0, c1), pixel(q.z, c0, c1),
                  pixel(q.w, c0, c1));
}

__global__ void spin(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

struct Bufs {
  const float* img;
  float* out;
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

template <int W>
std::pair<std::string, Fn> warps() {
  char name[32];
  std::snprintf(name, sizeof name, "one W%d", W);
  return {name, [](const Bufs& b, int n) {
            pixel_pipeline_warps<W><<<n / (128 * W), W * 32>>>(b.img, b.out,
                                                               kC0, kC1, n);
          }};
}

int ctas_of(int m) {
  return (m + pixel_pipeline_cta_elems() - 1) / pixel_pipeline_cta_elems();
}

// the shipped kernel over m = grid block elements, grid = m / kBlock
void launch(const Bufs& b, int m) {
  CHECK((cudaError_t)launch_pixel_pipeline(b.img, b.out, kC0, kC1,
                                           m / kBlock, kBlock, ctas_of(m),
                                           nullptr));
}

// the kernel against the old one over m elements of block 1 (once,
// untimed); out past m must keep its zeros; 1 if they differ
int check_ragged(const float* img, float* out, float* ref, int n, int m) {
  std::vector<float> want(n), got(n);
  CHECK(cudaMemset(ref, 0, (size_t)n * 4));
  CHECK(cudaMemset(out, 0, (size_t)n * 4));
  old_pixel<<<m, 1>>>(img, ref, kC0, kC1);
  CHECK((cudaError_t)launch_pixel_pipeline(img, out, kC0, kC1, m, 1,
                                           ctas_of(m), nullptr));
  CHECK(cudaDeviceSynchronize());
  CHECK(cudaMemcpy(want.data(), ref, (size_t)n * 4, cudaMemcpyDeviceToHost));
  CHECK(cudaMemcpy(got.data(), out, (size_t)n * 4, cudaMemcpyDeviceToHost));
  if (std::memcmp(got.data(), want.data(), (size_t)n * 4) == 0) return 0;
  std::printf("MISMATCH m = %d kernel\n", m);
  return 1;
}

int run(int n) {
  std::vector<float> hx(n);
  srand(42);
  for (int i = 0; i < n; ++i)
    hx[i] = 0.5f + 1.5f * ((float)rand() / ((float)RAND_MAX + 1.0f));
  // img, out, and the same two 4 bytes past a 16-byte boundary
  float *img, *out, *img1, *out1, *ref;
  for (float** b : {&img, &out, &ref}) CHECK(cudaMalloc(b, (size_t)n * 4));
  for (float** b : {&img1, &out1}) CHECK(cudaMalloc(b, (size_t)n * 4 + 16));
  img1 += 1, out1 += 1;
  CHECK(cudaMemcpy(img, hx.data(), (size_t)n * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(img1, hx.data(), (size_t)n * 4, cudaMemcpyHostToDevice));
  int bad = check_ragged(img, out, ref, n, n - 3);
  old_pixel<<<n / kBlock, kBlock>>>(img, ref, kC0, kC1);
  std::vector<float> want(n), got(n);
  CHECK(cudaMemcpy(want.data(), ref, (size_t)n * 4, cudaMemcpyDeviceToHost));

  std::vector<std::pair<std::string, Fn>> vs = {
      {"old",
       [](const Bufs& b, int n) {
         old_pixel<<<n / kBlock, kBlock>>>(b.img, b.out, kC0, kC1);
       }},
      {"kernel", launch},
      warps<4>(), warps<8>(), warps<16>(),
      {"float4 W8",
       [](const Bufs& b, int n) {
         float4_lane<<<n / 1024, 256>>>(b.img, b.out, kC0, kC1);
       }},
      {"copy",
       [](const Bufs& b, int n) {
         CHECK(cudaMemcpyAsync(b.out, b.img, (size_t)n * 4,
                               cudaMemcpyDeviceToDevice));
       }},
  };
  const int nv = (int)vs.size();
  std::vector<std::vector<float>> ts(nv + 1);
  for (int turn = 0; turn < kTurns; ++turn) {
    for (int v = 0; v <= nv; ++v) {
      // the last is the shipped kernel on buffers 4 bytes off
      const bool off = v == nv;
      const Bufs b = off ? Bufs{img1, out1} : Bufs{img, out};
      const Fn& f = vs[off ? 1 : v].second;
      CHECK(cudaMemset(b.out, 0, (size_t)n * 4));
      f(b, n);
      CHECK(cudaDeviceSynchronize());
      if (turn == 0 && (off || vs[v].first != "copy")) {
        CHECK(cudaMemcpy(got.data(), b.out, (size_t)n * 4,
                         cudaMemcpyDeviceToHost));
        if (std::memcmp(got.data(), want.data(), (size_t)n * 4) != 0)
          ++bad, std::printf("MISMATCH n = %d %s\n", n,
                             off ? "kernel off16" : vs[v].first.c_str());
      }
      ts[v].push_back(time_ms([&] { f(b, n); }));
    }
  }
  std::printf("\nn = %d, block %d (kernel: %d CTAs; bound %.6f ms at 3.35 "
              "TB/s)\n", n, kBlock, ctas_of(n), 8.0 * n / 3.35e12 * 1e3);
  for (int v = 0; v <= nv; ++v) {
    const float m = median(ts[v]);
    std::printf("  %-14s %9.6f ms  %7.1f GB/s\n",
                v == nv ? "kernel off16" : vs[v].first.c_str(), m,
                8.0 * n / (m * 1e-3) / 1e9);
  }
  for (float* b : {img, out, ref}) CHECK(cudaFree(b));
  for (float* b : {img1, out1}) CHECK(cudaFree(b - 1));
  return bad;
}

}  // namespace variants

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("card: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const int bad = variants::run(1 << 24);
  std::printf("\npixel_pipeline_variants: %s\n",
              bad ? "MISMATCH"
                  : "every variant, the kernel off 16 bytes and the kernel "
                    "at a ragged m equal the old kernel bit for bit");
  return bad ? 1 : 0;
}
