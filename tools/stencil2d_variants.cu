// Times src/repro_torch/csrc/stencil2d.cu at the main path's 4096 x 4096
// float32 array (the chevron's (512, 512) tiles of 8 x 8) and at
// 2048 x 2048, beside the kernel it replaced and variants of its design,
// on one CUDA card, so that the choices its source note makes rest on a
// measurement:
//   old        the earlier kernel: a CTA of 8 x 8 threads a logical tile, a
//              10 x 10 __shared__ halo tile behind one barrier, one cell a
//              thread;
//   kernel     the shipped kernel through launch_stencil2d (8 warps a CTA,
//              each 1 row x 128 columns, a float4 a lane a row, neighbours
//              by shuffle), 16-byte aligned, and with x and y 4 bytes off a
//              16-byte boundary (one float an access);
//   R<r> W<k>  the design written again with strips of r rows a warp (the
//              r + 2 rows it needs held in registers, each row loaded once
//              by the warp) and k warps a CTA (R1 W8 is the shipped shape);
//   copy       cudaMemcpyAsync of x into y: the same bytes read and
//              written, with no stencil and no halo.
// Every variant must equal `cell` (one cell a thread, clamped loads, the
// shipped arithmetic) bit for bit, and the old kernel too: it adds in the
// same order with the same intrinsics.  Each line gives the median of 25
// CUDA-event runs after 5 warm-ups, a spin on the card covering the
// enqueue; five turns, then each variant's median of its turns and its
// rate over the 8 bytes a cell moves.  Build and run from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/stencil2d_variants tools/stencil2d_variants.cu \
//     && build/stencil2d_variants
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <utility>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/stencil2d.cu"

namespace variants {

constexpr int kTurns = 5, kRuns = 25, kWarm = 5;

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
__global__ void old_tile(const float* __restrict__ x, float* y, int h,
                         int w) {
  __shared__ float s[10][10];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.y * 8 + ty;
  const int col = blockIdx.x * 8 + tx;
  auto at = [&](int r, int c) {
    r = min(max(r, 0), h - 1);
    c = min(max(c, 0), w - 1);
    return x[(size_t)r * w + c];
  };
  s[ty + 1][tx + 1] = at(row, col);
  if (ty == 0) s[0][tx + 1] = at(row - 1, col);
  if (ty == 7) s[9][tx + 1] = at(row + 1, col);
  if (tx == 0) s[ty + 1][0] = at(row, col - 1);
  if (tx == 7) s[ty + 1][9] = at(row, col + 1);
  __syncthreads();
  if (row < h && col < w) {
    float v = __fadd_rn(s[ty + 1][tx + 1], s[ty][tx + 1]);
    v = __fadd_rn(v, s[ty + 2][tx + 1]);
    v = __fadd_rn(v, s[ty + 1][tx]);
    v = __fadd_rn(v, s[ty + 1][tx + 2]);
    y[(size_t)row * w + col] = __fmul_rn(0.2f, v);
  }
}

// one cell a thread, clamped loads, the shipped arithmetic: the reference
__global__ void cell(const float* __restrict__ x, float* y, int h, int w) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x, r = blockIdx.y;
  if (c >= w) return;
  auto at = [&](int rr, int cc) {
    return x[(size_t)min(max(rr, 0), h - 1) * w + min(max(cc, 0), w - 1)];
  };
  y[(size_t)r * w + c] = stencil(at(r, c), at(r - 1, c), at(r + 1, c),
                                 at(r, c - 1), at(r, c + 1));
}

// the shipped design with R rows a warp and W warps a CTA (float4s; h a
// multiple of R W, w of 128 here): the warp loads its R + 2 rows once
template <int R, int W>
__global__ void __launch_bounds__(W * 32)
    strips(const float* __restrict__ x, float* y, int h, int w) {
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * R * W + (threadIdx.x >> 5) * R;
  const int c0 = blockIdx.x * 128 + lane * 4;
  float v[R + 2][4];
#pragma unroll
  for (int i = 0; i < R + 2; ++i)
    load_cols<true>(x, min(max(r0 - 1 + i, 0), h - 1), c0, w, v[i]);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float* row = x + (size_t)(r0 + i) * w;
    float we = __shfl_up_sync(0xffffffffu, v[i + 1][3], 1);
    float ea = __shfl_down_sync(0xffffffffu, v[i + 1][0], 1);
    if (lane == 0) we = row[max(c0 - 1, 0)];
    if (lane == 31) ea = row[min(c0 + 4, w - 1)];
    float out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[e] = stencil(v[i + 1][e], v[i][e], v[i + 2][e],
                       e ? v[i + 1][e - 1] : we,
                       e < 3 ? v[i + 1][e + 1] : ea);
    *reinterpret_cast<float4*>(y + (size_t)(r0 + i) * w + c0) =
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

using Fn = std::function<void(const Bufs&, int, int)>;

template <int R, int W>
std::pair<std::string, Fn> design() {
  char name[32];
  std::snprintf(name, sizeof name, "R%d W%d", R, W);
  return {name, [](const Bufs& b, int h, int w) {
            strips<R, W><<<dim3(w / 128, h / (R * W)), W * 32>>>(b.x, b.y,
                                                                 h, w);
          }};
}

int run(int h, int w) {
  const size_t cells = (size_t)h * w;
  std::vector<float> hx(cells);
  srand(42);
  for (size_t i = 0; i < cells; ++i)
    hx[i] = 2.0f * (float)rand() / RAND_MAX - 1.0f;
  // x, y, and the same two 4 bytes past a 16-byte boundary
  float *x, *y, *x1, *y1, *ref;
  for (float** b : {&x, &y, &ref}) CHECK(cudaMalloc(b, cells * 4));
  for (float** b : {&x1, &y1}) CHECK(cudaMalloc(b, cells * 4 + 16));
  x1 += 1, y1 += 1;
  CHECK(cudaMemcpy(x, hx.data(), cells * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(x1, hx.data(), cells * 4, cudaMemcpyHostToDevice));
  cell<<<dim3((w + 127) / 128, h), 128>>>(x, ref, h, w);
  std::vector<float> want(cells), got(cells);
  CHECK(cudaMemcpy(want.data(), ref, cells * 4, cudaMemcpyDeviceToHost));

  const int cx = (w + stencil2d_cta_cols() - 1) / stencil2d_cta_cols();
  const int cy = (h + stencil2d_cta_rows() - 1) / stencil2d_cta_rows();
  std::vector<std::pair<std::string, Fn>> vs = {
      {"old",
       [](const Bufs& b, int h, int w) {
         old_tile<<<dim3(w / 8, h / 8), dim3(8, 8)>>>(b.x, b.y, h, w);
       }},
      {"kernel",
       [=](const Bufs& b, int h, int w) {
         CHECK((cudaError_t)launch_stencil2d(b.x, b.y, h, w, w / 8, h / 8,
                                             cx, cy, nullptr));
       }},
      design<1, 8>(), design<2, 8>(), design<4, 8>(), design<1, 4>(),
      design<1, 16>(), design<2, 4>(), design<4, 4>(),
      {"copy",
       [](const Bufs& b, int h, int w) {
         CHECK(cudaMemcpyAsync(b.y, b.x, (size_t)h * w * 4,
                               cudaMemcpyDeviceToDevice));
       }},
  };
  const int nv = (int)vs.size();
  int bad = 0;
  std::vector<std::vector<float>> ts(nv + 1);
  for (int turn = 0; turn < kTurns; ++turn) {
    for (int v = 0; v <= nv; ++v) {
      // the last is the shipped kernel on buffers 4 bytes off
      const bool off = v == nv;
      const Bufs b = off ? Bufs{x1, y1} : Bufs{x, y};
      const Fn& f = vs[off ? 1 : v].second;
      CHECK(cudaMemset(b.y, 0, cells * 4));
      f(b, h, w);
      CHECK(cudaDeviceSynchronize());
      if (turn == 0 && (off || vs[v].first != "copy")) {
        CHECK(cudaMemcpy(got.data(), b.y, cells * 4,
                         cudaMemcpyDeviceToHost));
        if (std::memcmp(got.data(), want.data(), cells * 4) != 0)
          ++bad, std::printf("MISMATCH %dx%d %s\n", h, w,
                             off ? "kernel off16" : vs[v].first.c_str());
      }
      ts[v].push_back(time_ms([&] { f(b, h, w); }));
    }
  }
  std::printf("\n%d x %d (kernel: %d x %d CTAs; bound %.6f ms at 3.35 TB/s)\n",
              h, w, cx, cy, 8.0 * cells / 3.35e12 * 1e3);
  for (int v = 0; v <= nv; ++v) {
    const float m = median(ts[v]);
    std::printf("  %-14s %9.6f ms  %7.1f GB/s\n",
                v == nv ? "kernel off16" : vs[v].first.c_str(), m,
                8.0 * cells / (m * 1e-3) / 1e9);
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
  const int bad = variants::run(4096, 4096) + variants::run(2048, 2048);
  std::printf("\nstencil2d_variants: %s\n",
              bad ? "MISMATCH"
                  : "every variant and the old kernel equal `cell` bit for "
                    "bit");
  return bad ? 1 : 0;
}
