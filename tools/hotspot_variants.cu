// Times src/repro_torch/csrc/hotspot.cu at the main path's 1024 x 1024
// float32 grid (the chevron's (128, 128) tiles of 8 x 8) and at 4096 x 4096,
// where t, p and t_out (192 MB) no longer fit in the 50 MB L2, beside the
// kernel it replaced and variants of its design, on one CUDA card, so that
// the choices its source note makes rest on a measurement:
//   old        the earlier kernel: a CTA of 8 x 8 threads a logical tile, a
//              10 x 10 __shared__ halo tile, one cell a thread, its
//              arithmetic contracted into FMAs by nvcc;
//   kernel     the shipped kernel through launch_hotspot (8 warps a CTA,
//              each a strip of 1 row x 128 columns, a float4 a lane a
//              row, neighbours by shuffle), 16-byte aligned, and with t, p
//              and t_out 4 bytes off a 16-byte boundary (one float an
//              access);
//   R<r> W<k>  the design written again with strips of r rows and k warps
//              a CTA (R1 W8 is the shipped shape);
//   smem       a CTA of 256 threads stages a 34 x 130 haloed region of t
//              (32 x 128 cells) in __shared__ by float4s, one barrier,
//              then computes a float4 a thread a row from it: the halo
//              staged once for the region.
// The old kernel's FMAs round differently, so it is held within 1e-4 of
// `cell` (one cell a thread, the plain version's order, each operation
// rounded alone); every other variant must equal `cell` bit for bit, and
// keep t_out's input past nothing (the grid covers the array).  Each line
// gives the median of 25 CUDA-event runs after 5 warm-ups, a spin on the
// card covering the enqueue; five turns, then each variant's median of its
// turns and its rate over the 12 bytes a cell moved.  Build and run from
// the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/hotspot_variants tools/hotspot_variants.cu \
//     && build/hotspot_variants
#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <utility>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/hotspot.cu"

namespace variants {

constexpr int kTurns = 5, kRuns = 25, kWarm = 5;
constexpr float kCap = 0.5f, kRx = 0.1f, kRy = 0.1f, kRz = 0.05f,
                kAmb = 80.0f;

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
__global__ void old_tile(const float* __restrict__ t,
                         const float* __restrict__ p, float* t_out, int h,
                         int w, float cap, float rx, float ry, float rz,
                         float amb) {
  __shared__ float s[10][10];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.y * 8 + ty;
  const int col = blockIdx.x * 8 + tx;
  auto at = [&](int r, int c) {
    r = min(max(r, 0), h - 1);
    c = min(max(c, 0), w - 1);
    return t[(size_t)r * w + c];
  };
  s[ty + 1][tx + 1] = at(row, col);
  if (ty == 0) s[0][tx + 1] = at(row - 1, col);
  if (ty == 7) s[9][tx + 1] = at(row + 1, col);
  if (tx == 0) s[ty + 1][0] = at(row, col - 1);
  if (tx == 7) s[ty + 1][9] = at(row, col + 1);
  __syncthreads();
  if (row < h && col < w) {
    const float tc = s[ty + 1][tx + 1];
    const float v = tc + cap * (p[(size_t)row * w + col]
        + ry * (s[ty][tx + 1] + s[ty + 2][tx + 1] - 2.0f * tc)
        + rx * (s[ty + 1][tx] + s[ty + 1][tx + 2] - 2.0f * tc)
        + rz * (amb - tc));
    t_out[(size_t)row * w + col] = v;
  }
}

// one cell a thread, clamped loads, the shipped arithmetic: the reference
__global__ void cell(const float* __restrict__ t, const float* __restrict__ p,
                     float* t_out, int h, int w, Coeffs k) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x, r = blockIdx.y;
  if (c >= w) return;
  auto at = [&](int rr, int cc) {
    return t[(size_t)min(max(rr, 0), h - 1) * w + min(max(cc, 0), w - 1)];
  };
  t_out[(size_t)r * w + c] =
      step(at(r, c), p[(size_t)r * w + c], at(r - 1, c), at(r + 1, c),
           at(r, c - 1), at(r, c + 1), k);
}

// the shipped design with R rows a warp and W warps a CTA (float4s; h a
// multiple of R W, w of 128 here)
template <int R, int W>
__global__ void __launch_bounds__(W * 32)
    strips(const float* __restrict__ t, const float* __restrict__ p,
           float* t_out, int h, int w, Coeffs k) {
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * R * W + (threadIdx.x >> 5) * R;
  const int c0 = blockIdx.x * 128 + lane * 4;
  float v[R + 2][4], pv[R][4];
#pragma unroll
  for (int i = 0; i < R + 2; ++i)
    load_cols<true>(t, min(max(r0 - 1 + i, 0), h - 1), c0, w, v[i]);
#pragma unroll
  for (int i = 0; i < R; ++i) load_cols<true>(p, r0 + i, c0, w, pv[i]);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float* row = t + (size_t)(r0 + i) * w;
    float we = __shfl_up_sync(0xffffffffu, v[i + 1][3], 1);
    float ea = __shfl_down_sync(0xffffffffu, v[i + 1][0], 1);
    if (lane == 0) we = row[max(c0 - 1, 0)];
    if (lane == 31) ea = row[min(c0 + 4, w - 1)];
    float out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[e] = step(v[i + 1][e], pv[i][e], v[i][e], v[i + 2][e],
                    e ? v[i + 1][e - 1] : we, e < 3 ? v[i + 1][e + 1] : ea,
                    k);
    *reinterpret_cast<float4*>(t_out + (size_t)(r0 + i) * w + c0) =
        make_float4(out[0], out[1], out[2], out[3]);
  }
}

// 32 x 128 cells a CTA of 256 through a haloed __shared__ region; the
// interior starts at column 4 so that its float4s are aligned
__global__ void __launch_bounds__(256)
    smem(const float* __restrict__ t, const float* __restrict__ p,
         float* t_out, int h, int w, Coeffs k) {
  __shared__ __align__(16) float s[34][136];
  const int rb = blockIdx.y * 32, cb = blockIdx.x * 128;
  for (int i = threadIdx.x; i < 34 * 32; i += 256) {
    const int r = min(max(rb - 1 + i / 32, 0), h - 1);
    *reinterpret_cast<float4*>(&s[i / 32][4 + (i % 32) * 4]) =
        *reinterpret_cast<const float4*>(t + (size_t)r * w + cb +
                                         (i % 32) * 4);
  }
  if (threadIdx.x < 68) {
    const int i = threadIdx.x % 34, side = threadIdx.x / 34;
    const int r = min(max(rb - 1 + i, 0), h - 1);
    const int c = side ? min(cb + 128, w - 1) : max(cb - 1, 0);
    s[i][side ? 132 : 3] = t[(size_t)r * w + c];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31, r0 = (threadIdx.x >> 5) * 4;
  const int sc = 4 + lane * 4;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int sr = r0 + i + 1;
    const float4 pc = *reinterpret_cast<const float4*>(
        p + (size_t)(rb + r0 + i) * w + cb + lane * 4);
    const float pe[4] = {pc.x, pc.y, pc.z, pc.w};
    float out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[e] = step(s[sr][sc + e], pe[e], s[sr - 1][sc + e],
                    s[sr + 1][sc + e], s[sr][sc + e - 1], s[sr][sc + e + 1],
                    k);
    *reinterpret_cast<float4*>(t_out + (size_t)(rb + r0 + i) * w + cb +
                               lane * 4) =
        make_float4(out[0], out[1], out[2], out[3]);
  }
}

__global__ void spin(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

struct Bufs {
  const float *t, *p;
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

template <int R, int W>
std::pair<std::string, std::function<void(const Bufs&, int, int)>> design() {
  char name[32];
  std::snprintf(name, sizeof name, "R%d W%d", R, W);
  return {name, [](const Bufs& b, int h, int w) {
            strips<R, W><<<dim3(w / 128, h / (R * W)), W * 32>>>(
                b.t, b.p, b.out, h, w, Coeffs{kCap, kRx, kRy, kRz, kAmb});
          }};
}

int run(int h, int w) {
  const size_t cells = (size_t)h * w;
  std::vector<float> ht(cells), hp(cells);
  srand(42);
  for (size_t i = 0; i < cells; ++i) {
    ht[i] = 60.0f + 40.0f * (float)rand() / RAND_MAX;
    hp[i] = (float)rand() / RAND_MAX;
  }
  // t, p, out, and the same three 4 bytes past a 16-byte boundary
  float *t, *p, *out, *t1, *p1, *out1, *ref;
  for (float** b : {&t, &p, &out, &ref}) CHECK(cudaMalloc(b, cells * 4));
  for (float** b : {&t1, &p1, &out1}) CHECK(cudaMalloc(b, cells * 4 + 16));
  t1 += 1, p1 += 1, out1 += 1;
  CHECK(cudaMemcpy(t, ht.data(), cells * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(p, hp.data(), cells * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(t1, ht.data(), cells * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(p1, hp.data(), cells * 4, cudaMemcpyHostToDevice));
  const Coeffs k{kCap, kRx, kRy, kRz, kAmb};
  cell<<<dim3((w + 127) / 128, h), 128>>>(t, p, ref, h, w, k);
  std::vector<float> want(cells), got(cells);
  CHECK(cudaMemcpy(want.data(), ref, cells * 4, cudaMemcpyDeviceToHost));

  const int cx = (w + hotspot_cta_cols() - 1) / hotspot_cta_cols();
  const int cy = (h + hotspot_cta_rows() - 1) / hotspot_cta_rows();
  using Fn = std::function<void(const Bufs&, int, int)>;
  std::vector<std::pair<std::string, Fn>> vs = {
      {"old",
       [](const Bufs& b, int h, int w) {
         old_tile<<<dim3(w / 8, h / 8), dim3(8, 8)>>>(
             b.t, b.p, b.out, h, w, kCap, kRx, kRy, kRz, kAmb);
       }},
      {"kernel",
       [=](const Bufs& b, int h, int w) {
         CHECK((cudaError_t)launch_hotspot(b.t, b.p, b.out, h, w, kCap, kRx,
                                           kRy, kRz, kAmb, w / 8, h / 8, cx,
                                           cy, nullptr));
       }},
      design<1, 8>(), design<2, 8>(), design<4, 8>(), design<8, 8>(),
      design<4, 4>(), design<4, 16>(), design<2, 16>(),
      {"smem",
       [](const Bufs& b, int h, int w) {
         smem<<<dim3(w / 128, h / 32), 256>>>(
             b.t, b.p, b.out, h, w, Coeffs{kCap, kRx, kRy, kRz, kAmb});
       }},
  };
  const int nv = (int)vs.size();
  int bad = 0;
  std::vector<std::vector<float>> ts(nv + 1);
  for (int turn = 0; turn < kTurns; ++turn) {
    for (int v = 0; v <= nv; ++v) {
      // the last is the shipped kernel on buffers 4 bytes off
      const bool off = v == nv;
      const Bufs b = off ? Bufs{t1, p1, out1} : Bufs{t, p, out};
      const Fn& f = vs[off ? 1 : v].second;
      CHECK(cudaMemset(b.out, 0, cells * 4));
      f(b, h, w);
      CHECK(cudaDeviceSynchronize());
      if (turn == 0) {
        CHECK(cudaMemcpy(got.data(), b.out, cells * 4,
                         cudaMemcpyDeviceToHost));
        double err = 0;
        for (size_t i = 0; i < cells; ++i)
          err = std::max(err, (double)std::fabs(got[i] - want[i]));
        const bool same = std::equal(
            got.begin(), got.end(), want.begin(),
            [](float a, float b) { return std::memcmp(&a, &b, 4) == 0; });
        if (v == 0 ? err > 1e-4 : !same)
          ++bad, std::printf("MISMATCH %dx%d %s: max abs err %g\n", h, w,
                             off ? "kernel off16" : vs[v].first.c_str(),
                             err);
      }
      ts[v].push_back(time_ms([&] { f(b, h, w); }));
    }
  }
  std::printf("\n%d x %d (kernel: %d x %d CTAs; bound %.6f ms at 3.35 TB/s)\n",
              h, w, cx, cy, 12.0 * cells / 3.35e12 * 1e3);
  for (int v = 0; v <= nv; ++v) {
    const float m = median(ts[v]);
    std::printf("  %-14s %9.6f ms  %7.1f GB/s\n",
                v == nv ? "kernel off16" : vs[v].first.c_str(), m,
                12.0 * cells / (m * 1e-3) / 1e9);
  }
  for (float* b : {t, p, out, ref}) CHECK(cudaFree(b));
  for (float* b : {t1, p1, out1}) CHECK(cudaFree(b - 1));
  return bad;
}

}  // namespace variants

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("card: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const int bad = variants::run(1024, 1024) + variants::run(4096, 4096);
  std::printf("\nhotspot_variants: %s\n",
              bad ? "MISMATCH"
                  : "every variant equals `cell` bit for bit, the old "
                    "kernel within 1e-4");
  return bad ? 1 : 0;
}
