// Times src/repro_torch/csrc/rmsnorm.cu at the main path's x[8192, 2048]
// beside the kernel it replaced and variants of its design, on one CUDA
// card, so that the choices its source note makes rest on a measurement
// (then its wide path, below):
//   two-pass   the earlier kernel, copied below as it was: a block of
//              grain = 8 rows, a warp a row, one pass over the row to sum
//              its squares and a second (from L1 or L2) to scale it, 1 +
//              scale read a value at a time;
//   kernel     the shipped kernel through its launcher (the row in a
//              lane's registers, 1 + scale read from L1 as each chunk is
//              scaled, the last chunk predicated on d), 16-byte aligned,
//              and with x and out one element off a 16-byte boundary (its
//              two-pass instantiation of one element a load);
//   first      the kernel's first text: 1 + scale staged once a CTA in
//              shared memory behind a barrier, every chunk predicated on
//              d (`first` below);
//   wide       the launcher's instantiation for rows wider than its
//              switch (two passes, 16-byte loads, 8 rows a CTA), called
//              at this width;
//   knobs      the kernel's design with no predicate (`design` below),
//              one knob turned: 1 + scale staged once a CTA in shared
//              memory behind a barrier (staged), and with two rows a
//              warp, all their loads issued before the first row's sum
//              (staged rows2); 1 + scale from L1 as in the kernel
//              (l1-scale), and under a register cap for two CTAs an SM
//              (l1-scale occ2);
//   pipe       a warp walks rows a grid's warps apart in CTAs that fill
//              the SMs once, the next row's loads issued before this row
//              is summed;
//   scale-regs no shared memory and no barrier: a lane holds its
//              columns' 1 + scale in registers across the two rows its
//              warp takes one after the other.
// Each line gives the median of 25 CUDA-event runs after 5 warm-ups, the
// rate over the bytes moved, the max abs error against a float64 RMSNorm
// of the same rows, and whether out equals the two-pass kernel's bit for
// bit; three dtype pairs (x / scale: float32 / float32 and bfloat16 /
// bfloat16, the main path's, and bfloat16 / float32), each pair's
// variants in turns, five times.
// Then the wide path (a CTA of 8 warps a row, the row in their registers)
// at [1024, 7168] and [4, 7168] in float32 (zamba2-7b's gated norm at a
// 1,024-token prefill and at a decode step of 4 slots), [1024, 8192]
// (internvl2-76b's d_model) and [4096, 5120] (qwen2.5-32b's) in
// bfloat16, x and scale of one dtype:
//   two-pass   the kernel it replaced at these widths, the launcher's
//              two-pass instantiation (a warp a row, 16-byte loads, the
//              second pass from L1 or L2), called directly;
//   kernel     the shipped wide path through its launcher;
//   warps W    the wide path's design with CTAs of 4 or 16 warps (K
//              chunks a thread so that 32 W K VEC covers d).
// Each line gives the median of 25 CUDA-event runs after 5 warm-ups, the
// rate over x read once and out written once, the max abs error against
// a float64 RMSNorm, and the max abs gap from the shipped kernel's out;
// three turns.  Build and run from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/rmsnorm_variants tools/rmsnorm_variants.cu \
//     && build/rmsnorm_variants
#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/rmsnorm.cu"

namespace variants {

constexpr int kRows = 8192, kD = 2048, kGrain = 8;
constexpr float kEps = 1e-5f;

// the earlier kernel, as it was
template <typename TX, typename TS, int VEC>
__global__ void two_pass(const TX* __restrict__ x,
                         const TS* __restrict__ scale, TX* __restrict__ out,
                         int d, int grain, float eps) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nwarps = blockDim.x / 32;
  const int first = blockIdx.x * grain;
  for (int r = first + warp; r < first + grain; r += nwarps) {
    const TX* xr = x + (size_t)r * d;
    TX* orow = out + (size_t)r * d;
    float ss = 0.0f;
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      alignas(16) TX e[VEC];
      load(xr + c, e);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float v = to_f32(e[i]);
        ss = fmaf(v, v, ss);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    const float inv = 1.0f / sqrtf(ss / (float)d + eps);
    for (int c = lane * VEC; c < d; c += 32 * VEC) {
      alignas(16) TX e[VEC];
      load(xr + c, e);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        from_f32(__fmul_rn(__fmul_rn(to_f32(e[i]), inv),
                           __fadd_rn(1.0f, to_f32(scale[c + i]))),
                 &e[i]);
      store(e, orow + c);
    }
  }
}

// the kernel's first text: every chunk predicated on d, 1 + scale staged
// once a CTA in shared memory behind a barrier (laid out so that lane l
// reads chunk j's values as float4s (j H + h) 32 + l)
template <typename TX, typename TS, int K>
__global__ void __launch_bounds__(kThreads)
    first(const TX* __restrict__ x, const TS* __restrict__ scale,
          TX* __restrict__ out, int rows, int d, float eps) {
  constexpr int VEC = 16 / sizeof(TX), H = VEC / 4;
  __shared__ __align__(16) float s1[32 * VEC * K];
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + threadIdx.x / 32;
  const bool live = r < rows;
  const TX* xr = x + (size_t)r * d;
  alignas(16) TX e[K][VEC];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = VEC * lane + 32 * VEC * j;
    if (live && c < d) {
      load(xr + c, e[j]);
    } else {
      *reinterpret_cast<uint4*>(e[j]) = make_uint4(0, 0, 0, 0);
    }
  }
  for (int c = threadIdx.x; c < d; c += kThreads) {
    const int j = c / (32 * VEC), l = c / VEC % 32, i = c % VEC;
    s1[((j * H + i / 4) * 32 + l) * 4 + i % 4] =
        __fadd_rn(1.0f, to_f32(scale[c]));
  }
  __syncthreads();
  if (!live) return;
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (VEC * lane + 32 * VEC * j < d) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float v = to_f32(e[j][i]);
        ss = fmaf(v, v, ss);
      }
    }
  }
  ss = warp_sum(ss);
  const float inv = 1.0f / sqrtf(ss / (float)d + eps);
  TX* orow = out + (size_t)r * d;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = VEC * lane + 32 * VEC * j;
    if (c < d) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float4 g =
            reinterpret_cast<const float4*>(s1)[(j * H + h) * 32 + lane];
        const float gs[4] = {g.x, g.y, g.z, g.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          TX* v = &e[j][4 * h + q];
          from_f32(__fmul_rn(__fmul_rn(to_f32(*v), inv), gs[q]), v);
        }
      }
      store(e[j], orow + c);
    }
  }
}

// sum, scale and store one row held in a lane's K chunks
template <typename TX, typename TS, int K, bool STAGE>
__device__ __forceinline__ void finish(TX (&e)[K][16 / sizeof(TX)],
                                       const float* s1, const TS* scale,
                                       TX* orow, int lane, int d,
                                       float eps) {
  constexpr int VEC = 16 / sizeof(TX), H = VEC / 4;
  float ss = 0.0f;
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float v = to_f32(e[j][i]);
      ss = fmaf(v, v, ss);
    }
  ss = warp_sum(ss);
  const float inv = 1.0f / sqrtf(ss / (float)d + eps);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int c = VEC * lane + 32 * VEC * j;
    float g[VEC];
    if constexpr (STAGE) {
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float4 t =
            reinterpret_cast<const float4*>(s1)[(j * H + h) * 32 + lane];
        g[4 * h] = t.x;
        g[4 * h + 1] = t.y;
        g[4 * h + 2] = t.z;
        g[4 * h + 3] = t.w;
      }
    } else {
      one_plus(scale + c, g);
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      from_f32(__fmul_rn(__fmul_rn(to_f32(e[j][i]), inv), g[i]), &e[j][i]);
    store(e[j], orow + c);
  }
}

// the kernel's design with its knobs (d = 32 VEC K exactly): R rows a
// warp, all their loads issued first; W warps a CTA; at least MINB CTAs
// an SM (a cap on registers); 1 + scale staged in shared memory behind a
// barrier (STAGE) or read from L1 as each chunk is scaled
template <typename TX, typename TS, int K, int R, int W, int MINB,
          bool STAGE>
__global__ void __launch_bounds__(32 * W, MINB)
    design(const TX* __restrict__ x, const TS* __restrict__ scale,
           TX* __restrict__ out, int d, float eps) {
  constexpr int VEC = 16 / sizeof(TX), H = VEC / 4;
  __shared__ __align__(16) float s1[STAGE ? 32 * VEC * K : 4];
  const int lane = threadIdx.x % 32;
  const size_t row0 = ((size_t)blockIdx.x * W + threadIdx.x / 32) * R;
  alignas(16) TX e[R][K][VEC];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < K; ++j)
      load(x + (row0 + r) * d + VEC * lane + 32 * VEC * j, e[r][j]);
  if constexpr (STAGE) {
    for (int c = threadIdx.x; c < d; c += 32 * W) {
      const int j = c / (32 * VEC), l = c / VEC % 32, i = c % VEC;
      s1[((j * H + i / 4) * 32 + l) * 4 + i % 4] =
          __fadd_rn(1.0f, to_f32(scale[c]));
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    finish<TX, TS, K, STAGE>(e[r], s1, scale, out + (row0 + r) * d, lane, d,
                             eps);
}

// a warp walks rows r, r + N, ... (N the grid's warps), the next row's
// loads issued before this row is summed; 1 + scale read from L1
template <typename TX, typename TS, int K>
__global__ void __launch_bounds__(kThreads)
    pipelined(const TX* __restrict__ x, const TS* __restrict__ scale,
         TX* __restrict__ out, int rows, int d, float eps) {
  constexpr int VEC = 16 / sizeof(TX);
  const int lane = threadIdx.x % 32;
  const int step = gridDim.x * kWarps;
  int r = blockIdx.x * kWarps + threadIdx.x / 32;
  alignas(16) TX a[K][VEC], b[K][VEC];
  auto fetch = [&](int row, TX(&e)[K][VEC]) {
#pragma unroll
    for (int j = 0; j < K; ++j)
      load(x + (size_t)row * d + VEC * lane + 32 * VEC * j, e[j]);
  };
  if (r < rows) fetch(r, a);
  for (; r < rows; r += 2 * step) {
    if (r + step < rows) fetch(r + step, b);
    finish<TX, TS, K, false>(a, nullptr, scale, out + (size_t)r * d, lane, d,
                             eps);
    if (r + step >= rows) break;
    if (r + 2 * step < rows) fetch(r + 2 * step, a);
    finish<TX, TS, K, false>(b, nullptr, scale, out + (size_t)(r + step) * d,
                             lane, d, eps);
  }
}

// 1 + scale in a lane's registers; R rows a warp, one after the other
template <typename TX, typename TS, int K, int R>
__global__ void __launch_bounds__(kThreads)
    scale_regs(const TX* __restrict__ x, const TS* __restrict__ scale,
               TX* __restrict__ out, int d, float eps) {
  constexpr int VEC = 16 / sizeof(TX);
  const int lane = threadIdx.x % 32;
  const size_t row0 = ((size_t)blockIdx.x * kWarps + threadIdx.x / 32) * R;
  float g[K][VEC];
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      g[j][i] =
          __fadd_rn(1.0f, to_f32(scale[VEC * lane + 32 * VEC * j + i]));
  for (int r = 0; r < R; ++r) {
    const TX* xr = x + (row0 + r) * d + VEC * lane;
    alignas(16) TX e[K][VEC];
#pragma unroll
    for (int j = 0; j < K; ++j) load(xr + 32 * VEC * j, e[j]);
    float ss = 0.0f;
#pragma unroll
    for (int j = 0; j < K; ++j)
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float v = to_f32(e[j][i]);
        ss = fmaf(v, v, ss);
      }
    ss = warp_sum(ss);
    const float inv = 1.0f / sqrtf(ss / (float)d + eps);
    TX* orow = out + (row0 + r) * d + VEC * lane;
#pragma unroll
    for (int j = 0; j < K; ++j) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        from_f32(__fmul_rn(__fmul_rn(to_f32(e[j][i]), inv), g[j][i]),
                 &e[j][i]);
      store(e[j], orow + 32 * VEC * j);
    }
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
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  std::sort(ts.begin(), ts.end());
  return ts[ts.size() / 2];
}

float host_f32(float v) { return v; }
float host_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
T host_from(float v) {
  if constexpr (sizeof(T) == 2) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

template <typename TX, typename TS>
void run_pair(const char* pair, const std::vector<float>& hx,
              const std::vector<float>& hs) {
  constexpr int kVec = 16 / sizeof(TX), kK = kD / (32 * kVec);
  const size_t count = (size_t)kRows * kD, bytes = count * sizeof(TX);
  std::vector<TX> x(count + 1), got(count), want(count);
  std::vector<TS> s(kD);
  for (size_t i = 0; i < count; ++i) x[i] = host_from<TX>(hx[i]);
  x[count] = x[0];
  for (int i = 0; i < kD; ++i) s[i] = host_from<TS>(hs[i]);
  // float64 RMSNorm of the rows at offset 0 and at offset 1
  std::vector<double> exact[2];
  for (int off = 0; off < 2; ++off) {
    exact[off].resize(count);
    for (size_t r = 0; r < kRows; ++r) {
      const TX* row = x.data() + off + r * kD;
      double ss = 0;
      for (int c = 0; c < kD; ++c)
        ss += (double)host_f32(row[c]) * host_f32(row[c]);
      const double inv = 1.0 / std::sqrt(ss / kD + kEps);
      for (int c = 0; c < kD; ++c)
        exact[off][r * kD + c] =
            host_f32(row[c]) * inv * (1.0 + (double)host_f32(s[c]));
    }
  }
  TX *dx, *dout;
  TS* ds;
  cudaMalloc(&dx, bytes + 16);
  cudaMalloc(&dout, bytes + 16);
  cudaMalloc(&ds, kD * sizeof(TS));
  cudaMemcpy(dx, x.data(), bytes + sizeof(TX), cudaMemcpyHostToDevice);
  cudaMemcpy(ds, s.data(), kD * sizeof(TS), cudaMemcpyHostToDevice);
  const int xb = sizeof(TX) == 2, sb = sizeof(TS) == 2;
  int rep = 0;
  auto run = [&](const char* name, int off, auto launch) {
    cudaMemset(dout, 0, bytes + 16);
    const float ms = median_ms([&] { launch(dx + off, dout + off); });
    const cudaError_t err = cudaGetLastError();
    cudaMemcpy(got.data(), dout + off, bytes, cudaMemcpyDeviceToHost);
    double e = 0;
    for (size_t i = 0; i < count; ++i)
      e = std::max(e, std::fabs(host_f32(got[i]) - exact[off][i]));
    if (!strcmp(name, "two-pass")) want = got;
    const bool same = !memcmp(got.data(), want.data(), bytes);
    printf("turn %d %-10s %-22s %.5f ms  %.3f TB/s  max_abs_err %.3g  "
           "bits %s  %s\n",
           rep, pair, name, ms, 2.0 * bytes / ms / 1e9, e,
           same ? "equal" : "differ", cudaGetErrorString(err));
  };
  const unsigned ctas = rmsnorm_ctas(kRows, kD, sizeof(TX) == 2);
  int per_sm = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pipelined<TX, TS, kK>,
                                                kThreads, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  const int pipe_ctas = per_sm * sms;
  printf("%s: pipe %d CTAs (%d an SM)\n", pair, pipe_ctas, per_sm);
  for (; rep < 5; ++rep) {
    run("two-pass", 0, [&](const TX* xp, TX* op) {
      two_pass<TX, TS, kVec><<<kRows / kGrain, 32 * kGrain>>>(xp, ds, op, kD,
                                                              kGrain, kEps);
    });
    run("kernel", 0, [&](const TX* xp, TX* op) {
      launch_rmsnorm(xp, ds, op, kRows, kD, kGrain, kEps, xb, sb, nullptr);
    });
    run("kernel, 1 element off", 1, [&](const TX* xp, TX* op) {
      launch_rmsnorm(xp, ds, op, kRows, kD, kGrain, kEps, xb, sb, nullptr);
    });
    run("first", 0, [&](const TX* xp, TX* op) {
      first<TX, TS, kK><<<ctas, kThreads>>>(xp, ds, op, kRows, kD, kEps);
    });
    run("wide", 0, [&](const TX* xp, TX* op) {
      rmsnorm_two_pass<TX, TS, kVec><<<ctas, kThreads>>>(xp, ds, op, kRows, kD,
                                                         kEps);
    });
    auto knobs = [&](const char* name, auto kern, int rows_a_warp,
                     int warps) {
      run(name, 0, [&](const TX* xp, TX* op) {
        kern<<<kRows / (rows_a_warp * warps), 32 * warps>>>(xp, ds, op, kD,
                                                            kEps);
      });
    };
    knobs("staged", design<TX, TS, kK, 1, 8, 1, true>, 1, 8);
    knobs("staged rows2", design<TX, TS, kK, 2, 8, 1, true>, 2, 8);
    knobs("l1-scale", design<TX, TS, kK, 1, 8, 1, false>, 1, 8);
    knobs("l1-scale occ2", design<TX, TS, kK, 1, 8, 2, false>, 1, 8);
    run("pipe", 0, [&](const TX* xp, TX* op) {
      pipelined<TX, TS, kK><<<pipe_ctas, kThreads>>>(xp, ds, op, kRows, kD,
                                                     kEps);
    });
    run("scale-regs", 0, [&](const TX* xp, TX* op) {
      scale_regs<TX, TS, kK, 2><<<kRows / (2 * kWarps), kThreads>>>(
          xp, ds, op, kD, kEps);
    });
  }
  cudaFree(dx);
  cudaFree(dout);
  cudaFree(ds);
}


// the wide path's design at W warps a CTA, K = ceil(d / (32 W VEC))
template <typename TX, typename TS, int W>
cudaError_t wide_at(const TX* x, const TS* s, TX* out, int rows, int d) {
  constexpr int kVec = 16 / sizeof(TX);
  switch ((d + 32 * W * kVec - 1) / (32 * W * kVec)) {
#define CASE(K)                                                        \
  case K:                                                              \
    rmsnorm_wide<TX, TS, K, W><<<rows, 32 * W>>>(x, s, out, d, kEps); \
    return cudaGetLastError();
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15)
    CASE(16)
#undef CASE
  }
  return cudaErrorInvalidValue;
}

template <typename T>
void run_wide(const char* name, int rows, int d, const std::vector<float>& hx,
              const std::vector<float>& hs) {
  constexpr int kVec = 16 / sizeof(T);
  const size_t count = (size_t)rows * d, bytes = count * sizeof(T);
  std::vector<T> x(count), got(count), want(count);
  std::vector<T> s(d);
  for (size_t i = 0; i < count; ++i) x[i] = host_from<T>(hx[i % hx.size()]);
  for (int i = 0; i < d; ++i) s[i] = host_from<T>(hs[i % hs.size()]);
  std::vector<double> exact(count);
  for (int r = 0; r < rows; ++r) {
    const T* row = x.data() + (size_t)r * d;
    double ss = 0;
    for (int c = 0; c < d; ++c)
      ss += (double)host_f32(row[c]) * host_f32(row[c]);
    const double inv = 1.0 / std::sqrt(ss / d + kEps);
    for (int c = 0; c < d; ++c)
      exact[(size_t)r * d + c] =
          host_f32(row[c]) * inv * (1.0 + (double)host_f32(s[c]));
  }
  T *dx, *dout, *ds;
  cudaMalloc(&dx, bytes);
  cudaMalloc(&dout, bytes);
  cudaMalloc(&ds, d * sizeof(T));
  cudaMemcpy(dx, x.data(), bytes, cudaMemcpyHostToDevice);
  cudaMemcpy(ds, s.data(), d * sizeof(T), cudaMemcpyHostToDevice);
  const int bf = sizeof(T) == 2;
  printf("wide %s [%d, %d]: kernel ctas %d, bound %.5f ms\n", name, rows, d,
         rmsnorm_ctas(rows, d, bf), 2.0 * bytes / 3.35e9);
  auto run = [&](int turn, const char* vname, auto launch) {
    cudaMemset(dout, 0, bytes);
    const float ms = median_ms(launch);
    const cudaError_t err = cudaGetLastError();
    cudaMemcpy(got.data(), dout, bytes, cudaMemcpyDeviceToHost);
    const bool self = !strcmp(vname, "kernel");
    if (self) want = got;
    double e = 0, gap = 0;
    for (size_t i = 0; i < count; ++i) {
      e = std::max(e, std::fabs(host_f32(got[i]) - exact[i]));
      gap = std::max(gap, (double)std::fabs(host_f32(got[i]) -
                                            host_f32(want[i])));
    }
    printf("turn %d wide %s [%d, %d] %-10s %.5f ms  %.3f TB/s  max_abs_err "
           "%.3g  max_abs_gap %.3g  %s\n",
           turn, name, rows, d, vname, ms, 2.0 * bytes / ms / 1e9, e, gap,
           cudaGetErrorString(err));
  };
  for (int turn = 0; turn < 3; ++turn) {
    run(turn, "kernel", [&] {
      launch_rmsnorm(dx, ds, dout, rows, d, 1, kEps, bf, bf, nullptr);
    });
    run(turn, "two-pass", [&] {
      rmsnorm_two_pass<T, T, kVec><<<(rows + kWarps - 1) / kWarps,
                                     kThreads>>>(dx, ds, dout, rows, d, kEps);
    });
    run(turn, "warps 4", [&] { wide_at<T, T, 4>(dx, ds, dout, rows, d); });
    run(turn, "warps 16", [&] { wide_at<T, T, 16>(dx, ds, dout, rows, d); });
  }
  cudaFree(dx);
  cudaFree(dout);
  cudaFree(ds);
}

}  // namespace variants

int main() {
  using namespace variants;
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("device: %s, %d SMs; x[%d, %d]; kernel ctas %d\n", prop.name,
         prop.multiProcessorCount, kRows, kD,
         rmsnorm_ctas(kRows, kD, 0));
  std::vector<float> hx((size_t)kRows * kD + 1), hs(kD);
  srand(42);
  for (auto& v : hx) v = rand() / (float)RAND_MAX * 4 - 2;
  for (auto& v : hs) v = rand() / (float)RAND_MAX - 0.5f;
  run_pair<float, float>("f32/f32", hx, hs);
  run_pair<__nv_bfloat16, __nv_bfloat16>("bf16/bf16", hx, hs);
  run_pair<__nv_bfloat16, float>("bf16/f32", hx, hs);
  run_wide<float>("float32", 1024, 7168, hx, hs);
  run_wide<float>("float32", 4, 7168, hx, hs);
  run_wide<__nv_bfloat16>("bfloat16", 1024, 8192, hx, hs);
  run_wide<__nv_bfloat16>("bfloat16", 4096, 5120, hx, hs);
  return 0;
}
