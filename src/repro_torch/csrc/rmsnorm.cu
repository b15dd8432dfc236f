// rmsnorm: out[r, :] = x[r, :] * (1 / sqrt(mean(x[r, :]^2) + eps))
// * (1 + scale), in float32, written once in x's dtype (float32 or
// bfloat16, rounded to nearest even); scale's dtype is its own.  A row is
// read from device memory once, held in registers, summed, then scaled
// and written from the registers.
//
// Replaces: the TPU kernel src/repro/kernels/rmsnorm.py:17 (`_kernel`,
// called through `rmsnorm`, src/repro/kernels/rmsnorm.py:26).
//
// Bound on the H100: bytes.  x read once and out written once (2 x 2
// bytes an element in bfloat16: 67 MB for x[8192, 2048]; 134 MB in
// float32) over 3.35 TB/s is 0.020 ms (0.040); the 4 flops an element
// take 0.0010 ms at 67 TFLOP/s.  The design reads x from device memory
// once and keeps many loads in flight.  Two paths for 16-byte aligned
// rows whose width is a multiple of VEC (4 floats or 8 bfloat16s):
// - the register path, a warp a row: K = ceil(d / (32 VEC)) 16-byte
//   chunks a lane, chunk j of lane l at column c = VEC l + 32 VEC j, K a
//   template argument (1 ... 18, a switch in the launcher: rows up to
//   2304 wide in float32, 4608 in bfloat16; d = 2048 is K = 16 in
//   float32, 8 in bfloat16).  A lane issues all K loads before the first
//   fmaf, sums its squares over its registers in column order, and a
//   __shfl_xor_sync butterfly adds the 32 partial sums.  CTAs of 8 warps,
//   a warp a row: ceil(rows / 8) CTAs (1,024 at the main path's 8192
//   rows), whatever `grain`; a row's result never depended on it.  Only
//   a lane's last chunk is predicated on d;
// - the wide path, a CTA a row (rows wider than the switch, up to
//   kWideMax chunks: 16,384 floats or 32,768 bfloat16s): the row held in
//   the registers of a CTA of kWideWarps warps, K = ceil(d / (32
//   kWideWarps VEC)) chunks a thread (3 ... 16, a second switch; 7 at
//   zamba2-7b's float32 gated norm of 7,168, 4 at bfloat16's 8,192),
//   chunk j of thread t at column VEC t + 32 kWideWarps VEC j.  A thread
//   issues its K loads before its first fmaf and sums its squares in
//   column order; each warp's butterfly gives a warp sum, and every
//   thread adds the kWideWarps warp sums from shared memory in warp
//   order, so all threads of the row get the same bits.  `rows` CTAs
//   (1,024 at [1024, 7168]; 4 at zamba2's decode step).
// In both, 1 + scale is read with 16-byte loads (8 for a bfloat16 scale
// beside float32 x) as each chunk is scaled: the row of scale stays in L1
// for every warp of the SM.
// tools/rmsnorm_variants.cu times the register path beside 1 + scale
// staged in shared memory, two rows a warp, a register cap for two CTAs
// an SM, a warp that walks rows with the next row's loads in flight, and
// 1 + scale held in registers; and the wide path at [1024, 7168] and
// [4, 7168] float32, [1024, 8192] and [4096, 5120] bfloat16 beside the
// two-pass kernel it replaced and CTAs of 4 and 16 warps (PERF.md).
// Rows wider than kWideMax chunks, rows whose width is not a multiple of
// VEC, x or out off a 16-byte boundary and scale off one take two passes
// over the row, a warp a row (16-byte loads of x where aligned, one
// element a load otherwise): the second pass finds the row in L1 or L2,
// and 1 + scale is read a value at a time.
// The register path's 16-byte instantiations give a lane the same
// columns in the same order, so they give the same bits; one element a
// load sums a lane's squares in another order.  1 / sqrtf is the
// correctly rounded reciprocal square root's two IEEE steps, not the
// approximate rsqrtf.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

constexpr int kWarps = 8, kThreads = 32 * kWarps;
// the wide path: warps a CTA (a row), and the most chunks a row it holds
constexpr int kWideWarps = 8, kWideMax = 16 * 32 * kWideWarps;
// the register path's switch: chunks a lane
constexpr int kRegMax = 18;

// one lane's VEC elements: a 16-byte access when VEC > 1
template <typename T, int VEC>
__device__ __forceinline__ void load(const T* src, T (&e)[VEC]) {
  if constexpr (VEC > 1) {
    *reinterpret_cast<uint4*>(e) = *reinterpret_cast<const uint4*>(src);
  } else {
    e[0] = *src;
  }
}
template <typename T, int VEC>
__device__ __forceinline__ void store(const T (&e)[VEC], T* dst) {
  if constexpr (VEC > 1) {
    *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(e);
  } else {
    *dst = e[0];
  }
}

__device__ __forceinline__ float warp_sum(float ss) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  return ss;
}

// 1 + scale at a lane's VEC columns from p, in 8- or 16-byte loads
template <typename TS, int VEC>
__device__ __forceinline__ void one_plus(const TS* p, float (&g)[VEC]) {
  constexpr int kBytes = sizeof(TS) * VEC;
  alignas(16) TS t[VEC];
  if constexpr (kBytes >= 16) {
#pragma unroll
    for (int q = 0; q < kBytes / 16; ++q)
      reinterpret_cast<uint4*>(t)[q] =
          __ldg(reinterpret_cast<const uint4*>(p) + q);
  } else {
    *reinterpret_cast<uint2*>(t) = __ldg(reinterpret_cast<const uint2*>(p));
  }
#pragma unroll
  for (int i = 0; i < VEC; ++i) g[i] = __fadd_rn(1.0f, to_f32(t[i]));
}

// K chunks of VEC elements a lane, the row in registers
template <typename TX, typename TS, int K>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_kernel(const TX* __restrict__ x, const TS* __restrict__ scale,
                   TX* __restrict__ out, int rows, int d, float eps) {
  constexpr int VEC = 16 / sizeof(TX);
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= rows) return;
  const TX* xr = x + (size_t)r * d + VEC * lane;
  TX* orow = out + (size_t)r * d + VEC * lane;
  // only the last chunk can pass d
  const bool last = VEC * lane + 32 * VEC * (K - 1) < d;
  alignas(16) TX e[K][VEC];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < K - 1 || last) {
      load(xr + 32 * VEC * j, e[j]);
    } else {
      *reinterpret_cast<uint4*>(e[j]) = make_uint4(0, 0, 0, 0);
    }
  }
  float ss = 0.0f;       // a zero chunk adds exactly 0
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
    if (j < K - 1 || last) {
      float g[VEC];
      one_plus(scale + VEC * lane + 32 * VEC * j, g);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        from_f32(__fmul_rn(__fmul_rn(to_f32(e[j][i]), inv), g[i]),
                 &e[j][i]);
      store(e[j], orow + 32 * VEC * j);
    }
  }
}

// a CTA of W warps a row, K chunks of VEC elements a thread, the row in
// the CTA's registers
template <typename TX, typename TS, int K, int W>
__global__ void __launch_bounds__(32 * W)
    rmsnorm_wide(const TX* __restrict__ x, const TS* __restrict__ scale,
                 TX* __restrict__ out, int d, float eps) {
  constexpr int VEC = 16 / sizeof(TX), kStride = 32 * W * VEC;
  __shared__ float part[W];
  const int t = threadIdx.x;
  const TX* xr = x + (size_t)blockIdx.x * d + VEC * t;
  TX* orow = out + (size_t)blockIdx.x * d + VEC * t;
  alignas(16) TX e[K][VEC];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (VEC * t + kStride * j < d) {
      load(xr + kStride * j, e[j]);
    } else {
      *reinterpret_cast<uint4*>(e[j]) = make_uint4(0, 0, 0, 0);
    }
  }
  float ss = 0.0f;       // a zero chunk adds exactly 0
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float v = to_f32(e[j][i]);
      ss = fmaf(v, v, ss);
    }
  ss = warp_sum(ss);
  if (t % 32 == 0) part[t / 32] = ss;
  __syncthreads();
  ss = part[0];
#pragma unroll
  for (int w = 1; w < W; ++w) ss += part[w];
  const float inv = 1.0f / sqrtf(ss / (float)d + eps);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (VEC * t + kStride * j < d) {
      float g[VEC];
      one_plus(scale + VEC * t + kStride * j, g);
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        from_f32(__fmul_rn(__fmul_rn(to_f32(e[j][i]), inv), g[i]),
                 &e[j][i]);
      store(e[j], orow + kStride * j);
    }
  }
}

// two passes over the row; VEC: elements a lane moves in one 16-byte
// access (1 when the rows are not 16-byte aligned)
template <typename TX, typename TS, int VEC>
__global__ void __launch_bounds__(kThreads)
    rmsnorm_two_pass(const TX* __restrict__ x, const TS* __restrict__ scale,
                     TX* __restrict__ out, int rows, int d, float eps) {
  const int lane = threadIdx.x % 32;
  const int r = blockIdx.x * kWarps + threadIdx.x / 32;
  if (r >= rows) return;
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
  ss = warp_sum(ss);
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

// the path of an aligned row of d elements of VEC a chunk: 0 the
// register path, 1 the wide path, 2 two passes
int path_of(int d, int vec) {
  if (d % vec) return 2;
  const int chunks = d / vec;
  return chunks <= 32 * kRegMax ? 0 : chunks <= kWideMax ? 1 : 2;
}

int ctas_of(int rows, int path) {
  return path == 1 ? rows : (rows + kWarps - 1) / kWarps;
}

template <typename TX, typename TS>
cudaError_t launch(const void* x, const void* scale, void* out, int rows,
                   int d, float eps, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(TX);
  const TX* xp = (const TX*)x;
  const TS* sp = (const TS*)scale;
  TX* op = (TX*)out;
  if (d % kVec || ((uintptr_t)x | (uintptr_t)out) % 16) {
    rmsnorm_two_pass<TX, TS, 1><<<ctas_of(rows, 2), kThreads, 0, s>>>(
        xp, sp, op, rows, d, eps);
    return cudaGetLastError();
  }
  if ((uintptr_t)scale % 16 == 0) {
    const int path = path_of(d, kVec);
    const unsigned ctas = ctas_of(rows, path);
    if (path == 0) {
      switch ((d + 32 * kVec - 1) / (32 * kVec)) {
#define CASE(K)                                                        \
  case K:                                                              \
    rmsnorm_kernel<TX, TS, K><<<ctas, kThreads, 0, s>>>(xp, sp, op,    \
                                                        rows, d, eps); \
    return cudaGetLastError();
        CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
        CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15)
        CASE(16) CASE(17) CASE(18)
#undef CASE
      }
    }
    if (path == 1) {
      constexpr int kPer = 32 * kWideWarps * kVec;
      switch ((d + kPer - 1) / kPer) {
#define CASE(K)                                                           \
  case K:                                                                 \
    rmsnorm_wide<TX, TS, K, kWideWarps><<<ctas, 32 * kWideWarps, 0, s>>>( \
        xp, sp, op, d, eps);                                              \
    return cudaGetLastError();
        CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8) CASE(9) CASE(10)
        CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
#undef CASE
      }
    }
  }
  rmsnorm_two_pass<TX, TS, kVec><<<ctas_of(rows, 2), kThreads, 0, s>>>(
      xp, sp, op, rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

// The CTAs that launch_rmsnorm starts for rows of d elements of x's dtype
// (x_bf16: 0 float32, 1 bfloat16) with x, out and scale on 16-byte
// boundaries, whatever the grain: `rows` on the wide path (a CTA of 8
// warps a row), ceil(rows / 8) CTAs of 8 warps otherwise (a warp a row).
extern "C" int rmsnorm_ctas(int rows, int d, int x_bf16) {
  return ctas_of(rows, path_of(d, x_bf16 ? 8 : 4));
}

// The path that launch_rmsnorm takes for such rows: 0 the register path,
// 1 the wide path, 2 two passes.
extern "C" int rmsnorm_path(int d, int x_bf16) {
  return path_of(d, x_bf16 ? 8 : 4);
}

// x_bf16 / scale_bf16: 0 for float32, 1 for bfloat16.  grain divides rows
// (the wrapper shrinks it so); it is the reference's rows a program and
// does not change the launch.
extern "C" int launch_rmsnorm(const void* x, const void* scale, void* out,
                              int rows, int d, int grain, float eps,
                              int x_bf16, int scale_bf16, void* stream) {
  (void)grain;
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (x_bf16) {
    err = scale_bf16
              ? launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d,
                                                     eps, s)
              : launch<__nv_bfloat16, float>(x, scale, out, rows, d, eps, s);
  } else {
    err = scale_bf16
              ? launch<float, __nv_bfloat16>(x, scale, out, rows, d, eps, s)
              : launch<float, float>(x, scale, out, rows, d, eps, s);
  }
  return (int)err;
}
