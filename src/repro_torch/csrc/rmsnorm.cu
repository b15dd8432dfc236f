// rmsnorm: out[r, :] = x[r, :] * (1 / sqrt(mean(x[r, :]^2) + eps))
// * (1 + scale), in float32, written once in x's dtype (float32 or
// bfloat16, rounded to nearest even); scale's dtype is its own.  A block
// takes `grain` consecutive rows, as one program of the reference does;
// it has min(grain, 8) warps, and each warp normalises one row at a time:
// its lanes sum their squares across the row in registers, a
// __shfl_xor_sync butterfly adds the 32 partial sums, and a second pass
// over the row (now in L1) scales and writes it.  Rows whose width is a
// multiple of 16 bytes' worth of elements move 16 bytes a lane a load.
//
// Replaces: the TPU kernel src/repro/kernels/rmsnorm.py:17 (`_kernel`,
// called through `rmsnorm`, src/repro/kernels/rmsnorm.py:26).
//
// Bound on the H100: bytes.  x read once and out written once (2 x 2
// bytes an element in bfloat16: 67 MB for x[8192, 2048]) over 3.35 TB/s
// is 0.020 ms; the 4 flops an element take 0.0010 ms at 67 TFLOP/s.  The
// design reads x from device memory once: the second pass finds the row
// (4 KB in bfloat16) in L1, so the kernel streams, with 16-byte loads and
// one warp a row and no shared memory or barrier.  1 / sqrtf is the
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

constexpr int kMaxWarps = 8;

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

// VEC: elements a lane moves in one 16-byte access (1 when the rows are
// not 16-byte aligned)
template <typename TX, typename TS, int VEC>
__global__ void rmsnorm_kernel(const TX* __restrict__ x,
                               const TS* __restrict__ scale,
                               TX* __restrict__ out, int d, int grain,
                               float eps) {
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

template <typename TX, typename TS>
cudaError_t launch(const void* x, const void* scale, void* out, int rows,
                   int d, int grain, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(TX);
  const int warps = grain < kMaxWarps ? grain : kMaxWarps;
  const int blocks = rows / grain;
  const bool aligned = d % kVec == 0 &&
                       ((uintptr_t)x | (uintptr_t)out) % 16 == 0;
  if (aligned) {
    rmsnorm_kernel<TX, TS, kVec><<<blocks, 32 * warps, 0, stream>>>(
        (const TX*)x, (const TS*)scale, (TX*)out, d, grain, eps);
  } else {
    rmsnorm_kernel<TX, TS, 1><<<blocks, 32 * warps, 0, stream>>>(
        (const TX*)x, (const TS*)scale, (TX*)out, d, grain, eps);
  }
  return cudaGetLastError();
}

}  // namespace

// x_bf16 / scale_bf16: 0 for float32, 1 for bfloat16.  grain divides rows
// (the wrapper shrinks it so).
extern "C" int launch_rmsnorm(const void* x, const void* scale, void* out,
                              int rows, int d, int grain, float eps,
                              int x_bf16, int scale_bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err;
  if (x_bf16) {
    err = scale_bf16
              ? launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, d,
                                                     grain, eps, s)
              : launch<__nv_bfloat16, float>(x, scale, out, rows, d, grain,
                                             eps, s);
  } else {
    err = scale_bf16
              ? launch<float, __nv_bfloat16>(x, scale, out, rows, d, grain,
                                             eps, s)
              : launch<float, float>(x, scale, out, rows, d, grain, eps, s);
  }
  return (int)err;
}
