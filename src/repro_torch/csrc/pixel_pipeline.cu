// pixel_pipeline: out = exp(log(img) * c0 + c1), srad's extract and
// compress stages in one kernel.  The chevron's threads cover the first
// m = grid block elements (the wrapper keeps m <= n); out keeps its input
// past m.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_pixel_pipeline
// (src/repro/core/cuda_suite.py:422).
//
// Bound on the H100: memory.  img is read once and out written once
// (134 MB at n = 2^24): 0.040 ms at 3.35 TB/s; the 3.4e7 log and exp on
// the special-function units take 0.008 ms.  The reference's kernel puts
// each thread's logf in its own __shared__ cell between two barriers; no
// thread reads another's cell, so both barriers are removable (the
// reference's optimizer proves it) and the value is the same without
// them.  A CTA a logical block, one element a thread, paid a block's
// start and retirement for 512 bytes: 131,072 of them took 0.0846 ms, the
// block count and not the bytes setting the time.  Here a CTA of 8 warps
// covers 1,024 consecutive elements (16,384 CTAs at n = 2^24),
// stencil1d's mapping without its halo:
// - a warp takes 128 elements, a lane 4 adjacent ones, read one float an
//   access (each clamped to m - 1; the lanes' accesses of one warp cover
//   the same four lines, served by L1);
// - no shared memory and no barrier; a lane stores each of its elements
//   that lies below m.
// The arithmetic per element is the old kernel's: CUDA's logf, then
// __fmul_rn/__fadd_rn (no FMA), then expf, so out equals the old kernel's
// bits whatever the mapping, and agrees with the plain version and the
// oracle within the entry's tolerance (2e-5).
// tools/pixel_pipeline_variants.cu times this beside the old kernel, a
// float4 a lane, 4 and 16 warps a CTA and cudaMemcpyAsync of the same
// bytes.  On an NVIDIA H100 80GB HBM3 at 700 W, at n = 2^24: this kernel
// 0.0495 ms, the old one 0.0846, the copy 0.0495; a float4 a lane 0.0498,
// so the one-float text ships, with no alignment dispatch; 4 to 16 warps
// a CTA within 1 %; buffers off 16 bytes 0.0506.  25 registers, no
// spills.  The block is the one the kernel was made for, up to 1024
// threads; m is a runtime argument.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                   // warps a CTA
constexpr int kVals = 4;                    // elements a lane
constexpr int kWarpVals = 32 * kVals;       // 128

// The old kernel's arithmetic, its two stages without the shared cell.
__device__ __forceinline__ float pixel(float v, float c0, float c1) {
  return expf(__fadd_rn(__fmul_rn(logf(v), c0), c1));
}

template <int W>
__global__ void __launch_bounds__(W * 32)
    pixel_pipeline_warps(const float* __restrict__ img, float* out, float c0,
                         float c1, int m) {
  const long long i0 =
      ((long long)blockIdx.x * W + threadIdx.x / 32) * kWarpVals +
      (threadIdx.x & 31) * kVals;
  if (i0 >= m) return;
  float v[kVals];
#pragma unroll
  for (int e = 0; e < kVals; ++e) v[e] = img[min(i0 + e, m - 1LL)];
  // the four results first, then the stores below m (stencil1d's order)
#pragma unroll
  for (int e = 0; e < kVals; ++e) v[e] = pixel(v[e], c0, c1);
  float* dst = out + i0;
#pragma unroll
  for (int e = 0; e < kVals; ++e)
    if (i0 + e < m) dst[e] = v[e];
}

}  // namespace

// The elements one CTA covers; lower_cuda.pixel_pipeline_ctas gives the
// CTA count from it.
extern "C" int pixel_pipeline_cta_elems() { return kWarps * kWarpVals; }

// The chevron's grid of blocks of `block` threads, run as `ctas` CTAs of
// kWarps warps over the m = grid block elements they write.
extern "C" int launch_pixel_pipeline(const float* img, float* out, float c0,
                                     float c1, int grid, int block, int ctas,
                                     void* stream) {
  const int m = (int)((long long)grid * block);
  pixel_pipeline_warps<kWarps><<<ctas, kWarps * 32, 0,
                                 (cudaStream_t)stream>>>(img, out, c0, c1, m);
  return (int)cudaGetLastError();
}
