// stencil1d: the 3-point stencil y[i] = 0.25 x[i-1] + 0.5 x[i] + 0.25 x[i+1]
// (hotspot in one dimension), reads clamped to the array [0, n-1].  The
// chevron's threads cover i < m = min(n, grid block); y keeps its input
// past m.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_stencil1d
// (src/repro/core/cuda_suite.py:244).
//
// Bound on the H100: memory.  x is read once and y written once (134 MB at
// n = 2^24): 0.040 ms at 3.35 TB/s, against five flops an element.  A CTA
// a logical block, one element a thread with a __shared__ halo behind one
// barrier, paid a block's start and retirement for 512 bytes: 131,072 of
// them took 0.0847 ms, the block count and not the bytes setting the
// time.  Here a CTA of 8 warps covers 1,024 consecutive elements (16,384
// CTAs at n = 2^24), hotspot's and stencil2d's mapping in one dimension:
// - a warp takes 128 elements, a lane 4 adjacent ones, read one float an
//   access (each clamped to n - 1; the lanes' accesses of one warp cover
//   the same four lines, served by L1);
// - the west and east neighbours come from the next lanes by
//   __shfl_up_sync / __shfl_down_sync; lanes 0 and 31 read theirs from x
//   with clamped loads (served by L1 or L2: the next warp's elements);
// - no shared memory and no barrier.  A warp whose first element is at or
//   past m returns whole, before the shuffles; a lane past m returns
//   after them, so no lane waits on one that left; each element is
//   stored where it lies below m.
// tools/stencil1d_variants.cu times this beside the old kernel, one and
// two float4s a lane, 4 and 16 warps a CTA and cudaMemcpyAsync of the same
// bytes.  On an NVIDIA H100 80GB HBM3 at 700.00 W, at n = 2^24, over
// four runs: this kernel 0.0492-0.0498 ms, the old one 0.0844-0.0845, the
// copy 0.0493-0.0496; a float4 a lane 0.0493-0.0498, so the float4 path
// (and the alignment dispatch it needs) is not shipped; two float4s a
// lane and 4 to 16 warps a CTA within 1 % of a float4 a lane; buffers off
// 16 bytes 0.0500-0.0505.  23 registers, no spills.  The
// sum is added left to right with __fmul_rn/__fadd_rn, as the reference
// orders it, so nvcc cannot contract it into FMAs, and y equals the plain
// version's and NumPy's bits.  n, grid and block are runtime arguments.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;                   // warps a CTA
constexpr int kVals = 4;                    // elements a lane
constexpr int kWarpVals = 32 * kVals;       // 128
constexpr unsigned kFull = 0xffffffffu;

// The reference's order: (0.25 west + 0.5 centre) + 0.25 east.
__device__ __forceinline__ float stencil(float we, float c, float ea) {
  return __fadd_rn(__fadd_rn(__fmul_rn(0.25f, we), __fmul_rn(0.5f, c)),
                   __fmul_rn(0.25f, ea));
}

__global__ void __launch_bounds__(kWarps * 32)
    stencil1d_warps(const float* __restrict__ x, float* y, int n, int m) {
  const int lane = threadIdx.x & 31;
  const long long w0 =
      ((long long)blockIdx.x * kWarps + threadIdx.x / 32) * kWarpVals;
  // a warp returns whole: every lane of a live warp joins the shuffles
  if (w0 >= m) return;
  const long long i0 = w0 + lane * kVals;
  float c[kVals];
#pragma unroll
  for (int e = 0; e < kVals; ++e) c[e] = x[min(i0 + e, n - 1LL)];
  float we = __shfl_up_sync(kFull, c[kVals - 1], 1);
  float ea = __shfl_down_sync(kFull, c[0], 1);
  if (lane == 0) we = x[i0 > 0 ? i0 - 1 : 0];
  if (lane == 31) ea = x[min(i0 + kVals, n - 1LL)];
  if (i0 >= m) return;                   // past the shuffles: no lane waits
  // the four results first, then the stores below m (the stencil inside
  // each store's mask took 2 % more)
  float out[kVals];
#pragma unroll
  for (int e = 0; e < kVals; ++e)
    out[e] = stencil(e ? c[e - 1] : we, c[e], e < kVals - 1 ? c[e + 1] : ea);
  float* dst = y + i0;
#pragma unroll
  for (int e = 0; e < kVals; ++e)
    if (i0 + e < m) dst[e] = out[e];
}

}  // namespace

// The elements one CTA covers; lower_cuda.stencil1d_ctas gives the CTA
// count from it.
extern "C" int stencil1d_cta_elems() { return kWarps * kWarpVals; }

// The chevron's grid of blocks of `block` threads, run as `ctas` CTAs of
// kWarps warps over the m = min(n, grid block) elements they write.
extern "C" int launch_stencil1d(const float* x, float* y, int n, int grid,
                                int block, int ctas, void* stream) {
  const long long gb = (long long)grid * block;
  const int m = gb < n ? (int)gb : n;
  stencil1d_warps<<<ctas, kWarps * 32, 0, (cudaStream_t)stream>>>(x, y, n,
                                                                 m);
  return (int)cudaGetLastError();
}
