// scan_block: the Hillis-Steele inclusive prefix sum within each logical
// block of B threads.  In the reference each thread holds s[t]; for d = 1,
// 2, 4, ... below B it reads s[t - d] (0.0 for t < d), barriers, adds it
// into s[t] and barriers again: log2(B) levels, every read of a level
// before any write of it.  Then y[gid] = s[t].
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_scan_block
// (src/repro/core/cuda_suite.py:344).
//
// Bound on the H100: memory.  x is read once and y written once (134 MB at
// n = 2^24): 0.040 ms at 3.35 TB/s, against log2(B) adds an element.  A
// CTA a logical block, one value a thread in __shared__ behind 2 log2(B) +
// 1 barriers (15 at B = 128), paid a block's start and retirement for 512
// bytes: 131,072 of them took 0.0857 ms, the block count and not the bytes
// setting the time.  Here one warp is one logical block, in CTAs of 8
// warps (16,384 CTAs at n = 2^24, B = 128), with no shared memory and no
// barrier:
// - lane l holds the block's E = B/32 values in registers, value j being
//   thread t = 32 j + l, so each value is one coalesced 128-byte warp
//   access;
// - each level adds the reference's pair, v[t] + v[t - d] (or + 0.0f for
//   t < d), from a copy of the level's old values, so every read of a
//   level comes before any write of it:
//     d < 32:  t - d is value j of lane l - d, or for l < d value j - 1
//              of lane l - d + 32: one rotating __shfl_sync a value, each
//              source lane s sending value j - 1 where s + d >= 32 (0.0f
//              at j = 0, which is what t < d adds);
//     d >= 32: this lane, d / 32 values down;
// - a block of B < 32 threads is a segment of B lanes (the shuffles'
//   width), one value a lane, so a warp serves 32/B logical blocks.
// tools/scan_block_variants.cu times this beside the old kernel, groups
// of four consecutive threads a lane (a float4 a lane at B = 128), the
// blocked layout (lane l holds t = E l ... E l + E - 1), 4 and 16 warps a
// CTA and cudaMemcpyAsync of the same bytes.  On an NVIDIA H100 80GB HBM3
// at 700.00 W, at n = 2^24, over five runs: B = 128, this kernel
// 0.0494-0.0498 ms, the old one 0.0849-0.0856, the copy 0.0493-0.0495,
// groups of four 0.0494-0.0508 and 4 or 16 warps a CTA within 1 %; B =
// 1024, this kernel 0.0502-0.0510, groups of four 0.0495-0.0496 (1-3 %
// less, off the main path, for a second layout, float2 / float4 accesses
// and an alignment dispatch: not shipped), blocked 0.093-0.102 (a lane's
// float4s 128 bytes apart, so each warp access touches 32 lines); B = 32
// and 16, 0.066-0.069 against the old 0.320 and 0.635 (one 4-byte access
// a lane, few bytes in flight).  21 registers at B = 128, 8 to 40 over the
// 11 instantiations, no spills.  Every level adds with
// __fadd_rn, the 0.0f too (so a -0.0 input becomes +0.0 as in the
// reference), so y equals the plain version and the reference bit for
// bit; NumPy's cumsum adds in sequence, so the oracle holds it within the
// entry's tolerance.  B is a power of two up to 1024 (the wrapper's check)
// and a template argument; the wrapper keeps grid * B within x, so no
// block is partial.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8, kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int log2_of(int b) {
  return b > 1 ? 1 + log2_of(b / 2) : 0;
}

// o[j], where j >= 0 wherever the value is used (a guard for the indices
// of branches that unrolling removes)
template <int E>
__device__ __forceinline__ float at(const float (&o)[E], int j) {
  return o[j > 0 ? j : 0];
}

// The reference's levels over one logical block of 32 E threads held by
// a warp, thread 32 j + lane at v[j].  Every index is a constant after
// unrolling, so v stays in registers.
template <int E>
__device__ __forceinline__ void scan_warp(float (&v)[E], int lane) {
#pragma unroll
  for (int lv = 0; lv < log2_of(32 * E); ++lv) {
    const int d = 1 << lv;
    float o[E];                          // the level's old values
#pragma unroll
    for (int j = 0; j < E; ++j) o[j] = v[j];
#pragma unroll
    for (int j = 0; j < E; ++j) {
      if (d >= 32) {                     // this lane, d / 32 values down
        const int m = d / 32;
        v[j] = __fadd_rn(o[j], j >= m ? at(o, j - m) : 0.0f);
      } else {                           // d lanes down, wrapping to j - 1
        const float wrap = j ? at(o, j - 1) : 0.0f;
        const float send = lane + d >= 32 ? wrap : o[j];
        v[j] = __fadd_rn(o[j], __shfl_sync(kFull, send, (lane - d) & 31));
      }
    }
  }
}

// E = B/32 values a lane: warp w of CTA c takes logical block kWarps c + w
template <int E>
__global__ void __launch_bounds__(kThreads)
    scan_block_warps(const float* __restrict__ x, float* __restrict__ y,
                     int grid) {
  const int lane = threadIdx.x % 32;
  const long long bid = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (bid >= grid) return;               // the whole warp is past
  const long long base = bid * 32 * E + lane;
  float v[E];
#pragma unroll
  for (int j = 0; j < E; ++j) v[j] = __ldg(x + base + 32 * j);
  scan_warp<E>(v, lane);
#pragma unroll
  for (int j = 0; j < E; ++j) y[base + 32 * j] = v[j];
}

// B < 32: a warp serves 32/B logical blocks, a segment of B lanes each
template <int B>
__global__ void __launch_bounds__(kThreads)
    scan_block_lanes(const float* __restrict__ x, float* __restrict__ y,
                     int grid) {
  const int lane = threadIdx.x % 32;
  const long long warp = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (warp * (32 / B) >= grid) return;   // the whole warp is past
  const long long gid = warp * 32 + lane;
  const bool live = gid < (long long)grid * B;
  float v = live ? __ldg(x + gid) : 0.0f;
  const int t = lane % B;
#pragma unroll
  for (int lv = 0; lv < log2_of(B); ++lv) {
    const int d = 1 << lv;
    const float up = __shfl_up_sync(kFull, v, d, B);
    v = __fadd_rn(v, t >= d ? up : 0.0f);
  }
  if (live) y[gid] = v;
}

// CTAs of kWarps warps: a warp a logical block, or 32/B blocks a warp
// below 32 threads
template <int B>
cudaError_t launch(const float* x, float* y, int grid, cudaStream_t s) {
  const long long warps = ((long long)grid * (B < 32 ? B : 32) + 31) / 32;
  const unsigned ctas = (unsigned)((warps + kWarps - 1) / kWarps);
  if constexpr (B < 32)
    scan_block_lanes<B><<<ctas, kThreads, 0, s>>>(x, y, grid);
  else
    scan_block_warps<B / 32><<<ctas, kThreads, 0, s>>>(x, y, grid);
  return cudaGetLastError();
}

}  // namespace

// block: the logical block B, a power of two up to 1024 (the wrapper's
// check); any other is refused with cudaErrorInvalidValue.
extern "C" int launch_scan_block(const float* x, float* y, int grid,
                                 int block, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (block) {
    case 1: return (int)launch<1>(x, y, grid, s);
    case 2: return (int)launch<2>(x, y, grid, s);
    case 4: return (int)launch<4>(x, y, grid, s);
    case 8: return (int)launch<8>(x, y, grid, s);
    case 16: return (int)launch<16>(x, y, grid, s);
    case 32: return (int)launch<32>(x, y, grid, s);
    case 64: return (int)launch<64>(x, y, grid, s);
    case 128: return (int)launch<128>(x, y, grid, s);
    case 256: return (int)launch<256>(x, y, grid, s);
    case 512: return (int)launch<512>(x, y, grid, s);
    case 1024: return (int)launch<1024>(x, y, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
