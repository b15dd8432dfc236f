// reduce_shared: each logical block's sum of x[bid * B + t], t < B (0 past
// n), in the reference's barrier-tree order: for off = B/2 down to 1,
// s[t] += s[t + off] for t < off; out[bid] = s[0].
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_reduce_shared
// (src/repro/core/cuda_suite.py:126).
//
// Bound on the H100: memory.  x is read once (67 MB at n = 2^24): 0.020
// ms at 3.35 TB/s, against one add an element.  The reference's block, a
// __shared__ tree behind log2(B) barriers with one 4-byte load a thread,
// keeps few bytes in flight; here one warp does a logical block of B >= 32
// threads with no shared memory and no barrier:
// - lane l holds the B/32 values t = l + 32 j in registers, loaded as
//   coalesced 128-byte warp loads, all issued before the first add (8 in
//   flight a lane at B = 256);
// - the tree's levels with off >= 32 pair t with t + off in the same lane:
//   register j takes register j + off/32;
// - levels 16 .. 1 pair lanes: lane t < off takes s[t + off] by
//   __shfl_down_sync (lanes past off compute values no lane reads again).
// These are the tree's pairs, level by level, added with __fadd_rn, so
// each sum equals the plain version's (and the reference's) bit for bit;
// the oracle, NumPy's pairwise sum, holds it within the entry's tolerance.
// A block of B < 32 threads is a segment of B lanes (the shuffles' width),
// so a warp serves 32/B logical blocks.
//
// Physical to logical: the entry's grid and block stay the chevron's
// (65,536 blocks of 256 at n = 2^24); the launcher starts CTAs of 256
// threads, each serving 8 logical blocks of B >= 32, or 8 * 32/B of
// B < 32.  Logical block bid stores only where bid < grid and
// bid < n_out, as the reference's block does.  B is a power of two up to
// 1024 (the wrapper's check) and a template argument.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// The tree's levels off, off/2, .., 1 over the registers v[0 .. 2 off):
// v[j] += v[j + off] for j < off (a template, so every index is constant
// and v stays in registers).
template <int OFF>
__device__ __forceinline__ void fold(float* v) {
  if constexpr (OFF >= 1) {
#pragma unroll
    for (int j = 0; j < OFF; ++j) v[j] = __fadd_rn(v[j], v[j + OFF]);
    fold<OFF / 2>(v);
  }
}

template <int B>
__global__ void __launch_bounds__(kThreads)
    reduce_shared_kernel(const float* __restrict__ x, float* __restrict__ out,
                         int n, int n_out, int grid) {
  constexpr int kLanes = B < 32 ? B : 32;        // lanes a logical block
  constexpr int kVals = B < 32 ? 1 : B / 32;     // values a lane
  const int lane = threadIdx.x % 32;
  const long long warp = (long long)blockIdx.x * (kThreads / 32) +
                         threadIdx.x / 32;
  const long long bid = (warp * 32 + lane) / kLanes;
  if (warp * 32 / kLanes >= grid) return;        // the whole warp is past
  const long long base = bid * B + lane % kLanes;
  float v[kVals];
#pragma unroll
  for (int j = 0; j < kVals; ++j) {
    const long long gid = base + 32LL * j;
    v[j] = gid < n ? __ldg(x + gid) : 0.0f;
  }
  fold<kVals / 2>(v);
  float s = v[0];
#pragma unroll
  for (int off = kLanes / 2; off >= 1; off /= 2)
    s = __fadd_rn(s, __shfl_down_sync(0xffffffffu, s, off, kLanes));
  if (lane % kLanes == 0 && bid < grid && bid < n_out) out[bid] = s;
}

template <int B>
cudaError_t launch(const float* x, float* out, int n, int n_out, int grid,
                   cudaStream_t stream) {
  constexpr int kLanes = B < 32 ? B : 32;
  const long long warps = ((long long)grid * kLanes + 31) / 32;
  const long long ctas = (warps + kThreads / 32 - 1) / (kThreads / 32);
  reduce_shared_kernel<B><<<(unsigned)ctas, kThreads, 0, stream>>>(
      x, out, n, n_out, grid);
  return cudaGetLastError();
}

}  // namespace

// block: the logical block B, a power of two up to 1024 (the wrapper's
// check); any other is refused with cudaErrorInvalidValue.
extern "C" int launch_reduce_shared(const float* x, float* out, int n,
                                    int n_out, int grid, int block,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (block) {
    case 1: return (int)launch<1>(x, out, n, n_out, grid, s);
    case 2: return (int)launch<2>(x, out, n, n_out, grid, s);
    case 4: return (int)launch<4>(x, out, n, n_out, grid, s);
    case 8: return (int)launch<8>(x, out, n, n_out, grid, s);
    case 16: return (int)launch<16>(x, out, n, n_out, grid, s);
    case 32: return (int)launch<32>(x, out, n, n_out, grid, s);
    case 64: return (int)launch<64>(x, out, n, n_out, grid, s);
    case 128: return (int)launch<128>(x, out, n, n_out, grid, s);
    case 256: return (int)launch<256>(x, out, n, n_out, grid, s);
    case 512: return (int)launch<512>(x, out, n, n_out, grid, s);
    case 1024: return (int)launch<1024>(x, out, n, n_out, grid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
