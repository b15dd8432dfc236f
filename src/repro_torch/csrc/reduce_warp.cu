// reduce_warp: the shuffle-based block reduction (Crystal q11-q13).  In
// the reference each thread loads x[gid] (0 past n); each warp runs the
// __shfl_xor_sync butterfly v += shfl_xor(v, off) for off = 16, 8, 4, 2,
// 1; lane 0 puts its warp's sum in s[warp]; after a barrier, warp 0 runs
// the same butterfly over s[t] for t < nwarps (0 in the other lanes), and
// thread 0 writes out[blockIdx].
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_reduce_warp
// (src/repro/core/cuda_suite.py:162).
//
// Bound on the H100: memory.  x is read once (67 MB at n = 2^24): 0.020
// ms at 3.35 TB/s.  The reference's block does one 4-byte load a thread
// and 5 shuffles a warp for every 32 floats, behind a barrier; here one
// warp does a logical block of B = 32 * nwarps threads with no shared
// memory and no barrier:
// - lane l holds v[j] = x[bid * B + 32 j + l] for j < nwarps, so register
//   j across the lanes is the reference's warp j; the loads are coalesced
//   128-byte warp loads, all issued before the first add;
// - the first butterflies run level by level (off = 16 .. 1) on all the
//   registers at once, independent shuffles added with __fadd_rn;
// - lane t takes warp t's sum v[t] by an unrolled select (0 for t >=
//   nwarps), and the second butterfly runs as the reference's.
// These are the reference's adds, so each sum equals the plain version's
// (and the reference's) bit for bit; the oracle, NumPy's pairwise sum,
// holds it within the entry's tolerance.  A block of nwarps not a power
// of two runs with the next power of two, its extra registers zero (their
// butterflies give +0.0, which no lane reads: lanes t >= nwarps take 0.0,
// as the reference's do).  tools/reduce_warp_variants.cu times this
// beside two layouts with fewer shuffles (the first butterflies' levels
// splitting the registers between the lanes, 15 shuffles a block of 256
// against 45 here; register levels with loads of 16 bytes a line): on an
// H100 the split layout is at most a few per cent faster, within the
// run-to-run spread, so the loads, not the shuffles, set the pace, and
// the plainer layout stays.
//
// Physical to logical: the entry's grid and block stay the chevron's
// (65,536 blocks of 256 at n = 2^24); the launcher starts CTAs of 256
// threads, each serving 8 logical blocks.  Logical block bid stores only
// where bid < grid and bid < n_out, as the reference's block does.  B is
// a multiple of 32 up to 1024 (the wrapper's check); the next power of
// two at or above nwarps is a template argument.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

// NW: the power of two at or above nwarps.
template <int NW>
__global__ void __launch_bounds__(kThreads)
    reduce_warp_kernel(const float* __restrict__ x, float* __restrict__ out,
                       int n, int n_out, int grid, int nwarps) {
  const int lane = threadIdx.x % 32;
  const long long bid = (long long)blockIdx.x * (kThreads / 32) +
                        threadIdx.x / 32;
  if (bid >= grid) return;               // the whole warp is past
  const long long base = bid * 32 * nwarps + lane;
  float v[NW];
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    const long long gid = base + 32LL * j;
    v[j] = j < nwarps && gid < n ? __ldg(x + gid) : 0.0f;
  }
#pragma unroll
  for (int off = 16; off >= 1; off /= 2)
#pragma unroll
    for (int j = 0; j < NW; ++j)
      v[j] = __fadd_rn(v[j], __shfl_xor_sync(kFull, v[j], off));
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < NW; ++j) s = lane == j ? v[j] : s;
  s = lane < nwarps ? s : 0.0f;
#pragma unroll
  for (int off = 16; off >= 1; off /= 2)
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
  if (lane == 0 && bid < n_out) out[bid] = s;
}

template <int NW>
cudaError_t launch(const float* x, float* out, int n, int n_out, int grid,
                   int nwarps, cudaStream_t stream) {
  const long long ctas = ((long long)grid + kThreads / 32 - 1) /
                         (kThreads / 32);
  reduce_warp_kernel<NW><<<(unsigned)ctas, kThreads, 0, stream>>>(
      x, out, n, n_out, grid, nwarps);
  return cudaGetLastError();
}

}  // namespace

// block: the logical block B, a multiple of 32 up to 1024 (the wrapper's
// check); any other is refused with cudaErrorInvalidValue.
extern "C" int launch_reduce_warp(const float* x, float* out, int n,
                                  int n_out, int grid, int block,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (block % 32 || block < 32 || block > 1024)
    return (int)cudaErrorInvalidValue;
  const int nw = block / 32;
  if (nw == 1) return (int)launch<1>(x, out, n, n_out, grid, nw, s);
  if (nw == 2) return (int)launch<2>(x, out, n, n_out, grid, nw, s);
  if (nw <= 4) return (int)launch<4>(x, out, n, n_out, grid, nw, s);
  if (nw <= 8) return (int)launch<8>(x, out, n, n_out, grid, nw, s);
  if (nw <= 16) return (int)launch<16>(x, out, n, n_out, grid, nw, s);
  return (int)launch<32>(x, out, n, n_out, grid, nw, s);
}
