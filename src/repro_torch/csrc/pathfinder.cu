// pathfinder: one row of the row-wavefront dynamic program (Rodinia
// pathfinder): dst[c] = wall[r, c] + min(src[c-1], src[c], src[c+1]),
// edges clamped, for the columns c < m = min(cols, grid block) that the
// chevron's threads cover; dst keeps its input past m.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`)
// applied to make_pathfinder (src/repro/core/cuda_suite.py:501).
//
// Bound on the H100: the fixed cost of a launch, then latency.  A row
// moves 1.2 MB at 100,000 columns (0.00036 ms at 3.35 TB/s) against an
// empty launch's 0.0049 ms under CUDA events, and a chain runs rows - 1
// launches.  The kernel it replaced ran 64-thread CTAs through three dependent
// round trips: src into a __shared__ halo, a barrier, row[0], then the
// wall load that depends on it.  Here stencil1d's mapping:
// - a CTA of 8 warps covers 1,024 consecutive columns, a warp 128, a lane
//   4 adjacent ones (lower_cuda.pathfinder_ctas gives the CTA count);
// - the west and east neighbours come from the next lanes by
//   __shfl_up_sync / __shfl_down_sync; lanes 0 and 31 read theirs from
//   src with clamped loads.  No shared memory and no barrier;
// - two dependent round trips, not three: src, the two edge neighbours
//   and row[0] (lane 0, broadcast by shuffle) in the first, the wall row
//   in the second;
// - 16-byte loads of src and of the wall row, and 16-byte stores of dst,
//   where cols % 4 == 0 and the three buffers lie on 16-byte boundaries;
//   one-int accesses otherwise;
// - a programmatic dependent launch, as needle_nw's: only index
//   arithmetic before griddepcontrol.wait, griddepcontrol.launch_
//   dependents once the first round's loads are issued.
// A warp whose first column is at or past m returns whole, before the
// shuffles; a lane past m returns after them.  row[0] wraps once below 0
// and is clamped into [0, rows), the reference's gather rule.  int32
// throughout, so dst equals the plain version's bits.
// tools/pathfinder_variants.cu times this kernel beside the old one, the
// same mapping without the attribute, its one-int path and an empty
// kernel of the same CTAs with and without the attribute.  On an NVIDIA
// H100 80GB HBM3 at 700.00 W, two runs, 99 launches back to back on the
// first row: this kernel 1.369-1.375 us a launch, the old one 3.146-3.175,
// this mapping launched plainly 2.298-2.321, the one-int path 1.433-1.438,
// an empty kernel 0.66 as a dependent launch and 1.77-1.79 plainly.  The
// chain with its update kernels streamed: 5.53-5.55 us a row against
// 7.08-7.11; replayed as one CUDA graph: 3.99 against 4.08-4.11.  22
// registers (30 on the one-int path), no spills.  rows and cols are
// runtime arguments so one build serves every size.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlock = 64;                  // the chevron's block (check)
constexpr int kWarps = 8;                   // warps a CTA
constexpr int kVals = 4;                    // columns a lane
constexpr int kWarpVals = 32 * kVals;       // 128
constexpr unsigned kFull = 0xffffffffu;

bool aligned16(const void* p) {
  return reinterpret_cast<std::uintptr_t>(p) % 16 == 0;
}

}  // namespace

// kVec: cols % 4 == 0 and wall, src and dst on 16-byte boundaries.
template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
    pathfinder_rows(const int* __restrict__ wall,
                    const int* __restrict__ src, int* dst,
                    const int* __restrict__ row, int rows, int cols,
                    int m) {
  const int lane = threadIdx.x & 31;
  const long long w0 =
      ((long long)blockIdx.x * kWarps + threadIdx.x / 32) * kWarpVals;
  // a warp returns whole: every lane of a live warp joins the shuffles
  if (w0 >= m) return;
  const long long i0 = w0 + lane * kVals;
  const long long last = cols - 1LL;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  // round 1: this lane's columns, the warp's edge neighbours and row[0]
  int c[kVals];
  if (kVec && i0 < cols) {
    const int4 v = *reinterpret_cast<const int4*>(src + i0);
    c[0] = v.x, c[1] = v.y, c[2] = v.z, c[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < kVals; ++e) c[e] = src[min(i0 + e, last)];
  }
  const int wl = lane == 0 ? src[i0 > 0 ? i0 - 1 : 0] : 0;
  const int el = lane == 31 ? src[min(i0 + kVals, last)] : 0;
  const int r0 = lane == 0 ? row[0] : 0;
  asm volatile("griddepcontrol.launch_dependents;");
  int we = __shfl_up_sync(kFull, c[kVals - 1], 1);
  int ea = __shfl_down_sync(kFull, c[0], 1);
  int r = __shfl_sync(kFull, r0, 0);
  if (lane == 0) we = wl;
  if (lane == 31) ea = el;
  if (i0 >= m) return;                   // past the shuffles: no lane waits
  if (r < 0) r += rows;                  // gather rule: wrap once, clamp
  r = min(max(r, 0), rows - 1);
  const int* wr = wall + (size_t)r * cols;
  // round 2: the wall row
  int wv[kVals];
  if (kVec) {                            // i0 < m <= cols: 4 columns in
    const int4 v = *reinterpret_cast<const int4*>(wr + i0);
    wv[0] = v.x, wv[1] = v.y, wv[2] = v.z, wv[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < kVals; ++e) wv[e] = wr[min(i0 + e, last)];
  }
  int out[kVals];
#pragma unroll
  for (int e = 0; e < kVals; ++e)
    out[e] = wv[e] + min(min(e ? c[e - 1] : we, c[e]),
                         e < kVals - 1 ? c[e + 1] : ea);
  if (kVec && i0 + kVals <= m) {
    *reinterpret_cast<int4*>(dst + i0) =
        make_int4(out[0], out[1], out[2], out[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kVals; ++e)
      if (i0 + e < m) dst[i0 + e] = out[e];
  }
}

// The columns one CTA covers; lower_cuda.pathfinder_ctas gives the CTA
// count from it.
extern "C" int pathfinder_cta_cols() { return kWarps * kWarpVals; }

// The chevron's grid of kBlock-thread blocks, run as `ctas` CTAs of kWarps
// warps over the m = min(cols, grid kBlock) columns they write, launched
// as a programmatic dependent of the work before it on the stream.
extern "C" int launch_pathfinder(const int* wall, const int* src, int* dst,
                                 const int* row, int rows, int cols,
                                 int grid, int ctas, void* stream) {
  const long long gb = (long long)grid * kBlock;
  const int m = gb < cols ? (int)gb : cols;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (cols % 4 == 0 && aligned16(wall) && aligned16(src) && aligned16(dst))
    return (int)cudaLaunchKernelEx(&cfg, pathfinder_rows<true>, wall, src,
                                   dst, row, rows, cols, m);
  return (int)cudaLaunchKernelEx(&cfg, pathfinder_rows<false>, wall, src,
                                 dst, row, rows, cols, m);
}
