// stencil2d: the 5-point stencil y = 0.2 (c + n + s + w + e) on a 2-D grid
// (hotspot's shape), reads clamped to the array, stores dropped outside the
// grid.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_stencil2d
// (src/repro/core/cuda_suite.py:272).
//
// The chevron's logical blocks are 8 x 8 tiles (a genuinely 2-D dim3 block)
// on a (w/8, h/8) grid; the launch writes the cells (r, c) with
// r < min(h, 8 grid.y) and c < min(w, 8 grid.x), and y keeps its input past
// them.  Neighbours clamp to the array, not to the grid.
//
// Bound on the H100: memory.  x is read once and y written once (134 MB at
// 4096 x 4096): 0.040 ms at 3.35 TB/s, against five flops a cell.  A CTA
// of one 8 x 8 tile, which staged a 10 x 10 __shared__ halo behind a
// barrier, paid a block's start for 64 cells: 262,144 of them took
// 0.163 ms, the block count and not the bytes setting the time.  Here a
// CTA of 8 warps covers 8 rows x 128 columns (16 logical tiles; 16,384
// CTAs at 4096 x 4096), hotspot's mapping:
//   - each warp takes 128 columns of one row, a lane 4 adjacent columns,
//     loaded as float4s of its row and of the rows above and below when
//     w % 4 == 0 and x and y lie on 16-byte boundaries (one float an
//     access otherwise), all before the first store;
//   - the west and east neighbours come from the next lanes by
//     __shfl_up_sync / __shfl_down_sync; lanes 0 and 31 read theirs from
//     x (one float a row);
//   - no shared memory and no barrier: the rows above and below are the
//     next warps' own rows, read again from L1 or L2, not from DRAM.
// tools/stencil2d_variants.cu times this beside the 8 x 8 tile kernel,
// strips of several rows a warp and other CTA widths.  On an NVIDIA H100
// 80GB HBM3 at 700 W, at 4096 x 4096: this kernel 0.0502 ms, the old one
// 0.1630, a cudaMemcpyAsync of the same bytes 0.0496; strips of 2 or 4
// rows a warp and 4 to 16 warps a CTA all within 2 % of it, so the
// simplest stays; buffers off 16 bytes (one float an access) 0.0578
// (PERF.md has the rest).  The five terms are added left to right
// (centre, north, south, west, east) and scaled with __fadd_rn /
// __fmul_rn, as the reference orders them, so nvcc contracts nothing and
// y equals the plain version's and NumPy's bits.  h and w are runtime
// arguments.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8;                  // the chevron's logical tile
constexpr int kWarps = 8;                 // warps a CTA, a row each
constexpr int kCols = 4;                  // columns a lane
constexpr int kCtaCols = 32 * kCols;      // 128
constexpr unsigned kFull = 0xffffffffu;

// Columns c0 .. c0 + 3 of row r of x, each clamped to w - 1.
template <bool VEC4>
__device__ __forceinline__ void load_cols(const float* __restrict__ x,
                                          int r, int c0, int w,
                                          float (&v)[kCols]) {
  const float* row = x + (size_t)r * w;
  if (VEC4 && c0 < w) {
    const float4 q = *reinterpret_cast<const float4*>(row + c0);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e) v[e] = row[min(c0 + e, w - 1)];
  }
}

// The reference's order: (((c + n) + s) + w) + e, then 0.2 times it.
__device__ __forceinline__ float stencil(float c, float n, float s, float we,
                                         float ea) {
  float v = __fadd_rn(c, n);
  v = __fadd_rn(v, s);
  v = __fadd_rn(v, we);
  v = __fadd_rn(v, ea);
  return __fmul_rn(0.2f, v);
}

// The cells (r, c), r < nr and c < nc, of an [h, w] array.
template <bool VEC4>
__global__ void __launch_bounds__(kWarps * 32)
    stencil2d_rows(const float* __restrict__ x, float* y, int h, int w,
                   int nr, int nc) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.y * kWarps + (threadIdx.x >> 5);
  const int cw = blockIdx.x * kCtaCols;   // the warp's first column
  // a warp returns whole: every lane of a live warp joins the shuffles
  if (r >= nr || cw >= nc) return;
  const int c0 = cw + lane * kCols;
  float n[kCols], c[kCols], s[kCols];
  load_cols<VEC4>(x, max(r - 1, 0), c0, w, n);
  load_cols<VEC4>(x, r, c0, w, c);
  load_cols<VEC4>(x, min(r + 1, h - 1), c0, w, s);
  const float* row = x + (size_t)r * w;
  float we = __shfl_up_sync(kFull, c[kCols - 1], 1);
  float ea = __shfl_down_sync(kFull, c[0], 1);
  if (lane == 0) we = row[max(c0 - 1, 0)];
  if (lane == 31) ea = row[min(c0 + kCols, w - 1)];
  if (c0 >= nc) return;                  // past the shuffles: no lane waits
  float out[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e)
    out[e] = stencil(c[e], n[e], s[e], e ? c[e - 1] : we,
                     e < kCols - 1 ? c[e + 1] : ea);
  float* dst = y + (size_t)r * w + c0;
  if (VEC4) {      // nc % 4 == 0 here, so the four are all below it
    *reinterpret_cast<float4*>(dst) =
        make_float4(out[0], out[1], out[2], out[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e)
      if (c0 + e < nc) dst[e] = out[e];
  }
}

bool aligned16(const void* a) {
  return (reinterpret_cast<size_t>(a) & 15) == 0;
}

}  // namespace

// The rows and columns of the [h, w] array that one CTA covers;
// lower_cuda.stencil2d_ctas gives the CTA grid from them.
extern "C" int stencil2d_cta_rows() { return kWarps; }
extern "C" int stencil2d_cta_cols() { return kCtaCols; }

// The chevron's (grid_x, grid_y) of 8 x 8 tiles, run as (ctas_x, ctas_y)
// CTAs of kWarps x kCtaCols cells.
extern "C" int launch_stencil2d(const float* x, float* y, int h, int w,
                                int grid_x, int grid_y, int ctas_x,
                                int ctas_y, void* stream) {
  const long long gy = (long long)grid_y * kTile;
  const long long gx = (long long)grid_x * kTile;
  const int nr = gy < h ? (int)gy : h, nc = gx < w ? (int)gx : w;
  const dim3 grid(ctas_x, ctas_y), block(kWarps * 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (w % 4 == 0 && aligned16(x) && aligned16(y))
    stencil2d_rows<true><<<grid, block, 0, s>>>(x, y, h, w, nr, nc);
  else
    stencil2d_rows<false><<<grid, block, 0, s>>>(x, y, h, w, nr, nc);
  return (int)cudaGetLastError();
}
