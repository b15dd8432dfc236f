// hotspot: one step of the RC thermal model on a 2-D grid (Rodinia
// hotspot), edges clamped:
//   t' = t + cap * (p + ry*(N + S - 2t) + rx*(W + E - 2t) + rz*(amb - t))
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`)
// applied to make_hotspot (src/repro/core/cuda_suite.py:1018).
//
// The chevron's logical blocks are 8 x 8 tiles on a (w/8, h/8) grid; the
// launch writes the cells (r, c) with r < min(h, 8 grid.y) and c < min(w,
// 8 grid.x), and t_out keeps its input past them.  Neighbours clamp to the
// array, not to the grid.
//
// Bound on the H100: memory (three float reads and one write a cell,
// about 15 flops).  A CTA of one 8 x 8 tile paid a block's start for 64
// cells and staged a 10 x 10 halo for them; here a CTA of 8 warps covers
// 8 rows x 128 columns (16 logical tiles), each warp 128 columns of one
// row, a lane 4 adjacent columns:
//   - a lane loads its 4 columns of the row of t, of the rows above and
//     below, and of p, as float4s when w % 4 == 0 and the buffers lie on
//     16-byte boundaries, all before the first store;
//   - the west and east neighbours come from the next lanes by
//     __shfl_up_sync / __shfl_down_sync; lanes 0 and 31 read theirs from
//     t (one float a row, which the next CTA's warp also loads);
//   - no shared memory and no barrier: the rows above and below are the
//     next warps' own rows, read again from L1 or L2, not from DRAM.
// At 1024 x 1024 that is 1,024 CTAs against 16,384.  Strips of 2 to 8
// rows a warp, 4 to 16 warps a CTA and a haloed __shared__ region staged
// by float4s all took longer there (tools/hotspot_variants.cu times
// them; PERF.md has the numbers).  t, p and t_out (12 MB) fit in the
// 50 MB L2, so repeated steps may read from L2 rather than
// DRAM.  The arithmetic is written with __fmul_rn / __fadd_rn / __fsub_rn
// in the plain version's order, so nvcc contracts nothing into an FMA and
// t_out equals the plain version bit for bit; bound by bytes, an FMA
// would buy nothing.  t and p are read through `const float*
// __restrict__` (4 MB each at 1024^2, far past the 64 KB __constant__
// bank).
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 8;                  // the chevron's logical tile
constexpr int kWarps = 8;                 // warps a CTA, a row each
constexpr int kCols = 4;                  // columns a lane
constexpr int kCtaCols = 32 * kCols;      // 128
constexpr unsigned kFull = 0xffffffffu;

struct Coeffs {
  float cap, rx, ry, rz, amb;
};

// Columns c0 .. c0 + 3 of row r of a, each clamped to w - 1.
template <bool VEC4>
__device__ __forceinline__ void load_cols(const float* __restrict__ a,
                                          int r, int c0, int w,
                                          float (&x)[kCols]) {
  const float* row = a + (size_t)r * w;
  if (VEC4 && c0 < w) {
    const float4 v = *reinterpret_cast<const float4*>(row + c0);
    x[0] = v.x, x[1] = v.y, x[2] = v.z, x[3] = v.w;
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e) x[e] = row[min(c0 + e, w - 1)];
  }
}

// The plain version's order: tc + cap * (((p + ry*(N + S - 2tc))
// + rx*(W + E - 2tc)) + rz*(amb - tc)), each operation rounded alone.
__device__ __forceinline__ float step(float tc, float pc, float n, float s,
                                      float we, float ea, const Coeffs& k) {
  const float tc2 = __fmul_rn(2.0f, tc);
  const float dy = __fmul_rn(k.ry, __fsub_rn(__fadd_rn(n, s), tc2));
  const float dx = __fmul_rn(k.rx, __fsub_rn(__fadd_rn(we, ea), tc2));
  const float dz = __fmul_rn(k.rz, __fsub_rn(k.amb, tc));
  const float sum = __fadd_rn(__fadd_rn(__fadd_rn(pc, dy), dx), dz);
  return __fadd_rn(tc, __fmul_rn(k.cap, sum));
}

// The cells (r, c), r < nr and c < nc, of an [h, w] grid.
template <bool VEC4>
__global__ void __launch_bounds__(kWarps * 32)
    hotspot_rows(const float* __restrict__ t, const float* __restrict__ p,
                 float* t_out, int h, int w, int nr, int nc, Coeffs k) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.y * kWarps + (threadIdx.x >> 5);
  const int cw = blockIdx.x * kCtaCols;   // the warp's first column
  // a warp returns whole: every lane of a live warp joins the shuffles
  if (r >= nr || cw >= nc) return;
  const int c0 = cw + lane * kCols;
  float n[kCols], tc[kCols], s[kCols], pc[kCols];
  load_cols<VEC4>(t, max(r - 1, 0), c0, w, n);
  load_cols<VEC4>(t, r, c0, w, tc);
  load_cols<VEC4>(t, min(r + 1, h - 1), c0, w, s);
  load_cols<VEC4>(p, r, c0, w, pc);
  const float* row = t + (size_t)r * w;
  float we = __shfl_up_sync(kFull, tc[kCols - 1], 1);
  float ea = __shfl_down_sync(kFull, tc[0], 1);
  if (lane == 0) we = row[max(c0 - 1, 0)];
  if (lane == 31) ea = row[min(c0 + kCols, w - 1)];
  if (c0 >= nc) return;                  // past the shuffles: no lane waits
  float out[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e)
    out[e] = step(tc[e], pc[e], n[e], s[e], e ? tc[e - 1] : we,
                  e < kCols - 1 ? tc[e + 1] : ea, k);
  float* dst = t_out + (size_t)r * w + c0;
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

// The rows and columns of the [h, w] grid that one CTA covers;
// lower_cuda.hotspot_ctas gives the CTA grid from them.
extern "C" int hotspot_cta_rows() { return kWarps; }
extern "C" int hotspot_cta_cols() { return kCtaCols; }

// The chevron's (grid_x, grid_y) of 8 x 8 tiles, run as (ctas_x, ctas_y)
// CTAs of kWarps x kCtaCols cells.
extern "C" int launch_hotspot(const float* t, const float* p, float* t_out,
                              int h, int w, float cap, float rx, float ry,
                              float rz, float amb, int grid_x, int grid_y,
                              int ctas_x, int ctas_y, void* stream) {
  const long long gy = (long long)grid_y * kTile;
  const long long gx = (long long)grid_x * kTile;
  const int nr = gy < h ? (int)gy : h, nc = gx < w ? (int)gx : w;
  const Coeffs k{cap, rx, ry, rz, amb};
  const dim3 grid(ctas_x, ctas_y), block(kWarps * 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (w % 4 == 0 && aligned16(t) && aligned16(p) && aligned16(t_out))
    hotspot_rows<true><<<grid, block, 0, s>>>(t, p, t_out, h, w, nr, nc, k);
  else
    hotspot_rows<false><<<grid, block, 0, s>>>(t, p, t_out, h, w, nr, nc, k);
  return (int)cudaGetLastError();
}
