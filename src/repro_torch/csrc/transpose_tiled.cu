// transpose_tiled: y[w, h] = x[h, w] transposed, for the 8 x 8 tiles that
// the logical grid covers.  The reference's launch is one 64-thread block
// per 8 x 8 tile: block bid = by * (w/8) + bx on a 1-D grid owns tile
// (by, bx), loads it into an 8 x 8 __shared__ tile along its rows, and
// after one barrier stores the tile's columns along y's rows.  y keeps its
// bits outside the tiles the grid covers (bid >= grid).
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_transpose_tiled
// (src/repro/core/cuda_suite.py:387).
//
// Bound on the H100: memory.  x is read once and y written once (134 MB
// at 4096 x 4096): 0.040 ms at 3.35 TB/s, with no arithmetic.  The
// reference's CTA moves 256 bytes in and 256 out behind a barrier, one
// 4-byte load in flight a thread, and a warp touches four 32-byte row
// segments on each side: far too few bytes in flight to keep the memory
// busy.  So a physical CTA of kThreads threads moves a kT x kT square
// (64 x 64: 64 logical tiles):
// - it works in 32 x 32 sub-squares; in one pass a warp moves four
//   128-byte row segments of one, a float4 a lane, on both sides;
// - every load of the square (four float4s a thread) is issued before
//   the first store into the __shared__ square, and one barrier
//   separates the stores from the reads;
// - the square's rows are padded by one float, so a warp's column reads
//   t[b + e][a] (eight values of b four apart, four of a) hit 32
//   different banks, as do its row stores: no conflict on either side.
// tools/transpose_tiled_variants.cu times the square at 32 and 64,
// padding on and off, and one to sixteen floats a thread: all within 3 %
// of each other and of cudaMemcpyAsync of the same bytes on an H100, so
// once enough bytes are in flight the memory's mix of reads and writes,
// not the shared-memory side, sets the pace.
//
// Physical to logical: the chevron's grid and block stay the entry's
// (262,144 blocks of 64 at 4096 x 4096).  The wrapper gives the launcher
// a physical grid of ceil(covered columns / kT) x ceil(covered rows / kT)
// squares (lower_cuda.transpose_tiled_ctas, which reads kT from
// transpose_tiled_side below; 4,096 at 4096 x 4096); a square may reach
// past h or w (both are multiples of 8, not of kT) and past the logical
// grid, so each float4 is loaded only inside x and stored only where its
// logical tile (row/8) * (w/8) + col/8 is below the grid.  A float4 never
// straddles two tiles.  A copy: y equals x's bits.
// stencil2d has the same 8 x 8 geometry and can take the same mapping.
//
// Alignment: the float4 accesses need x and y on 16-byte boundaries (their
// rows are: h and w are multiples of 8).  The wrapper checks only that
// the buffers are contiguous, so for views off 16 bytes the launcher
// starts the instantiation that moves one float an access, sixteen a
// thread, with the same square and mapping.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kLogical = 8;   // the reference's tile
constexpr int kSub = 32;      // the sub-square a pass of the CTA covers
constexpr int kT = 64;        // the physical square
constexpr int kThreads = 256;

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using type = float4;
  static __device__ __forceinline__ float get(const float4& v, int e) {
    return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
  }
  static __device__ __forceinline__ float4 make(const float (&f)[4]) {
    return make_float4(f[0], f[1], f[2], f[3]);
  }
};
template <>
struct Vec<1> {
  using type = float;
  static __device__ __forceinline__ float get(float v, int) { return v; }
  static __device__ __forceinline__ float make(const float (&f)[1]) {
    return f[0];
  }
};

// VEC: floats an access.  Item u of a thread is, in sub-square u /
// kPasses, the row (u % kPasses) * kRows + tid / kLanes and the VEC
// columns from (tid % kLanes) * VEC; the stores take the same item as
// (row of y, VEC columns of y).
template <int VEC>
__global__ void __launch_bounds__(kThreads)
    transpose_square_kernel(const float* __restrict__ x,
                            float* __restrict__ y, int h, int w,
                            int grid) {
  using V = typename Vec<VEC>::type;
  constexpr int kLanes = kSub / VEC;        // threads across a sub-row
  constexpr int kRows = kThreads / kLanes;  // sub-rows a pass
  static_assert(kT % kSub == 0 && kSub % kRows == 0 && kLogical % VEC == 0,
                "the passes must tile the square");
  constexpr int kPasses = kSub / kRows;
  constexpr int kSubs = kT / kSub;
  constexpr int kItems = kSubs * kSubs * kPasses;
  __shared__ float t[kT][kT + 1];   // padded by one float: no conflicts

  const int tid = threadIdx.x;
  const int r0 = blockIdx.y * kT, c0 = blockIdx.x * kT;
  const int lr = tid / kLanes, lc = (tid % kLanes) * VEC;
  V v[kItems];
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int s = u / kPasses;
    const int r = (s / kSubs) * kSub + (u % kPasses) * kRows + lr;
    const int c = (s % kSubs) * kSub + lc;
    if (r0 + r < h && c0 + c < w)
      v[u] = *reinterpret_cast<const V*>(x + (size_t)(r0 + r) * w + c0 + c);
    else
      v[u] = V{};
  }
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int s = u / kPasses;
    const int r = (s / kSubs) * kSub + (u % kPasses) * kRows + lr;
    const int c = (s % kSubs) * kSub + lc;
#pragma unroll
    for (int e = 0; e < VEC; ++e) t[r][c + e] = Vec<VEC>::get(v[u], e);
  }
  __syncthreads();
  const long long tiles_w = w / kLogical;
#pragma unroll
  for (int u = 0; u < kItems; ++u) {
    const int s = u / kPasses;
    // a: y's row (x's column c0 + a); b: y's columns (x's rows r0 + b ..)
    const int a = (s / kSubs) * kSub + (u % kPasses) * kRows + lr;
    const int b = (s % kSubs) * kSub + lc;
    const int xr = r0 + b, xc = c0 + a;
    if (xr < h && xc < w &&
        (xr / kLogical) * tiles_w + xc / kLogical < grid) {
      float f[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) f[e] = t[b + e][a];
      *reinterpret_cast<V*>(y + (size_t)xc * h + xr) = Vec<VEC>::make(f);
    }
  }
}

template <int VEC>
cudaError_t launch_square(const float* x, float* y, int h, int w, int grid,
                          int ctas_x, int ctas_y, cudaStream_t stream) {
  transpose_square_kernel<VEC>
      <<<dim3(ctas_x, ctas_y), kThreads, 0, stream>>>(x, y, h, w, grid);
  return cudaGetLastError();
}

}  // namespace

// h, w: multiples of 8 with grid <= (h/8) (w/8) logical tiles (the
// wrapper checks both); ctas_x, ctas_y: the physical grid of kT x kT
// squares that covers them (lower_cuda.transpose_tiled_ctas).
extern "C" int launch_transpose_tiled(const float* x, float* y, int h,
                                      int w, int grid, int ctas_x,
                                      int ctas_y, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t any =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  return (int)(any % 16 ? launch_square<1>(x, y, h, w, grid, ctas_x, ctas_y,
                                           s)
                        : launch_square<4>(x, y, h, w, grid, ctas_x, ctas_y,
                                           s));
}

// The side of the square of x that one physical CTA moves (kT), from
// which lower_cuda.transpose_tiled_ctas computes the physical grid.
extern "C" int transpose_tiled_side() { return kT; }
