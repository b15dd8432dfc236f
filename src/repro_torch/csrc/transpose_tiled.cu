// transpose_tiled: y[w, h] = x[h, w] transposed through 8 x 8 __shared__
// tiles.  Block bid = by * (w/8) + bx on a 1-D grid owns tile (by, bx); its
// 64 threads are ty = tid / 8, tx = tid % 8.  Each thread loads
// x[by*8 + ty][bx*8 + tx] into t[ty][tx], one barrier, then stores t[tx][ty]
// to y[bx*8 + ty][by*8 + tx]: both the load and the store run along rows.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_transpose_tiled
// (src/repro/core/cuda_suite.py:387).
//
// Bound on the H100: memory.  x is read once and y written once (134 MB at
// 4096 x 4096): 0.040 ms at 3.35 TB/s, with no arithmetic.  The tile is the
// reference's 8 x 8, so a warp touches four rows of 32 bytes on each side,
// and the column read t[tx][ty] meets 2-way bank conflicts; padding the
// tile or widening it is later work.  A copy: y equals x's bits.  h and w
// are runtime arguments (multiples of 8); the wrapper keeps the grid within
// the (h/8) (w/8) tiles.
#include <cuda_runtime.h>

#define TT_TILE 8

__global__ void transpose_tiled_kernel(const float* __restrict__ x,
                                       float* y, int h, int w) {
  __shared__ float t[TT_TILE][TT_TILE];
  const int ty = threadIdx.x / TT_TILE, tx = threadIdx.x % TT_TILE;
  const int ntx = w / TT_TILE;
  const int by = blockIdx.x / ntx, bx = blockIdx.x % ntx;
  t[ty][tx] = x[(size_t)(by * TT_TILE + ty) * w + bx * TT_TILE + tx];
  __syncthreads();
  y[(size_t)(bx * TT_TILE + ty) * h + by * TT_TILE + tx] = t[tx][ty];
}

extern "C" int launch_transpose_tiled(const float* x, float* y, int h,
                                      int w, int grid, void* stream) {
  transpose_tiled_kernel<<<grid, TT_TILE * TT_TILE, 0,
                           (cudaStream_t)stream>>>(x, y, h, w);
  return (int)cudaGetLastError();
}
