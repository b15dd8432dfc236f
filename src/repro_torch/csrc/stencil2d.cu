// stencil2d: the 5-point stencil y = 0.2 (c + n + s + w + e) on a 2-D grid
// (hotspot's shape), reads clamped to the grid, stores dropped outside it.
// blockIdx and threadIdx are genuinely 2-D: each 8x8 block (dim3) stages
// its tile in a __shared__ float[10][10], the threads on the tile's four
// edges load the one-cell halo, one barrier, then each thread reads its
// four neighbours from shared memory.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_stencil2d
// (src/repro/core/cuda_suite.py:272).
//
// Bound on the H100: memory.  x is read once and y written once (134 MB at
// 4096 x 4096): 0.040 ms at 3.35 TB/s, against five flops a cell.  The
// halo adds 32 loads to a block's 64, mostly from L2.  The five terms are
// added left to right (centre, north, south, west, east) and scaled with
// __fadd_rn/__fmul_rn, as the reference orders them, so y equals the
// reference's and NumPy's bits.  h and w are runtime arguments.
#include <cuda_runtime.h>

#define ST2_TILE 8

__global__ void stencil2d_kernel(const float* __restrict__ x, float* y,
                                 int h, int w) {
  __shared__ float s[ST2_TILE + 2][ST2_TILE + 2];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.y * ST2_TILE + ty;
  const int col = blockIdx.x * ST2_TILE + tx;
  auto at = [&](int r, int c) {
    r = min(max(r, 0), h - 1);
    c = min(max(c, 0), w - 1);
    return x[(size_t)r * w + c];
  };
  s[ty + 1][tx + 1] = at(row, col);
  if (ty == 0) s[0][tx + 1] = at(row - 1, col);
  if (ty == ST2_TILE - 1) s[ST2_TILE + 1][tx + 1] = at(row + 1, col);
  if (tx == 0) s[ty + 1][0] = at(row, col - 1);
  if (tx == ST2_TILE - 1) s[ty + 1][ST2_TILE + 1] = at(row, col + 1);
  __syncthreads();
  if (row < h && col < w) {
    float v = __fadd_rn(s[ty + 1][tx + 1], s[ty][tx + 1]);
    v = __fadd_rn(v, s[ty + 2][tx + 1]);
    v = __fadd_rn(v, s[ty + 1][tx]);
    v = __fadd_rn(v, s[ty + 1][tx + 2]);
    y[(size_t)row * w + col] = __fmul_rn(0.2f, v);
  }
}

extern "C" int launch_stencil2d(const float* x, float* y, int h, int w,
                                int grid_x, int grid_y, void* stream) {
  stencil2d_kernel<<<dim3(grid_x, grid_y), dim3(ST2_TILE, ST2_TILE), 0,
                     (cudaStream_t)stream>>>(x, y, h, w);
  return (int)cudaGetLastError();
}
