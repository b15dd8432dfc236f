// matmul_tiled: c[m, n] = a[m, k] @ b[k, n] in 8 x 8 output tiles.  Block
// bid = by * (n/8) + bx on a 1-D grid owns tile (by, bx); its 64 threads
// are ty = tid / 8, tx = tid % 8.  For each of the k/8 k-tiles the block
// stages an 8 x 8 tile of a and of b in __shared__ memory, barriers, adds
// the tile's 8-term dot product into a register accumulator, and barriers
// again: the accumulator lives across 2 * k/8 barriers.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_matmul_tiled
// (src/repro/core/cuda_suite.py:196).
//
// Bound on the H100: operations.  2 m n k flops (1.72e10 at 2048^3) over
// 67 TFLOP/s of float32 outside the tensor cores is 0.256 ms; the 50 MB
// of a, b and c take 0.015 ms.  The design is the reference's, tile for
// tile: each block reads 2 * 64 floats a k-tile for 1024 flops, so the
// loads (from L2, 8.6 GB in all at 2048^3) and the two barriers a k-tile,
// not the multiply-adds, set the time.  Full float32 on the CUDA cores,
// no TF32.  Inside a k-tile the 8 products are chained with fmaf (the
// reference's einsum fixes no order there), then added to the accumulator
// with one rounding, as the reference's acc + tile sum; c agrees with the
// plain version and the oracle within the entry's tolerance, not bit for
// bit.  m, n, k (multiples of 8) are runtime arguments.
#include <cuda_runtime.h>

#define MM_TILE 8

__global__ void matmul_tiled_kernel(const float* __restrict__ a,
                                    const float* __restrict__ b, float* c,
                                    int n, int k) {
  __shared__ float sa[MM_TILE][MM_TILE];
  __shared__ float sb[MM_TILE][MM_TILE];
  const int ty = threadIdx.x / MM_TILE, tx = threadIdx.x % MM_TILE;
  const int ntn = n / MM_TILE;
  const int row = (blockIdx.x / ntn) * MM_TILE + ty;
  const int col = (blockIdx.x % ntn) * MM_TILE + tx;
  float acc = 0.0f;
  for (int kk = 0; kk < k; kk += MM_TILE) {
    sa[ty][tx] = a[(size_t)row * k + kk + tx];
    sb[ty][tx] = b[(size_t)(kk + ty) * n + col];
    __syncthreads();
    float part = 0.0f;
#pragma unroll
    for (int i = 0; i < MM_TILE; ++i) part = fmaf(sa[ty][i], sb[i][tx], part);
    acc = __fadd_rn(acc, part);
    __syncthreads();
  }
  c[(size_t)row * n + col] = acc;
}

// The wrapper keeps grid <= (m/8) * (n/8), so every row is below m.
extern "C" int launch_matmul_tiled(const float* a, const float* b, float* c,
                                   int n, int k, int grid, void* stream) {
  matmul_tiled_kernel<<<grid, MM_TILE * MM_TILE, 0, (cudaStream_t)stream>>>(
      a, b, c, n, k);
  return (int)cudaGetLastError();
}
