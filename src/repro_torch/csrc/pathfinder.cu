// pathfinder: one row of the row-wavefront dynamic program (Rodinia
// pathfinder): dst[c] = wall[r, c] + min(src[c-1], src[c], src[c+1]),
// edges clamped.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`)
// applied to make_pathfinder (src/repro/core/cuda_suite.py:501).
//
// Bound on the H100: memory, with little work per byte (one row of src
// and wall read, one row of dst written per launch; 1.2 MB at 100k
// columns, so a launch is also short enough for launch overhead to
// matter).  Each 64-thread block stages its slice of src plus a one-cell
// halo on each side in __shared__ memory, so each src word is read from
// device memory about once; loads and stores are coalesced.  `rows` and
// `cols` are runtime arguments so one build serves every size.
#include <cuda_runtime.h>

#define PF_BLOCK 64

__global__ void pathfinder_kernel(const int* __restrict__ wall,
                                  const int* __restrict__ src, int* dst,
                                  const int* __restrict__ row, int rows,
                                  int cols) {
  __shared__ int s[PF_BLOCK + 2];
  const int tid = threadIdx.x;
  const int col = blockIdx.x * PF_BLOCK + tid;
  const int c = min(max(col, 0), cols - 1);
  s[tid + 1] = src[c];
  if (tid == 0) s[0] = src[min(max(col - 1, 0), cols - 1)];
  if (tid == PF_BLOCK - 1) s[PF_BLOCK + 1] = src[min(max(col + 1, 0), cols - 1)];
  __syncthreads();
  int r = row[0];
  if (r < 0) r += rows;                 // gather rule: wrap once, clamp
  r = min(max(r, 0), rows - 1);
  const int best = min(min(s[tid], s[tid + 1]), s[tid + 2]);
  if (col < cols) dst[col] = wall[(size_t)r * cols + c] + best;
}

extern "C" int launch_pathfinder(const int* wall, const int* src, int* dst,
                                 const int* row, int rows, int cols,
                                 int grid, void* stream) {
  pathfinder_kernel<<<grid, PF_BLOCK, 0, (cudaStream_t)stream>>>(
      wall, src, dst, row, rows, cols);
  return (int)cudaGetLastError();
}
