// scan_block: the Hillis-Steele inclusive prefix sum within each block.
// Each thread loads x[gid] into __shared__ s[t]; for d = 1, 2, 4, ... below
// the block, it reads s[t - d] (0.0 for t < d), barriers, adds it into its
// own value, stores that to s[t], and barriers again: log2(block) read /
// write pairs, as the reference's stages.  Then y[gid] = its value.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_scan_block
// (src/repro/core/cuda_suite.py:344).
//
// Bound on the H100: memory.  x is read once and y written once (134 MB at
// n = 2^24): 0.040 ms at 3.35 TB/s, against log2(block) adds an element.
// The 2 log2(block) + 1 barriers (15 at block 128) are what the design
// pays to keep the reference's order: the read before the barrier and the
// write after it keep one level's reads from seeing its writes.  Every
// level adds with __fadd_rn, the 0.0 too (so a -0.0 input becomes +0.0 as
// in the reference), so y equals the plain version and the reference bit
// for bit; NumPy's cumsum adds in sequence, so the oracle holds it within
// the entry's tolerance.  The block is a power of two up to 1024, and the
// wrapper keeps grid * block within x.
#include <cuda_runtime.h>

#define SCAN_MAX_THREADS 1024

__global__ void scan_block_kernel(const float* __restrict__ x, float* y) {
  __shared__ float s[SCAN_MAX_THREADS];
  const int t = threadIdx.x;
  const size_t gid = (size_t)blockIdx.x * blockDim.x + t;
  float v = x[gid];
  s[t] = v;
  __syncthreads();
  for (int d = 1; d < (int)blockDim.x; d <<= 1) {
    const float add = t >= d ? s[t - d] : 0.0f;
    __syncthreads();
    v = __fadd_rn(v, add);
    s[t] = v;
    __syncthreads();
  }
  y[gid] = v;
}

extern "C" int launch_scan_block(const float* x, float* y, int grid,
                                 int block, void* stream) {
  scan_block_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, y);
  return (int)cudaGetLastError();
}
