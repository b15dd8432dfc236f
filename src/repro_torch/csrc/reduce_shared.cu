// reduce_shared: the classic barrier-tree block reduction.  Each thread
// loads x[gid] (0 past n) into __shared__ memory; then for off = blockDim/2
// down to 1, threads t < off add s[t + off] into s[t], a barrier after
// each level; thread 0 writes the block's sum to out[blockIdx].
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_reduce_shared
// (src/repro/core/cuda_suite.py:126).
//
// Bound on the H100: memory.  x is read once (67 MB at n = 2^24): 0.020
// ms at 3.35 TB/s, against one add an element.  The tree is the
// reference's, level for level, with __fadd_rn, so each sum equals the
// plain version's (and the reference's) bit for bit; the oracle, NumPy's
// pairwise sum, holds it within the entry's tolerance.  The block is a
// power of two up to 1024, as the reference's shared array is.
#include <cuda_runtime.h>

#define REDUCE_MAX_THREADS 1024

__global__ void reduce_shared_kernel(const float* __restrict__ x, float* out,
                                     int n, int n_out) {
  __shared__ float s[REDUCE_MAX_THREADS];
  const int t = threadIdx.x;
  const long long gid = (long long)blockIdx.x * blockDim.x + t;
  s[t] = gid < n ? x[gid] : 0.0f;
  __syncthreads();
  for (int off = blockDim.x / 2; off >= 1; off >>= 1) {
    if (t < off) s[t] = __fadd_rn(s[t], s[t + off]);
    __syncthreads();
  }
  if (t == 0 && (int)blockIdx.x < n_out) out[blockIdx.x] = s[0];
}

extern "C" int launch_reduce_shared(const float* x, float* out, int n,
                                    int n_out, int grid, int block,
                                    void* stream) {
  reduce_shared_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, out, n,
                                                                 n_out);
  return (int)cudaGetLastError();
}
