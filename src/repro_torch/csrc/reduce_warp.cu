// reduce_warp: the shuffle-based block reduction (Crystal q11-q13).  Each
// thread loads x[gid] (0 past n); each warp runs the __shfl_xor_sync
// butterfly v += shfl_xor(v, off) for off = 16, 8, 4, 2, 1; lane 0 puts
// its warp's sum in s[warp]; after a barrier, warp 0 runs the same
// butterfly over s[t] for t < nwarps (0 in the other lanes), and thread 0
// writes out[blockIdx].
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_reduce_warp
// (src/repro/core/cuda_suite.py:162).
//
// Bound on the H100: memory.  x is read once (67 MB at n = 2^24): 0.020
// ms at 3.35 TB/s.  The butterflies are the reference's, level for level,
// with __fadd_rn, so each sum equals the plain version's (and the
// reference's) bit for bit; the oracle, NumPy's pairwise sum, holds it
// within the entry's tolerance.  One barrier a block, against the shared
// tree's eight at 256 threads.  The block is a whole number of warps, up
// to 1024 threads.
#include <cuda_runtime.h>

#define FULL_MASK 0xffffffffu

__device__ __forceinline__ float butterfly(float v) {
  for (int off = 16; off >= 1; off >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(FULL_MASK, v, off));
  return v;
}

__global__ void reduce_warp_kernel(const float* __restrict__ x, float* out,
                                   int n, int n_out) {
  __shared__ float s[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const long long gid = (long long)blockIdx.x * blockDim.x + t;
  const float v = butterfly(gid < n ? x[gid] : 0.0f);
  if (lane == 0) s[warp] = v;
  __syncthreads();
  if (warp == 0) {
    const float w = butterfly(t < nwarps ? s[t] : 0.0f);
    if (t == 0 && (int)blockIdx.x < n_out) out[blockIdx.x] = w;
  }
}

extern "C" int launch_reduce_warp(const float* x, float* out, int n,
                                  int n_out, int grid, int block,
                                  void* stream) {
  reduce_warp_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, out, n,
                                                               n_out);
  return (int)cudaGetLastError();
}
