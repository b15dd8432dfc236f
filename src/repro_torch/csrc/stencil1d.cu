// stencil1d: the 3-point stencil y[i] = 0.25 x[i-1] + 0.5 x[i] + 0.25 x[i+1]
// (hotspot in one dimension), reads clamped to [0, n-1], stores dropped at
// or past n.  Each block stages its x values in __shared__ s[1..block],
// thread 0 loads the left halo s[0] and thread block-1 the right halo
// s[block+1], one barrier, then each thread reads its three neighbours
// from shared memory.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_stencil1d
// (src/repro/core/cuda_suite.py:244).
//
// Bound on the H100: memory.  x is read once and y written once (134 MB at
// n = 2^24): 0.040 ms at 3.35 TB/s, against five flops an element.  One
// thread per element, neighbouring threads on neighbouring addresses, as
// the reference's launch has; the halo costs two extra loads a block.  The
// sum is added left to right with __fmul_rn/__fadd_rn, so nvcc cannot
// contract it into FMAs, and y equals the reference's and NumPy's bits.
// The block is the one the kernel was made for, up to 1024 threads.
#include <cuda_runtime.h>

#define ST1_MAX_THREADS 1024

__device__ __forceinline__ float clamped(const float* __restrict__ x,
                                         long long i, int n) {
  return x[i < 0 ? 0 : (i >= n ? n - 1 : i)];
}

__global__ void stencil1d_kernel(const float* __restrict__ x, float* y,
                                 int n) {
  __shared__ float s[ST1_MAX_THREADS + 2];
  const int t = threadIdx.x;
  const long long gid = (long long)blockIdx.x * blockDim.x + t;
  s[t + 1] = clamped(x, gid, n);
  if (t == 0) s[0] = clamped(x, gid - 1, n);
  if (t == (int)blockDim.x - 1) s[blockDim.x + 1] = clamped(x, gid + 1, n);
  __syncthreads();
  if (gid < n)
    y[gid] = __fadd_rn(__fadd_rn(__fmul_rn(0.25f, s[t]),
                                 __fmul_rn(0.5f, s[t + 1])),
                       __fmul_rn(0.25f, s[t + 2]));
}

extern "C" int launch_stencil1d(const float* x, float* y, int n, int grid,
                                int block, void* stream) {
  stencil1d_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, y, n);
  return (int)cudaGetLastError();
}
