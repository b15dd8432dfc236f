// vecadd: the paper's Listing 1, c[i] = a[i] + b[i] for i < n.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_vecadd
// (src/repro/core/cuda_suite.py:68).
//
// Bound on the H100: memory.  Each element is read twice and written once
// (201 MB at n = 2^24), with one add: 0.060 ms at 3.35 TB/s.  One thread
// per element, as the reference's launch has, neighbouring threads on
// neighbouring addresses so every warp's loads and store coalesce.  The
// add is one rounding, as NumPy's, so c equals the oracle bit for bit.
// `n` is a runtime argument; threads at or past n write nothing.
#include <cuda_runtime.h>

__global__ void vecadd_kernel(const float* __restrict__ a,
                              const float* __restrict__ b, float* c, int n) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid < n) c[gid] = __fadd_rn(a[gid], b[gid]);
}

extern "C" int launch_vecadd(const float* a, const float* b, float* c, int n,
                             int grid, int block, void* stream) {
  vecadd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a, b, c, n);
  return (int)cudaGetLastError();
}
