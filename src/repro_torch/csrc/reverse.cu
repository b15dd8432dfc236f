// reverse: the paper's Listing 3 (dynamicReverse).  One block stages d in
// an extern __shared__ array whose extent the launch gives, barriers, and
// writes it back reversed: d[t] = s[ns - 1 - t], ns = the array's length.
// A grid of g blocks, which the reference runs one after another on the
// same d, runs as g passes of the one physical block, a barrier between
// each pass's reads of s and the next pass's writes (as backprop maps its
// wide logical block onto the threads it has).
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_reverse
// (src/repro/core/cuda_suite.py:83).
//
// Bound on the H100: launch latency.  One block moves 8 KB at 1024
// threads, far below a microsecond at the memory rate, so the launch floor
// sets the time, as it does for lud_diag.  The design is the listing's:
// the launcher passes the extent in bytes as the chevron's third argument,
// and the kernel derives ns from it.  Where ns exceeds the block, the
// cells no thread loads are zeroed first, as the reference's shared
// memory starts at zero; the wrapper refuses ns smaller than the block.
#include <cuda_runtime.h>

__global__ void reverse_kernel(int* d, int ns, int passes) {
  extern __shared__ int s[];
  const int t = threadIdx.x;
  for (int i = blockDim.x + t; i < ns; i += blockDim.x) s[i] = 0;
  for (int pass = 0; pass < passes; ++pass) {
    if (pass) __syncthreads();   // every thread has read the last pass's s
    s[t] = d[t];
    __syncthreads();
    d[t] = s[ns - 1 - t];
  }
}

// grid: the logical blocks, each one pass of the one block launched
extern "C" int launch_reverse(int* d, int grid, int block, size_t smem_bytes,
                              void* stream) {
  reverse_kernel<<<1, block, smem_bytes, (cudaStream_t)stream>>>(
      d, (int)(smem_bytes / sizeof(int)), grid);
  return (int)cudaGetLastError();
}
