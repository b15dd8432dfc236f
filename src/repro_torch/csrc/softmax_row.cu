// softmax_row: one block per row of x[rows, width] (width = blockDim.x):
// y = exp(x - max) / sum(exp(x - max)).  Each thread holds one value; the
// row's max is taken by a __shfl_xor_sync butterfly in each warp and over
// the warps' maxima in __shared__ memory (barrier one); each thread's
// p = expf(x - max) is summed the same way (barrier two); then p / sum.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_softmax_row
// (src/repro/core/cuda_suite.py:316).
//
// Bound on the H100: memory.  x is read once and y written once (134 MB at
// 131,072 x 128): 0.040 ms at 3.35 TB/s; the 1.7e7 exps on the
// special-function units take 0.004 ms.  The reference has every thread
// read the whole row from shared memory, twice; the warp butterflies give
// the same max (max is order-free) and a sum in another order, so y agrees
// with the plain version and the oracle within the entry's tolerance
// (2e-5), not bit for bit.  expf (not __expf) and IEEE division: no fast
// math.  The block is a whole number of warps, up to 1024 threads.
#include <cuda_runtime.h>

#define SM_MAX_WARPS 32
#define FULL_MASK 0xffffffffu

__global__ void softmax_row_kernel(const float* __restrict__ x, float* y) {
  __shared__ float wmax[SM_MAX_WARPS];
  __shared__ float wsum[SM_MAX_WARPS];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const size_t at = (size_t)blockIdx.x * blockDim.x + t;
  const float v = x[at];
  float m = v;
  for (int off = 16; off >= 1; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, off));
  if (lane == 0) wmax[warp] = m;
  __syncthreads();
  m = wmax[0];
  for (int i = 1; i < nwarps; ++i) m = fmaxf(m, wmax[i]);
  const float p = expf(__fsub_rn(v, m));
  float sum = p;
  for (int off = 16; off >= 1; off >>= 1)
    sum = __fadd_rn(sum, __shfl_xor_sync(FULL_MASK, sum, off));
  if (lane == 0) wsum[warp] = sum;
  __syncthreads();
  sum = wsum[0];
  for (int i = 1; i < nwarps; ++i) sum = __fadd_rn(sum, wsum[i]);
  y[at] = __fdiv_rn(p, sum);
}

extern "C" int launch_softmax_row(const float* x, float* y, int grid,
                                  int block, void* stream) {
  softmax_row_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(x, y);
  return (int)cudaGetLastError();
}
