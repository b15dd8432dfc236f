// histogram: Hetero-Mark HIST.  Thread gid counts pixels k = 0 .. iters-1
// at idx = gid + k * total_threads (the coalesced layout, Fig. 10a) or
// idx = gid * iters + k (the contiguous one, Fig. 10c), those below n,
// into hist[x[idx]] with an integer atomicAdd.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_histogram
// (src/repro/core/cuda_suite.py:102).
//
// Bound on the H100: memory, then atomics.  The pixels are read once (67
// MB at n = 2^24 int32): 0.020 ms at 3.35 TB/s.  The reference adds every
// pixel to one of nbins global addresses, 2^24 atomics on 256 addresses at
// full size, which the card would serialise.  The counts are integers, so
// their order does not change the result: each block counts into a private
// histogram in dynamic shared memory (nbins ints, at most 48 KB), then
// adds each nonzero bin to hist with one global atomicAdd.  total_threads,
// iters and the layout are runtime arguments, not gridDim * blockDim, so
// a launch on fewer blocks counts exactly the pixels the reference's
// threads of that launch count.  A bin value follows the reference's
// scatter rule: a negative one wraps once, and one still outside
// [0, nbins) is dropped.
#include <cuda_runtime.h>

__global__ void histogram_kernel(const int* __restrict__ x, int* hist, int n,
                                 int nbins, int total_threads, int iters,
                                 int contiguous) {
  extern __shared__ int local[];
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) local[i] = 0;
  __syncthreads();
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (int k = 0; k < iters; ++k) {
    const long long idx = contiguous ? gid * iters + k
                                     : gid + (long long)k * total_threads;
    if (idx >= n) continue;
    int v = x[idx];
    if (v < 0) v += nbins;
    if (v >= 0 && v < nbins) atomicAdd(&local[v], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) {
    if (local[i]) atomicAdd(&hist[i], local[i]);
  }
}

extern "C" int launch_histogram(const int* x, int* hist, int n, int nbins,
                                int total_threads, int iters, int contiguous,
                                int grid, int block, void* stream) {
  histogram_kernel<<<grid, block, (size_t)nbins * sizeof(int),
                     (cudaStream_t)stream>>>(x, hist, n, nbins,
                                             total_threads, iters,
                                             contiguous);
  return (int)cudaGetLastError();
}
