// lavamd: the particle potential of Rodinia lavaMD over a neighbour-box
// list.  Block b owns home box b, thread t its particle b * ppb + t:
//   force[b*ppb + t] = sum_k sum_j q[nb*ppb + j] * exp(-alpha * d * d),
//   d = pos[b*ppb + t] - pos[nb*ppb + j],  nb = nbr[b, k].
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`)
// applied to make_lavamd (src/repro/core/cuda_suite.py:756).
//
// Bound on the H100: operations, the exp at the special-function units'
// rate (2.7e8 pair terms at lavaMD -boxes1d 10 against 1.3 MB of data).
// Each of the nnei neighbours is staged in __shared__ (positions and
// charges of its ppb particles, dynamic shared memory sized by the
// runtime ppb) between two barriers; every thread then reads them as
// broadcasts.  The accumulator stays in a register across all 2 * nnei
// barriers.  Precision follows the reference: a per-neighbour sum u over
// j, then acc += u, and expf (not __expf; no fast math), so the result
// stays within the entry's 1e-4.  The gathers follow the reference's
// rule for an index out of range: wrap a negative one once, then clamp.
#include <cuda_runtime.h>

__global__ void lavamd_kernel(const float* __restrict__ pos,
                              const float* __restrict__ q,
                              const int* __restrict__ nbr, float* force,
                              int nboxes, int ppb, int nnei, float alpha) {
  extern __shared__ float sh[];
  float* sy = sh;
  float* sq = sh + ppb;
  const int t = threadIdx.x, b = blockIdx.x;
  const long long n = (long long)nboxes * ppb;
  const float x = pos[(size_t)b * ppb + t];
  float acc = 0.0f;
  for (int k = 0; k < nnei; ++k) {
    long long src = (long long)nbr[(size_t)b * nnei + k] * ppb + t;
    if (src < 0) src += n;
    src = src < 0 ? 0 : (src >= n ? n - 1 : src);
    sy[t] = pos[src];
    sq[t] = q[src];
    __syncthreads();
    float u = 0.0f;
    for (int j = 0; j < ppb; ++j) {
      const float d = x - sy[j];
      u += sq[j] * expf(-alpha * d * d);
    }
    acc += u;
    __syncthreads();
  }
  force[(size_t)b * ppb + t] = acc;
}

extern "C" int launch_lavamd(const float* pos, const float* q, const int* nbr,
                             float* force, int nboxes, int ppb, int nnei,
                             float alpha, int grid, void* stream) {
  lavamd_kernel<<<grid, ppb, 2 * ppb * sizeof(float),
                  (cudaStream_t)stream>>>(pos, q, nbr, force, nboxes, ppb,
                                          nnei, alpha);
  return (int)cudaGetLastError();
}
