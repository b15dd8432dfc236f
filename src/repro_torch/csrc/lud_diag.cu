// lud_diag: the diagonal-tile step of Rodinia lud.  Block t LU-factors
// (Doolittle, no pivoting) its own b x b tile of `a` and writes L\U to
// `lu`: for k = 0 .. b-2, rows i > k take m = s[i][k] / s[k][k], then
// s[i][c] -= m * s[k][c] for c > k, then s[i][k] = m.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`)
// applied to make_lud_diag (src/repro/core/cuda_suite.py:620).
//
// Bound on the H100: launch latency.  The work is tiny (2 x 128 KB moved
// and about 2/3 b^3 flops a tile at 128 tiles of 16 x 16), so the launch
// floor of a few microseconds sets the time.  The design stays the
// reference's: one thread per row, the tile in a __shared__ float
// [32][33] (the padding column keeps a column's 32 rows on 32 banks), b-1
// steps separated by __syncthreads().  The tile is loaded and stored
// coalesced, b floats a step.  The product and difference use the _rn
// intrinsics so nvcc does not contract them into an FMA; the division is
// IEEE (no fast math).  `b` (at most 32) is a runtime argument.
#include <cuda_runtime.h>

#define LUD_MAX_B 32

__global__ void lud_diag_kernel(const float* __restrict__ a, float* lu,
                                int b) {
  __shared__ float s[LUD_MAX_B][LUD_MAX_B + 1];
  const int i = threadIdx.x;
  const size_t base = (size_t)blockIdx.x * b * b;
  for (int e = i; e < b * b; e += b) s[e / b][e % b] = a[base + e];
  __syncthreads();
  for (int k = 0; k < b - 1; ++k) {
    if (i > k) {
      const float m = s[i][k] / s[k][k];
      for (int c = k + 1; c < b; ++c)
        s[i][c] = __fsub_rn(s[i][c], __fmul_rn(m, s[k][c]));
      s[i][k] = m;
    }
    __syncthreads();
  }
  for (int e = i; e < b * b; e += b) lu[base + e] = s[e / b][e % b];
}

extern "C" int launch_lud_diag(const float* a, float* lu, int b, int grid,
                               void* stream) {
  lud_diag_kernel<<<grid, b, 0, (cudaStream_t)stream>>>(a, lu, b);
  return (int)cudaGetLastError();
}
