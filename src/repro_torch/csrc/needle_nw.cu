// needle_nw: one anti-diagonal of the Needleman-Wunsch wavefront (Rodinia
// nw).  Cell (i, j) with i + j == d takes
//   max(score[i-1][j-1] + sim[i-1][j-1], score[i-1][j] - p, score[i][j-1] - p)
// on the row-major (n+1) x (n+1) score matrix.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`)
// applied to make_needle_nw (src/repro/core/cuda_suite.py:539).
//
// Bound on the H100: launch overhead, then memory.  A diagonal holds at
// most n cells (2048 at Rodinia size, 40 KB of traffic), so the device
// work per launch is far below a launch's fixed cost and the 2n-1 launches
// of a run are paced by the host.  The kernel is one thread per cell, no
// shared memory: cells of one diagonal depend only on the two before it,
// already final in device memory.  `n` and `penalty` are runtime
// arguments, and the diagonal index is read from device memory so the
// host never waits on the card between launches.
#include <cuda_runtime.h>

__global__ void needle_nw_kernel(int* score, const int* __restrict__ sim,
                                 const int* __restrict__ diag, int n,
                                 int penalty) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int d = diag[0];
  const int lo = max(1, d - n);
  const int hi = min(n, d - 1);
  if (t > hi - lo) return;
  const int i = t + lo;
  const int j = d - i;
  const size_t w = (size_t)n + 1;
  const int dv = score[(i - 1) * w + (j - 1)] + sim[(i - 1) * (size_t)n + (j - 1)];
  const int up = score[(i - 1) * w + j] - penalty;
  const int lf = score[i * w + (j - 1)] - penalty;
  score[i * w + j] = max(dv, max(up, lf));
}

extern "C" int launch_needle_nw(int* score, const int* sim, const int* diag,
                                int n, int penalty, int grid, int block,
                                void* stream) {
  needle_nw_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      score, sim, diag, n, penalty);
  return (int)cudaGetLastError();
}
