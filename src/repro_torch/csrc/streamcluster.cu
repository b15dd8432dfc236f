// streamcluster: one pgain evaluation of Rodinia streamcluster.  Point i
// compares its cost to its assigned centre a = assign[i] with its cost to
// the candidate; a switcher (dcand < dcur) adds its saving to gain[0] and
// csave[a], sets switched[i], and claims dirty[a] with atomicCAS(0 -> 1);
// the winner of each claim adds 1 to ndirty.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`)
// applied to make_streamcluster (src/repro/core/cuda_suite.py:967).
//
// Bound on the H100: launch latency and atomics.  The data is small (1 MB
// at 65,536 points), and every switcher's saving goes to one address.
// All results are integer and order-free, so the card's atomic order
// cannot show: gain is summed per warp with __reduce_add_sync (exact for
// int32) before one atomicAdd a warp, and ndirty counts the distinct
// centres whose flag went from 0 to 1, as the reference's serialised CAS
// does.  The reference's inactive threads CAS a past-the-end slot k with
// an impossible compare value; here only switchers with 0 <= a < k touch
// csave or dirty, so nothing ever touches dirty[k].  Every thread reaches
// the warp reduction (no early return), so blocks are whole warps.
#include <cuda_runtime.h>

__global__ void streamcluster_kernel(
    const int* __restrict__ px, const int* __restrict__ py,
    const int* __restrict__ cx, const int* __restrict__ cy,
    const int* __restrict__ cand, const int* __restrict__ assign, int* gain,
    int* csave, int* dirty, int* ndirty, int* switched, int n, int k) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  int save = 0;
  if (i < n) {
    const int a = assign[i];
    int c = a < 0 ? a + k : a;          // gather rule: wrap once, clamp
    c = min(max(c, 0), k - 1);
    const int x = px[i], y = py[i];
    const int dcur = (x - cx[c]) * (x - cx[c]) + (y - cy[c]) * (y - cy[c]);
    const int dcand = (x - cand[0]) * (x - cand[0])
                      + (y - cand[1]) * (y - cand[1]);
    if (dcand < dcur) {
      save = dcur - dcand;
      switched[i] = 1;
      if (a >= 0 && a < k) {
        atomicAdd(&csave[a], save);
        if (atomicCAS(&dirty[a], 0, 1) == 0) atomicAdd(ndirty, 1);
      }
    }
  }
  const int warp_sum = __reduce_add_sync(0xffffffffu, save);
  if ((threadIdx.x & 31) == 0 && warp_sum != 0) atomicAdd(gain, warp_sum);
}

extern "C" int launch_streamcluster(const int* px, const int* py,
                                    const int* cx, const int* cy,
                                    const int* cand, const int* assign,
                                    int* gain, int* csave, int* dirty,
                                    int* ndirty, int* switched, int n, int k,
                                    int grid, int block, void* stream) {
  streamcluster_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      px, py, cx, cy, cand, assign, gain, csave, dirty, ndirty, switched, n,
      k);
  return (int)cudaGetLastError();
}
