// kmeans: one Lloyd iteration of Rodinia kmeans as two launches:
//   kmeans_assign - each point takes its nearest centroid (ties to the
//                   lower centre); the point's coordinates and a count go
//                   to its cluster's sums, and a moved point to `changed`;
//   kmeans_update - one block per cluster: the centroid becomes its sums
//                   over its count, and an empty cluster keeps its centroid.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_kmeans_assign and
// make_kmeans_update (src/repro/core/cuda_suite.py:898 and :936).
//
// Bound on the H100: atomics, then memory.  assign moves 7.9 MB at
// 494,080 points (px, py, assign read; assign written), 2.4 us at the
// memory rate; but the reference adds every point to one of k = 4
// addresses per sum, about 1.5 M atomics on 13 addresses, which the card
// serialises.  The coordinates are integer-valued and their total stays
// below 2^24, so every partial sum is an exact float whatever its order.
// That lets each block pre-reduce: per warp, a shuffle tree per cluster;
// per block, one __shared__ atomic per warp and cluster; then one global
// atomicAdd per block and bin (about 100 K in all), and one for the
// block's moved count from __syncthreads_count.  The results equal the
// reference's bit for bit.  Distances use the _rn intrinsics: after the
// first update the centroids are not integers, and an FMA would move
// near ties.  update divides with __fdiv_rn, so the centroids equal
// NumPy's float32 division.
#include <cuda_runtime.h>

#define KMEANS_MAX_K 32

__device__ __forceinline__ float dist2(float x, float y, float cx, float cy) {
  const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// blockDim is a multiple of 32, and every thread reaches the shuffles and
// the barriers (no early return).
__global__ void kmeans_assign_kernel(
    const float* __restrict__ px, const float* __restrict__ py,
    const float* __restrict__ cx, const float* __restrict__ cy, int* assign,
    int* changed, float* sumx, float* sumy, int* count, int n, int k) {
  __shared__ float bx[KMEANS_MAX_K], by[KMEANS_MAX_K];
  __shared__ int bn[KMEANS_MAX_K];
  const int t = threadIdx.x;
  for (int c = t; c < k; c += blockDim.x) {
    bx[c] = 0.0f;
    by[c] = 0.0f;
    bn[c] = 0;
  }
  const long long i = (long long)blockIdx.x * blockDim.x + t;
  const bool valid = i < n;
  const int g = valid ? (int)i : n - 1;
  const float x = px[g], y = py[g];
  int best = 0;
  float bestd = dist2(x, y, cx[0], cy[0]);
  for (int c = 1; c < k; ++c) {
    const float d = dist2(x, y, cx[c], cy[c]);
    if (d < bestd) {              // strict: ties keep the lower centre
      best = c;
      bestd = d;
    }
  }
  const int moved = valid && assign[g] != best;
  if (valid) assign[i] = best;
  __syncthreads();                // the bins are zeroed
  const bool lead = (t & 31) == 0;
  for (int c = 0; c < k; ++c) {
    const bool mine = valid && best == c;
    const int wn = __reduce_add_sync(0xffffffffu, mine ? 1 : 0);
    const float wx = warp_sum(mine ? x : 0.0f);
    const float wy = warp_sum(mine ? y : 0.0f);
    if (lead && wn) {
      atomicAdd(&bx[c], wx);
      atomicAdd(&by[c], wy);
      atomicAdd(&bn[c], wn);
    }
  }
  const int nmoved = __syncthreads_count(moved);  // and the bins are full
  for (int c = t; c < k; c += blockDim.x) {
    if (bn[c]) {
      atomicAdd(&sumx[c], bx[c]);
      atomicAdd(&sumy[c], by[c]);
      atomicAdd(&count[c], bn[c]);
    }
  }
  if (t == 0 && nmoved) atomicAdd(changed, nmoved);
}

__global__ void kmeans_update_kernel(const float* __restrict__ sumx,
                                     const float* __restrict__ sumy,
                                     const int* __restrict__ count, float* cx,
                                     float* cy, int k) {
  const int c = blockIdx.x;
  if (threadIdx.x != 0 || c >= k) return;
  const int cnt = count[c];
  if (cnt == 0) return;           // an empty cluster keeps its centroid
  const float safe = __int2float_rn(cnt);
  cx[c] = __fdiv_rn(sumx[c], safe);
  cy[c] = __fdiv_rn(sumy[c], safe);
}

extern "C" int launch_kmeans_assign(const float* px, const float* py,
                                    const float* cx, const float* cy,
                                    int* assign, int* changed, float* sumx,
                                    float* sumy, int* count, int n, int k,
                                    int grid, int block, void* stream) {
  kmeans_assign_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      px, py, cx, cy, assign, changed, sumx, sumy, count, n, k);
  return (int)cudaGetLastError();
}

// grid == k: one block per cluster.
extern "C" int launch_kmeans_update(const float* sumx, const float* sumy,
                                    const int* count, float* cx, float* cy,
                                    int k, int block, void* stream) {
  kmeans_update_kernel<<<k, block, 0, (cudaStream_t)stream>>>(
      sumx, sumy, count, cx, cy, k);
  return (int)cudaGetLastError();
}
