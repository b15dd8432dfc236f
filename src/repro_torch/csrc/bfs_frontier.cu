// bfs_frontier: one level of level-synchronous BFS (Rodinia bfs).
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_bfs_frontier
// (src/repro/core/cuda_suite.py:452).  There the grid steps run in order
// and the atomicCAS claims are serialised in thread order, so a node
// reached by several frontier threads goes to the first claimant in
// (block, edge slot, thread) order.  The reference's `active` counts, per
// block, the threads that won at least one node, and so depends on which
// claimant won.  A single atomicCAS pass on the card would leave that to
// the hardware and change `active` from run to run.  The launch therefore
// settles every contested node in the reference's order, in two passes:
//   1. bfs_bid: each frontier thread bids for each unvisited neighbour
//      with atomicMin of its (block, slot, thread) key into `owner`
//      (INT_MAX on entry, filled by the wrapper);
//   2. bfs_expand: the thread whose key holds a node writes visited, nxt
//      and dist = level + 1; the block counts its winners with
//      __syncthreads_count and thread 0 adds the count to active[0] with
//      atomicAdd.
// dist, visited, nxt and active then match the reference bit for bit.
//
// Bound on the H100: memory.  Each frontier thread reads its deg edge
// slots (one row, contiguous) and touches deg scattered flags in each
// pass; the other threads read one frontier word.  `edges` stays in
// device memory behind `const int* __restrict__` (the read-only path): at
// Rodinia size it is 24 MB, far past the 64 KB __constant__ bank.  Blocks
// are 32 threads, so __syncthreads_count is one warp's count; no thread of
// bfs_expand returns before that barrier (n is a multiple of 32).
#include <cuda_runtime.h>

// The reference's claim order: block, then edge slot, then thread.  The
// wrapper checks n * deg < 2^31, so the key fits an int.
__device__ __forceinline__ int claim_key(int k, int deg) {
  return ((int)blockIdx.x * deg + k) * (int)blockDim.x + (int)threadIdx.x;
}

__global__ void bfs_bid(const int* __restrict__ edges,
                        const int* __restrict__ frontier,
                        const int* __restrict__ visited, int* owner, int n,
                        int deg) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n || frontier[t] != 1) return;   // no barrier in this pass
  const int* row = edges + (size_t)t * deg;
  for (int k = 0; k < deg; ++k) {
    const int nbr = row[k];                 // == n for padding slots
    if (nbr >= 0 && nbr < n && visited[nbr] == 0)
      atomicMin(&owner[nbr], claim_key(k, deg));
  }
}

__global__ void bfs_expand(const int* __restrict__ edges,
                           const int* __restrict__ frontier,
                           const int* __restrict__ owner, int* visited,
                           int* nxt, int* dist, int* active,
                           const int* __restrict__ level, int n, int deg) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  int won_any = 0;
  if (t < n && frontier[t] == 1) {
    const int lvl = level[0];
    const int* row = edges + (size_t)t * deg;
    for (int k = 0; k < deg; ++k) {
      const int nbr = row[k];
      if (nbr >= 0 && nbr < n && owner[nbr] == claim_key(k, deg)) {
        visited[nbr] = 1;
        nxt[nbr] = 1;
        dist[nbr] = lvl + 1;
        won_any = 1;
      }
    }
  }
  const int nwin = __syncthreads_count(won_any);
  if (threadIdx.x == 0 && nwin) atomicAdd(active, nwin);
}

extern "C" int launch_bfs_frontier(const int* edges, const int* frontier,
                                   int* owner, int* visited, int* nxt,
                                   int* dist, int* active, const int* level,
                                   int n, int deg, int grid, int block,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  bfs_bid<<<grid, block, 0, s>>>(edges, frontier, visited, owner, n, deg);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bfs_expand<<<grid, block, 0, s>>>(edges, frontier, owner, visited, nxt,
                                    dist, active, level, n, deg);
  return (int)cudaGetLastError();
}
