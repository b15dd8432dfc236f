// bfs_frontier: one level of level-synchronous BFS (Rodinia bfs).
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_bfs_frontier
// (src/repro/core/cuda_suite.py:452).  There the grid steps run in order
// and the atomicCAS claims are serialised in thread order, so a node
// reached by several frontier threads goes to the first claimant in
// (block, edge slot, thread) order.  The reference's `active` counts the
// threads that won at least one node, and so depends on which claimant
// won.  A single atomicCAS pass on the card would leave that to the
// hardware and change `active` from run to run.  The launch therefore
// settles every contested node in the reference's order, in two passes:
//   1. bfs_bid: each frontier node bids for each unvisited neighbour with
//      atomicMin of its (logical block, slot, logical thread) key into
//      `owner`, and notes which of its slots bid in `bids`;
//   2. bfs_expand: the node whose key holds a neighbour writes visited,
//      nxt and dist = level + 1, and puts INT_MAX back into `owner`;
//      `active` gains the nodes that won anything.
// dist, visited, nxt and active then match the reference bit for bit.
// The keys come from the chevron's logical ids (t / block, t % block),
// never from the CTA's, so the CTA mapping below changes no result.
//
// Bound on the H100: memory, and at most levels the frontier scan alone.
// Each frontier node reads its deg edge slots (one row, contiguous) and
// touches deg scattered flags in each pass; every other node reads one
// frontier word a pass.  `edges` stays in device memory behind
// `const int* __restrict__` (the read-only path): at Rodinia size it is
// 24 MB, far past the 64 KB __constant__ bank.
//
// The design against what one block of 32 threads a logical block cost:
//   - a CTA of 256 threads covers 1024 nodes, four a thread at a stride of
//     256 (each of the four loads a warp's 128 contiguous bytes of the
//     frontier), so a level at n = 10^6 starts 977 CTAs, not 2 x 31,250
//     of one warp: the block cost no longer grows with n / 32;
//   - a node's deg slots are read eight at a time, then their flags (or
//     owners) eight at a time, so the scattered loads of one node are in
//     flight together;
//   - at the widest levels the time is the scattered flag and owner
//     accesses (a 32-byte sector each for 4 bytes), not the CTAs: the bid
//     pass stores, for each frontier node, the mask of its slots that bid
//     (one coalesced word in `bids`, scratch that needs no fill: the
//     expand pass reads it only for the frontier nodes that the bid pass
//     wrote it for), and the expand pass reads the owners of those slots
//     alone.  Past the widest level most neighbours are already visited,
//     so most owner reads go (slots past the 32nd always read theirs);
//   - `active` is summed in the CTA: __reduce_add_sync a warp, the warps'
//     sums in shared memory behind a named barrier that counts only the
//     CTA's live warps, one atomicAdd a CTA.  Warps wholly past n return
//     at once and no barrier waits for them;
//   - `owner` is not filled each launch.  It is INT_MAX between launches:
//     the wrapper keeps one buffer a (device, stream, n), filled once,
//     and every node that received a bid has exactly one winner, which
//     puts INT_MAX back after reading its key.  A loser never sees its own
//     key: it sees the winner's or INT_MAX, and no key is INT_MAX (the
//     wrapper checks n * deg < 2^31).  Launches on one stream run in
//     order; another stream gets its own buffer, and a launch that
//     returns an error drops its buffer (the wrapper does both).  A
//     64-bit key with a launch counter in its high word would need no
//     reset, but twice the bytes a scattered owner access and a counter
//     kept on the host; the reset costs one store a won node.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;                 // 8 warps a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kNodes = 4;                     // nodes a thread
constexpr int kCtaNodes = kThreads * kNodes;  // 1024 nodes a CTA
constexpr int kBatch = 8;                     // edge slots loaded together
constexpr unsigned kFull = 0xffffffffu;

// Whether any of this warp's nodes lies below n (its first one does).
__device__ __forceinline__ bool warp_live(int n) {
  return (int)blockIdx.x * kCtaNodes + (int)(threadIdx.x & ~31) < n;
}

__device__ __forceinline__ void load_frontier(const int* __restrict__ f,
                                              int n, int (&in)[kNodes]) {
  const int base = blockIdx.x * kCtaNodes + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kNodes; ++j) {
    const int t = base + j * kThreads;
    in[j] = t < n ? f[t] : 0;
  }
}

// Whether slot k of a node whose bid mask is `mask` bid (or lies past
// the mask's 32 slots).
__device__ __forceinline__ bool did_bid(unsigned mask, int k) {
  return k >= 32 || (mask >> k) & 1u;
}

// Node t's bids: atomicMin of the reference's claim key, ((t / lb) * deg
// + k) * lb + t % lb, into each unvisited neighbour's owner; the slots
// that bid go to bids[t].
__device__ __forceinline__ void bid_node(const int* __restrict__ edges,
                                         const int* __restrict__ visited,
                                         int* owner, unsigned* bids, int t,
                                         int n, int deg, int lb) {
  const int* row = edges + (size_t)t * deg;
  const int key0 = (t / lb) * deg * lb + t % lb;
  unsigned mask = 0;
  for (int k0 = 0; k0 < deg; k0 += kBatch) {
    int nb[kBatch], seen[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      nb[i] = k0 + i < deg ? row[k0 + i] : n;   // n marks a padding slot
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      seen[i] = nb[i] >= 0 && nb[i] < n ? visited[nb[i]] : 1;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (seen[i] == 0) {
        atomicMin(owner + nb[i], key0 + (k0 + i) * lb);
        if (k0 + i < 32) mask |= 1u << (k0 + i);
      }
    }
  }
  bids[t] = mask;
}

// Node t's wins: the neighbours, among the slots that bid, whose owner
// holds t's key.  Returns 1 if it won any.
__device__ __forceinline__ int expand_node(const int* __restrict__ edges,
                                           const unsigned* __restrict__ bids,
                                           int* owner, int* visited,
                                           int* nxt, int* dist, int next,
                                           int t, int n, int deg, int lb) {
  const unsigned mask = bids[t];
  const int* row = edges + (size_t)t * deg;
  const int key0 = (t / lb) * deg * lb + t % lb;
  int won = 0;
  for (int k0 = 0; k0 < deg; k0 += kBatch) {
    // the slots load beside the mask, not after it: one round trip less
    int nb[kBatch], own[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      nb[i] = k0 + i < deg ? row[k0 + i] : n;
    // all of the batch's owners are read before any is reset, so a node
    // in two slots of one row is won by its first slot alone
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      own[i] = nb[i] >= 0 && nb[i] < n && did_bid(mask, k0 + i)
                   ? owner[nb[i]]
                   : -1;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) {
      if (own[i] == key0 + (k0 + i) * lb) {
        visited[nb[i]] = 1;
        nxt[nb[i]] = 1;
        dist[nb[i]] = next;
        owner[nb[i]] = INT_MAX;
        won = 1;
      }
    }
  }
  return won;
}

__global__ void __launch_bounds__(kThreads)
    bfs_bid(const int* __restrict__ edges, const int* __restrict__ frontier,
            const int* __restrict__ visited, int* owner, unsigned* bids,
            int n, int deg, int lb) {
  if (!warp_live(n)) return;
  int in[kNodes];
  load_frontier(frontier, n, in);
  const int base = blockIdx.x * kCtaNodes + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kNodes; ++j)
    if (in[j] == 1)
      bid_node(edges, visited, owner, bids, base + j * kThreads, n, deg,
               lb);
}

__global__ void __launch_bounds__(kThreads)
    bfs_expand(const int* __restrict__ edges,
               const int* __restrict__ frontier,
               const unsigned* __restrict__ bids, int* owner, int* visited,
               int* nxt, int* dist, int* active,
               const int* __restrict__ level, int n, int deg, int lb) {
  __shared__ int warp_wins[kWarps];
  if (!warp_live(n)) return;             // whole warps, before any sync
  int in[kNodes];
  load_frontier(frontier, n, in);
  const int base = blockIdx.x * kCtaNodes + threadIdx.x;
  const int next = level[0] + 1;
  int wins = 0;
#pragma unroll
  for (int j = 0; j < kNodes; ++j)
    if (in[j] == 1)
      wins += expand_node(edges, bids, owner, visited, nxt, dist, next,
                          base + j * kThreads, n, deg, lb);
  wins = __reduce_add_sync(kFull, wins);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_wins[warp] = wins;
  // the live warps are the CTA's first ones: those whose first node is
  // below n
  const int live = min(kWarps, (n - (int)blockIdx.x * kCtaNodes + 31) / 32);
  asm volatile("bar.sync 1, %0;" ::"r"(live * 32) : "memory");
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < live; ++w) sum += warp_wins[w];
    if (sum) atomicAdd(active, sum);
  }
}

}  // namespace

// Nodes a CTA covers; lower_cuda.bfs_frontier_ctas(n) starts
// ceil(n / bfs_frontier_cta_nodes()) CTAs.
extern "C" int bfs_frontier_cta_nodes() { return kCtaNodes; }

// n nodes in `ctas` CTAs of kThreads; lb is the chevron's block (the
// claim keys' logical block).  `owner` must hold INT_MAX everywhere, and
// does again when both passes have run; `bids` is n words of scratch.
extern "C" int launch_bfs_frontier(const int* edges, const int* frontier,
                                   int* owner, unsigned* bids, int* visited,
                                   int* nxt, int* dist, int* active,
                                   const int* level, int n, int deg, int lb,
                                   int ctas, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  bfs_bid<<<ctas, kThreads, 0, s>>>(edges, frontier, visited, owner, bids,
                                    n, deg, lb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bfs_expand<<<ctas, kThreads, 0, s>>>(edges, frontier, bids, owner, visited,
                                       nxt, dist, active, level, n, deg, lb);
  return (int)cudaGetLastError();
}
