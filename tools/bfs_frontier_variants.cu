// Times src/repro_torch/csrc/bfs_frontier.cu at the main path's size (n =
// 1,000,000 nodes of 6 edge slots, the chevron's blocks of 32) beside the
// kernel it replaced and variants of its design, at every level of one BFS,
// on one CUDA card, so that the choices its source note makes rest on a
// measurement.  The graph is the entry's shape built here: a ring (slot 0
// is t + 1) plus 5 random chords a node (splitmix64, seed 42; not NumPy's
// draws, so the frontiers differ a little from the entry's).  Each level
// starts from the state the chain reaches there (frontier, visited, dist
// from a BFS on the host).  Variants:
//   old        the earlier launch: torch.full's fill of `owner` (a fill
//              kernel here), then bfs_bid and bfs_expand in n / 32 blocks
//              of 32 threads, one atomicAdd a block with a winner;
//   kernel     the shipped launch through launch_bfs_frontier (977 CTAs of
//              256, four nodes a thread, `active` summed a CTA, no fill:
//              `owner` stays INT_MAX; the expand pass reads the owners of
//              the slots that bid alone);
//   kernel+fill  the same after the old fill, as if `owner` were new;
//   T<t> N<k> <sum>
//              the design at t threads a CTA, k nodes a thread, and
//              `active` summed a CTA (cta) or one atomicAdd a warp (warp),
//              on the shipped per-node code; T256 N4 cta is the shipped
//              shape;
//   nomask     T256 N4 cta with no bid mask: the expand pass reads the
//              owner of every slot (the tool's copy of that per-node code);
//   occ8       T256 N4 / N2 cta held by __launch_bounds__(256, 8) to 32
//              registers, for 8 CTAs (64 warps) an SM.
// The old and the shipped launch are also timed a pass at a time (fill,
// bid, expand).  Every variant's visited, nxt, dist and active must equal
// the old kernel's bit for bit at every level, and `owner` must come back
// to INT_MAX everywhere.  Each level's time is the median of 25 CUDA-event
// runs after 5 warm-ups, a spin on the card covering the enqueue and the
// written buffers restored outside the window; three turns, then each
// variant's median of its turns, by level and summed over the levels.
// Build and run from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/bfs_frontier_variants tools/bfs_frontier_variants.cu \
//     && build/bfs_frontier_variants
#include <algorithm>
#include <climits>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <string>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/bfs_frontier.cu"

namespace variants {

constexpr int kN = 1000000, kDeg = 6, kLb = 32, kTurns = 3;
constexpr int kRuns = 25, kWarm = 5;

#define CHECK(x)                                                        \
  do {                                                                  \
    cudaError_t e_ = (x);                                               \
    if (e_ != cudaSuccess) {                                            \
      std::fprintf(stderr, "%s:%d %s\n", __FILE__, __LINE__,            \
                   cudaGetErrorString(e_));                             \
      std::exit(1);                                                     \
    }                                                                   \
  } while (0)

// ---- the kernels this redesign replaced, as they were -------------------
namespace old {

__device__ __forceinline__ int claim_key(int k, int deg) {
  return ((int)blockIdx.x * deg + k) * (int)blockDim.x + (int)threadIdx.x;
}

__global__ void bid(const int* __restrict__ edges,
                    const int* __restrict__ frontier,
                    const int* __restrict__ visited, int* owner, int n,
                    int deg) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n || frontier[t] != 1) return;
  const int* row = edges + (size_t)t * deg;
  for (int k = 0; k < deg; ++k) {
    const int nbr = row[k];
    if (nbr >= 0 && nbr < n && visited[nbr] == 0)
      atomicMin(&owner[nbr], claim_key(k, deg));
  }
}

__global__ void expand(const int* __restrict__ edges,
                       const int* __restrict__ frontier,
                       const int* __restrict__ owner, int* visited, int* nxt,
                       int* dist, int* active, const int* __restrict__ level,
                       int n, int deg) {
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

}  // namespace old

__global__ void fill(int* a, int n, int v) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) a[i] = v;
}

__global__ void spin(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

// ---- per-node code with no bid mask: every slot's owner is read --------
namespace nomask {

__device__ __forceinline__ void bid_node(const int* __restrict__ edges,
                                         const int* __restrict__ visited,
                                         int* owner, unsigned*, int t, int n,
                                         int deg, int lb) {
  const int* row = edges + (size_t)t * deg;
  const int key0 = (t / lb) * deg * lb + t % lb;
  for (int k0 = 0; k0 < deg; k0 += kBatch) {
    int nb[kBatch], seen[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      nb[i] = k0 + i < deg ? row[k0 + i] : n;
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      seen[i] = nb[i] >= 0 && nb[i] < n ? visited[nb[i]] : 1;
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      if (seen[i] == 0) atomicMin(owner + nb[i], key0 + (k0 + i) * lb);
  }
}

__device__ __forceinline__ int expand_node(const int* __restrict__ edges,
                                           const unsigned*, int* owner,
                                           int* visited, int* nxt, int* dist,
                                           int next, int t, int n, int deg,
                                           int lb) {
  const int* row = edges + (size_t)t * deg;
  const int key0 = (t / lb) * deg * lb + t % lb;
  int won = 0;
  for (int k0 = 0; k0 < deg; k0 += kBatch) {
    int nb[kBatch], own[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      nb[i] = k0 + i < deg ? row[k0 + i] : n;
#pragma unroll
    for (int i = 0; i < kBatch; ++i)
      own[i] = nb[i] >= 0 && nb[i] < n ? owner[nb[i]] : -1;
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

}  // namespace nomask

// ---- the design at other shapes ------------------------------------------
struct Masked {
  template <class... A>
  __device__ static void bid(A... a) { bid_node(a...); }
  template <class... A>
  __device__ static int expand(A... a) { return expand_node(a...); }
};
struct Unmasked {
  template <class... A>
  __device__ static void bid(A... a) { nomask::bid_node(a...); }
  template <class... A>
  __device__ static int expand(A... a) { return nomask::expand_node(a...); }
};

template <int NT, int NN, class Node, int MINB>
__global__ void __launch_bounds__(NT, MINB)
    bid_v(const int* __restrict__ edges, const int* __restrict__ frontier,
          const int* __restrict__ visited, int* owner, unsigned* bids, int n,
          int deg, int lb) {
  const int base = blockIdx.x * NT * NN + threadIdx.x;
  if (base - (int)(threadIdx.x & 31) >= n) return;
  int in[NN];
#pragma unroll
  for (int j = 0; j < NN; ++j)
    in[j] = base + j * NT < n ? frontier[base + j * NT] : 0;
#pragma unroll
  for (int j = 0; j < NN; ++j)
    if (in[j] == 1)
      Node::bid(edges, visited, owner, bids, base + j * NT, n, deg, lb);
}

template <int NT, int NN, bool CTA_SUM, class Node, int MINB>
__global__ void __launch_bounds__(NT, MINB)
    expand_v(const int* __restrict__ edges,
             const int* __restrict__ frontier,
             const unsigned* __restrict__ bids, int* owner, int* visited,
             int* nxt, int* dist, int* active,
             const int* __restrict__ level, int n, int deg, int lb) {
  __shared__ int warp_wins[NT / 32];
  const int base = blockIdx.x * NT * NN + threadIdx.x;
  if (base - (int)(threadIdx.x & 31) >= n) return;
  int in[NN];
#pragma unroll
  for (int j = 0; j < NN; ++j)
    in[j] = base + j * NT < n ? frontier[base + j * NT] : 0;
  const int next = level[0] + 1;
  int wins = 0;
#pragma unroll
  for (int j = 0; j < NN; ++j)
    if (in[j] == 1)
      wins += Node::expand(edges, bids, owner, visited, nxt, dist, next,
                           base + j * NT, n, deg, lb);
  wins = __reduce_add_sync(0xffffffffu, wins);
  if (!CTA_SUM) {
    if ((threadIdx.x & 31) == 0 && wins) atomicAdd(active, wins);
    return;
  }
  if ((threadIdx.x & 31) == 0) warp_wins[threadIdx.x >> 5] = wins;
  const int live =
      min(NT / 32, (n - (int)blockIdx.x * NT * NN + 31) / 32);
  asm volatile("bar.sync 1, %0;" ::"r"(live * 32) : "memory");
  if (threadIdx.x == 0) {
    int sum = 0;
    for (int w = 0; w < live; ++w) sum += warp_wins[w];
    if (sum) atomicAdd(active, sum);
  }
}

// ---- the graph and the levels -------------------------------------------
uint64_t splitmix(uint64_t& s) {
  uint64_t z = (s += 0x9e3779b97f4a7c15ull);
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

struct Dev {
  int *edges, *frontier, *visited0, *dist0, *visited, *nxt, *dist, *active,
      *level, *owner;
  unsigned* bids;
};

struct Variant {
  std::string name;
  std::function<void(const Dev&)> run;
  bool keeps_owner;   // `owner` must be INT_MAX afterwards
};

float median(std::vector<float> v) {
  std::sort(v.begin(), v.end());
  return v[v.size() / 2];
}

// the level's state, and `owner` at INT_MAX
void restore(const Dev& d) {
  CHECK(cudaMemcpyAsync(d.visited, d.visited0, kN * 4,
                        cudaMemcpyDeviceToDevice));
  CHECK(cudaMemcpyAsync(d.dist, d.dist0, kN * 4, cudaMemcpyDeviceToDevice));
  CHECK(cudaMemsetAsync(d.nxt, 0, kN * 4));
  CHECK(cudaMemsetAsync(d.active, 0, 4));
  fill<<<(kN + 255) / 256, 256>>>(d.owner, kN, INT_MAX);
}

// median ms of f over kRuns runs; before() runs outside the window
float time_ms(const std::function<void()>& f,
              const std::function<void()>& before) {
  cudaEvent_t e0, e1;
  CHECK(cudaEventCreate(&e0));
  CHECK(cudaEventCreate(&e1));
  std::vector<float> ts;
  for (int i = 0; i < kWarm + kRuns; ++i) {
    before();
    spin<<<1, 1>>>(200000);
    CHECK(cudaEventRecord(e0));
    f();
    CHECK(cudaEventRecord(e1));
    CHECK(cudaEventSynchronize(e1));
    float ms;
    CHECK(cudaEventElapsedTime(&ms, e0, e1));
    if (i >= kWarm) ts.push_back(ms);
  }
  CHECK(cudaGetLastError());
  CHECK(cudaEventDestroy(e0));
  CHECK(cudaEventDestroy(e1));
  return median(ts);
}

template <int NT, int NN, bool CTA_SUM, class Node = Masked, int MINB = 1>
Variant design(const char* name) {
  return {name,
          [](const Dev& d) {
            const int ctas = (kN + NT * NN - 1) / (NT * NN);
            bid_v<NT, NN, Node, MINB><<<ctas, NT>>>(
                d.edges, d.frontier, d.visited, d.owner, d.bids, kN, kDeg,
                kLb);
            expand_v<NT, NN, CTA_SUM, Node, MINB><<<ctas, NT>>>(
                d.edges, d.frontier, d.bids, d.owner, d.visited, d.nxt,
                d.dist, d.active, d.level, kN, kDeg, kLb);
          },
          true};
}

void old_fill(const Dev& d) {
  fill<<<(kN + 255) / 256, 256>>>(d.owner, kN, INT_MAX);
}
void old_bid(const Dev& d) {
  old::bid<<<kN / kLb, kLb>>>(d.edges, d.frontier, d.visited, d.owner, kN,
                              kDeg);
}
void old_expand(const Dev& d) {
  old::expand<<<kN / kLb, kLb>>>(d.edges, d.frontier, d.owner, d.visited,
                                 d.nxt, d.dist, d.active, d.level, kN, kDeg);
}
void shipped(const Dev& d) {
  CHECK((cudaError_t)launch_bfs_frontier(
      d.edges, d.frontier, d.owner, d.bids, d.visited, d.nxt, d.dist,
      d.active, d.level, kN, kDeg, kLb,
      (kN + bfs_frontier_cta_nodes() - 1) / bfs_frontier_cta_nodes(),
      nullptr));
}
void shipped_bid(const Dev& d) {
  bfs_bid<<<(kN + kCtaNodes - 1) / kCtaNodes, kThreads>>>(
      d.edges, d.frontier, d.visited, d.owner, d.bids, kN, kDeg, kLb);
}
void shipped_expand(const Dev& d) {
  bfs_expand<<<(kN + kCtaNodes - 1) / kCtaNodes, kThreads>>>(
      d.edges, d.frontier, d.bids, d.owner, d.visited, d.nxt, d.dist,
      d.active, d.level, kN, kDeg, kLb);
}

}  // namespace variants

int main() {
  using namespace variants;
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("card: %s, %d SMs\n", prop.name, prop.multiProcessorCount);

  // the graph, and the BFS distances from node 0
  std::vector<int> edges((size_t)kN * kDeg);
  uint64_t seed = 42;
  for (int t = 0; t < kN; ++t) {
    edges[(size_t)t * kDeg] = (t + 1) % kN;
    for (int k = 1; k < kDeg; ++k)
      edges[(size_t)t * kDeg + k] = (int)(splitmix(seed) % kN);
  }
  std::vector<int> dist(kN, -1), cur{0}, nxt_nodes;
  dist[0] = 0;
  int levels = 0;
  for (; !cur.empty(); ++levels) {
    nxt_nodes.clear();
    for (int u : cur)
      for (int k = 0; k < kDeg; ++k) {
        const int v = edges[(size_t)u * kDeg + k];
        if (dist[v] < 0) dist[v] = levels + 1, nxt_nodes.push_back(v);
      }
    cur.swap(nxt_nodes);
  }

  Dev d;
  int** bufs[] = {&d.edges, &d.frontier, &d.visited0, &d.dist0, &d.visited,
                  &d.nxt, &d.dist, &d.active, &d.level, &d.owner};
  for (int** b : bufs)
    CHECK(cudaMalloc(b, b == &d.edges ? edges.size() * 4 : (size_t)kN * 4));
  CHECK(cudaMalloc(&d.bids, (size_t)kN * 4));
  CHECK(cudaMemcpy(d.edges, edges.data(), edges.size() * 4,
                   cudaMemcpyHostToDevice));
  fill<<<(kN + 255) / 256, 256>>>(d.owner, kN, INT_MAX);

  std::vector<Variant> vs = {
      {"old", [](const Dev& d) { old_fill(d); old_bid(d); old_expand(d); },
       false},
      {"kernel", shipped, true},
      {"kernel+fill", [](const Dev& d) { old_fill(d); shipped(d); }, true},
      design<256, 1, true>("T256 N1 cta"),
      design<256, 2, true>("T256 N2 cta"),
      design<256, 4, true>("T256 N4 cta"),
      design<256, 8, true>("T256 N8 cta"),
      design<128, 4, true>("T128 N4 cta"),
      design<512, 4, true>("T512 N4 cta"),
      design<256, 4, false>("T256 N4 warp"),
      design<256, 4, true, Unmasked>("nomask"),
      design<256, 4, true, Masked, 8>("T256 N4 occ8"),
      design<256, 2, true, Masked, 8>("T256 N2 occ8"),
  };
  // a pass at a time: (name, the pass, what runs before it untimed)
  struct Pass {
    const char* name;
    void (*run)(const Dev&);
    void (*prep)(const Dev&);
  };
  const Pass passes[] = {
      {"old fill", old_fill, nullptr},
      {"old bid", old_bid, nullptr},
      {"old expand", old_expand, old_bid},
      {"kernel bid", shipped_bid, nullptr},
      {"kernel expand", shipped_expand, shipped_bid},
  };
  const int nv = (int)vs.size(), np = (int)(sizeof passes / sizeof *passes);

  std::vector<std::vector<std::vector<float>>> t(
      levels, std::vector<std::vector<float>>(nv + np));
  std::vector<int> fsize(levels);
  std::vector<int> want_vis(kN), want_nxt(kN), want_dist(kN), got(kN);
  int bad = 0;
  for (int lv = 0; lv < levels; ++lv) {
    std::vector<int> f(kN), vis(kN), dl(kN);
    for (int i = 0; i < kN; ++i) {
      f[i] = dist[i] == lv;
      vis[i] = dist[i] >= 0 && dist[i] <= lv;
      dl[i] = dist[i] >= 0 && dist[i] <= lv ? dist[i] : -1;
      fsize[lv] += f[i];
    }
    CHECK(cudaMemcpy(d.frontier, f.data(), kN * 4, cudaMemcpyHostToDevice));
    CHECK(cudaMemcpy(d.visited0, vis.data(), kN * 4,
                     cudaMemcpyHostToDevice));
    CHECK(cudaMemcpy(d.dist0, dl.data(), kN * 4, cudaMemcpyHostToDevice));
    CHECK(cudaMemcpy(d.level, &lv, 4, cudaMemcpyHostToDevice));

    // the old kernel's outputs, then every variant against them
    int want_active = 0;
    for (int v = 0; v < nv; ++v) {
      restore(d);
      vs[v].run(d);
      CHECK(cudaDeviceSynchronize());
      int act;
      CHECK(cudaMemcpy(&act, d.active, 4, cudaMemcpyDeviceToHost));
      int* outs[] = {d.visited, d.nxt, d.dist};
      std::vector<int>* wants[] = {&want_vis, &want_nxt, &want_dist};
      for (int o = 0; o < 3; ++o) {
        CHECK(cudaMemcpy(got.data(), outs[o], kN * 4,
                         cudaMemcpyDeviceToHost));
        if (v == 0)
          *wants[o] = got;
        else if (got != *wants[o])
          ++bad, std::printf("MISMATCH level %d %s output %d\n", lv,
                             vs[v].name.c_str(), o);
      }
      if (v == 0)
        want_active = act;
      else if (act != want_active)
        ++bad, std::printf("MISMATCH level %d %s active %d != %d\n", lv,
                           vs[v].name.c_str(), act, want_active);
      if (vs[v].keeps_owner) {
        CHECK(cudaMemcpy(got.data(), d.owner, kN * 4,
                         cudaMemcpyDeviceToHost));
        if (std::count(got.begin(), got.end(), INT_MAX) != kN)
          ++bad, std::printf("OWNER level %d %s not INT_MAX\n", lv,
                             vs[v].name.c_str());
      }
    }
    for (int turn = 0; turn < kTurns; ++turn) {
      for (int v = 0; v < nv; ++v)
        t[lv][v].push_back(
            time_ms([&] { vs[v].run(d); }, [&] { restore(d); }));
      for (int p = 0; p < np; ++p)
        t[lv][nv + p].push_back(time_ms([&] { passes[p].run(d); }, [&] {
          restore(d);
          if (passes[p].prep) passes[p].prep(d);
        }));
    }
  }

  std::printf("\nms a level (median of %d turns), frontier sizes first\n",
              kTurns);
  std::printf("%-14s", "level");
  for (int lv = 0; lv < levels; ++lv) std::printf(" %9d", lv);
  std::printf(" %10s\n%-14s", "sum", "frontier");
  for (int lv = 0; lv < levels; ++lv) std::printf(" %9d", fsize[lv]);
  std::printf("\n");
  for (int v = 0; v < nv + np; ++v) {
    const std::string name = v < nv ? vs[v].name : passes[v - nv].name;
    std::printf("%-14s", name.c_str());
    double sum = 0;
    for (int lv = 0; lv < levels; ++lv) {
      const float m = median(t[lv][v]);
      sum += m;
      std::printf(" %9.6f", m);
    }
    std::printf(" %10.6f\n", sum);
  }
  std::printf("\nbfs_frontier_variants: %d levels, %s\n", levels,
              bad ? "MISMATCH" : "every variant equals the old kernel");
  for (int** b : bufs) CHECK(cudaFree(*b));
  CHECK(cudaFree(d.bids));
  return bad ? 1 : 0;
}
