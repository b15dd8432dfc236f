// kmeans: one Lloyd iteration of Rodinia kmeans as two launches:
//   kmeans_assign - each point takes its nearest centroid (ties to the
//                   lower centre); the point's coordinates and a count go
//                   to its cluster's sums, and a moved point to `changed`;
//   kmeans_update - the centroid of each cluster becomes its sums over its
//                   count (over 1 where the count is negative), and an
//                   empty cluster keeps its centroid.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_kmeans_assign and
// make_kmeans_update (src/repro/core/cuda_suite.py:898 and :936).
//
// Bound on the H100: memory, then atomics.  assign moves 7.9 MB at
// 494,080 points (px, py, assign read; assign written), 2.4 us at the
// memory rate; but the reference adds every point to one of k = 4
// addresses per sum, which the card would serialise.  The coordinates are
// integer-valued and their total stays below 2^24, so every partial sum
// is an exact float whatever its order, and the kernel may pre-reduce.
// The chevron's grid of one point a thread (7,720 blocks of 64 at that
// size) made a block pay its start for 64 points and still left one
// global atomic per block and bin, about 100 K on 13 addresses, which L2
// runs one after another.  So the chevron's grid and block only fix the
// m = min(n, grid block) points the launch covers, and the launcher
// starts ceil(m / (kThreads kPoints)) CTAs (kmeans_assign_cta_points;
// 483 at 494,080 points):
//   - a thread takes kPoints points, kThreads apart (neighbouring threads
//     on neighbouring points), all loads issued before the first compare;
//   - k <= kRegK: the centroids and the thread's per-cluster sums and
//     count live in registers (assign_regs<K>, one instantiation a k);
//   - kRegK < k <= KMEANS_MAX_K: each warp adds its points into its own
//     __shared__ bins with shared atomics (assign_bins);
//   - a warp then sums each bin by shuffles, the warps' sums meet in
//     __shared__ behind one barrier, and the CTA makes one global
//     atomicAdd per bin that holds a point, and one for its moved count:
//     about 3,000 in all.
// tools/kmeans_assign_variants.cu times this beside the one-point-a-thread
// kernel, that kernel with per-block partials stored instead of added,
// other CTA widths and points a thread, and shared bins at small k.  On
// an NVIDIA H100 80GB HBM3 at 700 W, at k = 4: the old kernel 0.0285 ms,
// with its global atomics stored as partials 0.0148 (the contended
// atomics cost 13.7 us, 1.8 ns each at 7,720 an address, and the 7,720
// small CTAs most of the rest), an empty kernel of 483 CTAs 0.0051, this
// kernel 0.0084; 8 or 16 points a thread up to 37 % slower, CTAs of 128
// or 512 threads within 10 %; shared bins 0.0140, hence registers up to
// k = 8.  At k = 32 the bins take 0.0160 against the old kernel's 0.0618
// (PERF.md has the rest).  Distances use the _rn intrinsics: after the
// first update the centroids are not integers, and an FMA would move near
// ties.  update divides with __fdiv_rn, so the centroids equal NumPy's
// float32 division.
//
// kmeans_update is bound by the launch: it moves 28 k bytes.  The
// chevron's k blocks of 8 threads, of which thread 0 read count[c] and only
// then sumx[c] and sumy[c], paid two dependent round trips behind a plain
// launch after assign.  The design:
// - a lane a cluster: lane c of warp w takes cluster 32 w + c, in CTAs of
//   up to kUpdateCtaWarps warps (lower_cuda.kmeans_update_ctas gives the
//   CTA count); the chevron's grid of k blocks only fixes k;
// - one round trip: count, sumx and sumy are loaded together before any
//   is used; an empty cluster stores nothing, so cx and cy are never read;
// - a programmatic dependent launch (as needle_nw's): the launch and the
//   CTAs' start overlap assign's tail.  Only index arithmetic runs before
//   griddepcontrol.wait, since assign adds into sumx, sumy and count by
//   atomics; each lane signals griddepcontrol.launch_dependents once its
//   loads are issued.  sumx, sumy and count have no __restrict__, so their
//   loads do not take the non-coherent path.
// The reference divides by max(count, 1) and keeps the centroid only where
// the count is 0, so a negative count divides by 1, as here.
// assign signals griddepcontrol.launch_dependents once its loads are
// issued (kAssignTriggers), so that update's CTA may start before assign's
// have all finished; it changes nothing else in assign.
// tools/kmeans_update_variants.cu times update beside the kernel it
// replaced, the mapping launched plainly, CTAs of 1 to 8 warps and an
// empty kernel of its CTA, and the chain's iteration (four zero fills,
// assign, update) with and without assign's trigger.  On an NVIDIA H100
// 80GB HBM3 at 700.00 W, 512 launches back to back at k = 4: this kernel
// 0.9008 us a launch, the old one 2.2326, this mapping launched plainly
// 1.9630, CTAs of 1 to 8 warps 0.889-0.901; an empty kernel 0.5592 as a
// dependent launch and 1.6943 plainly.  An iteration streamed: 14.44 us
// against the old kernel's 15.89, 14.15 with assign's trigger; replayed as
// one CUDA graph: 9.73 against 10.11, 9.02 with the trigger.  update 20
// registers, assign 40 at k = 4 with or without the trigger, no spills.
#include <cuda_runtime.h>

#define KMEANS_MAX_K 32

namespace {

constexpr int kThreads = 256;              // a CTA
constexpr int kPoints = 4;                 // points a thread
constexpr int kWarps = kThreads / 32;
constexpr int kRegK = 8;                   // the largest k held in registers
constexpr unsigned kFull = 0xffffffffu;
constexpr int kUpdateCtaWarps = 8;         // update's widest CTA
constexpr bool kAssignTriggers = true;     // assign signals its dependents

__device__ __forceinline__ void wait_for_prerequisites() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;");
}

__device__ __forceinline__ float dist2(float x, float y, float cx, float cy) {
  const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// lane 0 gets the warp's sum (exact in any order for integer values)
template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  return v;
}

// The buffers of one assign launch.
struct Bufs {
  const float* px;
  const float* py;
  const float* cx;
  const float* cy;
  int* assign;
  int* changed;
  float* sumx;
  float* sumy;
  int* count;
};

// The first of the thread's kPoints points, kThreads apart.
__device__ __forceinline__ long long first_point() {
  return (long long)blockIdx.x * kThreads * kPoints + threadIdx.x;
}

// The CTA's partials: each warp's sums (sx, sy, count per bin, its moved
// count) meet in __shared__; thread c < k adds bin c's to the global sums
// and thread kThreads - 1 the moved count.  Every thread calls this.
template <int NB>
__device__ __forceinline__ void flush(const Bufs& b, float (&wx)[kWarps][NB],
                                      float (&wy)[kWarps][NB],
                                      int (&wn)[kWarps][NB],
                                      int (&wm)[kWarps], int moved, int k) {
  const int t = threadIdx.x;
  moved = warp_sum(moved);
  if ((t & 31) == 0) wm[t >> 5] = moved;
  __syncthreads();
  if (t < k) {
    float x = 0.0f, y = 0.0f;
    int n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      x += wx[w][t];
      y += wy[w][t];
      n += wn[w][t];
    }
    if (n) {
      atomicAdd(&b.sumx[t], x);
      atomicAdd(&b.sumy[t], y);
      atomicAdd(&b.count[t], n);
    }
  }
  if (t == kThreads - 1) {
    int n = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) n += wm[w];
    if (n) atomicAdd(b.changed, n);
  }
}

// k == K <= kRegK: centroids and per-cluster partials in registers.
template <int K, bool kTrigger = kAssignTriggers>
__global__ void __launch_bounds__(kThreads) assign_regs(Bufs b, long long m) {
  __shared__ float wx[kWarps][K], wy[kWarps][K];
  __shared__ int wn[kWarps][K], wm[kWarps];
  float ccx[K], ccy[K], sx[K], sy[K];
  int sn[K];
#pragma unroll
  for (int c = 0; c < K; ++c) {
    ccx[c] = b.cx[c], ccy[c] = b.cy[c];
    sx[c] = 0.0f, sy[c] = 0.0f, sn[c] = 0;
  }
  const long long first = first_point();
  float x[kPoints], y[kPoints];
  int old[kPoints];
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const long long i = first + (long long)j * kThreads;
    if (i < m) x[j] = b.px[i], y[j] = b.py[i], old[j] = b.assign[i];
  }
  if constexpr (kTrigger) launch_dependents();
  int moved = 0;
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const long long i = first + (long long)j * kThreads;
    if (i >= m) continue;
    int best = 0;
    float bestd = dist2(x[j], y[j], ccx[0], ccy[0]);
#pragma unroll
    for (int c = 1; c < K; ++c) {
      const float d = dist2(x[j], y[j], ccx[c], ccy[c]);
      if (d < bestd) {            // strict: ties keep the lower centre
        best = c;
        bestd = d;
      }
    }
    moved += old[j] != best;
    b.assign[i] = best;
#pragma unroll
    for (int c = 0; c < K; ++c) {
      const bool mine = best == c;
      sx[c] += mine ? x[j] : 0.0f;
      sy[c] += mine ? y[j] : 0.0f;
      sn[c] += mine;
    }
  }
  const int warp = threadIdx.x >> 5;
  const bool lead = (threadIdx.x & 31) == 0;
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float ax = warp_sum(sx[c]), ay = warp_sum(sy[c]);
    const int an = warp_sum(sn[c]);
    if (lead) wx[warp][c] = ax, wy[warp][c] = ay, wn[warp][c] = an;
  }
  flush<K>(b, wx, wy, wn, wm, moved, K);
}

// kRegK < k <= KMEANS_MAX_K: centroids in __shared__, a bin set per warp
// filled by shared atomics.
template <bool kTrigger = kAssignTriggers>
__global__ void __launch_bounds__(kThreads)
    assign_bins(Bufs b, long long m, int k) {
  __shared__ float ccx[KMEANS_MAX_K], ccy[KMEANS_MAX_K];
  __shared__ float wx[kWarps][KMEANS_MAX_K], wy[kWarps][KMEANS_MAX_K];
  __shared__ int wn[kWarps][KMEANS_MAX_K], wm[kWarps];
  const int t = threadIdx.x, warp = t >> 5;
  if (t < k) ccx[t] = b.cx[t], ccy[t] = b.cy[t];
  for (int e = t; e < kWarps * KMEANS_MAX_K; e += kThreads) {
    (&wx[0][0])[e] = 0.0f;
    (&wy[0][0])[e] = 0.0f;
    (&wn[0][0])[e] = 0;
  }
  const long long first = first_point();
  float x[kPoints], y[kPoints];
  int old[kPoints];
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const long long i = first + (long long)j * kThreads;
    if (i < m) x[j] = b.px[i], y[j] = b.py[i], old[j] = b.assign[i];
  }
  if constexpr (kTrigger) launch_dependents();
  __syncthreads();                // the centroids are in, the bins zeroed
  int moved = 0;
#pragma unroll
  for (int j = 0; j < kPoints; ++j) {
    const long long i = first + (long long)j * kThreads;
    if (i >= m) continue;
    int best = 0;
    float bestd = dist2(x[j], y[j], ccx[0], ccy[0]);
    for (int c = 1; c < k; ++c) {
      const float d = dist2(x[j], y[j], ccx[c], ccy[c]);
      if (d < bestd) {            // strict: ties keep the lower centre
        best = c;
        bestd = d;
      }
    }
    moved += old[j] != best;
    b.assign[i] = best;
    atomicAdd(&wx[warp][best], x[j]);
    atomicAdd(&wy[warp][best], y[j]);
    atomicAdd(&wn[warp][best], 1);
  }
  flush<KMEANS_MAX_K>(b, wx, wy, wn, wm, moved, k);
}

// assign_regs<k>, for 1 <= k <= K.
template <int K>
void launch_assign(const Bufs& b, long long m, int k, int ctas,
                   cudaStream_t s) {
  if (k == K) {
    assign_regs<K><<<ctas, kThreads, 0, s>>>(b, m);
  } else if constexpr (K > 1) {
    launch_assign<K - 1>(b, m, k, ctas, s);
  }
}

// Lane c of the launch takes cluster c; blockDim-agnostic, so
// tools/kmeans_update_variants.cu can launch it on other CTAs.
__global__ void kmeans_update_kernel(const float* sumx, const float* sumy,
                                     const int* count, float* cx, float* cy,
                                     int k) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= k) return;
  wait_for_prerequisites();
  const int cnt = count[c];
  const float sx = sumx[c], sy = sumy[c];
  launch_dependents();
  if (cnt == 0) return;           // an empty cluster keeps its centroid
  const float safe = __int2float_rn(max(cnt, 1));
  cx[c] = __fdiv_rn(sx, safe);
  cy[c] = __fdiv_rn(sy, safe);
}

// The CTAs of kmeans_update (warps of a lane a cluster, up to
// kUpdateCtaWarps a CTA) and their threads, for k clusters.
inline int update_ctas_of(int k) {
  const int warps = (k + 31) / 32;
  return (warps + kUpdateCtaWarps - 1) / kUpdateCtaWarps;
}

inline int update_threads_of(int k) {
  const int warps = (k + 31) / 32;
  return 32 * (warps < kUpdateCtaWarps ? warps : kUpdateCtaWarps);
}

}  // namespace

// The points one CTA of launch_kmeans_assign covers;
// lower_cuda.kmeans_assign_ctas gives the CTA count from it.
extern "C" int kmeans_assign_cta_points() { return kThreads * kPoints; }

// grid, block: the chevron's, whose threads cover the first
// m = min(n, grid block) points; ctas: CTAs of kmeans_assign_cta_points
// points that cover those m.
extern "C" int launch_kmeans_assign(const float* px, const float* py,
                                    const float* cx, const float* cy,
                                    int* assign, int* changed, float* sumx,
                                    float* sumy, int* count, int n, int k,
                                    int grid, int block, int ctas,
                                    void* stream) {
  if (k < 1 || k > KMEANS_MAX_K) return (int)cudaErrorInvalidValue;
  const long long threads = (long long)grid * block;
  const long long m = threads < n ? threads : n;
  if (m <= 0) return (int)cudaSuccess;
  const Bufs b{px, py, cx, cy, assign, changed, sumx, sumy, count};
  cudaStream_t s = (cudaStream_t)stream;
  if (k <= kRegK)
    launch_assign<kRegK>(b, m, k, ctas, s);
  else
    assign_bins<kAssignTriggers><<<ctas, kThreads, 0, s>>>(b, m, k);
  return (int)cudaGetLastError();
}

// The widest CTA of kmeans_update; lower_cuda.kmeans_update_ctas gives
// the CTA count.
extern "C" int kmeans_update_cta_threads() { return kUpdateCtaWarps * 32; }

// grid == k: the chevron's one block of `block` threads a cluster, run as a
// lane a cluster and launched as a programmatic dependent of the work
// before it on the stream.  A block the chevron could not launch is
// refused as the chevron would refuse it.
extern "C" int launch_kmeans_update(const float* sumx, const float* sumy,
                                    const int* count, float* cx, float* cy,
                                    int k, int block, void* stream) {
  if (k < 1 || block < 1 || block > 1024)
    return (int)cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(update_ctas_of(k));
  cfg.blockDim = dim3(update_threads_of(k));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kmeans_update_kernel, sumx, sumy,
                                 count, cx, cy, k);
}
