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
// at 65,536 points), and every switcher's saving goes to one of k
// addresses.  All results are integer and order-free, so the card's
// atomic order cannot show: the sums are exact (modulo 2^32, as the
// reference's int32) in any grouping, and ndirty counts the distinct
// centres whose flag went from 0 to 1, as the reference's serialised CAS
// does.  The reference's inactive threads CAS a past-the-end slot k with
// an impossible compare value; here only switchers with 0 <= a < k touch
// csave or dirty, so nothing ever touches dirty[k].  A point whose a lies
// outside [0, k) takes its centre by the gather rule (wrap once, clamp)
// and updates gain and switched only.
// The chevron's grid of one point a thread (1,024 blocks of 64 at 65,536
// points) made every switcher (40 % of the points) make two global
// atomics on k = 20 addresses, about 52,000 that L2 runs one after
// another.  So the chevron's grid and block only fix the
// m = min(n, grid block) points the launch covers, and the launcher
// starts ceil(m / (kThreads kPoints)) CTAs (streamcluster_cta_points;
// lower_cuda.streamcluster_ctas gives the count):
//   - a thread takes kPoints points, kThreads apart (neighbouring threads
//     on neighbouring points), all loads issued before the first compare;
//   - 1 <= k <= STREAMCLUSTER_SHARED_K: the CTA adds its switchers'
//     savings into __shared__ bins by centre (int32 shared atomics) and
//     sets a __shared__ flag for each centre they leave, both sized at
//     launch as dynamic shared memory (8 k bytes, 8 KB at the limit);
//     after one barrier thread c makes one global atomicAdd of bin c if
//     it is non-zero and, if flag c is set, one atomicCAS(&dirty[c], 0, 1);
//     a thread issues all its centres' CASes before it counts a win;
//   - any other k: the same points a thread, with the old kernel's direct
//     global atomics on csave and dirty;
//   - gain is summed per warp with __reduce_add_sync, the warps' sums meet
//     in __shared__, and the CTA makes one global atomicAdd; the CASes it
//     won meet likewise behind a second barrier, and it makes one
//     atomicAdd on ndirty.
// tools/streamcluster_variants.cu times this beside the old kernel, an
// empty launch of the same CTAs, 1 to 8 points a thread and the direct
// global atomics.  On an NVIDIA H100 80GB HBM3 at 700 W, at k = 20: the
// old kernel 0.0188-0.0191 ms, the direct global atomics with 4 points a
// thread about the same (the atomics, not the CTAs, cost), an empty
// launch of 64 CTAs 0.0048, this kernel 0.0064-0.0071 (2 points a thread
// within 2 %, 1 and 8 points 4-10 % slower).  At k = 1,024 the bins take
// 0.0085 against the old 0.0103 and the global atomics' 0.0108; at
// k = 4,096, few switchers a centre, the global atomics take 0.0084, as
// the old kernel does, and bins that every CTA flushes whole measured
// slower there, hence the limit.  Every thread reaches the warp
// reductions and both barriers (no early return).
#include <cuda_runtime.h>

#define STREAMCLUSTER_SHARED_K 1024

namespace {

constexpr int kThreads = 256;              // a CTA
constexpr int kPoints = 4;                 // points a thread
// the centres a thread flushes at most
constexpr int kFlush = STREAMCLUSTER_SHARED_K / kThreads;
constexpr unsigned kFull = 0xffffffffu;

// The buffers of one launch.
struct Bufs {
  const int* px;
  const int* py;
  const int* cx;
  const int* cy;
  const int* cand;
  const int* assign;
  int* gain;
  int* csave;
  int* dirty;
  int* ndirty;
  int* switched;
};

// P points a thread over the first m points.  SHARED: csave's bins in
// bins[0, k) and dirty's flags in bins[k, 2 k), dynamic shared memory;
// otherwise direct global atomics.
template <int P, bool SHARED>
__global__ void __launch_bounds__(kThreads)
    streamcluster_points(Bufs b, long long m, int k) {
  extern __shared__ int bins[];
  __shared__ int wgain[kThreads / 32], wins;
  const int t = threadIdx.x;
  if (SHARED)
    for (int c = t; c < 2 * k; c += kThreads) bins[c] = 0;
  if (t == 0) wins = 0;
  const long long first = (long long)blockIdx.x * kThreads * P + t;
  int x[P], y[P], a[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const long long i = first + (long long)j * kThreads;
    if (i < m) x[j] = b.px[i], y[j] = b.py[i], a[j] = b.assign[i];
  }
  const int qx = b.cand[0], qy = b.cand[1];
  if (SHARED) __syncthreads();     // the bins are zeroed
  int save = 0, won = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const long long i = first + (long long)j * kThreads;
    if (i >= m) continue;
    int c = a[j] < 0 ? a[j] + k : a[j];   // gather rule: wrap once, clamp
    c = min(max(c, 0), k - 1);
    const int dcur = (x[j] - b.cx[c]) * (x[j] - b.cx[c])
                     + (y[j] - b.cy[c]) * (y[j] - b.cy[c]);
    const int dcand = (x[j] - qx) * (x[j] - qx) + (y[j] - qy) * (y[j] - qy);
    if (dcand < dcur) {
      const int s = dcur - dcand;
      save += s;
      b.switched[i] = 1;
      if (a[j] >= 0 && a[j] < k) {
        if (SHARED) {
          atomicAdd(&bins[a[j]], s);
          bins[k + a[j]] = 1;
        } else {
          atomicAdd(&b.csave[a[j]], s);
          won += atomicCAS(&b.dirty[a[j]], 0, 1) == 0;
        }
      }
    }
  }
  save = __reduce_add_sync(kFull, save);
  if ((t & 31) == 0) wgain[t >> 5] = save;
  __syncthreads();                 // bins, flags and the warps' gains in
  if (SHARED) {
    // thread t flushes the centres t + e kThreads; every CAS is issued
    // before the first result is used, so a thread waits on L2 once, not
    // once a centre
    int seen[kFlush];                // the flag a claim found; 1: none
#pragma unroll
    for (int e = 0; e < kFlush; ++e) {
      const int c = t + e * kThreads;
      seen[e] = 1;
      if (c < k) {
        const int s = bins[c];
        if (s) atomicAdd(&b.csave[c], s);
        if (bins[k + c]) seen[e] = atomicCAS(&b.dirty[c], 0, 1);
      }
    }
#pragma unroll
    for (int e = 0; e < kFlush; ++e) won += seen[e] == 0;
  }
  won = __reduce_add_sync(kFull, won);
  if ((t & 31) == 0 && won) atomicAdd(&wins, won);
  if (t == kThreads - 1) {
    int g = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) g += wgain[w];
    if (g) atomicAdd(b.gain, g);
  }
  __syncthreads();                 // every warp's wins in
  if (t == 0 && wins) atomicAdd(b.ndirty, wins);
}

}  // namespace

// The points one CTA of launch_streamcluster covers;
// lower_cuda.streamcluster_ctas gives the CTA count from it.
extern "C" int streamcluster_cta_points() { return kThreads * kPoints; }

// grid, block: the chevron's, whose threads cover the first
// m = min(n, grid block) points; ctas: CTAs of streamcluster_cta_points
// points that cover those m.
extern "C" int launch_streamcluster(const int* px, const int* py,
                                    const int* cx, const int* cy,
                                    const int* cand, const int* assign,
                                    int* gain, int* csave, int* dirty,
                                    int* ndirty, int* switched, int n, int k,
                                    int grid, int block, int ctas,
                                    void* stream) {
  const long long threads = (long long)grid * block;
  const long long m = threads < n ? threads : n;
  if (m <= 0) return (int)cudaSuccess;
  if ((long long)ctas * kThreads * kPoints < m)
    return (int)cudaErrorInvalidValue;
  const Bufs b{px, py, cx, cy, cand, assign, gain, csave, dirty, ndirty,
               switched};
  cudaStream_t s = (cudaStream_t)stream;
  if (k >= 1 && k <= STREAMCLUSTER_SHARED_K)
    streamcluster_points<kPoints, true>
        <<<ctas, kThreads, 2 * k * sizeof(int), s>>>(b, m, k);
  else
    streamcluster_points<kPoints, false><<<ctas, kThreads, 0, s>>>(b, m, k);
  return (int)cudaGetLastError();
}
