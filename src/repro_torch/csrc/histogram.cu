// histogram: Hetero-Mark HIST.  Thread gid of the reference counts pixels
// k = 0 .. iters-1 at idx = gid + k * total_threads (the coalesced
// layout, Fig. 10a) or idx = gid * iters + k (the contiguous one, Fig.
// 10c), those below n, into hist[x[idx]] with an integer atomicAdd.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_histogram
// (src/repro/core/cuda_suite.py:102).
//
// Bound on the H100: memory.  The pixels are read once (67 MB at n = 2^24
// int32): 0.020 ms at 3.35 TB/s.  The counts are integers, so their order
// does not change the result, and the kernel may read the pixels in any
// order.  A thread of the reference's mapping loads one int, adds it, and
// moves total_threads pixels on: about one 4-byte load in flight a
// thread, which held the old kernel (1024 CTAs of 256) at 1.5 TB/s by
// Little's law, 0.0447 ms.  So the launcher ignores the thread mapping
// and counts the same multiset of pixels as runs of consecutive ones
// (struct Runs): with T = total_threads and G = grid block threads,
// - coalesced, G = T (the main path): the rows [k T, k T + T) of the k-th
//   pixels tile [0, n), one run;
// - coalesced, G != T: iters runs [k T, min(k T + G, n)), k < iters; for
//   G > T they overlap, and a pixel counts once for each run that holds
//   it, as the reference's threads gid >= T count pixels again;
// - contiguous: the run [0, min(n, G iters)).
// A CTA of 256 threads counts up to kPixels consecutive pixels of one run
// (a fixed count, histogram_cta_pixels; 256 CTAs at n = 2^24):
// - 16-byte int4 loads, a thread's next kLoads (64 bytes) in flight while
//   it counts its current kLoads, and scalar loads for the at most 3
//   pixels before the segment's first 16-byte boundary and after its last;
// - a private histogram in dynamic shared memory (nbins ints, at most 48
//   KB), filled by shared atomics (ATOMS.POPC.INC: a warp's increments of
//   one address are one operation);
// - one global atomicAdd per nonzero bin at the end, 256 CTAs of them
//   where the old kernel made 1024.
// A bin value follows the reference's scatter rule: a negative one wraps
// once, and one still outside [0, nbins) is dropped.
// tools/histogram_variants.cu times this beside the old kernel in both
// layouts, 1, 2 and 8 int4s in flight, the loads issued before the
// atomics with none in flight while a thread counts, a copy of the
// histogram a warp (the Copies parameter; the launcher takes one a CTA),
// CTAs of other pixel counts, a read that only sums the pixels, the
// atomics alone, and an input of one bin.  On an NVIDIA H100 80GB HBM3 at
// 700 W, at n = 2^24 and 256 bins: the old kernel 0.0449 ms (0.114
// contiguous), this kernel 0.0292 in both layouts and off 16 bytes, the
// summing read 0.0274 and the atomics alone 0.0153, so the kernel stays
// 7 % above its read; the loads issued before the atomics 0.0302; one,
// two or eight int4s in flight 0.0400, 0.0302, 0.0301; a copy a warp
// 0.0295, 512 CTAs 0.0299, 128 CTAs 0.0324; one bin for every pixel
// 0.0292.  46 registers, no spills.
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int kThreads = 256;                           // a CTA
constexpr int kLoads = 4;                               // int4s a thread
constexpr int kPixels = 65536;                          // a CTA's count

// The pixels one launch counts, with multiplicity: run r < count is
// [r stride, min(r stride + len, n)).  lower_cuda.histogram_runs gives
// the same.
struct Runs {
  long long count, stride, len;
};

Runs runs_of(int n, int total_threads, int iters, int contiguous,
             long long threads) {
  if (contiguous) {
    const long long end = threads * iters;
    return {1, 0, end < n ? end : n};
  }
  if (threads == total_threads) return {1, 0, n};
  return {iters, total_threads, threads < n ? threads : n};
}

// the scatter rule: wrap once, drop what is still outside
__device__ __forceinline__ void count(int* bins, int v, int nbins) {
  if (v < 0) v += nbins;
  if ((unsigned)v < (unsigned)nbins) atomicAdd(bins + v, 1);
}

// CTA b counts the segment [a, a + per) of run b / chunks, cut at the
// run's end, into a histogram of nbins ints a copy, `Copies` copies (1: a
// CTA; the CTA's warp count: a warp each).
template <int Loads, int Copies>
__global__ void __launch_bounds__(kThreads)
    histogram_runs(const int* __restrict__ x, int* hist, int n, int nbins,
                   long long stride, long long len, long long chunks,
                   int per) {
  extern __shared__ int local[];
  const long long r = blockIdx.x / chunks;
  const long long start = r * stride;
  const long long end = start + len < n ? start + len : n;
  const long long a = start + (blockIdx.x - r * chunks) * per;
  if (a >= end) return;                      // the whole CTA: no barrier
  const int cnt = (int)(end - a < per ? end - a : per);
  const int t = threadIdx.x;
  for (int i = t; i < nbins * Copies; i += kThreads) local[i] = 0;
  __syncthreads();
  int* bins = local + (Copies == 1 ? 0 : (t / 32) * nbins);
  const int* p = x + a;
  const int head =
      min(cnt, (int)((16 - ((uintptr_t)p & 15)) & 15) / 4);
  const int nvec = (cnt - head) / 4;
  const int tail = head + 4 * nvec;          // cnt - tail <= 3 pixels
  if (t < head) count(bins, p[t], nbins);
  if (t < cnt - tail) count(bins, p[tail + t], nbins);
  // the next Loads int4s of a thread are loaded while its current ones
  // are counted
  const int4* q = reinterpret_cast<const int4*>(p + head);
  int4 cur[Loads];
#pragma unroll
  for (int u = 0; u < Loads; ++u)
    if (t + u * kThreads < nvec) cur[u] = q[t + u * kThreads];
  for (int base = t; base < nvec; base += Loads * kThreads) {
    const int next = base + Loads * kThreads;
    int4 nxt[Loads];
#pragma unroll
    for (int u = 0; u < Loads; ++u)
      if (next + u * kThreads < nvec) nxt[u] = q[next + u * kThreads];
#pragma unroll
    for (int u = 0; u < Loads; ++u) {
      if (base + u * kThreads < nvec) {
        count(bins, cur[u].x, nbins);
        count(bins, cur[u].y, nbins);
        count(bins, cur[u].z, nbins);
        count(bins, cur[u].w, nbins);
      }
      cur[u] = nxt[u];
    }
  }
  __syncthreads();
  for (int i = t; i < nbins; i += kThreads) {
    int s = 0;
#pragma unroll
    for (int c = 0; c < Copies; ++c) s += local[c * nbins + i];
    if (s) atomicAdd(hist + i, s);
  }
}

}  // namespace

// The pixels one CTA counts; lower_cuda.histogram_ctas gives the CTA
// count from it.
extern "C" int histogram_cta_pixels() { return kPixels; }

// grid, block: the chevron's; total_threads, iters and the layout fix
// the pixels the reference's threads count; ctas: CTAs of kPixels pixels
// that cover every run.
extern "C" int launch_histogram(const int* x, int* hist, int n, int nbins,
                                int total_threads, int iters, int contiguous,
                                int grid, int block, int ctas,
                                void* stream) {
  const Runs runs = runs_of(n, total_threads, iters, contiguous,
                            (long long)grid * block);
  if (runs.len <= 0) return (int)cudaSuccess;
  const long long chunks = (runs.len + kPixels - 1) / kPixels;
  // a CTA past the runs would count its run's first pixels again
  if (ctas != runs.count * chunks) return (int)cudaErrorInvalidValue;
  histogram_runs<kLoads, 1><<<ctas, kThreads, (size_t)nbins * sizeof(int),
                              (cudaStream_t)stream>>>(
      x, hist, n, nbins, runs.stride, runs.len, chunks, kPixels);
  return (int)cudaGetLastError();
}
