// vecadd: the paper's Listing 1, c[i] = a[i] + b[i] for i < n.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_vecadd
// (src/repro/core/cuda_suite.py:68).
//
// Bound on the H100: memory.  Each element is read twice and written once
// (201 MB at n = 2^24), with one add: 0.060 ms at 3.35 TB/s.  The
// reference's launch has one thread an element, in the chevron's grid of
// blocks (131,072 of 128 at n = 2^24); a block of one element a thread
// costs the card about 0.65 ns to start and retire, which at that count
// is the whole run.  So the entry's grid and block stay the chevron's and
// only the launcher changes what a CTA does:
// - the threads of the logical grid cover m = min(n, grid block)
//   elements; the launcher starts CTAs of 256 threads, and each thread
//   moves kUnroll float4s of a and b (all its loads issued before the
//   first add) and stores kUnroll float4s of c, neighbouring threads on
//   neighbouring 16 bytes (vecadd_ctas gives the count: 8,192 at
//   n = 2^24);
// - the elements past the last whole float4 below m, at most three, are
//   done one a thread by the last CTA; nothing at or past m is written,
//   as the reference's threads past the grid write nothing;
// - a, b or c off a 16-byte boundary: one element a thread over m
//   (vecadd_kernel, the reference's mapping) in ceil(m / 256) CTAs.
// tools/vecadd_variants.cu times this beside one and four float4s a
// thread, a grid-stride loop and streaming cache hints (PERF.md).  The add
// is one rounding, as NumPy's, so c equals the oracle bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 2;     // float4s a thread

__global__ void vecadd_kernel(const float* __restrict__ a,
                              const float* __restrict__ b, float* c, int n) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid < n) c[gid] = __fadd_rn(a[gid], b[gid]);
}

// kUnroll float4s a thread over the m / 4 whole float4s; the last CTA
// adds the m % 4 elements after them
__global__ void __launch_bounds__(kThreads)
    vecadd_vec_kernel(const float* __restrict__ a,
                      const float* __restrict__ b, float* c, long long m) {
  const long long nvec = m / 4;
  const long long first =
      (long long)blockIdx.x * kThreads * kUnroll + threadIdx.x;
  const float4* a4 = reinterpret_cast<const float4*>(a);
  const float4* b4 = reinterpret_cast<const float4*>(b);
  float4 va[kUnroll], vb[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = first + (long long)kThreads * u;
    if (i < nvec) {
      va[u] = a4[i];
      vb[u] = b4[i];
    }
  }
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long i = first + (long long)kThreads * u;
    if (i < nvec)
      reinterpret_cast<float4*>(c)[i] = make_float4(
          __fadd_rn(va[u].x, vb[u].x), __fadd_rn(va[u].y, vb[u].y),
          __fadd_rn(va[u].z, vb[u].z), __fadd_rn(va[u].w, vb[u].w));
  }
  if (blockIdx.x == gridDim.x - 1) {
    const long long t = 4 * nvec + threadIdx.x;
    if (t < m) c[t] = __fadd_rn(a[t], b[t]);
  }
}

long long covered(int n, int grid, int block) {
  const long long threads = (long long)grid * block;
  return threads < n ? threads : n;
}

// CTAs of the 16-byte path: one at least when m > 0, for the tail
unsigned vec_ctas(long long m) {
  const long long per = (long long)kThreads * kUnroll;
  const long long ctas = (m / 4 + per - 1) / per;
  return (unsigned)(ctas ? ctas : m > 0);
}

}  // namespace

// The CTAs of 256 threads that launch_vecadd starts for 16-byte aligned
// a, b and c.
extern "C" int vecadd_ctas(int n, int grid, int block) {
  return (int)vec_ctas(covered(n, grid, block));
}

// grid, block: the chevron's; the threads they hold cover the first
// min(n, grid block) elements.  A geometry that the chevron's launch would
// refuse is refused.
extern "C" int launch_vecadd(const float* a, const float* b, float* c, int n,
                             int grid, int block, void* stream) {
  if (grid < 1 || block < 1 || block > 1024)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  const long long m = covered(n, grid, block);
  if (m <= 0) return (int)cudaSuccess;
  if (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) % 16 == 0) {
    vecadd_vec_kernel<<<vec_ctas(m), kThreads, 0, s>>>(a, b, c, m);
  } else {
    const unsigned ctas = (unsigned)((m + kThreads - 1) / kThreads);
    vecadd_kernel<<<ctas, kThreads, 0, s>>>(a, b, c, (int)m);
  }
  return (int)cudaGetLastError();
}
