// Times src/repro_torch/csrc/histogram.cu at the main path's shape (n =
// 2^24 int32 pixels drawn uniformly from 256 bins, 1024 x 256 threads of
// 64 pixels each) beside the kernel it replaced and variants of its
// design, on one CUDA card, so that the choices its source note makes rest
// on a measurement:
//   old coal / old contig  the earlier kernel in the coalesced and the
//              contiguous layout: 1024 CTAs of 256 threads, one 4-byte
//              load a thread in flight, a shared histogram a CTA;
//   kernel coal / kernel contig  the shipped kernel through
//              launch_histogram in both layouts (CTAs of
//              histogram_cta_pixels pixels over one run [0, n)), and the
//              coalesced one with x 4 bytes off a 16-byte boundary;
//   L<l> P<p>  the design with l int4s a thread loaded while its l
//              before are counted, and p pixels a CTA (65,536: 256 CTAs,
//              about 2 an SM on 132; 131,072: 128, about 1; 32,768: 512,
//              about 4), one histogram a CTA (L4 P65536 is the kernel);
//   first L<l> the design's first text: l int4s loaded, then counted,
//              nothing in flight while a thread counts;
//   warps L4   a copy of the histogram a warp (8 a CTA), summed at the end;
//   sum        the same reads (L4, 65,536 pixels a CTA) that only add the
//              pixels up: the yardstick of the bytes;
//   atomics    the same shared atomics with no reads: each pixel's bin
//              hashed from its index (uniform over 256 bins), the CTAs and
//              threads of the kernel: the yardstick of the atomics;
//   one bin    the kernel and the old kernel on an input whose pixels all
//              lie in one bin, the worst case for the shared atomics (off
//              the main path).
// Every variant must equal the old coalesced kernel bit for bit on the
// same pixels (the one-bin rows each other).  Each line gives the median
// of 25 CUDA-event runs after 5 warm-ups, a spin on the card covering the
// enqueue; five turns, then each variant's median of its turns and its
// rate over the 4 bytes a pixel reads.  Build and run from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/histogram_variants tools/histogram_variants.cu \
//     && build/histogram_variants
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <utility>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/histogram.cu"

namespace variants {

constexpr int kTurns = 5, kRuns = 25, kWarm = 5;
constexpr int kN = 1 << 24, kBins = 256, kGrid = 1024, kBlock = 256;
constexpr int kT = kGrid * kBlock, kIters = (kN + kT - 1) / kT;

#define CHECK(x)                                                        \
  do {                                                                  \
    cudaError_t e_ = (x);                                               \
    if (e_ != cudaSuccess) {                                            \
      std::fprintf(stderr, "%s:%d %s\n", __FILE__, __LINE__,            \
                   cudaGetErrorString(e_));                             \
      std::exit(1);                                                     \
    }                                                                   \
  } while (0)

// the kernel this redesign replaced, as it was
__global__ void old_histogram(const int* __restrict__ x, int* hist, int n,
                              int nbins, int total_threads, int iters,
                              int contiguous) {
  extern __shared__ int local[];
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) local[i] = 0;
  __syncthreads();
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (int k = 0; k < iters; ++k) {
    const long long idx = contiguous ? gid * iters + k
                                     : gid + (long long)k * total_threads;
    if (idx >= n) continue;
    int v = x[idx];
    if (v < 0) v += nbins;
    if (v >= 0 && v < nbins) atomicAdd(&local[v], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nbins; i += blockDim.x) {
    if (local[i]) atomicAdd(&hist[i], local[i]);
  }
}

// the shipped reads, summed instead of counted: one atomic a CTA
__global__ void __launch_bounds__(kThreads)
    sum_read(const int* __restrict__ x, int* sink, int per) {
  const int4* q = reinterpret_cast<const int4*>(x + (long long)blockIdx.x *
                                                        per);
  const int nvec = per / 4;
  int s = 0;
  for (int base = threadIdx.x; base < nvec; base += kLoads * kThreads) {
    int4 v[kLoads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) v[u] = q[base + u * kThreads];
#pragma unroll
    for (int u = 0; u < kLoads; ++u) s += v[u].x + v[u].y + v[u].z + v[u].w;
  }
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if ((threadIdx.x & 31) == 0) atomicAdd(sink, s);
}

// the kernel's shared atomics and flush without its reads: bin of pixel
// i = a hash of i
__global__ void __launch_bounds__(kThreads)
    atomics_only(int* hist, int nbins, int per) {
  extern __shared__ int local[];
  const int t = threadIdx.x;
  for (int i = t; i < nbins; i += kThreads) local[i] = 0;
  __syncthreads();
  const unsigned a = blockIdx.x * (unsigned)per;
  for (int i = t; i < per; i += kThreads) {
    const unsigned h = (a + i) * 2654435761u;
    atomicAdd(local + (h >> 24) % nbins, 1);
  }
  __syncthreads();
  for (int i = t; i < nbins; i += kThreads)
    if (local[i]) atomicAdd(hist + i, local[i]);
}

// the design's first text: L int4s a thread loaded, then counted, then
// the next L (the run [0, n), n a multiple of per, x aligned)
template <int L>
__global__ void __launch_bounds__(kThreads)
    loads_first(const int* __restrict__ x, int* hist, int nbins, int per) {
  extern __shared__ int local[];
  const int t = threadIdx.x;
  for (int i = t; i < nbins; i += kThreads) local[i] = 0;
  __syncthreads();
  const int4* q = reinterpret_cast<const int4*>(x + (long long)blockIdx.x *
                                                        per);
  const int nvec = per / 4;
  for (int base = t; base < nvec; base += L * kThreads) {
    int4 v[L];
#pragma unroll
    for (int u = 0; u < L; ++u) v[u] = q[base + u * kThreads];
#pragma unroll
    for (int u = 0; u < L; ++u) {
      count(local, v[u].x, nbins);
      count(local, v[u].y, nbins);
      count(local, v[u].z, nbins);
      count(local, v[u].w, nbins);
    }
  }
  __syncthreads();
  for (int i = t; i < nbins; i += kThreads)
    if (local[i]) atomicAdd(hist + i, local[i]);
}

__global__ void spin(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

float median(std::vector<float> v) {
  std::sort(v.begin(), v.end());
  return v[v.size() / 2];
}

float time_ms(const std::function<void()>& f) {
  cudaEvent_t e0, e1;
  CHECK(cudaEventCreate(&e0));
  CHECK(cudaEventCreate(&e1));
  std::vector<float> ts;
  for (int i = 0; i < kWarm + kRuns; ++i) {
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

// a variant counts x (n pixels) into hist
using Fn = std::function<void(const int*, int*)>;

void old(const int* x, int* hist, int contiguous) {
  old_histogram<<<kGrid, kBlock, kBins * sizeof(int)>>>(
      x, hist, kN, kBins, kT, kIters, contiguous);
}

void kernel(const int* x, int* hist, int contiguous) {
  const int ctas = (kN + histogram_cta_pixels() - 1) / histogram_cta_pixels();
  CHECK((cudaError_t)launch_histogram(x, hist, kN, kBins, kT, kIters,
                                      contiguous, kGrid, kBlock, ctas,
                                      nullptr));
}

// the design over the one run [0, n): L int4s a thread, C copies, per
// pixels a CTA
template <int L, int C>
Fn design(int per) {
  return [per](const int* x, int* hist) {
    const long long chunks = (kN + per - 1) / per;
    histogram_runs<L, C><<<(int)chunks, kThreads, kBins * C * sizeof(int)>>>(
        x, hist, kN, kBins, 0, kN, chunks, per);
  };
}

int run() {
  std::vector<int> hx(kN), one(kN, 7);
  srand(42);
  for (int i = 0; i < kN; ++i) hx[i] = rand() % kBins;
  // x, x 4 bytes past a 16-byte boundary, the one-bin input
  int *x, *x1, *x7, *hist, *sink;
  CHECK(cudaMalloc(&x, (size_t)kN * 4));
  CHECK(cudaMalloc(&x1, (size_t)kN * 4 + 16));
  CHECK(cudaMalloc(&x7, (size_t)kN * 4));
  CHECK(cudaMalloc(&hist, kBins * 4));
  CHECK(cudaMalloc(&sink, 4));
  x1 += 1;
  CHECK(cudaMemcpy(x, hx.data(), (size_t)kN * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(x1, hx.data(), (size_t)kN * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(x7, one.data(), (size_t)kN * 4, cudaMemcpyHostToDevice));

  // name, input, function, and the row whose result it must equal ("":
  // none)
  struct Row {
    std::string name;
    const int* in;
    Fn f;
    std::string same_as;
  };
  const int ctas = (kN + histogram_cta_pixels() - 1) / histogram_cta_pixels();
  const std::string coal = "old coal", one_old = "one bin old";
  std::vector<Row> rows = {
      {coal, x, [](const int* a, int* h) { old(a, h, 0); }, ""},
      {"old contig", x, [](const int* a, int* h) { old(a, h, 1); }, coal},
      {"kernel coal", x, [](const int* a, int* h) { kernel(a, h, 0); }, coal},
      {"kernel contig", x, [](const int* a, int* h) { kernel(a, h, 1); },
       coal},
      {"kernel off16", x1, [](const int* a, int* h) { kernel(a, h, 0); },
       coal},
      {"L1 P65536", x, design<1, 1>(65536), coal},
      {"L2 P65536", x, design<2, 1>(65536), coal},
      {"L4 P65536", x, design<4, 1>(65536), coal},
      {"L8 P65536", x, design<8, 1>(65536), coal},
      {"first L4", x,
       [](const int* a, int* h) {
         loads_first<4><<<kN / 65536, kThreads, kBins * sizeof(int)>>>(
             a, h, kBins, 65536);
       },
       coal},
      {"first L8", x,
       [](const int* a, int* h) {
         loads_first<8><<<kN / 65536, kThreads, kBins * sizeof(int)>>>(
             a, h, kBins, 65536);
       },
       coal},
      {"L4 P131072", x, design<4, 1>(131072), coal},
      {"L4 P32768", x, design<4, 1>(32768), coal},
      {"warps L4", x, design<4, kThreads / 32>(65536), coal},
      {"sum", x,
       [](const int* a, int* h) {
         sum_read<<<kN / 65536, kThreads>>>(a, h, 65536);
       },
       ""},
      {"atomics", x,
       [](const int*, int* h) {
         atomics_only<<<kN / 65536, kThreads, kBins * sizeof(int)>>>(
             h, kBins, 65536);
       },
       ""},
      {one_old, x7, [](const int* a, int* h) { old(a, h, 0); }, ""},
      {"one bin kernel", x7, [](const int* a, int* h) { kernel(a, h, 0); },
       one_old},
      {"one bin warps", x7, design<4, kThreads / 32>(65536), one_old},
  };
  const int nv = (int)rows.size();
  std::vector<std::vector<int>> got(nv, std::vector<int>(kBins));
  std::vector<std::vector<float>> ts(nv);
  int bad = 0;
  for (int turn = 0; turn < kTurns; ++turn) {
    for (int v = 0; v < nv; ++v) {
      const Row& r = rows[v];
      int* out = r.name == "sum" ? sink : hist;
      CHECK(cudaMemset(out, 0, r.name == "sum" ? 4 : kBins * 4));
      r.f(r.in, out);
      CHECK(cudaDeviceSynchronize());
      if (turn == 0 && r.name != "sum") {
        CHECK(cudaMemcpy(got[v].data(), hist, kBins * 4,
                         cudaMemcpyDeviceToHost));
        int w = 0;
        while (w < v && rows[w].name != r.same_as) ++w;
        if (w < v && std::memcmp(got[v].data(), got[w].data(), kBins * 4))
          ++bad, std::printf("MISMATCH %s against %s\n", r.name.c_str(),
                             r.same_as.c_str());
      }
      ts[v].push_back(time_ms([&] { r.f(r.in, out); }));
    }
  }
  std::printf("\nn = %d, %d bins, %d x %d threads (kernel: %d CTAs of %d "
              "pixels; bound %.6f ms at 3.35 TB/s)\n", kN, kBins, kGrid,
              kBlock, ctas, histogram_cta_pixels(), 4.0 * kN / 3.35e12 * 1e3);
  for (int v = 0; v < nv; ++v) {
    const float m = median(ts[v]);
    std::printf("  %-16s %9.6f ms  %7.1f GB/s\n", rows[v].name.c_str(), m,
                4.0 * kN / (m * 1e-3) / 1e9);
  }
  CHECK(cudaFree(x));
  CHECK(cudaFree(x1 - 1));
  CHECK(cudaFree(x7));
  CHECK(cudaFree(hist));
  CHECK(cudaFree(sink));
  return bad;
}

}  // namespace variants

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("card: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const int bad = variants::run();
  std::printf("\nhistogram_variants: %s\n",
              bad ? "MISMATCH"
                  : "every variant equals the old coalesced kernel bit for "
                    "bit, the one-bin rows the old kernel");
  return bad ? 1 : 0;
}
