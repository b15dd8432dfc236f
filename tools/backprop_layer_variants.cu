// Times src/repro_torch/csrc/backprop_layer.cu at the main path's size
// (backprop 65536: 65,536 inputs, 16 hidden units) beside the kernel it
// replaced and a copy of the same bytes, on one CUDA card, so that the
// cluster size and CTA width its source note ships rest on a measurement:
//   old      the earlier kernel: one CTA of 1,024 threads a hidden unit,
//            16 CTAs;
//   C<c> P<p> the shipped kernel through launch_backprop_layer with a
//            cluster of c CTAs of p threads a unit (16 c CTAs, T = c p
//            threads a unit, 65536 / T inputs a thread; C16 is past the
//            portable cluster size; P = 1024 / c is the one-CTA kernel's
//            1,024 threads spread over the cluster, the mapping first
//            planned; C8 P256 is the shipped shape, as
//            lower_cuda.backprop_layer_ctas and backprop_layer_threads
//            pick it);
//   copy     cudaMemcpyAsync of w into w_out: 8.39 MB moved, the bulk of
//            the kernel's 8.65 MB;
//   first    the design's first text (pull between two cluster syncs,
//            the last levels in __shared__), and with knobs: "loads
//            first" issues all of a thread's loads before its first
//            product, "fold only" stores the partials to global memory
//            with no cluster and no tree (not compared), "tail only" runs
//            the clusters' syncs and tree with no fold (not compared);
//   float4   the fold alone with 16-byte accesses (not compared);
//   empty    an empty kernel of 128 CTAs of 512 threads, as clusters of 8
//            and not, and one cluster sync alone (not compared).
// The inputs are standard-normal-like floats from one seed.  Every
// variant must equal the old kernel bit for bit in hidden and w_out.  A
// cluster size the card refuses is reported and skipped.  The written
// buffers are zeroed before each run, outside the timed window.  Each
// line gives the median of 25 CUDA-event runs after 5 warm-ups, a spin on
// the card covering the enqueue; five turns, then each variant's median
// of its turns.  Each variant's line gives how many of its clusters the
// card holds at once (cudaOccupancyMaxActiveClusters).  Build and run
// from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/backprop_layer_variants tools/backprop_layer_variants.cu \
//     && build/backprop_layer_variants
#include <algorithm>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <utility>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/backprop_layer.cu"

namespace variants {

constexpr int kTurns = 5, kRuns = 25, kWarm = 5;
constexpr int kIn = 65536, kOut = 16, kT = 1024, kL = 6;
constexpr float kLr = 0.3f;

#define CHECK(x)                                                        \
  do {                                                                  \
    cudaError_t e_ = (x);                                               \
    if (e_ != cudaSuccess) {                                            \
      std::fprintf(stderr, "%s:%d %s\n", __FILE__, __LINE__,            \
                   cudaGetErrorString(e_));                             \
      std::exit(1);                                                     \
    }                                                                   \
  } while (0)

// the kernel this redesign replaced, as it was: block j owns unit j
template <int L>
__global__ void old_backprop(const float* __restrict__ inp,
                             const float* __restrict__ w,
                             const float* __restrict__ bias,
                             const float* __restrict__ delta, float* hidden,
                             float* w_out, int in_n, float lr) {
  __shared__ float s[1024];
  const int t = threadIdx.x, nt = blockDim.x, j = blockIdx.x;
  const float* wj = w + (size_t)j * in_n;
  float* woj = w_out + (size_t)j * in_n;
  const float lrd = __fmul_rn(lr, delta[j]);
  float st[L + 1];
#pragma unroll
  for (int p = 0; p < (1 << L); ++p) {
    int m = 0;
#pragma unroll
    for (int b = 0; b < L; ++b) m |= ((p >> b) & 1) << (L - 1 - b);
    const int i = t + m * nt;
    const float x = inp[i], wv = wj[i];
    woj[i] = __fadd_rn(wv, __fmul_rn(lrd, x));
    float carry = __fmul_rn(x, wv);
#pragma unroll
    for (int d = 0; d <= L; ++d) {
      const int below = (1 << d) - 1;
      if ((p & below) == below) {
        if ((p >> d) & 1)
          carry = __fadd_rn(st[d], carry);
        else
          st[d] = carry;
      }
    }
  }
  s[t] = st[L];
  __syncthreads();
  for (int off = nt / 2; off >= 1; off /= 2) {
    if (t < off) s[t] = __fadd_rn(s[t], s[t + off]);
    __syncthreads();
  }
  if (t == 0) {
    const float total = __fadd_rn(s[0], bias[j]);
    hidden[j] = 1.0f / (1.0f + expf(-total));
  }
}

// The design's first text (rank 0 pulls the partials through distributed
// shared memory between two cluster syncs, then runs the last log2(P)
// levels in __shared__ behind a barrier each), with knobs: LOADS_FIRST
// issues all of a thread's loads of inp and w before its first product;
// FOLD = false skips the fold (every partial 0, no load or store of the
// weights); TAIL = false stores each thread's partial to part[j T + t]
// and ends, with no cluster, no distributed shared memory and no tree.
template <int L, bool LOADS_FIRST, bool FOLD, bool TAIL>
__global__ void __launch_bounds__(1024)
    design(const float* __restrict__ inp, const float* __restrict__ w,
           const float* __restrict__ bias, const float* __restrict__ delta,
           float* hidden, float* w_out, int in_n, int nt, int nc, float lr,
           float* part) {
  namespace cg = cooperative_groups;
  __shared__ float s[1024];
  const int i = threadIdx.x, per = blockDim.x;
  const int r = TAIL ? (int)cg::this_cluster().block_rank()
                     : (int)(blockIdx.x % nc);
  const int t = r * per + i, j = blockIdx.x / nc;
  const float* wj = w + (size_t)j * in_n;
  float* woj = w_out + (size_t)j * in_n;
  const float lrd = __fmul_rn(lr, delta[j]);
  float st[L + 1];
  st[L] = 0.0f;
  if (FOLD) {
    float xs[LOADS_FIRST ? 1 << L : 1], ws[LOADS_FIRST ? 1 << L : 1];
    if (LOADS_FIRST) {
#pragma unroll
      for (int p = 0; p < (1 << L); ++p) {
        int m = 0;
#pragma unroll
        for (int b = 0; b < L; ++b) m |= ((p >> b) & 1) << (L - 1 - b);
        xs[p] = inp[t + m * nt];
        ws[p] = wj[t + m * nt];
      }
    }
#pragma unroll
    for (int p = 0; p < (1 << L); ++p) {
      int m = 0;
#pragma unroll
      for (int b = 0; b < L; ++b) m |= ((p >> b) & 1) << (L - 1 - b);
      const int k = t + m * nt;
      const float x = LOADS_FIRST ? xs[p] : inp[k];
      const float wv = LOADS_FIRST ? ws[p] : wj[k];
      woj[k] = __fadd_rn(wv, __fmul_rn(lrd, x));
      float carry = __fmul_rn(x, wv);
#pragma unroll
      for (int d = 0; d <= L; ++d) {
        const int below = (1 << d) - 1;
        if ((p & below) == below) {
          if ((p >> d) & 1)
            carry = __fadd_rn(st[d], carry);
          else
            st[d] = carry;
        }
      }
    }
  }
  if (!TAIL) {
    part[(size_t)j * nt + t] = st[L];
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  s[i] = st[L];
  cluster.sync();
  float v[16];
  if (r == 0) {
#pragma unroll
    for (int q = 0; q < 16; ++q)
      v[q] = q < nc ? cluster.map_shared_rank(s, q)[i] : 0.0f;
  }
  cluster.sync();
  if (r != 0) return;
#pragma unroll
  for (int l = 3; l >= 0; --l) {
    const int h = 8 >> (3 - l);
    if (h < nc) {
#pragma unroll
      for (int q = 0; q < (8 >> (3 - l)); ++q)
        v[q] = __fadd_rn(v[q], v[q + h]);
    }
  }
  s[i] = v[0];
  __syncthreads();
  for (int off = per / 2; off >= 1; off /= 2) {
    if (i < off) s[i] = __fadd_rn(s[i], s[i + off]);
    __syncthreads();
  }
  if (i == 0) {
    const float total = __fadd_rn(s[0], bias[j]);
    hidden[j] = 1.0f / (1.0f + expf(-total));
  }
}

// The fold alone with 16-byte accesses: thread t of a unit's T4 = nt
// threads owns the float4s t + T4 m of inp, w and w_out, and keeps four
// stacks, one per lane of the float4 (what a tree over float4s would do);
// its four partials go to part, no cluster, no tree (not compared).
template <int L>
__global__ void __launch_bounds__(256)
    fold4(const float* __restrict__ inp, const float* __restrict__ w,
          const float* __restrict__ bias, const float* __restrict__ delta,
          float* hidden, float* w_out, int in_n, int nt, int nc, float lr,
          float* part) {
  const int t = (blockIdx.x % nc) * blockDim.x + threadIdx.x;
  const int j = blockIdx.x / nc;
  const float4* x4 = reinterpret_cast<const float4*>(inp);
  const float4* w4 = reinterpret_cast<const float4*>(w + (size_t)j * in_n);
  float4* o4 = reinterpret_cast<float4*>(w_out + (size_t)j * in_n);
  const float lrd = __fmul_rn(lr, delta[j]);
  float st[4][L + 1];
#pragma unroll
  for (int p = 0; p < (1 << L); ++p) {
    int m = 0;
#pragma unroll
    for (int b = 0; b < L; ++b) m |= ((p >> b) & 1) << (L - 1 - b);
    const int k = t + m * nt;
    const float4 x = x4[k], wv = w4[k];
    o4[k] = make_float4(__fadd_rn(wv.x, __fmul_rn(lrd, x.x)),
                        __fadd_rn(wv.y, __fmul_rn(lrd, x.y)),
                        __fadd_rn(wv.z, __fmul_rn(lrd, x.z)),
                        __fadd_rn(wv.w, __fmul_rn(lrd, x.w)));
    const float c4[4] = {__fmul_rn(x.x, wv.x), __fmul_rn(x.y, wv.y),
                         __fmul_rn(x.z, wv.z), __fmul_rn(x.w, wv.w)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float carry = c4[e];
#pragma unroll
      for (int d = 0; d <= L; ++d) {
        const int below = (1 << d) - 1;
        if ((p & below) == below) {
          if ((p >> d) & 1)
            carry = __fadd_rn(st[e][d], carry);
          else
            st[e][d] = carry;
        }
      }
    }
  }
  reinterpret_cast<float4*>(part)[(size_t)j * nt + t] =
      make_float4(st[0][L], st[1][L], st[2][L], st[3][L]);
}

// yardsticks of the cluster launch: nothing, and one cluster sync
__global__ void empty(float*) {}

__global__ void sync_only(float*) { cooperative_groups::this_cluster().sync(); }

// the SM each CTA runs on, every CTA held resident for about 20 us
__global__ void where(float* part) {
  unsigned sm;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  if (threadIdx.x == 0) part[blockIdx.x] = (float)sm;
  const long long t0 = clock64();
  while (clock64() - t0 < 40000) {
  }
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

float uniform() { return (float)rand() / RAND_MAX * 2.0f - 1.0f; }

}  // namespace variants

int main() {
  using namespace variants;
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("card: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const size_t nw = (size_t)kIn * kOut;
  std::vector<float> inp(kIn), w(nw), bias(kOut), delta(kOut);
  srand(42);
  for (float& v : inp) v = uniform();
  for (float& v : w) v = 0.5f * uniform();
  for (float& v : bias) v = uniform();
  for (float& v : delta) v = uniform();
  float *d_inp, *d_w, *d_bias, *d_delta, *hidden, *w_out;
  CHECK(cudaMalloc(&d_inp, kIn * 4));
  CHECK(cudaMalloc(&d_w, nw * 4));
  CHECK(cudaMalloc(&d_bias, kOut * 4));
  CHECK(cudaMalloc(&d_delta, kOut * 4));
  CHECK(cudaMalloc(&hidden, kOut * 4));
  CHECK(cudaMalloc(&w_out, nw * 4));
  CHECK(cudaMemcpy(d_inp, inp.data(), kIn * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(d_w, w.data(), nw * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(d_bias, bias.data(), kOut * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(d_delta, delta.data(), kOut * 4, cudaMemcpyHostToDevice));
  auto restore = [&] {
    CHECK(cudaMemsetAsync(hidden, 0, kOut * 4));
    CHECK(cudaMemsetAsync(w_out, 0, nw * 4));
  };
  // the launch of a cluster of c CTAs of p threads a unit
  auto cluster = [&](int c, int p) {
    return [=] {
      return (cudaError_t)launch_backprop_layer(
          d_inp, d_w, d_bias, d_delta, hidden, w_out, kIn, kLr, kOut, c * p,
          c, nullptr);
    };
  };
  using Fn = std::function<cudaError_t()>;
  std::vector<std::pair<std::string, Fn>> vs = {
      {"old",
       [&] {
         old_backprop<kL><<<kOut, kT>>>(d_inp, d_w, d_bias, d_delta, hidden,
                                        w_out, kIn, kLr);
         return cudaGetLastError();
       }},
  };
  std::vector<std::pair<int, int>> shapes;     // (c, p) of each C<c> P<p>
  for (int c : {4, 8, 16})
    for (int p : {1024 / c, 256}) {
      if (std::find(shapes.begin(), shapes.end(), std::make_pair(c, p)) !=
          shapes.end())
        continue;
      shapes.push_back({c, p});
      char name[32];
      std::snprintf(name, sizeof name, "C%d P%d", c, p);
      vs.push_back({name, cluster(c, p)});
    }
  float* part;
  CHECK(cudaMalloc(&part, (size_t)kOut * kIn * 4));
  // design<L, ...> as a cluster of c CTAs of p threads a unit (TAIL), or
  // as the same CTAs with no cluster
  auto knob = [&](auto kern, int c, int p, bool tail, int dims = 0,
                  int smem = 0) {
    return [=]() -> cudaError_t {
      if (smem) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
      }
      if (c > 8) {
        const cudaError_t e = cudaFuncSetAttribute(
            kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
        if (e != cudaSuccess) return e;
      }
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = dims ? dims : tail ? c : 1;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(kOut * c);
      cfg.blockDim = dim3(p);
      cfg.dynamicSmemBytes = smem;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      return cudaLaunchKernelEx(&cfg, kern, (const float*)d_inp,
                                (const float*)d_w, (const float*)d_bias,
                                (const float*)d_delta, hidden, w_out, kIn,
                                c * p, c, kLr, part);
    };
  };
  // the first text at T = 1024 (64 inputs a thread), 4096 (16) and 8192
  vs.push_back({"first C8 P128", knob(design<6, false, true, true>, 8, 128,
                                      true)});
  vs.push_back({"first C8 P512", knob(design<4, false, true, true>, 8, 512,
                                      true)});
  vs.push_back({"first C8 P1024", knob(design<3, false, true, true>, 8, 1024,
                                       true)});
  vs.push_back({"first C8 P512 loads first",
                knob(design<4, true, true, true>, 8, 512, true)});
  vs.push_back({"first C8 P512 fold only",
                knob(design<4, false, true, false>, 8, 512, false)});
  vs.push_back({"first C8 P512 fold only, loads first",
                knob(design<4, true, true, false>, 8, 512, false)});
  vs.push_back({"first C8 P512 tail only",
                knob(design<4, false, false, true>, 8, 512, true)});
  // fold4 at 8 CTAs of 256 a unit: T4 = 2048 threads, 8 float4s a thread
  vs.push_back({"float4 C8 P256 fold only",
                knob(fold4<3>, 8, 256, false)});
  vs.push_back({"first C8 P512 fold only, clusters of 8",
                knob(design<4, false, true, false>, 8, 512, false, 8)});
  vs.push_back({"first C8 P512 fold only, clusters of 8, one CTA an SM",
                knob(design<4, false, true, false>, 8, 512, false, 8,
                     120 * 1024)});
  // the launch alone: 128 CTAs of 512 threads, as clusters of 8 or not
  auto bare = [&](void (*kern)(float*), int c) {
    return [=]() -> cudaError_t {
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = c;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(kOut * 8);
      cfg.blockDim = dim3(512);
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      return cudaLaunchKernelEx(&cfg, kern, part);
    };
  };
  vs.push_back({"empty, no cluster", bare(empty, 1)});
  vs.push_back({"empty, clusters of 8", bare(empty, 8)});
  vs.push_back({"sync only, clusters of 8", bare(sync_only, 8)});
  vs.push_back({"copy", [&] {
                  return cudaMemcpyAsync(w_out, d_w, nw * 4,
                                         cudaMemcpyDeviceToDevice);
                }});
  const int nv = (int)vs.size();
  std::vector<float> want_h(kOut), want_w(nw), got_h(kOut), got_w(nw);
  std::vector<bool> refused(nv, false);
  std::vector<std::vector<float>> ts(nv);
  int bad = 0;
  for (int turn = 0; turn < kTurns; ++turn) {
    for (int v = 0; v < nv; ++v) {
      const std::string& name = vs[v].first;
      if (refused[v]) continue;
      restore();
      const cudaError_t err = vs[v].second();
      if (err != cudaSuccess) {
        std::printf("%s refused: %s\n", name.c_str(),
                    cudaGetErrorString(err));
        refused[v] = true;
        cudaGetLastError();
        continue;
      }
      CHECK(cudaDeviceSynchronize());
      if (turn == 0 && name != "copy" && name.find("only") == name.npos &&
          name.find("empty") == name.npos) {
        // "only" and "empty" variants compute something else
        float* h = name == "old" ? want_h.data() : got_h.data();
        float* o = name == "old" ? want_w.data() : got_w.data();
        CHECK(cudaMemcpy(h, hidden, kOut * 4, cudaMemcpyDeviceToHost));
        CHECK(cudaMemcpy(o, w_out, nw * 4, cudaMemcpyDeviceToHost));
        if (name != "old" &&
            (std::memcmp(h, want_h.data(), kOut * 4) ||
             std::memcmp(o, want_w.data(), nw * 4)))
          ++bad, std::printf("MISMATCH %s\n", name.c_str());
      }
      ts[v].push_back(time_ms([&] { CHECK(vs[v].second()); }, restore));
    }
  }
  const double bytes = 4.0 * (kIn + 2.0 * nw + 3 * kOut);
  std::printf("\n%d inputs x %d units (bound %.6f ms at 3.35 TB/s)\n", kIn,
              kOut, bytes / 3.35e12 * 1e3);
  // how many clusters of c CTAs of p threads the card holds at once
  auto held = [](int c, int p) {
    int lg = 0;
    while ((c * p << lg) < kIn) ++lg;
    const Kernel kerns[] = {
        backprop_layer_kernel<0>, backprop_layer_kernel<1>,
        backprop_layer_kernel<2>, backprop_layer_kernel<3>,
        backprop_layer_kernel<4>, backprop_layer_kernel<5>,
        backprop_layer_kernel<6>};
    const Kernel kern = kerns[lg];
    CHECK(cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kOut * c);
    cfg.blockDim = dim3(p);
    cfg.dynamicSmemBytes = c * p * sizeof(float);
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int n = -1;
    if (cudaOccupancyMaxActiveClusters(&n, kern, &cfg) != cudaSuccess)
      n = -1;
    cudaGetLastError();
    return n;
  };
  for (int v = 0; v < nv; ++v) {
    if (refused[v]) continue;
    std::printf("  %-30s %9.6f ms", vs[v].first.c_str(), median(ts[v]));
    if (v >= 1 && v <= (int)shapes.size())
      std::printf("  (%d clusters held at once)",
                  held(shapes[v - 1].first, shapes[v - 1].second));
    std::printf("\n");
  }
  // where 16 clusters of 8 CTAs of 512 land, and 128 CTAs with no cluster
  for (int c : {1, 8}) {
    CHECK(bare(where, c)());
    CHECK(cudaDeviceSynchronize());
    std::vector<float> sm(kOut * 8);
    CHECK(cudaMemcpy(sm.data(), part, sm.size() * 4, cudaMemcpyDeviceToHost));
    std::sort(sm.begin(), sm.end());
    const int distinct = (int)(std::unique(sm.begin(), sm.end()) - sm.begin());
    std::printf("  128 CTAs of 512 in clusters of %d: on %d SMs\n", c,
                distinct);
  }
  std::printf("\nbackprop_layer_variants: %s\n",
              bad ? "MISMATCH"
                  : "every variant equals the old kernel bit for bit");
  for (void* p : {(void*)d_inp, (void*)d_w, (void*)d_bias, (void*)d_delta,
                  (void*)hidden, (void*)w_out, (void*)part})
    CHECK(cudaFree(p));
  return bad ? 1 : 0;
}
