// Times src/repro_torch/csrc/lavamd.cu at the main path's size (lavaMD
// -boxes1d 10: 1000 home boxes of 100 particles, 27 neighbour boxes each,
// alpha 0.5) beside the kernel it replaced and variants of its design, on
// one CUDA card, so that the choices its source note makes rest on a
// measurement.  The inputs have the entry's shape, drawn here (a fixed
// LCG, not NumPy's draws): pos in [-2, 2), q in [0.1, 1), neighbour 0 the
// home box, 1 the next box on a ring, the rest random boxes.  Variants:
//   old        the earlier kernel: a CTA of ppb threads, a particle a
//              thread, each neighbour staged alone between two barriers;
//   kernel     the shipped kernel through launch_lavamd: a CTA a home
//              box, all 27 neighbours staged once as float2s,
//              (neighbour, pair of particles) items over 512 threads, the
//              u_k in __shared__ and added in k order after one barrier,
//              the j loop unrolled by 16, expf;
//   once       every neighbour staged once, a particle a thread over all
//              of them (the old mapping: no lane fill);
//   box R<r> <exp> T<t> [U<u>]
//              the shipped design with r particles a thread, t threads a
//              CTA and the j loop unrolled by u (4 unless named); the exp
//              as expf or as ex2.approx.ftz of d*d*(-alpha log2 e);
//   split C<c> R<r> <exp>
//              a CTA a (home box, chunk of c neighbours), the u_k to a
//              global scratch and a second kernel adding them in k order:
//              more, smaller CTAs, so that the last wave is short (the
//              CTA's width the fewest idle lanes over 128 to 512 threads).
// Each variant must hold the old kernel within 1e-4 + 1e-4 |force| (the
// entry's tolerance).  Each line gives the median of 25 CUDA-event runs
// after 5 warm-ups, a spin on the card covering the enqueue; five turns,
// then each variant's median of its turns.  With a directory as its
// argument the tool also writes pos, q, nbr and every variant's force
// there as raw little-endian arrays (float32; nbr int32), for
// tools/lavamd_plain_err.py to hold against the plain version.  Build
// and run from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/lavamd_variants tools/lavamd_variants.cu \
//     && build/lavamd_variants build/lavamd_dump
#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <string>
#include <utility>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/lavamd.cu"

namespace variants {

constexpr int kTurns = 5, kRuns = 25, kWarm = 5;
constexpr int kBoxes = 1000, kPpb = 100, kNnei = 27;
constexpr float kAlpha = 0.5f;

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
__global__ void old_lavamd(const float* __restrict__ pos,
                           const float* __restrict__ q,
                           const int* __restrict__ nbr, float* force,
                           int nboxes, int ppb, int nnei, float alpha) {
  extern __shared__ float old_sh[];
  float* sy = old_sh;
  float* sq = old_sh + ppb;
  const int t = threadIdx.x, b = blockIdx.x;
  const long long n = (long long)nboxes * ppb;
  const float x = pos[(size_t)b * ppb + t];
  float acc = 0.0f;
  for (int k = 0; k < nnei; ++k) {
    long long src = (long long)nbr[(size_t)b * nnei + k] * ppb + t;
    if (src < 0) src += n;
    src = src < 0 ? 0 : (src >= n ? n - 1 : src);
    sy[t] = pos[src];
    sq[t] = q[src];
    __syncthreads();
    float u = 0.0f;
    for (int j = 0; j < ppb; ++j) {
      const float d = x - sy[j];
      u += sq[j] * expf(-alpha * d * d);
    }
    acc += u;
    __syncthreads();
  }
  force[(size_t)b * ppb + t] = acc;
}

__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// exp(-alpha d d): expf of ((-alpha) d) d, or ex2.approx of d d c with c
// = -alpha log2(e)
template <bool EX2>
__device__ __forceinline__ float term_exp(float d, float nalpha, float c) {
  if (EX2) return ex2_approx(d * d * c);
  return expf(nalpha * d * d);
}

// every neighbour staged once (float2s, one barrier), a particle a thread
template <bool EX2>
__global__ void once(const float* __restrict__ pos,
                     const float* __restrict__ q, const int* __restrict__ nbr,
                     float* force, int nboxes, int ppb, int nnei,
                     float alpha) {
  extern __shared__ float2 once_sh[];
  float2* syq = once_sh;
  const int t = threadIdx.x, b = blockIdx.x;
  const long long n = (long long)nboxes * ppb;
  for (int i = t; i < nnei * ppb; i += blockDim.x) {
    const int k = i / ppb;
    const long long s = gather_index(nbr[(size_t)b * nnei + k], ppb,
                                     i - k * ppb, n);
    syq[i] = make_float2(pos[s], q[s]);
  }
  __syncthreads();
  if (t >= ppb) return;
  const float x = pos[(size_t)b * ppb + t], nalpha = -alpha;
  const float c = -alpha * 1.4426950408889634f;
  float acc = 0.0f;
  for (int k = 0; k < nnei; ++k) {
    float u = 0.0f;
#pragma unroll 4
    for (int j = 0; j < ppb; ++j) {
      const float2 v = syq[k * ppb + j];
      const float d = x - v.x;
      u = fmaf(v.y, term_exp<EX2>(d, nalpha, c), u);
    }
    acc += u;
  }
  force[(size_t)b * ppb + t] = acc;
}

// the shipped design with R home particles a thread, either exp and the j
// loop unrolled by U; all neighbours in one chunk (32.4 KB)
template <int R, bool EX2, int U>
__global__ void __launch_bounds__(512)
    design(const float* __restrict__ pos, const float* __restrict__ q,
           const int* __restrict__ nbr, float* force, int nboxes, int ppb,
           int nnei, float alpha) {
  extern __shared__ float2 sh2[];
  float2* syq = sh2;
  float* su = reinterpret_cast<float*>(sh2 + nnei * ppb);
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const long long n = (long long)nboxes * ppb;
  const int groups = (ppb + R - 1) / R;
  const float* home = pos + (size_t)b * ppb;
  const float nalpha = -alpha, c = -alpha * 1.4426950408889634f;
  for (int i = tid; i < nnei * ppb; i += nt) {
    const int k = i / ppb;
    const long long s = gather_index(nbr[(size_t)b * nnei + k], ppb,
                                     i - k * ppb, n);
    syq[i] = make_float2(pos[s], q[s]);
  }
  __syncthreads();
  for (int item = tid; item < nnei * groups; item += nt) {
    const int k = item / groups, t0 = (item - k * groups) * R;
    float x[R], u[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      x[r] = home[min(t0 + r, ppb - 1)];
      u[r] = 0.0f;
    }
    const float2* yq = syq + k * ppb;
#pragma unroll U
    for (int j = 0; j < ppb; ++j) {
      const float2 v = yq[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d = x[r] - v.x;
        u[r] = fmaf(v.y, term_exp<EX2>(d, nalpha, c), u[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (t0 + r < ppb) su[k * ppb + t0 + r] = u[r];
  }
  __syncthreads();
  for (int t = tid; t < ppb; t += nt) {
    float acc = 0.0f;
    for (int k = 0; k < nnei; ++k) acc += su[k * ppb + t];
    force[(size_t)b * ppb + t] = acc;
  }
}

// the shipped terms kernel with R particles a thread and either exp
template <int R, bool EX2>
__global__ void __launch_bounds__(512)
    split(const float* __restrict__ pos, const float* __restrict__ q,
          const int* __restrict__ nbr, float* __restrict__ u, int nboxes,
          int ppb, int nnei, int chunk, int nchunks, float alpha) {
  extern __shared__ float2 split_sh[];
  float2* syq = split_sh;
  const int b = blockIdx.x / nchunks;
  const int k0 = (blockIdx.x - b * nchunks) * chunk;
  const int kc = min(chunk, nnei - k0);
  const int tid = threadIdx.x, nt = blockDim.x;
  const long long n = (long long)nboxes * ppb;
  const int groups = (ppb + R - 1) / R;
  const int* nb = nbr + (size_t)b * nnei + k0;
  for (int i = tid; i < kc * ppb; i += nt) {
    const int k = i / ppb;
    const long long s = gather_index(nb[k], ppb, i - k * ppb, n);
    syq[i] = make_float2(pos[s], q[s]);
  }
  __syncthreads();
  const float* home = pos + (size_t)b * ppb;
  float* ub = u + ((size_t)b * nnei + k0) * ppb;
  const float nalpha = -alpha, c = -alpha * 1.4426950408889634f;
  for (int item = tid; item < kc * groups; item += nt) {
    const int k = item / groups, t0 = (item - k * groups) * R;
    float x[R], acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      x[r] = home[min(t0 + r, ppb - 1)];
      acc[r] = 0.0f;
    }
    const float2* yq = syq + k * ppb;
#pragma unroll 4
    for (int j = 0; j < ppb; ++j) {
      const float2 v = yq[j];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d = x[r] - v.x;
        acc[r] = fmaf(v.y, term_exp<EX2>(d, nalpha, c), acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (t0 + r < ppb) ub[k * ppb + t0 + r] = acc[r];
  }
}

// force[i] = u_0 + .. + u_{nnei-1} of particle i, for i < np: the split
// design's second kernel
__global__ void __launch_bounds__(256)
    split_sum(const float* u, float* __restrict__ force, int ppb, int nnei,
              long long np) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= np) return;
  const long long b = i / ppb, t = i - b * ppb;
  const float* ui = u + b * nnei * ppb + t;
  float acc = 0.0f;
  for (int k = 0; k < nnei; ++k) acc += __ldcg(ui + (size_t)k * ppb);
  force[i] = acc;
}

// the split design's width: the fewest idle lanes over `items` items
int fill_threads(long long items) {
  int best = 128;
  double fill = 0.0;
  for (int t = 128; t <= 512; t += 32) {
    const long long rounds = (items + t - 1) / t;
    const double f = (double)items / (double)(rounds * t);
    if (f > fill + 1e-12) best = t, fill = f;
    if (t >= items) break;
  }
  return best;
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

struct Bufs {
  const float *pos, *q;
  const int* nbr;
  float* force;
};

using Fn = std::function<void(const Bufs&)>;

template <int R, bool EX2, int U = 4>
std::pair<std::string, Fn> box(int t) {
  char name[48];
  std::snprintf(name, sizeof name, U == 4 ? "box R%d %s T%d" :
                "box R%d %s T%d U%d", R, EX2 ? "ex2" : "expf", t, U);
  const size_t smem = (size_t)kNnei * kPpb * 12;
  return {name, [=](const Bufs& b) {
            design<R, EX2, U><<<kBoxes, t, smem>>>(
                b.pos, b.q, b.nbr, b.force, kBoxes, kPpb, kNnei, kAlpha);
          }};
}

void dump(const std::string& dir, const std::string& name, const void* p,
          size_t bytes) {
  const std::string path = dir + "/" + name + ".bin";
  FILE* f = std::fopen(path.c_str(), "wb");
  if (!f || std::fwrite(p, 1, bytes, f) != bytes) {
    std::fprintf(stderr, "cannot write %s\n", path.c_str());
    std::exit(1);
  }
  std::fclose(f);
}

int run(const char* dir) {
  const int n = kBoxes * kPpb;
  std::vector<float> hpos(n), hq(n);
  std::vector<int> hnbr(kBoxes * kNnei);
  unsigned long long s = 42;
  auto uni = [&] {
    s = s * 6364136223846793005ULL + 1442695040888963407ULL;
    return (float)((s >> 40) * (1.0 / 16777216.0));
  };
  for (int i = 0; i < n; ++i) hpos[i] = -2.0f + 4.0f * uni();
  for (int i = 0; i < n; ++i) hq[i] = 0.1f + 0.9f * uni();
  for (int b = 0; b < kBoxes; ++b) {
    hnbr[b * kNnei] = b;
    hnbr[b * kNnei + 1] = (b + 1) % kBoxes;
    for (int k = 2; k < kNnei; ++k)
      hnbr[b * kNnei + k] = std::min((int)(uni() * kBoxes), kBoxes - 1);
  }
  float *pos, *q, *force, *ref;
  int* nbr;
  CHECK(cudaMalloc(&pos, n * 4));
  CHECK(cudaMalloc(&q, n * 4));
  CHECK(cudaMalloc(&force, n * 4));
  CHECK(cudaMalloc(&ref, n * 4));
  CHECK(cudaMalloc(&nbr, kBoxes * kNnei * 4));
  CHECK(cudaMemcpy(pos, hpos.data(), n * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(q, hq.data(), n * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(nbr, hnbr.data(), kBoxes * kNnei * 4,
                   cudaMemcpyHostToDevice));
  if (dir) {
    dump(dir, "pos", hpos.data(), n * 4);
    dump(dir, "q", hq.data(), n * 4);
    dump(dir, "nbr", hnbr.data(), kBoxes * kNnei * 4);
  }
  old_lavamd<<<kBoxes, kPpb, 2 * kPpb * 4>>>(pos, q, nbr, ref, kBoxes, kPpb,
                                             kNnei, kAlpha);
  CHECK(cudaDeviceSynchronize());
  std::vector<float> want(n), got(n);
  CHECK(cudaMemcpy(want.data(), ref, n * 4, cudaMemcpyDeviceToHost));

  const size_t once_smem = (size_t)kNnei * kPpb * 8;
  const int once_t = (kPpb + 31) / 32 * 32;
  float* u;
  CHECK(cudaMalloc(&u, (size_t)n * kNnei * 4));
  // the shipped design at c neighbours a chunk, R particles a thread
  auto split_at = [=](auto kern, int r, int c, const char* exp) {
    const int nch = (kNnei + c - 1) / c;
    const int t = fill_threads((long long)c * ((kPpb + r - 1) / r));
    char name[48];
    std::snprintf(name, sizeof name, "split C%d R%d %s", c, r, exp);
    return std::pair<std::string, Fn>{name, [=](const Bufs& b) {
      kern<<<kBoxes * nch, t, (size_t)c * kPpb * 8>>>(
          b.pos, b.q, b.nbr, u, kBoxes, kPpb, kNnei, c, nch, kAlpha);
      split_sum<<<(n + 255) / 256, 256>>>(u, b.force, kPpb, kNnei, n);
    }};
  };
  std::vector<std::pair<std::string, Fn>> vs = {
      {"old",
       [](const Bufs& b) {
         old_lavamd<<<kBoxes, kPpb, 2 * kPpb * 4>>>(
             b.pos, b.q, b.nbr, b.force, kBoxes, kPpb, kNnei, kAlpha);
       }},
      {"kernel",
       [=](const Bufs& b) {
         CHECK((cudaError_t)launch_lavamd(b.pos, b.q, b.nbr, b.force,
                                          kBoxes, kPpb, kNnei, kAlpha,
                                          kBoxes, nullptr));
       }},
      {"once expf",
       [=](const Bufs& b) {
         once<false><<<kBoxes, once_t, once_smem>>>(
             b.pos, b.q, b.nbr, b.force, kBoxes, kPpb, kNnei, kAlpha);
       }},
      box<2, false>(128), box<2, false>(256), box<2, false>(352),
      box<2, false>(480), box<2, false>(512), box<2, false, 1>(512),
      box<2, false, 2>(512), box<2, false, 8>(512), box<2, false, 16>(512),
      box<2, false, 32>(512),
      box<1, false, 8>(512), box<3, false, 8>(512), box<4, false, 8>(352),
      box<2, true, 8>(512),
      split_at(split<2, false>, 2, 3, "expf"),
      split_at(split<2, false>, 2, 9, "expf"),
      split_at(split<2, false>, 2, 27, "expf"),
      split_at(split<1, false>, 1, 3, "expf"),
      split_at(split<2, true>, 2, 3, "ex2"),
  };
  const int nv = (int)vs.size();
  const Bufs b{pos, q, nbr, force};
  int bad = 0;
  std::vector<std::vector<float>> ts(nv);
  for (int turn = 0; turn < kTurns; ++turn) {
    for (int v = 0; v < nv; ++v) {
      CHECK(cudaMemset(force, 0, n * 4));
      vs[v].second(b);
      CHECK(cudaDeviceSynchronize());
      if (turn == 0) {
        CHECK(cudaMemcpy(got.data(), force, n * 4, cudaMemcpyDeviceToHost));
        double err = 0, fmax = 0;
        bool ok = true;
        for (int i = 0; i < n; ++i) {
          const double e = std::fabs((double)got[i] - want[i]);
          err = std::max(err, e);
          fmax = std::max(fmax, (double)std::fabs(want[i]));
          ok = ok && std::isfinite(got[i]) &&
               e <= 1e-4 + 1e-4 * std::fabs(want[i]);
        }
        std::printf("%-18s max abs err vs old %.3g (|force| up to %.4g)%s\n",
                    vs[v].first.c_str(), err, fmax, ok ? "" : "  MISMATCH");
        bad += !ok;
        if (dir) {
          std::string name = "force_" + vs[v].first;
          std::replace(name.begin(), name.end(), ' ', '_');
          dump(dir, name, got.data(), n * 4);
        }
      }
      ts[v].push_back(time_ms([&] { vs[v].second(b); }));
    }
  }
  const double terms = (double)kBoxes * kNnei * kPpb * kPpb;
  std::printf("\n%d boxes x %d particles, %d neighbours: %.4g terms; SFU "
              "bound %.6f ms (16 exp2 a clock an SM, 132 SMs, 1.98 GHz); "
              "kernel: %d threads a CTA, %d neighbours staged at once\n",
              kBoxes, kPpb, kNnei, terms, terms / (16 * 132 * 1.98e9) * 1e3,
              lavamd_cta_threads(kPpb, kNnei), lavamd_chunk(kPpb, kNnei));
  for (int v = 0; v < nv; ++v)
    std::printf("  %-18s %9.6f ms  (turns:%s)\n", vs[v].first.c_str(),
                median(ts[v]), [&] {
                  std::string t;
                  char buf[16];
                  for (float x : ts[v]) {
                    std::snprintf(buf, sizeof buf, " %.4f", x);
                    t += buf;
                  }
                  return t;
                }().c_str());
  for (float* p : {pos, q, force, ref, u}) CHECK(cudaFree(p));
  CHECK(cudaFree(nbr));
  return bad;
}

}  // namespace variants

int main(int argc, char** argv) {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("card: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const int bad = variants::run(argc > 1 ? argv[1] : nullptr);
  std::printf("\nlavamd_variants: %s\n",
              bad ? "MISMATCH"
                  : "every variant holds the old kernel within the "
                    "entry's 1e-4");
  return bad ? 1 : 0;
}
