// Times srad_update of src/repro_torch/csrc/srad.cu at the main path's
// 2048 x 2048 image (srad 2048 2048 ... : the chevron's (256, 256) tiles of
// 8 x 8, partials of 128 pixels) and at 4096 x 4096, where x and y (134 MB)
// no longer fit in the 50 MB L2, beside the kernels it replaced and
// variants of its design, on one CUDA card, so that the choices its source
// note makes rest on a measurement:
//   old          the earlier launch: a one-CTA fold of 1024 threads, one
//                4-byte load at a time, psum then psq, then a CTA of 8 x 8
//                threads a logical tile staging a 10 x 10 __shared__ halo,
//                its arithmetic contracted into FMAs by nvcc;
//   kernel       the shipped launch through launch_srad_update: the fold
//                (a cluster of 8 CTAs, both arrays in one pass by float4s,
//                the CTAs' sums added through distributed shared memory),
//                then the stencil
//                (8 warps a CTA, a warp 128 columns of a row, a float4 a
//                lane) as its programmatic dependent launch; also on a
//                stream of its own, and with x, y, psum and psq 4 bytes
//                off a 16-byte boundary (one float an access);
//   nopdl        the same two kernels launched one after the other;
//   kernel 1cta  the redesign's first fold, one CTA of 1024 threads, then
//                the stencil as its dependent launch;
//   fold0 + stencil
//                a primary that only stores q0, then the stencil as its
//                dependent: what two launches cost with no fold at all;
//   fold, fold 1cta, old fold, stencil, old stencil
//                each pass alone (the stencils on q0 from the new fold);
//   R<r> W<k>    the stencil written again with strips of r rows and k
//                warps a CTA, q0 read before anything (R1 W8 is the
//                shipped shape); occ<m> holds it to m CTAs an SM by
//                __launch_bounds__.
// The old launch's FMAs and fold round differently, so it is held within
// 1e-4 of `cell` (one pixel a thread, the shipped arithmetic, on the new
// fold's q0); every other variant must equal `cell` on the q0 its own fold
// left (the one-float fold adds in another order) bit for bit.  Each line
// gives the median of 25 CUDA-event runs after 5 warm-ups, a spin on the
// card covering the enqueue; five turns, then each variant's median of its
// turns and its rate over the 8 bytes a pixel moved.  Build and run from
// the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/srad_update_variants tools/srad_update_variants.cu \
//     && build/srad_update_variants
#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <utility>
#include <vector>

#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/srad.cu"

namespace variants {

constexpr int kTurns = 5, kRuns = 25, kWarm = 5;
constexpr float kLam = 0.5f;

#define CHECK(x)                                                        \
  do {                                                                  \
    cudaError_t e_ = (x);                                               \
    if (e_ != cudaSuccess) {                                            \
      std::fprintf(stderr, "%s:%d %s\n", __FILE__, __LINE__,            \
                   cudaGetErrorString(e_));                             \
      std::exit(1);                                                     \
    }                                                                   \
  } while (0)

// the fold this redesign replaced, as it was: two totals in tot
__global__ void old_fold(const float* __restrict__ psum,
                         const float* __restrict__ psq, int n_psum,
                         int n_psq, float* tot) {
  __shared__ float s1[1024];
  __shared__ float s2[1024];
  const int t = threadIdx.x;
  float a = 0.0f, b = 0.0f;
  for (int i = t; i < n_psum; i += blockDim.x) a += psum[i];
  for (int i = t; i < n_psq; i += blockDim.x) b += psq[i];
  s1[t] = a;
  s2[t] = b;
  __syncthreads();
  for (int off = blockDim.x / 2; off >= 1; off >>= 1) {
    if (t < off) {
      s1[t] = __fadd_rn(s1[t], s1[t + off]);
      s2[t] = __fadd_rn(s2[t], s2[t + off]);
    }
    __syncthreads();
  }
  if (t == 0) {
    tot[0] = s1[0];
    tot[1] = s2[0];
  }
}

// the stencil this redesign replaced, as it was, on the two totals
__global__ void old_stencil(const float* __restrict__ x,
                            const float* __restrict__ tot, float* y, int h,
                            int w, float npix, float coef) {
  __shared__ float s[10][10];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r = blockIdx.y * 8 + ty;
  const int c = blockIdx.x * 8 + tx;
  const int rc = min(max(r, 0), h - 1), cc = min(max(c, 0), w - 1);
  auto at = [&](int rr, int cx) {
    rr = min(max(rr, 0), h - 1);
    cx = min(max(cx, 0), w - 1);
    return x[(size_t)rr * w + cx];
  };
  s[ty + 1][tx + 1] = at(rc, cc);
  if (ty == 0) s[0][tx + 1] = at(rc - 1, cc);
  if (ty == 7) s[9][tx + 1] = at(rc + 1, cc);
  if (tx == 0) s[ty + 1][0] = at(rc, cc - 1);
  if (tx == 7) s[ty + 1][9] = at(rc, cc + 1);
  __syncthreads();
  if (r >= h || c >= w) return;
  const float mean = __fdiv_rn(tot[0], npix);
  const float mean2 = __fmul_rn(mean, mean);
  const float var = __fsub_rn(__fdiv_rn(tot[1], npix), mean2);
  const float q0 = __fdiv_rn(var, mean2);
  const float xc = s[ty + 1][tx + 1];
  const float dn = s[ty][tx + 1] - xc;
  const float ds = s[ty + 2][tx + 1] - xc;
  const float dw = s[ty + 1][tx] - xc;
  const float de = s[ty + 1][tx + 2] - xc;
  const float g2 = (dn * dn + ds * ds + dw * dw + de * de) / (xc * xc);
  const float ll = (dn + ds + dw + de) / xc;
  const float num = 0.5f * g2 - 0.0625f * (ll * ll);
  const float den = (1.0f + 0.25f * ll) * (1.0f + 0.25f * ll);
  const float q = num / den;
  float cd = 1.0f / (1.0f + (q - q0) / (q0 * (1.0f + q0)));
  cd = fminf(fmaxf(cd, 0.0f), 1.0f);
  y[(size_t)r * w + c] = xc + coef * cd * (dn + ds + dw + de);
}

struct Bufs {
  const float *x, *psum, *psq;
  float *tot, *y;
};

// the redesign's first fold: one CTA of 1024 threads, both arrays in one
// pass by float4s (n_psum, n_psq multiples of 4 here), q0 and den0 stored
__global__ void __launch_bounds__(1024)
    fold_1cta(const float* __restrict__ psum, const float* __restrict__ psq,
              int n_psum, int n_psq, float npix, float* tot) {
  asm volatile("griddepcontrol.launch_dependents;");
  const int t = threadIdx.x;
  const int na = n_psum / 4, nb = n_psq / 4;
  const float4* pa = reinterpret_cast<const float4*>(psum);
  const float4* pb = reinterpret_cast<const float4*>(psq);
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 4
  for (int i = t; i < max(na, nb); i += 1024) {
    if (i < na) {
      const float4 v = pa[i];
      a[0] += v.x, a[1] += v.y, a[2] += v.z, a[3] += v.w;
    }
    if (i < nb) {
      const float4 v = pb[i];
      b[0] += v.x, b[1] += v.y, b[2] += v.z, b[3] += v.w;
    }
  }
  float sa = (a[0] + a[1]) + (a[2] + a[3]);
  float sb = (b[0] + b[1]) + (b[2] + b[3]);
  for (int off = 16; off >= 1; off /= 2) {
    sa += __shfl_xor_sync(0xffffffffu, sa, off);
    sb += __shfl_xor_sync(0xffffffffu, sb, off);
  }
  __shared__ float wa[32], wb[32];
  if (t % 32 == 0) wa[t / 32] = sa, wb[t / 32] = sb;
  __syncthreads();
  if (t >= 32) return;
  sa = wa[t], sb = wb[t];
  for (int off = 16; off >= 1; off /= 2) {
    sa += __shfl_xor_sync(0xffffffffu, sa, off);
    sb += __shfl_xor_sync(0xffffffffu, sb, off);
  }
  if (t == 0) {
    const float mean = __fdiv_rn(sa, npix);
    const float mean2 = __fmul_rn(mean, mean);
    const float var = __fsub_rn(__fdiv_rn(sb, npix), mean2);
    const float q0 = __fdiv_rn(var, mean2);
    tot[0] = q0;
    tot[1] = __fmul_rn(q0, __fadd_rn(1.0f, q0));
  }
}

// a primary that reads nothing: q0 and den0 as constants
__global__ void fold0(float* tot, float q0, float den0) {
  asm volatile("griddepcontrol.launch_dependents;");
  if (threadIdx.x == 0) tot[0] = q0, tot[1] = den0;
}

// the shipped stencil as the programmatic dependent of the last launch
void stencil_pdl(const Bufs& b, int h, int w, int cx, int cy, float coef,
                 cudaStream_t s) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cx, cy);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* tc = b.tot;
  CHECK(cudaLaunchKernelEx(&cfg, srad_rows<true>, b.x, tc, b.y, h, w, h, w,
                           coef));
}

// the shipped arithmetic for one pixel, both halves
__device__ __forceinline__ float pixel(float xc, float n, float s, float we,
                                       float ea, float q0, float den0,
                                       float coef) {
  return pixel_step(xc, pixel_q(xc, n, s, we, ea), q0, den0, coef);
}

// one pixel a thread, clamped loads, the shipped arithmetic: the reference
__global__ void cell(const float* __restrict__ x, const float* tot, float* y,
                     int h, int w, float coef) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x, r = blockIdx.y;
  if (c >= w) return;
  auto at = [&](int rr, int cc) {
    return x[(size_t)min(max(rr, 0), h - 1) * w + min(max(cc, 0), w - 1)];
  };
  y[(size_t)r * w + c] = pixel(at(r, c), at(r - 1, c), at(r + 1, c),
                               at(r, c - 1), at(r, c + 1), tot[0], tot[1],
                               coef);
}

// the shipped stencil with R rows a warp and W warps a CTA, at least MINB
// CTAs an SM (float4s; h a multiple of R W, w of 128 here)
template <int R, int W, int MINB>
__global__ void __launch_bounds__(W * 32, MINB)
    strips(const float* __restrict__ x, const float* tot, float* y, int h,
           int w, float coef) {
  const int lane = threadIdx.x & 31;
  const int r0 = blockIdx.y * R * W + (threadIdx.x >> 5) * R;
  const int c0 = blockIdx.x * 128 + lane * 4;
  float v[R + 2][4];
#pragma unroll
  for (int i = 0; i < R + 2; ++i)
    load_cols<true>(x, min(max(r0 - 1 + i, 0), h - 1), c0, w, v[i]);
  const float q0 = __ldcg(tot), den0 = __ldcg(tot + 1);
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const float* row = x + (size_t)(r0 + i) * w;
    float we = __shfl_up_sync(0xffffffffu, v[i + 1][3], 1);
    float ea = __shfl_down_sync(0xffffffffu, v[i + 1][0], 1);
    if (lane == 0) we = row[max(c0 - 1, 0)];
    if (lane == 31) ea = row[min(c0 + 4, w - 1)];
    float out[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      out[e] = pixel(v[i + 1][e], v[i][e], v[i + 2][e],
                     e ? v[i + 1][e - 1] : we, e < 3 ? v[i + 1][e + 1] : ea,
                     q0, den0, coef);
    *reinterpret_cast<float4*>(y + (size_t)(r0 + i) * w + c0) =
        make_float4(out[0], out[1], out[2], out[3]);
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

float time_ms(const std::function<void(cudaStream_t)>& f, cudaStream_t s) {
  cudaEvent_t e0, e1;
  CHECK(cudaEventCreate(&e0));
  CHECK(cudaEventCreate(&e1));
  std::vector<float> ts;
  for (int i = 0; i < kWarm + kRuns; ++i) {
    spin<<<1, 1, 0, s>>>(200000);
    CHECK(cudaEventRecord(e0, s));
    f(s);
    CHECK(cudaEventRecord(e1, s));
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


// what a variant writes: y (checked against `cell`), or nothing (a fold)
enum class Out { y, old_y, none };

struct Variant {
  std::string name;
  std::function<void(const Bufs&, int, int, cudaStream_t)> run;
  Out out;
  bool off16 = false, own_stream = false;
};

template <int R, int W, int MINB = 1>
Variant design() {
  char name[32];
  std::snprintf(name, sizeof name, MINB > 1 ? "R%d W%d occ%d" : "R%d W%d",
                R, W, MINB);
  return {name,
          [](const Bufs& b, int h, int w, cudaStream_t s) {
            strips<R, W, MINB><<<dim3(w / 128, h / (R * W)), W * 32, 0, s>>>(
                b.x, b.tot, b.y, h, w, 0.25f * kLam);
          },
          Out::y};
}

int run(int h, int w) {
  const size_t npix = (size_t)h * w;
  const int nparts = (int)(npix / 128);
  std::vector<float> hx(npix), hs(nparts), hq(nparts);
  srand(42);
  for (size_t i = 0; i < npix; i += 2) {    // exp(0.1 N(0, 1)), Box-Muller
    const double u1 = (rand() + 1.0) / (RAND_MAX + 2.0);
    const double u2 = (rand() + 1.0) / (RAND_MAX + 2.0);
    const double m = std::sqrt(-2.0 * std::log(u1));
    hx[i] = (float)std::exp(0.1 * m * std::cos(6.283185307179586 * u2));
    if (i + 1 < npix)
      hx[i + 1] = (float)std::exp(0.1 * m * std::sin(6.283185307179586 * u2));
  }
  for (int b = 0; b < nparts; ++b) {
    float a = 0, c = 0;
    for (int i = 0; i < 128; ++i) {
      const float v = hx[(size_t)b * 128 + i];
      a += v, c += v * v;
    }
    hs[b] = a, hq[b] = c;
  }
  // x, y, psum, psq, and the same four 4 bytes past a 16-byte boundary
  float *x, *y, *ps, *pq, *tot, *ref, *x1, *y1, *ps1, *pq1;
  for (float** p : {&x, &y, &ref}) CHECK(cudaMalloc(p, npix * 4));
  for (float** p : {&ps, &pq}) CHECK(cudaMalloc(p, nparts * 4));
  for (float** p : {&x1, &y1}) CHECK(cudaMalloc(p, npix * 4 + 16));
  for (float** p : {&ps1, &pq1}) CHECK(cudaMalloc(p, nparts * 4 + 16));
  CHECK(cudaMalloc(&tot, 16));
  x1 += 1, y1 += 1, ps1 += 1, pq1 += 1;
  CHECK(cudaMemcpy(x, hx.data(), npix * 4, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(x1, hx.data(), npix * 4, cudaMemcpyHostToDevice));
  for (float* p : {ps, ps1})
    CHECK(cudaMemcpy(p, hs.data(), nparts * 4, cudaMemcpyHostToDevice));
  for (float* p : {pq, pq1})
    CHECK(cudaMemcpy(p, hq.data(), nparts * 4, cudaMemcpyHostToDevice));
  const float fnpix = (float)npix, coef = 0.25f * kLam;
  srad_fold<true><<<kFoldCtas, kFoldThreads>>>(ps, pq, nparts, nparts, fnpix,
                                               tot);
  cell<<<dim3((w + 127) / 128, h), 128>>>(x, tot, ref, h, w, coef);
  std::vector<float> want(npix), got(npix), want0(npix);
  CHECK(cudaMemcpy(want0.data(), ref, npix * 4, cudaMemcpyDeviceToHost));

  float qd[2];
  CHECK(cudaMemcpy(qd, tot, 8, cudaMemcpyDeviceToHost));
  const float q0c = qd[0], den0c = qd[1];
  const int cx = (w + srad_update_cta_cols() - 1) / srad_update_cta_cols();
  const int cy = (h + srad_update_cta_rows() - 1) / srad_update_cta_rows();
  auto shipped = [=](const Bufs& b, int h, int w, cudaStream_t s) {
    CHECK((cudaError_t)launch_srad_update(b.x, b.psum, b.psq, b.tot, b.y, h,
                                          w, nparts, nparts, fnpix, coef,
                                          w / 8, h / 8, cx, cy, s));
  };
  std::vector<Variant> vs = {
      {"old",
       [=](const Bufs& b, int h, int w, cudaStream_t s) {
         old_fold<<<1, 1024, 0, s>>>(b.psum, b.psq, nparts, nparts, b.tot);
         old_stencil<<<dim3(w / 8, h / 8), dim3(8, 8), 0, s>>>(
             b.x, b.tot, b.y, h, w, fnpix, coef);
       },
       Out::old_y},
      {"kernel", shipped, Out::y},
      {"kernel stream", shipped, Out::y, false, true},
      {"kernel off16", shipped, Out::y, true},
      {"nopdl",
       [=](const Bufs& b, int h, int w, cudaStream_t s) {
         srad_fold<true><<<kFoldCtas, kFoldThreads, 0, s>>>(
             b.psum, b.psq, nparts, nparts, fnpix, b.tot);
         srad_rows<true><<<dim3(cx, cy), kWarps * 32, 0, s>>>(
             b.x, b.tot, b.y, h, w, h, w, coef);
       },
       Out::y},
      {"kernel 1cta",
       [=](const Bufs& b, int h, int w, cudaStream_t s) {
         fold_1cta<<<1, 1024, 0, s>>>(b.psum, b.psq, nparts, nparts, fnpix,
                                      b.tot);
         stencil_pdl(b, h, w, cx, cy, coef, s);
       },
       Out::y},
      {"fold0 + stencil",
       [=](const Bufs& b, int h, int w, cudaStream_t s) {
         fold0<<<1, 32, 0, s>>>(b.tot, q0c, den0c);
         stencil_pdl(b, h, w, cx, cy, coef, s);
       },
       Out::y},
      {"fold 1cta",
       [=](const Bufs& b, int, int, cudaStream_t s) {
         fold_1cta<<<1, 1024, 0, s>>>(b.psum, b.psq, nparts, nparts, fnpix,
                                      b.tot);
       },
       Out::none},
      {"fold",
       [=](const Bufs& b, int, int, cudaStream_t s) {
         srad_fold<true><<<kFoldCtas, kFoldThreads, 0, s>>>(
             b.psum, b.psq, nparts, nparts, fnpix, b.tot);
       },
       Out::none},
      {"old fold",
       [=](const Bufs& b, int, int, cudaStream_t s) {
         old_fold<<<1, 1024, 0, s>>>(b.psum, b.psq, nparts, nparts, b.tot);
       },
       Out::none},
      {"stencil",
       [=](const Bufs& b, int h, int w, cudaStream_t s) {
         srad_rows<true><<<dim3(cx, cy), kWarps * 32, 0, s>>>(
             b.x, b.tot, b.y, h, w, h, w, coef);
       },
       Out::y},
      {"old stencil",
       [=](const Bufs& b, int h, int w, cudaStream_t s) {
         old_stencil<<<dim3(w / 8, h / 8), dim3(8, 8), 0, s>>>(
             b.x, b.tot, b.y, h, w, fnpix, coef);
       },
       Out::none},
      design<1, 8>(), design<1, 4>(), design<1, 16>(), design<2, 8>(),
      design<4, 8>(), design<1, 8, 8>(), design<2, 8, 6>(),
  };
  cudaStream_t own;
  CHECK(cudaStreamCreateWithFlags(&own, cudaStreamNonBlocking));
  const int nv = (int)vs.size();
  int bad = 0;
  std::vector<std::vector<float>> ts(nv);
  for (int turn = 0; turn < kTurns; ++turn) {
    for (int v = 0; v < nv; ++v) {
      const Variant& var = vs[v];
      const Bufs b = var.off16 ? Bufs{x1, ps1, pq1, tot, y1}
                               : Bufs{x, ps, pq, tot, y};
      const cudaStream_t s = var.own_stream ? own : nullptr;
      // the stencils alone read q0 and den0 from the new fold
      srad_fold<true><<<kFoldCtas, kFoldThreads, 0, s>>>(ps, pq, nparts,
                                                         nparts, fnpix, tot);
      CHECK(cudaMemsetAsync(b.y, 0, npix * 4, s));
      var.run(b, h, w, s);
      CHECK(cudaDeviceSynchronize());
      if (turn == 0 && var.out != Out::none) {
        CHECK(cudaMemcpy(got.data(), b.y, npix * 4, cudaMemcpyDeviceToHost));
        if (var.out == Out::y) {    // `cell` on the q0 this variant's fold left
          cell<<<dim3((w + 127) / 128, h), 128>>>(x, tot, ref, h, w, coef);
          CHECK(cudaMemcpy(want.data(), ref, npix * 4,
                           cudaMemcpyDeviceToHost));
        }
        if (var.out == Out::old_y) want = want0;   // y on the new fold's q0
        double err = 0;
        for (size_t i = 0; i < npix; ++i)
          err = std::max(err, (double)std::fabs(got[i] - want[i]));
        const bool same = std::equal(
            got.begin(), got.end(), want.begin(),
            [](float a, float c) { return std::memcmp(&a, &c, 4) == 0; });
        if (var.out == Out::old_y ? err > 1e-4 : !same)
          ++bad, std::printf("MISMATCH %dx%d %s: max abs err %g\n", h, w,
                             var.name.c_str(), err);
      }
      if (var.name == "stencil" || var.name == "old stencil" ||
          var.name[0] == 'R')
        srad_fold<true><<<kFoldCtas, kFoldThreads, 0, s>>>(ps, pq, nparts,
                                                           nparts, fnpix, tot);
      if (var.name == "old stencil")       // it reads the two totals
        old_fold<<<1, 1024, 0, s>>>(ps, pq, nparts, nparts, tot);
      ts[v].push_back(time_ms([&](cudaStream_t st) { var.run(b, h, w, st); },
                              s));
    }
  }
  std::printf("\n%d x %d (stencil: %d x %d CTAs of %d x %d; bound %.6f ms "
              "at 3.35 TB/s)\n",
              h, w, cx, cy, srad_update_cta_rows(), srad_update_cta_cols(),
              (8.0 * npix + 8.0 * nparts) / 3.35e12 * 1e3);
  for (int v = 0; v < nv; ++v) {
    const float m = median(ts[v]);
    std::printf("  %-14s %9.6f ms  %7.1f GB/s\n", vs[v].name.c_str(), m,
                8.0 * npix / (m * 1e-3) / 1e9);
  }
  CHECK(cudaStreamDestroy(own));
  for (float* p : {x, y, ps, pq, tot, ref}) CHECK(cudaFree(p));
  for (float* p : {x1, y1, ps1, pq1}) CHECK(cudaFree(p - 1));
  return bad;
}

}  // namespace variants

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  std::printf("card: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const int bad = variants::run(2048, 2048) + variants::run(4096, 4096);
  std::printf("\nsrad_update_variants: %s\n",
              bad ? "MISMATCH"
                  : "every variant equals `cell` bit for bit, the old "
                    "launch within 1e-4");
  return bad ? 1 : 0;
}
