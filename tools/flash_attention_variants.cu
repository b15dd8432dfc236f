// Times src/repro_torch/csrc/flash_attention.cu's "simt" kernel at
// granite-3-2b's attention (B 2, H 32, Hkv 8, S 4096, causal) beside the
// kernel it replaced and variants of its design, on one CUDA card, so
// that the choices its source note makes rest on a measurement.  Six
// cases: float32 at d = 64 (the main path), 32 and 128, and bfloat16
// (which the route sends to this kernel when the tensor-core kernel
// refuses a call) at d = 32, 64 and 128.  In each case:
//   32-row block  the earlier kernel, as it was, at the case's type and
//                 padded width: a CTA of 8 warps owns 32 queries, a warp 4
//                 rows; K and V staged through registers between two
//                 barriers a tile; a lane scores two keys against q read
//                 as broadcasts, p v reads p as a float4 broadcast and v
//                 one float a column;
//   kernel        the shipped kernel through its launcher (ShapeOf<DP>:
//                 256 queries a CTA with 8 x 8 micro-tiles at d = 64, 128
//                 with 8 x 8 at d = 32, 64 with 4 x 4 at d = 128; cp.async
//                 a tile ahead for float32, registers for bfloat16), and
//                 with q 4 bytes off (the next tile staged through
//                 registers);
//   q<BQ> <TM>x<TN> [u<n>] [regs]
//                 the kernel's template at other query tiles BQ and
//                 micro-tiles of TM rows x TN keys (TN = 64 / TX threads a
//                 row; the p v micro-tile is TM rows x d / TX columns),
//                 with S's loop over d unrolled n float4 steps at a time
//                 (all where no u is given), or the next tile staged
//                 through registers instead of cp.async ("regs").  At
//                 d = 32, q128 4x8 is this redesign's first shape;
//   in order      the d = 64 design written again (in_order_kernel below)
//                 with the CTAs in launch order, lightest first, where the
//                 kernel starts the heaviest causal CTAs first.
// Each turn times every variant as the median of 9 CUDA-event runs after
// 2 warm-ups and checks its output against the earlier kernel's within
// flash_attention.PLAIN_TOL of the route ((rtol, atol) = (2e-5, 2e-5) for
// float32, (1e-2, 1e-4) for bfloat16); five turns, then each variant's
// median of its five medians, its share of the operations bound (4 d
// flops a pair of the causal triangle at 67 TFLOP/s of float32 on the
// CUDA cores, where this kernel computes both types) and its time over
// the earlier kernel's.  Build and run from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/flash_attention_variants tools/flash_attention_variants.cu \
//     && build/flash_attention_variants
#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <vector>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/flash_attention.cu"

namespace old {

// the kernel this redesign replaced, as it was: its template over the
// element type and the padded width DP, and its launcher's choice of DP
constexpr int kWarps = 8, kRows = 4;            // rows a warp owns
constexpr int kQT = kWarps * kRows;             // queries a block
constexpr int kThreads = 32 * kWarps;

template <int DP>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kQT * DP + kKT * (DP + 4) + kKT * DP) +
         sizeof(float4) * kWarps * kKT;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    block_32(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int H, int Hkv,
             int Sq, int Skv, int d, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kQT * DP;
  float* vs = ks + kKT * (DP + 4);
  float4* ps = reinterpret_cast<float4*>(vs + kKT * DP);
  constexpr int kKS = DP + 4, kCols = DP / 32;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nq = (Sq + kQT - 1) / kQT;
  const int qt = blockIdx.x % nq, bh = blockIdx.x / nq;
  const int h = bh % H, b = bh / H, hk = h / (H / Hkv);
  const int q0 = qt * kQT;
  const T* qb = q + (size_t)(b * H + h) * Sq * d;
  const T* kb = k + (size_t)(b * Hkv + hk) * Skv * d;
  const T* vb = v + (size_t)(b * Hkv + hk) * Skv * d;
  T* ob = o + (size_t)(b * H + h) * Sq * d;
  for (int i = tid; i < kQT * DP; i += kThreads) {
    const int r = i / DP, c = i % DP;
    qs[i] = (q0 + r < Sq && c < d) ? to_f32(qb[(size_t)(q0 + r) * d + c])
                                   : 0.0f;
  }
  const int row0 = q0 + warp * kRows;
  const bool live = row0 < Sq;
  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kMasked;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.0f;
  }
  const int kend = causal ? min(Skv, q0 + kQT) : Skv;
  for (int k0 = 0; k0 < kend; k0 += kKT) {
    __syncthreads();
    for (int i = tid; i < kKT * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      const bool in = k0 + r < Skv && c < d;
      const size_t g = (size_t)(k0 + r) * d + c;
      ks[r * kKS + c] = in ? to_f32(kb[g]) : 0.0f;
      vs[i] = in ? to_f32(vb[g]) : 0.0f;
    }
    __syncthreads();
    if (!live) continue;
    float s[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) s[r][0] = s[r][1] = 0.0f;
    const float* klo = ks + lane * kKS;
    const float* khi = ks + (lane + 32) * kKS;
    const float* qw = qs + warp * kRows * DP;
#pragma unroll 4
    for (int c = 0; c < DP; c += 4) {
      const float4 ka = *reinterpret_cast<const float4*>(klo + c);
      const float4 kc = *reinterpret_cast<const float4*>(khi + c);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(qw + r * DP + c);
        s[r][0] = fmaf(qv.x, ka.x, s[r][0]);
        s[r][0] = fmaf(qv.y, ka.y, s[r][0]);
        s[r][0] = fmaf(qv.z, ka.z, s[r][0]);
        s[r][0] = fmaf(qv.w, ka.w, s[r][0]);
        s[r][1] = fmaf(qv.x, kc.x, s[r][1]);
        s[r][1] = fmaf(qv.y, kc.y, s[r][1]);
        s[r][1] = fmaf(qv.z, kc.z, s[r][1]);
        s[r][1] = fmaf(qv.w, kc.w, s[r][1]);
      }
    }
    float p[kRows][2];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = row0 + r;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int kpos = k0 + lane + 32 * t;
        const bool keep = kpos < Skv && (!causal || qpos >= kpos);
        s[r][t] = keep ? s[r][t] * scale : kMasked;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
      p[r][0] = expf(s[r][0] - m_new);
      p[r][1] = expf(s[r][1] - m_new);
      const float corr = expf(m[r] - m_new);
      l[r] = l[r] * corr + warp_sum(p[r][0] + p[r][1]);
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[r][j] *= corr;
    }
    float4* pw = ps + warp * kKT;
    pw[lane] = make_float4(p[0][0], p[1][0], p[2][0], p[3][0]);
    pw[lane + 32] = make_float4(p[0][1], p[1][1], p[2][1], p[3][1]);
    __syncwarp();
    const int jn = min(kKT, kend - k0);
    for (int j = 0; j < jn; ++j) {
      const float4 pj = pw[j];
      const float* vr = vs + j * DP;
#pragma unroll
      for (int jj = 0; jj < kCols; ++jj) {
        const float vv = vr[lane + 32 * jj];
        acc[0][jj] = fmaf(pj.x, vv, acc[0][jj]);
        acc[1][jj] = fmaf(pj.y, vv, acc[1][jj]);
        acc[2][jj] = fmaf(pj.z, vv, acc[2][jj]);
        acc[3][jj] = fmaf(pj.w, vv, acc[3][jj]);
      }
    }
    __syncwarp();
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = row0 + r;
    if (qpos >= Sq) break;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < kCols; ++jj) {
      const int c = lane + 32 * jj;
      if (c < d) from_f32(acc[r][jj] / denom, &ob[(size_t)qpos * d + c]);
    }
  }
}

template <typename T, int DP>
void launch(const void* q, const void* k, const void* v, void* o, int B,
            int H, int Hkv, int Sq, int Skv, int d, int causal,
            float scale) {
  constexpr size_t bytes = smem_bytes<DP>();
  cudaFuncSetAttribute(block_32<T, DP>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       (int)bytes);
  block_32<T, DP><<<B * H * ((Sq + kQT - 1) / kQT), kThreads, bytes>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, Hkv, Sq, Skv, d,
      causal, scale);
}

template <typename T>
void launch_d(const void* q, const void* k, const void* v, void* o, int B,
              int H, int Hkv, int Sq, int Skv, int d, int causal,
              float scale) {
  if (d <= 32)
    launch<T, 32>(q, k, v, o, B, H, Hkv, Sq, Skv, d, causal, scale);
  else if (d <= 64)
    launch<T, 64>(q, k, v, o, B, H, Hkv, Sq, Skv, d, causal, scale);
  else
    launch<T, 128>(q, k, v, o, B, H, Hkv, Sq, Skv, d, causal, scale);
}

}  // namespace old

namespace variants {

constexpr int B = 2, H = 32, Hkv = 8, kS = 4096, kTurns = 5;
constexpr double kFlops = 67e12;     // float32 on the CUDA cores

// the shipped float32 cp.async path written again with the CTAs in launch
// order: query tile blockIdx.x / BH, the lightest causal CTAs first
template <class Sh>
__global__ void __launch_bounds__(Sh::NT, 1)
    in_order_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, float* __restrict__ o,
                    int BH, int H, int Hkv, int Sq, int Skv, int d,
                    int causal, float scale_log2) {
  constexpr int DP = Sh::DP, BQ = Sh::BQ, TM = Sh::TM, TN = Sh::TN;
  constexpr int TX = Sh::TX, TY = Sh::TY, CN = Sh::CN, LD = Sh::LD;
  constexpr int PS = Sh::PS;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* kvs = qs + BQ * LD;
  float* ps = kvs + 4 * kKT * LD;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = lane % TX, tyl = lane / TX, ty = warp * Sh::G + tyl;
  const int qt = blockIdx.x / BH, bh = blockIdx.x % BH;
  const int h = bh % H, b = bh / H, hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const float* qb = q + (size_t)(b * H + h) * Sq * d;
  const float* kb = k + (size_t)(b * Hkv + hk) * Skv * d;
  const float* vb = v + (size_t)(b * Hkv + hk) * Skv * d;
  float* ob = o + (size_t)(b * H + h) * Sq * d;
  const int kend = causal ? min(Skv, q0 + BQ) : Skv;
  const int nt = (kend + kKT - 1) / kKT;

  stage_async<Sh, BQ>(qs, qb, q0, Sq, d, tid);
  if (nt > 0) {
    stage_async<Sh, kKT>(kvs, kb, 0, Skv, d, tid);
    stage_async<Sh, kKT>(kvs + kKT * LD, vb, 0, Skv, d, tid);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  float m[TM], l[TM], acc[TM][CN];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kMasked;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < CN; ++c) acc[i][c] = 0.0f;
  }
  float* pw = ps + warp * kKT * PS;

  for (int it = 0; it < nt; ++it) {
    const int k0 = it * kKT;
    const float* kt = kvs + (it & 1) * 2 * kKT * LD;
    const float* vt = kt + kKT * LD;
    float* kn = kvs + ((it + 1) & 1) * 2 * kKT * LD;
    float* vn = kn + kKT * LD;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (it + 1 < nt) {
      stage_async<Sh, kKT>(kn, kb, k0 + kKT, Skv, d, tid);
      stage_async<Sh, kKT>(vn, vb, k0 + kKT, Skv, d, tid);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }

    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.0f;
#pragma unroll(Sh::kUnrollD)
    for (int c = 0; c < DP; c += 4) {
      float4 kf[TN];
#pragma unroll
      for (int j = 0; j < TN; ++j)
        kf[j] = *reinterpret_cast<const float4*>(kt + (tx + TX * j) * LD + c);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const float4 qf =
            *reinterpret_cast<const float4*>(qs + (ty + TY * i) * LD + c);
#pragma unroll
        for (int j = 0; j < TN; ++j) {
          s[i][j] = fmaf(qf.x, kf[j].x, s[i][j]);
          s[i][j] = fmaf(qf.y, kf[j].y, s[i][j]);
          s[i][j] = fmaf(qf.z, kf[j].z, s[i][j]);
          s[i][j] = fmaf(qf.w, kf[j].w, s[i][j]);
        }
      }
    }

    const bool edge = k0 + kKT > Skv || (causal && k0 + kKT - 1 > q0);
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      const int qpos = q0 + ty + TY * i;
      float mx = kMasked;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        float x = s[i][j] * scale_log2;
        if (edge) {
          const int kpos = k0 + tx + TX * j;
          if (kpos >= Skv || (causal && kpos > qpos)) x = kMasked;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = exp2_approx(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        s[i][j] = exp2_approx(s[i][j] - m_new);
        sum += s[i][j];
      }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int c = 0; c < CN; ++c) acc[i][c] *= corr;
    }

#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int g = 0; g < TM / 4; ++g)
        *reinterpret_cast<float4*>(pw + (tx + TX * j) * PS + tyl * TM +
                                   4 * g) =
            make_float4(s[4 * g][j], s[4 * g + 1][j], s[4 * g + 2][j],
                        s[4 * g + 3][j]);
    __syncwarp();

#pragma unroll 8
    for (int kk = 0; kk < kKT; ++kk) {
      float p[TM];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(pw + kk * PS + tyl * TM + 4 * g);
        p[4 * g] = p4.x;
        p[4 * g + 1] = p4.y;
        p[4 * g + 2] = p4.z;
        p[4 * g + 3] = p4.w;
      }
#pragma unroll
      for (int c = 0; c < CN / 4; ++c) {
        const float4 vv = *reinterpret_cast<const float4*>(
            vt + kk * LD + tx * 4 + 4 * TX * c);
#pragma unroll
        for (int i = 0; i < TM; ++i) {
          acc[i][4 * c] = fmaf(p[i], vv.x, acc[i][4 * c]);
          acc[i][4 * c + 1] = fmaf(p[i], vv.y, acc[i][4 * c + 1]);
          acc[i][4 * c + 2] = fmaf(p[i], vv.z, acc[i][4 * c + 2]);
          acc[i][4 * c + 3] = fmaf(p[i], vv.w, acc[i][4 * c + 3]);
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int qpos = q0 + ty + TY * i;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(lt, 1e-30f);
    float* orow = ob + (size_t)qpos * d;
#pragma unroll
    for (int c = 0; c < CN / 4; ++c) {
      const int col = tx * 4 + 4 * TX * c;
      if (col < d)
        *reinterpret_cast<float4*>(orow + col) = make_float4(
            acc[i][4 * c] / denom, acc[i][4 * c + 1] / denom,
            acc[i][4 * c + 2] / denom, acc[i][4 * c + 3] / denom);
    }
  }
}

using Launch = std::function<void(const void*, const void*, const void*,
                                  void*)>;

float scale_of(int d) { return 1.0f / std::sqrt((float)d); }

template <typename T>
Launch earlier(int d) {
  return [d](const void* q, const void* k, const void* v, void* o) {
    old::launch_d<T>(q, k, v, o, B, H, Hkv, kS, kS, d, 1, scale_of(d));
  };
}

Launch kernel(int d, int bf16) {
  return [d, bf16](const void* q, const void* k, const void* v, void* o) {
    launch_flash_attention(q, k, v, o, B, H, Hkv, kS, kS, d, 1, scale_of(d),
                           bf16, nullptr, nullptr);
  };
}

template <class Sh, bool ASYNC>
Launch shape(int d) {
  return [d](const void* q, const void* k, const void* v, void* o) {
    launch_shape<float, Sh, ASYNC>(q, k, v, o, B, H, Hkv, kS, kS, d, 1,
                                   scale_of(d), nullptr);
  };
}

template <class Sh>
Launch in_order(int d) {
  return [d](const void* q, const void* k, const void* v, void* o) {
    cudaFuncSetAttribute(in_order_kernel<Sh>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)Sh::kSmem);
    in_order_kernel<Sh><<<B * H * ((kS + Sh::BQ - 1) / Sh::BQ), Sh::NT,
                          Sh::kSmem>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, B * H,
        H, Hkv, kS, kS, d, 1, scale_of(d) * kLog2e);
  };
}

struct Run {
  std::string name;
  bool q_off;         // q 4 bytes past a 16-byte boundary
  Launch f;
};

struct Case {
  std::string name;
  int d;
  bool bf16;
  std::vector<Run> runs;     // the first is the earlier kernel
};

template <class F>
float median_ms(F f) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int i = 0; i < 2; ++i) f();
  std::vector<float> ts;
  for (int r = 0; r < 9; ++r) {
    cudaEventRecord(e0);
    f();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    ts.push_back(ms);
  }
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  std::sort(ts.begin(), ts.end());
  return ts[ts.size() / 2];
}

// the device's n elements of the case's type, as float32
std::vector<float> fetch(const void* dev, size_t n, bool bf16) {
  std::vector<float> out(n);
  if (!bf16) {
    cudaMemcpy(out.data(), dev, n * 4, cudaMemcpyDeviceToHost);
    return out;
  }
  std::vector<__nv_bfloat16> raw(n);
  cudaMemcpy(raw.data(), dev, n * 2, cudaMemcpyDeviceToHost);
  for (size_t i = 0; i < n; ++i) out[i] = __bfloat162float(raw[i]);
  return out;
}

void run_case(const Case& c) {
  const size_t nq = (size_t)B * H * kS * c.d, nkv = (size_t)B * Hkv * kS * c.d;
  const size_t es = c.bf16 ? 2 : 4;
  const float rtol = c.bf16 ? 1e-2f : 2e-5f, atol = c.bf16 ? 1e-4f : 2e-5f;
  const double bound_ms =
      4.0 * c.d * B * H * (double)kS * (kS + 1) / 2 / kFlops * 1e3;
  std::vector<float> hq(nq), hk(nkv), hv(nkv);
  srand(42);
  auto uni = [] { return rand() / (float)RAND_MAX * 4 - 2; };
  for (auto& x : hq) x = uni();
  for (auto& x : hk) x = uni();
  for (auto& x : hv) x = uni();
  auto upload = [&](void* dev, const std::vector<float>& h) {
    if (!c.bf16) {
      cudaMemcpy(dev, h.data(), h.size() * 4, cudaMemcpyHostToDevice);
      return;
    }
    std::vector<__nv_bfloat16> raw(h.size());
    for (size_t i = 0; i < h.size(); ++i) raw[i] = __float2bfloat16_rn(h[i]);
    cudaMemcpy(dev, raw.data(), h.size() * 2, cudaMemcpyHostToDevice);
  };
  void *q, *k, *v, *o, *q_base;
  cudaMalloc(&q, nq * es);
  cudaMalloc(&k, nkv * es);
  cudaMalloc(&v, nkv * es);
  cudaMalloc(&o, nq * es);
  cudaMalloc(&q_base, nq * es + 16);
  void* q_off = static_cast<char*>(q_base) + 4;
  upload(q, hq);
  upload(k, hk);
  upload(v, hv);
  upload(q_off, hq);

  c.runs[0].f(q, k, v, o);
  const std::vector<float> want = fetch(o, nq, c.bf16);
  printf("%s: earlier kernel %s\n", c.name.c_str(),
         cudaGetErrorString(cudaGetLastError()));

  std::vector<std::vector<float>> times(c.runs.size());
  for (int turn = 0; turn < kTurns; ++turn) {
    for (size_t i = 0; i < c.runs.size(); ++i) {
      const Run& r = c.runs[i];
      const void* qp = r.q_off ? q_off : q;
      cudaMemset(o, 0, nq * es);
      const float ms = median_ms([&] { r.f(qp, k, v, o); });
      const std::vector<float> got = fetch(o, nq, c.bf16);
      double err = 0;
      bool close = true;
      for (size_t j = 0; j < nq; ++j) {
        const double e = std::fabs((double)got[j] - want[j]);
        err = std::max(err, e);
        close = close && e <= atol + rtol * std::fabs(want[j]);
      }
      printf("turn %d  %-10s %-22s %.4f ms  max_abs_err %.3g vs earlier  "
             "%s  %s\n",
             turn, c.name.c_str(), r.name.c_str(), ms, err,
             close ? "within PLAIN_TOL" : "OUTSIDE PLAIN_TOL",
             cudaGetErrorString(cudaGetLastError()));
      times[i].push_back(ms);
    }
  }
  float earlier_ms = 0;
  for (size_t i = 0; i < c.runs.size(); ++i) {
    std::vector<float> t = times[i];
    std::sort(t.begin(), t.end());
    const float ms = t[t.size() / 2];
    if (i == 0) earlier_ms = ms;
    printf("median of %d  %-10s %-22s %.4f ms  %.1f %% of the %.3f ms "
           "bound  %.3fx the earlier kernel\n",
           kTurns, c.name.c_str(), c.runs[i].name.c_str(), ms,
           100.0 * bound_ms / ms, bound_ms, ms / earlier_ms);
  }
  cudaFree(q);
  cudaFree(k);
  cudaFree(v);
  cudaFree(o);
  cudaFree(q_base);
}

}  // namespace variants

int main() {
  using namespace variants;
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("device: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const std::vector<Case> cases = {
      {"f32 d64", 64, false, {
           {"32-row block", false, earlier<float>(64)},
           {"kernel", false, kernel(64, 0)},
           {"kernel, q 4 bytes off", true, kernel(64, 0)},
           {"q128 8x4", false, shape<Shape<64, 128, 8, 16>, true>(64)},
           {"q128 8x4 regs", false, shape<Shape<64, 128, 8, 16>, false>(64)},
           {"q128 8x4 u1", false, shape<Shape<64, 128, 8, 16, 1>, true>(64)},
           {"q64 4x4", false, shape<Shape<64, 64, 4, 16>, true>(64)},
           {"q64 8x4", false, shape<Shape<64, 64, 8, 16>, true>(64)},
           {"q128 4x8", false, shape<Shape<64, 128, 4, 8>, true>(64)},
           {"q128 8x8", false, shape<Shape<64, 128, 8, 8>, true>(64)},
           {"q256 8x8", false, shape<Shape<64, 256, 8, 8>, true>(64)},
           {"q256 8x8 u4", false, shape<Shape<64, 256, 8, 8, 4>, true>(64)},
           {"q256 8x8 u2", false, shape<Shape<64, 256, 8, 8, 2>, true>(64)},
           {"q256 8x8 u1", false, shape<Shape<64, 256, 8, 8, 1>, true>(64)},
           {"q256 8x8 u1 regs", false,
            shape<Shape<64, 256, 8, 8, 1>, false>(64)},
           {"q256 8x8 u1 in order", false,
            in_order<Shape<64, 256, 8, 8, 1>>(64)},
       }},
      {"f32 d32", 32, false, {
           {"32-row block", false, earlier<float>(32)},
           {"kernel", false, kernel(32, 0)},
           {"kernel, q 4 bytes off", true, kernel(32, 0)},
           {"q64 4x8", false, shape<Shape<32, 64, 4, 8>, true>(32)},
           {"q128 4x8", false, shape<Shape<32, 128, 4, 8>, true>(32)},
           {"q256 8x8", false, shape<Shape<32, 256, 8, 8>, true>(32)},
       }},
      {"f32 d128", 128, false, {
           {"32-row block", false, earlier<float>(128)},
           {"kernel", false, kernel(128, 0)},
           {"kernel, q 4 bytes off", true, kernel(128, 0)},
           {"q64 4x4 u1", false, shape<Shape<128, 64, 4, 16, 1>, true>(128)},
           {"q32 4x4", false, shape<Shape<128, 32, 4, 16>, true>(128)},
           {"q64 4x8", false, shape<Shape<128, 64, 4, 8>, true>(128)},
       }},
      {"bf16 d32", 32, true, {
           {"32-row block", false, earlier<__nv_bfloat16>(32)},
           {"kernel", false, kernel(32, 1)},
       }},
      {"bf16 d64", 64, true, {
           {"32-row block", false, earlier<__nv_bfloat16>(64)},
           {"kernel", false, kernel(64, 1)},
           {"kernel, q 4 bytes off", true, kernel(64, 1)},
       }},
      {"bf16 d128", 128, true, {
           {"32-row block", false, earlier<__nv_bfloat16>(128)},
           {"kernel", false, kernel(128, 1)},
       }},
  };
  for (const Case& c : cases) run_case(c);
  return 0;
}
