// Times src/repro_torch/csrc/flash_attention_tc.cu's bfloat16 prefill
// (FlashAttention-3's design: TMA, a producer warpgroup, wgmma) beside the
// kernel it replaced and the FA3 steps tried on the way, on one CUDA card,
// so that the launcher's choice rests on a measurement.  Five causal
// shapes: granite-3-2b's attention at train_4k (B 2, H 32, Hkv 8,
// S 4,096, d 64; chip_smoke.py's hot path), qwen2-0.5b's training step
// (B 4, H 16, S 1,024, d 64, with lse), deepseek-moe-16b's prefill (H 16,
// S 1,024, d 128), zamba2-7b's shared attention (H 32, S 1,024, d 112,
// padded to 128) and a long prompt (B 1, H 32, Hkv 8, S 32,768, d 64).
// In each:
//   mma.sync    the earlier kernel, as it was (FlashAttention-2 on
//               mma.sync.m16n8k16, ldmatrix and cp.async double buffering,
//               4 warps a CTA; 64-key tiles);
//   shipped     the kernel through its launcher, as the port calls it;
//   nc<N> st<S> [pp] [ov]
//               the kernel's template with N consumer warpgroups (64 N
//               query rows a CTA; nc1 runs two CTAs an SM), S stages of K
//               and V in the producer's ring, and FA3's two scheduling
//               steps: pp, ping-pong (named barriers give the two
//               consumers turns at the tensor cores, so one's softmax runs
//               under the other's products), and ov, the intra-warpgroup
//               overlap (tile i's q k^T issued with tile i - 1's p v, and
//               tile i's softmax run while that p v does).
// Every wgmma variant must equal the shipped kernel's output (and lse) bit
// for bit: they differ in schedule only.  The mma.sync kernel walks
// 64-key tiles, so it is held to the shipped one within (rtol, atol) =
// (2e-2, 6e-3), twice flash_attention.PLAIN_TOL["tc", bfloat16] (each
// kernel lies within PLAIN_TOL of its own plain version).  Each variant's
// time is the median of 25 CUDA-event runs after 2 warm-ups, each run
// behind a spin on the card that covers the host's enqueue (the launcher
// encodes three tensor maps a call); three turns, then the median of the
// three medians, beside the bound: the larger of 4 d flops a (query, key)
// pair the mask keeps at 989 TFLOP/s and the bytes of q, k, v, o (and lse)
// at 3.35 TB/s.  tools/flash_attention_tc_library.py times
// scaled_dot_product_attention at the same shapes.  Build and run from
// the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/flash_attention_tc_variants \
//     tools/flash_attention_tc_variants.cu && build/flash_attention_tc_variants
#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <vector>

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/flash_attention_tc.cu"

// the library takes this from csrc/matmul_tc.cu; the tool's own copy
PFN_cuTensorMapEncodeTiled_v12000 cupbop_tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

namespace old {

// the kernel this redesign replaced, as it was, and its launcher's choice
// of the padded width

constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kKT = 64;                 // keys a tile
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !pred (src is then unread)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (2^-1e30 is 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// rows [r0, r0 + ROWS) of a [nrows, d] bf16 matrix into a [ROWS][DP + 8]
// tile
template <int DP, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const __nv_bfloat16* src, int r0,
                                          int nrows, int d, int tid) {
  constexpr int kChunks = DP / 8;       // 16-byte chunks a row
#pragma unroll
  for (int i = tid; i < ROWS * kChunks; i += kThreads) {
    const int r = i / kChunks, col = (i % kChunks) * 8;
    const bool in = r0 + r < nrows && col < d;
    const __nv_bfloat16* g = in ? src + (size_t)(r0 + r) * d + col : src;
    cp_async16(tile + (r * (DP + 8) + col) * 2, g, in);
  }
}

// m16 tiles a warp: two where the registers allow, so that each K and V
// fragment read from shared memory feeds two mma
template <int DP>
__host__ __device__ constexpr int m_tiles() {
  return DP <= 64 ? 2 : 1;
}
template <int DP>
__host__ __device__ constexpr int q_tile() {
  return 16 * m_tiles<DP>() * kWarps;
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    flash_attention_tc_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              __nv_bfloat16* __restrict__ o,
                              float* __restrict__ lse, int BH, int H,
                              int Hkv, int Sq, int Skv, int d, int causal,
                              float scale_log2) {
  constexpr int kMT = m_tiles<DP>(), kQT = q_tile<DP>();
  constexpr int kWR = 16 * kMT;                   // rows a warp
  constexpr int kRow = DP + 8;                    // padded row (elements)
  constexpr int kTile = kKT * kRow * 2;           // bytes a kv tile
  constexpr int kKS = DP / 16;                    // k16 slices of d
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t qs = smem_u32(smem);
  const uint32_t ks = qs + kQT * kRow * 2;        // 2 buffers
  const uint32_t vs = ks + 2 * kTile;             // 2 buffers

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nq = (Sq + kQT - 1) / kQT;
  // heaviest (last) query tiles first: under the causal mask they walk
  // the most kv tiles
  const int qt = nq - 1 - (int)(blockIdx.x / BH), bh = blockIdx.x % BH;
  const int h = bh % H, b = bh / H, hk = h / (H / Hkv);
  const int q0 = qt * kQT;
  const __nv_bfloat16* qb = q + (size_t)(b * H + h) * Sq * d;
  const __nv_bfloat16* kb = k + (size_t)(b * Hkv + hk) * Skv * d;
  const __nv_bfloat16* vb = v + (size_t)(b * Hkv + hk) * Skv * d;
  __nv_bfloat16* ob = o + (size_t)(b * H + h) * Sq * d;

  const int kend = causal ? min(Skv, q0 + kQT) : Skv;
  const int nt = (kend + kKT - 1) / kKT;

  load_tile<DP, kQT>(qs, qb, q0, Sq, d, tid);
  load_tile<DP, kKT>(ks, kb, 0, Skv, d, tid);
  load_tile<DP, kKT>(vs, vb, 0, Skv, d, tid);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  const int g = lane / 4, t = lane % 4;           // the fragments' lane split
  const int w0 = q0 + warp * kWR;                 // the warp's first row
  uint32_t qf[kMT][kKS][4];
  float acc[kMT][DP / 8][4];
  float m[kMT][2], l[kMT][2];
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
      acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.0f;
    m[mt][0] = m[mt][1] = kMasked;
    l[mt][0] = l[mt][1] = 0.0f;
  }

  for (int it = 0; it < nt; ++it) {
    const int buf = it & 1, k0 = it * kKT;
    if (it + 1 < nt) {     // the next tile loads while this one is used
      load_tile<DP, kKT>(ks + (buf ^ 1) * kTile, kb, k0 + kKT, Skv, d, tid);
      load_tile<DP, kKT>(vs + (buf ^ 1) * kTile, vb, k0 + kKT, Skv, d, tid);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
    if (it == 0) {
      // A fragments: matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15)
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int r = warp * kWR + mt * 16 + (lane % 8) +
                      ((lane / 8) & 1) * 8;
#pragma unroll
        for (int kk = 0; kk < kKS; ++kk)
          ldsm_x4(qs + (r * kRow + kk * 16 + (lane / 16) * 8) * 2,
                  qf[mt][kk]);
      }
    }
    const uint32_t kt = ks + buf * kTile, vt = vs + buf * kTile;
    // a warp whose rows all lie above this tile's keys, or past Sq, has
    // nothing to add; it still takes part in the block's barriers
    if (w0 < Sq && !(causal && k0 > w0 + kWR - 1)) {
      // ---- S = q k^T: n-tile j holds keys 8 j .. 8 j + 7 --------------
      float s[kMT][8][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.0f;
#pragma unroll
      for (int kk = 0; kk < kKS; ++kk) {
#pragma unroll
        for (int p = 0; p < 4; ++p) {
          // keys 16 p + (0-7 | 8-15) x cols (0-7 | 8-15) of slice kk
          const int key = 16 * p + (lane % 8) + (lane / 16) * 8;
          uint32_t bk[4];
          ldsm_x4(kt + (key * kRow + kk * 16 + ((lane / 8) & 1) * 8) * 2,
                  bk);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_bf16(s[mt][2 * p], qf[mt][kk], bk[0], bk[1]);
            mma_bf16(s[mt][2 * p + 1], qf[mt][kk], bk[2], bk[3]);
          }
        }
      }
      // ---- scale (log2 domain), mask, online softmax --------------------
      const bool edge = k0 + kKT > Skv || (causal && k0 + kKT - 1 > w0);
      uint32_t pa[kMT][4][4];     // p as bf16 A fragments, k16 slice kk
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const int row0 = w0 + mt * 16 + g;        // this lane's rows: +0, +8
        float mx[2] = {kMasked, kMasked};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = s[mt][j][e] * scale_log2;
            if (edge) {
              const int key = k0 + 8 * j + 2 * t + (e & 1);
              const int qpos = row0 + (e >> 1) * 8;
              if (key >= Skv || (causal && qpos < key)) x = kMasked;
            }
            s[mt][j][e] = x;
            mx[e >> 1] = fmaxf(mx[e >> 1], x);
          }
        }
        float corr[2];
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
          mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
          const float m_new = fmaxf(m[mt][hf], mx[hf]);
          corr[hf] = exp2_approx(m[mt][hf] - m_new);
          m[mt][hf] = m_new;
          l[mt][hf] *= corr[hf];  // this lane's share; the quad sums later
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float p0 = exp2_approx(s[mt][j][0] - m[mt][0]);
          const float p1 = exp2_approx(s[mt][j][1] - m[mt][0]);
          const float p2 = exp2_approx(s[mt][j][2] - m[mt][1]);
          const float p3 = exp2_approx(s[mt][j][3] - m[mt][1]);
          l[mt][0] += p0 + p1;
          l[mt][1] += p2 + p3;
          // C layout (row g | g + 8, keys 2t, 2t + 1) -> A layout: n-tile
          // 2kk gives a0, a1, n-tile 2kk + 1 gives a2, a3
          pa[mt][j / 2][(j & 1) * 2] = pack_bf16(p0, p1);
          pa[mt][j / 2][(j & 1) * 2 + 1] = pack_bf16(p2, p3);
        }
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          acc[mt][j][0] *= corr[0];
          acc[mt][j][1] *= corr[0];
          acc[mt][j][2] *= corr[1];
          acc[mt][j][3] *= corr[1];
        }
      }
      // ---- acc += p v: V by ldmatrix.trans --------------------------------
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const int key = 16 * kk + (lane % 8) + ((lane / 8) & 1) * 8;
#pragma unroll
        for (int qq = 0; qq < DP / 16; ++qq) {
          uint32_t bv[4];
          ldsm_x4_t(vt + (key * kRow + 16 * qq + (lane / 16) * 8) * 2, bv);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            mma_bf16(acc[mt][2 * qq], pa[mt][kk], bv[0], bv[1]);
            mma_bf16(acc[mt][2 * qq + 1], pa[mt][kk], bv[2], bv[3]);
          }
        }
      }
    }
    __syncthreads();            // this buffer is refilled two tiles on
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");   // Skv = 0

#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lt = l[mt][hf];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int qpos = w0 + mt * 16 + g + 8 * hf;
      if (qpos >= Sq) continue;
      if (lse != nullptr && t == 0)      // m is the quad's, lt its sum
        lse[(size_t)(b * H + h) * Sq + qpos] =
            m[mt][hf] * kLn2 + logf(fmaxf(lt, 1e-30f));
      lt = 1.0f / fmaxf(lt, 1e-30f);
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t;        // d % 8 == 0: pairs are whole
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)qpos * d + col) =
              __floats2bfloat162_rn(acc[mt][j][2 * hf] * lt,
                                    acc[mt][j][2 * hf + 1] * lt);
      }
    }
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Hkv, int Sq, int Skv, int d,
                   int causal, float scale, cudaStream_t stream) {
  constexpr int kQT = q_tile<DP>();
  constexpr int bytes = (kQT + 4 * kKT) * (DP + 8) * 2;   // q, 2 K, 2 V
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_tc_kernel<DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((Sq + kQT - 1) / kQT);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_attention_tc_kernel<DP><<<(unsigned)blocks, kThreads, bytes,
                                  stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, lse, B * H, H, Hkv, Sq,
      Skv, d, causal, scale * kLog2e);
  return cudaGetLastError();
}


cudaError_t launch_any(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int Hkv, int Sq, int Skv,
                       int d, int causal, float scale, cudaStream_t s) {
  if (d <= 32) return launch<32>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, d,
                                 causal, scale, s);
  if (d <= 64) return launch<64>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, d,
                                 causal, scale, s);
  return launch<128>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, d, causal, scale,
                     s);
}

}  // namespace old

#define CHECK(x)                                                         \
  do {                                                                   \
    cudaError_t e_ = (x);                                                \
    if (e_ != cudaSuccess) {                                             \
      fprintf(stderr, "%s:%d %s: %s\n", __FILE__, __LINE__, #x,          \
              cudaGetErrorString(e_));                                   \
      exit(1);                                                           \
    }                                                                    \
  } while (0)

using Launch = std::function<cudaError_t(const void*, const void*,
                                         const void*, void*, float*, int,
                                         int, int, int, int, int, int, float,
                                         cudaStream_t)>;

struct Variant {
  std::string name;
  int q_tile;          // query rows a CTA
  Launch fn;
};

template <int DP, int NC, int ST, bool PP, bool OV>
Variant wgmma_variant() {
  std::string name = "nc" + std::to_string(NC) + " st" + std::to_string(ST);
  if (PP) name += " pp";
  if (OV) name += " ov";
  return {name, 64 * NC, flash_tc::launch<DP, NC, ST, PP, OV>};
}

template <int DP>
std::vector<Variant> variants();

// the design's first shape (nc2 st2), then the steps: stages, PP, OV,
// both, and three consumers or one (two CTAs an SM)
template <>
std::vector<Variant> variants<64>() {
  return {wgmma_variant<64, 2, 2, false, false>(),
          wgmma_variant<64, 2, 3, false, false>(),
          wgmma_variant<64, 2, 2, true, false>(),
          wgmma_variant<64, 2, 3, false, true>(),
          wgmma_variant<64, 2, 3, true, true>(),
          wgmma_variant<64, 2, 4, true, true>(),
          wgmma_variant<64, 3, 2, false, false>(),
          wgmma_variant<64, 3, 2, true, true>(),
          wgmma_variant<64, 3, 3, true, true>(),
          wgmma_variant<64, 3, 4, true, true>(),
          wgmma_variant<64, 1, 2, false, false>()};
}

template <>
std::vector<Variant> variants<128>() {
  return {wgmma_variant<128, 2, 2, false, false>(),
          wgmma_variant<128, 2, 3, false, false>(),
          wgmma_variant<128, 2, 2, true, false>(),
          wgmma_variant<128, 2, 3, false, true>(),
          wgmma_variant<128, 2, 2, true, true>(),
          wgmma_variant<128, 2, 3, true, true>()};
}

// ~cycles of spin on the card, ahead of a timed run
__global__ void spin(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

struct Shape {
  const char* name;
  int B, H, Hkv, S, d;
  bool lse;
};

float median(std::vector<float> v) {
  std::sort(v.begin(), v.end());
  return v[v.size() / 2];
}

// median of 25 runs after 2 warm-ups, each behind a spin
float time_ms(const std::function<void()>& run) {
  std::vector<float> ts;
  cudaEvent_t a, b;
  CHECK(cudaEventCreate(&a));
  CHECK(cudaEventCreate(&b));
  for (int i = 0; i < 27; ++i) {
    spin<<<1, 1>>>(200000);
    CHECK(cudaEventRecord(a));
    run();
    CHECK(cudaEventRecord(b));
    CHECK(cudaEventSynchronize(b));
    float ms;
    CHECK(cudaEventElapsedTime(&ms, a, b));
    if (i >= 2) ts.push_back(ms);
  }
  CHECK(cudaEventDestroy(a));
  CHECK(cudaEventDestroy(b));
  return median(ts);
}

uint16_t to_bf16(float x) {          // round to nearest even
  uint32_t u;
  memcpy(&u, &x, 4);
  return (uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16);
}

float from_bf16(uint16_t h) {
  uint32_t u = (uint32_t)h << 16;
  float x;
  memcpy(&x, &u, 4);
  return x;
}

template <int DP>
void run_shape(const Shape& sh) {
  const int B = sh.B, H = sh.H, Hkv = sh.Hkv, S = sh.S, d = sh.d;
  const size_t nq = (size_t)B * H * S * d, nk = (size_t)B * Hkv * S * d;
  std::vector<uint16_t> hq(nq), hk(nk), hv(nk);
  uint64_t st = 12345;               // a fixed LCG: standard-ish normals
  auto draw = [&]() {
    float s = 0.0f;
    for (int i = 0; i < 4; ++i) {
      st = st * 6364136223846793005ull + 1442695040888963407ull;
      s += (float)((st >> 40) & 0xffffff) / 16777216.0f;
    }
    return (s - 2.0f) * 1.7320508f;
  };
  for (auto& x : hq) x = to_bf16(draw());
  for (auto& x : hk) x = to_bf16(draw());
  for (auto& x : hv) x = to_bf16(draw());
  void *q, *k, *v, *o, *o_ref, *o_old;
  float *lse = nullptr, *lse_ref = nullptr;
  CHECK(cudaMalloc(&q, nq * 2));
  CHECK(cudaMalloc(&k, nk * 2));
  CHECK(cudaMalloc(&v, nk * 2));
  CHECK(cudaMalloc(&o, nq * 2));
  CHECK(cudaMalloc(&o_ref, nq * 2));
  CHECK(cudaMalloc(&o_old, nq * 2));
  const size_t nl = (size_t)B * H * S;
  if (sh.lse) {
    CHECK(cudaMalloc(&lse, nl * 4));
    CHECK(cudaMalloc(&lse_ref, nl * 4));
  }
  CHECK(cudaMemcpy(q, hq.data(), nq * 2, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(k, hk.data(), nk * 2, cudaMemcpyHostToDevice));
  CHECK(cudaMemcpy(v, hv.data(), nk * 2, cudaMemcpyHostToDevice));
  const float scale = 1.0f / sqrtf((float)d);
  double pairs = 0;
  for (int i = 0; i < S; ++i) pairs += std::min(S, i + 1);
  const double flops = 4.0 * d * B * H * pairs;
  const double bytes = 2.0 * (2 * nq + 2 * nk) + (sh.lse ? 4.0 * nl : 0);
  const double bound =
      std::max(flops / 989e12, bytes / 3.35e12) * 1e3;
  const char* by = flops / 989e12 >= bytes / 3.35e12 ? "operations" : "bytes";

  std::vector<Variant> all = {
      {"mma.sync", DP <= 64 ? 128 : 64, old::launch_any},
      {"shipped", flash_tc::q_tile(d),
       [](const void* q, const void* k, const void* v, void* o, float* lse,
          int B, int H, int Hkv, int Sq, int Skv, int d, int causal,
          float scale, cudaStream_t s) {
         return (cudaError_t)launch_flash_attention_tc(
             q, k, v, o, B, H, Hkv, Sq, Skv, d, causal, scale, flash_tc::kBN,
             lse, s);
       }}};
  for (auto& x : variants<DP>()) all.push_back(x);

  // the shipped kernel's output, and the old kernel's
  CHECK(all[1].fn(q, k, v, o_ref, lse_ref, B, H, Hkv, S, S, d, 1, scale, 0));
  CHECK(all[0].fn(q, k, v, o_old, nullptr, B, H, Hkv, S, S, d, 1, scale, 0));
  CHECK(cudaDeviceSynchronize());
  std::vector<uint16_t> ref(nq), got(nq);
  std::vector<float> lref(sh.lse ? nl : 0), lgot(sh.lse ? nl : 0);
  CHECK(cudaMemcpy(ref.data(), o_ref, nq * 2, cudaMemcpyDeviceToHost));
  if (sh.lse)
    CHECK(cudaMemcpy(lref.data(), lse_ref, nl * 4, cudaMemcpyDeviceToHost));
  {
    CHECK(cudaMemcpy(got.data(), o_old, nq * 2, cudaMemcpyDeviceToHost));
    double worst = 0;
    bool ok = true;
    for (size_t i = 0; i < nq; ++i) {
      const double a = from_bf16(got[i]), w = from_bf16(ref[i]);
      worst = std::max(worst, std::fabs(a - w));
      if (!(std::fabs(a - w) <= 6e-3 + 2e-2 * std::fabs(w))) ok = false;
    }
    printf("check %s mma.sync: max_abs_diff=%.3g within (2e-2, 6e-3)=%s\n",
           sh.name, worst, ok ? "yes" : "NO");
    if (!ok) exit(1);
  }
  for (size_t vi = 2; vi < all.size(); ++vi) {
    CHECK(cudaMemset(o, 0, nq * 2));
    CHECK(all[vi].fn(q, k, v, o, lse, B, H, Hkv, S, S, d, 1, scale, 0));
    CHECK(cudaDeviceSynchronize());
    CHECK(cudaMemcpy(got.data(), o, nq * 2, cudaMemcpyDeviceToHost));
    bool eq = memcmp(got.data(), ref.data(), nq * 2) == 0;
    if (sh.lse) {
      CHECK(cudaMemcpy(lgot.data(), lse, nl * 4, cudaMemcpyDeviceToHost));
      eq = eq && memcmp(lgot.data(), lref.data(), nl * 4) == 0;
    }
    if (!eq) {
      printf("check %s %s: NOT bit for bit the shipped kernel\n", sh.name,
             all[vi].name.c_str());
      exit(1);
    }
  }
  printf("check %s: %zu wgmma variants bit for bit the shipped kernel\n",
         sh.name, all.size() - 2);

  const int turns = 3;
  std::vector<std::vector<float>> t(all.size());
  for (int turn = 0; turn < turns; ++turn)
    for (size_t vi = 0; vi < all.size(); ++vi) {
      t[vi].push_back(time_ms([&]() {
        CHECK(all[vi].fn(q, k, v, o, lse, B, H, Hkv, S, S, d, 1, scale, 0));
      }));
    }
  const float base = median(t[0]);
  for (size_t vi = 0; vi < all.size(); ++vi) {
    const float ms = median(t[vi]);
    printf("shape %s (B %d, H %d, Hkv %d, S %d, d %d%s) %-14s q_tile=%d "
           "ctas=%lld ms=%.5f turns=%.5f/%.5f/%.5f tflops=%.1f "
           "bound_ms=%.5f (%s) of_bound=%.3f vs_mma_sync=%.3f\n",
           sh.name, B, H, Hkv, S, d, sh.lse ? ", lse" : "",
           all[vi].name.c_str(), all[vi].q_tile,
           (long long)B * H * ((S + all[vi].q_tile - 1) / all[vi].q_tile), ms,
           t[vi][0], t[vi][1], t[vi][2], flops / ms * 1e-9, bound, by,
           bound / ms, ms / base);
  }
  fflush(stdout);
  for (void* p : {q, k, v, o, o_ref, o_old}) CHECK(cudaFree(p));
  if (sh.lse) {
    CHECK(cudaFree(lse));
    CHECK(cudaFree(lse_ref));
  }
}

int main() {
  cudaDeviceProp prop;
  CHECK(cudaGetDeviceProperties(&prop, 0));
  printf("card: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const Shape shapes[] = {
      {"hot", 2, 32, 8, 4096, 64, false},
      {"train", 4, 16, 16, 1024, 64, true},
      {"moe", 1, 16, 16, 1024, 128, false},
      {"zamba2", 1, 32, 32, 1024, 112, false},
      {"long", 1, 32, 8, 32768, 64, false}};
  for (const Shape& sh : shapes) {
    if (sh.d <= 64)
      run_shape<64>(sh);
    else
      run_shape<128>(sh);
  }
  return 0;
}
