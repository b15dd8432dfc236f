// flash_attention: causal or non-causal GQA attention with an online
// softmax, q [B, H, Sq, d], k and v [B, Hkv, Skv, d], out [B, H, Sq, d] in
// q's dtype (float32, or bfloat16 rounded to nearest even); query head h
// reads kv head h / (H / Hkv).  Everything is computed in float32: q, k,
// v, the scores, p and the accumulator.
//
// One block of 8 warps handles one (b, h, tile of 32 queries); each warp
// owns 4 query rows.  The block stages its q tile once, then walks the kv
// axis in tiles of 64 keys, each staged in __shared__ memory as float32
// (rows padded to d + 4 floats, so that lanes reading different keys hit
// different banks).  For each tile a lane scores two keys (k0 + lane and
// k0 + lane + 32) against the warp's 4 rows, with q read from shared
// memory as a broadcast; a __shfl_xor_sync butterfly takes each row's tile
// maximum and sum of p.  The running maximum m, the denominator l and the
// accumulator live in float32 registers: for the product with v, lane l
// holds output columns l, l + 32, ... of the warp's 4 rows, and reads the
// tile's p from shared memory, 4 rows in one 16-byte broadcast per key.
// Masked scores are -1e30, not -inf: a tile's first key is never masked
// for a live row (key 0 is in the first tile), so m is finite and no
// (-inf) - (-inf) arises.  The causal mask is top-left, qpos >= kpos with
// both counted from 0, and a kv tile wholly above the tile's diagonal is
// skipped.  The output is acc / max(l, 1e-30).  Ragged edges (Sq or Skv
// not a multiple of the tiles, d below its padded width of 32, 64 or 128)
// are zero-filled on load and masked on store.
//
// Replaces: the TPU kernel src/repro/kernels/flash_attention.py:34
// (`_kernel`, called through `flash_attention`,
// src/repro/kernels/flash_attention.py:84).
//
// Bound on the H100: prefill by operations, decode by bytes.  Causal
// prefill at B = 2, H = 32, S = 4096, d = 64 does 4 d flops for each of
// B H S (S + 1) / 2 pairs, 1.37e11: 0.139 ms at the tensor cores' 989
// TFLOP/s in bfloat16 (2.05 ms at 67 TFLOP/s in float32); its 5.4e8 exp
// take 0.128 ms on the special-function units.  Decode (Sq = 1, B = 32,
// Skv = 4096) reads 268 MB of bfloat16 K and V: 0.080 ms at 3.35 TB/s.
// The design is the online softmax of FlashAttention on the CUDA cores:
// no score matrix reaches device memory, a block reads each K and V tile
// once for its 32 rows, and the float32 arithmetic the reference asks for
// runs at the CUDA cores' rate, so it does not reach the bfloat16 bound;
// tensor cores (mma / wgmma) are a later redesign.  A decode block has one
// live row: the warps without one skip the arithmetic and only load.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

constexpr int kWarps = 8, kRows = 4;            // rows a warp owns
constexpr int kQT = kWarps * kRows;             // queries a block
constexpr int kKT = 64;                         // keys a tile
constexpr int kThreads = 32 * kWarps;
constexpr float kMasked = -1e30f;

template <int DP>
constexpr size_t smem_bytes() {
  // q tile, K tile (padded rows), V tile, p of each warp (float4 a key)
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

// DP: d padded to 32, 64 or 128
template <typename T, int DP>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int H, int Hkv, int Sq, int Skv, int d,
                           int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // [kQT][DP]
  float* ks = qs + kQT * DP;                    // [kKT][DP + 4]
  float* vs = ks + kKT * (DP + 4);              // [kKT][DP]
  float4* ps = reinterpret_cast<float4*>(vs + kKT * DP);   // [kWarps][kKT]
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
  const int row0 = q0 + warp * kRows;           // the warp's first query
  const bool live = row0 < Sq;
  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kMasked;
    l[r] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.0f;
  }
  // keys at or past kend are masked for every row of the tile
  const int kend = causal ? min(Skv, q0 + kQT) : Skv;
  for (int k0 = 0; k0 < kend; k0 += kKT) {
    __syncthreads();          // the last tile's readers are done
    for (int i = tid; i < kKT * DP; i += kThreads) {
      const int r = i / DP, c = i % DP;
      const bool in = k0 + r < Skv && c < d;
      const size_t g = (size_t)(k0 + r) * d + c;
      ks[r * kKS + c] = in ? to_f32(kb[g]) : 0.0f;
      vs[i] = in ? to_f32(vb[g]) : 0.0f;
    }
    __syncthreads();
    if (!live) continue;
    // scores of keys k0 + lane and k0 + lane + 32 for the warp's rows
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
    const int jn = min(kKT, kend - k0);          // keys past jn have p = 0
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
    __syncwarp();             // p is read before the next tile rewrites it
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
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int B, int H, int Hkv, int Sq, int Skv, int d, int causal,
                   float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<DP>();
  // above 48 KB a block's dynamic shared memory needs the opt-in
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((Sq + kQT - 1) / kQT);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  flash_attention_kernel<T, DP><<<(unsigned)blocks, kThreads, bytes,
                                  stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, H, Hkv, Sq, Skv, d,
      causal, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int Hkv, int Sq, int Skv, int d,
                     int causal, float scale, cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, o, B, H, Hkv, Sq, Skv, d, causal, scale,
                         stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, B, H, Hkv, Sq, Skv, d, causal, scale,
                         stream);
  if (d <= 128)
    return launch<T, 128>(q, k, v, o, B, H, Hkv, Sq, Skv, d, causal, scale,
                          stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// bf16: 0 when q, k, v and o are float32, 1 when they are bfloat16.
// 1 <= d <= 128, H a multiple of Hkv (the wrapper checks both).
extern "C" int launch_flash_attention(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Hkv, int Sq, int Skv, int d,
                                      int causal, float scale, int bf16,
                                      void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Skv,
                                              d, causal, scale, s)
                    : launch_d<float>(q, k, v, o, B, H, Hkv, Sq, Skv, d,
                                      causal, scale, s));
}
