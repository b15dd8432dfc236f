// flash_decode: attention of a few query rows over a long kv cache, in
// float32 or bfloat16 (float32 arithmetic throughout), for the shapes where
// a kv group's query rows are few: g = H / Hkv query heads times Sq rows,
// R = g Sq <= 8 (`flash_attention.route` is "decode").  q [B, H, Sq, d],
// k and v [B, Hkv, Skv, d], out [B, H, Sq, d] in q's dtype; the causal
// mask is top-left (row i sees keys 0 .. i).
//
// Split-kv in two kernels launched by one C call.  The first gives each
// warp one split of `split` keys of one (b, kv head), and all R rows of
// the kv group: each K and V byte is read from device memory once, not g
// times.  A lane copies 16 bytes of a key row at a time (L lanes a row, so
// a warp copies 32 / L rows an instruction, coalesced) with cp.async into
// its own slots of a ring of 3 tiles in shared memory, so that two tiles
// are in flight while one is used, without holding them in registers; it
// holds q's matching 16 bytes of each of the R rows in registers, and the
// row's L lanes sum their partial dot products with __shfl_xor_sync.
// Each lane keeps an online softmax (m, l, acc) over the keys of its row
// slot, with m shared by the warp; at the end of the split the warp sums l and acc across its
// row slots and writes (m, l, acc) of each row to a float32 scratch
// buffer that the wrapper allocates.  The second kernel merges a row's
// splits in order: M = max m, l = sum l e^(m - M), acc = sum acc e^(m - M),
// out = acc / max(l, 1e-30); when `lse` is not null it also writes the
// row's logsumexp, M + ln max(l, 1e-30), to float32 lse [B, H, Sq] (the
// trainable attention's backward reads it), and a null `lse` leaves the
// rest as it was, bit for bit.  Masked scores are -1e30, never -inf: a split
// that the causal mask hides from a row keeps m = -1e30 and weighs
// e^(-1e30 - M) = 0 in the merge, since split 0 holds key 0, which every
// row sees.
//
// Replaces: the TPU kernel src/repro/kernels/flash_attention.py:34
// (`_kernel`, called through `flash_attention`,
// src/repro/kernels/flash_attention.py:84), for decode-shaped calls.
//
// Bound on the H100: bytes.  Decode at B = 32, Hkv = 8, Skv = 4096,
// d = 64 reads 268 MB of bfloat16 K and V (537 MB in float32): 0.080 ms
// (0.160) at 3.35 TB/s, against 1.1e9 flops.  The design keeps every K/V
// load 16 bytes wide and coalesced, reads each byte once for the whole kv
// group, and fills the card in one wave: 4 blocks of 4 warps fit an SM
// (48 KB of ring and at most 128 registers a thread for R <= 4), and the
// wrapper picks `split` so that about 132 x 16 = 2112 warps run (B Hkv
// Skv / split); the merge reads
// B Hkv (Skv / split) R (d + 2) floats, a few MB.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4, kThreads = 32 * kWarps;
constexpr int kNI = 4;                  // 16-byte chunks a lane, K and V
constexpr int kStages = 3;              // tiles in the ring a warp
constexpr int kRingBytes = kWarps * kStages * 2 * kNI * 32 * 16;   // 48 KB
constexpr float kMasked = -1e30f;

// 16 bytes global -> shared; zero-filled when !pred (src is then unread)
__device__ __forceinline__ void cp_async16(uint4* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 16 bytes of T as float32: 4 floats, or 8 widened bfloat16s
template <typename T>
__device__ __forceinline__ void unpack(const uint4& v, float* out) {
  if constexpr (sizeof(T) == 4) {
    out[0] = __uint_as_float(v.x); out[1] = __uint_as_float(v.y);
    out[2] = __uint_as_float(v.z); out[3] = __uint_as_float(v.w);
  } else {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
}
__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// T: the dtype; DP: d padded to 32, 64 or 128; RMAX: rows held (>= R)
template <typename T, int DP, int RMAX>
__global__ void __launch_bounds__(kThreads, RMAX <= 4 ? 4 : 2)
    flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                              const T* __restrict__ v,
                              float* __restrict__ part_m,
                              float* __restrict__ part_l,
                              float* __restrict__ part_acc, int H, int Hkv,
                              int Sq, int Skv, int d, int causal, float scale,
                              int split, int nsplit) {
  extern __shared__ uint4 smem[];
  constexpr int kEPV = 16 / sizeof(T);          // elements a 16-byte load
  constexpr int kL = DP / kEPV;                 // lanes a key row
  constexpr int kKPI = 32 / kL;                 // keys a warp-wide load
  constexpr int kKT = kNI * kKPI;               // keys a tile
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int nsb = (nsplit + kWarps - 1) / kWarps;
  const int bg = blockIdx.x / nsb;              // b * Hkv + kv head
  const int sp = (blockIdx.x % nsb) * kWarps + warp;
  if (sp >= nsplit) return;
  const int g = H / Hkv, R = g * Sq;
  const int b = bg / Hkv, hk = bg % Hkv;
  const int kg = lane / kL, col = (lane % kL) * kEPV;
  const bool colok = col < d;                   // d % kEPV == 0

  float qv[RMAX][kEPV];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    const int h = hk * g + r / Sq, i = r % Sq;
    if (r < R && colok) {
      unpack<T>(*reinterpret_cast<const uint4*>(
                    q + ((size_t)(b * H + h) * Sq + i) * d + col),
                qv[r]);
    } else {
#pragma unroll
      for (int e = 0; e < kEPV; ++e) qv[r][e] = 0.0f;
    }
  }
  const T* kb = k + (size_t)bg * Skv * d + col;
  const T* vb = v + (size_t)bg * Skv * d + col;
  const int ks = sp * split, ke = min(ks + split, Skv);

  float m[RMAX], l[RMAX], acc[RMAX][kEPV];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    m[r] = kMasked;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < kEPV; ++e) acc[r][e] = 0.0f;
  }
  // a ring of kStages tiles in shared memory: lane `lane` copies its own
  // 16-byte chunks and reads back only those, so cp.async's per-thread
  // wait_group is all the ordering needed
  const int ntile = (ke - ks + kKT - 1) / kKT;
  uint4* ring = smem + (size_t)warp * kStages * 2 * kNI * 32 + lane;
  auto issue = [&](int tile) {
    uint4* st = ring + (tile % kStages) * 2 * kNI * 32;
#pragma unroll
    for (int i = 0; i < kNI; ++i) {
      const int key = ks + tile * kKT + i * kKPI + kg;
      const bool in = key < ke && colok;
      const size_t off = in ? (size_t)key * d : 0;
      cp_async16(st + i * 32, kb + off, in);
      cp_async16(st + (kNI + i) * 32, vb + off, in);
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntile) issue(t);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  for (int t = 0; t < ntile; ++t) {
    if (t + kStages - 1 < ntile) issue(t + kStages - 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1) : "memory");
    const uint4* st = ring + (t % kStages) * 2 * kNI * 32;
    const int k0 = ks + t * kKT;
    float s[RMAX][kNI];
#pragma unroll
    for (int i = 0; i < kNI; ++i) {
      float kf[kEPV];
      unpack<T>(st[i * 32], kf);
      const int key = k0 + i * kKPI + kg;
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r >= R) break;                      // uniform across the warp
        float part = 0.0f;
#pragma unroll
        for (int e = 0; e < kEPV; ++e) part = fmaf(qv[r][e], kf[e], part);
#pragma unroll
        for (int off = 1; off < kL; off <<= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        s[r][i] = (key < ke && (!causal || r % Sq >= key)) ? part * scale
                                                           : kMasked;
      }
    }
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r >= R) break;
      float mx = kMasked;
#pragma unroll
      for (int i = 0; i < kNI; ++i) mx = fmaxf(mx, s[r][i]);
#pragma unroll
      for (int off = kL; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < kEPV; ++e) acc[r][e] *= corr;
#pragma unroll
      for (int i = 0; i < kNI; ++i) {
        s[r][i] = expf(s[r][i] - m_new);        // p
        l[r] += s[r][i];
      }
    }
#pragma unroll
    for (int i = 0; i < kNI; ++i) {
      float vf[kEPV];
      unpack<T>(st[(kNI + i) * 32], vf);
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r >= R) break;
#pragma unroll
        for (int e = 0; e < kEPV; ++e)
          acc[r][e] = fmaf(s[r][i], vf[e], acc[r][e]);
      }
    }
  }
  // sum the row slots (lanes with the same column, other keys)
  const size_t base = ((size_t)bg * nsplit + sp) * R;
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r >= R) break;
#pragma unroll
    for (int off = kL; off < 32; off <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
#pragma unroll
      for (int e = 0; e < kEPV; ++e)
        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
    }
    if (kg == 0 && colok) {
#pragma unroll
      for (int e = 0; e < kEPV; ++e)
        part_acc[(base + r) * d + col + e] = acc[r][e];
    }
    if (lane == 0) {
      part_m[base + r] = m[r];
      part_l[base + r] = l[r];
    }
  }
}

// one block a (b, kv head, row): thread c merges column c of the splits
template <typename T>
__global__ void flash_decode_merge_kernel(const float* __restrict__ part_m,
                                          const float* __restrict__ part_l,
                                          const float* __restrict__ part_acc,
                                          T* __restrict__ o,
                                          float* __restrict__ lse, int H,
                                          int Hkv, int Sq, int d,
                                          int nsplit) {
  const int g = H / Hkv, R = g * Sq;
  const int r = blockIdx.x % R, bg = blockIdx.x / R;
  const int b = bg / Hkv, hk = bg % Hkv;
  const int h = hk * g + r / Sq, i = r % Sq;
  const size_t row = (size_t)bg * nsplit * R + r;     // split 0's entry
  float mx = kMasked;
  for (int s = 0; s < nsplit; ++s) mx = fmaxf(mx, part_m[row + (size_t)s * R]);
  T* out = o + ((size_t)(b * H + h) * Sq + i) * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float l = 0.0f, acc = 0.0f;
    for (int s = 0; s < nsplit; ++s) {
      const size_t at = row + (size_t)s * R;
      const float w = expf(part_m[at] - mx);
      l = fmaf(part_l[at], w, l);
      acc = fmaf(part_acc[at * d + c], w, acc);
    }
    from_f32(acc / fmaxf(l, 1e-30f), &out[c]);
    if (lse != nullptr && c == 0)     // every column sums the same l
      lse[(size_t)(b * H + h) * Sq + i] = mx + logf(fmaxf(l, 1e-30f));
  }
}

template <typename T, int DP, int RMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, float* pm, float* pl, float* pa, int B, int H,
                   int Hkv, int Sq, int Skv, int d, int causal, float scale,
                   int split, int nsplit, cudaStream_t stream) {
  const long long blocks =
      (long long)B * Hkv * ((nsplit + kWarps - 1) / kWarps);
  const long long rows = (long long)B * Hkv * (H / Hkv) * Sq;
  if (blocks > 0x7fffffffLL || rows > 0x7fffffffLL)
    return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      flash_decode_split_kernel<T, DP, RMAX>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kRingBytes);
  if (err != cudaSuccess) return err;
  flash_decode_split_kernel<T, DP, RMAX><<<(unsigned)blocks, kThreads,
                                           kRingBytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, pm, pl, pa, H, Hkv, Sq, Skv, d,
      causal, scale, split, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_decode_merge_kernel<T><<<(unsigned)rows, d <= 64 ? 64 : 128, 0,
                                 stream>>>(pm, pl, pa, (T*)o, lse, H, Hkv,
                                           Sq, d, nsplit);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_r(const void* q, const void* k, const void* v, void* o,
                     float* lse, float* pm, float* pl, float* pa, int B,
                     int H, int Hkv, int Sq, int Skv, int d, int causal,
                     float scale, int split, int nsplit, cudaStream_t s) {
  const int R = H / Hkv * Sq;
  if (R <= 4)
    return launch<T, DP, 4>(q, k, v, o, lse, pm, pl, pa, B, H, Hkv, Sq, Skv,
                            d, causal, scale, split, nsplit, s);
  if (R <= 8)
    return launch<T, DP, 8>(q, k, v, o, lse, pm, pl, pa, B, H, Hkv, Sq, Skv,
                            d, causal, scale, split, nsplit, s);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     float* lse, float* pm, float* pl, float* pa, int B,
                     int H, int Hkv, int Sq, int Skv, int d, int causal,
                     float scale, int split, int nsplit, cudaStream_t s) {
  if (d <= 32)
    return launch_r<T, 32>(q, k, v, o, lse, pm, pl, pa, B, H, Hkv, Sq, Skv,
                           d, causal, scale, split, nsplit, s);
  if (d <= 64)
    return launch_r<T, 64>(q, k, v, o, lse, pm, pl, pa, B, H, Hkv, Sq, Skv,
                           d, causal, scale, split, nsplit, s);
  if (d <= 128)
    return launch_r<T, 128>(q, k, v, o, lse, pm, pl, pa, B, H, Hkv, Sq, Skv,
                            d, causal, scale, split, nsplit, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// bf16: 0 when q, k, v and o are float32, 1 when they are bfloat16.
// part_m, part_l: [B Hkv, nsplit, R] float32; part_acc: [B Hkv, nsplit, R,
// d]; nsplit = ceil(Skv / split), split a multiple of 32.  d * (element
// size) % 16 == 0, q, k, v 16-byte aligned, R = (H / Hkv) Sq <= 8 (the
// wrapper's route checks; refused here as well).  `tile` is the keys a
// warp walks a step as the caller's plain version walks them
// (`flash_attention.decode_tile`): refused unless it is this kernel's
// kNI * 32 / L, so that the two cannot sum in different orders.  lse:
// null, or float32 [B, H, Sq] for each row's logsumexp.
extern "C" int launch_flash_decode(const void* q, const void* k,
                                   const void* v, void* o, void* part_m,
                                   void* part_l, void* part_acc, int B, int H,
                                   int Hkv, int Sq, int Skv, int d, int causal,
                                   float scale, int split, int nsplit,
                                   int tile, int bf16, void* lse,
                                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v);
  const int size = bf16 ? 2 : 4;
  const int dp = d <= 32 ? 32 : d <= 64 ? 64 : 128;
  if (Hkv <= 0 || H % Hkv || (d * size) % 16 || any % 16 || split % 32 ||
      split <= 0 || nsplit != (Skv + split - 1) / split ||
      tile != kNI * 32 / (dp * size / 16))
    return (int)cudaErrorInvalidValue;
  float *pm = (float*)part_m, *pl = (float*)part_l, *pa = (float*)part_acc;
  float* ls = (float*)lse;
  return (int)(bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, ls, pm, pl, pa, B,
                                              H, Hkv, Sq, Skv, d, causal,
                                              scale, split, nsplit, s)
                    : launch_d<float>(q, k, v, o, ls, pm, pl, pa, B, H, Hkv,
                                      Sq, Skv, d, causal, scale, split,
                                      nsplit, s));
}
