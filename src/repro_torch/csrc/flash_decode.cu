// flash_decode: attention of a few query rows over a long kv cache, in
// float32 or bfloat16 (float32 arithmetic throughout), for the shapes where
// a kv group's query rows are few: g = H / Hkv query heads times Sq rows,
// R = g Sq <= 8 (`flash_attention.route` is "decode").  q [B, H, Sq, d],
// k and v [B, Hkv, Skv, d], out [B, H, Sq, d] in q's dtype; the causal
// mask is top-left (row i sees keys 0 .. i).  Row r of a group is head
// r / Sq of the group and query r % Sq: the group's R rows of q and of
// out are R contiguous rows of d.  Each K and V byte is read from device
// memory once for the whole kv group.  Masked scores are -1e30, never
// -inf; every row sees key 0, so every row's final max is a real score's.
// Each kv group's keys are cut into `parts` parts of `per` keys
// (`flash_attention.decode_split`, whose rule flash_decode_per below
// gives), merged in part order: M = max m, l = sum l e^(m - M), acc = sum
// acc e^(m - M), out = acc / max(l, 1e-30); when `lse` is not null the
// row's logsumexp M + ln max(l, 1e-30) goes to float32 lse [B, H, Sq]
// (the trainable attention's backward reads it), and a null `lse` changes
// nothing else.
//
// bfloat16: one launch, no scratch (flash_decode_mma_kernel).  Each kv
// group (b, kv head) gets a thread-block cluster of C = parts CTAs (1, 2,
// 4 or 8: C doubles while the B Hkv C CTAs stay under 132 and no rank
// would be left without keys); rank c takes keys [c per, min((c + 1)
// per, Skv)), `per` a whole number of tiles.  A CTA is kWarps warps; a
// tile is kWarps 16 keys, warp w taking keys [16 w, 16 (w + 1)) of every
// tile (`flash_attention.decode_tile`), and all R rows of the group.
// Each warp keeps a ring of kMmaStages stages of its own: its lane 0
// copies a tile's K and V by TMA from [B Hkv, Skv, d] tensor maps in
// boxes of 16 keys x 64 columns with 128-byte swizzle (zeros past Skv, so
// a ragged tile never reads the next group's rows, and past d) onto the
// stage's mbarrier, and refills the stage once the warp has read it, so
// no warp waits for another until the fold.  q k^T is mma.sync m16n8k16
// with the group's rows as a's rows 0 .. 7 (rows 8 .. 15 zero) over two
// n8 tiles of keys, K read by ldmatrix without bank conflicts; p v takes
// p from the score fragments as a, split into bfloat16 hi + lo so that p
// keeps about 16 bits: two products, v by ldmatrix.trans.  Each warp
// keeps an online softmax (m, l, acc) of its rows over its keys in log2
// units of the scaled scores (p = 2^(s c - m), c = log2 e / sqrt(d)).
// Then the CTA folds its warps' (m, l, acc) in shared memory in warp
// order; after a cluster barrier rank 0 reads every rank's folded (m, l,
// acc) through distributed shared memory, folds them the same way in
// rank order and writes out (and lse, M ln 2 + ln l); a second cluster
// barrier keeps the other ranks' shared memory alive until rank 0 has
// read it.
//
// float32: the split-kv kernel of the Ampere design, in two launches
// (flash_decode_split_kernel, then flash_decode_merge_kernel).  A warp
// takes one split of `per` keys (a multiple of 32; parts = ceil(Skv /
// per) splits, B Hkv Skv / 2112 keys rounded up, so that one wave of 132
// x 16 warps runs).  A lane copies 16 bytes of a key row at a time (L
// lanes a row, so a warp copies 32 / L rows an instruction, coalesced)
// with cp.async into its own slots of a ring of 3 tiles of kNI 32 / L
// keys (`flash_attention.decode_tile`), holds q's matching 16 bytes of
// each of the R rows in registers, and the row's L lanes sum their
// partial dot products with __shfl_xor_sync; each lane keeps an online
// softmax over the keys of its row slot, m shared by the warp.  At the
// end of the split the warp sums l and acc across its row slots and
// writes (m, l, acc) of each row to a float32 scratch that the wrapper
// allocates, and the merge kernel folds a row's splits in order.  The
// cluster design on the CUDA cores (tools/flash_decode_variants.cu)
// measured 0.3-2.9 % slower than this kernel in float32 on an NVIDIA
// H100 80GB HBM3 at 700.00 W, so float32 keeps it.
//
// Replaces: the TPU kernel src/repro/kernels/flash_attention.py:34
// (`_kernel`, called through `flash_attention`,
// src/repro/kernels/flash_attention.py:84), for decode-shaped calls.
//
// Bound on the H100: bytes.  Decode at B = 32, Hkv = 8, Skv = 4096,
// d = 64 reads 268 MB of bfloat16 K and V (537 MB in float32): 0.080 ms
// (0.160) at 3.35 TB/s, against 1.1e9 flops.  The bfloat16 design keeps
// its copies in flight with no register or instruction spent on them,
// spends a few tensor-core instructions where the CUDA cores would spend
// a shuffle a key, and needs no second kernel and no scratch; at the LM
// path's shapes (16 to 64 groups over 1,024 keys) the cluster spreads a
// group's keys over up to 8 SMs.  tools/flash_decode_variants.cu times
// both kernels beside the other shapes of their designs (PERF.md).
#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// cuTensorMapEncodeTiled from the driver, or null (csrc/matmul_tc.cu)
PFN_cuTensorMapEncodeTiled_v12000 cupbop_tensor_map_encoder();

namespace {

namespace cg = cooperative_groups;

constexpr int kWarps = 4, kThreads = 32 * kWarps;   // warps a CTA
constexpr int kMmaStages = 2;               // bfloat16's stages a warp
constexpr int kMaxCluster = 8;
constexpr int kCtas = 132;                  // bfloat16's clusters fill these
constexpr int kNI = 4;                      // float32: 16-byte chunks a lane
constexpr int kStages = 3;                  // float32: tiles in a warp's ring
constexpr int kRingBytes = kWarps * kStages * 2 * kNI * 32 * 16;   // 48 KB
constexpr int kSplitWarps = 132 * 16;       // float32: one wave of warps
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- float32: the split-kv kernel and its merge ------------------------
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
  extern __shared__ __align__(16) unsigned char smem[];
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
  uint4* ring = reinterpret_cast<uint4*>(smem) +
                (size_t)warp * kStages * 2 * kNI * 32 + lane;
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

// the split kernel, then the merge, on `stream`
template <typename T, int DP, int RMAX>
cudaError_t launch_split(const void* q, const void* k, const void* v,
                         void* o, float* lse, float* pm, float* pl,
                         float* pa, int B, int H, int Hkv, int Sq, int Skv,
                         int d, int causal, float scale, int split,
                         int nsplit, cudaStream_t stream) {
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

// the instantiation for R rows at width d
template <typename T>
cudaError_t launch_split_d(const void* q, const void* k, const void* v,
                           void* o, float* lse, float* pm, float* pl,
                           float* pa, int B, int H, int Hkv, int Sq, int Skv,
                           int d, int causal, float scale, int split,
                           int nsplit, cudaStream_t s) {
  const bool few = H / Hkv * Sq <= 4;
#define ROWS(DP)                                                           \
  return few ? launch_split<T, DP, 4>(q, k, v, o, lse, pm, pl, pa, B, H,   \
                                      Hkv, Sq, Skv, d, causal, scale,      \
                                      split, nsplit, s)                    \
             : launch_split<T, DP, 8>(q, k, v, o, lse, pm, pl, pa, B, H,   \
                                      Hkv, Sq, Skv, d, causal, scale,      \
                                      split, nsplit, s);
  if (d <= 32) { ROWS(32) }
  if (d <= 64) { ROWS(64) }
  ROWS(128)
#undef ROWS
}

// ---- bfloat16: the cluster kernel on the tensor cores ------------------
// The CTA's fold of its W warps' partials (wm, wl [W][RMAX], wacc
// [W][RMAX][d], the rows of R) in warp order, M = max m, l = sum l 2^(m -
// M), acc = sum acc 2^(m - M), into cm [RMAX], then l [RMAX] and acc
// [RMAX][d] after it; after a cluster barrier, rank 0 folds the ranks'
// the same way in rank order through distributed shared memory and
// writes out = acc / max(l, 1e-30) to o's rows from qrow, and lse's from
// lrow when lse is not null.  A second barrier keeps every rank's shared
// memory alive until rank 0 has read it.
template <typename T, int RMAX, int W>
__device__ __forceinline__ void fold_and_store(
    const float* wm, const float* wl, const float* wacc, float* cm, T* o,
    float* lse, size_t qrow, size_t lrow, int R, int d, uint32_t C,
    uint32_t rank) {
  cg::cluster_group cluster = cg::this_cluster();
  float* cl = cm + RMAX;
  float* cacc = cl + RMAX;
  for (int x = threadIdx.x; x < R * (d + 1); x += blockDim.x) {
    const int r = x / (d + 1), e = x % (d + 1);
    float mx = kMasked;
#pragma unroll
    for (int w = 0; w < W; ++w) mx = fmaxf(mx, wm[w * RMAX + r]);
    float sum = 0.0f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const float wt = exp2f(wm[w * RMAX + r] - mx);
      sum = fmaf(e < d ? wacc[((size_t)w * RMAX + r) * d + e]
                       : wl[w * RMAX + r],
                 wt, sum);
    }
    if (e < d) {
      cacc[r * d + e] = sum;
    } else {
      cl[r] = sum;
      cm[r] = mx;
    }
  }
  cluster.sync();                               // every rank folded
  if (rank == 0) {
    for (int x = threadIdx.x; x < R * d; x += blockDim.x) {
      const int r = x / d, e = x % d;
      float mx = kMasked;
      for (int c = 0; c < (int)C; ++c)
        mx = fmaxf(mx, cluster.map_shared_rank(cm, c)[r]);
      float sum = 0.0f, den = 0.0f;
      for (int c = 0; c < (int)C; ++c) {
        const float* rm = cluster.map_shared_rank(cm, c);
        const float wt = exp2f(rm[r] - mx);
        den = fmaf(rm[RMAX + r], wt, den);      // that rank's l
        sum = fmaf(rm[2 * RMAX + r * d + e], wt, sum);
      }
      den = fmaxf(den, 1e-30f);
      from_f32(sum / den, &o[qrow + (size_t)r * d + e]);
      if (lse != nullptr && e == 0) lse[lrow + r] = mx * kLn2 + logf(den);
    }
  }
  cluster.sync();                               // rank 0 has read them
}

// keys a warp takes from each tile on the tensor-core path: one k16 of p v
constexpr int kMmaTile = 16;

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

// c += a b, m16n8k16, bfloat16 in, float32 accumulate; a's rows 8 .. 15
// are zero (registers a1 and a3)
__device__ __forceinline__ void mma_rows8(float (&c)[4], uint32_t a0,
                                          uint32_t a2, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(0u), "r"(a2), "r"(0u), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// one box of a [groups, Skv, d] map: columns c0.., rows c1.., group c2
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(
          dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

template <int DP, int W, int S>
struct MmaTile {
  static constexpr int kBoxes = DP / 64;                 // 64 columns each
  static constexpr int kBoxBytes = kMmaTile * 128;       // 2 KB
  static constexpr int kTileBytes = kBoxes * kBoxBytes;  // K or V
  static constexpr int kRing = W * S * 2 * kTileBytes;
  static constexpr int kParts = W * 8 * (DP + 2) * 4;
  static constexpr int kHead = (8 * (DP + 2) * 4 + W * S * 8 + 127) / 128 *
                               128;
  static constexpr int kSmem =
      kHead + 1024 + (kRing > kParts ? kRing : kParts);
};

// DP: d padded to 64 or 128; W: warps; S: stages a warp.  K and V arrive
// by TMA from [B Hkv, Skv, d] maps in boxes of 16 keys x 64 columns with
// 128-byte swizzle (zeros past Skv and past d), so that ldmatrix reads
// them without bank conflicts.  A warp's tile is one m16n8k16 step of p v:
// s = q k^T over two n8 tiles of keys (q's R <= 8 rows in a's rows 0 .. 7),
// then o += p v with p split into bfloat16 hi + lo, two products, so that
// p keeps about 16 bits (the plain version's float32 p within PLAIN_TOL).
template <int DP, int W, int S>
__global__ void __launch_bounds__(32 * W, 16 / W)
    flash_decode_mma_kernel(const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __nv_bfloat16* __restrict__ q,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int H, int Hkv, int Sq,
                            int Skv, int d, int causal, float scale2,
                            int per) {
  using M = MmaTile<DP, W, S>;
  constexpr int kT = W * kMmaTile;              // keys a tile
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t C, rank;                             // the cluster's CTAs, ours
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(C));
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  const int bg = blockIdx.x / C;                // b * Hkv + kv head
  const int g = H / Hkv, R = g * Sq;
  const int b = bg / Hkv, hk = bg % Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane / 4, tq = lane % 4;       // the fragments' row, pair
  const int start = (int)rank * per, end = min(start + per, Skv);
  const int w0 = start + warp * kMmaTile;
  const int ntile = w0 < end ? (end - w0 + kT - 1) / kT : 0;

  float* cm = reinterpret_cast<float*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + 8 * (DP + 2) * 4);
  const uint32_t ring = (smem_u32(smem + M::kHead) + 1023u) & ~1023u;
  const uint32_t mine = ring + warp * S * 2 * M::kTileBytes;
  const uint32_t full0 = smem_u32(bars + warp * S);
  auto issue = [&](int t) {
    const uint32_t st = mine + (t % S) * 2 * M::kTileBytes;
    const uint32_t bar = full0 + 8 * (t % S);
    const int k0 = w0 + t * kT;
    mbar_expect_tx(bar, 2 * M::kTileBytes);
#pragma unroll
    for (int x = 0; x < M::kBoxes; ++x) {
      tma_load_3d(st + x * M::kBoxBytes, &map_k, bar, 64 * x, k0, bg);
      tma_load_3d(st + M::kTileBytes + x * M::kBoxBytes, &map_v, bar, 64 * x,
                  k0, bg);
    }
  };
  if (lane == 0) {
    for (int s = 0; s < S; ++s) mbar_init(full0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < S && t < ntile; ++t) issue(t);
  }
  __syncwarp();

  // q's rows as a's fragments: row gr, columns 16 kk + 2 tq (+ 8)
  const size_t qrow = ((size_t)b * H + (size_t)hk * g) * Sq * d;
  uint32_t qa[DP / 16][2];
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 16 * kk + 8 * h + 2 * tq;
      qa[kk][h] = gr < R && c < d
                      ? *reinterpret_cast<const uint32_t*>(
                            q + qrow + (size_t)gr * d + c)
                      : 0u;
    }
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  float m = kMasked, l = 0.0f;
  // a swizzled box row's 16-byte chunk: the row's chunk c ^ (row % 8)
  auto chunk = [](uint32_t tile, int row, int c) {
    return tile + (c / 8) * M::kBoxBytes + row * 128 +
           (((c % 8) ^ (row & 7)) << 4);
  };
  for (int t = 0; t < ntile; ++t) {
    mbar_wait(full0 + 8 * (t % S), (t / S) & 1);
    const uint32_t sk = mine + (t % S) * 2 * M::kTileBytes;
    const uint32_t sv = sk + M::kTileBytes;
    // s = q k^T: keys 8 j + 2 tq (+ 1) of row gr in sc[j][0 .. 1]
    float sc[2][4] = {};
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int kk = 0; kk < DP / 16; kk += 2) {
        uint32_t bk[4];
        ldsm_x4(chunk(sk, 8 * j + lane % 8, 2 * kk + lane / 8), bk);
        mma_rows8(sc[j], qa[kk][0], qa[kk][1], bk[0], bk[1]);
        mma_rows8(sc[j], qa[kk + 1][0], qa[kk + 1][1], bk[2], bk[3]);
      }
    const int k0 = w0 + t * kT + 2 * tq;
    float mx = kMasked;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = k0 + 8 * j + e;
        sc[j][e] = key < end && (!causal || gr % Sq >= key)
                       ? sc[j][e] * scale2
                       : kMasked;
        mx = fmaxf(mx, sc[j][e]);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float corr = exp2f(m - m_new);
    m = m_new;
    l *= corr;
    uint32_t ph[2], pl[2];                      // p as a's hi and lo
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float p[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        p[e] = sc[j][e] == kMasked ? 0.0f : exp2f(sc[j][e] - m_new);
        l += p[e];
      }
      ph[j] = pack_bf16(p[0], p[1]);
      const __nv_bfloat162 h = *reinterpret_cast<__nv_bfloat162*>(&ph[j]);
      pl[j] = pack_bf16(p[0] - __low2float(h), p[1] - __high2float(h));
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= corr;
      acc[n][1] *= corr;
    }
    // o += p v: v's columns 8 n + gr, two n8 tiles a load
#pragma unroll
    for (int n = 0; n < DP / 8; n += 2) {
      uint32_t bv[4];
      ldsm_x4_t(chunk(sv, lane % 16, n + lane / 16), bv);
      mma_rows8(acc[n], ph[0], ph[1], bv[0], bv[1]);
      mma_rows8(acc[n], pl[0], pl[1], bv[0], bv[1]);
      mma_rows8(acc[n + 1], ph[0], ph[1], bv[2], bv[3]);
      mma_rows8(acc[n + 1], pl[0], pl[1], bv[2], bv[3]);
    }
    __syncwarp();
    if (lane == 0 && t + S < ntile) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(t + S);
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  __syncthreads();                              // every tile consumed
  float* wm = reinterpret_cast<float*>(smem + (ring - smem_u32(smem)));
  float* wl = wm + W * 8;
  float* wacc = wl + W * 8;
  if (gr < R) {
#pragma unroll
    for (int n = 0; n < DP / 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * n + 2 * tq + e;
        if (c < d) wacc[((size_t)warp * 8 + gr) * d + c] = acc[n][e];
      }
    if (tq == 0) {
      wm[warp * 8 + gr] = m;
      wl[warp * 8 + gr] = l;
    }
  }
  __syncthreads();
  fold_and_store<__nv_bfloat16, 8, W>(wm, wl, wacc, cm, o, lse, qrow,
                                      ((size_t)b * H + (size_t)hk * g) * Sq,
                                      R, d, C, rank);
}

// a bfloat16 [groups, Skv, d] tensor in boxes of kMmaTile keys x 64
// columns, 128-byte swizzle; false when the driver refuses it
bool encode_kv(CUtensorMap* map, const void* ptr, int groups, int Skv,
               int d) {
  auto fn = cupbop_tensor_map_encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)Skv,
                              (cuuint64_t)groups};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)Skv * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)kMmaTile, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int W, int S>
cudaError_t launch_mma_dp(const void* q, const void* k, const void* v,
                          void* o, float* lse, int B, int H, int Hkv, int Sq,
                          int Skv, int d, int causal, float scale, int cluster,
                          int per, cudaStream_t stream) {
  using M = MmaTile<DP, W, S>;
  CUtensorMap map_k, map_v;
  if (!encode_kv(&map_k, k, B * Hkv, Skv, d) ||
      !encode_kv(&map_v, v, B * Hkv, Skv, d))
    return cudaErrorInvalidValue;
  const long long ctas = (long long)B * Hkv * cluster;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  auto kern = flash_decode_mma_kernel<DP, W, S>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, M::kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(32 * W);
  cfg.dynamicSmemBytes = M::kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, map_k, map_v,
                           (const __nv_bfloat16*)q, (__nv_bfloat16*)o, lse, H,
                           Hkv, Sq, Skv, d, causal, scale * kLog2e, per);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the tensor-core path at width d
template <int W, int S>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int Hkv, int Sq, int Skv,
                       int d, int causal, float scale, int cluster, int per,
                       cudaStream_t s) {
  if (d <= 64)
    return launch_mma_dp<64, W, S>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, d,
                                   causal, scale, cluster, per, s);
  return launch_mma_dp<128, W, S>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, d,
                                  causal, scale, cluster, per, s);
}

}  // namespace

// The keys of each part of a kv group (`per`) that the wrapper's
// `flash_attention.decode_split` gives, which keeps the same rule for the
// plain version: the parts are ceil(Skv / per).  bfloat16: per = a whole
// number of kWarps 16-key tiles over C ranks, C doubled from 1 while C <
// kMaxCluster, the B Hkv C CTAs stay under kCtas and rank 2C - 1 would
// still hold keys.  float32: a split of B Hkv Skv / kSplitWarps keys
// rounded up to a multiple of 32, at least 32.
extern "C" int flash_decode_per(int B, int Hkv, int Skv, int d, int bf16) {
  (void)d;          // neither rule depends on the width
  if (!bf16) {
    const long long w = (long long)B * Hkv * Skv;
    const long long s = (w + kSplitWarps - 1) / kSplitWarps;
    return (int)((s < 32 ? 32 : s + 31) / 32 * 32);
  }
  const int tile = kWarps * kMmaTile;
  auto per_rank = [&](long long c) {
    return (int)((Skv + c * tile - 1) / (c * tile) * tile);
  };
  int c = 1;
  while (c < kMaxCluster && (long long)B * Hkv * c < kCtas &&
         (2LL * c - 1) * per_rank(2 * c) < Skv)
    c *= 2;
  return per_rank(c);
}

// bf16: 0 when q, k, v and o are float32, 1 when they are bfloat16.
// d * (element size) % 16 == 0, d <= 128, q, k, v and o 16-byte aligned
// and contiguous, R = (H / Hkv) Sq <= 8, Skv >= 1 (the wrapper's route
// checks; refused here as well).  Each kv group's keys in `parts` parts of
// `per` keys, none of them empty: parts = ceil(Skv / per).  bfloat16:
// `parts` is the cluster (1, 2, 4 or 8) and `per` a whole number of
// tiles; part_m, part_l and part_acc are unread (null).  float32: `per` a
// multiple of 32; part_m, part_l: [B Hkv, parts, R] float32, part_acc:
// [B Hkv, parts, R, d].  `tile` is the keys a warp takes from each tile
// as the caller's plain version walks them (`flash_attention.decode_tile`):
// refused unless it is the kernel's own (16 in bfloat16, kNI 32 / L in
// float32), so that the two cannot sum in different orders.  lse: null,
// or float32 [B, H, Sq] for each row's logsumexp.
extern "C" int launch_flash_decode(const void* q, const void* k,
                                   const void* v, void* o, void* part_m,
                                   void* part_l, void* part_acc, int B, int H,
                                   int Hkv, int Sq, int Skv, int d, int causal,
                                   float scale, int parts, int per, int tile,
                                   int bf16, void* lse, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v) |
                        reinterpret_cast<uintptr_t>(o);
  const int size = bf16 ? 2 : 4;
  const int dp = d <= 32 ? 32 : d <= 64 ? 64 : 128;
  const int kt = bf16 ? kMmaTile : kNI * 32 / (dp * size / 16);
  if (Hkv <= 0 || H % Hkv || d <= 0 || d > 128 || (d * size) % 16 ||
      any % 16 || Skv <= 0 || Sq <= 0 || H / Hkv * Sq > 8 || tile != kt ||
      per <= 0 || parts != (Skv + per - 1) / per)
    return (int)cudaErrorInvalidValue;
  float* ls = (float*)lse;
  if (bf16) {
    if (parts > kMaxCluster || (parts & (parts - 1)) ||
        per % (kWarps * kt))
      return (int)cudaErrorInvalidValue;
    return (int)launch_mma<kWarps, kMmaStages>(q, k, v, o, ls, B, H, Hkv, Sq,
                                               Skv, d, causal, scale, parts,
                                               per, s);
  }
  if (per % 32 || part_m == nullptr || part_l == nullptr ||
      part_acc == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)launch_split_d<float>(q, k, v, o, ls, (float*)part_m,
                                    (float*)part_l, (float*)part_acc, B, H,
                                    Hkv, Sq, Skv, d, causal, scale, per,
                                    parts, s);
}
