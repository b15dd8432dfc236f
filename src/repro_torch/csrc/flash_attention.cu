// flash_attention: causal or non-causal GQA attention with an online
// softmax, q [B, H, Sq, d], k and v [B, Hkv, Skv, d], out [B, H, Sq, d] in
// q's dtype (float32, or bfloat16 rounded to nearest even); query head h
// reads kv head h / (H / Hkv).  Everything is computed in float32: q, k,
// v, the scores, p and the accumulator.  The "simt" route of
// flash_attention.route: float32 prefill, and the bfloat16 calls that the
// tensor-core and decode kernels refuse (d % 8 != 0, views off 16 bytes).
//
// Replaces: the TPU kernel src/repro/kernels/flash_attention.py:34
// (`_kernel`, called through `flash_attention`,
// src/repro/kernels/flash_attention.py:84).
//
// Bound on the H100: operations.  Causal prefill at B = 2, H = 32,
// S = 4096, d = 64 does 4 d flops for each of B H S (S + 1) / 2 pairs,
// 1.37e11: 2.05 ms at the CUDA cores' 67 TFLOP/s of float32 (the
// reference's arithmetic: TF32 would not hold its 2e-5); its 5.4e8 exp
// take 0.128 ms on the special-function units.  So the design is about
// keeping the FMA pipes fed, FlashAttention's online softmax on the CUDA
// cores with both products as register outer products:
// - a CTA of 256 threads (128 up to d = 32) owns (b, h, BQ queries), so
//   each K and V tile read from L2 serves BQ rows: 256 at d = 64, 128 up
//   to d = 32, 64 at d = 128 (where two float32 K/V buffers and a bigger
//   q tile do not fit 227 KB);
// - the thread grid is TY x TX: thread (ty, tx) owns the TM rows ty + TY i,
//   of each 64-key tile the keys tx + TX j, and of the output the columns
//   tx 4 + 4 TX c + (0..3).  At d = 64 TM = 8 and TX = 8: S = q k^T is
//   8 x 8 scores a thread and O += p v 8 x 8 accumulators, 64 FMAs for 16
//   floats read from shared memory;
// - q (once) and each K and V tile are staged row-major in __shared__
//   memory, rows padded to d + 4 floats; S reads a float4 of d from each
//   of the thread's rows and keys (the warp's 4 or 2 rows are broadcasts,
//   its TX keys consecutive padded rows: no bank conflict), p goes
//   through a per-warp __shared__ patch (the lanes that share a row are
//   one warp: a __syncwarp, not a barrier), stored key-major so that O
//   reads float4s of p (broadcasts) and of v a key;
// - the row max is a __shfl_xor_sync butterfly over the TX lanes of a
//   row, the row sum a per-lane partial summed once at the end; exp is one
//   ex2.approx of the score pre-scaled by log2(e) / sqrt(d);
// - the next K/V tile is in flight while this one is computed: cp.async
//   into the second of two buffers for float32 rows of 16-byte multiples
//   on 16-byte boundaries; otherwise (bfloat16, d % 4, views off 16
//   bytes) K is loaded into registers during S and V during p v, each
//   stored into the second buffer after.  One barrier a tile;
// - causal CTAs start heaviest (last query tile) first, so the last wave
//   is not the diagonal's stragglers.
// Registers: each shape is held under 255 with no spill, partly by how
// far S's loop over d unrolls (ShapeOf below).
// Masked scores are -1e30, not -inf: a tile's first key is never masked
// for a live row (key 0 is in the first tile), so m is finite and no
// (-inf) - (-inf) arises.  The causal mask is top-left, qpos >= kpos with
// both counted from 0, and a kv tile wholly above the CTA's last row is
// not visited.  The output is acc / max(l, 1e-30); when `lse` is not null
// each row's logsumexp goes to float32 lse [B, H, Sq] as well, m ln 2 +
// ln max(l, 1e-30) (m is in log2 units of the pre-scaled scores), for the
// trainable attention's backward, and a null `lse` leaves the rest as it
// was, bit for bit.  Ragged edges (Sq or
// Skv not a multiple of the tiles, d below its padded width of 32, 64 or
// 128) are zero-filled on load and masked on store.
// tools/flash_attention_variants.cu times this kernel beside the one it
// replaced (32 queries a CTA, a warp's 4 rows, synchronous staging), in
// float32 and bfloat16 at d = 32, 64 and 128, and beside other query
// tiles, micro-tiles, unrolls, staging and CTA orders.
#include <cstdint>

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

constexpr int kKT = 64;                 // keys a tile (KV_TILE)
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !pred (src is then unread)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}

// 2^x on the special-function unit (2^-1e30 is 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A CTA's shape for the padded head width DP: BQ query rows, TM of them a
// thread; TX threads share a row.  UNROLL_D: d's float4 steps of S that
// one turn of its loop unrolls.  The launcher's shapes are ShapeOf<DP>
// below; the variant tool instantiates others.
template <int DP_, int BQ_, int TM_, int TX_, int UNROLL_D = DP_ / 4>
struct Shape {
  static constexpr int DP = DP_, BQ = BQ_, TM = TM_, TX = TX_;
  static constexpr int TY = BQ / TM;          // row groups
  static constexpr int NT = TY * TX;          // threads
  static constexpr int TN = kKT / TX;         // keys a thread, of a tile
  static constexpr int CN = DP / TX;          // output columns a thread
  static constexpr int G = 32 / TX;           // row groups a warp
  static constexpr int LD = DP + 4;           // padded row of q, K, V
  static constexpr int PS = G * TM + 4;       // a key's row of a warp's p
  static constexpr int kUnrollD = UNROLL_D;
  static_assert(NT % 32 == 0 && 32 % TX == 0 && TM % 4 == 0 && CN % 4 == 0,
                "a warp holds whole rows; rows and columns in float4s");
  // q, two buffers of K and V, p of each warp
  static constexpr size_t kSmem =
      sizeof(float) * ((size_t)BQ * LD + 4 * kKT * LD + NT / 32 * kKT * PS);
};

// The launcher's shape for the padded head width DP, the fastest of those
// tools/flash_attention_variants.cu times at each width on an H100: d = 64
// takes 256 queries a CTA and 8 x 8 micro-tiles (4 FMAs a float read from
// shared memory) with S's loop over d not unrolled, which keeps it under
// 255 registers; d = 32 the same micro-tiles over 128 queries a CTA of
// 128 threads, two CTAs an SM; d = 128 4 x 4 over 64 queries.
template <int DP>
struct ShapeOf;
template <>
struct ShapeOf<32> { using type = Shape<32, 128, 8, 8>; };
template <>
struct ShapeOf<64> { using type = Shape<64, 256, 8, 8, 1>; };
template <>
struct ShapeOf<128> { using type = Shape<128, 64, 4, 16>; };

// rows [r0, r0 + ROWS) of a [nrows, d] float32 matrix into a [ROWS][LD]
// tile by cp.async, 16 bytes a copy (d % 4 == 0, src 16-byte aligned)
template <class S, int ROWS>
__device__ __forceinline__ void stage_async(float* tile, const float* src,
                                            int r0, int nrows, int d,
                                            int tid) {
  constexpr int kChunks = S::DP / 4;
  static_assert(ROWS * kChunks % S::NT == 0, "whole chunks a thread");
#pragma unroll
  for (int u = 0; u < ROWS * kChunks / S::NT; ++u) {
    const int i = tid + u * S::NT;
    const int r = i / kChunks, col = (i % kChunks) * 4;
    const bool in = r0 + r < nrows && col < d;
    cp_async16(tile + r * S::LD + col,
               in ? src + (size_t)(r0 + r) * d + col : src, in);
  }
}

// the same rows one element a load, held as float32 in registers between
// the load and the store into the tile.  A thread's elements share one
// column (NT is a multiple of DP), so the loads clamp the row and column
// instead of carrying a predicate each, and the store writes 0 for those
// past nrows or d
template <class S, int ROWS>
struct Staged {
  static constexpr int kStep = S::NT / S::DP;       // rows between loads
  static constexpr int kN = ROWS / kStep;
  static_assert(S::NT % S::DP == 0 && ROWS % kStep == 0,
                "whole rows a pass, one column a thread");
  float x[kN];

  template <typename T>
  __device__ __forceinline__ void load(const T* src, int r0, int nrows,
                                       int d, int tid) {
    const T* col = src + min(tid % S::DP, d - 1);
#pragma unroll
    for (int u = 0; u < kN; ++u) {
      const int r = min(r0 + tid / S::DP + u * kStep, nrows - 1);
      x[u] = to_f32(col[(size_t)r * d]);
    }
  }
  __device__ __forceinline__ void store(float* tile, int r0, int nrows,
                                        int d, int tid) const {
    const int c = tid % S::DP, r = tid / S::DP;
#pragma unroll
    for (int u = 0; u < kN; ++u)
      tile[(r + u * kStep) * S::LD + c] =
          c < d && r0 + r + u * kStep < nrows ? x[u] : 0.0f;
  }
};

// ASYNC: q, k, v are float32 with d % 4 == 0 and, with o, on 16-byte
// boundaries (the launcher checks)
template <typename T, class S, bool ASYNC>
__global__ void __launch_bounds__(S::NT, 1)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o,
                           int BH, int H, int Hkv, int Sq, int Skv, int d,
                           int causal, float scale_log2,
                           float* __restrict__ lse) {
  constexpr int DP = S::DP, BQ = S::BQ, TM = S::TM, TN = S::TN;
  constexpr int TX = S::TX, TY = S::TY, CN = S::CN, LD = S::LD;
  constexpr int PS = S::PS;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);     // [BQ][LD]
  float* kvs = qs + BQ * LD;                       // [2][K, V][kKT][LD]
  float* ps = kvs + 4 * kKT * LD;                  // [warps][kKT][PS]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int tx = lane % TX, tyl = lane / TX, ty = warp * S::G + tyl;
  const int nq = (Sq + BQ - 1) / BQ;
  // heaviest (last) query tiles first: under the causal mask they walk
  // the most kv tiles
  const int qt = nq - 1 - (int)(blockIdx.x / BH);
  const int bh = blockIdx.x % BH;
  const int h = bh % H, b = bh / H, hk = h / (H / Hkv);
  const int q0 = qt * BQ;
  const T* qb = q + (size_t)(b * H + h) * Sq * d;
  const T* kb = k + (size_t)(b * Hkv + hk) * Skv * d;
  const T* vb = v + (size_t)(b * Hkv + hk) * Skv * d;
  T* ob = o + (size_t)(b * H + h) * Sq * d;
  // keys at or past kend are masked for every row of the CTA
  const int kend = causal ? min(Skv, q0 + BQ) : Skv;
  const int nt = (kend + kKT - 1) / kKT;

  Staged<S, kKT> next;    // the register path's next K, then V, tile
  if constexpr (ASYNC) {
    stage_async<S, BQ>(qs, reinterpret_cast<const float*>(qb), q0, Sq, d,
                       tid);
    if (nt > 0) {
      stage_async<S, kKT>(kvs, reinterpret_cast<const float*>(kb), 0, Skv,
                          d, tid);
      stage_async<S, kKT>(kvs + kKT * LD, reinterpret_cast<const float*>(vb),
                          0, Skv, d, tid);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  } else {
    for (int i = tid; i < BQ * DP; i += S::NT) {
      const int r = i / DP, c = i % DP;
      qs[r * LD + c] =
          q0 + r < Sq && c < d ? to_f32(qb[(size_t)(q0 + r) * d + c]) : 0.0f;
    }
    if (nt > 0) {
      next.load(kb, 0, Skv, d, tid);
      next.store(kvs, 0, Skv, d, tid);
      next.load(vb, 0, Skv, d, tid);
      next.store(kvs + kKT * LD, 0, Skv, d, tid);
    }
  }

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
    float* kn = kvs + ((it + 1) & 1) * 2 * kKT * LD;   // the other buffer
    float* vn = kn + kKT * LD;
    const bool more = it + 1 < nt;
    if constexpr (ASYNC) asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // this tile is in place; every thread is done with the other buffer,
    // which no thread reads again before the next barrier
    __syncthreads();
    // the next tile loads while this one is used: by cp.async, or K into
    // registers during S and V during p v, each stored after
    if (more) {
      if constexpr (ASYNC) {
        stage_async<S, kKT>(kn, reinterpret_cast<const float*>(kb),
                            k0 + kKT, Skv, d, tid);
        stage_async<S, kKT>(vn, reinterpret_cast<const float*>(vb),
                            k0 + kKT, Skv, d, tid);
        asm volatile("cp.async.commit_group;\n" ::: "memory");
      } else {
        next.load(kb, k0 + kKT, Skv, d, tid);
      }
    }

    // ---- S = q k^T: s[i][j] for row ty + TY i, key k0 + tx + TX j ------
    float s[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) s[i][j] = 0.0f;
#pragma unroll(S::kUnrollD)
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

    if constexpr (!ASYNC) {
      if (more) {
        next.store(kn, k0 + kKT, Skv, d, tid);
        next.load(vb, k0 + kKT, Skv, d, tid);
      }
    }

    // ---- scale (log2 domain), mask, online softmax ----------------------
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
      l[i] = l[i] * corr + sum;  // this lane's share; the row sums at the end
#pragma unroll
      for (int c = 0; c < CN; ++c) acc[i][c] *= corr;
    }

    // ---- p into the warp's patch, key-major: pw[key][tyl TM + i] --------
#pragma unroll
    for (int j = 0; j < TN; ++j)
#pragma unroll
      for (int g = 0; g < TM / 4; ++g)
        *reinterpret_cast<float4*>(pw + (tx + TX * j) * PS + tyl * TM +
                                   4 * g) =
            make_float4(s[4 * g][j], s[4 * g + 1][j], s[4 * g + 2][j],
                        s[4 * g + 3][j]);
    __syncwarp();

    // ---- O += p v: acc[i][4 c + e] for column tx 4 + 4 TX c + e ---------
    // a masked key's p is 0 and a key past Skv has v = 0: every key of
    // the tile is added
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
    if constexpr (!ASYNC) {
      if (more) next.store(vn, k0 + kKT, Skv, d, tid);
    }
    // the next write of pw follows the next tile's barrier
  }
  if constexpr (ASYNC) asm volatile("cp.async.wait_group 0;\n" ::: "memory");

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = TX / 2; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int qpos = q0 + ty + TY * i;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(lt, 1e-30f);
    if (lse != nullptr && tx == 0)    // m[i] is the row's, lt its sum
      lse[(size_t)(b * H + h) * Sq + qpos] = m[i] * kLn2 + logf(denom);
    T* orow = ob + (size_t)qpos * d;
#pragma unroll
    for (int c = 0; c < CN / 4; ++c) {
      const int col = tx * 4 + 4 * TX * c;
      if constexpr (ASYNC) {         // float32, d % 4 == 0, aligned
        if (col < d)
          *reinterpret_cast<float4*>(orow + col) = make_float4(
              acc[i][4 * c] / denom, acc[i][4 * c + 1] / denom,
              acc[i][4 * c + 2] / denom, acc[i][4 * c + 3] / denom);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < d) from_f32(acc[i][4 * c + e] / denom, orow + col + e);
      }
    }
  }
}

template <typename T, class S, bool ASYNC>
cudaError_t launch_shape(const void* q, const void* k, const void* v,
                         void* o, int B, int H, int Hkv, int Sq, int Skv,
                         int d, int causal, float scale,
                         cudaStream_t stream, float* lse = nullptr) {
  const auto kern = flash_attention_kernel<T, S, ASYNC>;
  // above 48 KB a block's dynamic shared memory needs the opt-in
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)S::kSmem);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((Sq + S::BQ - 1) / S::BQ);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kern<<<(unsigned)blocks, S::NT, S::kSmem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, B * H, H, Hkv, Sq, Skv,
      d, causal, scale * kLog2e, lse);
  return cudaGetLastError();
}

// cp.async where the rows are float32 16-byte multiples on 16-byte
// boundaries, registers otherwise
template <typename T, class S>
cudaError_t launch_staged(const void* q, const void* k, const void* v,
                          void* o, int B, int H, int Hkv, int Sq, int Skv,
                          int d, int causal, float scale,
                          cudaStream_t stream, float* lse) {
  const uintptr_t any =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if constexpr (sizeof(T) == sizeof(float)) {
    if (d % 4 == 0 && any % 16 == 0)
      return launch_shape<T, S, true>(q, k, v, o, B, H, Hkv, Sq, Skv, d,
                                      causal, scale, stream, lse);
  }
  return launch_shape<T, S, false>(q, k, v, o, B, H, Hkv, Sq, Skv, d, causal,
                                   scale, stream, lse);
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int Hkv, int Sq, int Skv, int d,
                     int causal, float scale, cudaStream_t stream,
                     float* lse) {
  if (d <= 32)
    return launch_staged<T, ShapeOf<32>::type>(q, k, v, o, B, H, Hkv, Sq,
                                               Skv, d, causal, scale, stream,
                                               lse);
  if (d <= 64)
    return launch_staged<T, ShapeOf<64>::type>(q, k, v, o, B, H, Hkv, Sq,
                                               Skv, d, causal, scale, stream,
                                               lse);
  if (d <= 128)
    return launch_staged<T, ShapeOf<128>::type>(
        q, k, v, o, B, H, Hkv, Sq, Skv, d, causal, scale, stream, lse);
  return cudaErrorInvalidValue;
}

}  // namespace

// bf16: 0 when q, k, v and o are float32, 1 when they are bfloat16.
// 1 <= d <= 128, H a multiple of Hkv (the wrapper checks both).
// lse: null, or float32 [B, H, Sq] for each row's logsumexp.
extern "C" int launch_flash_attention(const void* q, const void* k,
                                      const void* v, void* o, int B, int H,
                                      int Hkv, int Sq, int Skv, int d,
                                      int causal, float scale, int bf16,
                                      void* lse, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* ls = (float*)lse;
  return (int)(bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Skv,
                                              d, causal, scale, s, ls)
                    : launch_d<float>(q, k, v, o, B, H, Hkv, Sq, Skv, d,
                                      causal, scale, s, ls));
}

// The query rows a CTA of the launcher owns at head width d (1 ... 128),
// and the CTAs it starts for B H heads of Sq queries.
extern "C" int flash_attention_q_tile(int d) {
  return d <= 32 ? ShapeOf<32>::type::BQ
                 : d <= 64 ? ShapeOf<64>::type::BQ : ShapeOf<128>::type::BQ;
}

extern "C" int flash_attention_ctas(int B, int H, int Sq, int d) {
  const int bq = flash_attention_q_tile(d);
  return B * H * ((Sq + bq - 1) / bq);
}
