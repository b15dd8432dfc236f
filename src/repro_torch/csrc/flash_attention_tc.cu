// flash_attention_tc: causal or non-causal GQA prefill in bfloat16 on the
// tensor cores (FlashAttention-2 with mma.sync), q [B, H, Sq, d], k and v
// [B, Hkv, Skv, d], out [B, H, Sq, d]; query head h reads kv head
// h / (H / Hkv).  The scores, the online softmax and the accumulator are
// float32; p is rounded to bfloat16 for the product with v, the one
// rounding the reference does not make (the plain version makes it too).
//
// One block of 4 warps owns (b, h, a tile of queries); each warp owns 32
// query rows (two m16 tiles, so that each K and V fragment it reads from
// shared memory feeds two mma) for d <= 64, 16 rows for d = 128 (where two
// tiles' accumulators do not fit the registers), and skips the kv tiles
// that lie wholly above its rows.  The block stages its q tile once with
// cp.async, and each warp keeps its rows in registers as
// mma.sync.m16n8k16 A fragments, loaded by ldmatrix.
// The kv axis is walked in tiles of 64 keys, double buffered in
// __shared__ memory by cp.async (16-byte chunks; rows padded
// by 16 bytes, so ldmatrix's eight rows hit different banks): the next
// tile loads while this one is multiplied.  S = q k^T is 8 mma n-tiles a
// warp, K read by ldmatrix (K [keys, d] row-major is the col-major B
// operand); the row max and sum go over the quad of lanes that share a
// row (__shfl_xor_sync 1 and 2).  p is converted to bf16 in registers
// from the C-fragment layout to the A-fragment layout (no trip through
// shared memory), and V is read by ldmatrix.trans for p v.  Masked scores
// are -1e30, never -inf; the causal mask is top-left (qpos >= kpos, both
// counted from 0), and kv tiles wholly above the tile's diagonal are not
// visited.  The output is acc / max(l, 1e-30).  When `lse` is not null the
// kernel also writes each row's logsumexp, float32 [B, H, Sq]: the natural
// log of the softmax's denominator over the scaled scores, m ln 2 +
// ln max(l, 1e-30) (m is kept in log2 units of the pre-scaled scores), for
// the trainable attention's backward; a null `lse` leaves the rest of the
// kernel as it was, bit for bit.  d is padded to 32, 64 or
// 128 with zeros (so d = 80 runs); ragged Sq and Skv are zero-filled on
// load, masked, and not stored.  Causal blocks are issued heaviest first.
//
// Replaces: the TPU kernel src/repro/kernels/flash_attention.py:34
// (`_kernel`, called through `flash_attention`,
// src/repro/kernels/flash_attention.py:84), for bfloat16 prefill whose
// rows cp.async can copy (`flash_attention.route` is "tc").
//
// Bound on the H100: operations.  Causal prefill at B = 2, H = 32,
// S = 4096, d = 64 does 4 d flops for each of B H S (S + 1) / 2 pairs,
// 1.37e11: 0.139 ms at the tensor cores' 989 TFLOP/s in bfloat16; its
// 5.4e8 exp take 0.128 ms on the special-function units.  mma.sync
// reaches only part of that rate on Hopper: a wgmma kernel with TMA and
// warp specialisation (FlashAttention-3's design) is a later redesign.
// Here each K and V tile is read from device memory once for 128 query
// rows (64 at d = 128) and from shared memory once for 32 (16), no score
// leaves the registers, and exp is one ex2.approx on the special-function
// unit (the scale folds in log2 e).  With one m16 tile a warp, each warp
// reads all of a 64-key K and V tile from shared memory (16 KB) for 16
// rows, and those ldmatrix reads, about 66 MB an SM at granite-3-2b's
// prefill, take longer than the mma (derived from the shapes); two tiles
// halve them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

}  // namespace

// q, k, v and o are bfloat16, 16-byte aligned, with d % 8 == 0 and
// 8 <= d <= 128 (the wrapper's route checks; refused here as well).
// lse: null, or float32 [B, H, Sq] for each row's logsumexp.
extern "C" int launch_flash_attention_tc(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int H, int Hkv, int Sq, int Skv,
                                         int d, int causal, float scale,
                                         void* lse, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* ls = (float*)lse;
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v);
  if (d % 8 || any % 16 || Hkv <= 0 || H % Hkv) return cudaErrorInvalidValue;
  if (d <= 32) return launch<32>(q, k, v, o, ls, B, H, Hkv, Sq, Skv, d,
                                 causal, scale, s);
  if (d <= 64) return launch<64>(q, k, v, o, ls, B, H, Hkv, Sq, Skv, d,
                                 causal, scale, s);
  if (d <= 128) return launch<128>(q, k, v, o, ls, B, H, Hkv, Sq, Skv, d,
                                   causal, scale, s);
  return cudaErrorInvalidValue;
}
