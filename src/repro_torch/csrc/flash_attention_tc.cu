// flash_attention_tc: causal or non-causal GQA prefill in bfloat16 on
// Hopper's tensor cores (FlashAttention-3's design: TMA, a producer
// warpgroup and wgmma), q [B, H, Sq, d], k and v [B, Hkv, Skv, d], out
// [B, H, Sq, d]; query head h reads kv head h / (H / Hkv).  The scores, the
// online softmax and the accumulator are float32; p is rounded to bfloat16
// for the product with v, the one rounding the reference does not make
// (the plain version makes it too).
//
// A CTA owns (b, h, a tile of 64 NC queries) and has NC + 1 warpgroups.
// The last is the producer: after `setmaxnreg` drops its registers, one
// thread loads the CTA's q tile once by TMA and keeps a ring of ST stages
// of K and V tiles (kBN = 128 keys each) in flight, K and V each completing
// on the stage's own `full` mbarrier, and refills a stage once every
// consumer has released it on its `empty` mbarrier.  The others are the
// consumers (registers raised by `setmaxnreg`), 64 query rows each:
//   S = q k^T   wgmma m64n128k16, q and K both K-major from shared memory;
//   softmax     masked scores -1e30 (never -inf), the row max and sum over
//               the quad of lanes that share a row, p = 2^(s c - m) as one
//               FFMA and one ex2.approx (c folds 1 / sqrt(d) and log2 e);
//   o += p v    p converted to bfloat16 in registers and fed as wgmma's
//               register A operand (the accumulator's layout is the A
//               fragment's, so no score leaves the registers), V the
//               transposed (MN-major) B operand from shared memory.
// Two steps of FlashAttention-3 overlap the softmax with the products: PP
// (ping-pong), named barriers that give the consumers turns at the tensor
// cores in a cycle, so that one's products run under another's softmax;
// and OV (intra-warpgroup overlap), tile i's q k^T issued together with
// tile i - 1's p v, and tile i's softmax run while that p v does.  The
// causal mask is top-left (qpos >= kpos, both counted from 0); a CTA walks
// its keys up to its last row, and a consumer whose rows lie wholly above
// a tile's keys only releases its stage.  The output is acc / max(l,
// 1e-30), rounded once.  When `lse` is not null the kernel also writes
// each row's logsumexp, float32 [B, H, Sq]: m ln 2 + ln max(l, 1e-30) (m
// is kept in log2 units of the scaled scores), the plain version's -1e30
// for a row that saw no key, for the trainable attention's backward; a
// null `lse` changes nothing else.  Causal CTAs are issued heaviest first.
//
// The tensor maps are encoded on the host at every launch with
// cuTensorMapEncodeTiled, fetched from the driver by csrc/matmul_tc.cu's
// cupbop_tensor_map_encoder() (the library links no -lcuda), and reach the
// kernel as `const __grid_constant__ CUtensorMap` parameters.  q is mapped
// as [B H, Sq, d] and k, v as [B Hkv, Skv, d], never as 2-D [rows, d], so
// that a ragged last tile arrives as TMA's zeros and not as the next
// head's rows; ragged rows are masked and never stored.  The boxes are 64
// columns wide (128 bytes) with 128-byte swizzle, the wgmma descriptors'
// layout type 1, each tile on a 1024-byte boundary: d is padded to 64 or
// 128 in shared memory, and the columns past d (d = 80, 112) arrive as
// TMA's zeros.  Skv = 0 encodes no k or v map (a zero extent is refused)
// and writes zeros.  Every choice of (NC, ST, PP, OV) computes the same
// bits: they differ in schedule only.
//
// Replaces: the TPU kernel src/repro/kernels/flash_attention.py:34
// (`_kernel`, called through `flash_attention`,
// src/repro/kernels/flash_attention.py:84), for bfloat16 prefill whose
// tensors TMA can address (`flash_attention.route` is "tc").
//
// Bound on the H100: operations at long prompts, bytes at 1,024 tokens.
// Causal prefill at B = 2, H = 32, S = 4096, d = 64 does 4 d flops for
// each of B H S (S + 1) / 2 pairs, 1.37e11: 0.139 ms at the tensor cores'
// 989 TFLOP/s in bfloat16, and its 5.4e8 exp take about as long on the
// special-function units, so at d = 64 the softmax costs as much as the
// products and only their overlap approaches the bound.  wgmma is the only
// route to the tensor cores' full rate on Hopper; TMA spends no consumer
// register or instruction on the copies; each K and V tile is read from
// device memory once for 64 NC query rows; the softmax issues about four
// FMA- and ALU-pipe instructions a score beside its ex2, and the mask's
// compares run in a loop of their own, only on the tiles that need them.
// On an H100 80GB HBM3 at 700 W, tools/flash_attention_tc_variants.cu
// times the kernel at that shape at 0.328 ms, 42 % of the bound (the
// FlashAttention-2 kernel it replaced: 0.587), and the choices at
// `Choice` below against the design's other shapes; what holds the rest
// is not measured (no profiler of the SM's pipes runs there).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// cuTensorMapEncodeTiled from the driver, or null (csrc/matmul_tc.cu)
PFN_cuTensorMapEncodeTiled_v12000 cupbop_tensor_map_encoder();

namespace flash_tc {

constexpr int kBN = 128;                // keys a tile (TC_KV_TILE)
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
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

// one box of a [heads, rows, d] map: columns c0.., rows c1.., head c2
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

// named barriers 1 + w: consumer w's turn at the tensor cores (PP)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// a wgmma shared-memory descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// s (64 x 128, f32) = or += a (64 x 16, K-major) b^T (128 x 16, K-major),
// both from shared memory; `acc` 0 overwrites s
__device__ __forceinline__ void wgmma_s(float (&d)[64], uint64_t da,
                                        uint64_t db, int acc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(acc));
}

// o (64 x 64, f32) += p (64 x 16, bf16 A fragments in registers) v (16 x 64,
// MN-major in shared memory: the transpose-B bit)
__device__ __forceinline__ void wgmma_o(float (&d)[32],
                                        const uint32_t (&a)[4],
                                        uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// the same at 64 x 128 (d padded to 128)
__device__ __forceinline__ void wgmma_o(float (&d)[64],
                                        const uint32_t (&a)[4],
                                        uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, 1, 1, 1, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
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

// the shape of a CTA: DP the padded head width (64 or 128), NC consumer
// warpgroups of 64 query rows, ST stages of K and V
template <int DP, int NC, int ST>
struct Tile {
  static constexpr int kBM = 64 * NC;                  // query rows
  static constexpr int kThreads = 128 * (NC + 1);
  static constexpr int kBlocksPerSM = NC == 1 ? 2 : 1;
  // registers a thread after setmaxnreg: the CTA's blocks fill the file
  static constexpr int kProducerRegs = NC == 3 ? 32 : 24;
  static constexpr int kConsumerRegs = NC == 1 ? 232 : NC == 2 ? 240 : 160;
  static constexpr int kBoxes = DP / 64;               // 64-column boxes
  static constexpr int kQBytes = kBM * DP * 2;
  static constexpr int kKVBytes = kBN * DP * 2;        // one K or V tile
  static constexpr int kSmemBytes = kQBytes + 2 * ST * kKVBytes +
                                    1024 /* align */ + 8 * (1 + 3 * ST);
};

// S = q k^T for the warpgroup's 64 rows (q_w: their first row in the q
// tile of bm rows) over one K tile; n8 tile j of S holds keys 8 j .. 8 j + 7
template <int DP>
__device__ __forceinline__ void issue_s(float (&sc)[64], uint32_t q_w,
                                        int bm, uint32_t kt) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    // k16 slice kk: 32 bytes into the rows of 64-column box kk / 4
    const uint64_t da = make_desc(q_w + (kk / 4) * bm * 128 + (kk % 4) * 32,
                                  16, 1024);
    const uint64_t db = make_desc(kt + (kk / 4) * kBN * 128 + (kk % 4) * 32,
                                  16, 1024);
    wgmma_s(sc, da, db, kk > 0);
  }
}

// o += p v over one V tile: V [keys, d] is the MN-major B operand, 16 keys
// (2048 bytes) a k16 step, its 64-column boxes kBN * 128 bytes apart
template <int DP>
__device__ __forceinline__ void issue_o(float (&acc)[DP / 2],
                                        const uint32_t (&pa)[kBN / 16][4],
                                        uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < kBN / 16; ++kk)
    wgmma_o(acc, pa[kk], make_desc(vt + kk * 16 * 128, kBN * 128, 1024));
}

// the online softmax of one tile's raw scores, in place: masked scores
// become -1e30 (when `edge`), the rows' max m (log2 units of the scaled
// scores) moves, l is rescaled and gains this lane's share of p, and sc
// becomes p = 2^(s c - m) (one FFMA and one ex2.approx); corr is the factor
// for the accumulator.  This lane's rows are r0 and r0 + 8, its keys
// k0 + 8 j + 2 t + {0, 1}.
__device__ __forceinline__ void softmax(float (&sc)[64], float (&m)[2],
                                        float (&l)[2], float (&corr)[2],
                                        bool edge, int k0, int r0, int t,
                                        int Skv, int causal, float c) {
  if (edge) {                     // a uniform branch: most tiles skip it
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * t + (e & 1);
        const int qpos = r0 + (e >> 1) * 8;
        if (key >= Skv || (causal && qpos < key)) sc[4 * j + e] = kMasked;
      }
    }
  }
  float mx[2] = {kMasked, kMasked};
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * j + e]);
  }
  float neg[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 1));
    mx[hf] = fmaxf(mx[hf], __shfl_xor_sync(0xffffffffu, mx[hf], 2));
    // c > 0, so the max of the scaled scores is the scaled max
    const float m_new = fmaxf(m[hf], mx[hf] * c);
    corr[hf] = exp2_approx(m[hf] - m_new);
    m[hf] = m_new;
    neg[hf] = -m_new;
    l[hf] *= corr[hf];            // this lane's share; the quad sums later
  }
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      sc[4 * j + e] = exp2_approx(fmaf(sc[4 * j + e], c, neg[e >> 1]));
    l[0] += sc[4 * j] + sc[4 * j + 1];
    l[1] += sc[4 * j + 2] + sc[4 * j + 3];
  }
}

// p to bf16 A fragments: the C layout (row g | g + 8, keys 2t, 2t + 1) is
// the A layout's, n8 tile 2kk giving a0, a1 and n8 tile 2kk + 1 a2, a3
__device__ __forceinline__ void to_a(const float (&sc)[64],
                                     uint32_t (&pa)[kBN / 16][4]) {
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    pa[j / 2][(j & 1) * 2] = pack_bf16(sc[4 * j], sc[4 * j + 1]);
    pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
  }
}

template <int DP>
__device__ __forceinline__ void rescale(float (&acc)[DP / 2],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    acc[4 * j] *= corr[0];
    acc[4 * j + 1] *= corr[0];
    acc[4 * j + 2] *= corr[1];
    acc[4 * j + 3] *= corr[1];
  }
}

// PP: consumer w's turn at the tensor cores is named barrier 1 + w, which
// it waits on with its 128 threads and the consumer before it (in the
// cycle 0, 1, .., NC - 1) gives with 128
template <bool PP>
__device__ __forceinline__ void turn_begin(int wg) {
  if (PP) bar_sync(1 + wg, 256);
}
template <bool PP, int NC>
__device__ __forceinline__ void turn_end(int wg) {
  if (PP) bar_arrive(1 + (wg + 1) % NC, 256);
}

// OV (intra-warpgroup overlap): tile i's q k^T is issued together with
// tile i - 1's p v, and tile i's softmax runs while that p v does; p is
// converted to bf16 once the p v before it is done, so one set of A
// fragments suffices
template <int DP, int NC, int ST, bool PP, bool OV>
__global__ void __launch_bounds__(Tile<DP, NC, ST>::kThreads,
                                  Tile<DP, NC, ST>::kBlocksPerSM)
    flash_attention_tc_kernel(const __grid_constant__ CUtensorMap map_q,
                              const __grid_constant__ CUtensorMap map_k,
                              const __grid_constant__ CUtensorMap map_v,
                              __nv_bfloat16* __restrict__ o,
                              float* __restrict__ lse, int BH, int H,
                              int Hkv, int Sq, int Skv, int d, int causal,
                              float scale_log2) {
  using T = Tile<DP, NC, ST>;
  static_assert(!PP || NC >= 2, "ping-pong takes turns between consumers");
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles must start on 1024-byte boundaries
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base;                               // q: kBoxes boxes
  const uint32_t sk = sq + T::kQBytes;                    // ST K tiles
  const uint32_t sv = sk + ST * T::kKVBytes;              // ST V tiles
  const uint32_t qbar = sv + ST * T::kKVBytes;
  const uint32_t kfull = qbar + 8, vfull = kfull + 8 * ST;
  const uint32_t empty = vfull + 8 * ST;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int nq = (Sq + T::kBM - 1) / T::kBM;
  // heaviest (last) query tiles first: under the causal mask they walk
  // the most kv tiles
  const int qt = nq - 1 - (int)(blockIdx.x / BH), bh = blockIdx.x % BH;
  const int h = bh % H, b = bh / H, bkv = b * Hkv + h / (H / Hkv);
  const int q0 = qt * T::kBM;
  const int kend = causal ? min(Skv, q0 + T::kBM) : Skv;
  const int nt = (kend + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(kfull + 8 * s, 1);     // the producer's expect_tx
      mbar_init(vfull + 8 * s, 1);
      mbar_init(empty + 8 * s, NC);    // one thread of each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == NC) {
    // ---- producer: one thread loads q and keeps the K / V ring full ------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        T::kProducerRegs));
    if (tid == 0 && nt > 0) {
      mbar_expect_tx(qbar, T::kQBytes);
#pragma unroll
      for (int c = 0; c < T::kBoxes; ++c)
        tma_load_3d(sq + c * T::kBM * 128, &map_q, qbar, 64 * c, q0, bh);
      for (int it = 0; it < nt; ++it) {
        const int s = it % ST, round = it / ST;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        const uint32_t kb = kfull + 8 * s, vb = vfull + 8 * s;
        mbar_expect_tx(kb, T::kKVBytes);
#pragma unroll
        for (int c = 0; c < T::kBoxes; ++c)
          tma_load_3d(sk + s * T::kKVBytes + c * kBN * 128, &map_k, kb,
                      64 * c, it * kBN, bkv);
        mbar_expect_tx(vb, T::kKVBytes);
#pragma unroll
        for (int c = 0; c < T::kBoxes; ++c)
          tma_load_3d(sv + s * T::kKVBytes + c * kBN * 128, &map_v, vb,
                      64 * c, it * kBN, bkv);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        T::kConsumerRegs));
    const int warp = tid / 32, lane = tid % 32;
    const int t = lane % 4;                      // the fragments' lane split
    const int w0 = q0 + wg * 64;                 // the warpgroup's first row
    const int r0 = w0 + warp * 16 + lane / 4;    // this lane's rows: +0, +8
    const uint32_t q_w = sq + wg * 64 * 128;
    // the tiles this warpgroup's rows see: the rest are walked only to
    // release their stages (rows all above their keys, or all past Sq)
    const int ntw = w0 >= Sq ? 0
                    : causal ? min(nt, (min(Skv, w0 + 64) + kBN - 1) / kBN)
                             : nt;
    float acc[DP / 2];                           // o: n8 tile j at 4 j
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc[i] = 0.0f;
    float m[2] = {kMasked, kMasked}, l[2] = {0.0f, 0.0f}, corr[2];
    float sc[64];
    uint32_t pa[kBN / 16][4];
    auto edge = [&](int k0) {
      return k0 + kBN > Skv || (causal && k0 + kBN - 1 > w0);
    };
    auto k_tile = [&](int it) { return sk + (it % ST) * T::kKVBytes; };
    auto v_tile = [&](int it) { return sv + (it % ST) * T::kKVBytes; };
    auto wait_k = [&](int it) {
      mbar_wait(kfull + 8 * (it % ST), (it / ST) & 1);
    };
    auto wait_v = [&](int it) {
      mbar_wait(vfull + 8 * (it % ST), (it / ST) & 1);
    };
    auto release = [&](int it) {
      if (tid == 0) mbar_arrive(empty + 8 * (it % ST));
    };
    if (PP && wg == NC - 1) bar_arrive(1, 256);  // consumer 0 goes first
    if (ntw > 0) mbar_wait(qbar, 0);
    if (!OV) {
      for (int it = 0; it < ntw; ++it) {
        wait_k(it);
        turn_begin<PP>(wg);
        wgmma_fence();
        issue_s<DP>(sc, q_w, T::kBM, k_tile(it));
        wgmma_commit();
        turn_end<PP, NC>(wg);
        wgmma_wait<0>();
        softmax(sc, m, l, corr, edge(it * kBN), it * kBN, r0, t, Skv, causal,
                scale_log2);
        to_a(sc, pa);
        rescale<DP>(acc, corr);
        wait_v(it);
        wgmma_fence();
        issue_o<DP>(acc, pa, v_tile(it));
        wgmma_commit();
        wgmma_wait<0>();
        release(it);
      }
    } else if (ntw > 0) {
      wait_k(0);
      turn_begin<PP>(wg);
      wgmma_fence();
      issue_s<DP>(sc, q_w, T::kBM, k_tile(0));
      wgmma_commit();
      turn_end<PP, NC>(wg);
      wgmma_wait<0>();
      softmax(sc, m, l, corr, edge(0), 0, r0, t, Skv, causal, scale_log2);
      to_a(sc, pa);
      for (int it = 1; it < ntw; ++it) {
        wait_k(it);
        turn_begin<PP>(wg);
        wgmma_fence();
        issue_s<DP>(sc, q_w, T::kBM, k_tile(it));
        wgmma_commit();
        rescale<DP>(acc, corr);                  // tile it - 1's factor
        wait_v(it - 1);
        wgmma_fence();
        issue_o<DP>(acc, pa, v_tile(it - 1));
        wgmma_commit();
        turn_end<PP, NC>(wg);
        wgmma_wait<1>();                         // q k^T of tile it done
        softmax(sc, m, l, corr, edge(it * kBN), it * kBN, r0, t, Skv, causal,
                scale_log2);
        wgmma_wait<0>();                         // p v of tile it - 1 done
        release(it - 1);
        to_a(sc, pa);
      }
      rescale<DP>(acc, corr);
      wait_v(ntw - 1);
      wgmma_fence();
      issue_o<DP>(acc, pa, v_tile(ntw - 1));
      wgmma_commit();
      wgmma_wait<0>();
      release(ntw - 1);
    }
    for (int it = ntw; it < nt; ++it) {          // stages released unread
      wait_k(it);
      wait_v(it);                                // its V lands before reuse
      turn_begin<PP>(wg);                        // the turns kept in step
      turn_end<PP, NC>(wg);
      release(it);
    }
    if (PP && wg == 0) bar_sync(1, 256);  // the last consumer's turn given

    // accumulator layout: n8 tile j of the warp's 16 rows holds (row
    // lane / 4, columns 8 j + 2 (lane % 4) + {0, 1}) and the same 8 rows on
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      float lt = l[hf];
      lt += __shfl_xor_sync(0xffffffffu, lt, 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const int qpos = r0 + 8 * hf;
      if (qpos >= Sq) continue;
      if (lse != nullptr && t == 0)      // m is the quad's, lt its sum
        lse[(size_t)bh * Sq + qpos] =
            (m[hf] > kMasked ? m[hf] * kLn2 : kMasked) +
            logf(fmaxf(lt, 1e-30f));
      lt = 1.0f / fmaxf(lt, 1e-30f);
      __nv_bfloat16* orow = o + ((size_t)bh * Sq + qpos) * d;
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        const int col = 8 * j + 2 * t;   // d % 8 == 0: pairs are whole
        if (col < d)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * hf] * lt,
                                    acc[4 * j + 2 * hf + 1] * lt);
      }
    }
  }
}

// a bf16 [heads, rows, d] tensor in boxes of box_rows x 64 columns, 128-byte
// swizzle; false when the driver refuses it
bool encode(CUtensorMap* map, const void* ptr, int heads, int rows, int d,
            int box_rows) {
  auto fn = cupbop_tensor_map_encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)heads};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int NC, int ST, bool PP, bool OV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Hkv, int Sq, int Skv, int d,
                   int causal, float scale, cudaStream_t stream) {
  using T = Tile<DP, NC, ST>;
  CUtensorMap map_q, map_k = {}, map_v = {};
  if (!encode(&map_q, q, B * H, Sq, d, T::kBM)) return cudaErrorInvalidValue;
  if (Skv > 0 && (!encode(&map_k, k, B * Hkv, Skv, d, kBN) ||
                  !encode(&map_v, v, B * Hkv, Skv, d, kBN)))
    return cudaErrorInvalidValue;
  auto kernel = flash_attention_tc_kernel<DP, NC, ST, PP, OV>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmemBytes);
  if (err != cudaSuccess) return err;
  const long long blocks = (long long)B * H * ((Sq + T::kBM - 1) / T::kBM);
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, T::kThreads, T::kSmemBytes, stream>>>(
      map_q, map_k, map_v, (__nv_bfloat16*)o, lse, B * H, H, Hkv, Sq, Skv, d,
      causal, scale * kLog2e);
  return cudaGetLastError();
}

// The launcher's choice for each padded width, timed by
// tools/flash_attention_tc_variants.cu on an H100 80GB HBM3 at 700 W
// against the design's other shapes (PERF.md gives every time).  At
// DP = 64 three consumers of 64 rows (192 query rows a CTA), four stages,
// PP and OV: 0.329 ms at granite-3-2b's B 2, H 32, Hkv 8, S 4,096 against
// 0.371 for two consumers, two stages and neither step and 0.333 for three
// without the steps.  At DP = 128 two consumers, three stages (224 KB of
// shared memory, the most that fits), PP and OV: 0.0232 ms at
// deepseek-moe-16b's 16 heads of 1,024 tokens against 0.0237 without them.
// OV needs the deeper ring: with two stages it loses at every shape.
template <int DP>
struct Choice;
template <>
struct Choice<64> {
  static constexpr int kNC = 3, kST = 4;
};
template <>
struct Choice<128> {
  static constexpr int kNC = 2, kST = 3;
};

// the query rows a CTA owns at head width d
constexpr int q_tile(int d) {
  return 64 * (d <= 64 ? Choice<64>::kNC : Choice<128>::kNC);
}

template <int DP>
cudaError_t launch_choice(const void* q, const void* k, const void* v,
                          void* o, float* lse, int B, int H, int Hkv, int Sq,
                          int Skv, int d, int causal, float scale,
                          cudaStream_t stream) {
  return launch<DP, Choice<DP>::kNC, Choice<DP>::kST, true, true>(
      q, k, v, o, lse, B, H, Hkv, Sq, Skv, d, causal, scale, stream);
}

}  // namespace flash_tc

// q, k, v and o are bfloat16, 16-byte aligned, with d % 8 == 0,
// 8 <= d <= 128, Sq > 0 and B H > 0 (the wrapper's route and checks;
// refused here as well), and kv_tile is the kernel's keys a tile (128,
// flash_attention.TC_KV_TILE), which the plain version walks: any other is
// refused.  lse: null, or float32 [B, H, Sq] for each row's logsumexp.
extern "C" int launch_flash_attention_tc(const void* q, const void* k,
                                         const void* v, void* o, int B,
                                         int H, int Hkv, int Sq, int Skv,
                                         int d, int causal, float scale,
                                         int kv_tile, void* lse,
                                         void* stream) {
  using namespace flash_tc;
  cudaStream_t s = (cudaStream_t)stream;
  float* ls = (float*)lse;
  const uintptr_t any = reinterpret_cast<uintptr_t>(q) |
                        reinterpret_cast<uintptr_t>(k) |
                        reinterpret_cast<uintptr_t>(v);
  if (d % 8 || d < 8 || d > 128 || any % 16 || Hkv <= 0 || H % Hkv ||
      B <= 0 || H <= 0 || Sq <= 0 || Skv < 0 || kv_tile != kBN)
    return cudaErrorInvalidValue;
  if (d <= 64)
    return launch_choice<64>(q, k, v, o, ls, B, H, Hkv, Sq, Skv, d, causal,
                             scale, s);
  return launch_choice<128>(q, k, v, o, ls, B, H, Hkv, Sq, Skv, d, causal,
                            scale, s);
}

// the query rows a CTA of the kernel owns at head width d
extern "C" int flash_attention_tc_q_tile(int d) { return flash_tc::q_tile(d); }
