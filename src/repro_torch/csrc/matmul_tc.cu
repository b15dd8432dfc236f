// matmul_tc: c[M, N] = a[M, K] @ b[K, N] in bfloat16 on Hopper's tensor
// cores: wgmma.mma_async m64n256k16 on bf16 operands read from shared
// memory, float32 accumulators in registers, each sum rounded once to
// bfloat16 (round to nearest even).  bf16 x bf16 products are exact in
// float32, so the sums differ from the plain version's only in order.
//
// A block of three warpgroups owns a 128 x 256 tile of c.  Warpgroup 2 is
// the producer: after `setmaxnreg` drops its registers to 40, one thread
// keeps a ring of kStages (4) stages in flight, each a 64-deep k slice of
// a (128 x 64) and of b (64 x 256, as four 64 x 64 boxes), loaded by TMA
// with 128-byte swizzle and completing on the stage's `full` mbarrier.
// Warpgroups 0 and 1 are the consumers (registers raised to 232): each
// owns 64 rows of the tile, waits for a stage, issues four wgmma k16
// steps on it, waits for them, and releases the stage on its `empty`
// mbarrier; its 128 float32 accumulators a thread are stored at the end.
//
// Replaces: the TPU kernel src/repro/kernels/matmul.py:21 (`_kernel`,
// called through `matmul`, src/repro/kernels/matmul.py:39), for bfloat16
// operands that TMA can address (`matmul.route` is "tc"); the others run
// csrc/matmul.cu.
//
// Bound on the H100: operations.  2 M N K flops (2.75e11 for the MLP's
// [8192, 2048] @ [2048, 8192]) take 0.278 ms at the tensor cores' 989
// TFLOP/s in bfloat16; the 201 MB of a, b and c take 0.060 ms.  The
// design is the usual Hopper GEMM: TMA feeds a multi-stage ring so that
// loads overlap the products, and wgmma reads both operands from the
// swizzled shared tiles, so no register or instruction is spent on the
// copies.  Each block reads 2 * 64 * (128 + 256) bytes a k slice for
// 2 * 128 * 256 * 64 flops: 85 flops a byte of shared memory.
//
// Where it can go wrong, and what this file does about it:
// * The tensor map: cuTensorMapEncodeTiled is a driver function and the
//   library links only the runtime, so it is fetched once with
//   cudaGetDriverEntryPoint and called on the host for every launch (the
//   pointers change); the map reaches the kernel as a
//   `const __grid_constant__ CUtensorMap` parameter.
// * TMA alignment: the global address must be 16-byte aligned and the row
//   strides multiples of 16 bytes (K % 8 == 0 and N % 8 == 0).  The
//   wrapper's `route` sends any other shape or view to csrc/matmul.cu;
//   the launcher refuses them too.  Boxes past M, N or K arrive
//   zero-filled, which covers the ragged edges; stores past M or N are
//   masked.
// * The layout of b: b is [K, N] with N contiguous, an MN-major B operand.
//   The wgmma's transpose-B bit is set, and its descriptor gives the
//   stride between the four 64-column chunks of a 256-wide tile (LBO,
//   8192 bytes: one 64 x 64 box) and between groups of 8 k rows (SBO, 1024
//   bytes); a's K-major descriptor steps 32 bytes per k16 inside the
//   128-byte swizzle atom, b's 2048 bytes (16 rows of 128 bytes).  The
//   gpu tests with non-square shapes catch a transposed or mis-strided b
//   (exchanged LBO and SBO give wrong sums).
// * The swizzle: TMA's CU_TENSOR_MAP_SWIZZLE_128B and the descriptors'
//   layout type 1 (128B) must match, and each tile starts on a 1024-byte
//   boundary (the dynamic shared memory is aligned by hand).
#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128, kBN = 256, kBK = 64, kStages = 4;
constexpr int kThreads = 384;                      // 2 consumers, 1 producer
constexpr int kABytes = kBM * kBK * 2;             // 16 KB a stage
constexpr int kBBytes = kBK * kBN * 2;             // 32 KB a stage
constexpr int kBoxBytes = kBK * 64 * 2;            // one 64 x 64 box of b
constexpr int kSmemBytes = kStages * (kABytes + kBBytes) + 1024 /* align */
                           + 2 * kStages * 8;      // mbarriers

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

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// a wgmma shared-memory descriptor, 128-byte swizzle (layout type 1)
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_m64n256k16(float* d, uint64_t da,
                                              uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n"
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
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}


__global__ void __launch_bounds__(kThreads, 1)
    matmul_tc_kernel(const __grid_constant__ CUtensorMap map_a,
                     const __grid_constant__ CUtensorMap map_b,
                     __nv_bfloat16* __restrict__ c, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles must start on 1024-byte boundaries
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sa = base;                             // kStages a tiles
  const uint32_t sb = base + kStages * kABytes;         // kStages b tiles
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      smem + kStages * (kABytes + kBBytes));
  const uint32_t full = smem_u32(bars), empty = full + kStages * 8;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int m0 = blockIdx.x * kBM, n0 = blockIdx.y * kBN;
  const int nk = (K + kBK - 1) / kBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + 8 * s, 1);      // the producer's expect_tx
      mbar_init(empty + 8 * s, 2);     // one thread of each consumer
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full -----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kStages, round = kt / kStages;
        if (round > 0) mbar_wait(empty + 8 * s, (round - 1) & 1);
        const uint32_t bar = full + 8 * s;
        mbar_expect_tx(bar, kABytes + kBBytes);
        tma_load_2d(sa + s * kABytes, &map_a, bar, kt * kBK, m0);
#pragma unroll
        for (int j = 0; j < kBN / 64; ++j)
          tma_load_2d(sb + s * kBBytes + j * kBoxBytes, &map_b, bar,
                      n0 + 64 * j, kt * kBK);
      }
    }
  } else {
    // ---- consumers: 64 rows of the tile each -----------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    float acc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) acc[i] = 0.0f;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % kStages;
      mbar_wait(full + 8 * s, (kt / kStages) & 1);
      const uint32_t a_tile = sa + s * kABytes + wg * 64 * 128;
      const uint32_t b_tile = sb + s * kBBytes;
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t da = make_desc(a_tile + kk * 32, 16, 1024);
        const uint64_t db = make_desc(b_tile + kk * 2048, kBoxBytes, 1024);
        wgmma_m64n256k16(acc, da, db);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      if (tid == 0) mbar_arrive(empty + 8 * s);
    }
    // accumulator layout: n8 tile j of the warp's 16 rows holds (row
    // lane / 4, columns 8 j + 2 (lane % 4) + {0, 1}) and the same 8 rows on
    const int warp = tid / 32, lane = tid % 32;
    const int row = m0 + wg * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + j * 8 + (lane % 4) * 2;
      if (col >= N) continue;          // N % 8 == 0: a pair never straddles
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row + 8 * h;
        if (r < M)
          *reinterpret_cast<__nv_bfloat162*>(c + (size_t)r * N + col) =
              __floats2bfloat162_rn(acc[4 * j + 2 * h],
                                    acc[4 * j + 2 * h + 1]);
      }
    }
  }
}

}  // namespace

// cuTensorMapEncodeTiled, fetched once from the driver (the library links
// only the runtime), or null; csrc/flash_attention_tc.cu encodes its maps
// with it too
PFN_cuTensorMapEncodeTiled_v12000 cupbop_tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

namespace {

// a row-major bf16 [rows, cols] tensor in boxes of box_rows x 64 columns
bool encode(CUtensorMap* map, const void* ptr, int rows, int cols,
            int box_rows) {
  auto fn = cupbop_tensor_map_encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// a, b and c are bfloat16; K % 8 == 0, N % 8 == 0 and a, b 16-byte
// aligned (the wrapper's route checks; refused here as well).
extern "C" int launch_matmul_tc(const void* a, const void* b, void* c, int M,
                                int N, int K, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % 8 || N % 8 ||
      reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  if (!encode(&map_a, a, M, K, kBM) || !encode(&map_b, b, K, N, kBK))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      matmul_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + kBM - 1) / kBM, (N + kBN - 1) / kBN);
  if (grid.y > 65535) return (int)cudaErrorInvalidConfiguration;
  matmul_tc_kernel<<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      map_a, map_b, (__nv_bfloat16*)c, M, N, K);
  return (int)cudaGetLastError();
}
