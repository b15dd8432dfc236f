// matmul: c[M, N] = a[M, K] @ b[K, N], a float32 accumulator per output,
// cast once to a's dtype (float32, or bfloat16 rounded to nearest even).
// A CTA of 256 threads owns a 128 x 128 tile of c; thread (ty, tx) of its
// 16 x 16 grid owns the 8 x 8 outputs of rows ty*4 + {0..3} and 64 +
// ty*4 + {0..3} and the same split of the columns, in registers, so a
// warp's shared reads of b's slice are 16-byte accesses without bank
// conflicts.  The CTA walks the k axis in slices of 16, and each output is
// one fmaf chain in k order from 0.
//
// Replaces: the TPU kernel src/repro/kernels/matmul.py:21 (`_kernel`,
// called through `matmul`, src/repro/kernels/matmul.py:39).
//
// Bound on the H100: operations.  2 M N K flops (2.75e11 for the MLP's
// [8192, 2048] @ [2048, 8192]) take 4.10 ms at 67 TFLOP/s in float32 on
// the CUDA cores; the 201 MB of a, b and c (float32) take 0.060 ms.  Full
// float32: TF32's ten mantissa bits would not hold matmul_tol, so the
// tensor cores do not take this product (bfloat16 that TMA can address
// runs csrc/matmul_tc.cu; what reaches this kernel in bfloat16 is widened
// by __bfloat162float).  Each thread does 64 multiply-adds for every 16
// floats it reads from shared memory, and each CTA reads 2 * 128 * K
// inputs for 128 * 128 * K multiply-adds.  The data movement keeps the
// CUDA cores fed (matmul_tiled.cu's pipeline, without its per-k-tile
// rounding):
// - each slice's global loads are two 16-byte float4s of a and two of b a
//   thread (a: rows r = tid % 16 + 16 (tid / 32), k offsets 4 ((tid / 16)
//   % 2) + {0, 8}, so a warp reads 16 rows x 32 bytes; b: k rows tid / 32
//   + {0, 8}, columns 4 (tid % 32), a warp 512 contiguous bytes);
// - the loads are issued unconditionally, the next slice's into registers
//   before the current slice is computed (only K >= 1 is launched, so the
//   first slice always exists); two __shared__ buffers and one barrier a
//   slice;
// - a's slice is stored k-major (transposed on the store, rows padded by
//   4 floats, which makes the 16-row x 2-offset pattern of a warp's stores
//   free of bank conflicts), so the inner loop reads float4s of both;
// - 33,280 bytes of shared memory and __launch_bounds__(256, 2): at most
//   128 registers, so two CTAs share an SM and one's barriers and loads
//   overlap the other's FMAs.  Left to itself nvcc may take more, and
//   then only one CTA fits an SM.
// tools/matmul_variants.cu times this beside the kernel it replaced and
// variants of its design (no bound, the first slice behind a guard,
// slices of 8, CTA tiles of 256 x 128 with 16 x 8 outputs a thread);
// PERF.md has what each cost on an H100.
//
// Instantiations, chosen by the launcher:
// - whole tiles: float32 with M and N multiples of 128, K of 16, and a, b
//   and c on 16-byte boundaries (the main path's shapes) moves 16 bytes
//   an access and clamps and masks nothing;
// - float32 with K % 4 == 0, N % 4 == 0 and the three bases 16-byte
//   aligned moves 16 bytes an access; the addresses are clamped into the
//   buffers, and what lies past M, N or K is zeroed when it is stored to
//   shared memory;
// - every other call (bfloat16; N % 4 or K % 4 != 0; a view at an odd
//   offset) moves the same groups of four one element at a time, each
//   load predicated on its own index, so any shape works.
// The TPU's 128^3 block and its grain are not carried over: the wrapper
// checks the reference's block arguments and the kernel takes its own
// tiles.
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

constexpr int kBM = 128, kBN = 128, kBK = 16, kThreads = 256;
constexpr int kPadA = 4;   // a's k-major rows: 132 floats, 16-byte aligned

// row[i .. i+3] as float: one 16-byte load at an index clamped below lim
// (kVec: float32, lim and i multiples of 4, row 16-byte aligned), else
// four loads, each of an index at or past lim replaced by 0.  The caller
// zeroes what lies at or past lim.
template <bool kVec, typename T>
__device__ __forceinline__ float4 load4(const T* row, int i, int lim) {
  if constexpr (kVec) {
    return __ldg(reinterpret_cast<const float4*>(row + min(i, lim - 4)));
  } else {
    return make_float4(i < lim ? to_f32(row[i]) : 0.0f,
                       i + 1 < lim ? to_f32(row[i + 1]) : 0.0f,
                       i + 2 < lim ? to_f32(row[i + 2]) : 0.0f,
                       i + 3 < lim ? to_f32(row[i + 3]) : 0.0f);
  }
}

// v with the elements i + e at or past lim, or all where !in, zeroed
__device__ __forceinline__ float4 mask4(float4 v, bool in, int i, int lim) {
  return make_float4(in && i < lim ? v.x : 0.0f,
                     in && i + 1 < lim ? v.y : 0.0f,
                     in && i + 2 < lim ? v.z : 0.0f,
                     in && i + 3 < lim ? v.w : 0.0f);
}

// kWhole (float32, kVec): M, N multiples of 128 and K of 16, so nothing
// is clamped or masked
template <typename T, bool kVec, bool kWhole>
__global__ void __launch_bounds__(kThreads, 2)
    hot_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ c, int M, int N, int K) {
  __shared__ __align__(16) float sa[2][kBK][kBM + kPadA];   // k-major
  __shared__ __align__(16) float sb[2][kBK][kBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // a: row ar, k offsets ak + {0, 8}; b: k rows bk + {0, 8}, columns
  // bn .. bn + 3
  const int ar = tid % 16 + 16 * (tid / 32), ak = 4 * ((tid / 16) % 2);
  const int bk = tid / 32, bn = 4 * (tid % 32);
  float4 ra[kBK / 8], rb[kBK / 8];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      if constexpr (kWhole) {
        ra[j] = __ldg(reinterpret_cast<const float4*>(
            a + (size_t)(m0 + ar) * K + k0 + ak + 8 * j));
        rb[j] = __ldg(reinterpret_cast<const float4*>(
            b + (size_t)(k0 + bk + 8 * j) * N + n0 + bn));
      } else {
        const int ka = k0 + ak + 8 * j, kb = k0 + bk + 8 * j;
        ra[j] = load4<kVec>(a + (size_t)min(m0 + ar, M - 1) * K, ka, K);
        rb[j] = load4<kVec>(b + (size_t)min(kb, K - 1) * N, n0 + bn, N);
      }
    }
  };
  auto stash = [&](int buf, int k0) {
#pragma unroll
    for (int j = 0; j < kBK / 8; ++j) {
      const float4 va =
          kWhole ? ra[j] : mask4(ra[j], m0 + ar < M, k0 + ak + 8 * j, K);
      sa[buf][ak + 8 * j][ar] = va.x;
      sa[buf][ak + 8 * j + 1][ar] = va.y;
      sa[buf][ak + 8 * j + 2][ar] = va.z;
      sa[buf][ak + 8 * j + 3][ar] = va.w;
      *reinterpret_cast<float4*>(&sb[buf][bk + 8 * j][bn]) =
          kWhole ? rb[j] : mask4(rb[j], k0 + bk + 8 * j < K, n0 + bn, N);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  fetch(0);
  stash(0, 0);
  __syncthreads();
  for (int k0 = 0, cur = 0; k0 < K; k0 += kBK, cur ^= 1) {
    const bool next = k0 + kBK < K;
    if (next) fetch(k0 + kBK);
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&sa[cur][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&sa[cur][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sb[cur][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&sb[cur][k][64 + tx * 4]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (next) stash(cur ^ 1, k0 + kBK);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + 64 * (i / 4) + ty * 4 + i % 4;
    if (!kWhole && row >= M) continue;
    T* crow = c + (size_t)row * N;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;    // four columns
      if constexpr (kVec) {
        if (kWhole || col < N)
          *reinterpret_cast<float4*>(crow + col) =
              make_float4(acc[i][h * 4], acc[i][h * 4 + 1],
                          acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < N) from_f32(acc[i][h * 4 + e], crow + col + e);
      }
    }
  }
}

// the launch's grid: one CTA a 128 x 128 tile of c, the ragged ones too
dim3 grid_of(int M, int N) {
  return dim3((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
}

// one launch of hot_matmul_kernel<T, kVec, kWhole> over c
template <typename T, bool kVec, bool kWhole = false>
cudaError_t start(const void* a, const void* b, void* c, int M, int N,
                  int K, cudaStream_t s) {
  hot_matmul_kernel<T, kVec, kWhole><<<grid_of(M, N), kThreads, 0, s>>>(
      (const T*)a, (const T*)b, (T*)c, M, N, K);
  return cudaGetLastError();
}

}  // namespace

// The CTAs that launch_matmul starts for c[M, N].
extern "C" int matmul_ctas(int M, int N) {
  const dim3 g = grid_of(M, N);
  return (int)(g.x * g.y);
}

// bf16: 0 when a, b and c are float32, 1 when they are bfloat16.  M, N
// and K are at least 1 (the wrapper refuses empty blocks); any other call
// is refused with cudaErrorInvalidValue.
extern "C" int launch_matmul(const void* a, const void* b, void* c, int M,
                             int N, int K, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (M < 1 || N < 1 || K < 1) return (int)cudaErrorInvalidValue;
  const bool vec = !bf16 && K % 4 == 0 && N % 4 == 0 &&
                   (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) & 15) == 0;
  if (bf16) return (int)start<__nv_bfloat16, false>(a, b, c, M, N, K, s);
  if (vec && M % kBM == 0 && N % kBN == 0 && K % kBK == 0)
    return (int)start<float, true, true>(a, b, c, M, N, K, s);
  if (vec) return (int)start<float, true>(a, b, c, M, N, K, s);
  return (int)start<float, false>(a, b, c, M, N, K, s);
}
