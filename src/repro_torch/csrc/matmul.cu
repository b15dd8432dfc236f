// matmul: c[M, N] = a[M, K] @ b[K, N], a float32 accumulator per output,
// cast once to a's dtype (float32, or bfloat16 rounded to nearest even).
// A block of 256 threads owns a 128 x 128 tile of c.  It walks the k axis
// in slices of 16: the block stages a's 128 x 16 and b's 16 x 128 slice in
// __shared__ memory as float32 (bfloat16 widened by __bfloat162float),
// barriers, and each thread adds the slice's products into its 8 x 8
// outputs in registers (fmaf in k order), then barriers again.  Thread
// (ty, tx) of the 16 x 16 grid owns rows ty*4 + {0..3} and 64 + ty*4 +
// {0..3}, and the same split of the columns, so a warp's shared reads of
// b's slice are 16-byte accesses without bank conflicts.  Tiles past M, N
// or K are zero-filled on load and masked on store, so any shape works.
//
// Replaces: the TPU kernel src/repro/kernels/matmul.py:21 (`_kernel`,
// called through `matmul`, src/repro/kernels/matmul.py:39).
//
// Bound on the H100: operations.  2 M N K flops (2.75e11 for the MLP's
// [8192, 2048] @ [2048, 8192]) take 0.278 ms at the tensor cores' 989
// TFLOP/s in bfloat16 and 4.10 ms at 67 TFLOP/s in float32 on the CUDA
// cores; the 201 MB of a, b and c (bfloat16) take 0.060 ms.  The design is
// the classic register-tiled SGEMM on the CUDA cores: each thread does 64
// multiply-adds for every 16 floats it reads from shared memory, and each
// block reads 2 * 128 * K inputs for 128 * 128 * K multiply-adds.  It does
// not reach the bfloat16 bound: the tensor cores (mma / wgmma) and a
// cp.async or TMA pipeline are a later redesign.  The TPU's 128^3 block
// and its grain are not carried over: the wrapper checks the reference's
// block arguments and the kernel takes its own tiles.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    hot_matmul_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ c, int M, int N, int K) {
  __shared__ __align__(16) float sa[kBK][kBM];   // a's slice, k-major
  __shared__ __align__(16) float sb[kBK][kBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // a: 128 rows x 16 k, 8 consecutive k a thread; b: 16 k x 128 columns,
  // 8 consecutive columns a thread
  const int ar = tid / 2, ak = (tid % 2) * 8;
  const int bk = tid / 16, bn = (tid % 16) * 8;
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    const int gm = m0 + ar, gk = k0 + bk;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int ka = k0 + ak + i, gn = n0 + bn + i;
      sa[ak + i][ar] =
          (gm < M && ka < K) ? to_f32(a[(size_t)gm * K + ka]) : 0.0f;
      sb[bk][bn + i] =
          (gk < K && gn < N) ? to_f32(b[(size_t)gk * N + gn]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float av[8], bv[8];
      const float4 a0 = *reinterpret_cast<const float4*>(&sa[k][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&sa[k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&sb[k][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&sb[k][64 + tx * 4]);
      av[0] = a0.x; av[1] = a0.y; av[2] = a0.z; av[3] = a0.w;
      av[4] = a1.x; av[5] = a1.y; av[6] = a1.z; av[7] = a1.w;
      bv[0] = b0.x; bv[1] = b0.y; bv[2] = b0.z; bv[3] = b0.w;
      bv[4] = b1.x; bv[5] = b1.y; bv[6] = b1.z; bv[7] = b1.w;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= M) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (col < N) from_f32(acc[i][j], &c[(size_t)row * N + col]);
    }
  }
}

}  // namespace

// bf16: 0 when a, b and c are float32, 1 when they are bfloat16.
extern "C" int launch_matmul(const void* a, const void* b, void* c, int M,
                             int N, int K, int bf16, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    hot_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (__nv_bfloat16*)c,
        M, N, K);
  } else {
    hot_matmul_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)a, (const float*)b, (float*)c, M, N, K);
  }
  return (int)cudaGetLastError();
}
