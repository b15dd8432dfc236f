// matmul_tiled: c[m, n] = a[m, k] @ b[k, n], written where the logical
// grid covers c.  The reference's launch is one 64-thread block per 8 x 8
// output tile, logical block bid = by * (n/8) + bx owning tile (by, bx),
// and it accumulates one 8-deep k-tile at a time: acc + (the tile's
// 8-term dot product).
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_matmul_tiled
// (src/repro/core/cuda_suite.py:196).
//
// Bound on the H100: operations.  2 m n k flops (1.72e10 at 2048^3) over
// 67 TFLOP/s of float32 outside the tensor cores is 0.256 ms; the 50 MB
// of a, b and c take 0.015 ms.  Full float32 on the CUDA cores: TF32's
// ten mantissa bits would not hold matmul_tol(k), so neither the tensor
// cores nor wgmma take this product.  The reference's 8 x 8 tile reads
// 2 * 64 floats for 1024 flops behind two barriers a k-tile, so here a
// physical CTA of 256 threads owns 128 x 128 of c (16 x 16 logical
// tiles) and each thread 8 x 8 outputs in registers:
// - k runs in slices of 16, two of the reference's 8-deep k-tiles (a
//   last slice of one k-tile where k/8 is odd).  Two __shared__ buffers:
//   the next slice's global loads (a float4 of a and one of b a k-tile
//   and thread) are issued into registers before the current slice is
//   computed and stored into the other buffer after it, and one barrier
//   a slice separates them (tools/matmul_tiled_variants.cu times slices
//   of one k-tile against two);
// - a's slice is stored k-major (transposed on the store, rows padded by
//   4 floats: the stores are free of bank conflicts), so the inner loop
//   reads float4s of both operands; thread (ty, tx) of the 16 x 16 grid
//   owns rows ty*4 + {0..3} and 64 + ty*4 + {0..3} and the same split of
//   the columns, which keeps b's float4 reads free of bank conflicts.
// Rounding is the reference's per k-tile: an 8-deep fmaf chain from 0
// into a partial, then one __fadd_rn of the partial into the accumulator
// (the reference's einsum fixes no order inside a tile).  That costs one
// FADD per 8 FMAs (0.288 ms at 2048^3) and 64 registers for the
// partials; c agrees with the plain version and the oracle within the
// entry's tolerance, not bit for bit.
//
// Physical to logical: the chevron's grid and block stay the entry's
// (65,536 blocks of 64 at 2048^3).  The wrapper gives the launcher a
// physical grid of ceil(n/128) x ceil(tile rows the grid reaches / 16)
// CTAs (lower_cuda.matmul_tiled_ctas; 256 CTAs at 2048^3, 1.94 waves on
// 132 SMs).  Rows and columns past m or n are zeroed on their way into
// shared memory and masked on store, and an output is stored only where its logical tile
// (row/8) * (n/8) + col/8 is below the grid; the wrapper keeps c
// elsewhere, as the reference does.  m, n, k are runtime arguments.
//
// Alignment: the float4 loads and stores need 16-byte bases (the rows
// are: k and n are multiples of 8).  The wrapper checks only that the
// buffers are contiguous, so a view at an odd offset can reach the
// launcher; it then starts the instantiation that moves the same float4
// groups as four scalar accesses each.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kBM = 128, kBN = 128, kThreads = 256;
constexpr int kTile = 8;          // the reference's k-tile
constexpr int kTiles = 2;         // k-tiles a slice
constexpr int kBK = kTile * kTiles;
constexpr int kPadA = 4;          // a's k-major rows: 132 floats, 16-byte aligned

template <bool kVec>
__device__ __forceinline__ float4 load4(const float* p) {
  if (kVec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

template <bool kVec>
__device__ __forceinline__ void store4(float* p, float x, float y, float z,
                                       float w) {
  if (kVec) {
    *reinterpret_cast<float4*>(p) = make_float4(x, y, z, w);
  } else {
    p[0] = x; p[1] = y; p[2] = z; p[3] = w;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads, 1)
    matmul_tiled_kernel(const float* __restrict__ a,
                        const float* __restrict__ b, float* __restrict__ c,
                        int m, int n, int k, int grid) {
  __shared__ __align__(16) float sa[2][kBK][kBM + kPadA];   // k-major
  __shared__ __align__(16) float sb[2][kBK][kBN];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  // each k-tile's loads: a's row ar, k's ak..ak+3; b's k row bk, columns
  // bn..bn+3 (n is a multiple of 8, so the four are all in or all out).
  // The addresses are clamped into the buffers and the loads issued
  // unconditionally, so that they go out ahead of the slice's compute;
  // what lies past m, n or k is zeroed when it is stored to shared memory.
  const int ar = tid / 2, ak = (tid % 2) * 4;
  const int bk = tid / 32, bn = (tid % 32) * 4;
  const bool a_in = m0 + ar < m, b_in = n0 + bn < n;
  const float* ap = a + (size_t)min(m0 + ar, m - 1) * k + ak;
  const float* bp = b + (size_t)bk * n + min(n0 + bn, n - 4);
  float4 ra[kTiles], rb[kTiles];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      const int kt = min(k0 + t * kTile, k - kTile);
      ra[t] = load4<kVec>(ap + kt);
      rb[t] = load4<kVec>(bp + (size_t)kt * n);
    }
  };
  auto stash = [&](int buf, int k0) {
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      const bool in = k0 + t * kTile < k;
      const float4 va = a_in && in ? ra[t] : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 vb = b_in && in ? rb[t] : make_float4(0.f, 0.f, 0.f, 0.f);
      float* col = &sa[buf][t * kTile + ak][ar];
      col[0 * (kBM + kPadA)] = va.x;
      col[1 * (kBM + kPadA)] = va.y;
      col[2 * (kBM + kPadA)] = va.z;
      col[3 * (kBM + kPadA)] = va.w;
      *reinterpret_cast<float4*>(&sb[buf][t * kTile + bk][bn]) = vb;
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
  for (int k0 = 0, cur = 0; k0 < k; k0 += kBK, cur ^= 1) {
    const bool next = k0 + kBK < k;
    if (next) fetch(k0 + kBK);
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      if (t > 0 && k0 + t * kTile >= k) break;   // k/8 odd: a last half slice
      float part[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) part[i][j] = 0.0f;
#pragma unroll
      for (int kk = t * kTile; kk < (t + 1) * kTile; ++kk) {
        const float4 a0 =
            *reinterpret_cast<const float4*>(&sa[cur][kk][ty * 4]);
        const float4 a1 =
            *reinterpret_cast<const float4*>(&sa[cur][kk][64 + ty * 4]);
        const float4 b0 =
            *reinterpret_cast<const float4*>(&sb[cur][kk][tx * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&sb[cur][kk][64 + tx * 4]);
        const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            part[i][j] = fmaf(av[i], bv[j], part[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          acc[i][j] = __fadd_rn(acc[i][j], part[i][j]);
    }
    if (next) stash(cur ^ 1, k0 + kBK);
    __syncthreads();
  }

  const int ntn = n / 8;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (row >= m) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int col = n0 + h * 64 + tx * 4;   // four columns of one tile
      if (col >= n || (row / 8) * ntn + col / 8 >= grid) continue;
      store4<kVec>(c + (size_t)row * n + col, acc[i][h * 4],
                   acc[i][h * 4 + 1], acc[i][h * 4 + 2], acc[i][h * 4 + 3]);
    }
  }
}

}  // namespace

// grid: the logical grid (at most (m/8) * (n/8), the wrapper's check);
// ctas_x, ctas_y: the physical grid that covers it.
extern "C" int launch_matmul_tiled(const float* a, const float* b, float* c,
                                   int m, int n, int k, int grid, int ctas_x,
                                   int ctas_y, void* stream) {
  const dim3 ctas(ctas_x, ctas_y);
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = (((uintptr_t)a | (uintptr_t)b | (uintptr_t)c) & 15) == 0;
  if (vec) {
    matmul_tiled_kernel<true><<<ctas, kThreads, 0, s>>>(a, b, c, m, n, k,
                                                        grid);
  } else {
    matmul_tiled_kernel<false><<<ctas, kThreads, 0, s>>>(a, b, c, m, n, k,
                                                         grid);
  }
  return (int)cudaGetLastError();
}
