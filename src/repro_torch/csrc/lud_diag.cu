// lud_diag: the diagonal-tile step of Rodinia lud.  Logical block t
// LU-factors (Doolittle, no pivoting) its own b x b tile of `a` and writes
// L\U to `lu`.  At step k = 0 .. b-2 every row i > k takes
// m = s[i][k] / s[k][k], then s[i][c] -= m * u_c for every c != k, with
// u_c = s[k][c] for c > k and 0 for c < k, then s[i][k] = m; rows i <= k
// keep their values.  So an infinite or NaN m turns the row's columns
// c < k into NaN, and a -0 there under a negative m into +0, as the
// reference's step does.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`)
// applied to make_lud_diag (src/repro/core/cuda_suite.py:620).
//
// Bound on the H100: latency.  The bytes (2 x 128 KB at 128 tiles of 16)
// take 0.08 us; the time is the chain of b - 1 dependent steps.  The
// reference's design (one thread a row of a __shared__ tile, a barrier a
// step) made every load of a step wait on the store before it.  Here a
// tile lives in one warp's registers:
//   - P, the smallest power of two >= b, lanes hold a tile: lane jP + i
//     holds row i of the warp's tile j in registers r[0, MB), MB the
//     smallest of 4, 8, 16, 32 that is >= b (the launcher dispatches on
//     it; b stays a runtime argument), so that every register index is a
//     compile-time constant once k and c are unrolled over MB;
//   - a warp holds 32 / P tiles, a CTA kWarps = 1 warp (lud_diag_cta_tiles;
//     lower_cuda.lud_diag_ctas gives the CTA count: 64 at 128 tiles of 16);
//   - step k shuffles the pivot row's r[k], and each r[c] for c > k, from
//     lane k of the segment; lanes below the pivot apply the rule above
//     with __fdiv_rn, __fmul_rn and __fsub_rn in the plain version's
//     order, so nvcc contracts nothing and the result is the plain
//     version's bit for bit.  No barrier and no shared memory: the
//     critical path of a step is a shuffle, the division, one
//     product-difference and the next step's shuffle;
//   - a live lane loads and stores its row as float4s when b % 4 == 0 and
//     both buffers lie on 16-byte boundaries, a float at a time otherwise.
//     Lanes past b, and segments past the grid's tiles, run every shuffle
//     and touch no memory, so the tiles past the grid keep lu's input.
// tools/lud_diag_variants.cu times this beside the old kernel, an empty
// launch and a copy of the same CTAs, one tile a warp, 1 to 8 warps a CTA,
// and the first text of this design.  On an NVIDIA H100 80GB HBM3 at 700 W,
// at 128 tiles of 16: the old kernel 0.0118 ms, an empty launch 0.0049, the
// copy 0.0052, this kernel 0.0060 (51 registers, no spills); one tile a
// warp the same, 4 and 8 warps a CTA 5 % and 19 % slower (fewer SMs, more
// warps on each).  The first text, its steps and columns kept
// to b by runtime guards, took 0.0075: the guards cut the steps into
// blocks nvcc could not schedule across.  At 64 tiles of 32: 0.0091
// against the old 0.0236 (80 registers, no spills).
#include <cstdint>

#include <cuda_runtime.h>

#define LUD_MAX_B 32

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 1;                  // a CTA

// The lanes a tile of b rows takes: the smallest power of two >= b.
inline int tile_lanes(int b) {
  int p = 1;
  while (p < b) p <<= 1;
  return p;
}

// Tile (CTA x W + warp) per_warp + j sits in segment j of the warp, lanes
// [j lanes, (j + 1) lanes); tiles: the tiles the launch factors.  The
// steps run over all MB columns and MB - 1 pivots whatever b is: a column
// c >= b never feeds a column below b and is never stored, and a step
// k >= b - 1 has no live row below its pivot, so it changes nothing.  So
// no guard on b splits the steps into blocks, and nvcc schedules a step's
// shuffles and updates across them.  Idle lanes hold 1.0 and change
// nothing, so their divisions stay off the slow path.
template <int MB, bool VEC>
__global__ void __launch_bounds__(256)
    lud_diag_warp(const float* __restrict__ a, float* __restrict__ lu,
                  int b, int tiles, int lanes, int per_warp) {
  const int lane = threadIdx.x & 31;
  const int seg = lane / lanes, i = lane % lanes;
  const long long t =
      ((long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) *
          per_warp + seg;
  const bool live = seg < per_warp && t < tiles && i < b;
  const size_t row = ((size_t)t * b + i) * b;
  float r[MB];
#pragma unroll
  for (int c = 0; c < MB; ++c) r[c] = 1.0f;
  if (live) {
    if (VEC) {
#pragma unroll
      for (int c = 0; c < MB; c += 4)
        if (c < b) {
          const float4 v = *reinterpret_cast<const float4*>(a + row + c);
          r[c] = v.x, r[c + 1] = v.y, r[c + 2] = v.z, r[c + 3] = v.w;
        }
    } else {
#pragma unroll
      for (int c = 0; c < MB; ++c)
        if (c < b) r[c] = a[row + c];
    }
  }
#pragma unroll
  for (int k = 0; k < MB - 1; ++k) {
    const float piv = __shfl_sync(kFull, r[k], k, lanes);
    float u[MB];
#pragma unroll
    for (int c = k + 1; c < MB; ++c) u[c] = __shfl_sync(kFull, r[c], k, lanes);
    // every lane computes; a row at or above the pivot, or an idle lane,
    // keeps its values by a select, not a branch
    const bool below = live && i > k;
    const float m = __fdiv_rn(r[k], piv);
    const float z = __fmul_rn(m, 0.0f);    // m u_c for every c < k
#pragma unroll
    for (int c = k + 1; c < MB; ++c) {
      const float v = __fsub_rn(r[c], __fmul_rn(m, u[c]));
      r[c] = below ? v : r[c];
    }
#pragma unroll
    for (int c = 0; c < k; ++c) {
      const float v = __fsub_rn(r[c], z);
      r[c] = below ? v : r[c];
    }
    r[k] = below ? m : r[k];
  }
  if (live) {
    if (VEC) {
#pragma unroll
      for (int c = 0; c < MB; c += 4)
        if (c < b)
          *reinterpret_cast<float4*>(lu + row + c) =
              make_float4(r[c], r[c + 1], r[c + 2], r[c + 3]);
    } else {
#pragma unroll
      for (int c = 0; c < MB; ++c)
        if (c < b) lu[row + c] = r[c];
    }
  }
}

template <int MB>
void start_at(const float* a, float* lu, int b, int tiles, int ctas,
              int warps, int per_warp, bool vec, cudaStream_t s) {
  const int lanes = tile_lanes(b);
  if (vec)
    lud_diag_warp<MB, true><<<ctas, 32 * warps, 0, s>>>(a, lu, b, tiles,
                                                        lanes, per_warp);
  else
    lud_diag_warp<MB, false><<<ctas, 32 * warps, 0, s>>>(a, lu, b, tiles,
                                                         lanes, per_warp);
}

// ctas CTAs of `warps` warps, per_warp tiles a warp (32 / P or 1), over
// the first `tiles` tiles of b rows, 1 <= b <= LUD_MAX_B.
void start(const float* a, float* lu, int b, int tiles, int ctas, int warps,
           int per_warp, cudaStream_t s) {
  const bool vec = b % 4 == 0 &&
                   ((std::uintptr_t)a | (std::uintptr_t)lu) % 16 == 0;
  if (b <= 4)
    start_at<4>(a, lu, b, tiles, ctas, warps, per_warp, vec, s);
  else if (b <= 8)
    start_at<8>(a, lu, b, tiles, ctas, warps, per_warp, vec, s);
  else if (b <= 16)
    start_at<16>(a, lu, b, tiles, ctas, warps, per_warp, vec, s);
  else
    start_at<32>(a, lu, b, tiles, ctas, warps, per_warp, vec, s);
}

}  // namespace

// The tiles of b rows one CTA of launch_lud_diag holds;
// lower_cuda.lud_diag_ctas gives the CTA count from it.
extern "C" int lud_diag_cta_tiles(int b) {
  return kWarps * (32 / tile_lanes(b));
}

// grid: the chevron's, a block a tile; ctas: CTAs of lud_diag_cta_tiles
// tiles that cover those grid tiles.
extern "C" int launch_lud_diag(const float* a, float* lu, int b, int grid,
                               int ctas, void* stream) {
  if (b < 1 || b > LUD_MAX_B ||
      (long long)ctas * lud_diag_cta_tiles(b) < grid)
    return (int)cudaErrorInvalidValue;
  start(a, lu, b, grid, ctas, kWarps, 32 / tile_lanes(b),
        (cudaStream_t)stream);
  return (int)cudaGetLastError();
}
