// softmax_row: y = exp(x - max) / sum(exp(x - max)) over each row of
// x[rows, width] that the logical grid covers (width = the chevron's block
// B).  In the reference one block of B threads takes one row: each thread
// holds one value; the max is taken over the block behind a barrier, then
// each thread's p = exp(x - max), then the sum of p behind a second
// barrier, then p / sum.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_softmax_row
// (src/repro/core/cuda_suite.py:316).
//
// Bound on the H100: memory.  x is read once and y written once (134 MB at
// 131,072 x 128): 0.040 ms at 3.35 TB/s; the 1.7e7 exps on the
// special-function units take 0.004 ms.  A block a row of one value a
// thread costs the card a block's launch and retirement for 512 bytes, and
// two barriers; here one warp is one logical block, in physical CTAs of
// 256 threads, with no shared memory and no barrier:
// - lane l holds the row's V = B/32 values in registers, all loaded before
//   the first fmaxf: at B = 128 one 16-byte float4 a lane, so a row is one
//   coalesced 512-byte warp load; float4 loads whenever V % 4 == 0, float2
//   when V % 2 == 0, else one float each (value j of lane l is
//   x[W (l + 32 (j / W)) + j % W] for W-wide accesses);
// - the max over the lane's registers, then a __shfl_xor_sync butterfly;
// - p = expf(x - max) per value, their sum over the registers in order,
//   then a butterfly of __fadd_rn;
// - y = p / sum (IEEE division), stored as the values were loaded.
// tools/softmax_row_variants.cu times this beside two and four rows a
// warp (all their loads issued first): on an H100 neither was faster
// (PERF.md), so a warp takes one row.
// The max is order-free, so it is the reference's; the sum takes another
// order than the reference's (and the plain version's), so y agrees with
// both and with the oracle within the entry's tolerance (2e-5), not bit
// for bit.  expf (not __expf) and IEEE division: no fast math.
//
// Physical to logical: the entry's grid and block stay the chevron's
// (131,072 blocks of 128 at the main path's shape); the launcher starts
// ceil(grid / 8) CTAs of 256 threads (16,384), warp w of CTA c taking
// logical block 8 c + w.  A warp whose block is at or past the grid
// stores nothing, as the reference's missing block writes nothing.  V is a
// template argument (B is a multiple of 32 up to 1024, the wrapper's
// check), so the values stay in registers.  Bases that are not aligned to
// the access width (a view at an odd offset) take the instantiation of
// one float an access.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256, kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// one lane's W consecutive values (W = 1, 2 or 4): one access of 4 W bytes
template <int W>
__device__ __forceinline__ void load(const float* p, float* v) {
  if constexpr (W == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else if constexpr (W == 2) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  } else {
    v[0] = __ldg(p);
  }
}
template <int W>
__device__ __forceinline__ void store(float* p, const float* v) {
  if constexpr (W == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (W == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  } else {
    *p = v[0];
  }
}

// V values a lane, in W-wide accesses (V % W == 0)
template <int V, int W>
__global__ void __launch_bounds__(kThreads)
    softmax_row_kernel(const float* __restrict__ x, float* __restrict__ y,
                       int grid) {
  const int lane = threadIdx.x % 32;
  const long long row = (long long)blockIdx.x * kWarps + threadIdx.x / 32;
  if (row >= grid) return;               // the whole warp is past
  const float* xr = x + row * 32 * V + W * lane;
  float v[V];
#pragma unroll
  for (int j = 0; j < V / W; ++j) load<W>(xr + 32 * W * j, &v[W * j]);
  float m = v[0];
#pragma unroll
  for (int j = 1; j < V; ++j) m = fmaxf(m, v[j]);
#pragma unroll
  for (int off = 16; off >= 1; off /= 2)
    m = fmaxf(m, __shfl_xor_sync(kFull, m, off));
  float s = 0.0f;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    v[j] = expf(__fsub_rn(v[j], m));
    s = j ? __fadd_rn(s, v[j]) : v[j];
  }
#pragma unroll
  for (int off = 16; off >= 1; off /= 2)
    s = __fadd_rn(s, __shfl_xor_sync(kFull, s, off));
#pragma unroll
  for (int j = 0; j < V; ++j) v[j] = __fdiv_rn(v[j], s);
  float* yr = y + row * 32 * V + W * lane;
#pragma unroll
  for (int j = 0; j < V / W; ++j) store<W>(yr + 32 * W * j, &v[W * j]);
}

template <int V>
cudaError_t launch(const float* x, float* y, int grid, cudaStream_t s) {
  constexpr int kW = V % 4 == 0 ? 4 : V % 2 == 0 ? 2 : 1;
  const unsigned ctas = (unsigned)((grid + kWarps - 1) / kWarps);
  const bool aligned = ((uintptr_t)x | (uintptr_t)y) % (4 * kW) == 0;
  if (aligned) {
    softmax_row_kernel<V, kW><<<ctas, kThreads, 0, s>>>(x, y, grid);
  } else {
    softmax_row_kernel<V, 1><<<ctas, kThreads, 0, s>>>(x, y, grid);
  }
  return cudaGetLastError();
}

}  // namespace

// block: the logical block B, a multiple of 32 up to 1024 (the wrapper's
// check); any other is refused with cudaErrorInvalidValue.
extern "C" int launch_softmax_row(const float* x, float* y, int grid,
                                  int block, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (block) {
#define CASE(V) \
  case 32 * V: \
    return (int)launch<V>(x, y, grid, s);
    CASE(1) CASE(2) CASE(3) CASE(4) CASE(5) CASE(6) CASE(7) CASE(8)
    CASE(9) CASE(10) CASE(11) CASE(12) CASE(13) CASE(14) CASE(15) CASE(16)
    CASE(17) CASE(18) CASE(19) CASE(20) CASE(21) CASE(22) CASE(23)
    CASE(24) CASE(25) CASE(26) CASE(27) CASE(28) CASE(29) CASE(30)
    CASE(31) CASE(32)
#undef CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
