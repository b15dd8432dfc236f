// srad: one iteration of Rodinia srad (speckle-reducing anisotropic
// diffusion) as two launches:
//   srad_stats  - each logical block sums x and x*x over its pixels in the
//                 reference's barrier-tree order into psum[b] and psq[b];
//   srad_update - the image's mean and variance from those partials give
//                 q0, and each pixel takes one diffusion step, edges
//                 clamped.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_srad_stats and
// make_srad_update (src/repro/core/cuda_suite.py:660 and :707).
//
// Bound on the H100: memory.  srad_stats reads each pixel once (16.8 MB
// at 2048^2) and writes two floats a block.  The reference's block, a
// __shared__ tree of two arrays behind log2(B) + 1 barriers with one
// 4-byte load a thread, keeps few bytes in flight; here one warp does a
// logical block of B >= 32 threads with no shared memory and no barrier,
// as csrc/reduce_shared.cu does, carrying two sums:
// - lane l holds the B/32 pixels t = l + 32 j and their squares
//   (__fmul_rn) in two register arrays, loaded as coalesced 128-byte warp
//   loads, all issued before the first add;
// - the tree's levels with off >= 32 add register j + off/32 into
//   register j, in both arrays;
// - levels 16 .. 1 pair lanes: lane t < off takes s[t + off] by
//   __shfl_down_sync.
// These are the tree's pairs, level by level, added with __fadd_rn, so
// the partials equal the plain version's (and the reference's) bit for
// bit.  A block of B < 32 threads is a segment of B lanes (the shuffles'
// width), so a warp serves 32/B logical blocks.  The launcher starts CTAs
// of 256 threads (4,096 of them at 2048^2 and B = 128); logical block bid
// stores psum only where bid < grid and bid < n_psum, psq where bid <
// grid and bid < n_psq.  B is a power of two up to 1024 (the wrapper's
// check) and a template argument.
// In the reference every thread of srad_update sums all of psum and psq:
// at 2048^2 that is 32,768 x 2 loads for each of 4.2 M pixels.  Here the
// update launch folds the partials once: a one-block pass (srad_fold)
// writes the two totals to a scratch pair, and the 8x8 stencil blocks read
// those two floats.  The fold's order is not jnp.sum's, so y agrees with
// the reference within the entry's tolerance (1e-4), not bit for bit.  The
// stencil stages its tile plus a one-pixel halo in __shared__, as hotspot
// does, so each pixel is read from device memory about once.
#include <cuda_runtime.h>

#define SRAD_FOLD_THREADS 1024
#define SRAD_TILE 8

// A barrier tree over blockDim (a power of two) values in s1, s2, the
// reference's order; the sums end in s1[0], s2[0].  Every thread of the
// block reaches it.
__device__ __forceinline__ void srad_tree(float* s1, float* s2) {
  const int t = threadIdx.x;
  __syncthreads();
  for (int off = blockDim.x / 2; off >= 1; off >>= 1) {
    if (t < off) {
      s1[t] = __fadd_rn(s1[t], s1[t + off]);
      s2[t] = __fadd_rn(s2[t], s2[t + off]);
    }
    __syncthreads();
  }
}

namespace {

constexpr int kStatsThreads = 256;

// The tree's levels off, off/2, .., 1 over the registers s[0 .. 2 off)
// and q[0 .. 2 off): s[j] += s[j + off], q[j] += q[j + off] for j < off
// (a template, so every index is constant and both stay in registers).
template <int OFF>
__device__ __forceinline__ void fold(float* s, float* q) {
  if constexpr (OFF >= 1) {
#pragma unroll
    for (int j = 0; j < OFF; ++j) {
      s[j] = __fadd_rn(s[j], s[j + OFF]);
      q[j] = __fadd_rn(q[j], q[j + OFF]);
    }
    fold<OFF / 2>(s, q);
  }
}

template <int B>
__global__ void __launch_bounds__(kStatsThreads)
    srad_stats_kernel(const float* __restrict__ x, float* __restrict__ psum,
                      float* __restrict__ psq, int npix, int n_psum,
                      int n_psq, int grid) {
  constexpr int kLanes = B < 32 ? B : 32;        // lanes a logical block
  constexpr int kVals = B < 32 ? 1 : B / 32;     // pixels a lane
  const int lane = threadIdx.x % 32;
  const long long warp = (long long)blockIdx.x * (kStatsThreads / 32) +
                         threadIdx.x / 32;
  const long long bid = (warp * 32 + lane) / kLanes;
  if (warp * 32 / kLanes >= grid) return;        // the whole warp is past
  const long long base = bid * B + lane % kLanes;
  float s[kVals], q[kVals];
#pragma unroll
  for (int j = 0; j < kVals; ++j) {
    const long long gid = base + 32LL * j;
    s[j] = gid < npix ? __ldg(x + gid) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kVals; ++j) q[j] = __fmul_rn(s[j], s[j]);
  fold<kVals / 2>(s, q);
  float a = s[0], b = q[0];
#pragma unroll
  for (int off = kLanes / 2; off >= 1; off /= 2) {
    a = __fadd_rn(a, __shfl_down_sync(0xffffffffu, a, off, kLanes));
    b = __fadd_rn(b, __shfl_down_sync(0xffffffffu, b, off, kLanes));
  }
  if (lane % kLanes == 0 && bid < grid) {
    if (bid < n_psum) psum[bid] = a;
    if (bid < n_psq) psq[bid] = b;
  }
}

// The launcher's arguments, as launch_srad_stats receives them.
struct StatsArgs {
  const float* x;
  float *psum, *psq;
  int npix, n_psum, n_psq, grid;
};

template <int B>
cudaError_t launch_stats(const StatsArgs& a, cudaStream_t stream) {
  constexpr int kLanes = B < 32 ? B : 32;
  const long long warps = ((long long)a.grid * kLanes + 31) / 32;
  const long long ctas = (warps + kStatsThreads / 32 - 1) /
                         (kStatsThreads / 32);
  srad_stats_kernel<B><<<(unsigned)ctas, kStatsThreads, 0, stream>>>(
      a.x, a.psum, a.psq, a.npix, a.n_psum, a.n_psq, a.grid);
  return cudaGetLastError();
}

}  // namespace

// One block: tot[0] = sum(psum), tot[1] = sum(psq).
__global__ void srad_fold(const float* __restrict__ psum,
                          const float* __restrict__ psq, int n_psum,
                          int n_psq, float* tot) {
  __shared__ float s1[SRAD_FOLD_THREADS];
  __shared__ float s2[SRAD_FOLD_THREADS];
  const int t = threadIdx.x;
  float a = 0.0f, b = 0.0f;
  for (int i = t; i < n_psum; i += blockDim.x) a += psum[i];
  for (int i = t; i < n_psq; i += blockDim.x) b += psq[i];
  s1[t] = a;
  s2[t] = b;
  srad_tree(s1, s2);
  if (t == 0) {
    tot[0] = s1[0];
    tot[1] = s2[0];
  }
}

__global__ void srad_update_kernel(const float* __restrict__ x,
                                   const float* __restrict__ tot, float* y,
                                   int h, int w, float npix, float coef) {
  __shared__ float s[SRAD_TILE + 2][SRAD_TILE + 2];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int r = blockIdx.y * SRAD_TILE + ty;
  const int c = blockIdx.x * SRAD_TILE + tx;
  const int rc = min(max(r, 0), h - 1), cc = min(max(c, 0), w - 1);
  auto at = [&](int rr, int cx) {
    rr = min(max(rr, 0), h - 1);
    cx = min(max(cx, 0), w - 1);
    return x[(size_t)rr * w + cx];
  };
  // the reference's neighbours are those of the clamped pixel (rc, cc)
  s[ty + 1][tx + 1] = at(rc, cc);
  if (ty == 0) s[0][tx + 1] = at(rc - 1, cc);
  if (ty == SRAD_TILE - 1) s[SRAD_TILE + 1][tx + 1] = at(rc + 1, cc);
  if (tx == 0) s[ty + 1][0] = at(rc, cc - 1);
  if (tx == SRAD_TILE - 1) s[ty + 1][SRAD_TILE + 1] = at(rc, cc + 1);
  __syncthreads();
  if (r >= h || c >= w) return;
  // q0 in the reference's order, uncontracted
  const float mean = __fdiv_rn(tot[0], npix);
  const float mean2 = __fmul_rn(mean, mean);
  const float var = __fsub_rn(__fdiv_rn(tot[1], npix), mean2);
  const float q0 = __fdiv_rn(var, mean2);
  // at an image edge the clamped loads above put the pixel itself in the
  // neighbour's cell, which is the reference's edge rule
  const float xc = s[ty + 1][tx + 1];
  const float dn = s[ty][tx + 1] - xc;
  const float ds = s[ty + 2][tx + 1] - xc;
  const float dw = s[ty + 1][tx] - xc;
  const float de = s[ty + 1][tx + 2] - xc;
  const float g2 = (dn * dn + ds * ds + dw * dw + de * de) / (xc * xc);
  const float ll = (dn + ds + dw + de) / xc;
  const float num = 0.5f * g2 - 0.0625f * (ll * ll);
  const float den = (1.0f + 0.25f * ll) * (1.0f + 0.25f * ll);
  const float q = num / den;
  float cd = 1.0f / (1.0f + (q - q0) / (q0 * (1.0f + q0)));
  cd = fminf(fmaxf(cd, 0.0f), 1.0f);
  y[(size_t)r * w + c] = xc + coef * cd * (dn + ds + dw + de);
}

// block: the logical block B, a power of two up to 1024 (the wrapper's
// check); any other is refused with cudaErrorInvalidValue.
extern "C" int launch_srad_stats(const float* x, float* psum, float* psq,
                                 int npix, int n_psum, int n_psq, int grid,
                                 int block, void* stream) {
  const StatsArgs a{x, psum, psq, npix, n_psum, n_psq, grid};
  cudaStream_t s = (cudaStream_t)stream;
  switch (block) {
    case 1: return (int)launch_stats<1>(a, s);
    case 2: return (int)launch_stats<2>(a, s);
    case 4: return (int)launch_stats<4>(a, s);
    case 8: return (int)launch_stats<8>(a, s);
    case 16: return (int)launch_stats<16>(a, s);
    case 32: return (int)launch_stats<32>(a, s);
    case 64: return (int)launch_stats<64>(a, s);
    case 128: return (int)launch_stats<128>(a, s);
    case 256: return (int)launch_stats<256>(a, s);
    case 512: return (int)launch_stats<512>(a, s);
    case 1024: return (int)launch_stats<1024>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// coef = 0.25 * lam; npix = h * w as a float, as the reference divides.
extern "C" int launch_srad_update(const float* x, const float* psum,
                                  const float* psq, float* tot, float* y,
                                  int h, int w, int n_psum, int n_psq,
                                  float npix, float coef, int grid_x,
                                  int grid_y, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  srad_fold<<<1, SRAD_FOLD_THREADS, 0, s>>>(psum, psq, n_psum, n_psq, tot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  srad_update_kernel<<<dim3(grid_x, grid_y), dim3(SRAD_TILE, SRAD_TILE), 0,
                       s>>>(x, tot, y, h, w, npix, coef);
  return (int)cudaGetLastError();
}
