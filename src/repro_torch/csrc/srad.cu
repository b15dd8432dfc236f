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
// update launch folds the partials once, then runs the stencil:
// - srad_fold, a cluster of 8 CTAs of 256 threads, walks both arrays in
//   one pass by float4s into independent sums, adds the CTAs' sums through
//   distributed shared memory, and stores q0 and q0 (1 + q0) in a
//   two-float scratch (a launch with one CTA of 1024 threads as the fold
//   took 0-2 us longer at 2048^2, 3 us at 4096^2); its order is not
//   torch.sum's, so y agrees with the plain version within the
//   entry's tolerance (1e-4), and bit for bit when the totals do not
//   depend on the order;
// - srad_rows, the stencil, moves 33.6 MB at 2048^2 (x read, y written),
//   but its four divisions and a reciprocal a pixel (IEEE, each with its
//   range check and slow path: about 125 instructions a pixel) make it
//   bound by instruction issue.  It takes hotspot's mapping
//   (csrc/hotspot.cu): CTAs of 8 warps, a warp 128 columns of one row, a
//   float4 a lane (a float where w % 4 != 0 or a buffer lies off a 16-byte
//   boundary), west and east by shuffle, north and south from the clamped
//   rows, no shared memory and no barrier: 4,096 CTAs at 2048^2 against
//   the 8 x 8 tiles' 65,536.  The arithmetic is written with __f*_rn in
//   the plain version's order, so nvcc contracts nothing;
// - the stencil is the fold's programmatic dependent launch
//   (cudaLaunchKernelEx with programmatic stream serialization): its CTAs
//   start while the fold runs, load their rows and compute q (three of
//   the divisions), and wait (griddepcontrol.wait) only before they
//   read q0.
// tools/srad_update_variants.cu times the fold and the stencil apart,
// with and without the dependent launch, beside the old kernels.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#define SRAD_TILE 8

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

constexpr int kFoldCtas = 8;              // the fold's cluster
constexpr int kFoldThreads = 256;
constexpr int kWarps = 8;                 // warps a stencil CTA, a row each
constexpr int kCols = 4;                  // columns a lane
constexpr int kCtaCols = 32 * kCols;      // 128
constexpr unsigned kFull = 0xffffffffu;

bool aligned16(const void* a) {
  return (reinterpret_cast<size_t>(a) & 15) == 0;
}

// A cluster of kFoldCtas CTAs folds psum and psq into their totals and
// stores q0 and q0 * (1 + q0), the plain version's order, in tot[0] and
// tot[1]: each CTA sums a slice of both arrays (float4s where both lie on
// 16-byte boundaries), and rank 0 adds the CTAs' sums in rank order from
// their shared memory.
template <bool VEC4>
__global__ void __cluster_dims__(kFoldCtas, 1, 1)
    __launch_bounds__(kFoldThreads)
    srad_fold(const float* __restrict__ psum, const float* __restrict__ psq,
              int n_psum, int n_psq, float npix, float* tot) {
  // the stencil may start now: its CTAs load their rows while this folds,
  // and wait for tot (griddepcontrol.wait) before they read it
  asm volatile("griddepcontrol.launch_dependents;");
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank(), t = threadIdx.x;
  const int first = rank * kFoldThreads + t;
  constexpr int kStride = kFoldCtas * kFoldThreads;
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f}, b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  int done_a = 0, done_b = 0;
  if (VEC4) {
    const int na = n_psum / 4, nb = n_psq / 4;
    const float4* pa = reinterpret_cast<const float4*>(psum);
    const float4* pb = reinterpret_cast<const float4*>(psq);
#pragma unroll 4
    for (int i = first; i < max(na, nb); i += kStride) {
      if (i < na) {
        const float4 v = pa[i];
        a[0] += v.x, a[1] += v.y, a[2] += v.z, a[3] += v.w;
      }
      if (i < nb) {
        const float4 v = pb[i];
        b[0] += v.x, b[1] += v.y, b[2] += v.z, b[3] += v.w;
      }
    }
    done_a = na * 4, done_b = nb * 4;
  }
  for (int i = done_a + first; i < n_psum; i += kStride) a[0] += psum[i];
  for (int i = done_b + first; i < n_psq; i += kStride) b[0] += psq[i];
  float sa = (a[0] + a[1]) + (a[2] + a[3]);
  float sb = (b[0] + b[1]) + (b[2] + b[3]);
#pragma unroll
  for (int off = 16; off >= 1; off /= 2) {
    sa += __shfl_xor_sync(kFull, sa, off);
    sb += __shfl_xor_sync(kFull, sb, off);
  }
  __shared__ float wa[kFoldThreads / 32], wb[kFoldThreads / 32], part[2];
  if (t % 32 == 0) wa[t / 32] = sa, wb[t / 32] = sb;
  __syncthreads();
  if (t == 0) {
    sa = 0.0f, sb = 0.0f;
    for (int i = 0; i < kFoldThreads / 32; ++i) sa += wa[i], sb += wb[i];
    part[0] = sa, part[1] = sb;
  }
  cluster.sync();
  if (rank == 0 && t == 0) {
    sa = 0.0f, sb = 0.0f;
    for (int r = 0; r < kFoldCtas; ++r) {
      const float* p = cluster.map_shared_rank(part, r);
      sa += p[0], sb += p[1];
    }
    // q0 in the plain version's order, each operation rounded alone
    const float mean = __fdiv_rn(sa, npix);
    const float mean2 = __fmul_rn(mean, mean);
    const float var = __fsub_rn(__fdiv_rn(sb, npix), mean2);
    const float q0 = __fdiv_rn(var, mean2);
    tot[0] = q0;
    tot[1] = __fmul_rn(q0, __fadd_rn(1.0f, q0));
  }
  cluster.sync();     // the CTAs' sums stay until rank 0 has read them
}

// Columns c0 .. c0 + 3 of row r of x, each clamped to w - 1.
template <bool VEC4>
__device__ __forceinline__ void load_cols(const float* __restrict__ x, int r,
                                          int c0, int w, float (&v)[kCols]) {
  const float* row = x + (size_t)r * w;
  if (VEC4 && c0 < w) {
    const float4 f = *reinterpret_cast<const float4*>(row + c0);
    v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e) v[e] = row[min(c0 + e, w - 1)];
  }
}

// One pixel's diffusion step in the plain version's order, each operation
// rounded alone, in two halves: before q0 is known, q and the sum of the
// four differences; then the step, with den0 = q0 * (1 + q0).  The clamp
// keeps a NaN, as torch.clamp does.
struct Half {
  float q, sum;
};

__device__ __forceinline__ Half pixel_q(float xc, float n, float s, float we,
                                        float ea) {
  const float dn = __fsub_rn(n, xc), ds = __fsub_rn(s, xc);
  const float dw = __fsub_rn(we, xc), de = __fsub_rn(ea, xc);
  const float sq = __fadd_rn(__fadd_rn(__fadd_rn(__fmul_rn(dn, dn),
                                                 __fmul_rn(ds, ds)),
                                       __fmul_rn(dw, dw)),
                             __fmul_rn(de, de));
  const float g2 = __fdiv_rn(sq, __fmul_rn(xc, xc));
  const float sum = __fadd_rn(__fadd_rn(__fadd_rn(dn, ds), dw), de);
  const float ll = __fdiv_rn(sum, xc);
  const float num = __fsub_rn(__fmul_rn(0.5f, g2),
                              __fmul_rn(0.0625f, __fmul_rn(ll, ll)));
  const float t = __fadd_rn(1.0f, __fmul_rn(0.25f, ll));
  return {__fdiv_rn(num, __fmul_rn(t, t)), sum};
}

__device__ __forceinline__ float pixel_step(float xc, Half h, float q0,
                                            float den0, float coef) {
  // 1 / v as the correctly rounded reciprocal: the division's bits
  float cd = __frcp_rn(__fadd_rn(1.0f, __fdiv_rn(__fsub_rn(h.q, q0), den0)));
  cd = cd < 0.0f ? 0.0f : (cd > 1.0f ? 1.0f : cd);
  return __fadd_rn(xc, __fmul_rn(__fmul_rn(coef, cd), h.sum));
}

// The pixels (r, c), r < nr and c < nc, of an [h, w] image: a warp 128
// columns of one row, a lane 4 of them.
template <bool VEC4>
__global__ void __launch_bounds__(kWarps * 32)
    srad_rows(const float* __restrict__ x, const float* tot, float* y, int h,
              int w, int nr, int nc, float coef) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.y * kWarps + (threadIdx.x >> 5);
  const int cw = blockIdx.x * kCtaCols;   // the warp's first column
  // a warp returns whole: every lane of a live warp joins the shuffles
  if (r >= nr || cw >= nc) return;
  const int c0 = cw + lane * kCols;
  float n[kCols], xc[kCols], s[kCols];
  load_cols<VEC4>(x, max(r - 1, 0), c0, w, n);
  load_cols<VEC4>(x, r, c0, w, xc);
  load_cols<VEC4>(x, min(r + 1, h - 1), c0, w, s);
  const float* row = x + (size_t)r * w;
  float we = __shfl_up_sync(kFull, xc[kCols - 1], 1);
  float ea = __shfl_down_sync(kFull, xc[0], 1);
  if (lane == 0) we = row[max(c0 - 1, 0)];
  if (lane == 31) ea = row[min(c0 + kCols, w - 1)];
  if (c0 >= nc) return;                  // past the shuffles: no lane waits
  Half hq[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e)
    hq[e] = pixel_q(xc[e], n[e], s[e], e ? xc[e - 1] : we,
                    e < kCols - 1 ? xc[e + 1] : ea);
  // the fold's q0 and den0 are visible once it has finished
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const float q0 = __ldcg(tot), den0 = __ldcg(tot + 1);
  float out[kCols];
#pragma unroll
  for (int e = 0; e < kCols; ++e)
    out[e] = pixel_step(xc[e], hq[e], q0, den0, coef);
  float* dst = y + (size_t)r * w + c0;
  if (VEC4) {      // nc % 4 == 0 here, so the four are all below it
    *reinterpret_cast<float4*>(dst) =
        make_float4(out[0], out[1], out[2], out[3]);
  } else {
#pragma unroll
    for (int e = 0; e < kCols; ++e)
      if (c0 + e < nc) dst[e] = out[e];
  }
}

}  // namespace

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

// The rows and columns of the [h, w] image that one stencil CTA covers;
// lower_cuda.srad_update_ctas gives the CTA grid from them.
extern "C" int srad_update_cta_rows() { return kWarps; }
extern "C" int srad_update_cta_cols() { return kCtaCols; }

// coef = 0.25 * lam; npix = h * w as a float, as the reference divides.
// The chevron's (grid_x, grid_y) of 8 x 8 tiles, run as (ctas_x, ctas_y)
// CTAs of kWarps x kCtaCols pixels, launched as the fold's programmatic
// dependent.  tot is the launch's two-float scratch.
extern "C" int launch_srad_update(const float* x, const float* psum,
                                  const float* psq, float* tot, float* y,
                                  int h, int w, int n_psum, int n_psq,
                                  float npix, float coef, int grid_x,
                                  int grid_y, int ctas_x, int ctas_y,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (aligned16(psum) && aligned16(psq))
    srad_fold<true><<<kFoldCtas, kFoldThreads, 0, s>>>(psum, psq, n_psum,
                                                        n_psq, npix, tot);
  else
    srad_fold<false><<<kFoldCtas, kFoldThreads, 0, s>>>(psum, psq, n_psum,
                                                         n_psq, npix, tot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long gy = (long long)grid_y * SRAD_TILE;
  const long long gx = (long long)grid_x * SRAD_TILE;
  const int nr = gy < h ? (int)gy : h, nc = gx < w ? (int)gx : w;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas_x, ctas_y);
  cfg.blockDim = dim3(kWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* tc = tot;
  if (w % 4 == 0 && aligned16(x) && aligned16(y))
    err = cudaLaunchKernelEx(&cfg, srad_rows<true>, x, tc, y, h, w, nr, nc,
                             coef);
  else
    err = cudaLaunchKernelEx(&cfg, srad_rows<false>, x, tc, y, h, w, nr, nc,
                             coef);
  return (int)err;
}
