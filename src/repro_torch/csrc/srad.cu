// srad: one iteration of Rodinia srad (speckle-reducing anisotropic
// diffusion) as two launches:
//   srad_stats  - each block sums x and x*x over its pixels with a barrier
//                 tree into psum[b] and psq[b];
//   srad_update - the image's mean and variance from those partials give
//                 q0, and each pixel takes one diffusion step, edges
//                 clamped.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_srad_stats and
// make_srad_update (src/repro/core/cuda_suite.py:660 and :707).
//
// Bound on the H100: memory.  srad_stats reads each pixel once (16.8 MB
// at 2048^2) and writes two floats a block.  Its tree adds s[t + off] into
// s[t] for t < off, off from blockDim/2 down to 1, exactly as the
// reference's stages do, and squares with __fmul_rn, so the partials
// equal the reference's bit for bit.
// In the reference every thread of srad_update sums all of psum and psq:
// at 2048^2 that is 32,768 x 2 loads for each of 4.2 M pixels.  Here the
// update launch folds the partials once: a one-block pass (srad_fold)
// writes the two totals to a scratch pair, and the 8x8 stencil blocks read
// those two floats.  The fold's order is not jnp.sum's, so y agrees with
// the reference within the entry's tolerance (1e-4), not bit for bit.  The
// stencil stages its tile plus a one-pixel halo in __shared__, as hotspot
// does, so each pixel is read from device memory about once.
#include <cuda_runtime.h>

#define SRAD_MAX_THREADS 1024
#define SRAD_FOLD_THREADS 1024
#define SRAD_TILE 8

// The reference's tree over blockDim (a power of two) values in s1, s2;
// the sums end in s1[0], s2[0].  Every thread of the block reaches it.
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

__global__ void srad_stats_kernel(const float* __restrict__ x, float* psum,
                                  float* psq, int npix, int n_psum,
                                  int n_psq) {
  __shared__ float s1[SRAD_MAX_THREADS];
  __shared__ float s2[SRAD_MAX_THREADS];
  const int t = threadIdx.x;
  const long long gid = (long long)blockIdx.x * blockDim.x + t;
  const float v = gid < npix ? x[gid] : 0.0f;
  s1[t] = v;
  s2[t] = __fmul_rn(v, v);
  srad_tree(s1, s2);
  if (t == 0) {
    if ((int)blockIdx.x < n_psum) psum[blockIdx.x] = s1[0];
    if ((int)blockIdx.x < n_psq) psq[blockIdx.x] = s2[0];
  }
}

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

extern "C" int launch_srad_stats(const float* x, float* psum, float* psq,
                                 int npix, int n_psum, int n_psq, int grid,
                                 int block, void* stream) {
  srad_stats_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      x, psum, psq, npix, n_psum, n_psq);
  return (int)cudaGetLastError();
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
