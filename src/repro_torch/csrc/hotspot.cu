// hotspot: one step of the RC thermal model on a 2-D grid (Rodinia
// hotspot), edges clamped:
//   t' = t + cap * (p + ry*(N + S - 2t) + rx*(W + E - 2t) + rz*(amb - t))
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`)
// applied to make_hotspot (src/repro/core/cuda_suite.py:1018).
//
// Bound on the H100: memory (three float reads and one write per cell,
// about 15 flops).  Each 8x8 block (dim3) stages its tile plus a one-cell
// halo in a __shared__ float[10][10], so each temperature is read from
// device memory about once; the power grid is read through
// `const float* __restrict__` (4 MB at 1024^2, too large for the 64 KB
// __constant__ bank).  nvcc contracts the arithmetic to FMAs, which the
// reference on the CPU does not, so results agree to 1e-4, not bit for bit.
#include <cuda_runtime.h>

#define HS_TILE 8

__global__ void hotspot_kernel(const float* __restrict__ t,
                               const float* __restrict__ p, float* t_out,
                               int h, int w, float cap, float rx, float ry,
                               float rz, float amb) {
  __shared__ float s[HS_TILE + 2][HS_TILE + 2];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int row = blockIdx.y * HS_TILE + ty;
  const int col = blockIdx.x * HS_TILE + tx;
  auto at = [&](int r, int c) {
    r = min(max(r, 0), h - 1);
    c = min(max(c, 0), w - 1);
    return t[(size_t)r * w + c];
  };
  s[ty + 1][tx + 1] = at(row, col);
  if (ty == 0) s[0][tx + 1] = at(row - 1, col);
  if (ty == HS_TILE - 1) s[HS_TILE + 1][tx + 1] = at(row + 1, col);
  if (tx == 0) s[ty + 1][0] = at(row, col - 1);
  if (tx == HS_TILE - 1) s[ty + 1][HS_TILE + 1] = at(row, col + 1);
  __syncthreads();
  if (row < h && col < w) {
    const float tc = s[ty + 1][tx + 1];
    const float v = tc + cap * (p[(size_t)row * w + col]
        + ry * (s[ty][tx + 1] + s[ty + 2][tx + 1] - 2.0f * tc)
        + rx * (s[ty + 1][tx] + s[ty + 1][tx + 2] - 2.0f * tc)
        + rz * (amb - tc));
    t_out[(size_t)row * w + col] = v;
  }
}

extern "C" int launch_hotspot(const float* t, const float* p, float* t_out,
                              int h, int w, float cap, float rx, float ry,
                              float rz, float amb, int grid_x, int grid_y,
                              void* stream) {
  hotspot_kernel<<<dim3(grid_x, grid_y), dim3(HS_TILE, HS_TILE), 0,
                   (cudaStream_t)stream>>>(t, p, t_out, h, w, cap, rx, ry,
                                           rz, amb);
  return (int)cudaGetLastError();
}
