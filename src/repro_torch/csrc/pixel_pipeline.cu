// pixel_pipeline: out = exp(log(img) * c0 + c1), srad's extract and
// compress stages in one kernel, as a naive port writes it: each thread
// puts logf(img[gid]) in its own __shared__ cell, barriers, scales the cell
// in place, barriers again, and writes expf of the cell.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_pixel_pipeline
// (src/repro/core/cuda_suite.py:422).
//
// Bound on the H100: memory.  img is read once and out written once
// (134 MB at n = 2^24): 0.040 ms at 3.35 TB/s; the 3.4e7 log and exp on
// the special-function units take 0.008 ms.  No thread reads another's
// cell, so both barriers are removable (the reference's optimizer proves
// it); the kernel keeps them, as the CUDA a user brings does, and pays two
// barriers and a shared round trip per element.  The scale and shift use
// __fmul_rn/__fadd_rn (no FMA), logf and expf are CUDA's, so out agrees
// with the plain version and the oracle within the entry's tolerance
// (2e-5).  The block is the one the kernel was made for, up to 1024
// threads, and the wrapper keeps grid * block within img.
#include <cuda_runtime.h>

#define PP_MAX_THREADS 1024

__global__ void pixel_pipeline_kernel(const float* __restrict__ img,
                                      float* out, float c0, float c1) {
  __shared__ float buf[PP_MAX_THREADS];
  const int t = threadIdx.x;
  const size_t gid = (size_t)blockIdx.x * blockDim.x + t;
  buf[t] = logf(img[gid]);
  __syncthreads();
  buf[t] = __fadd_rn(__fmul_rn(buf[t], c0), c1);
  __syncthreads();
  out[gid] = expf(buf[t]);
}

extern "C" int launch_pixel_pipeline(const float* img, float* out, float c0,
                                     float c1, int grid, int block,
                                     void* stream) {
  pixel_pipeline_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(img, out,
                                                                  c0, c1);
  return (int)cudaGetLastError();
}
