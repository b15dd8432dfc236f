// nn: one output slot of Rodinia nn's k-nearest-neighbour search as two
// launches:
//   nn_reduce - each block finds its nearest untaken record to the target
//               with a barrier-tree arg-min into pval[b], pidx[b];
//   nn_select - one block reduces those partials the same way, writes the
//               winner to out_d[step], out_i[step], and sets its taken flag.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_nn_reduce and make_nn_select
// (src/repro/core/cuda_suite.py:816 and :852).
//
// Bound on the H100: launch latency.  At 65,536 records nn_reduce moves
// 0.79 MB (lat, lng and taken once each), 0.24 us at the memory rate, and
// nn_select reads 2 KB.  Both are one pass with a barrier per tree level.
// The tree's step keeps the lesser (value, index) pair: (v2, i2) replaces
// (v1, i1) when v2 < v1, or v2 == v1 and i2 < i1.  That minimum does not
// depend on the order of the pairings, so the winner is np.argmin's first
// minimum whatever the tree.  The distance is formed with the _rn
// intrinsics, so nvcc cannot contract it into an FMA and move a near tie
// to another record: out_i and taken equal the reference's bit for bit.
#include <cuda_runtime.h>
#include <math_constants.h>

#define NN_MAX_THREADS 1024

// The arg-min tree over blockDim (a power of two) pairs in sv, si; the
// least pair ends in sv[0], si[0].  Every thread of the block reaches it.
__device__ __forceinline__ void nn_argmin_tree(float* sv, int* si) {
  const int t = threadIdx.x;
  __syncthreads();
  for (int off = blockDim.x / 2; off >= 1; off >>= 1) {
    if (t < off) {
      const float v1 = sv[t], v2 = sv[t + off];
      const int i1 = si[t], i2 = si[t + off];
      if (v2 < v1 || (v2 == v1 && i2 < i1)) {
        sv[t] = v2;
        si[t] = i2;
      }
    }
    __syncthreads();
  }
}

__global__ void nn_reduce_kernel(const float* __restrict__ lat,
                                 const float* __restrict__ lng,
                                 const float* __restrict__ target,
                                 const int* __restrict__ taken, float* pval,
                                 int* pidx, int n, int n_pval, int n_pidx) {
  __shared__ float sv[NN_MAX_THREADS];
  __shared__ int si[NN_MAX_THREADS];
  const int t = threadIdx.x;
  const long long i = (long long)blockIdx.x * blockDim.x + t;
  const int g = i < n ? (int)i : n - 1;
  const float dx = __fsub_rn(lat[g], target[0]);
  const float dy = __fsub_rn(lng[g], target[1]);
  const float d = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
  sv[t] = (i < n && taken[g] == 0) ? d : CUDART_INF_F;
  si[t] = g;
  nn_argmin_tree(sv, si);
  if (t == 0) {
    if ((int)blockIdx.x < n_pval) pval[blockIdx.x] = sv[0];
    if ((int)blockIdx.x < n_pidx) pidx[blockIdx.x] = si[0];
  }
}

// JAX's scatter rule for one index: wrap a negative index once, then drop
// what is still out of range (-1 when dropped).
__device__ __forceinline__ int wrap_or_drop(int i, int size) {
  if (i < 0) i += size;
  return (i >= 0 && i < size) ? i : -1;
}

__global__ void nn_select_kernel(const float* __restrict__ pval,
                                 const int* __restrict__ pidx,
                                 const int* __restrict__ step, float* out_d,
                                 int* out_i, int* taken, int n_out_d,
                                 int n_out_i, int n_taken) {
  __shared__ float sv[NN_MAX_THREADS];
  __shared__ int si[NN_MAX_THREADS];
  const int t = threadIdx.x;
  sv[t] = pval[t];
  si[t] = pidx[t];
  nn_argmin_tree(sv, si);
  if (t == 0) {
    const int s = step[0];
    const int od = wrap_or_drop(s, n_out_d), oi = wrap_or_drop(s, n_out_i);
    const int tk = wrap_or_drop(si[0], n_taken);
    if (od >= 0) out_d[od] = sv[0];
    if (oi >= 0) out_i[oi] = si[0];
    if (tk >= 0) taken[tk] = 1;
  }
}

extern "C" int launch_nn_reduce(const float* lat, const float* lng,
                                const float* target, const int* taken,
                                float* pval, int* pidx, int n, int n_pval,
                                int n_pidx, int grid, int block,
                                void* stream) {
  nn_reduce_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      lat, lng, target, taken, pval, pidx, n, n_pval, n_pidx);
  return (int)cudaGetLastError();
}

// block == len(pval) == len(pidx): one thread per partial.  Every block
// of a wider grid writes the same winner.
extern "C" int launch_nn_select(const float* pval, const int* pidx,
                                const int* step, float* out_d, int* out_i,
                                int* taken, int n_out_d, int n_out_i,
                                int n_taken, int grid, int block,
                                void* stream) {
  nn_select_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      pval, pidx, step, out_d, out_i, taken, n_out_d, n_out_i, n_taken);
  return (int)cudaGetLastError();
}
