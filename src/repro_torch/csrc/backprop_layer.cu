// backprop_layer: one layer of Rodinia backprop, forward and weight update
// fused.  Block j owns hidden unit j:
//   hidden[j]   = sigmoid(sum_i inp[i] * w[j, i] + bias[j])
//   w_out[j, i] = w[j, i] + lr * delta[j] * inp[i]
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`)
// applied to make_backprop_layer (src/repro/core/cuda_suite.py:572).
//
// Bound on the H100: memory (w read and w_out written once, 8 MB at
// Rodinia's 65536 inputs x 16 units; about four flops per weight).  The
// reference's logical block has one thread per input, up to 65536, past
// CUDA's 1024.  The launcher runs min(in_n, 1024) threads, and thread t
// owns the 2^L inputs t + threads * m.  The reference's tree halves its
// offset from in_n / 2 down to 1; every level whose offset is at least
// `threads` pairs two inputs of one thread (m and m + h), so the thread
// does those levels in registers.  That halving tree over m is the
// adjacent-pair tree over the bit-reversed order of m, so the thread
// streams its inputs in that order through a binary-counter stack of L+1
// partial sums (L a template parameter, every index a constant after
// unrolling: registers, no local array), with the reference's operand
// grouping.  The last log2(threads) levels run in a __shared__ tree.  The
// sum keeps the reference's order without an in_n-float shared array (256
// KB at 65536, over the SM's 227 KB).  Products and sums use the _rn
// intrinsics so nvcc does not contract them into FMAs the reference does
// not have.  Loads of w and inp are coalesced (consecutive t), and
// straight-line code lets them be issued ahead.  The inputs are
// `const float* __restrict__`, not __constant__.  Only 16 blocks run at
// Rodinia size (one per hidden unit), on 16 of the 132 SMs.
#include <cuda_runtime.h>

template <int L>
__global__ void backprop_layer_kernel(const float* __restrict__ inp,
                                      const float* __restrict__ w,
                                      const float* __restrict__ bias,
                                      const float* __restrict__ delta,
                                      float* hidden, float* w_out, int in_n,
                                      float lr) {
  __shared__ float s[1024];
  const int t = threadIdx.x, nt = blockDim.x, j = blockIdx.x;
  const float* wj = w + (size_t)j * in_n;
  float* woj = w_out + (size_t)j * in_n;
  const float lrd = __fmul_rn(lr, delta[j]);
  float st[L + 1];     // st[d]: sum of a complete subtree of 2^d inputs
#pragma unroll
  for (int p = 0; p < (1 << L); ++p) {
    int m = 0;         // bit reversal of p over L bits
#pragma unroll
    for (int b = 0; b < L; ++b) m |= ((p >> b) & 1) << (L - 1 - b);
    const int i = t + m * nt;
    const float x = inp[i], wv = wj[i];
    woj[i] = __fadd_rn(wv, __fmul_rn(lrd, x));
    float carry = __fmul_rn(x, wv);
#pragma unroll
    for (int d = 0; d <= L; ++d) {
      const int below = (1 << d) - 1;
      if ((p & below) == below) {      // the carry has reached level d
        if ((p >> d) & 1)
          carry = __fadd_rn(st[d], carry);
        else
          st[d] = carry;
      }
    }
  }
  s[t] = st[L];
  __syncthreads();
  for (int off = nt / 2; off >= 1; off /= 2) {
    if (t < off) s[t] = __fadd_rn(s[t], s[t + off]);
    __syncthreads();
  }
  if (t == 0) {
    const float total = __fadd_rn(s[0], bias[j]);
    hidden[j] = 1.0f / (1.0f + expf(-total));
  }
}

extern "C" int launch_backprop_layer(const float* inp, const float* w,
                                     const float* bias, const float* delta,
                                     float* hidden, float* w_out, int in_n,
                                     float lr, int grid, int threads,
                                     void* stream) {
  int lg = 0;                    // log2 of the inputs a thread owns
  while ((threads << lg) < in_n) ++lg;
  cudaStream_t s = (cudaStream_t)stream;
  switch (lg) {                  // at most 64 inputs a thread
#define BP_CASE(L)                                                        \
  case L:                                                                 \
    backprop_layer_kernel<L><<<grid, threads, 0, s>>>(inp, w, bias, delta, \
                                                      hidden, w_out, in_n, \
                                                      lr);                \
    break;
    BP_CASE(0) BP_CASE(1) BP_CASE(2) BP_CASE(3) BP_CASE(4) BP_CASE(5)
    BP_CASE(6)
#undef BP_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
