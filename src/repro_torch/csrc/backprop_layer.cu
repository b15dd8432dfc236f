// backprop_layer: one layer of Rodinia backprop, forward and weight update
// fused.  Hidden unit j:
//   hidden[j]   = sigmoid(sum_i inp[i] * w[j, i] + bias[j])
//   w_out[j, i] = w[j, i] + lr * delta[j] * inp[i]
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`)
// applied to make_backprop_layer (src/repro/core/cuda_suite.py:572).
//
// Bound on the H100: memory (w read and w_out written once, 8 MB at
// Rodinia's 65536 inputs x 16 units; about four flops per weight).  The
// reference's logical block has one thread per input, up to 65536, past
// CUDA's 1024.  The launcher runs T logical threads a unit, T a power of
// two up to in_n, and thread t owns the 2^L = in_n / T inputs t + T * m.
// The reference's tree halves its offset from in_n / 2 down to 1; every
// level whose offset is at least T pairs two inputs of one thread (m and
// m + h), so the thread does those levels in registers.  That halving
// tree over m is the adjacent-pair tree over the bit-reversed order of m,
// so the thread streams its inputs in that order through a binary-counter
// stack of L+1 partial sums (L a template parameter, every index a
// constant after unrolling: registers, no local array), with the
// reference's operand grouping.  Products and sums use the _rn intrinsics
// so nvcc does not contract them into FMAs the reference does not have.
// Loads of w and inp are coalesced (consecutive t), and straight-line code
// lets them be issued ahead.  The inputs are `const float* __restrict__`,
// not __constant__.
// One CTA of 1024 threads a unit ran only 16 CTAs at Rodinia size, on 16
// of the 132 SMs.  So each unit runs on a thread-block cluster of C CTAs
// of P threads, T = C P (lower_cuda.backprop_layer_ctas and
// backprop_layer_threads pick them: C up to 8 with at least a warp a CTA,
// C = 1 below 64 inputs; P up to 256).  CTA r runs the threads
// [r P, (r+1) P):
//   - a relaxed cluster arrive at the start, waited on after the fold,
//     tells every CTA that rank 0 has started (it costs nothing behind
//     the fold); each thread then stores its partial into rank 0's shared
//     array at its t through distributed shared memory and arrives with
//     release semantics before it stores its w_out (reading inp and w
//     again), so rank 0's wait does not wait for those stores to drain;
//   - thread i of rank 0 reads positions i + P q of the C CTAs and runs
//     the levels of offset T/2 down to P (which pair position i of CTA q
//     with position i of CTA q + h) in registers;
//   - after one barrier, lane l of warp 0 reads positions l + 32 w and
//     runs the levels P/2 down to 32 in registers the same way, then the
//     levels 16 down to 1 by __shfl_down_sync (lane l < off adds lane
//     l + off's value to its own, the tree's operand order), adds bias[j]
//     and stores the sigmoid.
// Which levels run where moves with T, but every level keeps its pairs
// and operand order, so hidden and w_out are the one-CTA kernel's bits
// at any C and P.  At 65536 x 16 that is 16 clusters of 8 CTAs of 256
// threads (T = 2048, 32 inputs a thread), two CTAs an SM at most (128
// registers): 128 CTAs.
// tools/backprop_layer_variants.cu times C = 4, 8 and 16 and P = 64 to
// 256 beside the one-CTA kernel, a copy of the bytes and the design's
// first text (rank 0 pulled the partials between two cluster syncs and
// ran its last levels in __shared__, a barrier each; the w_out stores
// came before the partials).  On an NVIDIA H100 80GB HBM3 at 700 W the
// first text took 0.0118-0.0119 ms at C = 8, P = 512 and 0.019 at P = 128
// (the one-CTA kernel's 1024 threads spread over the cluster), this
// kernel 0.0089-0.0092 against the old 0.0148-0.0149: the fold alone
// takes 0.0073-0.0076 (0.0073 with float4 accesses), a copy of the bytes
// 0.0061-0.0064, and one cluster sync 0.0006-0.0008 over an empty
// launch.  At C = 16, P = 256 (92 registers) the card holds 14 clusters
// at once, so two units wait: 0.0094.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxCluster = 16;     // C: the largest cluster the kernel takes
constexpr int kMaxCta = 256;        // P: the widest CTA (T <= 4096, 16 KB)
constexpr unsigned kFull = 0xffffffffu;

// The levels of offset H down to 1 of a halving tree over v[0, n), held
// in registers: level h adds v[q + h] into v[q] for q < h (the level's
// pairs in the tree's operand order), where h < n.  H is a template
// argument so that every index is a constant and v stays in registers.
template <int H, int N>
__device__ __forceinline__ void halve_from(float (&v)[N], int n) {
  if (H < n) {
#pragma unroll
    for (int q = 0; q < H; ++q) v[q] = __fadd_rn(v[q], v[q + H]);
  }
  if constexpr (H > 1) halve_from<H / 2>(v, n);
}

// p with its L low bits reversed
template <int L>
__device__ __forceinline__ int bit_reverse(int p) {
  int m = 0;
#pragma unroll
  for (int b = 0; b < L; ++b) m |= ((p >> b) & 1) << (L - 1 - b);
  return m;
}

// nt = T threads a unit, in a cluster of nc CTAs of blockDim.x = P; s:
// T floats of dynamic shared memory, where rank 0 gathers the partials.
template <int L>
__global__ void __launch_bounds__(kMaxCta, 2)
    backprop_layer_kernel(const float* __restrict__ inp,
                          const float* __restrict__ w,
                          const float* __restrict__ bias,
                          const float* __restrict__ delta, float* hidden,
                          float* w_out, int in_n, int nt, int nc, float lr) {
  namespace cg = cooperative_groups;
  constexpr int kN = 1 << L;           // inputs a thread
  extern __shared__ float s[];
  // every CTA has started once this barrier completes (waited on below)
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int r = (int)cluster.block_rank(), i = threadIdx.x, per = blockDim.x;
  const int t = r * per + i, j = blockIdx.x / nc;
  const float* wj = w + (size_t)j * in_n;
  float* woj = w_out + (size_t)j * in_n;
  const float lrd = __fmul_rn(lr, delta[j]), bj = bias[j];
  float st[L + 1];     // st[d]: sum of a complete subtree of 2^d inputs
#pragma unroll
  for (int p = 0; p < kN; ++p) {
    const int k = t + bit_reverse<L>(p) * nt;
    const float x = inp[k], wv = wj[k];
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
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  cluster.map_shared_rank(s, 0)[t] = st[L];
  // the partial is released before any weight is stored, so rank 0's
  // wait does not also wait for the w_out stores to drain; the stores
  // read inp and w again (from L1)
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
#pragma unroll
  for (int p = 0; p < kN; ++p) {
    const int k = t + bit_reverse<L>(p) * nt;
    woj[k] = __fadd_rn(wj[k], __fmul_rn(lrd, inp[k]));
  }
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (r != 0) return;                  // rank 0 holds all T partials
  float v[kMaxCluster];                // v[q]: position i + P q
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q) v[q] = q < nc ? s[q * per + i] : 0.0f;
  halve_from<kMaxCluster / 2>(v, nc);  // offsets h P, h = C/2 down to 1
  s[i] = v[0];                         // only thread i reads i + P q
  __syncthreads();
  if (i >= 32) return;
  const int warps = per / 32;          // 0 below 32 threads
  float u[kMaxCta / 32];               // u[w]: position i + 32 w
#pragma unroll
  for (int q = 0; q < kMaxCta / 32; ++q)
    u[q] = q < warps ? s[i + 32 * q] : 0.0f;
  halve_from<kMaxCta / 64>(u, warps);  // offsets 32 h, h = P/64 down to 1
  // below 32 threads warp 0 has only its per lanes
  const unsigned lanes = per >= 32 ? kFull : (1u << per) - 1;
  float x = warps ? u[0] : s[i];
  for (int off = min(per, 32) / 2; off >= 1; off /= 2) {
    const float y = __shfl_down_sync(lanes, x, off);
    if (i < off) x = __fadd_rn(x, y);
  }
  if (i == 0) {
    const float total = __fadd_rn(x, bj);
    hidden[j] = 1.0f / (1.0f + expf(-total));
  }
}

using Kernel = void (*)(const float*, const float*, const float*,
                        const float*, float*, float*, int, int, int, float);

}  // namespace

// grid: the hidden units the chevron's grid covers; threads: T, a unit's
// threads (lower_cuda.backprop_layer_threads), at most in_n and at least
// in_n / 64; cluster: C, the CTAs a unit (lower_cuda.backprop_layer_ctas),
// a power of two up to 16 that leaves each CTA T / C <= 256 threads.
extern "C" int launch_backprop_layer(const float* inp, const float* w,
                                     const float* bias, const float* delta,
                                     float* hidden, float* w_out, int in_n,
                                     float lr, int grid, int threads,
                                     int cluster, void* stream) {
  if (cluster < 1 || cluster > kMaxCluster || (cluster & (cluster - 1)) ||
      threads % cluster || threads / cluster > kMaxCta || threads > in_n)
    return (int)cudaErrorInvalidValue;
  int lg = 0;                    // log2 of the inputs a thread owns
  while ((threads << lg) < in_n) ++lg;
  Kernel kern;
  switch (lg) {                  // at most 64 inputs a thread
    case 0: kern = backprop_layer_kernel<0>; break;
    case 1: kern = backprop_layer_kernel<1>; break;
    case 2: kern = backprop_layer_kernel<2>; break;
    case 3: kern = backprop_layer_kernel<3>; break;
    case 4: kern = backprop_layer_kernel<4>; break;
    case 5: kern = backprop_layer_kernel<5>; break;
    case 6: kern = backprop_layer_kernel<6>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (cluster > 8) {             // past the portable cluster size
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return (int)err;
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid * cluster);
  cfg.blockDim = dim3(threads / cluster);
  cfg.dynamicSmemBytes = threads * sizeof(float);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kern, inp, w, bias, delta,
                                             hidden, w_out, in_n, threads,
                                             cluster, lr);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
