// nn: one output slot of Rodinia nn's k-nearest-neighbour search as two
// launches:
//   nn_reduce - each logical block finds its nearest untaken record to the
//               target with the reference's halving arg-min tree into
//               pval[b], pidx[b];
//   nn_select - the partials reduce by the same tree; the winner goes to
//               out_d[step], out_i[step], and its taken flag is set.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_nn_reduce and make_nn_select
// (src/repro/core/cuda_suite.py:816 and :852).
//
// The tree.  For off = B/2 down to 1, position t < off keeps its pair
// (v1, i1) or takes (v2, i2) from position t + off when v2 < v1, or
// v2 == v1 and i2 < i1.  Without NaN that is the least (value, index)
// pair, np.argmin's first minimum, whatever the pairing.  With NaN it is
// not: a NaN on the left is never replaced and one on the right never
// taken, so the result depends on where the NaN sits.  Both kernels keep
// the tree's pairs and their operand order (the lower position's pair on
// the left), and compare exactly so: no packed 64-bit key (it orders
// -0.0 above 0.0 and NaN by its bits), no redux, no fminf.  The plain
// version (lower_cuda._argmin_tree) repeats the same levels, so the
// kernels equal it bit for bit with NaN distances too.  The distance is
// formed with the _rn intrinsics in the plain version's order, so nvcc
// cannot contract it into an FMA and move a near tie to another record.
//
// Bound on the H100: the launch.  At 65,536 records nn_reduce moves 0.79
// MB (lat, lng and taken once each), 0.24 us at the memory rate, and
// nn_select reads 2 KB; the chevron's kernels ran a record a thread with
// a __shared__ tree of 8 barriers, each launch waiting for the one before
// it to drain.  The design:
// - a warp a logical block, as reduce_shared's: lane l holds the B/32
//   records t = l + 32 j of its block in registers (8 at B = 256), loaded
//   as coalesced warp loads, all issued before the first comparison; the
//   levels with off >= 32 pair register j with j + off/32 in the lane,
//   levels 16 .. 1 go by __shfl_down_sync, the receiving lane's own pair
//   on the left.  A block of B < 32 is a segment of B lanes.  No shared
//   memory, no barrier;
// - nn_select is one warp over the nblocks partials with the same levels;
//   step[0] is read in the same round as pval and pidx;
// - both are programmatic dependent launches (as needle_nw's): the launch
//   and the CTAs' start overlap the tail of the work before them.  Only
//   index arithmetic runs before griddepcontrol.wait, since the previous
//   nn_select writes the taken flags nn_reduce reads and reads the pval /
//   pidx it writes; each thread signals griddepcontrol.launch_dependents
//   once its loads are issued.  Both instructions do nothing in a kernel
//   launched without the attribute.
// nn_reduce runs kCtaWarps warps a CTA (lower_cuda.nn_reduce_ctas gives
// the CTA count), nn_select a warp a CTA, one CTA a logical block of its
// grid, each writing the same winner.  B and nblocks are powers of two
// up to 1024 (the wrappers' check) and template arguments; n and the
// buffers' lengths are runtime arguments.  Logical block b stores only
// where b < grid, b < len(pval), b < len(pidx).
// tools/nn_variants.cu times both beside the kernels they replaced (a
// record a thread, plain launches), the mapping without the attribute,
// CTAs of 1 to 8 warps and empty kernels of the same CTAs.  On an NVIDIA
// H100 80GB HBM3 at 700.00 W, two runs, 512 launches back to back on the
// main path's first iteration: nn_reduce 1.228-1.235 us a launch on CTAs
// of 4 warps (1.352-1.356 on 1, 1.257-1.260 on 2, 1.458-1.474 on 8), the
// old kernel 3.631-3.639, this mapping launched plainly 2.383-2.550;
// nn_select 1.095-1.100 against 3.062-3.084 (2.247-2.284 plainly); empty
// kernels 0.56-0.71 as dependent launches, 1.66-1.92 plainly.  An
// iteration of the chain (reduce, select, step + 1) streamed: 5.14-5.23
// us against 9.28-9.31; replayed as one CUDA graph: 3.91-3.94 against
// 6.58-6.66.  nn_reduce 48 registers at B = 256 (16-151 over B = 1 ..
// 1024), nn_select 26 (16-71), no spills.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kCtaWarps = 4;        // nn_reduce's warps a CTA: paced fastest
constexpr int kMaxCtaThreads = 256; // the widest CTA a variant launches
constexpr unsigned kFull = 0xffffffffu;

// The tree's step: (v2, i2), the pair from the higher position, replaces
// (v1, i1) when v2 < v1, or v2 == v1 and i2 < i1.
__device__ __forceinline__ void take_lesser(float& v1, int& i1, float v2,
                                            int i2) {
  if (v2 < v1 || (v2 == v1 && i2 < i1)) {
    v1 = v2;
    i1 = i2;
  }
}

// The tree's levels OFF, OFF/2, .., 1 over a lane's registers
// v[0 .. 2 OFF): register j takes register j + OFF (a template, so every
// index is constant and the pairs stay in registers).
template <int OFF>
__device__ __forceinline__ void fold(float* v, int* i) {
  if constexpr (OFF >= 1) {
#pragma unroll
    for (int j = 0; j < OFF; ++j) take_lesser(v[j], i[j], v[j + OFF],
                                              i[j + OFF]);
    fold<OFF / 2>(v, i);
  }
}

// The tree's levels LANES/2 .. 1 across a segment of LANES lanes: lane
// t < off takes lane t + off's pair, its own on the left.  Lanes past off
// compute pairs no lane reads again.
template <int LANES>
__device__ __forceinline__ void shuffle_levels(float& v, int& i) {
#pragma unroll
  for (int off = LANES / 2; off >= 1; off /= 2) {
    const float v2 = __shfl_down_sync(kFull, v, off, LANES);
    const int i2 = __shfl_down_sync(kFull, i, off, LANES);
    take_lesser(v, i, v2, i2);
  }
}

__device__ __forceinline__ void wait_for_prerequisites() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;");
}

// JAX's scatter rule for one index: wrap a negative index once, then drop
// what is still out of range (-1 when dropped).
__device__ __forceinline__ int wrap_or_drop(int i, int size) {
  if (i < 0) i += size;
  return (i >= 0 && i < size) ? i : -1;
}

template <typename... K, typename... A>
cudaError_t launch_dependent(void (*kern)(K...), int ctas, int threads,
                             cudaStream_t stream, A... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kern, args...);
}

}  // namespace

// A warp a logical block of B records (32/B blocks a warp below 32);
// blockDim-agnostic (whole warps), so tools/nn_variants.cu can launch it
// at other CTA widths.  taken has no __restrict__: the previous nn_select
// writes it, and its loads must not take the non-coherent path.
template <int B>
__global__ void __launch_bounds__(kMaxCtaThreads)
    nn_reduce_kernel(const float* __restrict__ lat,
                     const float* __restrict__ lng,
                     const float* __restrict__ target, const int* taken,
                     float* pval, int* pidx, int n, int n_pval, int n_pidx,
                     int grid) {
  constexpr int kLanes = B < 32 ? B : 32;        // lanes a logical block
  constexpr int kVals = B < 32 ? 1 : B / 32;     // records a lane
  const int lane = threadIdx.x % 32;
  const long long warp = (long long)blockIdx.x * (blockDim.x / 32) +
                         threadIdx.x / 32;
  if (warp * 32 / kLanes >= grid) return;        // the whole warp is past
  const long long bid = (warp * 32 + lane) / kLanes;
  const long long base = bid * B + lane % kLanes;
  wait_for_prerequisites();
  const float tx = target[0], ty = target[1];
  float la[kVals], lo[kVals];
  int tk[kVals];
#pragma unroll
  for (int j = 0; j < kVals; ++j) {
    const long long gid = base + 32LL * j;
    const int g = gid < n ? (int)gid : n - 1;
    la[j] = lat[g];
    lo[j] = lng[g];
    tk[j] = taken[g];
  }
  launch_dependents();
  float v[kVals];
  int id[kVals];
#pragma unroll
  for (int j = 0; j < kVals; ++j) {
    const long long gid = base + 32LL * j;
    const float dx = __fsub_rn(la[j], tx);
    const float dy = __fsub_rn(lo[j], ty);
    const float d = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
    v[j] = (gid < n && tk[j] == 0) ? d : CUDART_INF_F;
    id[j] = gid < n ? (int)gid : n - 1;
  }
  fold<kVals / 2>(v, id);
  float bv = v[0];
  int bi = id[0];
  shuffle_levels<kLanes>(bv, bi);
  if (lane % kLanes == 0 && bid < grid) {
    if (bid < n_pval) pval[bid] = bv;
    if (bid < n_pidx) pidx[bid] = bi;
  }
}

// One warp over the NB partials (lanes past a segment of NB < 32 repeat
// the first segment's loads); every CTA writes the same winner.
template <int NB>
__global__ void __launch_bounds__(32)
    nn_select_kernel(const float* pval, const int* pidx, const int* step,
                     float* out_d, int* out_i, int* taken, int n_out_d,
                     int n_out_i, int n_taken) {
  constexpr int kLanes = NB < 32 ? NB : 32;
  constexpr int kVals = NB < 32 ? 1 : NB / 32;
  const int l = threadIdx.x % kLanes;
  wait_for_prerequisites();
  float v[kVals];
  int id[kVals];
#pragma unroll
  for (int j = 0; j < kVals; ++j) {
    v[j] = pval[l + 32 * j];
    id[j] = pidx[l + 32 * j];
  }
  const int s = step[0];
  launch_dependents();
  fold<kVals / 2>(v, id);
  float bv = v[0];
  int bi = id[0];
  shuffle_levels<kLanes>(bv, bi);
  if (threadIdx.x == 0) {
    const int od = wrap_or_drop(s, n_out_d), oi = wrap_or_drop(s, n_out_i);
    const int tk = wrap_or_drop(bi, n_taken);
    if (od >= 0) out_d[od] = bv;
    if (oi >= 0) out_i[oi] = bi;
    if (tk >= 0) taken[tk] = 1;
  }
}

namespace {

// The CTAs of `threads` threads that hold a warp a logical block of B
// (32/B blocks a warp below 32) for `grid` blocks.
inline long long nn_reduce_ctas_of(int grid, int block, int threads) {
  const int lanes = block < 32 ? block : 32;
  const long long warps = ((long long)grid * lanes + 31) / 32;
  const int per = threads / 32;
  return (warps + per - 1) / per;
}

template <int B>
cudaError_t launch_reduce(const float* lat, const float* lng,
                          const float* target, const int* taken, float* pval,
                          int* pidx, int n, int n_pval, int n_pidx, int grid,
                          cudaStream_t stream) {
  const int threads = kCtaWarps * 32;
  return launch_dependent(
      nn_reduce_kernel<B>, (int)nn_reduce_ctas_of(grid, B, threads),
      threads, stream, lat, lng, target, taken, pval, pidx, n, n_pval,
      n_pidx, grid);
}

template <int NB>
cudaError_t launch_select(const float* pval, const int* pidx,
                          const int* step, float* out_d, int* out_i,
                          int* taken, int n_out_d, int n_out_i, int n_taken,
                          int grid, cudaStream_t stream) {
  return launch_dependent(nn_select_kernel<NB>, grid, 32, stream, pval,
                          pidx, step, out_d, out_i, taken, n_out_d, n_out_i,
                          n_taken);
}

}  // namespace

// The threads of one nn_reduce CTA; lower_cuda.nn_reduce_ctas gives the
// CTA count.
extern "C" int nn_reduce_cta_threads() { return kCtaWarps * 32; }

// The chevron's `grid` blocks of `block` records, a power of two up to
// 1024 (any other is refused with cudaErrorInvalidValue), launched as a
// programmatic dependent of the work before it on the stream.
extern "C" int launch_nn_reduce(const float* lat, const float* lng,
                                const float* target, const int* taken,
                                float* pval, int* pidx, int n, int n_pval,
                                int n_pidx, int grid, int block,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define NN_REDUCE_CASE(b)                                                 \
  case b:                                                                 \
    return (int)launch_reduce<b>(lat, lng, target, taken, pval, pidx, n, \
                                 n_pval, n_pidx, grid, s);
  switch (block) {
    NN_REDUCE_CASE(1) NN_REDUCE_CASE(2) NN_REDUCE_CASE(4)
    NN_REDUCE_CASE(8) NN_REDUCE_CASE(16) NN_REDUCE_CASE(32)
    NN_REDUCE_CASE(64) NN_REDUCE_CASE(128) NN_REDUCE_CASE(256)
    NN_REDUCE_CASE(512) NN_REDUCE_CASE(1024)
    default: return (int)cudaErrorInvalidValue;
  }
#undef NN_REDUCE_CASE
}

// block == len(pval) == len(pidx), a power of two up to 1024: one warp
// over the partials a CTA, `grid` CTAs each writing the same winner;
// launched as a programmatic dependent.
extern "C" int launch_nn_select(const float* pval, const int* pidx,
                                const int* step, float* out_d, int* out_i,
                                int* taken, int n_out_d, int n_out_i,
                                int n_taken, int grid, int block,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define NN_SELECT_CASE(b)                                                 \
  case b:                                                                 \
    return (int)launch_select<b>(pval, pidx, step, out_d, out_i, taken, \
                                 n_out_d, n_out_i, n_taken, grid, s);
  switch (block) {
    NN_SELECT_CASE(1) NN_SELECT_CASE(2) NN_SELECT_CASE(4)
    NN_SELECT_CASE(8) NN_SELECT_CASE(16) NN_SELECT_CASE(32)
    NN_SELECT_CASE(64) NN_SELECT_CASE(128) NN_SELECT_CASE(256)
    NN_SELECT_CASE(512) NN_SELECT_CASE(1024)
    default: return (int)cudaErrorInvalidValue;
  }
#undef NN_SELECT_CASE
}
