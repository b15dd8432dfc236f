// reverse: the paper's Listing 3 (dynamicReverse).  One block stages d in
// an extern __shared__ array whose extent the launch gives, barriers, and
// writes it back reversed: d[t] = s[ns - 1 - t], ns = the array's length,
// the cells past the block zero.  A grid of g blocks, which the reference
// runs one after another on the same d, applies that g times.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`, one
// pl.pallas_call per launch) applied to make_reverse
// (src/repro/core/cuda_suite.py:83).
//
// The closed form.  Write B for the block and lo = min(ns - B, B).  One
// pass sets d[t] = 0 for t < lo (s[ns - 1 - t] lies past the block) and
// d[t] = d[ns - 1 - t] for lo <= t < B, a reversal of the window [lo, B)
// onto itself; cells at B and past it are never touched.  So after g >= 1
// passes d[0, lo) is 0, and the window is reversed once for odd g and
// unchanged for even g.  The kernel computes that directly: no shared
// memory, no barrier, and a cost that does not grow with g.  The plain
// version (lower_cuda.reverse_plain) runs the passes one by one, so it
// checks the closed form independently.
//
// Bound on the H100: the launch.  B <= 1024 ints is at most 4 KB, far
// below a microsecond at the memory rate.  The design:
// - one CTA of kCtaWarps warps; a thread swaps disjoint pairs
//   (t, ns - 1 - t) of the window, whose middle cell (odd length) stays,
//   and writes the zeros, so no thread reads a cell another one writes;
// - 16-byte accesses on both sides of a pair, four pairs a lane reversed
//   in registers, where d + lo and d + B lie on 16-byte boundaries; the
//   pairs past the last whole four, and every pair otherwise, one int a
//   lane;
// - a programmatic dependent launch (as needle_nw's): the launch and the
//   CTA's start overlap the tail of the work before it on the stream,
//   which may be another reverse on the same d.  Only index arithmetic
//   runs before griddepcontrol.wait; the zeros and the swaps come after
//   it.
// The launcher keeps the listing's arguments: the extent in bytes as the
// chevron's third argument, from which it derives ns; it launches with no
// dynamic shared memory.  tools/reverse_variants.cu times this kernel
// beside the one it replaced (the listing's passes behind barriers),
// the mapping launched plainly, 1 to 8 warps a CTA with and without the
// 16-byte path, and an empty kernel of the same CTA.  On an NVIDIA H100
// 80GB HBM3 at 700.00 W, 511 launches back to back on one buffer at
// B = ns = 1024: the 16-byte path 1.004 us a launch on 4 or 8 warps,
// 1.215 on 2, 1.577 on 1; one int a lane 1.158 on 8 warps, 1.456 on 4,
// 3.498 on 1; the old kernel 2.135, this mapping launched plainly 2.008;
// an empty kernel 0.549 as a dependent launch and 1.631 plainly.  8 rows
// back to back on their own buffers: 1.520 us a row against 2.488.  Hence
// 8 warps: the 16-byte path paces as on 4, the one-int path faster.  42
// registers on the 16-byte path, 32 on the other, no spills.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kCtaWarps = 8;
constexpr int kMaxSharedBytes = 48 * 1024;   // the old kernel's extent cap

__device__ __forceinline__ void wait_for_prerequisites() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;");
}

// g passes of the one block over d in closed form (odd: g is odd);
// blockDim-agnostic, so tools/reverse_variants.cu can launch it on other
// CTAs.  kVec: d + lo and d + block lie on 16-byte boundaries.
template <bool kVec>
__global__ void __launch_bounds__(1024)
    reverse_kernel(int* d, int block, int ns, int odd) {
  const int t = threadIdx.x, nt = blockDim.x;
  const int lo = min(ns - block, block);
  const int pairs = odd ? (block - lo) / 2 : 0;
  int first = 0;                        // the first pair of the int path
  wait_for_prerequisites();
  launch_dependents();
  if constexpr (kVec) {
    const int quads = pairs / 4;
    for (int q = t; q < quads; q += nt) {
      int4* left = reinterpret_cast<int4*>(d + lo + 4 * q);
      int4* right = reinterpret_cast<int4*>(d + block - 4 - 4 * q);
      const int4 a = *left, b = *right;
      *left = make_int4(b.w, b.z, b.y, b.x);
      *right = make_int4(a.w, a.z, a.y, a.x);
    }
    first = 4 * quads;
  }
  for (int p = first + t; p < pairs; p += nt) {
    const int l = lo + p, r = block - 1 - p;
    const int a = d[l], b = d[r];
    d[l] = b;
    d[r] = a;
  }
  for (int i = t; i < lo; i += nt) d[i] = 0;
}

// Whether d + lo and d + block lie on 16-byte boundaries.
inline bool vec_ok(const int* d, int block, int ns) {
  const int lo = ns - block < block ? ns - block : block;
  return reinterpret_cast<std::uintptr_t>(d + lo) % 16 == 0 &&
         reinterpret_cast<std::uintptr_t>(d + block) % 16 == 0;
}

}  // namespace

// The threads of reverse's one CTA.
extern "C" int reverse_cta_threads() { return kCtaWarps * 32; }

// grid: the logical blocks, applied to d one after another; block, and
// the extern shared extent in bytes, as the chevron gives them.  A launch
// the listing's kernel could not make (no block, more than 1024 threads,
// an extent short of the block or past 48 KB) is refused.
extern "C" int launch_reverse(int* d, int grid, int block, size_t smem_bytes,
                              void* stream) {
  if (grid < 1 || block < 1 || block > 1024)
    return (int)cudaErrorInvalidConfiguration;
  if (smem_bytes > (size_t)kMaxSharedBytes) return (int)cudaErrorInvalidValue;
  const int ns = (int)(smem_bytes / sizeof(int));
  if (ns < block) return (int)cudaErrorInvalidValue;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(kCtaWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int odd = grid & 1;
  if (vec_ok(d, block, ns))
    return (int)cudaLaunchKernelEx(&cfg, reverse_kernel<true>, d, block, ns,
                                   odd);
  return (int)cudaLaunchKernelEx(&cfg, reverse_kernel<false>, d, block, ns,
                                 odd);
}
