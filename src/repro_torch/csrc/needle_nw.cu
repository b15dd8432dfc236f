// needle_nw: one anti-diagonal of the Needleman-Wunsch wavefront (Rodinia
// nw).  Cell (i, j) with i + j == d takes
//   max(score[i-1][j-1] + sim[i-1][j-1], score[i-1][j] - p, score[i][j-1] - p)
// on the row-major (n+1) x (n+1) score matrix.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`)
// applied to make_needle_nw (src/repro/core/cuda_suite.py:539).
//
// Bound on the H100: the fixed cost of a launch.  A diagonal holds at most
// n cells (2048 at Rodinia size, 40 KB of traffic: 0.00001 ms at 3.35
// TB/s), while an empty launch takes 0.0049 ms under CUDA events, so the
// 2n - 1 launches of a run are paced by the launch and by the latency of
// the loads that follow it.  The design:
// - full warps.  The chevron's logical blocks of 16 threads (n / 16 of
//   them) run on CTAs of kCtaThreads threads, thread t of the logical grid
//   keeping cell t of the diagonal; lower_cuda.needle_nw_ctas gives the
//   CTA count.  A CTA of 16 threads left every warp half empty;
// - a programmatic dependent launch (cudaLaunchAttributeProgrammatic
//   StreamSerialization, as srad_update's stencil is the fold's).  The
//   launch and the CTAs' start overlap the previous kernel's tail; only
//   index arithmetic runs before griddepcontrol.wait, and no global
//   memory (diag, score, sim) is touched before it, since the previous
//   launch of a chain writes the diagonal this one reads.  Each thread
//   signals griddepcontrol.launch_dependents once its loads are issued.
//   Both instructions do nothing in a kernel launched without the
//   attribute.
// Cells of one diagonal lie 4 (n + 1) bytes apart, so each access is a
// sector of its own: the layout is the entry's.  The guard t > hi - lo
// keeps a diagonal out of range from writing anything.  int32 throughout,
// so the cells equal the plain version's bit for bit.
// tools/needle_nw_variants.cu times this kernel beside the one it replaced
// (the chevron's 16-thread CTAs, plain launch), the same mapping without
// the attribute, other CTA widths and an empty kernel of the same CTAs
// with and without it.  On an NVIDIA H100 80GB HBM3 at 700.00 W, two runs,
// 512 launches back to back on the longest diagonal: this kernel
// 1.364-1.368 us a launch, the old one 2.240-2.298, this mapping launched
// plainly 2.440-2.496 (full warps alone do not pay), CTAs of 16 to 64
// threads 1.15-1.31 and of 256 1.68 as dependent launches, an empty kernel
// 0.59 as a dependent launch and 1.70-1.75 plainly.  The whole chain with
// its update kernel streamed: 3.43-3.47 us a diagonal against 4.37-4.41;
// replayed as one CUDA graph: 2.83-2.89 against 2.44-2.50, since the
// dependent launch after an update that never triggers costs there.
// 24 registers, no spills.
// n, penalty and the logical grid are runtime arguments; the diagonal
// index is read from device memory, so the host never waits on the card
// between launches.
#include <cuda_runtime.h>

namespace {

constexpr int kCtaThreads = 128;

}  // namespace

// blockDim-agnostic, so tools/needle_nw_variants.cu can launch it at
// other CTA widths; `total` is the logical grid's thread count.
__global__ void needle_nw_cells(int* score, const int* __restrict__ sim,
                                const int* __restrict__ diag, int n,
                                int penalty, int total) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int d = diag[0];
  const int lo = max(1, d - n);
  const int hi = min(n, d - 1);
  if (t > hi - lo) return;
  const int i = t + lo;
  const int j = d - i;
  const size_t w = (size_t)n + 1;
  const int s = score[(i - 1) * w + (j - 1)];
  const int m = sim[(i - 1) * (size_t)n + (j - 1)];
  const int up = score[(i - 1) * w + j];
  const int lf = score[i * w + (j - 1)];
  asm volatile("griddepcontrol.launch_dependents;");
  score[i * w + j] = max(s + m, max(up - penalty, lf - penalty));
}

// The threads of one CTA; lower_cuda.needle_nw_ctas gives the CTA count.
extern "C" int needle_nw_cta_threads() { return kCtaThreads; }

// The chevron's grid of blocks of `block` threads, run as `ctas` CTAs of
// kCtaThreads threads, launched as a programmatic dependent of the work
// before it on the stream.
extern "C" int launch_needle_nw(int* score, const int* sim, const int* diag,
                                int n, int penalty, int grid, int block,
                                int ctas, void* stream) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas);
  cfg.blockDim = dim3(kCtaThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, needle_nw_cells, score, sim, diag, n,
                                 penalty, grid * block);
}
