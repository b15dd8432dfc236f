// lavamd: the particle potential of Rodinia lavaMD over a neighbour-box
// list.  Logical block b owns home box b, its thread t particle b*ppb + t:
//   force[b*ppb + t] = sum_k u_k,  u_k = sum_j q[s_kj] * exp(-alpha*d*d),
//   d = pos[b*ppb + t] - pos[s_kj],  s_kj = nbr[b, k] * ppb + j,
// the u_k added in k order and each u_k summed over j in order.
//
// Replaces: the TPU kernel src/repro/core/pallas_emit.py:34 (`run`)
// applied to make_lavamd (src/repro/core/cuda_suite.py:756).
//
// Bound on the H100: operations, one exp a pair term (2.7e8 terms at
// lavaMD -boxes1d 10 against 1.3 MB of data).  The reference's block of
// ppb threads stages one neighbour at a time between two barriers; at ppb
// = 100 that left a warp with 4 live lanes.  Here a CTA still owns one
// home box, but:
//   - it stages (pos, q) of every neighbour box once, as float2s in
//     dynamic __shared__, behind one barrier (27 x 100 x 8 B = 21.6 KB at
//     the main path; neighbours in chunks where nnei * ppb * 12 B passes
//     kSmemBudget, since ppb runs up to 1024);
//   - its threads take (neighbour k, pair of home particles) items,
//     k-major, so that a warp's lanes read one staged float2 as a
//     broadcast and each float2 feeds two terms; the CTA is as wide as the
//     items need, up to 512 threads, so that an SM holds 64 warps;
//   - each item's u_k goes to __shared__ [chunk][ppb]; after a barrier
//     thread t adds its particle's u_k in k order.
// Each term is expf (not __expf, no fast math) of ((-alpha) d) d, rounded
// as the plain version rounds it, and an FFMA into u_k: about 13
// instructions a term with the loop's share, so the kernel is bound by
// instruction issue before the special-function units.  Its j loop is
// unrolled by 16: the loop's own instructions cost 4-18 % at unrolls of 4
// to 1, 1-3 % at 8.  tools/lavamd_variants.cu times this design's other
// widths, particles a thread and unrolls, chunks of neighbours spread
// over CTAs with the sum in a second kernel, and ex2.approx for the exp;
// PERF.md has the numbers.  The gathers follow the reference's rule for an
// index out of range: wrap a negative flat index once, then clamp it,
// element by element.
#include <cuda_runtime.h>

namespace {

constexpr int kR = 2;                // home particles a thread
constexpr int kMaxThreads = 512;     // the CTA's width, a multiple of 32
constexpr int kSmemBudget = 48 * 1024;   // a chunk's shared bytes

// The flat index of particle j of box nb, wrapped once and clamped.
__device__ __forceinline__ long long gather_index(int nb, int ppb, int j,
                                                  long long n) {
  long long s = (long long)nb * ppb + j;
  if (s < 0) s += n;
  return s < 0 ? 0 : (s >= n ? n - 1 : s);
}

__global__ void __launch_bounds__(kMaxThreads)
    lavamd_kernel(const float* __restrict__ pos, const float* __restrict__ q,
                  const int* __restrict__ nbr, float* __restrict__ force,
                  int nboxes, int ppb, int nnei, int chunk, float alpha) {
  extern __shared__ float2 sh[];
  float2* syq = sh;                                         // [chunk][ppb]
  float* su = reinterpret_cast<float*>(sh + chunk * ppb);   // [chunk][ppb]
  float* sacc = su + chunk * ppb;                           // [ppb]
  const int b = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const long long n = (long long)nboxes * ppb;
  const int groups = (ppb + kR - 1) / kR;
  const float* home = pos + (size_t)b * ppb;
  const int* nb = nbr + (size_t)b * nnei;
  const float nalpha = -alpha;
  if (nnei == 0)                       // no neighbour: the sum is 0
    for (int t = tid; t < ppb; t += nt) force[(size_t)b * ppb + t] = 0.0f;
  for (int k0 = 0; k0 < nnei; k0 += chunk) {
    const int kc = min(chunk, nnei - k0);
    for (int i = tid; i < kc * ppb; i += nt) {
      const int k = i / ppb;
      const long long s = gather_index(nb[k0 + k], ppb, i - k * ppb, n);
      syq[i] = make_float2(pos[s], q[s]);
    }
    __syncthreads();
    for (int item = tid; item < kc * groups; item += nt) {
      const int k = item / groups, t0 = (item - k * groups) * kR;
      float x[kR], u[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        x[r] = home[min(t0 + r, ppb - 1)];
        u[r] = 0.0f;
      }
      const float2* yq = syq + k * ppb;
#pragma unroll 16
      for (int j = 0; j < ppb; ++j) {
        const float2 v = yq[j];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const float d = x[r] - v.x;
          u[r] = fmaf(v.y, expf(nalpha * d * d), u[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r)
        if (t0 + r < ppb) su[k * ppb + t0 + r] = u[r];
    }
    __syncthreads();
    const bool last = k0 + kc >= nnei;
    for (int t = tid; t < ppb; t += nt) {
      float acc = k0 ? sacc[t] : 0.0f;
      for (int k = 0; k < kc; ++k) acc += su[k * ppb + t];
      if (last)
        force[(size_t)b * ppb + t] = acc;
      else
        sacc[t] = acc;
    }
    // the next chunk's staging overwrites what this one read; thread t
    // alone reads and writes sacc[t]
    if (!last) __syncthreads();
  }
}

// Neighbours staged together: as many as kSmemBudget holds, at least one.
int chunk_of(int ppb, int nnei) {
  const int per = ppb * (int)(sizeof(float2) + sizeof(float));
  const int fit = (kSmemBudget - ppb * (int)sizeof(float)) / per;
  return fit < 1 || nnei < 1 ? 1 : (fit < nnei ? fit : nnei);
}

// As many threads as a chunk's items, in whole warps, up to kMaxThreads.
int threads_of(int ppb, int nnei) {
  const long long items =
      (long long)chunk_of(ppb, nnei) * ((ppb + kR - 1) / kR);
  const long long t = (items + 31) / 32 * 32;
  return t < kMaxThreads ? (int)t : kMaxThreads;
}

}  // namespace

// The launcher's CTA: its threads and the neighbours it stages together,
// for chip_smoke.py's line and the variant tool.
extern "C" int lavamd_cta_threads(int ppb, int nnei) {
  return threads_of(ppb, nnei);
}
extern "C" int lavamd_chunk(int ppb, int nnei) { return chunk_of(ppb, nnei); }

// grid home boxes (grid <= nboxes, the wrapper's check), a CTA each.
extern "C" int launch_lavamd(const float* pos, const float* q, const int* nbr,
                             float* force, int nboxes, int ppb, int nnei,
                             float alpha, int grid, void* stream) {
  const int chunk = chunk_of(ppb, nnei);
  const size_t smem = (size_t)chunk * ppb * (sizeof(float2) + sizeof(float))
                      + (size_t)ppb * sizeof(float);
  lavamd_kernel<<<grid, threads_of(ppb, nnei), smem, (cudaStream_t)stream>>>(
      pos, q, nbr, force, nboxes, ppb, nnei, chunk, alpha);
  return (int)cudaGetLastError();
}
