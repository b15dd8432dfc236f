// Times src/repro_torch/csrc/flash_decode.cu beside the other shapes of
// its two designs, on one CUDA card:
//   kernel     the shipped launcher at the layout flash_decode_per gives
//              (flash_attention.decode_split's): bfloat16 a thread-block
//              cluster a kv group on the tensor cores, one launch;
//              float32 the split-kv kernel and its merge, two launches;
//   split-kv   bfloat16 only: the shipped split-kv kernel instantiated in
//              bfloat16, the kernel bfloat16 took before the cluster
//              design (a warp a split of B Hkv Skv / 2112 keys rounded up
//              to 32, cp.async into a ring of 3 tiles a warp, partials in
//              a float32 scratch merged by a second kernel);
//   cluster C  bfloat16 only: the shipped kernel at every other cluster
//              size that leaves no rank without keys;
//   mma        bfloat16 only: the tensor-core kernel at W warps and S
//              stages a warp, at every cluster size;
//   cores      the cluster design on the CUDA cores (below: a warp's
//              contiguous K and V rows by cp.async.bulk into a ring of its
//              own, a key row's L lanes summed by shuffles, the warps' and
//              ranks' partials folded as the shipped kernel folds them),
//              W warps a CTA, S stages a warp, NI key rows a lane a tile
//              (a warp's keys a tile are NI 32 / L), at every cluster
//              size, with the CTAs an SM holds at d = 64 and R = 4: the
//              design float32 would take in place of the split-kv kernel.
// The shapes: decode at B 32, H 32, Hkv 8, Skv 4,096, d 64 (the hot
// path's, bfloat16 and float32); deepseek-moe-16b's 16 heads of 128 over
// 1,024 keys; zamba2-7b's 32 heads of 112 over 1,024 keys; qwen2-0.5b's
// 16 heads of 64 (14 / 2 padded to 16 / 16) over 1,024 keys, one slot and
// four.  Each line gives the median of 25 CUDA-event runs after 5
// warm-ups, each behind a spin on the card that covers the host's
// enqueue, the rate over the bytes of K and V, and the max abs gap from
// the shipped kernel's output (the kernel's own line: from a float64
// attention of the same inputs).  Three turns of every variant.  Build
// and run from the repo root:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -Xptxas -v \
//     -o build/flash_decode_variants tools/flash_decode_variants.cu \
//     && build/flash_decode_variants
#include <algorithm>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <string>
#include <vector>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "../src/repro_torch/csrc/flash_decode.cu"

// the library takes this from csrc/matmul_tc.cu; the tool's own copy
PFN_cuTensorMapEncodeTiled_v12000 cupbop_tensor_map_encoder() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return nullptr;
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// the cluster design on the CUDA cores, in either dtype
namespace cores {

// `bytes` (a multiple of 16) from global src to shared dst, both 16-byte
// aligned, completing on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// keys a warp takes from each tile: NI steps of 32 / L rows
template <typename T, int DP, int NI>
__host__ __device__ constexpr int warp_tile() {
  return NI * (32 / (DP * (int)sizeof(T) / 16));
}

// the head of a CTA's dynamic shared memory: its folded (m, l, acc) and
// the W S mbarriers, padded to 128 bytes
template <int DP, int RMAX, int W, int S>
__host__ __device__ constexpr int head_bytes() {
  return (RMAX * (DP + 2) * 4 + W * S * 8 + 127) / 128 * 128;
}

// the dynamic shared memory of a CTA: the head, then each warp's S stages
// of K and V rows (reused for the warps' partials once every tile is
// consumed)
template <typename T, int DP, int RMAX, int W, int S, int NI>
__host__ __device__ constexpr int smem_bytes() {
  constexpr int ring = W * S * 2 * warp_tile<T, DP, NI>() * DP * sizeof(T);
  constexpr int parts = W * RMAX * (DP + 2) * 4;
  return head_bytes<DP, RMAX, W, S>() + (ring > parts ? ring : parts);
}

// T: the dtype; DP: d padded to 32, 64 or 128; RMAX: rows held (>= R);
// W: warps; S: stages a warp; NI: key rows a lane reads a tile
template <typename T, int DP, int RMAX, int W, int S, int NI>
__global__ void __launch_bounds__(32 * W, (RMAX <= 4 ? 16 : 8) / W)
    flash_decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, T* __restrict__ o,
                        float* __restrict__ lse, int H, int Hkv, int Sq,
                        int Skv, int d, int causal, float scale2, int per) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kEPV = 16 / sizeof(T);          // elements a 16-byte load
  constexpr int kL = DP / kEPV;                 // lanes a key row
  constexpr int kKPI = 32 / kL;                 // key rows a step
  constexpr int kTw = NI * kKPI;                // keys a warp a tile
  constexpr int kT = W * kTw;                   // keys a tile
  uint32_t C, rank;                             // the cluster's CTAs, ours
  asm("mov.u32 %0, %%cluster_nctarank;" : "=r"(C));
  asm("mov.u32 %0, %%cluster_ctarank;" : "=r"(rank));
  const int bg = blockIdx.x / C;                // b * Hkv + kv head
  const int g = H / Hkv, R = g * Sq;
  const int b = bg / Hkv, hk = bg % Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int start = (int)rank * per, end = min(start + per, Skv);
  // this warp's keys: [w0 + t kT, w0 + t kT + kTw) of tile t, below end
  const int w0 = start + warp * kTw;
  const int ntile = w0 < end ? (end - w0 + kT - 1) / kT : 0;
  const size_t row_bytes = (size_t)d * sizeof(T);
  const uint32_t part_bytes = (uint32_t)(kTw * row_bytes);

  // [folded m (RMAX), l (RMAX), acc (RMAX x d)] [full (W x S)] ... [ring]
  float* cm = reinterpret_cast<float*>(smem);
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + RMAX * (DP + 2) * 4);
  unsigned char* ring = smem + head_bytes<DP, RMAX, W, S>();
  // this warp's stages and barriers
  unsigned char* mine = ring + (size_t)warp * S * 2 * part_bytes;
  const uint32_t full0 = smem_u32(bars + warp * S);
  const size_t group = (size_t)bg * Skv * d;    // the group's first key
  // lane 0 copies tile t's rows of this warp into stage t % S
  auto issue = [&](int t) {
    const int k0 = w0 + t * kT;
    const uint32_t bytes = (uint32_t)(min(kTw, end - k0) * row_bytes);
    unsigned char* st = mine + (size_t)(t % S) * 2 * part_bytes;
    const uint32_t bar = full0 + 8 * (t % S);
    mbar_expect_tx(bar, 2 * bytes);
    bulk_load(smem_u32(st), k + group + (size_t)k0 * d, bytes, bar);
    bulk_load(smem_u32(st + part_bytes), v + group + (size_t)k0 * d, bytes,
              bar);
  };
  if (lane == 0) {
    for (int s = 0; s < S; ++s) mbar_init(full0 + 8 * s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int t = 0; t < S && t < ntile; ++t) issue(t);
  }
  __syncwarp();

  const size_t qrow = ((size_t)b * H + (size_t)hk * g) * Sq * d;
  const int kg = lane / kL, col = (lane % kL) * kEPV;
  const bool colok = col < d;                   // d % kEPV == 0
  float qv[RMAX][kEPV], m[RMAX], l[RMAX], acc[RMAX][kEPV];
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r < R && colok) {
      unpack<T>(*reinterpret_cast<const uint4*>(q + qrow + (size_t)r * d +
                                                col),
                qv[r]);
    } else {
#pragma unroll
      for (int e = 0; e < kEPV; ++e) qv[r][e] = 0.0f;
    }
    m[r] = kMasked;
    l[r] = 0.0f;
#pragma unroll
    for (int e = 0; e < kEPV; ++e) acc[r][e] = 0.0f;
  }
  for (int t = 0; t < ntile; ++t) {
    mbar_wait(full0 + 8 * (t % S), (t / S) & 1);
    const unsigned char* st = mine + (size_t)(t % S) * 2 * part_bytes;
    const int k0 = w0 + t * kT + kg;            // this lane's first key
    float sc[RMAX][NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int key = k0 + i * kKPI;
      float kf[kEPV];
      if (key < end && colok) {
        unpack<T>(*reinterpret_cast<const uint4*>(
                      st + (size_t)(kg + i * kKPI) * row_bytes +
                      col * sizeof(T)),
                  kf);
      } else {
#pragma unroll
        for (int e = 0; e < kEPV; ++e) kf[e] = 0.0f;
      }
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r >= R) break;                      // uniform across the warp
        float part = 0.0f;
#pragma unroll
        for (int e = 0; e < kEPV; ++e) part = fmaf(qv[r][e], kf[e], part);
#pragma unroll
        for (int off = 1; off < kL; off <<= 1)
          part += __shfl_xor_sync(0xffffffffu, part, off);
        sc[r][i] = (key < end && (!causal || r % Sq >= key))
                       ? part * scale2
                       : kMasked;
      }
    }
#pragma unroll
    for (int r = 0; r < RMAX; ++r) {
      if (r >= R) break;
      float mx = kMasked;
#pragma unroll
      for (int i = 0; i < NI; ++i) mx = fmaxf(mx, sc[r][i]);
#pragma unroll
      for (int off = kL; off < 32; off <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float corr = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr;
#pragma unroll
      for (int e = 0; e < kEPV; ++e) acc[r][e] *= corr;
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        sc[r][i] = sc[r][i] == kMasked ? 0.0f : exp2f(sc[r][i] - m_new);
        l[r] += sc[r][i];                       // p
      }
    }
#pragma unroll
    for (int i = 0; i < NI; ++i) {
      const int key = k0 + i * kKPI;
      float vf[kEPV];
      if (key < end && colok) {
        unpack<T>(*reinterpret_cast<const uint4*>(
                      st + part_bytes + (size_t)(kg + i * kKPI) * row_bytes +
                      col * sizeof(T)),
                  vf);
      } else {
#pragma unroll
        for (int e = 0; e < kEPV; ++e) vf[e] = 0.0f;
      }
#pragma unroll
      for (int r = 0; r < RMAX; ++r) {
        if (r >= R) break;
#pragma unroll
        for (int e = 0; e < kEPV; ++e)
          acc[r][e] = fmaf(sc[r][i], vf[e], acc[r][e]);
      }
    }
    // the stage is read: refill it with tile t + S
    __syncwarp();
    if (lane == 0 && t + S < ntile) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      issue(t + S);
    }
  }
  // sum the row slots (lanes with the same column, other keys)
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r >= R) break;
#pragma unroll
    for (int off = kL; off < 32; off <<= 1) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], off);
#pragma unroll
      for (int e = 0; e < kEPV; ++e)
        acc[r][e] += __shfl_xor_sync(0xffffffffu, acc[r][e], off);
    }
  }
  __syncthreads();                              // every tile consumed
  // the warps' partials where the ring was: m [W][RMAX], l [W][RMAX],
  // acc [W][RMAX][d]
  float* wm = reinterpret_cast<float*>(ring);
  float* wl = wm + W * RMAX;
  float* wacc = wl + W * RMAX;
#pragma unroll
  for (int r = 0; r < RMAX; ++r) {
    if (r >= R) break;
    if (kg == 0 && colok) {
#pragma unroll
      for (int e = 0; e < kEPV; ++e)
        wacc[((size_t)warp * RMAX + r) * d + col + e] = acc[r][e];
    }
    if (lane == 0) {
      wm[warp * RMAX + r] = m[r];
      wl[warp * RMAX + r] = l[r];
    }
  }
  __syncthreads();
  fold_and_store<T, RMAX, W>(wm, wl, wacc, cm, o, lse, qrow,
                             ((size_t)b * H + (size_t)hk * g) * Sq, R, d, C,
                             rank);
}

template <typename T, int DP, int RMAX, int W, int S, int NI>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int B, int H, int Hkv, int Sq, int Skv, int d,
                   int causal, float scale, int cluster, int per,
                   cudaStream_t stream) {
  constexpr int kSmem = smem_bytes<T, DP, RMAX, W, S, NI>();
  const long long ctas = (long long)B * Hkv * cluster;
  if (ctas > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  auto kern = flash_decode_kernel<T, DP, RMAX, W, S, NI>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)ctas);
  cfg.blockDim = dim3(32 * W);
  cfg.dynamicSmemBytes = kSmem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, (const T*)q, (const T*)k,
                           (const T*)v, (T*)o, lse, H, Hkv, Sq, Skv, d,
                           causal, scale * kLog2e, per);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the instantiation for R rows at width d, W warps, S stages a warp and
// NI key rows a lane a tile
template <typename T, int W, int S, int NI>
cudaError_t launch_any(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int Hkv, int Sq, int Skv,
                       int d, int causal, float scale, int cluster, int per,
                       cudaStream_t s) {
  const int R = H / Hkv * Sq;
#define ROWS(DP)                                                         \
  if (R == 1)                                                            \
    return launch<T, DP, 1, W, S, NI>(q, k, v, o, lse, B, H, Hkv, Sq,    \
                                      Skv, d, causal, scale, cluster,    \
                                      per, s);                           \
  if (R <= 4)                                                            \
    return launch<T, DP, 4, W, S, NI>(q, k, v, o, lse, B, H, Hkv, Sq,    \
                                      Skv, d, causal, scale, cluster,    \
                                      per, s);                           \
  return launch<T, DP, 8, W, S, NI>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, \
                                    d, causal, scale, cluster, per, s);
  if (d <= 32) { ROWS(32) }
  if (d <= 64) { ROWS(64) }
  ROWS(128)
#undef ROWS
}

}  // namespace cores

namespace {

// ~cycles of spin on the card, ahead of a timed run
__global__ void spin(long long cycles) {
  const long long t0 = clock64();
  while (clock64() - t0 < cycles) {
  }
}

// median of 25 runs after 5 warm-ups, each behind a spin that covers the
// host's enqueue (the tensor-core path encodes two tensor maps a call)
template <typename F>
float median_ms(F f) {
  cudaEvent_t e0, e1;
  cudaEventCreate(&e0);
  cudaEventCreate(&e1);
  for (int i = 0; i < 5; ++i) f();
  std::vector<float> ts;
  for (int r = 0; r < 25; ++r) {
    spin<<<1, 1>>>(100000);
    cudaEventRecord(e0);
    f();
    cudaEventRecord(e1);
    cudaEventSynchronize(e1);
    float ms;
    cudaEventElapsedTime(&ms, e0, e1);
    ts.push_back(ms);
  }
  cudaEventDestroy(e0);
  cudaEventDestroy(e1);
  std::sort(ts.begin(), ts.end());
  return ts[ts.size() / 2];
}

float host_f32(float v) { return v; }
float host_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T>
T host_from(float v) {
  if constexpr (sizeof(T) == 2) {
    return __float2bfloat16_rn(v);
  } else {
    return v;
  }
}

struct Shape {
  const char* name;
  int B, H, Hkv, Skv, d;
};

template <typename T>
void run_shape(const Shape& sh) {
  const int B = sh.B, H = sh.H, Hkv = sh.Hkv, Sq = 1, Skv = sh.Skv,
            d = sh.d;
  const int bf16 = sizeof(T) == 2, size = sizeof(T);
  const size_t nq = (size_t)B * H * Sq * d, nk = (size_t)B * Hkv * Skv * d;
  std::vector<T> hq(nq), hk(nk), hv(nk), got(nq);
  srand(42);
  auto draw = [] { return rand() / (float)RAND_MAX * 4 - 2; };
  for (auto& x : hq) x = host_from<T>(draw());
  for (auto& x : hk) x = host_from<T>(draw());
  for (auto& x : hv) x = host_from<T>(draw());
  // float64 attention of the same values
  const int g = H / Hkv;
  const double sc = 1.0 / std::sqrt((double)d);
  std::vector<double> exact(nq);
  std::vector<double> s(Skv);
  for (int b = 0; b < B; ++b)
    for (int h = 0; h < H; ++h) {
      const T* qr = hq.data() + ((size_t)b * H + h) * d;
      const size_t kb = ((size_t)b * Hkv + h / g) * Skv * d;
      double mx = -1e300;
      for (int j = 0; j < Skv; ++j) {
        double a = 0;
        for (int e = 0; e < d; ++e)
          a += (double)host_f32(qr[e]) * host_f32(hk[kb + (size_t)j * d + e]);
        s[j] = a * sc;
        mx = std::max(mx, s[j]);
      }
      double l = 0;
      for (int j = 0; j < Skv; ++j) l += (s[j] = std::exp(s[j] - mx));
      for (int e = 0; e < d; ++e) {
        double a = 0;
        for (int j = 0; j < Skv; ++j)
          a += s[j] * host_f32(hv[kb + (size_t)j * d + e]);
        exact[((size_t)b * H + h) * d + e] = a / l;
      }
    }
  T *dq, *dk, *dv, *dout;
  cudaMalloc(&dq, nq * size);
  cudaMalloc(&dk, nk * size);
  cudaMalloc(&dv, nk * size);
  cudaMalloc(&dout, nq * size);
  cudaMemcpy(dq, hq.data(), nq * size, cudaMemcpyHostToDevice);
  cudaMemcpy(dk, hk.data(), nk * size, cudaMemcpyHostToDevice);
  cudaMemcpy(dv, hv.data(), nk * size, cudaMemcpyHostToDevice);
  const int dp = d <= 32 ? 32 : d <= 64 ? 64 : 128;
  const int tw = bf16 ? kMmaTile : kNI * 32 / (dp * size / 16);
  // the shipped layout, and the split-kv kernel's in bfloat16
  const int per = flash_decode_per(B, Hkv, Skv, d, bf16);
  const int parts = (Skv + per - 1) / per;
  const int split = flash_decode_per(B, Hkv, Skv, d, 0);
  const int nsplit = (Skv + split - 1) / split;
  const size_t prow = (size_t)B * Hkv * nsplit * g * Sq;
  float *pm, *pl, *pa;
  cudaMalloc(&pm, prow * 4);
  cudaMalloc(&pl, prow * 4);
  cudaMalloc(&pa, prow * d * 4);
  const float scale = 1.0f / std::sqrt((float)d);
  const double mb = 2.0 * nk * size / 1e6;
  printf("%s %s: B %d H %d Hkv %d Skv %d d %d, %.3f MB of K and V, bound "
         "%.5f ms; kernel parts %d per %d; split-kv split %d nsplit %d\n",
         sh.name, bf16 ? "bfloat16" : "float32", B, H, Hkv, Skv, d, mb,
         mb / 3.35e3, parts, per, split, nsplit);
  std::vector<T> want(nq);
  auto run = [&](int turn, const std::string& name, auto launch) {
    cudaMemset(dout, 0, nq * size);
    const float ms = median_ms([&] { launch(); });
    const cudaError_t err = cudaDeviceSynchronize();
    const cudaError_t last = cudaGetLastError();
    cudaMemcpy(got.data(), dout, nq * size, cudaMemcpyDeviceToHost);
    double e = 0;
    const bool self = name == "kernel";
    if (self) want = got;
    for (size_t i = 0; i < nq; ++i)
      e = std::max(e, std::fabs((double)host_f32(got[i]) -
                                (self ? exact[i] : host_f32(want[i]))));
    printf("turn %d %-9s %-28s %.5f ms  %.3f TB/s  max_abs_%s %.3g  %s\n",
           turn, bf16 ? "bfloat16" : "float32", name.c_str(), ms,
           mb / ms / 1e3, self ? "err" : "gap", e,
           cudaGetErrorString(err != cudaSuccess ? err : last));
  };
  // every cluster size at which no rank of w warps' tiles of tile keys
  // is left without keys, and its keys a rank
  auto clusters = [&](int w, int tile, auto fn) {
    for (int c = 1; c <= kMaxCluster; c *= 2) {
      const int pc = (Skv + c * w * tile - 1) / (c * w * tile) * w * tile;
      if ((c - 1) * pc < Skv) fn(c, pc);
    }
  };
  for (int turn = 0; turn < 3; ++turn) {
    run(turn, "kernel", [&] {
      launch_flash_decode(dq, dk, dv, dout, pm, pl, pa, B, H, Hkv, Sq, Skv,
                          d, 0, scale, parts, per, tw, bf16, nullptr,
                          nullptr);
    });
    if constexpr (sizeof(T) == 2) {
      run(turn, "split-kv", [&] {
        launch_split_d<T>(dq, dk, dv, dout, nullptr, pm, pl, pa, B, H, Hkv,
                          Sq, Skv, d, 0, scale, split, nsplit, nullptr);
      });
      clusters(kWarps, kMmaTile, [&](int c, int pc) {
        if (c == parts) return;
        run(turn, "cluster " + std::to_string(c), [&] {
          launch_flash_decode(dq, dk, dv, dout, nullptr, nullptr, nullptr, B,
                              H, Hkv, Sq, Skv, d, 0, scale, c, pc, tw, bf16,
                              nullptr, nullptr);
        });
      });
      auto mma = [&](int w, int st, auto fn, auto kern, int smem) {
        int per_sm = 0;
        cudaFuncSetAttribute(kern,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 32 * w,
                                                      smem);
        clusters(w, kMmaTile, [&](int c, int pc) {
          run(turn,
              "mma warps " + std::to_string(w) + " stages " +
                  std::to_string(st) + " C " + std::to_string(c) + " (" +
                  std::to_string(per_sm) + "/SM)",
              [&] {
                fn(dq, dk, dv, dout, nullptr, B, H, Hkv, Sq, Skv, d, 0,
                   scale, c, pc, nullptr);
              });
        });
      };
#define MMA(W_, S_)                                                        \
  mma(W_, S_, launch_mma<W_, S_>, flash_decode_mma_kernel<64, W_, S_>,    \
      MmaTile<64, W_, S_>::kSmem);
      MMA(4, 4) MMA(4, 3) MMA(2, 4) MMA(8, 2)
#undef MMA
    }
    auto knob = [&](int w, int st, int ni, auto fn, auto kern, int smem) {
      int per_sm = 0;
      const int twk = ni * 32 / (dp * size / 16);
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           smem);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, 32 * w,
                                                    smem);
      clusters(w, twk, [&](int c, int pc) {
        run(turn,
            "cores warps " + std::to_string(w) + " stages " +
                std::to_string(st) + " rows " + std::to_string(ni) + " C " +
                std::to_string(c) + " (" + std::to_string(per_sm) + "/SM)",
            [&] {
              fn(dq, dk, dv, dout, nullptr, B, H, Hkv, Sq, Skv, d, 0, scale,
                 c, pc, nullptr);
            });
      });
    };
#define KNOB(W_, S_, NI_)                                                  \
  knob(W_, S_, NI_, cores::launch_any<T, W_, S_, NI_>,                    \
       cores::flash_decode_kernel<T, 64, 4, W_, S_, NI_>,                 \
       cores::smem_bytes<T, 64, 4, W_, S_, NI_>());
    KNOB(4, 3, 4) KNOB(4, 4, 4) KNOB(4, 2, 4) KNOB(8, 3, 4) KNOB(8, 2, 4)
    KNOB(8, 3, 2) KNOB(2, 3, 4)
#undef KNOB
  }
  cudaFree(dq);
  cudaFree(dk);
  cudaFree(dv);
  cudaFree(dout);
  cudaFree(pm);
  cudaFree(pl);
  cudaFree(pa);
}

}  // namespace

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  printf("device: %s, %d SMs\n", prop.name, prop.multiProcessorCount);
  const Shape shapes[] = {
      {"hot", 32, 32, 8, 4096, 64},
      {"d128_moe", 1, 16, 16, 1024, 128},
      {"d112_zamba2", 1, 32, 32, 1024, 112},
      {"qwen2_1slot", 1, 16, 16, 1024, 64},
      {"qwen2_4slots", 4, 16, 16, 1024, 64},
  };
  for (const Shape& sh : shapes) run_shape<__nv_bfloat16>(sh);
  run_shape<float>(shapes[0]);
  return 0;
}
