// K4 and K5: fused attention core emitting the NORMALIZED rollout map.
//
// Replaces protopformer_tpu/kernels/attention_core.py::_core_kernel
// (reached via fused_attention_core, K4) and ::_core_kernel_padded (via
// fused_attention_core_padded, K5). K4 is K5 with NP = real_n, so one
// launcher serves both. Two phases on the caller's stream:
//
//   1. attention and the raw fp32 head-mean map: K3's device code
//      (csrc/attention_mean.cu, called through ppf_attention_mean), so the
//      raw map is bit-equal to K3's on the same qkv and policy. A null
//      policy is K4's ones_policy. The map comes out zero outside the real
//      (real_n, real_n) block, as K5 zeroes it before its bisection.
//   2. normalize_kernel: the real (real_n, real_n) block of the map, at
//      row stride NP, is split over a thread-block cluster of
//      map_cluster_size(real_n) CTAs, each holding a band of whole rows in
//      shared memory (ppf::cluster_map_select); the cluster's radix select
//      finds the keep-th largest fp32 key (keep counted on real_n *
//      real_n), the JAX kernel's 31-step bisection from [0, max bits].
//      Each CTA then rewrites its own rows IN PLACE: entries whose bits
//      are below the threshold are zeroed; the identity is added on the
//      real diagonal at identity_weight and the sum divided by
//      1 + identity_weight; each row is divided by its sum (a zero sum by
//      1). Pad rows and columns are neither read nor written and keep
//      phase 1's exact zeros. That is what the JAX code does
//      (eye * real_block): its docstring's "0.2/1.2 on pad diagonals" does
//      not hold, and the port follows the code.
//
// Bound on an H100: K4 in bf16 at B=160, N=197 moves 73.2 MB (qkv, out,
// the fp32 map) = 21.9 us at 3.35 TB/s; in fp32 the products (4.77 GFLOP
// on the 67 TFLOP/s CUDA cores, 71 us) bound it. K5 at NP=256 moves
// ~105 MB (31 us). Phase 1 is K3's (tensor cores in bf16, register-blocked
// SIMT in fp32). Phase 2 is bound by the map's round trip (2 x 24.8 MB at
// B=160, N=197: ~15 us, L2-resident after phase 1). A block per sample
// would hold the whole real map (155 KB, one block an SM, two waves) and
// bisect it in 31 passes; the cluster splits it (4 CTAs of ~52 KB at
// N=197) and selects in 4 passes, as K2 does, and like K2 it is held
// above its bound by the passes' latency and two rounds of clusters. The
// divisions of the blend and the row normalize are by one value each
// (1 + identity_weight, the row sum), so they go through a correctly
// rounded reciprocal and FMA corrections (ppf::div_by_recip), which equal
// div.rn and do not branch. Split over a cluster, the normalize takes
// every real_n <= 256, as phase 1 does. The TPU kernel kept the map in
// VMEM between the phases; fusing them would mean rewriting K3's attention
// inside K4 for ~15 us of traffic.
#include "common.cuh"

extern "C" int ppf_attention_mean(const void* qkv, const void* policy, int B,
                                  int NP, int C, int H, int real_n, int is_bf16,
                                  float scale, float eps_over_n, void* out,
                                  void* map, void* stream);

namespace {

// One discarded-and-blended entry, rounded as the JAX kernel rounds:
// (where(bits >= lo, v, 0) + identity_weight * eye) / (1 + identity_weight);
// r_opiw = __frcp_rn(1 + identity_weight).
__device__ __forceinline__ float blend(float v, bool diag, int lo, float iw,
                                       float one_plus_iw, float r_opiw) {
  const float kept = __float_as_int(v) >= lo ? v : 0.f;
  return ppf::div_by_recip(__fadd_rn(kept, diag ? iw : 0.f), one_plus_iw,
                           r_opiw);
}

__global__ void __launch_bounds__(ppf::kMapThreads, ppf::kMapCtasPerSm)
normalize_kernel(float* __restrict__ map, int NP, int real_n, int keep,
                 float iw, float one_plus_iw) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* m = map + (size_t)blockIdx.y * NP * NP;
  ppf::MapBand band;
  const int lo = static_cast<int>(ppf::cluster_map_select(
      static_cast<const float*>(m), real_n, real_n, NP, false, keep, smem,
      band));

  // the band's rows, one warp a row: each lane blends its (up to 8) entries
  // of the row once, sums them in column order, the warp sums the lanes,
  // and each entry is divided by the row sum
  const float r_opiw = __frcp_rn(one_plus_iw);
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int r = threadIdx.x >> 5; r < band.rows; r += nw) {
    const int i = band.row0 + r;
    const float* row = band.a + r * band.stride;
    float bl[8];
    float sum = 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = lane + ppf::kWarp * u;
      bl[u] = j < real_n ? blend(row[j], i == j, lo, iw, one_plus_iw, r_opiw)
                         : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (lane + ppf::kWarp * u < real_n) sum = __fadd_rn(sum, bl[u]);
    sum = ppf::warp_sum(sum);
    const float denom = sum == 0.f ? 1.f : sum;
    const float r_denom = __frcp_rn(denom);
    float* dst = m + (size_t)i * NP;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = lane + ppf::kWarp * u;
      if (j < real_n) dst[j] = ppf::div_by_recip(bl[u], denom, r_denom);
    }
  }
}

cudaLaunchConfig_t normalize_config(int B, int NP, int real_n,
                                    cudaStream_t stream,
                                    cudaLaunchAttribute* attr) {
  return ppf::cluster_launch_config(ppf::map_cluster_size(real_n), B,
                                    ppf::kMapThreads,
                                    ppf::map_band_smem(real_n, real_n, NP),
                                    stream,
                                    attr);
}

}  // namespace

// qkv: (B, NP, 3C) fp32 or bf16 (is_bf16), rows >= real_n pads; policy:
// (B, NP) fp32 keep-mask with pads 0, or null for all ones; out: (B, NP, C)
// in the qkv dtype; map: (B, NP, NP) fp32, the normalized rollout map.
// scale = hd**-0.5, eps_over_n = 1e-6/real_n, one_plus_iw =
// 1 + identity_weight, all as fp32; keep counts on real_n * real_n;
// real_n <= NP <= 256. Returns the first failing launch's cudaError_t,
// else 0.
extern "C" int ppf_attention_core(const void* qkv, const void* policy, int B,
                                  int NP, int C, int H, int real_n, int keep,
                                  int is_bf16, float scale, float eps_over_n,
                                  float identity_weight, float one_plus_iw,
                                  void* out, void* map, void* stream) {
  const int err = ppf_attention_mean(qkv, policy, B, NP, C, H, real_n, is_bf16,
                                     scale, eps_over_n, out, map, stream);
  if (err != 0) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = normalize_config(
      B, NP, real_n, static_cast<cudaStream_t>(stream), attr);
  cudaError_t e = cudaFuncSetAttribute(
      normalize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cfg.dynamicSmemBytes);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, normalize_kernel, static_cast<float*>(map), NP,
                         real_n, keep, identity_weight, one_plus_iw);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// CTAs per sample (the cluster size) of the normalize launch.
extern "C" int ppf_attention_core_cluster_size(int real_n) {
  return ppf::map_cluster_size(real_n);
}

// How many of the normalize launch's clusters the card can hold at once
// (negative: the cudaError_t of the query).
extern "C" int ppf_attention_core_active_clusters(int real_n, int NP) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = normalize_config(1, NP, real_n, nullptr, attr);
  int clusters = 0;
  cudaError_t e = cudaFuncSetAttribute(
      normalize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cfg.dynamicSmemBytes);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(&clusters, normalize_kernel, &cfg);
  return e == cudaSuccess ? clusters : -static_cast<int>(e);
}
