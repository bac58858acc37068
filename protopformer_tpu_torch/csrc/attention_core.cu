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
// every real_n <= NP, as phase 1 does: above 256 real rows with
// K2's long select (map_stats.cu; common.cuh, cluster_radix_select_long),
// above 512 in a cluster of 16 CTAs with bands of up to 40 rows (37 at
// 577, ~114 KB of shared memory: two CTAs an SM; measured 0.541 -> 0.437
// ms at 577, B=160, and 1.08 -> 0.72 ms at real 577 in NP 640, B=256, on
// an H100 at 700 W, PERF.md), and past 640 real rows on the select's
// in-place route, which reads each CTA's rows of the map in place and
// rewrites them there, where the rows start on 128-byte lines (NP a
// multiple of 32: K5's bench pad, 896) or the band no longer fits shared
// memory (from ~850 real rows); rows that straddle lines (K4 at 785) keep
// the band, which reads faster there (normalize_route). At
// B=160, N=577 in fp32
// K4 moves 429 MB (qkv, out, the map) and its products are 164 GFLOP at
// H=12: 2.44 ms on the CUDA cores bounds it; the normalize's round trip of
// the 213 MB map is 0.13 ms at the memory rate, no longer L2-resident. In
// bf16 above 256 tokens phase 1 is K3's bf16 long kernel (stored logits,
// K and V read once a head). The TPU kernel kept the map in VMEM between
// the phases; fusing them would mean rewriting K3's attention inside K4
// for ~15 us of traffic at N=197.
#include "common.cuh"

extern "C" int ppf_attention_mean(const void* qkv, const void* policy, int B,
                                  int NP, int C, int H, int real_n, int is_bf16,
                                  float scale, float eps_over_n, void* out,
                                  void* map, void* stream, void* scratch);

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

// kRoute: the select's route (ppf::map_route); on kMapGlobal the band is
// the map's own rows, blended and normalized in place there.
template <int kRoute>
__global__ void __launch_bounds__(
    ppf::kMapThreads, ppf::map_ctas_per_sm(kRoute == ppf::kMapOneStep))
normalize_kernel(float* __restrict__ map, int NP, int real_n, int keep,
                 float iw, float one_plus_iw) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kOneStep = kRoute == ppf::kMapOneStep;
  float* m = map + (size_t)blockIdx.y * NP * NP;
  ppf::map_band_t<kRoute, float> band;
  const int lo = static_cast<int>(ppf::cluster_map_select<kRoute>(
      static_cast<const float*>(m), real_n, real_n, NP, false, keep, smem,
      band));

  // the band's rows, one warp a row: each lane blends its entries of the
  // row once, 8 a step of ppf::kRowStep columns, sums them in column order,
  // the warp sums the lanes, and each entry is divided by the row sum. Up
  // to 256 columns the blended entries stay in registers; above, each step
  // writes them back into the band in place (on the global route the band
  // is the row itself, and each entry is rewritten by the lane that wrote
  // it).
  const float r_opiw = __frcp_rn(one_plus_iw);
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  // blends row i's 8 entries of this lane from column c0 into bl and adds
  // them to sum
  auto blend_step = [&](const float* row, int i, int c0, float (&bl)[8],
                        float& sum) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = c0 + lane + ppf::kWarp * u;
      bl[u] = j < real_n ? blend(row[j], i == j, lo, iw, one_plus_iw, r_opiw)
                         : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (c0 + lane + ppf::kWarp * u < real_n) sum = __fadd_rn(sum, bl[u]);
  };
  for (int r = threadIdx.x >> 5; r < band.rows; r += nw) {
    const int i = band.row0 + r;
    float* row = band.a + r * band.stride;
    float* dst = m + (size_t)i * NP;
    float bl[8];
    float sum = 0.f;
    if (kOneStep) {
      blend_step(row, i, 0, bl, sum);
      sum = ppf::warp_sum(sum);
      const float denom = sum == 0.f ? 1.f : sum;
      const float r_denom = __frcp_rn(denom);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int j = lane + ppf::kWarp * u;
        if (j < real_n) dst[j] = ppf::div_by_recip(bl[u], denom, r_denom);
      }
    } else {
      for (int c0 = 0; c0 < real_n; c0 += ppf::kRowStep) {
        blend_step(row, i, c0, bl, sum);
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int j = c0 + lane + ppf::kWarp * u;
          if (j < real_n) row[j] = bl[u];
        }
      }
      sum = ppf::warp_sum(sum);
      const float denom = sum == 0.f ? 1.f : sum;
      const float r_denom = __frcp_rn(denom);
      for (int j = lane; j < real_n; j += ppf::kWarp)
        dst[j] = ppf::div_by_recip(row[j], denom, r_denom);
    }
  }
  if constexpr (!kOneStep) ppf::cluster_wait();
}

// The normalize kernel on `route` (ppf::map_route's numbers).
auto normalize_kernel_on(int route) {
  switch (route) {
    case ppf::kMapOneStep: return normalize_kernel<ppf::kMapOneStep>;
    case ppf::kMapLong: return normalize_kernel<ppf::kMapLong>;
    default: return normalize_kernel<ppf::kMapGlobal>;
  }
}

// The normalize's route for the real (real_n, real_n) block at row stride
// NP: the select's (ppf::map_route), but past kMapLongCols columns the
// band in shared memory where it fits unless the rows start on 128-byte
// lines (NP a multiple of 32). The in-place route rewrites each row where
// it lies, blended, then divided: on rows that straddle lines it reads
// slower than the band, on aligned ones faster (K5's NP 896; measured at
// 641-849 real rows on an H100, PERF.md).
int normalize_route(int real_n, int NP) {
  const int route = ppf::map_route(real_n, real_n, NP);
  if (route == ppf::kMapGlobal && NP % 32 != 0 &&
      ppf::map_route_takes(ppf::kMapLong, real_n, real_n, NP))
    return ppf::kMapLong;
  return route;
}

// The normalize launch of B maps on its route (normalize_route), its
// kernel set up for it. `attr` must outlive the launch call.
cudaError_t configure_normalize(int B, int NP, int real_n, cudaStream_t stream,
                                cudaLaunchAttribute* attr,
                                cudaLaunchConfig_t& cfg) {
  const int route = normalize_route(real_n, NP);
  if (!ppf::map_route_takes(route, real_n, real_n, NP))
    return cudaErrorInvalidValue;
  cfg = ppf::cluster_launch_config(
      ppf::map_cluster_size(real_n), B, ppf::kMapThreads,
      ppf::map_route_smem(route, real_n, real_n, NP), stream, attr);
  const auto kernel = normalize_kernel_on(route);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cfg.dynamicSmemBytes);
  return e == cudaSuccess ? ppf::allow_map_clusters(kernel, (int)cfg.gridDim.x)
                          : e;
}

// Phase 2, in place on the (B, NP, NP) fp32 map.
cudaError_t launch_normalize(float* map, int B, int NP, int real_n, int keep,
                             float identity_weight, float one_plus_iw,
                             cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cudaError_t e = configure_normalize(B, NP, real_n, stream, attr, cfg);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg,
                         normalize_kernel_on(normalize_route(real_n, NP)), map,
                         NP, real_n, keep, identity_weight, one_plus_iw);
  return e == cudaSuccess ? cudaGetLastError() : e;
}

}  // namespace

// qkv: (B, NP, 3C) fp32 or bf16 (is_bf16), rows >= real_n pads; policy:
// (B, NP) fp32 keep-mask with pads 0, or null for all ones; out: (B, NP, C)
// in the qkv dtype; map: (B, NP, NP) fp32, the normalized rollout map.
// scale = hd**-0.5, eps_over_n = 1e-6/real_n, one_plus_iw =
// 1 + identity_weight, all as fp32; keep counts on real_n * real_n;
// real_n <= NP; scratch: ppf_attention_mean_scratch_bytes of phase 1 (null
// where that is 0). Returns the first failing launch's cudaError_t, else 0.
extern "C" int ppf_attention_core(const void* qkv, const void* policy, int B,
                                  int NP, int C, int H, int real_n, int keep,
                                  int is_bf16, float scale, float eps_over_n,
                                  float identity_weight, float one_plus_iw,
                                  void* out, void* map, void* stream,
                                  void* scratch) {
  if (!ppf::map_route_takes(normalize_route(real_n, NP), real_n, real_n, NP))
    return cudaErrorInvalidValue;
  const int err = ppf_attention_mean(qkv, policy, B, NP, C, H, real_n, is_bf16,
                                     scale, eps_over_n, out, map, stream,
                                     scratch);
  if (err != 0) return err;
  return launch_normalize(static_cast<float*>(map), B, NP, real_n, keep,
                          identity_weight, one_plus_iw,
                          static_cast<cudaStream_t>(stream));
}

// The normalize's select route (ppf_map_stats_route's numbers) for
// real_n real rows at row stride NP.
extern "C" int ppf_attention_core_route(int real_n, int NP) {
  return normalize_route(real_n, NP);
}

// CTAs per sample (the cluster size) of the normalize launch.
extern "C" int ppf_attention_core_cluster_size(int real_n) {
  return ppf::map_cluster_size(real_n);
}

// How many of the normalize launch's clusters the card can hold at once
// (negative: the cudaError_t of the query).
extern "C" int ppf_attention_core_active_clusters(int real_n, int NP) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int clusters = 0;
  cudaError_t e = configure_normalize(1, NP, real_n, nullptr, attr, cfg);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(
        &clusters, normalize_kernel_on(normalize_route(real_n, NP)), &cfg);
  return e == cudaSuccess ? clusters : -static_cast<int>(e);
}

// ppf_map_stats_select_route for the normalize's select above 256 tokens.
extern "C" int ppf_attention_core_select_route(int* out, int reset) {
  return ppf::read_select_route(out, reset != 0);
}
