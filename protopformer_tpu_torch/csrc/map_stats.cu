// K2: fused lazy-rollout map statistics.
//
// Replaces protopformer_tpu/kernels/stats.py::_stats_kernel (reached via
// fused_map_stats): for each (N, N) non-negative map, the keep-th largest
// value on its bit pattern (the fp32 pattern, or its high 16 bits in
// prefix16 mode; the JAX kernel bisects it in 31 or 15 steps from
// [0, max]) and the row sums of the entries at or above that threshold.
//
// Bound on an H100: bytes. Each map is read once (197 x 197 fp32 = 155 KB
// per sample on the main path) and only B + B*N floats are written; the
// select and the row sums are a few operations per entry. A single block
// per sample would hold the whole map (one block an SM, two waves of 160
// samples over 132 SMs) and a bisection re-reads it 31 times. Instead one
// sample is split over a thread-block cluster of map_cluster_size(N) CTAs
// (4 at N=197: bands of 49-50 rows, ~52 KB of shared memory a CTA), each
// loading its band of whole rows into shared memory once, in 16-byte
// chunks. The threshold is the cluster's radix select over the bands (4
// passes of 8-bit digits on fp32 keys, 2 on 16-bit ones), which returns
// the bisection's answer without the maximum; each CTA then sums its own
// rows. What holds it above the bound is latency, not traffic: each pass
// scans the band and ends in a cluster barrier, and 160 clusters of 4 do
// not fit the card at once (chip_smoke.py prints how many do), so the
// launch runs in two rounds.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(ppf::kMapThreads, ppf::kMapCtasPerSm)
map_stats_kernel(const T* __restrict__ map, int N, int keep, bool prefix16,
                 float* __restrict__ t_out, float* __restrict__ s_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  ppf::MapBand band;
  const unsigned key = ppf::cluster_map_select(
      map + (size_t)b * N * N, N, N, N, prefix16, keep, smem, band);
  const float t = ppf::threshold_from_key(static_cast<int>(key), prefix16);
  if (blockIdx.x == 0 && threadIdx.x == 0) t_out[b] = t;
  ppf::block_masked_row_sums(band.a, band.rows, N, band.stride, t,
                             s_out + (size_t)b * N + band.row0);
}

template <typename T>
cudaError_t launch(const void* map, int B, int N, int keep, bool prefix16,
                   void* t_out, void* s_out, cudaStream_t stream) {
  const size_t smem = ppf::map_band_smem(N, N, N);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = ppf::cluster_launch_config(
      ppf::map_cluster_size(N), B, ppf::kMapThreads, smem, stream, attr);
  cudaError_t err = cudaFuncSetAttribute(
      map_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg, map_stats_kernel<T>, static_cast<const T*>(map),
                           N, keep, prefix16, static_cast<float*>(t_out),
                           static_cast<float*>(s_out));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int active_clusters(int N) {
  const size_t smem = ppf::map_band_smem(N, N, N);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = ppf::cluster_launch_config(
      ppf::map_cluster_size(N), 1, ppf::kMapThreads, smem, nullptr, attr);
  int clusters = 0;
  cudaError_t err = cudaFuncSetAttribute(
      map_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, map_stats_kernel<T>, &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

}  // namespace

// map: (B, N, N) fp32 or bf16 (map_is_bf16), N <= 256; t_out: (B,) fp32;
// s_out: (B, N) fp32. One cluster launch; returns its cudaError_t.
extern "C" int ppf_map_stats(const void* map, int map_is_bf16, int B, int N,
                             int keep, int prefix16, void* t_out, void* s_out,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (map_is_bf16)
    return launch<__nv_bfloat16>(map, B, N, keep, prefix16 != 0, t_out, s_out, s);
  return launch<float>(map, B, N, keep, prefix16 != 0, t_out, s_out, s);
}

// CTAs per sample (the cluster size) of the launch at N.
extern "C" int ppf_map_stats_cluster_size(int N) {
  return ppf::map_cluster_size(N);
}

// How many of those clusters the card can hold at once (negative: the
// cudaError_t of the query).
extern "C" int ppf_map_stats_active_clusters(int N, int map_is_bf16) {
  return map_is_bf16 ? active_clusters<__nv_bfloat16>(N)
                     : active_clusters<float>(N);
}
