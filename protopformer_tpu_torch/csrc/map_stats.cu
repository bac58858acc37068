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
//
// Tokens: any N. Up to 256 tokens the select is the one above
// (cluster_radix_select). Above 256 tokens (cluster_radix_select_long):
//  * up to 512 rows a CTA holds at most 64 (5 CTAs at N=257, 8 from 449);
//    above 512 a cluster of 16 CTAs (a non-portable size the H100 takes),
//    bands of 37 rows at N=577 (DeiT-B/16 at 384): ~114 KB of shared
//    memory, two CTAs an SM. Bound there: bytes, 213 MB (the 1.33 MB fp32
//    map of each of 160 samples read once) = 0.064 ms.
//  * Pass 0 counts each value's top digit as the band is loaded; at the
//    end of each cluster pass each CTA adds its non-zero counts into every
//    CTA's totals (red.shared::cluster) before the barrier, so that no CTA
//    waits on a read of another's memory after it.
//  * On fp32 keys, after the top 16 bits, each CTA lists its keys that
//    still match them; after one cluster barrier every CTA copies the
//    cluster's lists (up to ~4,700 keys of a seeded model's map at 577, of
//    the 7,168 the copy takes at 16 bits a key, the prefix left out) and
//    runs the last two passes over the copy with no cluster barrier.
//    Lists that would overflow send the cluster to passes 2 and 3 over its
//    bands (ppf_map_stats_select_route counts them).
//  * The final cluster barrier is split: a CTA arrives when it no longer
//    reads another's memory and waits only before it exits, behind its
//    row sums.
// What holds it above the bound: each round of ~14 resident clusters
// loads its maps, then runs its passes while the memory idles; the
// cluster barriers of the first two passes remain. Measured
// (cli.time_long_kernels --against parent, an H100 at 700 W, B=160, the
// model's maps; PERF.md): 0.574 -> 0.357 ms at 577, 0.126 -> 0.086 ms at
// 257; as K1's select at 577 0.347 -> 0.251 ms (bf16 map) and 0.556 ->
// 0.351 ms (fp32).
// Past 640 tokens (DeiT at 448 px has 785, at 512 px 1,025) the select
// takes its in-place route (common.cuh, ppf::map_route): each CTA reads
// its band of the map where it lies, on each of its passes, and counts
// into 32-bit histogram copies. Its band of fp32 rows would fit shared
// memory up to ~850 tokens, but there one CTA an SM holds 7 clusters of
// 16 at once (~23 rounds at B=160) against the in-place route's 42 (35
// on a bf16 map), which reads faster at every count measured from 641 to
// 849 (measured on an H100, PERF.md); a band kept as bf16 (two CTAs an
// SM, 14 clusters) read between the two. Bound there: bytes, the map
// read once; what holds it above: the passes re-read the band, from L2
// where the map stays there.
// Above 256 tokens the same launch is also K1's select, on the map K1's
// heads kernel stored (attention_block_stats.cu).
//
// The signed instantiation (ppf_signed_map_stats, signed_map_stats_kernel)
// is CaiT's discard search over its talking-heads maps, which hold
// negative values. It replaces no TPU kernel: the JAX package runs that
// search as plain jnp (protopformer_tpu/ops/rollout.py,
// kth_largest_bf16_signed / kth_largest_signed, a bisection of the signed
// key space), and the port ran it as 16 eager passes over the map (32 on
// fp32 keys), each a compare, a widening and a count sum. The keys are
// the unsigned monotone ones (common.cuh, select_key<true>): a
// non-negative value's pattern with its top bit set, a negative one's
// inverted, so the key order is the value order and -0.0 ranks just below
// +0.0, as in the bisection's int16 keys; the threshold is the inverse
// map of the selected key and the row sums take a >= t unchanged. Bound:
// bytes, the map read once and t and s written once: 106.5 MB at
// CaiT-S24@384's (160, 576, 576) bf16 maps, 31.8 us. The design is K2's:
// 16 CTAs a sample each hold a band of 36 rows in shared memory as fp32,
// counting pass 0 as it arrives, and a bf16 map's 16-bit keys take the 2
// cluster passes; an fp32 map's 32-bit keys take 4, the last two over the
// cluster's compact key lists. The one-step and in-place routes take the
// other token counts, as for K2.
#include "common.cuh"

namespace {

// One sample's select and row sums (blockIdx.y the sample); kSigned: in
// the signed key space (ppf::select_key<true>).
template <typename T, int kRoute, bool kSigned>
__device__ __forceinline__ void map_stats(const T* __restrict__ map, int N,
                                          int keep, bool prefix16, unsigned hi,
                                          float* __restrict__ t_out,
                                          float* __restrict__ s_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int b = blockIdx.y;
  ppf::map_band_t<kRoute, T> band;
  const unsigned key = ppf::cluster_map_select<kRoute, kSigned>(
      map + (size_t)b * N * N, N, N, N, prefix16, keep, smem, band, hi);
  const float t =
      ppf::threshold_from_key<kSigned>(static_cast<int>(key), prefix16);
  if (blockIdx.x == 0 && threadIdx.x == 0) t_out[b] = t;
  ppf::block_masked_row_sums<kRoute == ppf::kMapOneStep>(
      band.a, band.rows, N, band.stride, t, s_out + (size_t)b * N + band.row0);
  if constexpr (kRoute != ppf::kMapOneStep) ppf::cluster_wait();
}

// kRoute: the select's route at N tokens (ppf::map_route).
template <typename T, int kRoute>
__global__ void __launch_bounds__(
    ppf::kMapThreads, ppf::map_ctas_per_sm(kRoute == ppf::kMapOneStep))
map_stats_kernel(const T* __restrict__ map, int N, int keep, bool prefix16,
                 unsigned hi, float* __restrict__ t_out,
                 float* __restrict__ s_out) {
  map_stats<T, kRoute, false>(map, N, keep, prefix16, hi, t_out, s_out);
}

// The same in the signed key space, with no cap (CaiT's maps).
template <typename T, int kRoute>
__global__ void __launch_bounds__(
    ppf::kMapThreads, ppf::map_ctas_per_sm(kRoute == ppf::kMapOneStep))
signed_map_stats_kernel(const T* __restrict__ map, int N, int keep,
                        bool prefix16, unsigned hi, float* __restrict__ t_out,
                        float* __restrict__ s_out) {
  map_stats<T, kRoute, true>(map, N, keep, prefix16, hi, t_out, s_out);
}

// The kernel for maps of T on `route` (ppf::map_route's numbers).
template <typename T, bool kSigned>
auto kernel_for(int route) {
  if constexpr (kSigned) {
    switch (route) {
      case ppf::kMapOneStep:
        return signed_map_stats_kernel<T, ppf::kMapOneStep>;
      case ppf::kMapLong: return signed_map_stats_kernel<T, ppf::kMapLong>;
      default: return signed_map_stats_kernel<T, ppf::kMapGlobal>;
    }
  } else {
    switch (route) {
      case ppf::kMapOneStep: return map_stats_kernel<T, ppf::kMapOneStep>;
      case ppf::kMapLong: return map_stats_kernel<T, ppf::kMapLong>;
      default: return map_stats_kernel<T, ppf::kMapGlobal>;
    }
  }
}

// The launch configuration of B maps at N tokens on the select's route
// (ppf::map_route), its kernel set up for it. `attr` must outlive the
// launch call.
template <typename T, bool kSigned>
cudaError_t configure(int B, int N, cudaStream_t stream,
                      cudaLaunchAttribute* attr, cudaLaunchConfig_t& cfg) {
  const int route = ppf::map_route(N, N, N);
  if (!ppf::map_route_takes(route, N, N, N)) return cudaErrorInvalidValue;
  cfg = ppf::cluster_launch_config(ppf::map_cluster_size(N), B,
                                   ppf::kMapThreads,
                                   ppf::map_route_smem(route, N, N, N),
                                   stream, attr);
  const auto kernel = kernel_for<T, kSigned>(route);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)cfg.dynamicSmemBytes);
  return err == cudaSuccess
             ? ppf::allow_map_clusters(kernel, ppf::map_cluster_size(N))
             : err;
}

template <typename T, bool kSigned = false>
cudaError_t launch(const void* map, int B, int N, int keep, bool prefix16,
                   unsigned hi, void* t_out, void* s_out,
                   cudaStream_t stream) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  cudaError_t err = configure<T, kSigned>(B, N, stream, attr, cfg);
  if (err != cudaSuccess) return err;
  err = cudaLaunchKernelEx(&cfg,
                           kernel_for<T, kSigned>(ppf::map_route(N, N, N)),
                           static_cast<const T*>(map), N, keep, prefix16, hi,
                           static_cast<float*>(t_out),
                           static_cast<float*>(s_out));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int active_clusters(int N) {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  int clusters = 0;
  cudaError_t err = configure<T, false>(1, N, nullptr, attr, cfg);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(
        &clusters, kernel_for<T, false>(ppf::map_route(N, N, N)), &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}

}  // namespace

// map: (B, N, N) fp32 or bf16 (map_is_bf16), any N; t_out: (B,) fp32;
// s_out: (B, N) fp32; the key capped at `hi` (0: the top of the key space;
// K1 above 256 tokens caps it at the key of 1.0, as its JAX kernel's
// bisection from [0, 1] is). One cluster launch; returns its cudaError_t.
extern "C" int ppf_map_stats_at_most(const void* map, int map_is_bf16, int B,
                                     int N, int keep, int prefix16,
                                     unsigned hi, void* t_out, void* s_out,
                                     void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (map_is_bf16)
    return launch<__nv_bfloat16>(map, B, N, keep, prefix16 != 0, hi, t_out,
                                 s_out, s);
  return launch<float>(map, B, N, keep, prefix16 != 0, hi, t_out, s_out, s);
}

// K2: the same with no cap.
extern "C" int ppf_map_stats(const void* map, int map_is_bf16, int B, int N,
                             int keep, int prefix16, void* t_out, void* s_out,
                             void* stream) {
  return ppf_map_stats_at_most(map, map_is_bf16, B, N, keep, prefix16, 0,
                               t_out, s_out, stream);
}

// The same select and row sums of (B, N, N) maps that may hold negative
// values (CaiT's talking-heads maps), in the signed key space
// (ppf::select_key<true>): t the keep-th largest value with no cap, as
// the bisection of ops/rollout.py's kth_largest_signed /
// kth_largest_bf16_signed finds it, and the row sums of the entries at or
// above it. prefix16: a bf16 map's own 16-bit keys (2 passes); otherwise
// 32-bit keys (4 passes, on an fp32 map or an exact bf16 one). An fp32
// map with prefix16 is refused (cudaErrorInvalidValue): the threshold of
// a negative fp32 value's 16-bit key lies above the value.
extern "C" int ppf_signed_map_stats(const void* map, int map_is_bf16, int B,
                                    int N, int keep, int prefix16,
                                    void* t_out, void* s_out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (map_is_bf16)
    return launch<__nv_bfloat16, true>(map, B, N, keep, prefix16 != 0, 0,
                                       t_out, s_out, s);
  if (prefix16) return cudaErrorInvalidValue;
  return launch<float, true>(map, B, N, keep, false, 0, t_out, s_out, s);
}

// CTAs per sample (the cluster size) of the launch at N.
extern "C" int ppf_map_stats_cluster_size(int N) {
  return ppf::map_cluster_size(N);
}

// The select's route at N tokens: 0 one step, 1 the band in shared memory,
// 2 the band read in place from global memory (ppf::map_route).
extern "C" int ppf_map_stats_route(int N) { return ppf::map_route(N, N, N); }

// How many of those clusters the card can hold at once (negative: the
// cudaError_t of the query).
extern "C" int ppf_map_stats_active_clusters(int N, int map_is_bf16) {
  return map_is_bf16 ? active_clusters<__nv_bfloat16>(N)
                     : active_clusters<float>(N);
}

// The route record of this file's select above 256 tokens (K2, and K1's
// select) since the last reset, into out[0..2]: the largest lists' total
// (against ppf::select_gather_cap), the largest CTA list (against
// ppf::kSelectListCap), and the samples whose lists overflowed, which took
// the passes over the bands. Zeroes it where `reset`; returns the
// cudaError_t.
extern "C" int ppf_map_stats_select_route(int* out, int reset) {
  return ppf::read_select_route(out, reset != 0);
}
