// K2: fused lazy-rollout map statistics.
//
// Replaces protopformer_tpu/kernels/stats.py::_stats_kernel (reached via
// fused_map_stats): for each (N, N) non-negative map, the keep-th largest
// value by bisection on its bit pattern (31 steps on the fp32 pattern, or
// 15 on its high 16 bits in prefix16 mode, from [0, max]) and the row sums
// of the entries at or above that threshold.
//
// Bound on an H100: bytes. Each map is read once (197 x 197 fp32 = 155 KB
// per sample on the main path) and only B + B*N floats are written; the
// bisection is 15-31 counting passes over the same values. The design
// loads the whole map into shared memory once (155 KB fits the 227 KB a
// block may use) and runs every counting pass and the row sums there, so
// device memory sees one read of the map, as the TPU kernel kept it in
// VMEM. One block per sample; B = 160 gives 1.2 waves over 132 SMs.
#include "common.cuh"

namespace {

template <typename T>
__global__ void __launch_bounds__(1024)
map_stats_kernel(const T* __restrict__ map, int N, int keep, bool prefix16,
                 float* __restrict__ t_out, float* __restrict__ s_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int E = N * N;
  int* red = reinterpret_cast<int*>(smem);
  float* a = reinterpret_cast<float*>(smem + ppf::align16(32 * sizeof(int)));
  const T* m = map + (size_t)blockIdx.x * E;

  int kmax = INT_MIN;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const float v = ppf::to_float(m[e]);  // exact widening for bf16
    a[e] = v;
    kmax = max(kmax, ppf::bisect_key(v, prefix16));
  }
  kmax = ppf::block_max_int(kmax, red);  // its barriers also publish a[]
  const int lo = ppf::block_bisect(a, E, keep, prefix16, 0, kmax,
                                   prefix16 ? 15 : 31, red);
  const float t = ppf::threshold_from_key(lo, prefix16);
  if (threadIdx.x == 0) t_out[blockIdx.x] = t;
  ppf::block_masked_row_sums(a, N, N, N, t, s_out + (size_t)blockIdx.x * N);
}

template <typename T>
cudaError_t launch(const void* map, int B, int N, int keep, bool prefix16,
                   void* t_out, void* s_out, cudaStream_t stream) {
  const size_t smem = ppf::align16(32 * sizeof(int)) + (size_t)N * N * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      map_stats_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  map_stats_kernel<T><<<B, 1024, smem, stream>>>(
      static_cast<const T*>(map), N, keep, prefix16,
      static_cast<float*>(t_out), static_cast<float*>(s_out));
  return cudaGetLastError();
}

}  // namespace

// map: (B, N, N) fp32 or bf16 (map_is_bf16); t_out: (B,) fp32; s_out:
// (B, N) fp32. Returns the launch's cudaError_t.
extern "C" int ppf_map_stats(const void* map, int map_is_bf16, int B, int N,
                             int keep, int prefix16, void* t_out, void* s_out,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (map_is_bf16)
    return launch<__nv_bfloat16>(map, B, N, keep, prefix16 != 0, t_out, s_out, s);
  return launch<float>(map, B, N, keep, prefix16 != 0, t_out, s_out, s);
}

extern "C" int ppf_map_stats_smem_bytes(int N) {
  return (int)(ppf::align16(32 * sizeof(int)) + (size_t)N * N * sizeof(float));
}
