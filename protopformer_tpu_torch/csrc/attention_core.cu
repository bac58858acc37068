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
//   2. normalize_kernel, one block per sample: the real block of the map
//      goes into shared memory once; 31 counting passes from
//      [0, max bits] find the keep-th largest value (keep counted on
//      real_n * real_n); entries whose bits are below it are zeroed; the
//      identity is added on the real diagonal at identity_weight and the
//      sum divided by 1 + identity_weight; each row is divided by its sum
//      (a zero sum by 1). The block writes the real block back IN PLACE;
//      pad rows and columns keep phase 1's exact zeros. That is what the
//      JAX code does (eye * real_block): its docstring's "0.2/1.2 on pad
//      diagonals" does not hold, and the port follows the code.
//
// Bound on an H100: K4 in bf16 at B=160, N=197 moves 73.2 MB (qkv, out,
// the fp32 map) = 21.9 us at 3.35 TB/s; in fp32 the products (4.77 GFLOP
// on the 67 TFLOP/s CUDA cores, 71 us) bound it. K5 at NP=256 moves
// ~105 MB (31 us). Design cost: phase 1 writes the raw map and phase 2
// reads it back, about 50 MB more traffic at B=160 than a fused kernel
// would need (the TPU kernel kept the map in VMEM between the two). The
// padded (256 x 256) fp32 map (262,144 B) does not fit the 232,448 B a
// Hopper block may use, so phase 2 holds only the real block: real_n <= 240.
// Fusing the phases, tensor cores and TMA loads are later work.
#include "common.cuh"

extern "C" int ppf_attention_mean(const void* qkv, const void* policy, int B,
                                  int NP, int C, int H, int real_n, int is_bf16,
                                  float scale, float eps_over_n, void* out,
                                  void* map, void* stream);

namespace {

constexpr int kThreads = 1024;

size_t normalize_smem(int real_n) {
  return ppf::align16(32 * sizeof(int)) + (size_t)real_n * real_n * sizeof(float);
}

// One discarded-and-blended entry, rounded as the JAX kernel rounds:
// (where(bits >= lo, v, 0) + identity_weight * eye) / (1 + identity_weight).
__device__ __forceinline__ float blend(float v, bool diag, int lo, float iw,
                                       float one_plus_iw) {
  const float kept = __float_as_int(v) >= lo ? v : 0.f;
  return __fdiv_rn(__fadd_rn(kept, diag ? iw : 0.f), one_plus_iw);
}

__global__ void __launch_bounds__(kThreads)
normalize_kernel(float* __restrict__ map, int NP, int real_n, int keep,
                 float iw, float one_plus_iw) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* red = reinterpret_cast<int*>(smem);
  float* a = reinterpret_cast<float*>(smem + ppf::align16(32 * sizeof(int)));
  const int n = real_n;
  const int E = n * n;
  float* m = map + (size_t)blockIdx.x * NP * NP;

  int kmax = INT_MIN;
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    const int i = e / n;
    const float v = m[(size_t)i * NP + (e - i * n)];
    a[e] = v;
    kmax = max(kmax, __float_as_int(v));
  }
  kmax = ppf::block_max_int(kmax, red);  // its barriers also publish a[]
  const int lo = ppf::block_bisect(a, E, keep, false, 0, kmax, 31, red);

  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < n; i += nw) {
    const float* row = a + (size_t)i * n;
    float sum = 0.f;
    for (int j = lane; j < n; j += ppf::kWarp)
      sum = __fadd_rn(sum, blend(row[j], i == j, lo, iw, one_plus_iw));
    sum = ppf::warp_sum(sum);
    const float denom = sum == 0.f ? 1.f : sum;
    float* dst = m + (size_t)i * NP;
    for (int j = lane; j < n; j += ppf::kWarp)
      dst[j] = __fdiv_rn(blend(row[j], i == j, lo, iw, one_plus_iw), denom);
  }
}

}  // namespace

// qkv: (B, NP, 3C) fp32 or bf16 (is_bf16), rows >= real_n pads; policy:
// (B, NP) fp32 keep-mask with pads 0, or null for all ones; out: (B, NP, C)
// in the qkv dtype; map: (B, NP, NP) fp32, the normalized rollout map.
// scale = hd**-0.5, eps_over_n = 1e-6/real_n, one_plus_iw =
// 1 + identity_weight, all as fp32; keep counts on real_n * real_n.
// Returns the first failing launch's cudaError_t, else 0.
extern "C" int ppf_attention_core(const void* qkv, const void* policy, int B,
                                  int NP, int C, int H, int real_n, int keep,
                                  int is_bf16, float scale, float eps_over_n,
                                  float identity_weight, float one_plus_iw,
                                  void* out, void* map, void* stream) {
  const int err = ppf_attention_mean(qkv, policy, B, NP, C, H, real_n, is_bf16,
                                     scale, eps_over_n, out, map, stream);
  if (err != 0) return err;
  const size_t smem = normalize_smem(real_n);
  cudaError_t e = cudaFuncSetAttribute(
      normalize_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  normalize_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(map), NP, real_n, keep, identity_weight, one_plus_iw);
  return cudaGetLastError();
}

// Shared memory of the normalize phase (phase 1 needs
// ppf_attention_mean_smem_bytes).
extern "C" int ppf_attention_core_smem_bytes(int real_n) {
  return (int)normalize_smem(real_n);
}
