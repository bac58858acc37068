// K3: policy-masked attention emitting the raw fp32 head-mean map.
//
// Replaces protopformer_tpu/kernels/attention_core.py::_mean_kernel_padded
// (reached via fused_attention_mean_padded). Per sample and head, over NP
// (possibly padded) tokens of which the first real_n are real: logits =
// fp32-accumulated QK^T times hd**-0.5 (not rounded first); an fp32
// softmax with the policy mask and the identity escape,
// probs = (e * (pol + (1 - pol) I) + 1e-6/real_n) / (sum e + 1e-6);
// V rows at or past real_n zeroed; AV with the probabilities in the
// compute dtype and fp32 accumulation. The head mean (acc = acc + p * (1/H)
// in fp32) is emitted with every entry outside the real (real_n, real_n)
// block exactly 0. In fp32 mode every product is an fp32 FMA on CUDA cores,
// never TF32.
//
// Bound on an H100: operations in fp32 mode (4.77 GFLOP at B=160, N=197
// on the 67 TFLOP/s non-tensor fp32 units, 71 us) and bytes in bf16 mode
// at N=82 (24.5 MB, 7.3 us). A (N, N) fp32 accumulator and one head's
// fp32 K and V do not fit one block's shared memory at N=197, so each
// block takes a tile of 64 query rows of one sample: it keeps that tile's
// accumulator rows and one head's K and V (padded row stride, no bank
// conflicts) in shared memory and writes its map rows once. B x ceil(NP/64)
// blocks (640 at B=160, N=197) fill the card; K and V are re-read once
// per row tile, from L2.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;

template <typename T>
struct Layout {
  size_t qbuf, pbuf, pol, acc, ks, vs, total;
  __host__ __device__ Layout(int NP, int hd) {
    qbuf = 0;
    pbuf = ppf::align16(qbuf + (size_t)kWarps * hd * sizeof(float));
    pol = ppf::align16(pbuf + (size_t)kWarps * NP * sizeof(float));
    acc = ppf::align16(pol + (size_t)NP * sizeof(float));
    ks = ppf::align16(acc + (size_t)kRows * NP * sizeof(float));
    vs = ppf::align16(ks + (size_t)NP * (hd + 2) * sizeof(T));
    total = ppf::align16(vs + (size_t)NP * hd * sizeof(T));
  }
};

__device__ __forceinline__ float compute_round(float x, float) { return x; }
__device__ __forceinline__ float compute_round(float x, __nv_bfloat16) {
  return ppf::bf16_round(x);
}

template <typename T, int MAXT>
__global__ void __launch_bounds__(kThreads)
mean_kernel(const T* __restrict__ qkv, const float* __restrict__ policy,
            int NP, int C, int H, int real_n, float scale, float eps_over_n,
            T* __restrict__ out, float* __restrict__ map_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = C / H;
  const int C3 = 3 * C;
  const Layout<T> L(NP, hd);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* q = reinterpret_cast<float*>(smem + L.qbuf) + warp * hd;
  float* p = reinterpret_cast<float*>(smem + L.pbuf) + warp * NP;
  float* pol = reinterpret_cast<float*>(smem + L.pol);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  T* Ks = reinterpret_cast<T*>(smem + L.ks);
  T* Vs = reinterpret_cast<T*>(smem + L.vs);

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const T* qkv_b = qkv + (size_t)b * NP * C3;
  const float rH = 1.0f / (float)H;

  // a null policy is the all-ones policy (K4's ones_policy): attn_policy
  // is then exactly 1 and the products below leave e unchanged
  for (int j = threadIdx.x; j < NP; j += blockDim.x)
    pol[j] = policy ? policy[(size_t)b * NP + j] : 1.f;
  for (int e = threadIdx.x; e < kRows * NP; e += blockDim.x) acc[e] = 0.f;

  for (int h = 0; h < H; ++h) {
    __syncthreads();  // previous head's K/V no longer read
    ppf::load_head(qkv_b, NP, C3, C + h * hd, hd, Ks, hd + 2, NP);
    ppf::load_head(qkv_b, NP, C3, 2 * C + h * hd, hd, Vs, hd, real_n);
    __syncthreads();
    for (int r = warp; r < kRows; r += kWarps) {
      const int i = row0 + r;
      if (i >= NP) break;
      for (int d = 2 * lane; d < hd; d += 64) {
        const float2 v = ppf::load2(qkv_b + (size_t)i * C3 + h * hd + d);
        q[d] = v.x;
        q[d + 1] = v.y;
      }
      __syncwarp();
      float l[MAXT];
      ppf::row_dots<T, MAXT>(q, Ks, hd + 2, NP, hd, l);
      float m = __uint_as_float(0xff800000u);  // -inf
#pragma unroll
      for (int u = 0; u < MAXT; ++u) {
        if (lane + 32 * u < NP) {
          l[u] = __fmul_rn(l[u], scale);
          m = fmaxf(m, l[u]);
        }
      }
      m = ppf::warp_max(m);
      float ssum = 0.f;
#pragma unroll
      for (int u = 0; u < MAXT; ++u) {
        const int j = lane + 32 * u;
        if (j < NP) {
          const float pj = pol[j];
          const float eye = j == i ? 1.f : 0.f;
          const float ap = __fadd_rn(pj, __fmul_rn(__fsub_rn(1.f, pj), eye));
          l[u] = __fmul_rn(expf(__fsub_rn(l[u], m)), ap);
          ssum = __fadd_rn(ssum, l[u]);
        }
      }
      const float denom = __fadd_rn(ppf::warp_sum(ssum), 1e-6f);
#pragma unroll
      for (int u = 0; u < MAXT; ++u) {
        const int j = lane + 32 * u;
        if (j < NP) {
          const float pj = __fdiv_rn(__fadd_rn(l[u], eps_over_n), denom);
          p[j] = compute_round(pj, T());
          acc[r * NP + j] = __fadd_rn(acc[r * NP + j], __fmul_rn(pj, rH));
        }
      }
      __syncwarp();
      ppf::row_av(p, Vs, NP, hd, out + ((size_t)b * NP + i) * C + h * hd);
      __syncwarp();  // p and q are rewritten by this warp's next row
    }
  }
  // each warp wrote only its own accumulator rows: no block barrier needed
  for (int r = warp; r < kRows; r += kWarps) {
    const int i = row0 + r;
    if (i >= NP) break;
    float* dst = map_out + ((size_t)b * NP + i) * NP;
    for (int j = lane; j < NP; j += 32) {
      const float real = (i < real_n && j < real_n) ? 1.f : 0.f;
      dst[j] = __fmul_rn(acc[r * NP + j], real);
    }
  }
}

template <typename T>
cudaError_t launch(const void* qkv, const float* policy, int B, int NP, int C,
                   int H, int real_n, float scale, float eps_over_n, void* out,
                   float* map, cudaStream_t stream) {
  const size_t smem = Layout<T>(NP, C / H).total;
  const dim3 grid((NP + kRows - 1) / kRows, B);
  PPF_DISPATCH_MAXT(NP, {
    cudaError_t err = cudaFuncSetAttribute(
        mean_kernel<T, MAXT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    mean_kernel<T, MAXT><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(qkv), policy, NP, C, H, real_n, scale,
        eps_over_n, static_cast<T*>(out), map);
  });
  return cudaGetLastError();
}

}  // namespace

// qkv: (B, NP, 3C) fp32 or bf16 (is_bf16); policy: (B, NP) fp32 keep-mask
// (pads 0), or null for all ones; out: (B, NP, C) in the qkv dtype; map:
// (B, NP, NP) fp32.
// scale = hd**-0.5 and eps_over_n = 1e-6/real_n as fp32.
extern "C" int ppf_attention_mean(const void* qkv, const void* policy, int B,
                                  int NP, int C, int H, int real_n, int is_bf16,
                                  float scale, float eps_over_n, void* out,
                                  void* map, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pol = static_cast<const float*>(policy);
  float* m = static_cast<float*>(map);
  if (is_bf16)
    return launch<__nv_bfloat16>(qkv, pol, B, NP, C, H, real_n, scale,
                                 eps_over_n, out, m, st);
  return launch<float>(qkv, pol, B, NP, C, H, real_n, scale, eps_over_n, out,
                       m, st);
}

extern "C" int ppf_attention_mean_smem_bytes(int NP, int hd, int is_bf16) {
  return (int)(is_bf16 ? Layout<__nv_bfloat16>(NP, hd).total
                       : Layout<float>(NP, hd).total);
}
