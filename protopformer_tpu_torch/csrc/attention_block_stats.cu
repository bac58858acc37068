// K1: fused ones-policy attention with the head-mean map, its discard
// threshold and its masked row sums.
//
// Replaces protopformer_tpu/kernels/attention_core.py::_block_stats_kernel
// (reached via fused_attention_block_stats), which runs on the pre-prune
// blocks of the bf16 serving path. Per sample and head: QK^T with fp32
// accumulation rounded to bf16 and scaled in bf16; the eps-softmax of the
// JAX package's bf16 branch (bf16 exp, fp32 row sum, bf16 reciprocal
// multiply); AV with fp32 accumulation. The head mean accumulates in fp32
// (acc = acc + p * (1/H), heads in order, no fused multiply-add), is
// rounded once to the storage dtype (bf16 in speed mode, fp32 in exact
// mode), and the threshold is bisected on the STORED map (15 steps on the
// high 16 bits or 31 on the fp32 pattern, from [0, bits(1.0)]).
//
// Bound on an H100: bytes (qkv read once, out and the map written once:
// 60.8 MB speed / 73.3 MB exact at B=160, N=197 against 4.77 GFLOP). The
// design keeps the probabilities out of device memory entirely: one block
// per sample holds the (N, N) fp32 accumulator (155 KB at N=197) and one
// head's bf16 K and V (51 KB) in shared memory, so the map is written once
// and the bisection and row sums run on the resident tile. The products
// run on CUDA cores (one warp per query row); tensor cores (wgmma) and a
// grid wider than B = 160 blocks are left for a later change.
#include "common.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;

struct Layout {
  size_t red, qbuf, pbuf, acc, ks, vs, total;
  __host__ __device__ Layout(int N, int hd) {
    red = 0;
    qbuf = ppf::align16(red + 32 * sizeof(int));
    pbuf = ppf::align16(qbuf + (size_t)kWarps * hd * sizeof(float));
    acc = ppf::align16(pbuf + (size_t)kWarps * N * sizeof(float));
    ks = ppf::align16(acc + (size_t)N * N * sizeof(float));
    vs = ppf::align16(ks + (size_t)N * (hd + 2) * sizeof(__nv_bfloat16));
    total = ppf::align16(vs + (size_t)N * hd * sizeof(__nv_bfloat16));
  }
};

template <int MAXT>
__global__ void __launch_bounds__(kThreads)
block_stats_kernel(const __nv_bfloat16* __restrict__ qkv, int N, int C, int H,
                   int keep, bool exact, float scale_bf16, float eps_over_n_bf16,
                   __nv_bfloat16* __restrict__ out, void* __restrict__ map_out,
                   float* __restrict__ t_out, float* __restrict__ s_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = C / H;
  const int C3 = 3 * C;
  const Layout L(N, hd);
  int* red = reinterpret_cast<int*>(smem + L.red);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* q = reinterpret_cast<float*>(smem + L.qbuf) + warp * hd;
  float* p = reinterpret_cast<float*>(smem + L.pbuf) + warp * N;
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem + L.ks);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(smem + L.vs);

  const int b = blockIdx.x;
  const int E = N * N;
  const __nv_bfloat16* qkv_b = qkv + (size_t)b * N * C3;
  const float rH = 1.0f / (float)H;

  for (int e = threadIdx.x; e < E; e += blockDim.x) acc[e] = 0.f;

  for (int h = 0; h < H; ++h) {
    __syncthreads();  // previous head's K/V no longer read
    ppf::load_head(qkv_b, N, C3, C + h * hd, hd, Ks, hd + 2, N);
    ppf::load_head(qkv_b, N, C3, 2 * C + h * hd, hd, Vs, hd, N);
    __syncthreads();
    for (int i = warp; i < N; i += kWarps) {
      for (int d = 2 * lane; d < hd; d += 64) {
        const float2 v = ppf::load2(qkv_b + (size_t)i * C3 + h * hd + d);
        q[d] = v.x;
        q[d + 1] = v.y;
      }
      __syncwarp();
      float l[MAXT];
      ppf::row_dots<__nv_bfloat16, MAXT>(q, Ks, hd + 2, N, hd, l);
      // logits: fp32 dot -> bf16, then x bf16(scale) in bf16
      float m = __uint_as_float(0xff800000u);  // -inf
#pragma unroll
      for (int u = 0; u < MAXT; ++u) {
        if (lane + 32 * u < N) {
          l[u] = ppf::bf16_round(__fmul_rn(ppf::bf16_round(l[u]), scale_bf16));
          m = fmaxf(m, l[u]);
        }
      }
      m = ppf::warp_max(m);
      float ssum = 0.f;
#pragma unroll
      for (int u = 0; u < MAXT; ++u) {
        if (lane + 32 * u < N) {
          l[u] = ppf::bf16_round(expf(ppf::bf16_round(__fsub_rn(l[u], m))));
          ssum = __fadd_rn(ssum, l[u]);
        }
      }
      ssum = __fadd_rn(ppf::warp_sum(ssum), 1e-6f);
      const float inv = ppf::bf16_round(__fdiv_rn(1.0f, ssum));
#pragma unroll
      for (int u = 0; u < MAXT; ++u) {
        const int j = lane + 32 * u;
        if (j < N) {
          const float pj = ppf::bf16_round(
              __fmul_rn(ppf::bf16_round(__fadd_rn(l[u], eps_over_n_bf16)), inv));
          p[j] = pj;
          acc[i * N + j] = __fadd_rn(acc[i * N + j], __fmul_rn(pj, rH));
        }
      }
      __syncwarp();
      ppf::row_av(p, Vs, N, hd, out + ((size_t)b * N + i) * C + h * hd);
      __syncwarp();  // p and q are rewritten by this warp's next row
    }
  }
  __syncthreads();

  // round once to the storage dtype; bisect and sum the STORED values
  for (int e = threadIdx.x; e < E; e += blockDim.x) {
    float v = acc[e];
    if (exact) {
      static_cast<float*>(map_out)[(size_t)b * E + e] = v;
    } else {
      const __nv_bfloat16 vb = __float2bfloat16_rn(v);
      static_cast<__nv_bfloat16*>(map_out)[(size_t)b * E + e] = vb;
      v = __bfloat162float(vb);
    }
    acc[e] = v;
  }
  __syncthreads();
  const bool prefix16 = !exact;
  const int lo = ppf::block_bisect(acc, E, keep, prefix16, 0,
                                   prefix16 ? (0x3F800000 >> 16) : 0x3F800000,
                                   prefix16 ? 15 : 31, red);
  const float t = ppf::threshold_from_key(lo, prefix16);
  if (threadIdx.x == 0) t_out[b] = t;
  ppf::block_masked_row_sums(acc, N, t, s_out + (size_t)b * N);
}

}  // namespace

// qkv: (B, N, 3C) bf16; out: (B, N, C) bf16; map: (B, N, N) fp32 (exact)
// or bf16; t: (B,) fp32; s: (B, N) fp32. scale_bf16 / eps_over_n_bf16 are
// hd**-0.5 and 1e-6/N rounded to bf16 by the caller.
extern "C" int ppf_attention_block_stats(const void* qkv, int B, int N, int C,
                                         int H, int keep, int exact,
                                         float scale_bf16, float eps_over_n_bf16,
                                         void* out, void* map, void* t, void* s,
                                         void* stream) {
  const int hd = C / H;
  const size_t smem = Layout(N, hd).total;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  PPF_DISPATCH_MAXT(N, {
    cudaError_t err = cudaFuncSetAttribute(
        block_stats_kernel<MAXT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    block_stats_kernel<MAXT><<<B, kThreads, smem, st>>>(
        static_cast<const __nv_bfloat16*>(qkv), N, C, H, keep, exact != 0,
        scale_bf16, eps_over_n_bf16, static_cast<__nv_bfloat16*>(out), map,
        static_cast<float*>(t), static_cast<float*>(s));
  });
  return cudaGetLastError();
}

extern "C" int ppf_attention_block_stats_smem_bytes(int N, int hd) {
  return (int)Layout(N, hd).total;
}
