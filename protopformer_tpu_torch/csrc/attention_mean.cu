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
// block exactly 0.
//
// Bound on an H100: operations in fp32 mode (4.77 GFLOP at B=160, N=197
// on the 67 TFLOP/s non-tensor fp32 units, 71 us) and bytes in bf16 mode
// (24.5 MB at N=82, 7.3 us). Two kernels:
//  * fp32 (the parity path): register-blocked SIMT, fp32 FMAs only, never
//    TF32. A block of 256 threads takes 32 query rows of one sample; each
//    thread computes a 4-row x ceil(NP/32)-column micro-tile of S from
//    16-byte shared loads (each K value feeds 4 FMAs, each Q value up to
//    8), takes its rows' max and sum by warp shuffles, keeps its share of
//    the head-mean accumulator in registers across heads, and then a
//    2-row x 4-column tile of O = P V. One buffer holds K, then V (~99 KB
//    at N=197: two blocks per SM); 7 x B blocks at N=197.
//  * bf16: K1's tensor-core tiles (mma.sync m16n8k16 from ldmatrix, one
//    warp per 16-row tile, four tiles a block), with fp32 logits and an
//    fp32 softmax; the probabilities are rounded to bf16 only as P V's
//    operand. The band's accumulator stays in shared memory.
// K and V are re-read from L2 by each row block of a sample.
#include "common.cuh"

namespace {

__device__ __forceinline__ float attn_policy(const float* pol, int j, int i) {
  const float pj = pol[j];
  const float eye = j == i ? 1.f : 0.f;
  return __fadd_rn(pj, __fmul_rn(__fsub_rn(1.f, pj), eye));
}

// a null policy is the all-ones policy (K4's ones_policy): attn_policy is
// then exactly 1 and the products leave e unchanged; pad columns past NP 0
__device__ __forceinline__ void load_policy(const float* policy, int NP,
                                            int cols, float* pol) {
  for (int j = threadIdx.x; j < cols; j += blockDim.x)
    pol[j] = j < NP ? (policy ? policy[j] : 1.f) : 0.f;
}

// --- bf16: tensor-core tiles --------------------------------------------------

namespace bf16k {

constexpr int kTiles = 4;  // 16-row tiles a block, one warp each
constexpr int kThreads = 32 * kTiles;

struct Layout {
  int np, astride, kstride;
  size_t pol, acc, kv, total;
  __host__ __device__ Layout(int NP, int hd) {
    np = 16 * ppf::key_tiles(NP);
    astride = np + 8;
    kstride = ppf::kv_stride(hd);
    pol = 0;
    acc = ppf::align16(pol + (size_t)np * sizeof(float));
    kv = ppf::align16(acc + (size_t)16 * kTiles * astride * sizeof(float));
    total = ppf::align16(kv + (size_t)np * kstride * sizeof(__nv_bfloat16));
  }
};

template <int KT>
__global__ void __launch_bounds__(kThreads)
mean_kernel(const __nv_bfloat16* __restrict__ qkv,
            const float* __restrict__ policy, int NP, int C, int H, int real_n,
            float scale, float eps_over_n, __nv_bfloat16* __restrict__ out,
            float* __restrict__ map_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = C / H;
  const int hk = (hd + 15) / 16;
  const int C3 = 3 * C;
  const Layout L(NP, hd);
  float* pol = reinterpret_cast<float*>(smem + L.pol);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(smem + L.kv);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int b = blockIdx.y;
  const int r0 = 16 * (blockIdx.x * kTiles + warp);  // this warp's first row
  const bool active = r0 < NP;
  const __nv_bfloat16* qkv_b = qkv + (size_t)b * NP * C3;
  const float rH = 1.0f / (float)H;
  const float neg_inf = __uint_as_float(0xff800000u);
  float* arow = acc + (16 * warp + g) * L.astride + 2 * t;

  load_policy(policy ? policy + (size_t)b * NP : nullptr, NP, L.np, pol);
  for (int e = threadIdx.x; e < 16 * kTiles * L.astride / 4; e += blockDim.x)
    reinterpret_cast<float4*>(acc)[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int h = 0; h < H; ++h) {
    __syncthreads();  // the previous head's V no longer read
    ppf::load_head_async(qkv_b, C3, C + h * hd, hd, NP, L.np, 16 * hk, kv,
                         L.kstride);
    ppf::cp_async_wait_all();
    __syncthreads();
    uint32_t pa[KT][4];
    if (active) {
      uint32_t qa[4][4];
      ppf::load_q_frags(qa, qkv_b + (size_t)r0 * C3 + h * hd, C3, NP - r0, hd);
      float S[2 * KT][4];
      ppf::warp_qk<KT>(S, qa, kv, L.kstride, hk);
      // element e of an n-tile: row g + 8 (e >> 1), column 8n + 2t + (e & 1);
      // pad columns (>= NP) lie in the n-tiles of ppf::pad_ntile
      float m[2] = {neg_inf, neg_inf};
#pragma unroll
      for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          S[n][e] = __fmul_rn(S[n][e], scale);
          if (ppf::pad_ntile<KT>(n, NP) && 8 * n + 2 * t + (e & 1) >= NP)
            S[n][e] = neg_inf;
          m[e >> 1] = fmaxf(m[e >> 1], S[n][e]);
        }
      m[0] = ppf::quad_max(m[0]);
      m[1] = ppf::quad_max(m[1]);
      // exp(-inf) = 0 at the pads, whose policy is 0 as well
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * n + 2 * t + (e & 1);
          const int row = r0 + g + 8 * (e >> 1);
          S[n][e] = __fmul_rn(expf(__fsub_rn(S[n][e], m[e >> 1])),
                              attn_policy(pol, col, row));
          sum[e >> 1] = __fadd_rn(sum[e >> 1], S[n][e]);
        }
      float denom[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        denom[i] = __fadd_rn(ppf::quad_sum(sum[i]), 1e-6f);
#pragma unroll
      for (int n = 0; n < 2 * KT; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          S[n][e] = __fdiv_rn(__fadd_rn(S[n][e], eps_over_n), denom[e >> 1]);
          if (ppf::pad_ntile<KT>(n, NP) && 8 * n + 2 * t + (e & 1) >= NP)
            S[n][e] = 0.f;
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          float2* a = reinterpret_cast<float2*>(arow + 8 * half * L.astride + 8 * n);
          float2 v = *a;
          v.x = __fadd_rn(v.x, __fmul_rn(S[n][2 * half], rH));
          v.y = __fadd_rn(v.y, __fmul_rn(S[n][2 * half + 1], rH));
          *a = v;
        }
      }
      ppf::pack_p<KT>(pa, S);  // probabilities rounded to bf16 for P V
    }
    __syncthreads();  // every warp is done with K
    ppf::load_head_async(qkv_b, C3, 2 * C + h * hd, hd, real_n, L.np, 16 * hk,
                         kv, L.kstride);
    ppf::cp_async_wait_all();
    __syncthreads();
    if (active) {
      float O[8][4];
      ppf::warp_pv<KT>(O, pa, kv, L.kstride, hk);
      ppf::store_o(out + ((size_t)b * NP + r0) * C + h * hd, C, O, NP - r0,
                   hd);
    }
  }
  __syncwarp();  // each warp writes the accumulator rows it updated
  for (int r = 0; r < 16; ++r) {
    const int i = r0 + r;
    if (i >= NP) break;
    const float* src = acc + (16 * warp + r) * L.astride;
    float* dst = map_out + ((size_t)b * NP + i) * NP;
    for (int j = lane; j < NP; j += ppf::kWarp) {
      const float real = (i < real_n && j < real_n) ? 1.f : 0.f;
      dst[j] = __fmul_rn(src[j], real);
    }
  }
}

cudaError_t launch(const void* qkv, const float* policy, int B, int NP, int C,
                   int H, int real_n, float scale, float eps_over_n, void* out,
                   float* map, cudaStream_t stream) {
  const size_t smem = Layout(NP, C / H).total;
  const dim3 grid(((NP + 15) / 16 + kTiles - 1) / kTiles, B);
  PPF_DISPATCH_KT(NP, {
    cudaError_t err = cudaFuncSetAttribute(
        mean_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    mean_kernel<KT><<<grid, kThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(qkv), policy, NP, C, H, real_n,
        scale, eps_over_n, static_cast<__nv_bfloat16*>(out), map);
  });
  return cudaGetLastError();
}

}  // namespace bf16k

// --- fp32: register-blocked SIMT tiles -----------------------------------------

namespace f32k {

constexpr int kThreads = 256;
constexpr int kRows = 32;  // query rows a block: 8 warps x 4 rows

struct Layout {
  int cols, kstride, pstride;
  size_t pol, q, kv, p, total;
  __host__ __device__ Layout(int NP, int hd) {
    cols = (NP + 31) / 32 * 32;
    kstride = hd + 4;  // 16-byte rows 16 mod 128 bytes apart: no bank conflict
    pstride = cols + 4;
    pol = 0;
    q = ppf::align16(pol + (size_t)cols * sizeof(float));
    kv = ppf::align16(q + (size_t)kRows * hd * sizeof(float));
    p = ppf::align16(kv + (size_t)cols * kstride * sizeof(float));
    total = ppf::align16(p + (size_t)kRows * pstride * sizeof(float));
  }
};

// CT = ceil(NP / 32): the S columns of a thread are lane + 32 u, u < CT.
template <int CT>
__global__ void __launch_bounds__(kThreads, 2)
mean_kernel(const float* __restrict__ qkv, const float* __restrict__ policy,
            int NP, int C, int H, int real_n, float scale, float eps_over_n,
            float* __restrict__ out, float* __restrict__ map_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = C / H;
  const int C3 = 3 * C;
  const Layout L(NP, hd);
  float* pol = reinterpret_cast<float*>(smem + L.pol);
  float* q = reinterpret_cast<float*>(smem + L.q);
  float* kv = reinterpret_cast<float*>(smem + L.kv);
  float* P = reinterpret_cast<float*>(smem + L.p);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const float* qkv_b = qkv + (size_t)b * NP * C3;
  const float rH = 1.0f / (float)H;
  const float neg_inf = __uint_as_float(0xff800000u);
  const int srow = 4 * warp;  // S phase: block rows srow .. srow + 3
  const int orow = 4 * warp + 2 * (lane >> 4);  // O phase: 2 rows,
  const int ocol = 4 * (lane & 15);             // 4 columns
  // a warp whose 4 rows are all pads (the last block of a sample) skips
  // the products: nothing it would compute is stored
  const bool live = row0 + srow < NP;

  load_policy(policy ? policy + (size_t)b * NP : nullptr, NP, L.cols, pol);
  float acc[4][CT];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
#pragma unroll
    for (int u = 0; u < CT; ++u) acc[rr][u] = 0.f;

  for (int h = 0; h < H; ++h) {
    __syncthreads();  // the previous head's Q, V and P no longer read
    ppf::load_head_async(qkv_b + (size_t)row0 * C3, C3, h * hd, hd, NP - row0,
                         kRows, hd, q, hd);
    ppf::load_head_async(qkv_b, C3, C + h * hd, hd, NP, L.cols, hd, kv,
                         L.kstride);
    ppf::cp_async_wait_all();
    __syncthreads();
    float s[4][CT];
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int u = 0; u < CT; ++u) s[rr][u] = 0.f;
    for (int d = 0; live && d < hd; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int rr = 0; rr < 4; ++rr)
        qv[rr] = *reinterpret_cast<const float4*>(q + (srow + rr) * hd + d);
#pragma unroll
      for (int u = 0; u < CT; ++u) {
        const float4 k4 = *reinterpret_cast<const float4*>(
            kv + (lane + 32 * u) * L.kstride + d);
#pragma unroll
        for (int rr = 0; rr < 4; ++rr) {
          s[rr][u] = fmaf(qv[rr].x, k4.x, s[rr][u]);
          s[rr][u] = fmaf(qv[rr].y, k4.y, s[rr][u]);
          s[rr][u] = fmaf(qv[rr].z, k4.z, s[rr][u]);
          s[rr][u] = fmaf(qv[rr].w, k4.w, s[rr][u]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < 4 && live; ++rr) {
      const int i = row0 + srow + rr;
      float m = neg_inf;
#pragma unroll
      for (int u = 0; u < CT; ++u) {
        const int c = lane + 32 * u;
        s[rr][u] = c < NP ? __fmul_rn(s[rr][u], scale) : neg_inf;
        m = fmaxf(m, s[rr][u]);
      }
      m = ppf::warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int u = 0; u < CT; ++u) {
        const int c = lane + 32 * u;
        const float e = c < NP ? __fmul_rn(expf(__fsub_rn(s[rr][u], m)),
                                           attn_policy(pol, c, i))
                               : 0.f;
        s[rr][u] = e;
        sum = __fadd_rn(sum, e);
      }
      const float denom = __fadd_rn(ppf::warp_sum(sum), 1e-6f);
#pragma unroll
      for (int u = 0; u < CT; ++u) {
        const int c = lane + 32 * u;
        const float p =
            c < NP ? __fdiv_rn(__fadd_rn(s[rr][u], eps_over_n), denom) : 0.f;
        acc[rr][u] = __fadd_rn(acc[rr][u], __fmul_rn(p, rH));
        P[(srow + rr) * L.pstride + c] = p;
      }
    }
    __syncthreads();  // K no longer read; P complete
    ppf::load_head_async(qkv_b, C3, 2 * C + h * hd, hd, real_n, L.cols, hd,
                         kv, L.kstride);
    ppf::cp_async_wait_all();
    __syncthreads();
    if (live && ocol < hd) {
      float o[2][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) o[r][c] = 0.f;
      // P is 0 and V is 0 past NP, so the last group of 4 may overrun it
      for (int j = 0; j < NP; j += 4) {
        float4 pv[2];
#pragma unroll
        for (int r = 0; r < 2; ++r)
          pv[r] = *reinterpret_cast<const float4*>(P + (orow + r) * L.pstride + j);
        float4 v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          v[k] = *reinterpret_cast<const float4*>(kv + (j + k) * L.kstride + ocol);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float pj[4] = {pv[r].x, pv[r].y, pv[r].z, pv[r].w};
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            o[r][0] = fmaf(pj[k], v[k].x, o[r][0]);
            o[r][1] = fmaf(pj[k], v[k].y, o[r][1]);
            o[r][2] = fmaf(pj[k], v[k].z, o[r][2]);
            o[r][3] = fmaf(pj[k], v[k].w, o[r][3]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int i = row0 + orow + r;
        if (i < NP)
          *reinterpret_cast<float4*>(out + ((size_t)b * NP + i) * C + h * hd +
                                     ocol) =
              make_float4(o[r][0], o[r][1], o[r][2], o[r][3]);
      }
    }
  }
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int i = row0 + srow + rr;
    if (i >= NP) break;
    float* dst = map_out + ((size_t)b * NP + i) * NP;
#pragma unroll
    for (int u = 0; u < CT; ++u) {
      const int c = lane + 32 * u;
      if (c < NP) {
        const float real = (i < real_n && c < real_n) ? 1.f : 0.f;
        dst[c] = __fmul_rn(acc[rr][u], real);
      }
    }
  }
}

cudaError_t launch(const void* qkv, const float* policy, int B, int NP, int C,
                   int H, int real_n, float scale, float eps_over_n, void* out,
                   float* map, cudaStream_t stream) {
  const size_t smem = Layout(NP, C / H).total;
  const dim3 grid((NP + kRows - 1) / kRows, B);
  PPF_DISPATCH_MAXT(NP, {
    cudaError_t err = cudaFuncSetAttribute(
        mean_kernel<MAXT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    mean_kernel<MAXT><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(qkv), policy, NP, C, H, real_n, scale,
        eps_over_n, static_cast<float*>(out), map);
  });
  return cudaGetLastError();
}

}  // namespace f32k

}  // namespace

// qkv: (B, NP, 3C) fp32 or bf16 (is_bf16); policy: (B, NP) fp32 keep-mask
// (pads 0), or null for all ones; out: (B, NP, C) in the qkv dtype; map:
// (B, NP, NP) fp32. C / H is at most 64 and a multiple of 4 (fp32) or 8
// (bf16); NP <= 256.
// scale = hd**-0.5 and eps_over_n = 1e-6/real_n as fp32.
extern "C" int ppf_attention_mean(const void* qkv, const void* policy, int B,
                                  int NP, int C, int H, int real_n, int is_bf16,
                                  float scale, float eps_over_n, void* out,
                                  void* map, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pol = static_cast<const float*>(policy);
  float* m = static_cast<float*>(map);
  if (is_bf16)
    return bf16k::launch(qkv, pol, B, NP, C, H, real_n, scale, eps_over_n, out,
                         m, st);
  return f32k::launch(qkv, pol, B, NP, C, H, real_n, scale, eps_over_n, out, m,
                      st);
}

extern "C" int ppf_attention_mean_smem_bytes(int NP, int hd, int is_bf16) {
  return (int)(is_bf16 ? bf16k::Layout(NP, hd).total
                       : f32k::Layout(NP, hd).total);
}
