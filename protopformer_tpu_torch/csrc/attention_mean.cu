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
//
// Tokens: NP <= 640. Both kernels above hold a head's K (then V) for every
// key in shared memory, and the fp32 one its rows' head mean in registers:
// at NP=577 that is ~254 KB and 19 columns a thread. From 257 on the long
// kernels stream K and V through shared memory instead:
//  * fp32 (f32k::mean_long_kernel): 32 query rows a block as above, 8
//    warps, one block an SM (207 KB of shared memory at 577 and 640).
//    Bound at B=160, NP=577, H=12: operations, 164 GFLOP on the CUDA cores
//    = 2.44 ms. What holds it above: shared-memory traffic (each FMA of S
//    needs half a 16-byte load, of P V an eighth), registers (the head
//    mean takes 80 a thread) and the latency of one block's phases.
//    K, then V, stream through a ring of three 128-key buffers filled by
//    cp.async two chunks ahead (one barrier a chunk); the next head's Q
//    comes with its first K chunk. S: a warp takes 16 rows x 32 keys of a
//    chunk, a lane 4 x 4 on 2-D lanes (a warp's loads on distinct banks),
//    into P in shared memory with the row maxima. The softmax: each warp
//    its 4 rows, two at a time, each row in registers from its load to
//    its store; the division from the row's reciprocal; the head mean in
//    registers. P V: each warp 16 keys of every chunk for all 32 x 64
//    outputs, a lane 8 x 8 (10 loads feed 64 FMAs); the 8 warps' sums meet
//    in P's space in warp order. S, the softmax and the head mean are
//    computed in the order of the kernel above; out sums each warp's keys
//    in order, then the warps (held to 1e-5 at 257, 301, 577 and 640 by
//    tests/test_torch_gpu.py). Measured (cli.time_long_kernels --against
//    parent, an H100 at 700 W, B=160, the model's own operands; PERF.md):
//    13.19 -> 8.07 ms at 577, 0.901 -> 0.547 ms at 257.
//  * bf16 (bf16k::mean_long_kernel): the tensor-core tiles above over
//    chunks of 128 keys, two warps a 16-row tile, each on half of every
//    chunk; three passes a head (the row maximum, the sum of the
//    exponentials, then the probabilities, the head mean and P V, with
//    that chunk's K and V in two buffers), recomputing S from the chunk
//    each pass; the halves' maxima and sums meet in shared memory, their
//    P V at the end of the head; the band's accumulator in shared memory
//    (222 KB at 640: one block an SM). The softmax arithmetic of every
//    probability over three passes, not the tensor cores, bounds it: as
//    K4's attention phase at 577 (B=160, H=12, an H100 at 700 W) it read
//    9.5 ms with one warp a tile and 6.9 ms with two (8 an SM).
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

// The long kernel (NP >= ppf::kLongMinTokens): two warps a 16-row tile,
// each on one half of every chunk of kLongTiles key tiles. Its shared
// memory: the policy and the band's accumulator over the NP columns rounded
// up to 16, one buffer each for a chunk of K and of V, the halves' P V of
// each tile, and their row maxima or sums.
constexpr int kLongTiles = 8;
constexpr int kLongChunk = 16 * kLongTiles;
constexpr int kLongThreads = 2 * kThreads;

struct LongLayout {
  int np, astride, kstride;
  size_t pol, acc, k, v, xchg, red, total;
  __host__ __device__ LongLayout(int NP, int hd) {
    np = ppf::round_up(NP, 16);
    astride = np + 8;
    kstride = ppf::kv_stride(hd);
    pol = 0;
    acc = ppf::align16(pol + (size_t)ppf::round_up(NP, kLongChunk) *
                                 sizeof(float));
    k = ppf::align16(acc + (size_t)16 * kTiles * astride * sizeof(float));
    v = ppf::align16(k + (size_t)kLongChunk * kstride * sizeof(__nv_bfloat16));
    xchg = ppf::align16(v + (size_t)kLongChunk * kstride *
                                sizeof(__nv_bfloat16));
    red = xchg + (size_t)kTiles * 32 * 32 * sizeof(float);
    total = ppf::align16(red + (size_t)2 * kTiles * 16 * sizeof(float));
  }
};

__global__ void __launch_bounds__(kLongThreads)
mean_long_kernel(const __nv_bfloat16* __restrict__ qkv,
                 const float* __restrict__ policy, int NP, int C, int H,
                 int real_n, float scale, float eps_over_n,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ map_out) {
  constexpr int KT = kLongTiles / 2;  // key tiles of a chunk a warp takes
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = C / H;
  const int hk = (hd + 15) / 16;
  const int C3 = 3 * C;
  const LongLayout L(NP, hd);
  float* pol = reinterpret_cast<float*>(smem + L.pol);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  __nv_bfloat16* kbuf = reinterpret_cast<__nv_bfloat16*>(smem + L.k);
  __nv_bfloat16* vbuf = reinterpret_cast<__nv_bfloat16*>(smem + L.v);
  float* xchg = reinterpret_cast<float*>(smem + L.xchg);
  float* red = reinterpret_cast<float*>(smem + L.red);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int tw = warp % kTiles;    // the warp's row tile
  const int half = warp / kTiles;  // the half of each chunk it takes
  const int b = blockIdx.y;
  const int r0 = 16 * (blockIdx.x * kTiles + tw);  // this warp's first row
  const bool active = r0 < NP;
  // this warp's keys of a chunk: rows ch .. ch + 16 KT - 1 of the buffers
  const int ch = 16 * KT * half;
  const int kofs = ch * L.kstride;
  // the halves' values of this tile's rows g and g + 8
  float* red_mine = red + (half * kTiles + tw) * 16;
  const float* red_lo = red + tw * 16;
  const float* red_hi = red + (kTiles + tw) * 16;
  const __nv_bfloat16* qkv_b = qkv + (size_t)b * NP * C3;
  const float rH = 1.0f / (float)H;
  const float neg_inf = __uint_as_float(0xff800000u);

  load_policy(policy ? policy + (size_t)b * NP : nullptr, NP,
              ppf::round_up(NP, kLongChunk), pol);
  for (int e = threadIdx.x; e < 16 * kTiles * L.astride / 4; e += blockDim.x)
    reinterpret_cast<float4*>(acc)[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  // starts the copy of keys k0 .. k0 + kLongChunk - 1 of the head slice at
  // column `col` into `dst`, rows >= valid zeros; arrive() waits for the
  // copies and publishes them
  auto copy_chunk = [&](__nv_bfloat16* dst, int col, int k0, int valid) {
    ppf::load_head_async(qkv_b + (size_t)k0 * C3, C3, col, hd, valid - k0,
                         kLongChunk, 16 * hk, dst, L.kstride);
  };
  auto arrive = [&]() {
    ppf::cp_async_wait_all();
    __syncthreads();
  };
  // publishes each quad's value of rows g and g + 8 for the other half
  auto share = [&](const float (&v)[2]) {
    if (active && t == 0) {
      red_mine[g] = v[0];
      red_mine[g + 8] = v[1];
    }
    __syncthreads();
  };
  // the warp's half of the chunk's fp32 logits times the scale, columns
  // >= NP -inf; element e of an n-tile is row g + 8 (e >> 1), column
  // k0 + ch + 8n + 2t + (e & 1)
  uint32_t qa[4][4];
  auto logits = [&](float (&S)[2 * KT][4], int k0) {
    ppf::warp_qk<KT>(S, qa, kbuf + kofs, L.kstride, hk);
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        S[n][e] = __fmul_rn(S[n][e], scale);
        if (k0 + ch + 8 * n + 2 * t + (e & 1) >= NP) S[n][e] = neg_inf;
      }
  };
  // e = exp(s - m) * policy (0 at the pads, whose policy is 0 as well)
  auto exps = [&](float (&S)[2 * KT][4], int k0, const float (&m)[2]) {
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + ch + 8 * n + 2 * t + (e & 1);
        const int row = r0 + g + 8 * (e >> 1);
        S[n][e] = __fmul_rn(expf(__fsub_rn(S[n][e], m[e >> 1])),
                            attn_policy(pol, col, row));
      }
  };

  for (int h = 0; h < H; ++h) {
    const int kcol = C + h * hd;
    if (active)
      ppf::load_q_frags(qa, qkv_b + (size_t)r0 * C3 + h * hd, C3, NP - r0, hd);
    float m[2] = {neg_inf, neg_inf};
    for (int k0 = 0; k0 < NP; k0 += kLongChunk) {
      __syncthreads();  // every warp is done with the buffers
      copy_chunk(kbuf, kcol, k0, NP);
      arrive();
      if (active) {
        float S[2 * KT][4];
        logits(S, k0);
#pragma unroll
        for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) m[e >> 1] = fmaxf(m[e >> 1], S[n][e]);
      }
    }
    m[0] = ppf::quad_max(m[0]);
    m[1] = ppf::quad_max(m[1]);
    share(m);
    m[0] = fmaxf(red_lo[g], red_hi[g]);
    m[1] = fmaxf(red_lo[g + 8], red_hi[g + 8]);
    float sum[2] = {0.f, 0.f};
    for (int k0 = 0; k0 < NP; k0 += kLongChunk) {
      __syncthreads();
      copy_chunk(kbuf, kcol, k0, NP);
      arrive();
      if (active) {
        float S[2 * KT][4];
        logits(S, k0);
        exps(S, k0, m);
#pragma unroll
        for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sum[e >> 1] = __fadd_rn(sum[e >> 1], S[n][e]);
      }
    }
    // each half's sum in column order, then the first half's plus the
    // second's
    sum[0] = ppf::quad_sum(sum[0]);
    sum[1] = ppf::quad_sum(sum[1]);
    share(sum);
    float denom[2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
      denom[i] = __fadd_rn(
          __fadd_rn(red_lo[g + 8 * i], red_hi[g + 8 * i]), 1e-6f);
    float O[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) O[n][e] = 0.f;
    for (int k0 = 0; k0 < NP; k0 += kLongChunk) {
      __syncthreads();
      copy_chunk(kbuf, kcol, k0, NP);
      copy_chunk(vbuf, 2 * C + h * hd, k0, real_n);
      arrive();
      if (active) {
        float S[2 * KT][4];
        logits(S, k0);
        exps(S, k0, m);
        float* arow = acc + (16 * tw + g) * L.astride + k0 + ch + 2 * t;
#pragma unroll
        for (int n = 0; n < 2 * KT; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            S[n][e] = __fdiv_rn(__fadd_rn(S[n][e], eps_over_n), denom[e >> 1]);
            if (k0 + ch + 8 * n + 2 * t + (e & 1) >= NP) S[n][e] = 0.f;
          }
          if (k0 + ch + 8 * n < L.np) {  // the last chunk may pass the band
#pragma unroll
            for (int half = 0; half < 2; ++half) {
              float2* a = reinterpret_cast<float2*>(
                  arow + 8 * half * L.astride + 8 * n);
              float2 v = *a;
              v.x = __fadd_rn(v.x, __fmul_rn(S[n][2 * half], rH));
              v.y = __fadd_rn(v.y, __fmul_rn(S[n][2 * half + 1], rH));
              *a = v;
            }
          }
        }
        uint32_t pa[KT][4];
        ppf::pack_p<KT>(pa, S);  // probabilities rounded to bf16 for P V
        ppf::warp_pv_add<KT>(O, pa, vbuf + kofs, L.kstride, hk);
      }
    }
    // O = the first half's P V plus the second's; the first warp stores it
    float* x = xchg + tw * 32 * 32 + lane;
    if (active && half == 1) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) x[(4 * n + e) * 32] = O[n][e];
    }
    __syncthreads();
    if (active && half == 0) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          O[n][e] = __fadd_rn(O[n][e], x[(4 * n + e) * 32]);
      ppf::store_o(out + ((size_t)b * NP + r0) * C + h * hd, C, O, NP - r0,
                   hd);
    }
  }
  __syncthreads();  // both warps of a tile updated its accumulator rows
  // each warp writes 8 of its tile's rows
  for (int r = 8 * half; r < 8 * half + 8; ++r) {
    const int i = r0 + r;
    if (i >= NP) break;
    const float* src = acc + (16 * tw + r) * L.astride;
    float* dst = map_out + ((size_t)b * NP + i) * NP;
    for (int j = lane; j < NP; j += ppf::kWarp) {
      const float real = (i < real_n && j < real_n) ? 1.f : 0.f;
      dst[j] = __fmul_rn(src[j], real);
    }
  }
}

size_t smem_bytes(int NP, int hd) {
  return NP >= ppf::kLongMinTokens ? LongLayout(NP, hd).total
                                   : Layout(NP, hd).total;
}

cudaError_t launch(const void* qkv, const float* policy, int B, int NP, int C,
                   int H, int real_n, float scale, float eps_over_n, void* out,
                   float* map, cudaStream_t stream) {
  const size_t smem = smem_bytes(NP, C / H);
  const dim3 grid(((NP + 15) / 16 + kTiles - 1) / kTiles, B);
  if (NP >= ppf::kLongMinTokens) {
    cudaError_t err = cudaFuncSetAttribute(
        mean_long_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    mean_long_kernel<<<grid, kLongThreads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(qkv), policy, NP, C, H, real_n,
        scale, eps_over_n, static_cast<__nv_bfloat16*>(out), map);
    return cudaGetLastError();
  }
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


// The long kernel (NP >= ppf::kLongMinTokens), 32 query rows a block as
// above. K, then V, stream through a ring of kLongStages buffers of
// kLongChunk keys, each filled by cp.async two chunks ahead of its use (one
// barrier a chunk); the Q of the next head comes with its first K chunk.
// The block's scaled logits, then its probabilities (P), sit in shared
// memory; its head-mean accumulator in registers, CT = cols / 32 columns a
// lane of each of a warp's 4 rows.
constexpr int kLongChunk = 128;
constexpr int kLongStages = 3;
constexpr int kLongMinCols = 384;  // CT = 12 at least (long_ct)

struct LongLayout {
  int cols, kstride, pstride;
  size_t pol, red, q, ring, p, total;
  __host__ __device__ LongLayout(int NP, int hd) {
    cols = ppf::round_up(NP, kLongChunk);
    if (cols < kLongMinCols) cols = kLongMinCols;
    // an odd multiple of 4 floats for hd a multiple of 8: the 16-byte rows
    // of 8 consecutive keys, or of 4 rows 4 apart, fall on distinct banks
    kstride = hd + 4;
    pstride = cols + 8;  // 8 mod 32: rows 4 apart on distinct banks
    pol = 0;
    red = ppf::align16(pol + (size_t)cols * sizeof(float));
    q = ppf::align16(red + (size_t)4 * kRows * sizeof(float));
    ring = ppf::align16(q + (size_t)2 * kRows * kstride * sizeof(float));
    p = ppf::align16(ring + (size_t)kLongStages * kLongChunk * kstride *
                                sizeof(float));
    // P, whose space also takes the 8 warps' 32 x 64 sums of P V
    const int pf = kRows * pstride > 8 * kRows * 64 ? kRows * pstride
                                                    : 8 * kRows * 64;
    total = ppf::align16(p + (size_t)pf * sizeof(float));
  }
};

// Accumulator columns of a lane (lane + 32 u, u < CT = cols / 32) at NP
// tokens: the long kernel is built for CT = 12, 16 and 20 (cols = 384,
// 512 and 640; 384 also below 385 tokens, as cli.time_long_kernels's copy
// runs it at N <= 256).
inline int long_ct(int NP) { return LongLayout(NP, 4).cols / 32; }

template <int CT>
__global__ void __launch_bounds__(kThreads, 1)
mean_long_kernel(const float* __restrict__ qkv,
                 const float* __restrict__ policy, int NP, int C, int H,
                 int real_n, float scale, float eps_over_n,
                 float* __restrict__ out, float* __restrict__ map_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = C / H;
  const int C3 = 3 * C;
  const LongLayout L(NP, hd);
  float* pol = reinterpret_cast<float*>(smem + L.pol);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* qbuf = reinterpret_cast<float*>(smem + L.q);
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  float* P = reinterpret_cast<float*>(smem + L.p);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const float* qkv_b = qkv + (size_t)b * NP * C3;
  const float rH = 1.0f / (float)H;
  const float neg_inf = __uint_as_float(0xff800000u);
  const int nc = L.cols / kLongChunk;  // chunks of K (and of V) a head
  // S = Q K^T: a warp takes 16 rows x 32 keys of a chunk, a lane 4 x 4 of
  // them, rows s_r + 4i and keys s_c + 8j: the 16-byte loads of a warp
  // fall on distinct banks
  const int s_r = 16 * (warp & 1) + (lane >> 3);
  const int s_c = 32 * (warp >> 1) + (lane & 7);
  const bool s_live = row0 + 16 * (warp & 1) < NP;
  // softmax and the head mean: block rows srow .. srow + 3
  const int srow = 4 * warp;
  // O = P V: warp kg takes keys 16 kg .. 16 kg + 15 of every chunk for all
  // 32 x 64 outputs, a lane 8 x 8 of them (rows o_r + 4i, columns o_c ..
  // o_c + 3 and o_c + 32 .. o_c + 35): 10 loads feed 64 FMAs; the 8 warps'
  // sums meet in shared memory at the end of the head
  const int kg = warp;
  const int o_r = lane >> 3;
  const int o_c = 4 * (lane & 7);

  load_policy(policy ? policy + (size_t)b * NP : nullptr, NP, L.cols, pol);
  float acc[4][CT];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
#pragma unroll
    for (int u = 0; u < CT; ++u) acc[rr][u] = 0.f;

  // the stream of chunks: each head's K chunks, then its V chunks (rows
  // >= NP, or >= real_n for V, zeros); with the first K chunk the head's
  // 32 Q rows into Q buffer h % 2. fetch() copies the next one, (ih, ic),
  // into stage ist; arrive() waits for the oldest, in stage cst, publishes
  // it, and refills the stage every warp is done with
  const size_t chunk = (size_t)kLongChunk * L.kstride;
  const ppf::CopySteps cs = ppf::copy_steps<float>(hd);
  int ih = 0, ic = 0, ist = 0, cst = 0;
  auto fetch = [&]() {
    if (ih < H) {
      if (ic == 0)
        ppf::load_rows_async(qkv_b + (size_t)row0 * C3, C3, ih * hd, hd,
                             NP - row0, kRows,
                             qbuf + (ih & 1) * kRows * L.kstride, L.kstride,
                             cs);
      const int k0 = (ic < nc ? ic : ic - nc) * kLongChunk;
      ppf::load_rows_async(qkv_b + (size_t)k0 * C3, C3,
                           (ic < nc ? C : 2 * C) + ih * hd, hd,
                           (ic < nc ? NP : real_n) - k0, kLongChunk,
                           ring + ist * chunk, L.kstride, cs);
    }
    if (++ic == 2 * nc) {
      ic = 0;
      ++ih;
    }
    ist = ist + 1 == kLongStages ? 0 : ist + 1;
    ppf::cp_async_commit();
  };
  auto arrive = [&]() {
    ppf::cp_async_wait<kLongStages - 2>();
    __syncthreads();
    fetch();
    const float* buf = ring + cst * chunk;
    cst = cst + 1 == kLongStages ? 0 : cst + 1;
    return buf;
  };

  for (int k = 0; k < kLongStages - 1; ++k) fetch();
  for (int h = 0; h < H; ++h) {
    const float* q = qbuf + (h & 1) * kRows * L.kstride;
    // S = Q K^T, each dot by FMAs in head-dim order, times the scale, into
    // P; -inf at the pad columns. Each lane keeps the maxima of its rows
    float mx[4] = {neg_inf, neg_inf, neg_inf, neg_inf};
    for (int c = 0; c < nc; ++c) {
      const float* kb = arrive();
      const int k0 = c * kLongChunk;
      if (s_live) {
        float sv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sv[i][j] = 0.f;
        // a warp whose 32 keys are all pads only writes -inf
        const int dn = k0 + 32 * (warp >> 1) < NP ? hd : 0;
#pragma unroll 4
        for (int d = 0; d < dn; d += 4) {
          float4 qv[4], kv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            qv[i] = *reinterpret_cast<const float4*>(
                q + (s_r + 4 * i) * L.kstride + d);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            kv[j] = *reinterpret_cast<const float4*>(
                kb + (s_c + 8 * j) * L.kstride + d);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              sv[i][j] = fmaf(qv[i].x, kv[j].x, sv[i][j]);
              sv[i][j] = fmaf(qv[i].y, kv[j].y, sv[i][j]);
              sv[i][j] = fmaf(qv[i].z, kv[j].z, sv[i][j]);
              sv[i][j] = fmaf(qv[i].w, kv[j].w, sv[i][j]);
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int col = k0 + s_c + 8 * j;
            const float x = col < NP ? __fmul_rn(sv[i][j], scale) : neg_inf;
            P[(s_r + 4 * i) * L.pstride + col] = x;
            mx[i] = fmaxf(mx[i], x);
          }
      }
    }
    // the row maxima over the 8 lanes of a row group, then the 4 warps of
    // a row block (the maximum is the same in any order)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 4));
      if ((lane & 7) == 0) red[(warp >> 1) * kRows + s_r + 4 * i] = mx[i];
    }
    __syncthreads();  // P holds every logit of the block, red its maxima
    // the softmax of the warp's 4 rows, two at a time, a lane's columns
    // in order, each row's values held in registers from its load to its
    // store: e = exp(s - m) * policy, then p = (e + eps/real_n) / (sum +
    // 1e-6), the division from the row's reciprocal (ppf::div_by_recip).
    // Every column is swept, with no branch: past NP s is -inf and the
    // policy 0, so e is 0 and adds nothing to the sum; p there is not 0,
    // but it meets zero V rows in P V and is never stored
    if (row0 + srow < NP) {  // a warp of pad rows only (a band's last) skips
#pragma unroll
      for (int r2 = 0; r2 < 4; r2 += 2) {
        float x[2][CT], sum[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float* prow = P + (srow + r2 + k) * L.pstride + lane;
#pragma unroll
          for (int u = 0; u < CT; ++u) x[k][u] = prow[32 * u];
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float* rm = red + srow + r2 + k;
          const float m = fmaxf(fmaxf(rm[0], rm[kRows]),
                                fmaxf(rm[2 * kRows], rm[3 * kRows]));
          const int i = row0 + srow + r2 + k;
          sum[k] = 0.f;
#pragma unroll
          for (int u = 0; u < CT; ++u) {
            const int c = lane + 32 * u;
            const float pe = pol[c];
            const float w = c == i ? __fadd_rn(pe, __fsub_rn(1.f, pe)) : pe;
            x[k][u] = __fmul_rn(expf(__fsub_rn(x[k][u], m)), w);
            sum[k] = __fadd_rn(sum[k], x[k][u]);
          }
        }
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const float denom = __fadd_rn(ppf::warp_sum(sum[k]), 1e-6f);
          const float rcp = __frcp_rn(denom);
          float* prow = P + (srow + r2 + k) * L.pstride + lane;
#pragma unroll
          for (int u = 0; u < CT; ++u) {
            const float p = ppf::div_by_recip(__fadd_rn(x[k][u], eps_over_n),
                                              denom, rcp);
            acc[r2 + k][u] = __fadd_rn(acc[r2 + k][u], __fmul_rn(p, rH));
            prow[32 * u] = p;
          }
        }
      }
    }
    // O = P V, this warp's keys of each chunk in key order (V rows >=
    // real_n zeros)
    float o[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) o[i][j] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float* vb = arrive();  // its barrier also publishes P
      const int k0 = c * kLongChunk + 16 * kg;
      if (k0 < NP) {
#pragma unroll 4
        for (int j = 0; j < 16; ++j) {
          float p[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) p[i] = P[(o_r + 4 * i) * L.pstride + k0 + j];
          const float* vrow = vb + (16 * kg + j) * L.kstride + o_c;
          const float4 v0 = *reinterpret_cast<const float4*>(vrow);
          const float4 v1 = *reinterpret_cast<const float4*>(vrow + 32);
          const float v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int jj = 0; jj < 8; ++jj) o[i][jj] = fmaf(p[i], v[jj], o[i][jj]);
        }
      }
    }
    // O = the 8 warps' sums in warp order, through P's space
    __syncthreads();  // every warp is done with P
    float* part = P + kg * kRows * 64;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* dst = part + (o_r + 4 * i) * 64 + o_c;
      *reinterpret_cast<float4*>(dst) =
          make_float4(o[i][0], o[i][1], o[i][2], o[i][3]);
      *reinterpret_cast<float4*>(dst + 32) =
          make_float4(o[i][4], o[i][5], o[i][6], o[i][7]);
    }
    __syncthreads();
    {
      // thread t: row t / 8, columns 8 (t % 8) .. + 7
      const int r = threadIdx.x >> 3;
      const int c0 = 8 * (threadIdx.x & 7);
      float4 a0 = *reinterpret_cast<const float4*>(P + r * 64 + c0);
      float4 a1 = *reinterpret_cast<const float4*>(P + r * 64 + c0 + 4);
#pragma unroll
      for (int g = 1; g < kThreads / 32; ++g) {
        const float* src = P + g * kRows * 64 + r * 64 + c0;
        const float4 b0 = *reinterpret_cast<const float4*>(src);
        const float4 b1 = *reinterpret_cast<const float4*>(src + 4);
        a0.x = __fadd_rn(a0.x, b0.x); a0.y = __fadd_rn(a0.y, b0.y);
        a0.z = __fadd_rn(a0.z, b0.z); a0.w = __fadd_rn(a0.w, b0.w);
        a1.x = __fadd_rn(a1.x, b1.x); a1.y = __fadd_rn(a1.y, b1.y);
        a1.z = __fadd_rn(a1.z, b1.z); a1.w = __fadd_rn(a1.w, b1.w);
      }
      const int i = row0 + r;
      float* dst = out + ((size_t)b * NP + i) * C + h * hd + c0;
      if (i < NP && c0 < hd) *reinterpret_cast<float4*>(dst) = a0;
      if (i < NP && c0 + 4 < hd) *reinterpret_cast<float4*>(dst + 4) = a1;
    }
  }
  // each lane writes the accumulator entries it holds
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int i = row0 + srow + rr;
    if (i < NP) {
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
}

bool long_tokens(int NP) { return NP >= ppf::kLongMinTokens; }

size_t smem_bytes(int NP, int hd) {
  return long_tokens(NP) ? LongLayout(NP, hd).total : Layout(NP, hd).total;
}

// Runs the statements given with `kernel` the fp32 kernel for NP tokens;
// returns cudaErrorInvalidValue where none takes NP.
#define PPF_DISPATCH_F32(NP, ...)                                        \
  if (long_tokens(NP)) {                                                 \
    switch (long_ct(NP)) {                                               \
      case 12: { auto kernel = mean_long_kernel<12>; __VA_ARGS__ } break; \
      case 16: { auto kernel = mean_long_kernel<16>; __VA_ARGS__ } break; \
      case 20: { auto kernel = mean_long_kernel<20>; __VA_ARGS__ } break; \
      default: return cudaErrorInvalidValue;                             \
    }                                                                    \
  } else {                                                               \
    PPF_DISPATCH_MAXT(NP, {                                              \
      auto kernel = mean_kernel<MAXT>;                                   \
      __VA_ARGS__                                                        \
    });                                                                  \
  }

cudaError_t launch(const void* qkv, const float* policy, int B, int NP, int C,
                   int H, int real_n, float scale, float eps_over_n, void* out,
                   float* map, cudaStream_t stream) {
  const size_t smem = smem_bytes(NP, C / H);
  const dim3 grid((NP + kRows - 1) / kRows, B);
  PPF_DISPATCH_F32(NP, {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(qkv), policy, NP, C, H, real_n, scale,
        eps_over_n, static_cast<float*>(out), map);
  });
  return cudaGetLastError();
}

// Blocks of the kernel for NP tokens an SM holds at once.
int resident_blocks(int NP, int hd) {
  const size_t smem = smem_bytes(NP, hd);
  int blocks = 0;
  PPF_DISPATCH_F32(NP, {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          kThreads, smem);
    if (err != cudaSuccess) return -static_cast<int>(err);
  });
  return blocks;
}

}  // namespace f32k

}  // namespace

// qkv: (B, NP, 3C) fp32 or bf16 (is_bf16); policy: (B, NP) fp32 keep-mask
// (pads 0), or null for all ones; out: (B, NP, C) in the qkv dtype; map:
// (B, NP, NP) fp32. C / H is at most 64 and a multiple of 4 (fp32) or 8
// (bf16); NP <= 640.
// scale = hd**-0.5 and eps_over_n = 1e-6/real_n as fp32.
extern "C" int ppf_attention_mean(const void* qkv, const void* policy, int B,
                                  int NP, int C, int H, int real_n, int is_bf16,
                                  float scale, float eps_over_n, void* out,
                                  void* map, void* stream) {
  if (NP > ppf::kMaxTokens) return cudaErrorInvalidValue;
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
  return (int)(is_bf16 ? bf16k::smem_bytes(NP, hd)
                       : f32k::smem_bytes(NP, hd));
}

// Blocks of the fp32 kernel for NP tokens at head dim hd an SM holds at
// once (negative: the cudaError_t of the query).
extern "C" int ppf_attention_mean_f32_resident_blocks(int NP, int hd) {
  if (NP > ppf::kMaxTokens) return -static_cast<int>(cudaErrorInvalidValue);
  return f32k::resident_blocks(NP, hd);
}
