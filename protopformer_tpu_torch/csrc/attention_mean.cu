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
// Tokens: any NP. Both kernels above hold a head's K (then V) for every
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
//  * bf16 (bf16k::mean_long_kernel; K4's and K5's attention phase above
//    256 tokens): K1's long design (attention_block_stats.cu) with K3's
//    numerics. 48 query rows a block in 3 tiles of 16, four warps a tile
//    (384 threads), no cluster: 13 blocks a sample at 577, the last with
//    one row. Bound at B=160, NP=577, H=12: bytes, 780 MB (qkv, the policy,
//    out, the fp32 map) = 0.233 ms. Pass 1 computes each logit once
//    (mma.sync m16n8k16 from ldmatrix, fp32 accumulate, times the scale,
//    unrounded; each warp 2 key tiles of a 128-key chunk) and stores it in
//    fp32, with the row maxima. The softmax then runs over the stored
//    logits: each warp 4 rows, a lane 4 columns of each 128, each row in
//    registers from its load to its store (e = exp(s - m) * policy with
//    the identity escape, the row sum, p = (e + eps/real_n) / (sum +
//    1e-6) by the row's reciprocal, ppf::div_by_recip), p back in place,
//    and the head mean in registers (80 a thread). P V reads the stored
//    probabilities, rounds them to bf16 as P's fragments (pack_p's
//    rounding) and multiplies by V, each warp 16 head-dim columns, so no
//    two warps' sums meet; key tiles at or past real_n (zero V rows) are
//    skipped. K and V are each copied once a head through a ring of 2
//    chunk buffers filled by cp.async one chunk ahead; the head's Q rows
//    come with its first K chunk. Every probability takes one exp. The
//    row maximum is final before any exp (no online rescaling, which
//    would move entries by an ulp that K4/K5's order statistic
//    magnifies). ~165 KB of shared memory at 577: one block an SM; what
//    holds it above the bound is the softmax's instruction rate and each
//    block streaming all of a head's K and V from L2. Measured
//    (cli.time_long_kernels --against parent, an H100 at 700 W, the
//    models' operands; PERF.md): 6.13 -> 3.35 ms at 577 on K4's operands
//    (B=160, H=12), 2.56 -> 1.51 ms on K5's bench operands (B=256, real
//    577 in NP 640, H=3).
// Above 640 tokens the fp32 long kernel holds neither a row block's head
// mean in registers nor its P in shared memory (at NP = 1,152, P alone
// would be 148 KB beside a 104 KB ring, and the head mean 144 registers a
// thread); the bf16 one holds its head mean in registers in 2 row tiles
// up to 1,152 tokens.
//  * fp32, up to 5,120 columns (mean_split_kernel, the split route): a
//    thread block cluster of ceil(cols / 640) CTAs takes each block of 32
//    rows, CTA r the keys of its run of 128-key chunks (at most 5), so
//    that each runs the register route's design on at most 640 columns:
//    its logits and P in shared memory, its columns of the head mean in
//    registers; nothing of P or the head mean leaves the chip, and each
//    map entry is written once by the CTA that holds it. Per head two
//    cluster barriers carry what crosses the cluster through distributed
//    shared memory: the rows' maxima over each CTA's keys (the maximum is
//    final before any exp, as on the register route), then the rows'
//    sums of e, added in rank order. P V multiplies e + eps/real_n by V
//    before the sums are known (the second barrier is split around it)
//    and out = the CTAs' P V sums, added in rank order by the CTA whose
//    rank is the row's modulo the cluster, divided by the row's
//    denominator; those sums cross at the next head's first barrier. No
//    atomics: every run gives the same result. p, and so the map, is the
//    register route's arithmetic; out differs from it by the order of the
//    sums and the late division (held to 1e-5, tests/test_torch_gpu.py).
//    ~200-216 KB of shared memory: one CTA an SM, 66 clusters of 2
//    resident. Measured (cli.time_long_kernels --against parent, an H100
//    at 700 W, B=160, H=3, the model's own operands; PERF.md): 7.99 ->
//    5.21 ms at 785 tokens, 16.99 -> 8.43 ms at 1,025 (4.6x and 4.4x the
//    operations bound); what holds it above the register route's rate is
//    each CTA's fixed work a head spread over 3-5 chunks, the runs'
//    unequal chunk counts (3 + 4 at 785) meeting at the maxima's barrier.
//  * bf16 up to 1,152 tokens (mean_long_kernel<7, 2> up to 896 and
//    <9, 2> above; K4's attention at DeiT-Tiny/16's 448 px, K5's on its
//    bench pad to 896): the register route above in 2 row tiles (32 rows,
//    256 threads), each warp's 4 rows of the head mean in registers, 7 or
//    9 steps of 4 columns a lane (112 or 144 registers: 3 tiles' 384
//    threads would spill), ~160 KB of shared memory at 785, one block an
//    SM; the map is written once at the end. Bound at B=160, NP=785, H=3:
//    bytes, 588 MB (qkv, out, the fp32 map) = 0.1755 ms. Its head mean
//    takes the global route's adds in the same order. Measured against
//    the global route and against a head split (a cluster of H CTAs, one
//    a head, each its head's fp32 probabilities of the band in shared
//    memory, the head mean added over distributed shared memory as K1's
//    is), on an H100 at 700 W (PERF.md):
//    the head split exchanged twice K1's bytes (fp32 probabilities) over
//    distributed shared memory and read no faster than the global route.
//  * bf16 above 1,152 tokens, and fp32 above 5,120 columns: the global
//    route, a simple route not yet tuned (PERF.md has its time against its
//    bound): the head mean accumulates in the output map itself, in
//    global memory (zeroed
//    by the block first, each entry updated by one lane in the same order:
//    acc = acc + p * (1/H), head by head, so the map is the one the
//    register route would give), and the entries outside the real block
//    are zeroed at the end; the softmax loops over a row's steps, writing
//    e back in place, then p; bf16: the block's fp32 logits stay in
//    shared memory, in 1 row tile (16 rows, up to ~2,900 tokens; 3 tiles'
//    logits fit no head dim past 1,152 tokens); fp32: P lies in a scratch
//    buffer in global
//    memory (32 rows a block, L2-resident while the block runs), and the
//    8 warps' P V sums meet in shared memory.
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

// The long kernel (NP >= ppf::kLongMinTokens): 16 TILES query rows a
// block in TILES 16-row tiles, kLongWarps warps a tile, no cluster.
// Pass 1 computes each fp32 logit of the block's rows once and stores it;
// the softmax runs over the stored values, each warp its kLongRowsPerWarp
// rows, with the head mean in registers (or in the map: the global
// route); P V reads the stored probabilities. K, then V, stream through a
// ring of kLongStages chunk buffers, each filled by cp.async one chunk
// ahead, and the head's Q rows come with its first K chunk.
constexpr int kLongWarps = 4;
constexpr int kLongRowsPerWarp = 4;  // a tile's 16 rows over its 4 warps
constexpr int kLongChunk = 32 * kLongWarps;  // keys a chunk: 2 key tiles a warp
constexpr int kLongStages = 2;

// Steps of 128 columns (4 a lane) a softmax row takes at NP tokens: the
// register route is built for 3, 4 and 5 (NP up to 384, 512 and 640).
inline int long_steps(int NP) { return (NP + kLongChunk - 1) / kLongChunk; }

// Its shared memory at `tiles` row tiles: the policy, each warp's row
// maxima of its tile, the block's Q rows, the ring, and the block's fp32
// logits (then probabilities) over the 32-key blocks that hold real keys
// (pass 1 writes whole blocks), at a stride of 8 mod 32 words past them: a
// half warp's float2 accesses (4 rows x 8 words) fall on 32 distinct banks.
struct LongLayout {
  int nk, lstride, kstride;
  size_t pol, red, q, ring, lg, total;
  __host__ __device__ LongLayout(int NP, int hd, int tiles) {
    const int rows = 16 * tiles;
    nk = ppf::round_up(NP, 16);
    lstride = ppf::round_up(NP, 32) + 8;
    kstride = ppf::kv_stride(hd);
    pol = 0;
    red = ppf::align16(pol + (size_t)ppf::round_up(NP, kLongChunk) *
                                 sizeof(float));
    q = ppf::align16(red + (size_t)rows / 4 * 16 * sizeof(float));
    ring = ppf::align16(q + (size_t)rows * kstride * sizeof(__nv_bfloat16));
    lg = ppf::align16(ring + (size_t)kLongStages * kLongChunk * kstride *
                                 sizeof(__nv_bfloat16));
    total = ppf::align16(lg + (size_t)rows * lstride * sizeof(float));
  }
};

// The long kernel's route at NP tokens: ST = long_steps(NP) up to 640
// tokens (the head mean in registers, 3 row tiles); ST = 7 up to 896 and
// 9 up to 1,152 (the same in 2 row tiles, whose registers hold 4 rows'
// head mean of 7 or 9 steps a lane: 3 tiles would spill); else ST = 0,
// the global route, in 1 row tile (past 1,152 tokens 3 tiles' logits fit
// shared memory at no head dim).
struct LongRoute {
  int st, tiles;
};

LongRoute long_route(int NP, int hd) {
  const int st = long_steps(NP);
  if (st <= 5) return {st, 3};
  if (st <= 9 && LongLayout(NP, hd, 2).total <= ppf::kMaxSmemPerBlock)
    return {st <= 7 ? 7 : 9, 2};
  return {0, 1};
}

// rows kLongRows * blockIdx.x on of sample blockIdx.y; ST and TILES its
// route (long_route)
template <int ST, int TILES>
__global__ void __launch_bounds__(32 * kLongWarps * TILES, 1)
mean_long_kernel(const __nv_bfloat16* __restrict__ qkv,
                 const float* __restrict__ policy, int NP, int C, int H,
                 int real_n, float scale, float eps_over_n,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ map_out) {
  constexpr int kLongRows = 16 * TILES;
  constexpr int kLongNW = kLongWarps * TILES;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = C / H;
  const int hk = (hd + 15) / 16;
  const int C3 = 3 * C;
  const LongLayout L(NP, hd, TILES);
  float* pol = reinterpret_cast<float*>(smem + L.pol);
  float* red = reinterpret_cast<float*>(smem + L.red);
  __nv_bfloat16* qbuf = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + L.ring);
  float* lg = reinterpret_cast<float*>(smem + L.lg);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int tw = warp / kLongWarps;  // the warp's row tile
  const int w = warp % kLongWarps;   // its 2 key tiles of a chunk, and its
                                     // 16 columns of the head dim in P V
  const int b = blockIdx.y;
  const int row0 = kLongRows * blockIdx.x;
  const int rows = min(kLongRows, NP - row0);  // rows of the block < NP
  const int r0 = row0 + 16 * tw;               // the tile's first row
  const bool active = 16 * tw < rows;
  const bool pv = active && w < hk;
  const __nv_bfloat16* qkv_b = qkv + (size_t)b * NP * C3;
  const float rH = 1.0f / (float)H;
  const float neg_inf = __uint_as_float(0xff800000u);
  const int nc = (NP + kLongChunk - 1) / kLongChunk;      // K chunks a head
  const int nv = (real_n + kLongChunk - 1) / kLongChunk;  // V chunks a head
  // softmax rows a warp holds at once: two, but one at 5 steps, where two
  // rows' 40 values beside the head mean's 80 would spill
  constexpr int RG = ST >= 5 ? 1 : 2;
  float* ltile = lg + 16 * tw * L.lstride;
  // ldmatrix's row and column of this lane in a 16 x 16 tile
  const int lrow = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int lcol = (lane >> 4) * 8;

  load_policy(policy ? policy + (size_t)b * NP : nullptr, NP,
              ppf::round_up(NP, kLongChunk), pol);
  // the head mean of rows warp + kLongNW k, columns 4 lane + 128 st .. + 3
  // (the global route: in the map, each entry zeroed by the lane that
  // updates it)
  float4 acc[kLongRowsPerWarp][ST > 0 ? ST : 1];
  if constexpr (ST > 0) {
#pragma unroll
    for (int k = 0; k < kLongRowsPerWarp; ++k)
#pragma unroll
      for (int st = 0; st < ST; ++st)
        acc[k][st] = make_float4(0.f, 0.f, 0.f, 0.f);
  } else {
    for (int k = 0; k < kLongRowsPerWarp; ++k) {
      const int r = warp + kLongNW * k;
      if (r >= rows) continue;
      float* mrow = map_out + ((size_t)b * NP + row0 + r) * NP;
      for (int c0 = 4 * lane; c0 < NP; c0 += kLongChunk)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (c0 + j < NP) mrow[c0 + j] = 0.f;
    }
  }

  // the stream of chunks: each head's K chunks (rows >= NP zeros), with the
  // first of them the head's Q rows, then its V chunks (rows >= real_n
  // zeros). fetch() copies the next one, (ih, ic), into stage ist;
  // arrive() waits for the oldest, in stage cst, publishes it, and refills
  // the stage every warp is done with
  const size_t chunk = (size_t)kLongChunk * L.kstride;
  const ppf::CopySteps cs = ppf::copy_steps<__nv_bfloat16>(16 * hk);
  int ih = 0, ic = 0, ist = 0, cst = 0;
  auto fetch = [&]() {
    if (ih < H) {
      if (ic == 0)
        ppf::load_rows_async(qkv_b + (size_t)row0 * C3, C3, ih * hd, hd,
                             NP - row0, kLongRows, qbuf, L.kstride, cs);
      const bool isk = ic < nc;
      const int k0 = (isk ? ic : ic - nc) * kLongChunk;
      ppf::load_rows_async(qkv_b + (size_t)k0 * C3, C3,
                           (isk ? C : 2 * C) + ih * hd, hd,
                           (isk ? NP : real_n) - k0, kLongChunk,
                           ring + ist * chunk, L.kstride, cs);
    }
    if (++ic == nc + nv) {
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
    const __nv_bfloat16* buf = ring + cst * chunk;
    cst = cst + 1 == kLongStages ? 0 : cst + 1;
    return buf;
  };

  for (int k = 0; k < kLongStages - 1; ++k) fetch();
  for (int h = 0; h < H; ++h) {
    // pass 1: each warp its 2 key tiles of every chunk. The logits, fp32
    // dots times the scale (columns >= NP -inf), into the tile's fp32 rows,
    // and the row maxima
    uint32_t qa[4][4];
    float mx[2] = {neg_inf, neg_inf};
    for (int c = 0; c < nc; ++c) {
      const __nv_bfloat16* kb = arrive();  // the first also brings Q
      if (!active) continue;
      if (c == 0) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          if (kk < hk)
            ppf::ldmatrix_x4(qa[kk], qbuf + (16 * tw + lrow) * L.kstride +
                                         16 * kk + lcol);
      }
      const int k0 = c * kLongChunk + 32 * w;
      if (k0 >= NP) continue;  // key tiles of pads only: never read
      float S[4][4];
      ppf::warp_qk<2>(S, qa, kb + 32 * w * L.kstride, L.kstride, hk);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int col = k0 + 8 * n + 2 * t;
          float x = __fmul_rn(S[n][2 * r], scale);
          float y = __fmul_rn(S[n][2 * r + 1], scale);
          if (col >= NP) x = neg_inf;
          if (col + 1 >= NP) y = neg_inf;
          mx[r] = fmaxf(mx[r], fmaxf(x, y));
          *reinterpret_cast<float2*>(ltile + (g + 8 * r) * L.lstride + col) =
              make_float2(x, y);
        }
    }
    if (active) {
      mx[0] = ppf::quad_max(mx[0]);
      mx[1] = ppf::quad_max(mx[1]);
      if (t == 0) {
        red[warp * 16 + g] = mx[0];
        red[warp * 16 + g + 8] = mx[1];
      }
    }
    __syncthreads();  // every logit and row maximum of the block stored
    // pass 2: the softmax of each warp's rows, RG at a time, a lane 4
    // columns of each 128, each row held in registers from its load to its
    // store: e = exp(s - m) * policy (the identity escape on the diagonal;
    // 0 past NP, where s is -inf and the policy 0) and its row sum (each
    // lane's values in column order, then the warp's lanes); p = (e +
    // eps/real_n) / (sum + 1e-6), the division from the row's reciprocal
    // (ppf::div_by_recip), 0 past NP, over the logits in place; the head
    // mean in registers. Rows past the block's (the last block's) skip.
    if constexpr (ST == 0) {
      // one row at a time: e written back over its logits, then p, and
      // the head mean in the map
      for (int k = 0; k < kLongRowsPerWarp; ++k) {
        const int r = warp + kLongNW * k;
        if (r >= rows) continue;
        const int i = row0 + r;
        const float* rm = red + (r >> 4) * kLongWarps * 16 + (r & 15);
        float m = rm[0];
#pragma unroll
        for (int q = 1; q < kLongWarps; ++q) m = fmaxf(m, rm[16 * q]);
        float* prow = lg + r * L.lstride;
        float sum = 0.f;
        for (int c0 = 4 * lane; c0 < L.nk; c0 += kLongChunk) {
          float4 x = *reinterpret_cast<const float4*>(prow + c0);
          const float4 pw = *reinterpret_cast<const float4*>(pol + c0);
          float* v = reinterpret_cast<float*>(&x);
          const float pp[4] = {pw.x, pw.y, pw.z, pw.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float wgt =
                c0 + j == i ? __fadd_rn(pp[j], __fsub_rn(1.f, pp[j])) : pp[j];
            v[j] = __fmul_rn(expf(__fsub_rn(v[j], m)), wgt);
            sum = __fadd_rn(sum, v[j]);
          }
          *reinterpret_cast<float4*>(prow + c0) = x;
        }
        const float denom = __fadd_rn(ppf::warp_sum(sum), 1e-6f);
        const float rcp = __frcp_rn(denom);
        float* mrow = map_out + ((size_t)b * NP + i) * NP;
        for (int c0 = 4 * lane; c0 < L.nk; c0 += kLongChunk) {
          float4 x = *reinterpret_cast<const float4*>(prow + c0);
          float* v = reinterpret_cast<float*>(&x);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            float p = ppf::div_by_recip(__fadd_rn(v[j], eps_over_n), denom,
                                        rcp);
            if (c0 + j >= NP)
              p = 0.f;
            else
              mrow[c0 + j] = __fadd_rn(mrow[c0 + j], __fmul_rn(p, rH));
            v[j] = p;
          }
          *reinterpret_cast<float4*>(prow + c0) = x;
        }
      }
    } else {
#pragma unroll
      for (int k2 = 0; k2 < kLongRowsPerWarp; k2 += RG) {
        float4 x[RG][ST > 0 ? ST : 1];
        float sum[RG];
#pragma unroll
        for (int kk = 0; kk < RG; ++kk) {
          sum[kk] = 0.f;
          const int r = warp + kLongNW * (k2 + kk);
          if (r >= rows) continue;
          const float* prow = lg + r * L.lstride + 4 * lane;
#pragma unroll
          for (int st = 0; st < ST; ++st)
            if (4 * lane + 128 * st < L.nk)
              x[kk][st] = *reinterpret_cast<const float4*>(prow + 128 * st);
        }
#pragma unroll
        for (int kk = 0; kk < RG; ++kk) {
          const int r = warp + kLongNW * (k2 + kk);
          if (r >= rows) continue;
          const int i = row0 + r;
          const float* rm = red + (r >> 4) * kLongWarps * 16 + (r & 15);
          float m = rm[0];
#pragma unroll
          for (int q = 1; q < kLongWarps; ++q) m = fmaxf(m, rm[16 * q]);
#pragma unroll
          for (int st = 0; st < ST; ++st) {
            const int c0 = 4 * lane + 128 * st;
            if (c0 < L.nk) {
              const float4 pw = *reinterpret_cast<const float4*>(pol + c0);
              float* v = reinterpret_cast<float*>(&x[kk][st]);
              const float pp[4] = {pw.x, pw.y, pw.z, pw.w};
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                const float wgt =
                    c0 + j == i ? __fadd_rn(pp[j], __fsub_rn(1.f, pp[j])) : pp[j];
                v[j] = __fmul_rn(expf(__fsub_rn(v[j], m)), wgt);
                sum[kk] = __fadd_rn(sum[kk], v[j]);
              }
            }
          }
        }
#pragma unroll
        for (int kk = 0; kk < RG; ++kk) {
          const int r = warp + kLongNW * (k2 + kk);
          if (r >= rows) continue;
          const float denom = __fadd_rn(ppf::warp_sum(sum[kk]), 1e-6f);
          const float rcp = __frcp_rn(denom);
          float* prow = lg + r * L.lstride + 4 * lane;
#pragma unroll
          for (int st = 0; st < ST; ++st) {
            const int c0 = 4 * lane + 128 * st;
            if (c0 < L.nk) {
              float* v = reinterpret_cast<float*>(&x[kk][st]);
              float* a = reinterpret_cast<float*>(&acc[k2 + kk][st]);
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                float p = ppf::div_by_recip(__fadd_rn(v[j], eps_over_n), denom,
                                            rcp);
                if (c0 + j >= NP) p = 0.f;
                a[j] = __fadd_rn(a[j], __fmul_rn(p, rH));
                v[j] = p;
              }
              *reinterpret_cast<float4*>(prow + 128 * st) = x[kk][st];
            }
          }
        }
      }
    }
    // pass 3: O = P V over the chunks of V, in key order, with P rounded to
    // bf16 (nearest even) as P V's operand; each warp the head dim's
    // columns 16 w .. 16 w + 15, so no two warps' sums meet. Key tiles at
    // or past real_n (zero V rows) are skipped
    float O[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) O[n][e] = 0.f;
    for (int c = 0; c < nv; ++c) {
      const __nv_bfloat16* vb = arrive();  // its barrier also publishes P
      if (!pv) continue;
#pragma unroll
      for (int j = 0; j < kLongChunk / 16; ++j) {
        const int kc = c * kLongChunk + 16 * j;
        if (kc >= real_n) break;
        const float* pr = ltile + g * L.lstride + kc + 2 * t;
        const float2 p0 = *reinterpret_cast<const float2*>(pr);
        const float2 p1 = *reinterpret_cast<const float2*>(pr + 8 * L.lstride);
        const float2 p2 = *reinterpret_cast<const float2*>(pr + 8);
        const float2 p3 =
            *reinterpret_cast<const float2*>(pr + 8 * L.lstride + 8);
        const uint32_t pa[4] = {
            ppf::pack_bf16(p0.x, p0.y), ppf::pack_bf16(p1.x, p1.y),
            ppf::pack_bf16(p2.x, p2.y), ppf::pack_bf16(p3.x, p3.y)};
        uint32_t bv[4];
        ppf::ldmatrix_x4_trans(
            bv, vb + (16 * j + lrow) * L.kstride + 16 * w + lcol);
        ppf::mma_bf16(O[0], pa, bv[0], bv[1]);
        ppf::mma_bf16(O[1], pa, bv[2], bv[3]);
      }
    }
    if (pv) {
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const int col = 16 * w + 8 * n + 2 * t;
        if (col < hd) {
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int row = g + 8 * half;
            if (row < NP - r0)
              *reinterpret_cast<__nv_bfloat162*>(
                  out + ((size_t)b * NP + r0 + row) * C + h * hd + col) =
                  __floats2bfloat162_rn(O[n][2 * half], O[n][2 * half + 1]);
          }
        }
      }
    }
  }

  // the head mean, zero outside the real block: each warp stages its rows
  // in the logits' space, then writes them row by row (the global route:
  // zeroes its rows' entries outside the real block in the map)
  __syncthreads();  // every warp is done with the last head's P
  if constexpr (ST == 0) {
    for (int k = 0; k < kLongRowsPerWarp; ++k) {
      const int r = warp + kLongNW * k;
      if (r >= rows) continue;
      const int i = row0 + r;
      float* mrow = map_out + ((size_t)b * NP + i) * NP;
      for (int j = i < real_n ? real_n + lane : lane; j < NP; j += ppf::kWarp)
        mrow[j] = 0.f;
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < kLongRowsPerWarp; ++k) {
    const int r = warp + kLongNW * k;
    if (r >= rows) continue;
    float* prow = lg + r * L.lstride + 4 * lane;
#pragma unroll
    for (int st = 0; st < ST; ++st)
      if (4 * lane + 128 * st < L.nk)
        *reinterpret_cast<float4*>(prow + 128 * st) = acc[k][st];
  }
  __syncwarp();
#pragma unroll
  for (int k = 0; k < kLongRowsPerWarp; ++k) {
    const int r = warp + kLongNW * k;
    if (r >= rows) continue;
    const int i = row0 + r;
    const float* src = lg + r * L.lstride;
    float* dst = map_out + ((size_t)b * NP + i) * NP;
    for (int j = lane; j < NP; j += ppf::kWarp) {
      const float real = (i < real_n && j < real_n) ? 1.f : 0.f;
      dst[j] = __fmul_rn(src[j], real);
    }
  }
}

bool long_tokens(int NP) { return NP >= ppf::kLongMinTokens; }

size_t smem_bytes(int NP, int hd) {
  if (!long_tokens(NP)) return Layout(NP, hd).total;
  return LongLayout(NP, hd, long_route(NP, hd).tiles).total;
}

// Runs the statements given with `kernel` the bf16 kernel for NP tokens at
// head dim HD and `threads` its block size; returns cudaErrorInvalidValue
// where none takes NP.
#define PPF_DISPATCH_BF16(NP, HD, ...)                                     \
  if (long_tokens(NP)) {                                                   \
    const LongRoute rt = long_route(NP, HD);                               \
    const int threads = 32 * kLongWarps * rt.tiles;                        \
    switch (10 * rt.st + rt.tiles) {                                       \
      case 33: { auto kernel = mean_long_kernel<3, 3>; __VA_ARGS__ } break; \
      case 43: { auto kernel = mean_long_kernel<4, 3>; __VA_ARGS__ } break; \
      case 53: { auto kernel = mean_long_kernel<5, 3>; __VA_ARGS__ } break; \
      case 72: { auto kernel = mean_long_kernel<7, 2>; __VA_ARGS__ } break; \
      case 92: { auto kernel = mean_long_kernel<9, 2>; __VA_ARGS__ } break; \
      case 1: { auto kernel = mean_long_kernel<0, 1>; __VA_ARGS__ } break;  \
      default: return cudaErrorInvalidValue;                               \
    }                                                                      \
  } else {                                                                 \
    constexpr int threads = kThreads;                                      \
    PPF_DISPATCH_KT(NP, {                                                  \
      auto kernel = mean_kernel<KT>;                                       \
      __VA_ARGS__                                                          \
    });                                                                    \
  }

cudaError_t launch(const void* qkv, const float* policy, int B, int NP, int C,
                   int H, int real_n, float scale, float eps_over_n, void* out,
                   float* map, cudaStream_t stream) {
  const size_t smem = smem_bytes(NP, C / H);
  const int long_rows = 16 * long_route(NP, C / H).tiles;
  const dim3 grid = long_tokens(NP)
                        ? dim3((NP + long_rows - 1) / long_rows, B)
                        : dim3(((NP + 15) / 16 + kTiles - 1) / kTiles, B);
  PPF_DISPATCH_BF16(NP, C / H, {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    kernel<<<grid, threads, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(qkv), policy, NP, C, H, real_n,
        scale, eps_over_n, static_cast<__nv_bfloat16*>(out), map);
  });
  return cudaGetLastError();
}

// Blocks of the kernel for NP tokens an SM holds at once.
int resident_blocks(int NP, int hd) {
  const size_t smem = smem_bytes(NP, hd);
  int blocks = 0;
  PPF_DISPATCH_BF16(NP, hd, {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          threads, smem);
    if (err != cudaSuccess) return -static_cast<int>(err);
  });
  return blocks;
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
constexpr int kLongMaxRegCols = 640;  // CT = 20 at most; above, the global route

struct LongLayout {
  int cols, kstride, pstride;
  size_t pol, red, q, ring, p, total;
  __host__ __device__ LongLayout(int NP, int hd) {
    cols = ppf::round_up(NP, kLongChunk);
    const bool global = cols > kLongMaxRegCols;
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
    // P, whose space also takes the 8 warps' 32 x 64 sums of P V (on the
    // global route those sums only: P lies in global memory)
    const int pf = !global && kRows * pstride > 8 * kRows * 64
                       ? kRows * pstride
                       : 8 * kRows * 64;
    total = ppf::align16(p + (size_t)pf * sizeof(float));
  }
};

// Accumulator columns of a lane (lane + 32 u, u < CT = cols / 32) at NP
// tokens: the long kernel's register route is built for CT = 12, 16 and
// 20 (cols = 384, 512 and 640); above 640 columns its global route
// (CT = 0) holds no accumulator.
inline int long_ct(int NP) {
  const int cols = LongLayout(NP, 4).cols;
  return cols > kLongMaxRegCols ? 0 : cols / 32;
}

// Bytes of the global route's P scratch: 32 x pstride floats a block.
size_t long_scratch_bytes(int B, int NP, int hd) {
  if (long_ct(NP) != 0) return 0;
  return (size_t)B * ((NP + kRows - 1) / kRows) * kRows *
         LongLayout(NP, hd).pstride * sizeof(float);
}

// CT = long_ct(NP); p_g: on the global route (CT = 0) the scratch whose
// kRows x pstride floats from block (blockIdx.y, blockIdx.x) on hold P.
template <int CT>
__global__ void __launch_bounds__(kThreads, 1)
mean_long_kernel(const float* __restrict__ qkv,
                 const float* __restrict__ policy, int NP, int C, int H,
                 int real_n, float scale, float eps_over_n,
                 float* __restrict__ out, float* __restrict__ map_out,
                 float* p_g) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = C / H;
  const int C3 = 3 * C;
  const LongLayout L(NP, hd);
  float* pol = reinterpret_cast<float*>(smem + L.pol);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* qbuf = reinterpret_cast<float*>(smem + L.q);
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  // P's space in shared memory, which also takes the 8 warps' P V sums;
  // on the global route P itself lies in the scratch
  float* Ps = reinterpret_cast<float*>(smem + L.p);
  float* P = CT == 0 ? p_g + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                                 kRows * L.pstride
                     : Ps;

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
  // the head mean of rows srow .. srow + 3, columns lane + 32 u (the global
  // route: in the map, each entry zeroed by the lane that updates it)
  float acc[4][CT > 0 ? CT : 1];
  if constexpr (CT > 0) {
#pragma unroll
    for (int rr = 0; rr < 4; ++rr)
#pragma unroll
      for (int u = 0; u < CT; ++u) acc[rr][u] = 0.f;
  } else {
    for (int rr = 0; rr < 4; ++rr) {
      const int i = row0 + srow + rr;
      if (i >= NP) break;
      float* dst = map_out + ((size_t)b * NP + i) * NP;
      for (int c = lane; c < NP; c += ppf::kWarp) dst[c] = 0.f;
    }
  }

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
    if constexpr (CT == 0) {
      // one row at a time: e written back over its logits, then p, and
      // the head mean in the map (rows past NP are never stored)
      for (int rr = 0; rr < 4 && row0 + srow < NP; ++rr) {
        float* prow = P + (srow + rr) * L.pstride + lane;
        const float* rm = red + srow + rr;
        const float m = fmaxf(fmaxf(rm[0], rm[kRows]),
                              fmaxf(rm[2 * kRows], rm[3 * kRows]));
        const int i = row0 + srow + rr;
        float sum = 0.f;
        for (int u = 0; u < L.cols / 32; ++u) {
          const int c = lane + 32 * u;
          const float pe = pol[c];
          const float w = c == i ? __fadd_rn(pe, __fsub_rn(1.f, pe)) : pe;
          const float e = __fmul_rn(expf(__fsub_rn(prow[32 * u], m)), w);
          prow[32 * u] = e;
          sum = __fadd_rn(sum, e);
        }
        const float denom = __fadd_rn(ppf::warp_sum(sum), 1e-6f);
        const float rcp = __frcp_rn(denom);
        float* dst = map_out + ((size_t)b * NP + i) * NP;
        for (int u = 0; u < L.cols / 32; ++u) {
          const int c = lane + 32 * u;
          const float p = ppf::div_by_recip(__fadd_rn(prow[32 * u], eps_over_n),
                                            denom, rcp);
          if (i < NP && c < NP) dst[c] = __fadd_rn(dst[c], __fmul_rn(p, rH));
          prow[32 * u] = p;
        }
      }
    } else if (row0 + srow < NP) {  // a warp of pad rows only (a band's last) skips
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
    float* part = Ps + kg * kRows * 64;
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
      float4 a0 = *reinterpret_cast<const float4*>(Ps + r * 64 + c0);
      float4 a1 = *reinterpret_cast<const float4*>(Ps + r * 64 + c0 + 4);
#pragma unroll
      for (int g = 1; g < kThreads / 32; ++g) {
        const float* src = Ps + g * kRows * 64 + r * 64 + c0;
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
  // each lane writes the accumulator entries it holds (the global route:
  // zeroes those outside the real block)
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int i = row0 + srow + rr;
    if (i < NP && CT == 0) {
      float* dst = map_out + ((size_t)b * NP + i) * NP;
      for (int c = lane; c < NP; c += ppf::kWarp)
        if (i >= real_n || c >= real_n) dst[c] = 0.f;
    } else if (i < NP) {
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

// --- above 640 columns: the split route ---------------------------------------

// A thread block cluster of split_ctas(NP) CTAs takes each block of 32
// query rows, CTA `rank` the keys of its run of 128-key chunks
// (split_chunks), so that each runs the register route above on at most
// 640 columns: its logits and P in shared memory, its columns of the head
// mean in registers. What crosses the cluster goes through distributed
// shared memory (see the header).

// CTAs of the cluster at NP tokens: 1 up to kLongMaxRegCols columns (the
// register route, no cluster), ceil(cols / kLongMaxRegCols) up to
// ppf::kMaxClusterSize (5,120 columns); 0 above, where the global route
// runs.
__host__ __device__ inline int split_ctas(int NP) {
  const int cols = ppf::round_up(NP, kLongChunk);
  if (cols <= kLongMaxRegCols) return 1;
  const int cs = (cols + kLongMaxRegCols - 1) / kLongMaxRegCols;
  return cs <= ppf::kMaxClusterSize ? cs : 0;
}

// The chunks [lo, hi) of a head's nc that CTA `rank` of a cluster of cs
// takes: contiguous runs whose lengths differ by one at most, the longer
// ones last (the row's last chunk, often a ragged one, in one of them);
// each at most ceil(nc / cs) <= 5 chunks.
__host__ __device__ inline void split_chunks(int nc, int cs, int rank,
                                             int& lo, int& hi) {
  lo = rank * nc / cs;
  hi = (rank + 1) * nc / cs;
}

// The split route's shared memory: LongLayout's over the columns of the
// longest run, then the exchange (the rows' maxima and sums over the
// CTA's keys, their denominators over the cluster's, and the CTA's
// kRows x 64 sums of P V).
struct SplitLayout {
  int cols, kstride, pstride;
  size_t pol, red, q, ring, p, x, total;
  __host__ __device__ SplitLayout(int NP, int hd) {
    const int cs = split_ctas(NP);
    const int nc = ppf::round_up(NP, kLongChunk) / kLongChunk;
    cols = kLongChunk * ((nc + cs - 1) / cs);
    kstride = hd + 4;
    pstride = cols + 8;
    pol = 0;
    red = ppf::align16(pol + (size_t)cols * sizeof(float));
    q = ppf::align16(red + (size_t)4 * kRows * sizeof(float));
    ring = ppf::align16(q + (size_t)2 * kRows * kstride * sizeof(float));
    p = ppf::align16(ring + (size_t)kLongStages * kLongChunk * kstride *
                                sizeof(float));
    const int pf = kRows * pstride > 8 * kRows * 64 ? kRows * pstride
                                                    : 8 * kRows * 64;
    x = ppf::align16(p + (size_t)pf * sizeof(float));
    total = ppf::align16(x + (size_t)(3 + 64) * kRows * sizeof(float));
  }
};

// The split route's kernel: CT = SplitLayout(NP, hd).cols / 32 (12, 16
// or 20), a cluster of split_ctas(NP) CTAs along x a row block. Per head
// two cluster barriers: the first publishes the rows' maxima (and the
// previous head's P V sums, which the CTAs then add up: reduce_out), the
// second, split in two around P V, the rows' sums of e. P V multiplies
// e + eps/real_n by V and out is divided by the row's denominator at the
// end, so P V does not wait for the sums. S, e, the sums and p are
// computed as the register route computes them, and added over the CTAs
// in rank order.
template <int CT>
__global__ void __launch_bounds__(kThreads, 1)
mean_split_kernel(const float* __restrict__ qkv,
                  const float* __restrict__ policy, int NP, int C, int H,
                  int real_n, float scale, float eps_over_n,
                  float* __restrict__ out, float* __restrict__ map_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  ppf::cg::cluster_group cluster = ppf::cg::this_cluster();
  const int hd = C / H;
  const int C3 = 3 * C;
  const SplitLayout L(NP, hd);
  float* pol = reinterpret_cast<float*>(smem + L.pol);
  float* red = reinterpret_cast<float*>(smem + L.red);
  float* qbuf = reinterpret_cast<float*>(smem + L.q);
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  // P, whose space also takes the 8 warps' P V sums
  float* P = reinterpret_cast<float*>(smem + L.p);
  float* xm = reinterpret_cast<float*>(smem + L.x);  // rows' maxima
  float* xs = xm + kRows;                            // rows' sums of e
  float* xd = xs + kRows;  // rows' denominators (the CTA's own)
  float* xo = xd + kRows;  // the CTA's P V sums, kRows x 64

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int b = blockIdx.y;
  // the cluster's CTAs are consecutive along x; CTA rank takes chunks
  // [c_lo, c_hi) of the head's, keys k_lo on (its column 0)
  const int cs = split_ctas(NP);
  const int rank = static_cast<int>(blockIdx.x) % cs;
  int c_lo, c_hi;
  split_chunks(ppf::round_up(NP, kLongChunk) / kLongChunk, cs, rank, c_lo,
               c_hi);
  const int nc = c_hi - c_lo;  // chunks of K (and of V) a head
  const int k_lo = c_lo * kLongChunk;
  // the CTA's columns that hold logits, to the last 32 that hold a key
  const int live = min(nc * kLongChunk, ppf::round_up(NP - k_lo, 32));
  const int row0 = blockIdx.x / cs * kRows;
  const float* qkv_b = qkv + (size_t)b * NP * C3;
  const float rH = 1.0f / (float)H;
  const float neg_inf = __uint_as_float(0xff800000u);
  // S = Q K^T as the register route takes it: a warp 16 rows x 32 keys of
  // a chunk, a lane 4 x 4 (rows s_r + 4i, keys s_c + 8j)
  const int s_r = 16 * (warp & 1) + (lane >> 3);
  const int s_c = 32 * (warp >> 1) + (lane & 7);
  const bool s_live = row0 + 16 * (warp & 1) < NP;
  // the softmax and the head mean: block rows srow .. srow + 3; a warp of
  // pad rows only (a sample's last block) computes nothing of them but
  // meets the barriers
  const int srow = 4 * warp;
  const bool rows_live = row0 + srow < NP;
  // O = P V: warp kg keys 16 kg .. 16 kg + 15 of every chunk, a lane 8 x 8
  // of the 32 x 64 outputs (rows o_r + 4i, columns o_c .. o_c + 3 and
  // o_c + 32 .. o_c + 35)
  const int kg = warp;
  const int o_r = lane >> 3;
  const int o_c = 4 * (lane & 7);
  // out of head hh for the block's rows r = t / 8 whose rank is r % cs
  // (columns 8 (t % 8) .. + 7): the CTAs' P V sums in rank order, divided
  // by the row's denominator
  auto reduce_out = [&](int hh) {
    const int r = threadIdx.x >> 3;
    const int c0 = 8 * (threadIdx.x & 7);
    const int i = row0 + r;
    if (r % cs != rank || i >= NP || c0 >= hd) return;
    float a[8];
    for (int q = 0; q < cs; ++q) {
      const float* src = cluster.map_shared_rank(xo, q) + r * 64 + c0;
      const float4 b0 = *reinterpret_cast<const float4*>(src);
      const float4 b1 = *reinterpret_cast<const float4*>(src + 4);
      const float v[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) a[k] = q == 0 ? v[k] : __fadd_rn(a[k], v[k]);
    }
    const float denom = xd[r];
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] = __fdiv_rn(a[k], denom);
    float* dst = out + ((size_t)b * NP + i) * C + hh * hd + c0;
    *reinterpret_cast<float4*>(dst) = make_float4(a[0], a[1], a[2], a[3]);
    if (c0 + 4 < hd)
      *reinterpret_cast<float4*>(dst + 4) = make_float4(a[4], a[5], a[6], a[7]);
  };

  // the policy of the CTA's columns (0 past its run and past NP)
  load_policy(policy ? policy + (size_t)b * NP + k_lo : nullptr,
              min(NP, c_hi * kLongChunk) - k_lo, L.cols, pol);
  // the head mean of rows srow .. srow + 3, the CTA's columns lane + 32 u
  float acc[4][CT];
#pragma unroll
  for (int rr = 0; rr < 4; ++rr)
#pragma unroll
    for (int u = 0; u < CT; ++u) acc[rr][u] = 0.f;

  // the stream of chunks, as the register route's: each head's K chunks
  // of the CTA's run, then its V chunks, with the head's Q rows
  const size_t chunk = (size_t)kLongChunk * L.kstride;
  const ppf::CopySteps cps = ppf::copy_steps<float>(hd);
  int ih = 0, ic = 0, ist = 0, cst = 0;
  auto fetch = [&]() {
    if (ih < H) {
      if (ic == 0)
        ppf::load_rows_async(qkv_b + (size_t)row0 * C3, C3, ih * hd, hd,
                             NP - row0, kRows,
                             qbuf + (ih & 1) * kRows * L.kstride, L.kstride,
                             cps);
      const int k0 = k_lo + (ic < nc ? ic : ic - nc) * kLongChunk;
      ppf::load_rows_async(qkv_b + (size_t)k0 * C3, C3,
                           (ic < nc ? C : 2 * C) + ih * hd, hd,
                           (ic < nc ? NP : real_n) - k0, kLongChunk,
                           ring + ist * chunk, L.kstride, cps);
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
    // S over the CTA's chunks into P (its columns), -inf past NP, and each
    // lane's row maxima
    float mx[4] = {neg_inf, neg_inf, neg_inf, neg_inf};
    for (int c = 0; c < nc; ++c) {
      const float* kb = arrive();
      const int k0 = k_lo + c * kLongChunk;
      if (s_live) {
        float sv[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) sv[i][j] = 0.f;
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
            P[(s_r + 4 * i) * L.pstride + col - k_lo] = x;
            mx[i] = fmaxf(mx[i], x);
          }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 4));
      if ((lane & 7) == 0) red[(warp >> 1) * kRows + s_r + 4 * i] = mx[i];
    }
    __syncthreads();  // P holds the CTA's logits, red its maxima
    // barrier 1: the rows' maxima over the CTA's keys published, and the
    // previous head's P V sums
    if (threadIdx.x < kRows) {
      const float* rm = red + threadIdx.x;
      xm[threadIdx.x] = fmaxf(fmaxf(rm[0], rm[kRows]),
                              fmaxf(rm[2 * kRows], rm[3 * kRows]));
    }
    cluster.sync();
    if (h > 0) reduce_out(h - 1);
    // e = exp(s - m) * policy over the CTA's live columns, the row's sum
    // of e over them (each lane's columns in order, then the warp's
    // lanes), and e + eps/real_n back over the logits
    if (rows_live) {
      for (int rr = 0; rr < 4; ++rr) {
        float m = neg_inf;
        for (int r = 0; r < cs; ++r)
          m = fmaxf(m, cluster.map_shared_rank(xm, r)[srow + rr]);
        const int i = row0 + srow + rr;
        float* prow = P + (srow + rr) * L.pstride + lane;
        float sum = 0.f;
#pragma unroll
        for (int u = 0; u < CT; ++u) {
          if (32 * u < live) {
            const int c = lane + 32 * u;
            const float pe = pol[c];
            const float w =
                c + k_lo == i ? __fadd_rn(pe, __fsub_rn(1.f, pe)) : pe;
            const float e = __fmul_rn(expf(__fsub_rn(prow[32 * u], m)), w);
            prow[32 * u] = __fadd_rn(e, eps_over_n);
            sum = __fadd_rn(sum, e);
          }
        }
        sum = ppf::warp_sum(sum);
        if (lane == 0) xs[srow + rr] = sum;
      }
    }
    ppf::cluster_arrive();  // barrier 2: xs published; waited for after P V
    // O = (e + eps/real_n) V over the CTA's keys, each warp its keys of
    // each chunk in key order (V rows >= real_n zeros; two steps of 16
    // unrolled, so that the head mean stays in registers beside O)
    float o[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) o[i][j] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const float* vb = arrive();  // its barrier also publishes P
      const int k0 = c * kLongChunk + 16 * kg;  // the CTA's column
      if (k_lo + k0 < NP) {
#pragma unroll 2
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
    // the rows' sums of e over the CTAs in rank order; p = (e +
    // eps/real_n) / (sum + 1e-6) over the CTA's live columns by the row's
    // reciprocal (ppf::div_by_recip) into the head mean, and the row's
    // denominator for out
    ppf::cluster_wait();
    if (rows_live) {
#pragma unroll
      for (int rr = 0; rr < 4; ++rr) {
        float sum = cluster.map_shared_rank(xs, 0)[srow + rr];
        for (int r = 1; r < cs; ++r)
          sum = __fadd_rn(sum, cluster.map_shared_rank(xs, r)[srow + rr]);
        const float denom = __fadd_rn(sum, 1e-6f);
        const float rcp = __frcp_rn(denom);
        if (lane == 0) xd[srow + rr] = denom;
        const float* prow = P + (srow + rr) * L.pstride + lane;
#pragma unroll
        for (int u = 0; u < CT; ++u) {
          if (32 * u < live) {
            const float p = ppf::div_by_recip(prow[32 * u], denom, rcp);
            acc[rr][u] = __fadd_rn(acc[rr][u], __fmul_rn(p, rH));
          }
        }
      }
    }
    // the 8 warps' sums of P V in warp order, through P's space, into xo
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
      *reinterpret_cast<float4*>(xo + r * 64 + c0) = a0;
      *reinterpret_cast<float4*>(xo + r * 64 + c0 + 4) = a1;
    }
  }
  cluster.sync();  // the last head's P V sums published
  reduce_out(H - 1);
  // no CTA leaves while another reads its xo: arrive here, wait at the end
  ppf::cluster_arrive();
  // each lane writes the head-mean entries of its run that it holds, 0
  // outside the real block
  const int c_end = min(NP, c_hi * kLongChunk) - k_lo;
#pragma unroll
  for (int rr = 0; rr < 4; ++rr) {
    const int i = row0 + srow + rr;
    if (i < NP) {
      float* dst = map_out + ((size_t)b * NP + i) * NP + k_lo;
#pragma unroll
      for (int u = 0; u < CT; ++u) {
        const int c = lane + 32 * u;
        if (c < c_end) {
          const float real = (i < real_n && c + k_lo < real_n) ? 1.f : 0.f;
          dst[c] = __fmul_rn(acc[rr][u], real);
        }
      }
    }
  }
  ppf::cluster_wait();
}

bool long_tokens(int NP) { return NP >= ppf::kLongMinTokens; }

// Whether the split route takes NP tokens (641 to 5,120 columns).
bool split_route(int NP) { return long_tokens(NP) && split_ctas(NP) > 1; }

size_t smem_bytes(int NP, int hd) {
  if (split_route(NP)) return SplitLayout(NP, hd).total;
  return long_tokens(NP) ? LongLayout(NP, hd).total : Layout(NP, hd).total;
}

// Bytes of the launch's scratch (the global route's P; none on the split
// route, whose columns would otherwise take the global one).
size_t scratch_bytes(int B, int NP, int hd) {
  return split_route(NP) ? 0 : long_scratch_bytes(B, NP, hd);
}

// Runs the statements given with `kernel` the fp32 long kernel for NP
// tokens; returns cudaErrorInvalidValue where none takes NP.
#define PPF_DISPATCH_F32_LONG(NP, ...)                                   \
  switch (long_ct(NP)) {                                                 \
    case 12: { auto kernel = mean_long_kernel<12>; __VA_ARGS__ } break;  \
    case 16: { auto kernel = mean_long_kernel<16>; __VA_ARGS__ } break;  \
    case 20: { auto kernel = mean_long_kernel<20>; __VA_ARGS__ } break;  \
    case 0: { auto kernel = mean_long_kernel<0>; __VA_ARGS__ } break;    \
    default: return cudaErrorInvalidValue;                               \
  }

// The same for the split route's kernel (CT = its run's columns / 32).
#define PPF_DISPATCH_F32_SPLIT(NP, ...)                                   \
  switch (SplitLayout(NP, 4).cols / 32) {                                 \
    case 12: { auto kernel = mean_split_kernel<12>; __VA_ARGS__ } break;  \
    case 16: { auto kernel = mean_split_kernel<16>; __VA_ARGS__ } break;  \
    case 20: { auto kernel = mean_split_kernel<20>; __VA_ARGS__ } break;  \
    default: return cudaErrorInvalidValue;                                \
  }

// The same for the fp32 kernel for NP tokens, the short one too.
#define PPF_DISPATCH_F32(NP, ...)                                        \
  if (split_route(NP)) {                                                 \
    PPF_DISPATCH_F32_SPLIT(NP, __VA_ARGS__)                              \
  } else if (long_tokens(NP)) {                                          \
    PPF_DISPATCH_F32_LONG(NP, __VA_ARGS__)                               \
  } else {                                                               \
    PPF_DISPATCH_MAXT(NP, {                                              \
      auto kernel = mean_kernel<MAXT>;                                   \
      __VA_ARGS__                                                        \
    });                                                                  \
  }

// CTAs of the fp32 kernel's cluster a row block at NP tokens: 2-8 on the
// split route, 1 where one CTA takes a row block (up to 640 columns), 0
// on the global route (above 5,120).
int cluster_size(int NP) { return long_tokens(NP) ? split_ctas(NP) : 1; }

// The split route's launch of B samples: clusters of split_ctas(NP) CTAs
// along x, one a row block. `attr` must outlive the launch call.
cudaLaunchConfig_t split_config(int B, int NP, size_t smem,
                                cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  return ppf::cluster_launch_config(split_ctas(NP), B, kThreads, smem, stream,
                                    attr, (NP + kRows - 1) / kRows);
}

cudaError_t launch(const void* qkv, const float* policy, int B, int NP, int C,
                   int H, int real_n, float scale, float eps_over_n, void* out,
                   float* map, float* scratch, cudaStream_t stream) {
  const size_t smem = smem_bytes(NP, C / H);
  const dim3 grid((NP + kRows - 1) / kRows, B);
  if (scratch_bytes(B, NP, C / H) > 0 && scratch == nullptr)
    return cudaErrorInvalidValue;
  if (split_route(NP)) {
    PPF_DISPATCH_F32_SPLIT(NP, {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      cudaLaunchAttribute attr[1];
      const cudaLaunchConfig_t cfg = split_config(B, NP, smem, stream, attr);
      err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const float*>(qkv),
                               policy, NP, C, H, real_n, scale, eps_over_n,
                               static_cast<float*>(out), map);
      if (err != cudaSuccess) return err;
    });
  } else if (long_tokens(NP)) {
    PPF_DISPATCH_F32_LONG(NP, {
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kThreads, smem, stream>>>(
          static_cast<const float*>(qkv), policy, NP, C, H, real_n, scale,
          eps_over_n, static_cast<float*>(out), map, scratch);
    });
  } else {
    PPF_DISPATCH_MAXT(NP, {
      const auto kernel = mean_kernel<MAXT>;
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
      kernel<<<grid, kThreads, smem, stream>>>(
          static_cast<const float*>(qkv), policy, NP, C, H, real_n, scale,
          eps_over_n, static_cast<float*>(out), map);
    });
  }
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

// Clusters of the split route at NP tokens the card holds at once (0
// where the route does not run; negative: the cudaError_t of the query).
int active_clusters(int NP, int hd) {
  if (!split_route(NP)) return 0;
  const size_t smem = smem_bytes(NP, hd);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = split_config(1, NP, smem, nullptr, attr);
  int clusters = 0;
  PPF_DISPATCH_F32_SPLIT(NP, {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return -static_cast<int>(err);
  });
  return clusters;
}

}  // namespace f32k

}  // namespace

// qkv: (B, NP, 3C) fp32 or bf16 (is_bf16); policy: (B, NP) fp32 keep-mask
// (pads 0), or null for all ones; out: (B, NP, C) in the qkv dtype; map:
// (B, NP, NP) fp32. C / H is at most 64 and a multiple of 4 (fp32) or 8
// (bf16); any NP whose kernel fits a block's shared memory
// (ppf_attention_mean_smem_bytes). scratch:
// ppf_attention_mean_scratch_bytes of device memory (null where that is 0).
// scale = hd**-0.5 and eps_over_n = 1e-6/real_n as fp32.
extern "C" int ppf_attention_mean(const void* qkv, const void* policy, int B,
                                  int NP, int C, int H, int real_n, int is_bf16,
                                  float scale, float eps_over_n, void* out,
                                  void* map, void* stream, void* scratch) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pol = static_cast<const float*>(policy);
  float* m = static_cast<float*>(map);
  if (is_bf16)
    return bf16k::launch(qkv, pol, B, NP, C, H, real_n, scale, eps_over_n, out,
                         m, st);
  return f32k::launch(qkv, pol, B, NP, C, H, real_n, scale, eps_over_n, out, m,
                      static_cast<float*>(scratch), st);
}

extern "C" int ppf_attention_mean_smem_bytes(int NP, int hd, int is_bf16) {
  return (int)(is_bf16 ? bf16k::smem_bytes(NP, hd)
                       : f32k::smem_bytes(NP, hd));
}

// Device memory the launch at B samples of NP tokens needs for its scratch
// (the fp32 long kernel's P on its global route).
extern "C" long long ppf_attention_mean_scratch_bytes(int B, int NP, int hd,
                                                      int is_bf16) {
  if (is_bf16 || !f32k::long_tokens(NP)) return 0;
  return (long long)f32k::scratch_bytes(B, NP, hd);
}

// The route of the long kernel at NP tokens: 0 where the rows' head mean
// stays in registers or, in fp32, on chip over a cluster (and below 257
// tokens), 1 the global route.
extern "C" int ppf_attention_mean_global_route(int NP, int hd, int is_bf16) {
  if (is_bf16)
    return bf16k::long_tokens(NP) && bf16k::long_route(NP, hd).st == 0;
  return f32k::long_tokens(NP) && f32k::cluster_size(NP) == 0;
}

// CTAs of the fp32 kernel's cluster a row block of 32 at NP tokens: 2-8
// on the split route (641 to 5,120 columns), 1 where one CTA takes a row
// block, 0 on the global route (above 5,120).
extern "C" int ppf_attention_mean_f32_cluster_size(int NP) {
  return f32k::cluster_size(NP);
}

// How many of those clusters the card holds at once (0 off the split
// route; negative: the cudaError_t of the query).
extern "C" int ppf_attention_mean_f32_active_clusters(int NP, int hd) {
  return f32k::active_clusters(NP, hd);
}

// Blocks of the fp32 kernel for NP tokens at head dim hd an SM holds at
// once (negative: the cudaError_t of the query).
extern "C" int ppf_attention_mean_f32_resident_blocks(int NP, int hd) {
  return f32k::resident_blocks(NP, hd);
}

// The same for the bf16 kernel.
extern "C" int ppf_attention_mean_bf16_resident_blocks(int NP, int hd) {
  return bf16k::resident_blocks(NP, hd);
}
