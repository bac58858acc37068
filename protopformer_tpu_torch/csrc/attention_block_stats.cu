// K1: fused ones-policy attention with the head-mean map, its discard
// threshold and its masked row sums.
//
// Replaces protopformer_tpu/kernels/attention_core.py::_block_stats_kernel
// (reached via fused_attention_block_stats), which runs on the pre-prune
// blocks of the bf16 serving path. Per sample and head: QK^T with fp32
// accumulation rounded to bf16 and scaled in bf16; the eps-softmax of the
// JAX package's bf16 branch (bf16 exp, fp32 row sum + 1e-6, bf16 reciprocal
// multiply); AV with fp32 accumulation. The head mean accumulates in fp32
// (acc = acc + p * (1/H), heads in order, no fused multiply-add), is
// rounded once to the storage dtype (bf16 in speed mode, fp32 in exact
// mode), and the threshold is the keep-th largest key of the STORED map
// (its high 16 bits, or the fp32 pattern) clamped to [0, bits(1.0)]: the
// value the JAX kernel's bisection returns.
//
// Bound on an H100: bytes (qkv read once, out and the map written once:
// 60.8 MB speed / 73.3 MB exact at B=160, N=197, against 4.77 GFLOP that
// the tensor cores do in ~5 us). Design:
//  * Both products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//    fp32 accumulate; ldmatrix from shared memory), one warp per 16-row
//    tile, N padded to 16 key_tiles(N) (208 at N=197) with zero rows and
//    -inf logits in the pad columns. The probabilities never leave
//    registers: the S accumulators, rounded, are P's A operand.
//  * One sample is split over a thread-block cluster of ceil(tiles / 4)
//    CTAs (4 at N=197, so 640 CTAs at B=160), each holding its band of at
//    most four tiles: the band's fp32 accumulator and one head's K, then V
//    (one buffer, ~88 KB at N=197, two CTAs per SM). The map leaves the
//    chip once, in its storage dtype.
//  * The threshold is a radix select over the cluster (2 passes of 8-bit
//    digits on the 16-bit keys, 4 on the fp32 keys): each CTA histograms
//    its band in shared memory, one warp per CTA sums the cluster's
//    histograms through distributed shared memory, one cluster barrier a
//    pass; each CTA then sums its own band's rows.
// The summation order of the tensor-core dots differs from a sequential
// fp32 sum, so a logit rounded to bf16 can move by one ulp against the
// plain version, which moves that logit's row of the map: the map is held
// to it within one bf16 ulp of its largest entry, with at most 1e-4 of
// its entries (or one row) differing, not bit for bit.
//
// Tokens: N <= 640. Up to 256 the kernel above keeps a head's K (then V)
// for every key in shared memory and a row's logits in registers. From 257
// on (block_stats_long_kernel) neither fits: at N=577, H=12 (DeiT-B/16 at
// 384) a band's fp32 accumulator is ~200 KB and a row's 37 key tiles
// would take 296 accumulator registers. The long kernel keeps the band
// (16 x ceil(tiles / cluster) rows, the columns rounded up to 16) and
// streams K and V through one buffer of 128 keys (64 where that pads less
// or the buffer does not fit). Two warps take each 16-row tile, each one
// half of every chunk's keys, and make three passes over the keys of a
// head, recomputing their tile of S = Q K^T from the chunk each time (the
// tensor cores have the operations to spare): the row maximum, then the
// sum of the bf16 exponentials, then the probabilities, the head mean and
// P V; the halves' maxima and sums meet in shared memory, and their P V
// at the end of the head. Each value is rounded where the kernel above
// rounds it (the row maximum from the largest dot, the rounding being
// monotonic); a row sum adds each half's values in column order, then the
// two halves (on chunks of 64 keys one warp takes a tile, in column
// order). The cluster is the portable 8 CTAs from 449 tokens on (5 at
// 257), each of up to 5 tiles: 223,376 bytes of shared memory at 577, one
// CTA an SM. Bound at B=160, N=577, H=12: bytes, 674 MB (speed) / 780 MB
// (exact) = 0.201 / 0.233 ms, against 164 GFLOP that the tensor cores do
// in 0.17 ms; the three passes make that 0.42 ms of products. What holds
// it far above the bound is the instruction rate: the bf16 roundings,
// exponentials and accumulator updates of every probability over three
// passes, on one CTA an SM. chip_smoke.py read it at 577 (an H100 at
// 700 W) as 8.9 ms with one warp a tile and 64-key chunks, 7.9 ms with
// 128-key chunks, 7.7 ms with pass 1 from the raw dots and 5.6 ms (28x)
// with two warps a tile (10 an SM).
#include "common.cuh"

namespace {

constexpr int kTilesPerCta = 4;  // 16-row tiles, one warp each
constexpr int kThreads = 32 * kTilesPerCta;
constexpr int kBandRows = 16 * kTilesPerCta;

struct Layout {
  int np, astride, kstride;
  size_t radix, acc, kv, total;
  __host__ __device__ Layout(int N, int hd) {
    np = 16 * ppf::key_tiles(N);
    astride = np + 8;  // 8 or 24 mod 32: a quad's float2 rows spread over banks
    kstride = ppf::kv_stride(hd);
    radix = 0;  // the radix select's ints
    acc = ppf::align16(radix + ppf::radix_smem_ints() * sizeof(int));
    kv = ppf::align16(acc + (size_t)kBandRows * astride * sizeof(float));
    total = ppf::align16(kv + (size_t)np * kstride * sizeof(__nv_bfloat16));
  }
};

// CTAs per sample: each takes a band of at most kTilesPerCta row tiles
// up to 8 CTAs, and kLongTiles above (from 449 tokens on).
__host__ __device__ inline int cluster_size(int N) {
  const int tiles = (N + 15) / 16;
  const int cs = (tiles + kTilesPerCta - 1) / kTilesPerCta;
  return cs < ppf::kMaxClusterSize ? cs : ppf::kMaxClusterSize;
}

// The long kernel (N >= ppf::kLongMinTokens): 16-row tiles a CTA holds at
// most (ceil(40 / 8) at 640), one or two warps each (long_threads).
constexpr int kLongTiles = 5;

// The long kernel's shared memory: the select's ints (during the heads the
// two warps of a tile exchange their halves of P V there), the band's fp32
// accumulator (its rows by the N columns rounded up to 16, at a stride 8
// or 24 mod 32), one buffer of a chunk of `kt` key tiles, and the halves'
// row maxima or sums of each tile's 16 rows.
struct LongLayout {
  int np, astride, kstride, rows;
  size_t radix, acc, kv, red, total;
  __host__ __device__ LongLayout(int N, int hd, int kt) {
    np = ppf::round_up(N, 16);
    astride = np + 8;
    kstride = ppf::kv_stride(hd);
    const int tiles = (N + 15) / 16;
    const int cs = cluster_size(N);
    rows = 16 * ((tiles + cs - 1) / cs);
    radix = 0;
    acc = ppf::align16(radix + ppf::radix_smem_ints() * sizeof(int));
    kv = ppf::align16(acc + (size_t)rows * astride * sizeof(float));
    red = ppf::align16(kv + (size_t)16 * kt * kstride *
                                sizeof(__nv_bfloat16));
    total = ppf::align16(red + (size_t)2 * kLongTiles * 16 * sizeof(float));
  }
};

// Key tiles a chunk of the long kernel holds: 8 (128 keys) where they pad
// the keys no further than 4 tiles do and the shared memory takes them
// (577 tokens: 223,376 bytes), else 4 (257 tokens, which 8 would pad to
// 384 keys; 229,520 bytes at 640). Each chunk costs a load and two
// barriers: at 577 the larger chunk took K1 from 8.9 to 7.9 ms.
__host__ __device__ inline int long_chunk_tiles(int N, int hd) {
  return ppf::round_up(N, 128) == ppf::round_up(N, 64) &&
                 LongLayout(N, hd, 8).total <= ppf::kMaxSmemPerBlock
             ? 8
             : 4;
}

// Threads of the long kernel's CTA: each warp takes 4 key tiles of a
// chunk, so a tile has two warps on a chunk of 8 (10 warps an SM at 577
// tokens: K1 7.7 -> 5.6 ms) and one on a chunk of 4 (at 257 two CTAs
// share an SM already, and a split chunk of 4 would leave a warp 2 tiles).
inline int long_threads(int N, int hd) {
  return 32 * kLongTiles * (long_chunk_tiles(N, hd) / 4);
}

template <int KT>
__global__ void __launch_bounds__(kThreads)
block_stats_kernel(const __nv_bfloat16* __restrict__ qkv, int N, int C, int H,
                   int keep, bool exact, float scale_bf16, float eps_over_n_bf16,
                   __nv_bfloat16* __restrict__ out, void* __restrict__ map_out,
                   float* __restrict__ t_out, float* __restrict__ s_out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = C / H;
  const int hk = (hd + 15) / 16;
  const int C3 = 3 * C;
  const Layout L(N, hd);
  int* radix = reinterpret_cast<int*>(smem + L.radix);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(smem + L.kv);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  // the cluster spans gridDim.x, so blockIdx.x is the CTA's rank in it;
  // the CTAs share out the ceil(N / 16) row tiles that hold real rows
  const int rank = blockIdx.x;
  const int tiles = (N + 15) / 16;
  const int tile0 = rank * tiles / (int)gridDim.x;
  const int tile1 = (rank + 1) * tiles / (int)gridDim.x;
  const int row0 = 16 * tile0;
  const int band = min(16 * (tile1 - tile0), N - row0);  // real rows
  const bool active = warp < tile1 - tile0;
  const int r0 = row0 + 16 * warp;  // this warp's first row
  const int b = blockIdx.y;
  const __nv_bfloat16* qkv_b = qkv + (size_t)b * N * C3;
  const float rH = 1.0f / (float)H;
  const float neg_inf = __uint_as_float(0xff800000u);

  for (int e = threadIdx.x; e < kBandRows * L.astride / 4; e += blockDim.x)
    reinterpret_cast<float4*>(acc)[e] = make_float4(0.f, 0.f, 0.f, 0.f);
  ppf::zero_radix_smem(radix);

  for (int h = 0; h < H; ++h) {
    __syncthreads();  // the previous head's V no longer read
    ppf::load_head_async(qkv_b, C3, C + h * hd, hd, N, L.np, 16 * hk, kv,
                         L.kstride);
    ppf::cp_async_wait_all();
    __syncthreads();
    uint32_t pa[KT][4];
    if (active) {
      uint32_t qa[4][4];
      ppf::load_q_frags(qa, qkv_b + (size_t)r0 * C3 + h * hd, C3, N - r0, hd);
      float S[2 * KT][4];
      ppf::warp_qk<KT>(S, qa, kv, L.kstride, hk);
      // Element e of an n-tile is row g + 8 (e >> 1), column 8n + 2t +
      // (e & 1); the two columns of a row are rounded to bf16 as one pair.
      // Only the n-tiles of ppf::pad_ntile hold pad columns (>= N).
      // logits: fp32 dot -> bf16, then x bf16(scale) in bf16; pads -inf
      float m[2] = {neg_inf, neg_inf};
#pragma unroll
      for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = S[n][2 * r];
          float& y = S[n][2 * r + 1];
          ppf::round2_bf16(x, y);
          x = __fmul_rn(x, scale_bf16);
          y = __fmul_rn(y, scale_bf16);
          ppf::round2_bf16(x, y);
          if (ppf::pad_ntile<KT>(n, N)) {
            const int col = 8 * n + 2 * t;
            if (col >= N) x = neg_inf;
            if (col + 1 >= N) y = neg_inf;
          }
          m[r] = fmaxf(m[r], fmaxf(x, y));
        }
      m[0] = ppf::quad_max(m[0]);
      m[1] = ppf::quad_max(m[1]);
      // bf16 exp of the bf16 difference (exp(-inf) = 0 at the pads)
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float& x = S[n][2 * r];
          float& y = S[n][2 * r + 1];
          x = __fsub_rn(x, m[r]);
          y = __fsub_rn(y, m[r]);
          ppf::round2_bf16(x, y);
          x = expf(x);
          y = expf(y);
          ppf::round2_bf16(x, y);
          sum[r] = __fadd_rn(__fadd_rn(sum[r], x), y);
        }
      float inv[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        inv[i] = ppf::bf16_round(
            __fdiv_rn(1.0f, __fadd_rn(ppf::quad_sum(sum[i]), 1e-6f)));
      // p = bf16(bf16(e + eps/N) * inv), pads 0; the head mean over this
      // warp's own rows, in head order; the packed pairs are P's fragments
      float* arow = acc + (16 * warp + g) * L.astride + 2 * t;
#pragma unroll
      for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x = __fadd_rn(S[n][2 * r], eps_over_n_bf16);
          float y = __fadd_rn(S[n][2 * r + 1], eps_over_n_bf16);
          ppf::round2_bf16(x, y);
          x = __fmul_rn(x, inv[r]);
          y = __fmul_rn(y, inv[r]);
          uint32_t packed = ppf::round2_bf16(x, y);
          if (ppf::pad_ntile<KT>(n, N)) {
            const int col = 8 * n + 2 * t;
            if (col >= N) x = 0.f;
            if (col + 1 >= N) y = 0.f;
            packed = ppf::pack_bf16(x, y);
          }
          pa[n >> 1][(n & 1) * 2 + r] = packed;
          float2* a = reinterpret_cast<float2*>(arow + 8 * r * L.astride + 8 * n);
          float2 v = *a;
          v.x = __fadd_rn(v.x, __fmul_rn(x, rH));
          v.y = __fadd_rn(v.y, __fmul_rn(y, rH));
          *a = v;
        }
    }
    __syncthreads();  // every warp is done with K
    ppf::load_head_async(qkv_b, C3, 2 * C + h * hd, hd, N, L.np, 16 * hk, kv,
                         L.kstride);
    ppf::cp_async_wait_all();
    __syncthreads();
    if (active) {
      float O[8][4];
      ppf::warp_pv<KT>(O, pa, kv, L.kstride, hk);
      ppf::store_o(out + ((size_t)b * N + r0) * C + h * hd, C, O, N - r0, hd);
    }
  }
  __syncthreads();

  // round once to the storage dtype and write the band's map rows; the
  // select and the row sums read the STORED values
  for (int r = warp; r < band; r += kTilesPerCta) {
    float* arow = acc + r * L.astride;
    const size_t o = ((size_t)b * N + row0 + r) * N;
    for (int c = lane; c < N; c += ppf::kWarp) {
      float v = arow[c];
      if (exact) {
        static_cast<float*>(map_out)[o + c] = v;
      } else {
        const __nv_bfloat16 vb = __float2bfloat16_rn(v);
        static_cast<__nv_bfloat16*>(map_out)[o + c] = vb;
        v = __bfloat162float(vb);
      }
      arow[c] = v;
    }
  }
  __syncthreads();
  const bool prefix16 = !exact;
  const unsigned key = ppf::cluster_radix_select<true>(
      acc, band, N, L.astride, prefix16, keep,
      prefix16 ? (0x3F800000u >> 16) : 0x3F800000u, radix);
  const float thr = ppf::threshold_from_key(static_cast<int>(key), prefix16);
  if (rank == 0 && threadIdx.x == 0) t_out[b] = thr;
  ppf::block_masked_row_sums<true>(acc, band, N, L.astride, thr,
                             s_out + (size_t)b * N + row0);
}


// K1 for N >= ppf::kLongMinTokens (see the header): the band's accumulator
// in shared memory, K and V streamed CT key tiles (long_chunk_tiles) at a
// time, three passes over a head's keys; on chunks of 8 tiles each row
// tile's two warps take the two halves. Launched as block_stats_kernel
// is, in clusters of cluster_size(N) CTAs of long_threads threads.
template <int CT>
__global__ void __launch_bounds__(32 * kLongTiles * (CT / 4), 1)
block_stats_long_kernel(const __nv_bfloat16* __restrict__ qkv, int N, int C,
                        int H, int keep, bool exact, float scale_bf16,
                        float eps_over_n_bf16,
                        __nv_bfloat16* __restrict__ out,
                        void* __restrict__ map_out, float* __restrict__ t_out,
                        float* __restrict__ s_out) {
  constexpr int kSplit = CT / 4;  // warps a row tile
  constexpr int KT = CT / kSplit;  // key tiles of a chunk a warp takes
  constexpr int KC = 16 * CT;      // keys a chunk
  constexpr int kXchgTiles = 3;  // tiles whose P V halves the ints hold
  static_assert(kXchgTiles * 32 * 32 <= ppf::radix_smem_ints(),
                "the select's ints cannot hold the P V exchange");
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = C / H;
  const int hk = (hd + 15) / 16;
  const int C3 = 3 * C;
  const LongLayout L(N, hd, CT);
  int* radix = reinterpret_cast<int*>(smem + L.radix);
  float* xchg = reinterpret_cast<float*>(smem + L.radix);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  __nv_bfloat16* kv = reinterpret_cast<__nv_bfloat16*>(smem + L.kv);
  float* red = reinterpret_cast<float*>(smem + L.red);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int tw = warp % kLongTiles;    // the warp's row tile
  const int half = warp / kLongTiles;  // the half of each chunk it takes
  const int rank = blockIdx.x;
  const int tiles = (N + 15) / 16;
  const int tile0 = rank * tiles / (int)gridDim.x;
  const int tile1 = (rank + 1) * tiles / (int)gridDim.x;
  const int row0 = 16 * tile0;
  const int band = min(16 * (tile1 - tile0), N - row0);  // real rows
  const bool active = tw < tile1 - tile0;
  const int r0 = row0 + 16 * tw;  // this warp's first row
  const int b = blockIdx.y;
  const __nv_bfloat16* qkv_b = qkv + (size_t)b * N * C3;
  const float rH = 1.0f / (float)H;
  const float neg_inf = __uint_as_float(0xff800000u);
  // this warp's keys of a chunk: rows ch .. ch + 16 KT - 1 of the buffer
  const int ch = 16 * KT * half;
  const __nv_bfloat16* ks = kv + ch * L.kstride;
  // the halves' values of this tile's rows g and g + 8
  float* red_mine = red + (half * kLongTiles + tw) * 16;
  const float* red_lo = red + tw * 16;
  const float* red_hi = red + (kLongTiles + tw) * 16;

  for (int e = threadIdx.x; e < L.rows * L.astride / 4; e += blockDim.x)
    reinterpret_cast<float4*>(acc)[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  // keys k0 .. k0 + KC - 1 of the head slice at column `col` into the
  // buffer, rows >= N zeros
  auto load_chunk = [&](int col, int k0) {
    __syncthreads();  // every warp is done with the buffer
    ppf::load_head_async(qkv_b + (size_t)k0 * C3, C3, col, hd, N - k0, KC,
                         16 * hk, kv, L.kstride);
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
  // the warp's half of the chunk's logits as the kernel above rounds them:
  // fp32 dot -> bf16, then x bf16(scale) in bf16; columns >= N -inf.
  // Element e of an n-tile is row g + 8 (e >> 1), column
  // k0 + ch + 8n + 2t + (e & 1).
  uint32_t qa[4][4];
  auto logits = [&](float (&S)[2 * KT][4], int k0) {
    ppf::warp_qk<KT>(S, qa, ks, L.kstride, hk);
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& x = S[n][2 * r];
        float& y = S[n][2 * r + 1];
        ppf::round2_bf16(x, y);
        x = __fmul_rn(x, scale_bf16);
        y = __fmul_rn(y, scale_bf16);
        ppf::round2_bf16(x, y);
        const int col = k0 + ch + 8 * n + 2 * t;
        if (col >= N) x = neg_inf;
        if (col + 1 >= N) y = neg_inf;
      }
  };
  // bf16 exp of the bf16 difference from the row maximum m (0 at -inf)
  auto exps = [&](float (&S)[2 * KT][4], const float (&m)[2]) {
#pragma unroll
    for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float& x = S[n][2 * r];
        float& y = S[n][2 * r + 1];
        x = __fsub_rn(x, m[r]);
        y = __fsub_rn(y, m[r]);
        ppf::round2_bf16(x, y);
        x = expf(x);
        y = expf(y);
        ppf::round2_bf16(x, y);
      }
  };

  for (int h = 0; h < H; ++h) {
    const int kcol = C + h * hd;
    if (active)
      ppf::load_q_frags(qa, qkv_b + (size_t)r0 * C3 + h * hd, C3, N - r0, hd);
    // pass 1: the row maxima of the logits. A logit is the fp32 dot
    // rounded to bf16, times the positive bf16 scale, rounded again: each
    // step is monotonic, so the largest logit is that of the largest dot
    float m[2] = {neg_inf, neg_inf};
    for (int k0 = 0; k0 < N; k0 += KC) {
      load_chunk(kcol, k0);
      if (active) {
        float S[2 * KT][4];
        ppf::warp_qk<KT>(S, qa, ks, L.kstride, hk);
#pragma unroll
        for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (k0 + ch + 8 * n + 2 * t + (e & 1) < N)
              m[e >> 1] = fmaxf(m[e >> 1], S[n][e]);
      }
    }
    m[0] = ppf::quad_max(m[0]);
    m[1] = ppf::quad_max(m[1]);
    if constexpr (kSplit == 2) {
      share(m);
      m[0] = fmaxf(red_lo[g], red_hi[g]);
      m[1] = fmaxf(red_lo[g + 8], red_hi[g + 8]);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
      m[r] = ppf::bf16_round(__fmul_rn(ppf::bf16_round(m[r]), scale_bf16));
    // pass 2: the row sums of the exponentials, each half's in column
    // order, then the first half's plus the second's
    float sum[2] = {0.f, 0.f};
    for (int k0 = 0; k0 < N; k0 += KC) {
      load_chunk(kcol, k0);
      if (active) {
        float S[2 * KT][4];
        logits(S, k0);
        exps(S, m);
#pragma unroll
        for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r)
            sum[r] = __fadd_rn(__fadd_rn(sum[r], S[n][2 * r]),
                               S[n][2 * r + 1]);
      }
    }
    sum[0] = ppf::quad_sum(sum[0]);
    sum[1] = ppf::quad_sum(sum[1]);
    if constexpr (kSplit == 2) {
      share(sum);
      sum[0] = __fadd_rn(red_lo[g], red_hi[g]);
      sum[1] = __fadd_rn(red_lo[g + 8], red_hi[g + 8]);
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r)
      inv[r] = ppf::bf16_round(__fdiv_rn(1.0f, __fadd_rn(sum[r], 1e-6f)));
    // pass 3: p = bf16(bf16(e + eps/N) * inv), pads 0; the head mean over
    // this warp's rows and columns in head order; O += P V over its keys
    float O[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) O[n][e] = 0.f;
    for (int k0 = 0; k0 < N; k0 += KC) {
      load_chunk(kcol, k0);
      uint32_t pa[KT][4];
      if (active) {
        float S[2 * KT][4];
        logits(S, k0);
        exps(S, m);
        float* arow = acc + (16 * tw + g) * L.astride + k0 + ch + 2 * t;
#pragma unroll
        for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float x = __fadd_rn(S[n][2 * r], eps_over_n_bf16);
            float y = __fadd_rn(S[n][2 * r + 1], eps_over_n_bf16);
            ppf::round2_bf16(x, y);
            x = __fmul_rn(x, inv[r]);
            y = __fmul_rn(y, inv[r]);
            uint32_t packed = ppf::round2_bf16(x, y);
            const int col = k0 + ch + 8 * n + 2 * t;
            if (col + 1 >= N) {
              if (col >= N) x = 0.f;
              y = 0.f;
              packed = ppf::pack_bf16(x, y);
            }
            pa[n >> 1][(n & 1) * 2 + r] = packed;
            if (col < L.np) {  // the last chunk may pass the band's columns
              float2* a =
                  reinterpret_cast<float2*>(arow + 8 * r * L.astride + 8 * n);
              float2 v = *a;
              v.x = __fadd_rn(v.x, __fmul_rn(x, rH));
              v.y = __fadd_rn(v.y, __fmul_rn(y, rH));
              *a = v;
            }
          }
      }
      load_chunk(2 * C + h * hd, k0);
      if (active) ppf::warp_pv_add<KT>(O, pa, ks, L.kstride, hk);
    }
    // O = the first half's P V plus the second's, kXchgTiles tiles a round
    // through the select's ints; the first warp of each tile stores it
    for (int base = 0; kSplit == 2 && base < kLongTiles; base += kXchgTiles) {
      const bool mine = active && tw >= base && tw < base + kXchgTiles;
      float* x = xchg + (mine ? tw - base : 0) * 32 * 32 + lane;
      if (mine && half == 1) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) x[(4 * n + e) * 32] = O[n][e];
      }
      __syncthreads();
      if (mine && half == 0) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            O[n][e] = __fadd_rn(O[n][e], x[(4 * n + e) * 32]);
      }
      __syncthreads();
    }
    if (active && half == 0)
      ppf::store_o(out + ((size_t)b * N + r0) * C + h * hd, C, O, N - r0, hd);
  }
  ppf::zero_radix_smem(radix);  // the heads used the ints for P V

  // round once to the storage dtype and write the band's map rows; the
  // select and the row sums read the STORED values
  for (int r = warp; r < band; r += kLongTiles * kSplit) {
    float* arow = acc + r * L.astride;
    const size_t o = ((size_t)b * N + row0 + r) * N;
    for (int c = lane; c < N; c += ppf::kWarp) {
      float v = arow[c];
      if (exact) {
        static_cast<float*>(map_out)[o + c] = v;
      } else {
        const __nv_bfloat16 vb = __float2bfloat16_rn(v);
        static_cast<__nv_bfloat16*>(map_out)[o + c] = vb;
        v = __bfloat162float(vb);
      }
      arow[c] = v;
    }
  }
  __syncthreads();
  const bool prefix16 = !exact;
  const unsigned key = ppf::cluster_radix_select<false>(
      acc, band, N, L.astride, prefix16, keep,
      prefix16 ? (0x3F800000u >> 16) : 0x3F800000u, radix);
  const float thr = ppf::threshold_from_key(static_cast<int>(key), prefix16);
  if (rank == 0 && threadIdx.x == 0) t_out[b] = thr;
  ppf::block_masked_row_sums<false>(acc, band, N, L.astride, thr,
                                    s_out + (size_t)b * N + row0);
}

bool long_tokens(int N) { return N >= ppf::kLongMinTokens; }

size_t smem_bytes(int N, int hd) {
  return long_tokens(N) ? LongLayout(N, hd, long_chunk_tiles(N, hd)).total
                        : Layout(N, hd).total;
}

// Whether the launch at N tokens fits what the kernels take: N <= 640 and
// a band whose counts fit the select's 16-bit counters.
bool takes(int N, int hd) {
  const int rows =
      long_tokens(N) ? LongLayout(N, hd, 4).rows : 16 * kTilesPerCta;
  return N <= ppf::kMaxTokens && ppf::hist_counts_fit(rows, N);
}

// The cluster launch of B samples at N tokens; `attr` must outlive the
// launch call.
cudaLaunchConfig_t cluster_config(int B, int N, int hd, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  return ppf::cluster_launch_config(
      cluster_size(N), B, long_tokens(N) ? long_threads(N, hd) : kThreads,
      smem, stream, attr);
}

// Runs the statements given with `kernel` the block-stats kernel for N
// tokens at head dim hd; returns cudaErrorInvalidValue where no kernel
// takes N.
#define PPF_DISPATCH_BLOCK_STATS(N, hd, ...)                           \
  if (long_tokens(N) && long_chunk_tiles(N, hd) == 8) {                \
    auto kernel = block_stats_long_kernel<8>;                          \
    __VA_ARGS__                                                        \
  } else if (long_tokens(N)) {                                         \
    auto kernel = block_stats_long_kernel<4>;                          \
    __VA_ARGS__                                                        \
  } else {                                                             \
    PPF_DISPATCH_KT(N, {                                               \
      auto kernel = block_stats_kernel<KT>;                            \
      __VA_ARGS__                                                      \
    });                                                                \
  }

}  // namespace

// qkv: (B, N, 3C) bf16; out: (B, N, C) bf16; map: (B, N, N) fp32 (exact)
// or bf16; t: (B,) fp32; s: (B, N) fp32. scale_bf16 / eps_over_n_bf16 are
// hd**-0.5 and 1e-6/N rounded to bf16 by the caller. C / H is a multiple
// of 8 and at most 64; N <= 640. One cluster launch; a refused launch
// returns its cudaError_t.
extern "C" int ppf_attention_block_stats(const void* qkv, int B, int N, int C,
                                         int H, int keep, int exact,
                                         float scale_bf16, float eps_over_n_bf16,
                                         void* out, void* map, void* t, void* s,
                                         void* stream) {
  if (!takes(N, C / H)) return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(N, C / H);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(B, N, C / H, smem, static_cast<cudaStream_t>(stream),
                     attr);
  PPF_DISPATCH_BLOCK_STATS(N, C / H, {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(
        &cfg, kernel, static_cast<const __nv_bfloat16*>(qkv), N, C, H, keep,
        exact != 0, scale_bf16, eps_over_n_bf16,
        static_cast<__nv_bfloat16*>(out), map, static_cast<float*>(t),
        static_cast<float*>(s));
    if (err != cudaSuccess) return err;
  });
  return cudaGetLastError();
}

extern "C" int ppf_attention_block_stats_smem_bytes(int N, int hd) {
  return (int)smem_bytes(N, hd);
}

// CTAs per sample (the cluster size) of the launch at N tokens.
extern "C" int ppf_attention_block_stats_cluster_size(int N) {
  return cluster_size(N);
}

// How many of those clusters the card can hold at once (negative: the
// cudaError_t of the query).
extern "C" int ppf_attention_block_stats_active_clusters(int N, int hd) {
  if (!takes(N, hd)) return -static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(N, hd);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(1, N, hd, smem, nullptr, attr);
  int clusters = 0;
  PPF_DISPATCH_BLOCK_STATS(N, hd, {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return -static_cast<int>(err);
  });
  return clusters;
}
