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
// Tokens: any N. Up to 256 the kernel above keeps a head's K (then V)
// for every key in shared memory and a row's logits in registers. From 257
// on neither fits: at N=577, H=12 (DeiT-B/16 at 384) a band's fp32
// accumulator is ~200 KB and a row's 37 key tiles would take 296
// accumulator registers. There K1 is two launches: block_stats_long_kernel
// (the heads, the head mean, the map stored once) and then K2's cluster
// kernel (map_stats.cu), which selects the threshold of the STORED map,
// capped at bits(1.0) as above, and sums its masked rows: the same select
// and row sums on the same stored values, read back once from L2.
//  * Bound at B=160, N=577, H=12: bytes, 674 MB (speed) / 780 MB (exact)
//    = 0.201 / 0.233 ms, against 164 GFLOP that the tensor cores do in
//    0.17 ms. What holds it above: the instruction rate of the softmax
//    arithmetic (for every probability bf16 roundings, an expf and the
//    head-mean update), one CTA an SM, and the K and V chunks that every
//    CTA of a sample streams from L2.
//  * The heads kernel takes 3 row tiles (48 rows) a CTA, no cluster (13
//    CTAs a sample at 577), 4 warps a tile: one CTA an SM (212 KB of
//    shared memory at 577, 224 KB at 640), 12 warps. The band's fp32
//    accumulator and its bf16 logits stay in shared memory.
//  * Pass 1 computes each logit once (mma.sync, each warp 2 key tiles of a
//    128-key chunk), rounds it as the kernel above does and stores it in
//    bf16; the row maxima come from the raw dots. Passes 2 and 3 read the
//    stored logits, not K: each warp its 4 rows side by side, each row
//    held in registers as bf16 pairs from its load to its store (e and the
//    row sum, then p and the head mean). Pass 4 multiplies the stored P by
//    V, each warp 16 columns of the head dim, so no two warps' sums meet.
//    Where three passes recomputed QK^T from K (eight loads of a head's
//    K and V chunks), one pass reads K and one reads V.
//  * K and V stream through a ring of 2 chunk buffers filled by cp.async
//    one chunk ahead (one barrier a chunk); a thread's copies step by the
//    block's threads from offsets computed once (ppf::copy_steps).
//  * Above 640 columns the band's fp32 accumulator and its rows no longer
//    fit one CTA beside each other (at 785 tokens the accumulator alone is
//    155 KB). There a thread block cluster of H CTAs takes each band, CTA
//    h its head h (block_stats_split_kernel, the head split; up to 16
//    heads): each holds its head's bf16 logits, then probabilities, for
//    the band's whole rows in shared memory (3 row tiles a CTA where two
//    CTAs fit an SM, to ~800 tokens; then 2, two CTAs an SM to ~1,200
//    tokens; 1 tile from ~3,000 to ~6,000), passes 2 and 3 loop over a
//    row's steps, each writing its values back in place, and it writes
//    its head's out. A row's softmax lies in one CTA,
//    so no row statistic crosses the cluster and every value is the
//    kernel above's. After one cluster barrier each CTA adds the head
//    mean of its share of the band's rows, acc = acc + p * (1/H) in head
//    order from 0, reading the heads' probabilities through distributed
//    shared memory, and stores it once: the map the kernel above stores,
//    bit for bit. Every row maximum is final before any exp (no online
//    rescaling, which would move entries by an ulp that the threshold
//    magnifies). A key split (a cluster sharing each band's keys, as
//    attention_mean.cu's fp32 split route does) was measured first and
//    lost at 785 tokens: three cluster barriers a head with one CTA an SM
//    (PERF.md). Above 16 heads the band's accumulator lies in a scratch
//    buffer in global memory (3 row tiles a CTA up to ~2,000 tokens, 1
//    above), as before the head split. Measured (cli.time_long_kernels
//    --against parent, an H100 at 700 W, B=160, H=3, the model's own
//    qkv; PERF.md), the heads kernel (K1 less its select): 1.94 -> 1.24
//    ms (speed) at 785 tokens, 3.67 -> 2.42 ms at 1,025; 79 clusters of 3
//    resident, two CTAs an SM.
// A row sum adds each lane's values in column order, then the warp's
// lanes; P V sums its 16-key products in key order. Measured
// (cli.time_long_kernels --against parent, an H100 at 700 W, B=160, the
// model's own qkv; PERF.md): 5.62 -> 3.25 ms (speed) and 5.83 -> 3.47 ms
// (exact) at 577, 0.511 -> 0.333 / 0.573 -> 0.382 ms at 257.
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

// CTAs per sample of the kernel above: each takes a band of at most
// kTilesPerCta row tiles (N <= 256: at most 4 CTAs).
__host__ __device__ inline int cluster_size(int N) {
  const int tiles = (N + 15) / 16;
  const int cs = (tiles + kTilesPerCta - 1) / kTilesPerCta;
  return cs < ppf::kMaxClusterSize ? cs : ppf::kMaxClusterSize;
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
  const unsigned key = ppf::cluster_radix_select(
      acc, band, N, L.astride, prefix16, keep,
      prefix16 ? (0x3F800000u >> 16) : 0x3F800000u, radix);
  const float thr = ppf::threshold_from_key(static_cast<int>(key), prefix16);
  if (rank == 0 && threadIdx.x == 0) t_out[b] = thr;
  ppf::block_masked_row_sums<true>(acc, band, N, L.astride, thr,
                             s_out + (size_t)b * N + row0);
}


// --- N >= ppf::kLongMinTokens: two launches -----------------------------------

// block_stats_long_kernel computes a sample's attention, head mean and
// stored map in CTAs of TILES row tiles, one CTA per band, no cluster;
// K2's cluster kernel (map_stats.cu) then selects the stored map's
// threshold, capped at bits(1.0), and sums its masked rows.
constexpr int kLongWarps = 4;  // warps a row tile
constexpr int kLongChunk = 32 * kLongWarps;  // keys a chunk: 2 key tiles a warp
constexpr int kLongStages = 2;  // chunk buffers in the ring
constexpr int kLongRowsPerWarp = 4;  // a tile's 16 rows over its 4 warps
// steps of 128 columns that passes 2 and 3 hold in registers: rows of up
// to 640 columns; longer rows loop over their steps in shared memory (a
// kernel of its own, so that the register route's code stays as it was)
constexpr int kLongRegSteps = 5;

// The long kernel's shared memory at `tiles` row tiles a CTA: the band's
// fp32 accumulator over the columns of the key tiles that hold real keys
// (nk; left out where `acc_smem` is false and the accumulator lies in
// global memory), and its bf16 logits (then exponentials, then
// probabilities) over those of the warps' 32-key blocks that do (pass 1
// writes whole blocks), each at a stride 8 past it (the logits' then 4 or
// 20 mod 32 words: a quad's rows, and ldmatrix's 8, on distinct banks);
// the ring of K or V chunks; each warp's row maxima of its tile.
struct LongLayout {
  int np, nk, astride, lstride, kstride;
  size_t acc, lg, ring, red, total;
  __host__ __device__ LongLayout(int N, int hd, int tiles, bool acc_smem) {
    const int rows = 16 * tiles;
    np = ppf::round_up(N, kLongChunk);
    nk = ppf::round_up(N, 16);
    astride = nk + 8;
    lstride = ppf::round_up(N, 32) + 8;
    kstride = ppf::kv_stride(hd);
    acc = 0;
    lg = ppf::align16(acc + (acc_smem ? (size_t)rows * astride * sizeof(float)
                                      : 0));
    ring = ppf::align16(lg + (size_t)rows * lstride * sizeof(__nv_bfloat16));
    red = ppf::align16(ring + (size_t)kLongStages * kLongChunk * kstride *
                                  sizeof(__nv_bfloat16));
    total = ppf::align16(red + (size_t)tiles * kLongWarps * 16 *
                                   sizeof(float));
  }
};

// The heads kernel's route at N tokens, chosen by what fits a block's
// shared memory: 3 row tiles with the accumulator in shared memory (up to
// ~660 tokens), 3 with it in global memory (up to ~2,000), then 1; rows in
// registers in passes 2 and 3 up to 640 columns.
struct LongRoute {
  int tiles;
  bool acc_smem;
  bool reg_rows;
};

LongRoute long_route(int N, int hd) {
  const bool reg = ppf::round_up(N, 16) <= 128 * kLongRegSteps;
  if (LongLayout(N, hd, 3, true).total <= ppf::kMaxSmemPerBlock)
    return {3, true, reg};
  if (LongLayout(N, hd, 3, false).total <= ppf::kMaxSmemPerBlock)
    return {3, false, reg};
  return {1, false, reg};
}

__device__ __forceinline__ void unpack4_bf16(uint2 v, float (&x)[4]) {
  x[0] = __uint_as_float(v.x << 16);
  x[1] = __uint_as_float(v.x & 0xffff0000u);
  x[2] = __uint_as_float(v.y << 16);
  x[3] = __uint_as_float(v.y & 0xffff0000u);
}

// K1's heads for N >= ppf::kLongMinTokens (see the header): rows
// kLongRows * blockIdx.x on of sample blockIdx.y, in TILES row tiles.
// Pass 1 stores each logit once, passes 2 and 3 run over the stored
// values, and only P V reads the chunks of V. acc_g: null, or the scratch
// whose kLongRows x astride floats from CTA (blockIdx.y, blockIdx.x) on
// hold its accumulator (long_route). kRegRows: passes 2 and 3 hold each
// row in registers (up to 640 columns), else loop over its steps.
template <int TILES, bool kRegRows>
__global__ void __launch_bounds__(32 * kLongWarps * TILES, 1)
block_stats_long_kernel(const __nv_bfloat16* __restrict__ qkv, int N, int C,
                        int H, bool exact, float scale_bf16,
                        float eps_over_n_bf16, __nv_bfloat16* __restrict__ out,
                        void* __restrict__ map_out, float* acc_g) {
  constexpr int kLongRows = 16 * TILES;
  constexpr int kLongThreads = 32 * kLongWarps * TILES;
  extern __shared__ __align__(16) unsigned char smem[];
  const int hd = C / H;
  const int hk = (hd + 15) / 16;
  const int C3 = 3 * C;
  const LongLayout L(N, hd, TILES, acc_g == nullptr);
  float* acc = acc_g ? acc_g + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                                   kLongRows * L.astride
                     : reinterpret_cast<float*>(smem + L.acc);
  __nv_bfloat16* lg = reinterpret_cast<__nv_bfloat16*>(smem + L.lg);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + L.ring);
  float* red = reinterpret_cast<float*>(smem + L.red);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int tw = warp / kLongWarps;  // the warp's row tile
  const int w = warp % kLongWarps;   // its 2 key tiles of a chunk, and its
                                     // 16 columns of the head dim in P V
  const int row0 = kLongRows * blockIdx.x;
  const int rows = min(kLongRows, N - row0);  // real rows of the band
  const int r0 = row0 + 16 * tw;              // the tile's first row
  const bool active = 16 * tw < rows;
  const bool pv = active && w < hk;
  const int b = blockIdx.y;
  const __nv_bfloat16* qkv_b = qkv + (size_t)b * N * C3;
  const float rH = 1.0f / (float)H;
  const float neg_inf = __uint_as_float(0xff800000u);
  const int nc = L.np / kLongChunk;  // chunks of K (and of V) a head
  __nv_bfloat16* ltile = lg + 16 * tw * L.lstride;
  // ldmatrix's row and column of this lane in a 16 x 16 tile
  const int lrow = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int lcol = (lane >> 4) * 8;

  for (int e = threadIdx.x; e < kLongRows * L.astride / 4; e += blockDim.x)
    reinterpret_cast<float4*>(acc)[e] = make_float4(0.f, 0.f, 0.f, 0.f);

  // the stream of chunks: each head's K chunks, then its V chunks, rows
  // >= N zeros. fetch() copies the next one, (ih, ic), into stage ist;
  // arrive() waits for the oldest, in stage cst, publishes it, and refills
  // the stage every warp is done with
  const size_t chunk = (size_t)kLongChunk * L.kstride;
  const ppf::CopySteps cs = ppf::copy_steps<__nv_bfloat16>(16 * hk);
  int ih = 0, ic = 0, ist = 0, cst = 0;
  auto fetch = [&]() {
    if (ih < H) {
      const int k0 = (ic < nc ? ic : ic - nc) * kLongChunk;
      ppf::load_rows_async(qkv_b + (size_t)k0 * C3, C3,
                           (ic < nc ? C : 2 * C) + ih * hd, hd, N - k0,
                           kLongChunk, ring + ist * chunk, L.kstride, cs);
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
    const __nv_bfloat16* buf = ring + cst * chunk;
    cst = cst + 1 == kLongStages ? 0 : cst + 1;
    return buf;
  };

  for (int k = 0; k < kLongStages - 1; ++k) fetch();
  uint32_t qa[4][4];
  if (active) ppf::load_q_frags(qa, qkv_b + (size_t)r0 * C3, C3, N - r0, hd);
  for (int h = 0; h < H; ++h) {
    // pass 1: each warp its 2 key tiles of every chunk. The logits as the
    // kernel above rounds them (fp32 dot -> bf16, then x bf16(scale) in
    // bf16; columns >= N -inf) into the band's bf16 rows, and the row
    // maxima of the raw dots: each rounding is monotonic, so the largest
    // logit is that of the largest dot
    float mx[2] = {neg_inf, neg_inf};
    for (int c = 0; c < nc; ++c) {
      const __nv_bfloat16* kb = arrive();
      if (active) {
        const int k0 = c * kLongChunk + 32 * w;
        if (k0 >= N) continue;  // key tiles of pads only: never read
        float S[4][4];
        ppf::warp_qk<2>(S, qa, kb + 32 * w * L.kstride, L.kstride, hk);
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            float x = S[n][2 * r];
            float y = S[n][2 * r + 1];
            const int col = k0 + 8 * n + 2 * t;
            if (col < N) mx[r] = fmaxf(mx[r], x);
            if (col + 1 < N) mx[r] = fmaxf(mx[r], y);
            ppf::round2_bf16(x, y);
            x = __fmul_rn(x, scale_bf16);
            y = __fmul_rn(y, scale_bf16);
            uint32_t packed = ppf::round2_bf16(x, y);
            if (col + 1 >= N)
              packed = ppf::pack_bf16(col < N ? x : neg_inf, neg_inf);
            *reinterpret_cast<uint32_t*>(ltile + (g + 8 * r) * L.lstride +
                                         col) = packed;
          }
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
    uint32_t qn[4][4];  // the next head's Q, loaded under passes 2-4
    if (active && h + 1 < H)
      ppf::load_q_frags(qn, qkv_b + (size_t)r0 * C3 + (h + 1) * hd, C3,
                        N - r0, hd);
    __syncthreads();  // every logit and row maximum of the band stored
    // passes 2 and 3, each warp its kLongRowsPerWarp rows warp + kNW k side
    // by side (rows past the band's compute on what their buffers hold and
    // are never stored), a lane 4 columns of each 128, held in registers as
    // bf16 pairs from their load to their store: e = bf16 exp of the bf16
    // difference from the row maximum (0 at -inf) and its row sum (each
    // lane's values in column order, then the warp's lanes); p =
    // bf16(bf16(e + eps/N) * inv), pads 0, over the logits in place, and
    // the head mean of the row in head order. The bf16 difference, sum and
    // product are bf16x2 operations (sub_bf16x2): their one rounding of the
    // exact result is the fp32 operation's rounded to bf16, as below
    {
      constexpr int kRW = kLongRowsPerWarp;
      constexpr int kNW = kLongThreads / 32;
      const uint32_t eps2 = ppf::pack_bf16(eps_over_n_bf16, eps_over_n_bf16);
      // the bf16 row maximum of row r's logits, packed twice
      auto row_max2 = [&](int r) {
        const float* rm = red + (r >> 4) * kLongWarps * 16 + (r & 15);
        float m = rm[0];
#pragma unroll
        for (int q = 1; q < kLongWarps; ++q) m = fmaxf(m, rm[16 * q]);
        m = ppf::bf16_round(__fmul_rn(ppf::bf16_round(m), scale_bf16));
        return ppf::pack_bf16(m, m);
      };
      // e's four values of one step (bf16 pairs v): the bf16 exp of the
      // bf16 difference from the maximum, rounded to bf16 in v and added
      // to sum in column order
      auto exp_step = [&](uint2& v, uint32_t m2, float& sum) {
        float x[4];
        unpack4_bf16(make_uint2(ppf::sub_bf16x2(v.x, m2),
                                ppf::sub_bf16x2(v.y, m2)),
                     x);
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = expf(x[j]);
        v.x = ppf::round2_bf16(x[0], x[1]);
        v.y = ppf::round2_bf16(x[2], x[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) sum = __fadd_rn(sum, x[j]);
      };
      // p of one step from e (columns c0 .. c0 + 3, pads 0) stored over the
      // logits at prow, and added to the head mean at arow
      auto prob_step = [&](uint2 e, uint32_t inv2, int c0,
                           __nv_bfloat16* prow, float* arow) {
        uint2 pv;
        pv.x = ppf::mul_bf16x2(ppf::add_bf16x2(e.x, eps2), inv2);
        pv.y = ppf::mul_bf16x2(ppf::add_bf16x2(e.y, eps2), inv2);
        if (c0 + 3 >= N) {  // pads 0
          pv.x &= (c0 < N ? 0xffffu : 0u) | (c0 + 1 < N ? 0xffff0000u : 0u);
          pv.y &= (c0 + 2 < N ? 0xffffu : 0u) |
                  (c0 + 3 < N ? 0xffff0000u : 0u);
        }
        *reinterpret_cast<uint2*>(prow) = pv;
        float x[4];
        unpack4_bf16(pv, x);
        float4 a = *reinterpret_cast<const float4*>(arow);
        a.x = __fadd_rn(a.x, __fmul_rn(x[0], rH));
        a.y = __fadd_rn(a.y, __fmul_rn(x[1], rH));
        a.z = __fadd_rn(a.z, __fmul_rn(x[2], rH));
        a.w = __fadd_rn(a.w, __fmul_rn(x[3], rH));
        *reinterpret_cast<float4*>(arow) = a;
      };
      auto inv2_of = [&](float sum) {
        const float inv = ppf::bf16_round(
            __fdiv_rn(1.0f, __fadd_rn(ppf::warp_sum(sum), 1e-6f)));
        return ppf::pack_bf16(inv, inv);
      };
      if constexpr (kRegRows) {
        constexpr int kSteps = kLongRegSteps;
        uint2 v[kRW][kSteps];
        float sum[kRW];
#pragma unroll
        for (int k = 0; k < kRW; ++k) {
          const int r = warp + kNW * k;
          const __nv_bfloat16* prow = lg + r * L.lstride + 4 * lane;
#pragma unroll
          for (int st = 0; st < kSteps; ++st)
            if (4 * lane + 128 * st < L.nk)
              v[k][st] = *reinterpret_cast<const uint2*>(prow + 128 * st);
        }
#pragma unroll
        for (int k = 0; k < kRW; ++k) {
          const uint32_t m2 = row_max2(warp + kNW * k);
          sum[k] = 0.f;
#pragma unroll
          for (int st = 0; st < kSteps; ++st)
            if (4 * lane + 128 * st < L.nk) exp_step(v[k][st], m2, sum[k]);
        }
#pragma unroll
        for (int k = 0; k < kRW; ++k) {
          const int r = warp + kNW * k;
          const uint32_t inv2 = inv2_of(sum[k]);
          __nv_bfloat16* prow = lg + r * L.lstride + 4 * lane;
          float* arow = acc + r * L.astride + 4 * lane;
#pragma unroll
          for (int st = 0; st < kSteps; ++st) {
            const int c0 = 4 * lane + 128 * st;
            if (c0 < L.nk)
              prob_step(v[k][st], inv2, c0, prow + 128 * st, arow + 128 * st);
          }
        }
      } else {
        // one row at a time: e written back over its logits, then p
        for (int k = 0; k < kRW; ++k) {
          const int r = warp + kNW * k;
          const uint32_t m2 = row_max2(r);
          __nv_bfloat16* prow = lg + r * L.lstride;
          float* arow = acc + r * L.astride;
          float sum = 0.f;
          for (int c0 = 4 * lane; c0 < L.nk; c0 += 128) {
            uint2 v = *reinterpret_cast<const uint2*>(prow + c0);
            exp_step(v, m2, sum);
            *reinterpret_cast<uint2*>(prow + c0) = v;
          }
          const uint32_t inv2 = inv2_of(sum);
          for (int c0 = 4 * lane; c0 < L.nk; c0 += 128)
            prob_step(*reinterpret_cast<const uint2*>(prow + c0), inv2, c0,
                      prow + c0, arow + c0);
        }
      }
    }
    // pass 4: O = P V over the chunks of V, in key order; each warp the
    // head dim's columns 16 w .. 16 w + 15, so no two warps' sums meet
    float O[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) O[n][e] = 0.f;
    for (int c = 0; c < nc; ++c) {
      const __nv_bfloat16* vb = arrive();  // its barrier also publishes P
      if (pv) {
#pragma unroll
        for (int j = 0; j < kLongChunk / 16; ++j) {
          if (c * kLongChunk + 16 * j >= N) break;  // pads only
          uint32_t pa[4], bv[4];
          ppf::ldmatrix_x4(pa, ltile + lrow * L.lstride + c * kLongChunk +
                                   16 * j + lcol);
          ppf::ldmatrix_x4_trans(
              bv, vb + (16 * j + lrow) * L.kstride + 16 * w + lcol);
          ppf::mma_bf16(O[0], pa, bv[0], bv[1]);
          ppf::mma_bf16(O[1], pa, bv[2], bv[3]);
        }
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
            if (row < N - r0)
              *reinterpret_cast<__nv_bfloat162*>(
                  out + ((size_t)b * N + r0 + row) * C + h * hd + col) =
                  __floats2bfloat162_rn(O[n][2 * half], O[n][2 * half + 1]);
          }
        }
      }
    }
    if (active && h + 1 < H) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) qa[kk][e] = qn[kk][e];
    }
  }

  // round each warp's rows of the head mean once to the storage dtype and
  // write them; K2 selects and sums on the stored values
  for (int r = warp; r < rows; r += kLongThreads / 32) {
    const float* arow = acc + r * L.astride;
    const size_t o = ((size_t)b * N + row0 + r) * N;
    for (int c = lane; c < N; c += ppf::kWarp) {
      if (exact)
        static_cast<float*>(map_out)[o + c] = arow[c];
      else
        static_cast<__nv_bfloat16*>(map_out)[o + c] =
            __float2bfloat16_rn(arow[c]);
    }
  }
}

// --- above 640 columns: the head split ----------------------------------------

// A thread block cluster of H CTAs takes each band of rows, CTA h its
// head h (up to kMaxHeadSplit heads). Each CTA holds its head's bf16
// logits, then probabilities, for the band's whole rows in shared memory,
// runs passes 1-4 of the kernel above on them (passes 2 and 3 over a
// row's steps, as above 640 columns), and writes its head's out. No row
// statistic crosses the cluster: a row's softmax lies in one CTA. After
// one cluster barrier the cluster adds the head mean, acc = acc + p *
// (1/H) in head order from 0, reading each head's probabilities through
// distributed shared memory, each CTA a share of the band's rows, and
// stores it once in the storage dtype: the map the kernel above stores.
constexpr int kMaxHeadSplit = ppf::kMaxMapClusterSize;

// An SM's shared memory, 1,024 bytes of it reserved for each block.
constexpr size_t kSmemPerSm = 233472;

// Row tiles a CTA of the head split takes at N tokens: 3 where two such
// CTAs fit an SM (up to ~800 tokens at head dim 64), else 2 (two CTAs an
// SM up to ~1,200 tokens, one above), 1 past what 2 tiles' logits fit
// (~3,000 tokens).
__host__ __device__ inline int split_tiles(int N, int hd) {
  if (2 * (LongLayout(N, hd, 3, false).total + 1024) <= kSmemPerSm) return 3;
  return LongLayout(N, hd, 2, false).total <= ppf::kMaxSmemPerBlock ? 2 : 1;
}

template <int TILES>
__global__ void __launch_bounds__(32 * kLongWarps * TILES, 2)
block_stats_split_kernel(const __nv_bfloat16* __restrict__ qkv, int N, int C,
                         int H, bool exact, float scale_bf16,
                         float eps_over_n_bf16,
                         __nv_bfloat16* __restrict__ out,
                         void* __restrict__ map_out) {
  constexpr int kLongRows = 16 * TILES;
  constexpr int kLongThreads = 32 * kLongWarps * TILES;
  extern __shared__ __align__(16) unsigned char smem[];
  ppf::cg::cluster_group cluster = ppf::cg::this_cluster();
  const int hd = C / H;
  const int hk = (hd + 15) / 16;
  const int C3 = 3 * C;
  const LongLayout L(N, hd, TILES, false);
  __nv_bfloat16* lg = reinterpret_cast<__nv_bfloat16*>(smem + L.lg);
  __nv_bfloat16* ring = reinterpret_cast<__nv_bfloat16*>(smem + L.ring);
  float* red = reinterpret_cast<float*>(smem + L.red);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int tw = warp / kLongWarps;  // the warp's row tile
  const int w = warp % kLongWarps;   // its 2 key tiles of a chunk, and its
                                     // 16 columns of the head dim in P V
  // the cluster's CTAs are consecutive along x, CTA h taking head h
  const int h = static_cast<int>(blockIdx.x) % H;
  const int row0 = kLongRows * (blockIdx.x / H);
  const int rows = min(kLongRows, N - row0);  // real rows of the band
  const int r0 = row0 + 16 * tw;              // the tile's first row
  const bool active = 16 * tw < rows;
  const bool pv = active && w < hk;
  const int b = blockIdx.y;
  const __nv_bfloat16* qkv_b = qkv + (size_t)b * N * C3;
  const float rH = 1.0f / (float)H;
  const float neg_inf = __uint_as_float(0xff800000u);
  const int nc = L.np / kLongChunk;  // chunks of K (and of V)
  __nv_bfloat16* ltile = lg + 16 * tw * L.lstride;
  // ldmatrix's row and column of this lane in a 16 x 16 tile
  const int lrow = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int lcol = (lane >> 4) * 8;

  // the stream of the head's K chunks, then its V chunks (rows >= N
  // zeros), as the kernel above streams each head's
  const size_t chunk = (size_t)kLongChunk * L.kstride;
  const ppf::CopySteps cps = ppf::copy_steps<__nv_bfloat16>(16 * hk);
  int ic = 0, ist = 0, cst = 0;
  auto fetch = [&]() {
    if (ic < 2 * nc) {
      const int k0 = (ic < nc ? ic : ic - nc) * kLongChunk;
      ppf::load_rows_async(qkv_b + (size_t)k0 * C3, C3,
                           (ic < nc ? C : 2 * C) + h * hd, hd, N - k0,
                           kLongChunk, ring + ist * chunk, L.kstride, cps);
    }
    ++ic;
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
  uint32_t qa[4][4];
  if (active)
    ppf::load_q_frags(qa, qkv_b + (size_t)r0 * C3 + h * hd, C3, N - r0, hd);
  // pass 1: the logits, rounded as the kernel above rounds them, into the
  // band's bf16 rows, and the row maxima of the raw dots
  float mx[2] = {neg_inf, neg_inf};
  for (int c = 0; c < nc; ++c) {
    const __nv_bfloat16* kb = arrive();
    if (active) {
      const int k0 = c * kLongChunk + 32 * w;
      if (k0 >= N) continue;  // key tiles of pads only: never read
      float S[4][4];
      ppf::warp_qk<2>(S, qa, kb + 32 * w * L.kstride, L.kstride, hk);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float x = S[n][2 * r];
          float y = S[n][2 * r + 1];
          const int col = k0 + 8 * n + 2 * t;
          if (col < N) mx[r] = fmaxf(mx[r], x);
          if (col + 1 < N) mx[r] = fmaxf(mx[r], y);
          ppf::round2_bf16(x, y);
          x = __fmul_rn(x, scale_bf16);
          y = __fmul_rn(y, scale_bf16);
          uint32_t packed = ppf::round2_bf16(x, y);
          if (col + 1 >= N)
            packed = ppf::pack_bf16(col < N ? x : neg_inf, neg_inf);
          *reinterpret_cast<uint32_t*>(ltile + (g + 8 * r) * L.lstride +
                                       col) = packed;
        }
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
  __syncthreads();  // every logit and row maximum of the band stored
  // passes 2 and 3 as the kernel above runs them above 640 columns, one
  // row at a time over its steps: e = bf16 exp of the bf16 difference
  // from the row maximum written back over the logits with the row sum
  // (each lane's values in column order, then the warp's lanes); then p =
  // bf16(bf16(e + eps/N) * inv), pads 0, back in place
  {
    constexpr int kNW = kLongThreads / 32;
    const uint32_t eps2 = ppf::pack_bf16(eps_over_n_bf16, eps_over_n_bf16);
    for (int k = 0; k < kLongRowsPerWarp; ++k) {
      const int r = warp + kNW * k;
      const float* rm = red + (r >> 4) * kLongWarps * 16 + (r & 15);
      float m = rm[0];
#pragma unroll
      for (int q = 1; q < kLongWarps; ++q) m = fmaxf(m, rm[16 * q]);
      m = ppf::bf16_round(__fmul_rn(ppf::bf16_round(m), scale_bf16));
      const uint32_t m2 = ppf::pack_bf16(m, m);
      __nv_bfloat16* prow = lg + r * L.lstride;
      float sum = 0.f;
      for (int c0 = 4 * lane; c0 < L.nk; c0 += 128) {
        uint2 v = *reinterpret_cast<const uint2*>(prow + c0);
        float x[4];
        unpack4_bf16(make_uint2(ppf::sub_bf16x2(v.x, m2),
                                ppf::sub_bf16x2(v.y, m2)),
                     x);
#pragma unroll
        for (int j = 0; j < 4; ++j) x[j] = expf(x[j]);
        v.x = ppf::round2_bf16(x[0], x[1]);
        v.y = ppf::round2_bf16(x[2], x[3]);
#pragma unroll
        for (int j = 0; j < 4; ++j) sum = __fadd_rn(sum, x[j]);
        *reinterpret_cast<uint2*>(prow + c0) = v;
      }
      const float inv = ppf::bf16_round(
          __fdiv_rn(1.0f, __fadd_rn(ppf::warp_sum(sum), 1e-6f)));
      const uint32_t inv2 = ppf::pack_bf16(inv, inv);
      for (int c0 = 4 * lane; c0 < L.nk; c0 += 128) {
        const uint2 e = *reinterpret_cast<const uint2*>(prow + c0);
        uint2 pv2;
        pv2.x = ppf::mul_bf16x2(ppf::add_bf16x2(e.x, eps2), inv2);
        pv2.y = ppf::mul_bf16x2(ppf::add_bf16x2(e.y, eps2), inv2);
        if (c0 + 3 >= N) {  // pads 0
          pv2.x &= (c0 < N ? 0xffffu : 0u) | (c0 + 1 < N ? 0xffff0000u : 0u);
          pv2.y &= (c0 + 2 < N ? 0xffffu : 0u) |
                   (c0 + 3 < N ? 0xffff0000u : 0u);
        }
        *reinterpret_cast<uint2*>(prow + c0) = pv2;
      }
    }
  }
  // pass 4: O = P V over the chunks of V, in key order; each warp the
  // head dim's columns 16 w .. 16 w + 15
  float O[2][4];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[n][e] = 0.f;
  for (int c = 0; c < nc; ++c) {
    const __nv_bfloat16* vb = arrive();  // its barrier also publishes P
    if (pv) {
#pragma unroll
      for (int j = 0; j < kLongChunk / 16; ++j) {
        if (c * kLongChunk + 16 * j >= N) break;  // pads only
        uint32_t pa[4], bv[4];
        ppf::ldmatrix_x4(pa, ltile + lrow * L.lstride + c * kLongChunk +
                                 16 * j + lcol);
        ppf::ldmatrix_x4_trans(
            bv, vb + (16 * j + lrow) * L.kstride + 16 * w + lcol);
        ppf::mma_bf16(O[0], pa, bv[0], bv[1]);
        ppf::mma_bf16(O[1], pa, bv[2], bv[3]);
      }
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
          if (row < N - r0)
            *reinterpret_cast<__nv_bfloat162*>(
                out + ((size_t)b * N + r0 + row) * C + h * hd + col) =
                __floats2bfloat162_rn(O[n][2 * half], O[n][2 * half + 1]);
        }
      }
    }
  }

  // every head's probabilities of the band in its CTA: the head mean of
  // rows r = h + H k, a warp a row, a lane 4 columns of each 128, added
  // in head order from 0 and stored once in the storage dtype
  cluster.sync();
  for (int r = h + H * warp; r < rows; r += H * (kLongThreads / 32)) {
    const size_t o = ((size_t)b * N + row0 + r) * N;
    for (int c0 = 4 * lane; c0 < N; c0 += 128) {
      float a[4] = {0.f, 0.f, 0.f, 0.f};
      for (int q = 0; q < H; ++q) {
        const __nv_bfloat16* src =
            cluster.map_shared_rank(lg, q) + r * L.lstride + c0;
        float x[4];
        unpack4_bf16(*reinterpret_cast<const uint2*>(src), x);
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = __fadd_rn(a[j], __fmul_rn(x[j], rH));
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (c0 + j < N) {
          if (exact)
            static_cast<float*>(map_out)[o + c0 + j] = a[j];
          else
            static_cast<__nv_bfloat16*>(map_out)[o + c0 + j] =
                __float2bfloat16_rn(a[j]);
        }
      }
    }
  }
  cluster.sync();  // no CTA leaves while another reads its probabilities
}

bool long_tokens(int N) { return N >= ppf::kLongMinTokens; }

// Whether the head split takes N tokens of H heads: rows longer than the
// register route's 640 columns, and at most kMaxHeadSplit heads (above,
// the routes with the band's accumulator in global memory).
bool split_route(int N, int H) {
  return long_tokens(N) &&
         ppf::round_up(N, 16) > kLongChunk * kLongRegSteps &&
         H <= kMaxHeadSplit;
}

size_t smem_bytes(int N, int hd, int H) {
  if (!long_tokens(N)) return Layout(N, hd).total;
  if (split_route(N, H))
    return LongLayout(N, hd, split_tiles(N, hd), false).total;
  const LongRoute rt = long_route(N, hd);
  return LongLayout(N, hd, rt.tiles, rt.acc_smem).total;
}

// The head split's kernel at `tiles` row tiles, and its launch of B
// samples: clusters of H CTAs along x, one a band. `attr` must outlive
// the launch call.
auto split_kernel(int tiles) {
  return tiles == 3   ? block_stats_split_kernel<3>
         : tiles == 2 ? block_stats_split_kernel<2>
                      : block_stats_split_kernel<1>;
}

cudaLaunchConfig_t split_config(int B, int N, int H, int tiles, size_t smem,
                                cudaStream_t stream,
                                cudaLaunchAttribute* attr) {
  const int rows = 16 * tiles;
  return ppf::cluster_launch_config(H, B, 32 * kLongWarps * tiles, smem,
                                    stream, attr, (N + rows - 1) / rows);
}

// The heads kernel of a route, and its threads (one row tile only where
// the rows are longer than the register route's).
auto long_kernel(const LongRoute& rt) {
  return rt.reg_rows ? block_stats_long_kernel<3, true>
         : rt.tiles == 3 ? block_stats_long_kernel<3, false>
                         : block_stats_long_kernel<1, false>;
}

int long_threads(const LongRoute& rt) { return 32 * kLongWarps * rt.tiles; }

// Bytes of the scratch that holds the heads kernel's accumulators where
// they lie in global memory (0 where they fit shared memory, and on the
// head split, which holds none).
size_t scratch_bytes(int B, int N, int hd, int H) {
  if (!long_tokens(N) || split_route(N, H)) return 0;
  const LongRoute rt = long_route(N, hd);
  if (rt.acc_smem) return 0;
  const int rows = 16 * rt.tiles;
  return (size_t)B * ((N + rows - 1) / rows) * rows *
         LongLayout(N, hd, rt.tiles, false).astride * sizeof(float);
}

// The cluster launch of B samples at N <= 256 tokens; `attr` must outlive
// the launch call.
cudaLaunchConfig_t cluster_config(int B, int N, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  return ppf::cluster_launch_config(cluster_size(N), B, kThreads, smem, stream,
                                    attr);
}

}  // namespace

// K2's launch (map_stats.cu) with the key capped at `hi`.
extern "C" int ppf_map_stats_at_most(const void* map, int map_is_bf16, int B,
                                     int N, int keep, int prefix16,
                                     unsigned hi, void* t_out, void* s_out,
                                     void* stream);
extern "C" int ppf_map_stats_active_clusters(int N, int map_is_bf16);

// qkv: (B, N, 3C) bf16; out: (B, N, C) bf16; map: (B, N, N) fp32 (exact)
// or bf16; t: (B,) fp32; s: (B, N) fp32. scale_bf16 / eps_over_n_bf16 are
// hd**-0.5 and 1e-6/N rounded to bf16 by the caller. C / H is a multiple
// of 8 and at most 64; any N whose heads kernel fits a block's shared
// memory (ppf_attention_block_stats_smem_bytes). scratch:
// ppf_attention_block_stats_scratch_bytes of device memory (null where
// that is 0). One cluster launch up to 256 tokens, the heads kernel and
// K2's cluster launch above; a refused launch returns its cudaError_t.
extern "C" int ppf_attention_block_stats(const void* qkv, int B, int N, int C,
                                         int H, int keep, int exact,
                                         float scale_bf16, float eps_over_n_bf16,
                                         void* out, void* map, void* t, void* s,
                                         void* stream, void* scratch) {
  const size_t smem = smem_bytes(N, C / H, H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (split_route(N, H)) {
    const int tiles = split_tiles(N, C / H);
    const auto kernel = split_kernel(tiles);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess) err = ppf::allow_map_clusters(kernel, H);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg =
        split_config(B, N, H, tiles, smem, st, attr);
    err = cudaLaunchKernelEx(&cfg, kernel,
                             static_cast<const __nv_bfloat16*>(qkv), N, C, H,
                             exact != 0, scale_bf16, eps_over_n_bf16,
                             static_cast<__nv_bfloat16*>(out), map);
    if (err != cudaSuccess) return err;
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return ppf_map_stats_at_most(map, !exact, B, N, keep, !exact,
                                 exact ? 0x3F800000u : 0x3F80u, t, s, stream);
  }
  if (long_tokens(N)) {
    const LongRoute rt = long_route(N, C / H);
    if (!rt.acc_smem && scratch == nullptr) return cudaErrorInvalidValue;
    const auto kernel = long_kernel(rt);
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    const int rows = 16 * rt.tiles;
    const dim3 grid((N + rows - 1) / rows, B);
    kernel<<<grid, long_threads(rt), smem, st>>>(
        static_cast<const __nv_bfloat16*>(qkv), N, C, H, exact != 0,
        scale_bf16, eps_over_n_bf16, static_cast<__nv_bfloat16*>(out), map,
        rt.acc_smem ? nullptr : static_cast<float*>(scratch));
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    // the key of 1.0: its fp32 pattern, or that pattern's high 16 bits
    return ppf_map_stats_at_most(map, !exact, B, N, keep, !exact,
                                 exact ? 0x3F800000u : 0x3F80u, t, s, stream);
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(B, N, smem, st, attr);
  PPF_DISPATCH_KT(N, {
    const auto kernel = block_stats_kernel<KT>;
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

// Shared memory of the kernel that runs the heads at N tokens of H heads.
extern "C" int ppf_attention_block_stats_smem_bytes(int N, int hd, int H) {
  return (int)smem_bytes(N, hd, H);
}

// Device memory the launch at B samples of N tokens of H heads needs for
// its scratch (the heads kernel's accumulators where they leave shared
// memory).
extern "C" long long ppf_attention_block_stats_scratch_bytes(int B, int N,
                                                             int hd, int H) {
  return (long long)scratch_bytes(B, N, hd, H);
}

// CTAs per sample of the select's cluster launch at N tokens (K1's own up
// to 256, K2's above).
extern "C" int ppf_attention_block_stats_cluster_size(int N) {
  return long_tokens(N) ? ppf::map_cluster_size(N) : cluster_size(N);
}

// How many of those clusters the card can hold at once (negative: the
// cudaError_t of the query).
extern "C" int ppf_attention_block_stats_active_clusters(int N, int hd) {
  if (long_tokens(N)) return ppf_map_stats_active_clusters(N, 0);
  const size_t smem = Layout(N, hd).total;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(1, N, smem, nullptr, attr);
  int clusters = 0;
  PPF_DISPATCH_KT(N, {
    const auto kernel = block_stats_kernel<KT>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return -static_cast<int>(err);
  });
  return clusters;
}

// CTAs of the heads kernel an SM holds at once above 256 tokens (negative:
// the cudaError_t of the query; 0 up to 256, where the cluster query
// above applies).
extern "C" int ppf_attention_block_stats_long_resident_ctas(int N, int hd,
                                                            int H) {
  if (!long_tokens(N)) return 0;
  const size_t smem = smem_bytes(N, hd, H);
  int ctas = 0;
  auto query = [&](auto kernel, int threads) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, kernel,
                                                          threads, smem);
    return err == cudaSuccess ? ctas : -static_cast<int>(err);
  };
  if (split_route(N, H)) {
    const int tiles = split_tiles(N, hd);
    return query(split_kernel(tiles), 32 * kLongWarps * tiles);
  }
  const LongRoute rt = long_route(N, hd);
  return query(long_kernel(rt), long_threads(rt));
}

// CTAs of the heads kernel's cluster a band at N tokens of H heads: H on
// the head split (past 640 tokens), 1 where one CTA takes a band's heads
// (up to 640 tokens; and up to 256, where the kernel above runs), 0 past
// 640 above kMaxHeadSplit heads.
extern "C" int ppf_attention_block_stats_heads_cluster_size(int N, int hd,
                                                            int H) {
  if (split_route(N, H)) return H;
  if (!long_tokens(N)) return 1;
  return long_route(N, hd).acc_smem ? 1 : 0;
}

// How many of those clusters the card holds at once (0 off the head
// split; negative: the cudaError_t of the query).
extern "C" int ppf_attention_block_stats_heads_active_clusters(int N, int hd,
                                                               int H) {
  if (!split_route(N, H)) return 0;
  const int tiles = split_tiles(N, hd);
  const size_t smem = smem_bytes(N, hd, H);
  const auto kernel = split_kernel(tiles);
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      split_config(1, N, H, tiles, smem, nullptr, attr);
  int clusters = 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) err = ppf::allow_map_clusters(kernel, H);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
  return err == cudaSuccess ? clusters : -static_cast<int>(err);
}
