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

// CTAs per sample, each taking a band of at most kTilesPerCta row tiles.
int cluster_size(int N) {
  const int tiles = (N + 15) / 16;
  return (tiles + kTilesPerCta - 1) / kTilesPerCta;
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
  ppf::block_masked_row_sums(acc, band, N, L.astride, thr,
                             s_out + (size_t)b * N + row0);
}

// The cluster launch of B samples at N tokens; `attr` must outlive the
// launch call.
cudaLaunchConfig_t cluster_config(int B, int N, size_t smem,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  return ppf::cluster_launch_config(cluster_size(N), B, kThreads, smem, stream,
                                    attr);
}

}  // namespace

// qkv: (B, N, 3C) bf16; out: (B, N, C) bf16; map: (B, N, N) fp32 (exact)
// or bf16; t: (B,) fp32; s: (B, N) fp32. scale_bf16 / eps_over_n_bf16 are
// hd**-0.5 and 1e-6/N rounded to bf16 by the caller. C / H is a multiple
// of 8 and at most 64; N <= 256. One cluster launch; a refused launch
// returns its cudaError_t.
extern "C" int ppf_attention_block_stats(const void* qkv, int B, int N, int C,
                                         int H, int keep, int exact,
                                         float scale_bf16, float eps_over_n_bf16,
                                         void* out, void* map, void* t, void* s,
                                         void* stream) {
  const size_t smem = Layout(N, C / H).total;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      cluster_config(B, N, smem, static_cast<cudaStream_t>(stream), attr);
  PPF_DISPATCH_KT(N, {
    cudaError_t err = cudaFuncSetAttribute(
        block_stats_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaLaunchKernelEx(
        &cfg, block_stats_kernel<KT>, static_cast<const __nv_bfloat16*>(qkv),
        N, C, H, keep, exact != 0, scale_bf16, eps_over_n_bf16,
        static_cast<__nv_bfloat16*>(out), map, static_cast<float*>(t),
        static_cast<float*>(s));
    if (err != cudaSuccess) return err;
  });
  return cudaGetLastError();
}

extern "C" int ppf_attention_block_stats_smem_bytes(int N, int hd) {
  return (int)Layout(N, hd).total;
}

// CTAs per sample (the cluster size) of the launch at N tokens.
extern "C" int ppf_attention_block_stats_cluster_size(int N) {
  return cluster_size(N);
}

// How many of those clusters the card can hold at once (negative: the
// cudaError_t of the query).
extern "C" int ppf_attention_block_stats_active_clusters(int N, int hd) {
  const size_t smem = Layout(N, hd).total;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(1, N, smem, nullptr, attr);
  int clusters = 0;
  PPF_DISPATCH_KT(N, {
    cudaError_t err = cudaFuncSetAttribute(
        block_stats_kernel<KT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveClusters(&clusters, block_stats_kernel<KT>,
                                           &cfg);
    if (err != cudaSuccess) return -static_cast<int>(err);
  });
  return clusters;
}
