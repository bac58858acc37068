// Shared device helpers for the port's Hopper kernels (K1-K5).
//
// Rounding: every step the JAX reference rounds is written with explicit
// IEEE intrinsics (__fmul_rn / __fadd_rn / __fdiv_rn), so nvcc's FMA
// contraction cannot merge it with its neighbour.
//
// Tensor-core pieces (K1, and K3 in bf16): a warp computes one 16-row tile
// of S = Q K^T and then of O = P V with mma.sync m16n8k16 (bf16 in, fp32
// accumulate), its operands loaded from shared memory with ldmatrix. The
// fragment of thread (g = lane / 4, t = lane % 4) holds, for an accumulator
// n-tile of 8 columns, rows g and g + 8 at columns 2t and 2t + 1; the same
// registers, packed to bf16, are the A operand of the P V product.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ppf {

namespace cg = cooperative_groups;

constexpr int kWarp = 32;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Sum / maximum over the four threads of a quad (the threads that share an
// mma accumulator row).
__device__ __forceinline__ float quad_sum(float v) {
  v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x / d rounded to nearest, from y = __frcp_rn(d), the correctly rounded
// reciprocal: q = x y, then twice q += (x - q d) y by FMAs. For a normal
// quotient this is div.rn's result (Markstein's theorem; held against
// __fdiv_rn by tests/test_torch_gpu.py), and x = +0 gives +0. It has no
// branch to div.rn's slow path, so the divisions of a row overlap.
__device__ __forceinline__ float div_by_recip(float x, float d, float y) {
  float q = __fmul_rn(x, y);
  q = __fmaf_rn(__fmaf_rn(-q, d, x), y, q);
  return __fmaf_rn(__fmaf_rn(-q, d, x), y, q);
}

__device__ __forceinline__ float threshold_from_key(int lo, bool prefix16) {
  return __int_as_float(prefix16 ? (lo << 16) : lo);
}

// s[i] = sum_j a[i, j] * [a[i, j] >= t] over `rows` resident rows of `cols`
// (<= 256) values at row stride `stride`, one warp per row.
__device__ __forceinline__ void block_masked_row_sums(const float* a, int rows,
                                                      int cols, int stride,
                                                      float t, float* s) {
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < rows; i += nw) {
    float v[8];  // the lane's values of the row, loaded together
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = lane + kWarp * u;
      v[u] = j < cols ? a[i * stride + j] : 0.f;
    }
    float acc = 0.f;
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (lane + kWarp * u < cols) acc += v[u] >= t ? v[u] : 0.f;
    acc = warp_sum(acc);
    if (lane == 0) s[i] = acc;
  }
}

// --- radix select ------------------------------------------------------------

// Run by one warp whose lane l holds in c[u] the count of digit 255 - 8l - u
// (lane 0 the largest digits): the digit d that holds the k-th largest key
// (1-based) and the count of keys in the digits above d, written to sel[0]
// and sel[1].
__device__ __forceinline__ void warp_pick_digit(const int (&c)[8], int k,
                                                int* sel) {
  const int lane = threadIdx.x & 31;
  int sum = 0;
#pragma unroll
  for (int u = 0; u < 8; ++u) sum += c[u];
  int incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  int run = incl - sum;
  if (run < k && k <= incl) {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      if (run + c[u] >= k) {
        sel[0] = 255 - 8 * lane - u;
        sel[1] = run;
        break;
      }
      run += c[u];
    }
  }
}

// The largest cluster a launch here takes: a sample of at most 256 rows
// over CTAs of 64 rows (K1's four 16-row tiles, or kMapBandRows).
constexpr int kMaxClusterSize = 4;

// Copies of the counting histogram, one per lane group of lane % 16.
constexpr int kHistCopies = 16;

// Shared ints the select takes: per pass the CTA's 256 digit counts (4
// passes at most), the picked digit and the count above it (2, padded to
// 4), and the counting scratch of kHistCopies copies of 256 16-bit
// counters, two digits a word.
__host__ __device__ constexpr int radix_smem_ints() {
  return 4 * 256 + 4 + 128 * kHistCopies;
}

// min(hi, keep-th largest key) over the non-negative fp32 values that the
// CTAs of the calling cluster hold in shared memory, each `rows` x `cols`
// (cols <= 256) at row stride `stride`. The key is the fp32 bit pattern, or
// its high 16 bits in prefix16 mode; a value whose sign bit is set (-0.0)
// has key 0, since the JAX kernels bisect signed keys and never count it.
// Digit by digit from the top, 8 bits a pass (2 passes on 16-bit keys, 4 on
// 32-bit ones): each CTA counts its keys that match the digits chosen so
// far by their next digit, and one warp of each CTA sums the cluster's
// counts through distributed shared memory and picks the digit. Every CTA
// returns the same key. This is the value a bisection returns from
// [0, hi], for any keys, since both find the largest v <= hi with
// count(key >= v) >= keep; the keep-th largest key is never above the
// largest, so hi at the top of the key space gives the bisection from
// [0, max] of the JAX kernels.
//
// The keys of a map share their top digits, so one histogram would take
// 32 lanes' atomics on a few counters. Lane l counts into copy l % 16 at
// word (digit / 2) * 16 + l % 16: at most two lanes of a warp share a bank.
// The CTA then sums the copies into its counts for the pass (each thread
// two digits over 8 copies, zeroing what it read) before the cluster
// barrier. `smem` (radix_smem_ints ints, shared, 16-byte aligned) is zeroed
// by the caller before a barrier that precedes the call, which also
// publishes `a`. Called by every thread of every CTA.
__device__ __forceinline__ unsigned cluster_radix_select(
    const float* a, int rows, int cols, int stride, bool prefix16, int keep,
    unsigned hi, int* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nranks = static_cast<int>(cluster.num_blocks());
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  int* sel = smem + 4 * 256;
  unsigned* scratch = reinterpret_cast<unsigned*>(sel + 4);
  unsigned* mine = scratch + (lane & (kHistCopies - 1));
  const int bits = prefix16 ? 16 : 32;
  unsigned prefix = 0;
  int k = keep;
  for (int pass = 0; pass < bits / 8; ++pass) {
    const int shift = bits - 8 * (pass + 1);
    for (int r = threadIdx.x >> 5; r < rows; r += nw) {
      float v[8];  // the row's values of this lane, loaded together
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int c = lane + kWarp * u;
        v[u] = c < cols ? a[r * stride + c] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        unsigned key = __float_as_uint(v[u]);
        key = (key >> 31) ? 0u : key;
        if (prefix16) key >>= 16;
        // every entry adds, 0 where it is not counted: no branch splits
        // the warp
        const bool counted = lane + kWarp * u < cols &&
                             (pass == 0 || (key >> (shift + 8)) == prefix);
        const unsigned digit = (key >> shift) & 255u;
        atomicAdd(mine + (digit >> 1) * kHistCopies,
                  static_cast<unsigned>(counted) << ((digit & 1) << 4));
      }
    }
    __syncthreads();
    // thread t sums digits 2p, 2p + 1 (p = t / 2) over copies 8h .. 8h + 7
    // (h = t % 2), rotated so that a warp's reads fall on 32 banks; its
    // partner t ^ 1 holds the other 8 copies
    int* counts = smem + pass * 256;
    for (int t = threadIdx.x; t < 256; t += blockDim.x) {
      const int p = t >> 1, h = t & 1;
      unsigned lo = 0, hi16 = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        unsigned* w = scratch + p * kHistCopies + 8 * h + ((i + (p >> 1)) & 7);
        const unsigned x = *w;
        *w = 0u;
        lo += x & 0xffffu;
        hi16 += x >> 16;
      }
      lo += __shfl_xor_sync(0xffffffffu, lo, 1);
      hi16 += __shfl_xor_sync(0xffffffffu, hi16, 1);
      counts[t] = static_cast<int>(h ? hi16 : lo);
    }
    cluster.sync();
    if (threadIdx.x < kWarp) {
      // lane l sums digits 248 - 8l .. 255 - 8l of every CTA's counts, all
      // the remote reads in flight at once
      int4 part[kMaxClusterSize][2];
#pragma unroll
      for (int q = 0; q < kMaxClusterSize; ++q) {
        if (q < nranks) {
          const int4* src = reinterpret_cast<const int4*>(
              cluster.map_shared_rank(counts, q) + 248 - 8 * lane);
          part[q][0] = src[0];
          part[q][1] = src[1];
        }
      }
      int c[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // c[u]: digit 255 - 8l - u
#pragma unroll
      for (int q = 0; q < kMaxClusterSize; ++q) {
        if (q < nranks) {
          c[7] += part[q][0].x; c[6] += part[q][0].y;
          c[5] += part[q][0].z; c[4] += part[q][0].w;
          c[3] += part[q][1].x; c[2] += part[q][1].y;
          c[1] += part[q][1].z; c[0] += part[q][1].w;
        }
      }
      warp_pick_digit(c, k, sel);
    }
    __syncthreads();
    prefix = (prefix << 8) | static_cast<unsigned>(sel[0]);
    k -= sel[1];
  }
  cluster.sync();  // no CTA leaves while another still reads its counts
  return min(prefix, hi);
}

// Zeroes the select's shared ints; a barrier must follow before the call.
__device__ __forceinline__ void zero_radix_smem(int* smem) {
  for (int e = threadIdx.x; e < radix_smem_ints() / 4; e += blockDim.x)
    reinterpret_cast<int4*>(smem)[e] = make_int4(0, 0, 0, 0);
}

// Launch configuration of a (cs, B) grid of `threads`-thread CTAs in
// clusters of cs along x: one sample a cluster, blockIdx.x its CTA's rank
// and blockIdx.y the sample. `attr` must outlive the launch call.
inline cudaLaunchConfig_t cluster_launch_config(int cs, int B, int threads,
                                                size_t smem,
                                                cudaStream_t stream,
                                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cs, B, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// --- one sample's map over a cluster (K2, and K4/K5's normalize) -------------

// Rows of the map a CTA holds at most, its threads, and the CTAs an SM
// holds at once: as many as the shared memory of ~50-row bands of 197 fp32
// allows, so that more of B=160's clusters of 4 run in the first round
// (the kernels' __launch_bounds__ cap their registers to fit).
constexpr int kMapBandRows = 64;
constexpr int kMapThreads = 256;
constexpr int kMapCtasPerSm = 4;

// CTAs per sample: 4 at 197 or 256 rows (bands of 49-64 rows), 1 up to 64.
__host__ __device__ inline int map_cluster_size(int rows) {
  return (rows + kMapBandRows - 1) / kMapBandRows;
}

// Where the band starts in shared memory: after the select's ints.
__host__ __device__ inline size_t map_band_offset() {
  return align16(radix_smem_ints() * sizeof(int));
}

// Row stride of a band in shared memory for rows of `cols` values at global
// row stride `stride`: the least one >= cols congruent to stride mod 4, so
// that each row lands as its source is aligned (load_band).
__host__ __device__ inline int band_stride(int cols, int stride) {
  return cols + ((stride - cols) & 3);
}

// Shared bytes of one CTA: the band of at most ceil(rows / cluster) rows of
// `cols` values in fp32 (global row stride `stride`), behind up to 3 floats
// that align it with its source (cluster_map_select).
__host__ __device__ inline size_t map_band_smem(int rows, int cols,
                                                int stride) {
  const int cs = map_cluster_size(rows);
  const size_t band = (rows + cs - 1) / cs;
  return map_band_offset() +
         (3 + band * band_stride(cols, stride)) * sizeof(float);
}

__device__ __forceinline__ void widen16(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
}

// bf16 -> fp32 is exact: the bf16 bits become the high half.
__device__ __forceinline__ void widen16(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Copies `rows` rows of `cols` values of T at row stride `stride` from
// global `src` to shared fp32 at row stride `dstride` from `dst`, widened
// exactly. Each row is cut into the 16-byte-aligned chunks of the address
// space it overlaps: whole chunks move as one 16-byte load and 16- or
// 32-byte stores, the partial ones at a row's ends value by value; each
// thread keeps 4 chunks in flight. Contiguous rows (stride == cols ==
// dstride) are one range, so a row that does not start on 16 bytes (197
// fp32 values are 788 bytes) costs nothing. `dst` lies at a float index
// congruent mod 4 to src's element index, and dstride to stride, so that an
// aligned chunk lands on 16 bytes.
template <typename T>
__device__ __forceinline__ void load_band(float* dst, int dstride,
                                          const T* src, int rows, int cols,
                                          int stride) {
  constexpr int V = 16 / sizeof(T);  // values in a chunk
  constexpr int U = 4;               // chunks a thread has in flight
  if (stride == cols) {
    cols *= rows;
    rows = 1;
  }
  // ceil((cols + V - 1) / V) chunks cover a row at any alignment
  const int cpr = (cols + 2 * V - 2) / V;
  const int total = rows * cpr;
  for (int i0 = threadIdx.x; i0 < total; i0 += U * blockDim.x) {
    float v[U][V];
    int r[U], c0[U];  // a chunk's row and first column
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = i0 + u * blockDim.x;
      r[u] = i / cpr;
      const T* row = src + r[u] * stride;
      const int lead = static_cast<int>(
          (reinterpret_cast<uintptr_t>(row) / sizeof(T)) & (V - 1));
      c0[u] = i < total ? (i - r[u] * cpr) * V - lead : cols;
      const T* p = row + c0[u];
      if (c0[u] >= 0 && c0[u] + V <= cols) {
        widen16(p, v[u]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int c = c0[u] + j;
          v[u][j] = c >= 0 && c < cols ? to_float(p[j]) : 0.f;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float* q = dst + r[u] * dstride + c0[u];
      if (c0[u] >= 0 && c0[u] + V <= cols) {
#pragma unroll
        for (int j = 0; j < V; j += 4)
          *reinterpret_cast<float4*>(q + j) =
              make_float4(v[u][j], v[u][j + 1], v[u][j + 2], v[u][j + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int c = c0[u] + j;
          if (c >= 0 && c < cols) q[j] = v[u][j];
        }
      }
    }
  }
}

// A CTA's share of one sample's map: its rows, resident in shared memory.
struct MapBand {
  const float* a;  // the band's first row
  int stride;      // its row stride (band_stride)
  int row0;        // the map row it starts at
  int rows;
};

// The keep-th largest key (cluster_radix_select, hi at the top of the key
// space) of one sample's real `rows` x `cols` map of T at row stride
// `stride` (cols <= 256), split over the calling cluster of
// map_cluster_size(rows) CTAs (blockIdx.x the rank): each CTA loads a band
// of whole rows, rows * rank / cs up to the next, into `smem`
// (map_band_smem bytes) as fp32, pad columns left out, and the cluster
// selects over the bands.
// The rows are whole, so each CTA's epilogue on `band` needs no cluster
// traffic. Called by every thread of every CTA.
template <typename T>
__device__ __forceinline__ unsigned cluster_map_select(
    const T* map, int rows, int cols, int stride, bool prefix16, int keep,
    unsigned char* smem, MapBand& band) {
  const int cs = static_cast<int>(gridDim.x);
  const int rank = static_cast<int>(blockIdx.x);
  band.row0 = rank * rows / cs;
  band.rows = (rank + 1) * rows / cs - band.row0;
  int* radix = reinterpret_cast<int*>(smem);
  const T* src = map + (size_t)band.row0 * stride;
  const int pad = static_cast<int>(
      (reinterpret_cast<uintptr_t>(src) / sizeof(T)) & 3);
  float* a = reinterpret_cast<float*>(smem + map_band_offset()) + pad;
  band.a = a;
  band.stride = band_stride(cols, stride);
  zero_radix_smem(radix);
  load_band(a, band.stride, src, band.rows, cols, stride);
  __syncthreads();  // publishes the band and the zeroed counts
  return cluster_radix_select(a, band.rows, cols, band.stride, prefix16, keep,
                              prefix16 ? 0xFFFFu : 0xFFFFFFFFu, radix);
}

// --- asynchronous copies and tensor-core fragments ---------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Copy one head's (rows_valid, hd) slice at column `col` of the packed
// (N, 3C) qkv rows of one sample into a shared tile of `rows_alloc` rows
// and `width` columns at row stride `stride` (elements), in 16-byte
// chunks: rows >= rows_valid and columns >= hd are zeros. hd * sizeof(T)
// and the row pitch are multiples of 16 bytes. Issues cp.async only; the
// caller waits (cp_async_wait_all) and synchronises.
template <typename T>
__device__ __forceinline__ void load_head_async(const T* qkv_b, int C3,
                                                int col, int hd,
                                                int rows_valid, int rows_alloc,
                                                int width, T* dst,
                                                int stride) {
  constexpr int kVec = 16 / sizeof(T);
  const int cpr = width / kVec;
  for (int idx = threadIdx.x; idx < rows_alloc * cpr; idx += blockDim.x) {
    const int n = idx / cpr;
    const int c = (idx - n * cpr) * kVec;
    const bool ok = n < rows_valid && c < hd;
    const T* src = ok ? qkv_b + (size_t)n * C3 + col + c : qkv_b;
    cp_async16(dst + n * stride + c, src, ok ? 16 : 0);
  }
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x16, row-major) * b (16x8, col-major), bf16 in, fp32 out.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Rounds x and y to bf16 (nearest even) with one conversion of the pair;
// returns the packed pair, x in the low half.
__device__ __forceinline__ uint32_t round2_bf16(float& x, float& y) {
  const uint32_t p = pack_bf16(x, y);
  x = __uint_as_float(p << 16);
  y = __uint_as_float(p & 0xffff0000u);
  return p;
}

// A fragments of a 16-row query tile, straight from global memory: `q`
// points at the tile's first row at its head's column; rows >= rows_valid
// and columns >= hd are zeros.
__device__ __forceinline__ void load_q_frags(uint32_t (&qa)[4][4],
                                             const __nv_bfloat16* q, int C3,
                                             int rows_valid, int hd) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = g + 8 * (r & 1);
      const int col = 16 * kk + 2 * t + 8 * (r >> 1);
      qa[kk][r] = (row < rows_valid && col < hd)
                      ? *reinterpret_cast<const uint32_t*>(q + (size_t)row * C3 + col)
                      : 0u;
    }
  }
}

// S (16 x 16 KT) = Q K^T for one warp's tile; Ks holds 16 KT key rows at
// row stride kstride (kv_stride: 8 mod 16 elements, so ldmatrix's eight
// 16-byte rows fall on distinct banks); hk = padded head dim / 16.
template <int KT>
__device__ __forceinline__ void warp_qk(float (&S)[2 * KT][4],
                                        const uint32_t (&qa)[4][4],
                                        const __nv_bfloat16* Ks, int kstride,
                                        int hk) {
  const int lane = threadIdx.x & 31;
  const int row = (lane & 7) + ((lane >> 4) << 3);
  const int col = ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int n = 0; n < 2 * KT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (kk < hk) {
#pragma unroll
      for (int j = 0; j < KT; ++j) {
        uint32_t b[4];
        ldmatrix_x4(b, Ks + (16 * j + row) * kstride + 16 * kk + col);
        mma_bf16(S[2 * j], qa[kk], b[0], b[1]);
        mma_bf16(S[2 * j + 1], qa[kk], b[2], b[3]);
      }
    }
  }
}

// P's A fragments from the probabilities held in S's accumulator layout,
// each rounded to bf16 (nearest even).
template <int KT>
__device__ __forceinline__ void pack_p(uint32_t (&pa)[KT][4],
                                       const float (&S)[2 * KT][4]) {
#pragma unroll
  for (int j = 0; j < KT; ++j) {
    pa[j][0] = pack_bf16(S[2 * j][0], S[2 * j][1]);
    pa[j][1] = pack_bf16(S[2 * j][2], S[2 * j][3]);
    pa[j][2] = pack_bf16(S[2 * j + 1][0], S[2 * j + 1][1]);
    pa[j][3] = pack_bf16(S[2 * j + 1][2], S[2 * j + 1][3]);
  }
}

// O (16 x 16 hk) = P V, fp32 accumulation; Vs holds 16 KT value rows.
template <int KT>
__device__ __forceinline__ void warp_pv(float (&O)[8][4],
                                        const uint32_t (&pa)[KT][4],
                                        const __nv_bfloat16* Vs, int vstride,
                                        int hk) {
  const int lane = threadIdx.x & 31;
  const int row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int col = (lane >> 4) * 8;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[n][e] = 0.f;
#pragma unroll
  for (int j = 0; j < KT; ++j) {
#pragma unroll
    for (int dn = 0; dn < 4; ++dn) {
      if (dn < hk) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, Vs + (16 * j + row) * vstride + 16 * dn + col);
        mma_bf16(O[2 * dn], pa[j], b[0], b[1]);
        mma_bf16(O[2 * dn + 1], pa[j], b[2], b[3]);
      }
    }
  }
}

// Store O rounded to bf16: `out` points at the tile's first row at its
// head's column (row pitch C); rows >= rows_valid and columns >= hd skipped.
__device__ __forceinline__ void store_o(__nv_bfloat16* out, int C,
                                        const float (&O)[8][4], int rows_valid,
                                        int hd) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = 8 * n + 2 * t;
    if (col < hd) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = g + 8 * half;
        if (row < rows_valid)
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * C + col) =
              __floats2bfloat162_rn(O[n][2 * half], O[n][2 * half + 1]);
      }
    }
  }
}

// Row stride (elements) of a bf16 K or V tile with hd columns: hd padded
// to 16, plus 8 so that ldmatrix's 8 rows fall on distinct banks.
__host__ __device__ inline int kv_stride(int hd) { return (hd + 15) / 16 * 16 + 8; }

}  // namespace ppf

// Runs the statements given for MAXT = ceil(N / 32) in 1..8 (N <= 256).
#define PPF_DISPATCH_MAXT(N, ...)                               \
  switch (((N) + 31) / 32) {                                    \
    case 1: { constexpr int MAXT = 1; __VA_ARGS__ } break;      \
    case 2: { constexpr int MAXT = 2; __VA_ARGS__ } break;      \
    case 3: { constexpr int MAXT = 3; __VA_ARGS__ } break;      \
    case 4: { constexpr int MAXT = 4; __VA_ARGS__ } break;      \
    case 5: { constexpr int MAXT = 5; __VA_ARGS__ } break;      \
    case 6: { constexpr int MAXT = 6; __VA_ARGS__ } break;      \
    case 7: { constexpr int MAXT = 7; __VA_ARGS__ } break;      \
    case 8: { constexpr int MAXT = 8; __VA_ARGS__ } break;      \
    default: return cudaErrorInvalidValue;                      \
  }

namespace ppf {

// Key tiles of 16 a tensor-core kernel is instantiated for at N tokens:
// ceil(N / 16) rounded up to the next of 2, 4, 6, 8, 10, 13, 16 (N = 197
// takes 13, 82 takes 6, 256 takes 16), so that a build compiles 7 of the
// 16 possible tile counts. Tiles past ceil(N / 16) hold zero K and V rows
// and pad columns only. Above 256 tokens: 0, which no kernel takes.
__host__ __device__ inline int key_tiles(int N) {
  const int t = (N + 15) / 16;
  if (t <= 8) return t <= 2 ? 2 : (t + 1) / 2 * 2;
  return t <= 10 ? 10 : t <= 13 ? 13 : t <= 16 ? 16 : 0;
}

// Whether n-tile n (8 key columns) of a KT-tile row holds pad columns
// (>= N). KT exceeds ceil(N / 16) by at most 2, so only the last 6
// n-tiles can: in an unrolled loop over n the test of every other n-tile
// folds away at compile time.
template <int KT>
__device__ __forceinline__ bool pad_ntile(int n, int N) {
  return n >= 2 * KT - 6 && 8 * (n + 1) > N;
}

}  // namespace ppf

// Runs the statements given for KT = ppf::key_tiles(N) (N <= 256).
#define PPF_DISPATCH_KT(N, ...)                                 \
  switch (ppf::key_tiles(N)) {                                  \
    case 2: { constexpr int KT = 2; __VA_ARGS__ } break;        \
    case 4: { constexpr int KT = 4; __VA_ARGS__ } break;        \
    case 6: { constexpr int KT = 6; __VA_ARGS__ } break;        \
    case 8: { constexpr int KT = 8; __VA_ARGS__ } break;        \
    case 10: { constexpr int KT = 10; __VA_ARGS__ } break;      \
    case 13: { constexpr int KT = 13; __VA_ARGS__ } break;      \
    case 16: { constexpr int KT = 16; __VA_ARGS__ } break;      \
    default: return cudaErrorInvalidValue;                      \
  }
