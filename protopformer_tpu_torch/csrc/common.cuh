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

#include <type_traits>

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

// The threshold of a selected key: the inverse of select_key<kSigned> on
// the selected value. kSigned: the key's top bit marks a non-negative
// value, whose pattern is the key without it; otherwise the pattern is
// the key inverted (a 16-bit key in prefix16 mode, inverted in 16 bits).
template <bool kSigned = false>
__device__ __forceinline__ float threshold_from_key(int lo, bool prefix16) {
  if constexpr (kSigned) {
    const unsigned top = prefix16 ? 0x8000u : 0x80000000u;
    unsigned key = static_cast<unsigned>(lo);
    key = (key & top) ? key & ~top : ~key & (top | (top - 1u));
    return __uint_as_float(prefix16 ? key << 16 : key);
  }
  return __int_as_float(prefix16 ? (lo << 16) : lo);
}

// Shared memory one block may use on Hopper (sm_90), bytes. No token
// count is fixed: each kernel picks a route by what its operands need of
// this (the map select's map_route, the long attention kernels' routes).
constexpr size_t kMaxSmemPerBlock = 232448;

// Columns a warp reads in one step of a row: 8 a lane.
constexpr int kRowStep = 8 * kWarp;

// s[i] = sum_j a[i, j] * [a[i, j] >= t] over `rows` rows of `cols` values
// of A (fp32 in shared memory, or the map's own dtype in global memory on
// the select's global route) at row stride `stride`, one warp per row,
// the row in steps of kRowStep columns. kOneStep: cols <= kRowStep, one
// unrolled step a row (the kernels' code up to 256 tokens).
template <bool kOneStep, typename A>
__device__ __forceinline__ void block_masked_row_sums(const A* a, int rows,
                                                      int cols, int stride,
                                                      float t, float* s) {
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  // adds the masked values of row i's step from column c0 to acc
  auto step = [&](int i, int c0, float& acc) {
    float v[8];  // the lane's values of the step, loaded together
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = c0 + lane + kWarp * u;
      v[u] = j < cols ? to_float(a[i * stride + j]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (c0 + lane + kWarp * u < cols) acc += v[u] >= t ? v[u] : 0.f;
  };
  for (int i = threadIdx.x >> 5; i < rows; i += nw) {
    float acc = 0.f;
    if (kOneStep) {
      step(i, 0, acc);
    } else {
      for (int c0 = 0; c0 < cols; c0 += kRowStep) step(i, c0, acc);
    }
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

// The largest portable cluster (K1's own launch up to 256 tokens; the map
// select up to 512 rows): a sample of up to 256 rows over CTAs of 64 rows
// (K1's four 16-row tiles, or kMapBandRows) takes 1-4 CTAs, of up to 512
// rows 5-8.
constexpr int kMaxClusterSize = 8;

// The map select's cluster above 512 rows: 16 CTAs, a non-portable size
// that Hopper takes (cudaFuncAttributeNonPortableClusterSizeAllowed), so
// that a band holds at most 40 rows (37 at 577: ~86 KB of fp32, two CTAs
// an SM).
constexpr int kMaxMapClusterSize = 16;

// Copies of the counting histogram, one per lane group of lane % 16.
constexpr int kHistCopies = 16;

// The most counts one copy of the histogram takes in a pass over a band of
// `rows` rows of `cols` columns: lanes l and l + 16 of each warp count into
// copy l % 16, two of the row's ceil(cols / 32) values a lane each. At the
// largest band, 64 rows of 512, that is 2,048: far from the 65,535 that a
// 16-bit counter holds before it carries into its neighbour (the count
// that the load makes, by 16-byte chunks, is at most the band's 32,768
// values). A band held in shared memory as fp32 (at most 58,112 values)
// stays below ~3,700; the select's global route, whose band has no such
// bound, counts into 32-bit copies instead (count_key<true>). Each
// launcher checks a band of the shared-memory routes (hist_counts_fit).
__host__ __device__ constexpr int hist_copy_counts(int rows, int cols) {
  return rows * 2 * ((cols + kWarp - 1) / kWarp);
}

__host__ __device__ constexpr bool hist_counts_fit(int rows, int cols) {
  return hist_copy_counts(rows, cols) <= 0xFFFF;
}

static_assert(hist_counts_fit(512 / kMaxClusterSize, 512),
              "a band of the largest map overflows the 16-bit counters");

// Shared ints the select takes: per pass the CTA's 256 digit counts (4
// passes at most; above 256 columns the cluster's), the picked digit and
// the count above it (sel[0] and sel[1], padded to 4), and the counting
// scratch of kHistCopies copies of 256 16-bit counters, two digits a word
// (`wide`: of 256 32-bit counters, one digit a word; the global route).
__host__ __device__ constexpr int radix_smem_ints(bool wide = false) {
  return 4 * 256 + 4 + (wide ? 256 : 128) * kHistCopies;
}

// The select's key of a value: the fp32 bit pattern, or its high 16 bits
// in prefix16 mode; a value whose sign bit is set (-0.0) has key 0, since
// the JAX kernels bisect signed keys and never count it. kSigned (mixed-
// sign maps, CaiT's): the unsigned monotone key, whose order is the
// order of every finite value: a non-negative pattern u gains the top
// bit, a negative one is inverted, so -0.0 ranks just below +0.0. Of a
// bf16 value (its pattern the fp32 one's top half) the top 16 bits are
// the 16-bit key of its own pattern.
template <bool kSigned = false>
__device__ __forceinline__ unsigned select_key(float v, bool prefix16) {
  unsigned key = __float_as_uint(v);
  if constexpr (kSigned)
    key = (key >> 31) ? ~key : key | 0x80000000u;
  else
    key = (key >> 31) ? 0u : key;
  return prefix16 ? key >> 16 : key;
}

// Adds 1 to digit `digit` of the calling lane's histogram copy if
// `counted` (0 otherwise: every lane adds, no branch splits the warp).
__device__ __forceinline__ void count_digit(unsigned* mine, unsigned digit,
                                            bool counted) {
  atomicAdd(mine + (digit >> 1) * kHistCopies,
            static_cast<unsigned>(counted) << ((digit & 1) << 4));
}

// The same in a 32-bit copy (word digit * kHistCopies of the lane's copy):
// no band overflows it.
__device__ __forceinline__ void count_digit_wide(unsigned* mine,
                                                 unsigned digit,
                                                 bool counted) {
  atomicAdd(mine + digit * kHistCopies, static_cast<unsigned>(counted));
}

template <bool kWide>
__device__ __forceinline__ void count_key(unsigned* mine, unsigned digit,
                                          bool counted) {
  if constexpr (kWide)
    count_digit_wide(mine, digit, counted);
  else
    count_digit(mine, digit, counted);
}

// The calling lane's histogram copy in the select's scratch.
__device__ __forceinline__ unsigned* hist_copy(int* smem) {
  return reinterpret_cast<unsigned*>(smem + 4 * 256 + 4) +
         ((threadIdx.x & 31) & (kHistCopies - 1));
}

// Sums the histogram copies into counts[0 .. 255], zeroing the copies:
// thread t sums digits 2p, 2p + 1 (p = t / 2) over copies 8h .. 8h + 7
// (h = t % 2), rotated so that a warp's reads fall on 32 banks; the
// partner t ^ 1 holds the other 8 copies. Every thread calls it after a
// barrier.
__device__ __forceinline__ void sum_hist_copies(unsigned* scratch,
                                                int* counts) {
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
}

// sum_hist_copies for the 32-bit copies: thread t sums digit t over the 16
// copies, rotated by t so that a warp's reads spread over the banks.
__device__ __forceinline__ void sum_hist_copies_wide(unsigned* scratch,
                                                     int* counts) {
  for (int t = threadIdx.x; t < 256; t += blockDim.x) {
    unsigned sum = 0;
#pragma unroll
    for (int i = 0; i < kHistCopies; ++i) {
      unsigned* w = scratch + t * kHistCopies + ((i + t) & (kHistCopies - 1));
      sum += *w;
      *w = 0u;
    }
    counts[t] = static_cast<int>(sum);
  }
}

// Ends a pass of the select of up to 4 CTAs once each has counted its keys
// into the histogram copies: the CTA sums its copies into its counts for
// the pass; after the cluster barrier one warp sums every CTA's counts
// through distributed shared memory and picks the digit that holds the
// k-th largest key (sel[0]) and the count above it (sel[1]).
__device__ __forceinline__ void radix_pass_end(cg::cluster_group& cluster,
                                               int pass, int k, int* smem) {
  const int nranks = static_cast<int>(cluster.num_blocks());
  const int lane = threadIdx.x & 31;
  int* sel = smem + 4 * 256;
  int* counts = smem + pass * 256;
  __syncthreads();
  sum_hist_copies(reinterpret_cast<unsigned*>(sel + 4), counts);
  cluster.sync();
  if (threadIdx.x < kWarp) {
    // lane l sums digits 248 - 8l .. 255 - 8l of every CTA's counts, the
    // remote reads in flight at once
    int c[8] = {0, 0, 0, 0, 0, 0, 0, 0};  // c[u]: digit 255 - 8l - u
    int4 part[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < nranks) {
        const int4* src = reinterpret_cast<const int4*>(
            cluster.map_shared_rank(counts, i) + 248 - 8 * lane);
        part[i][0] = src[0];
        part[i][1] = src[1];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i < nranks) {
        c[7] += part[i][0].x; c[6] += part[i][0].y;
        c[5] += part[i][0].z; c[4] += part[i][0].w;
        c[3] += part[i][1].x; c[2] += part[i][1].y;
        c[1] += part[i][1].z; c[0] += part[i][1].w;
      }
    }
    warp_pick_digit(c, k, sel);
  }
  __syncthreads();
}

// Counts, for the pass whose digit lies at `shift`, the keys of the
// calling warp's rows of a band (a at row stride `stride`, `rows` x `cols`
// of A) that match the digits above it (`prefix`; every key in pass 0), by
// that digit; each warp's rows in steps of kRowStep columns. kWide: into
// the 32-bit copies. kSigned: select_key<true>'s keys.
template <bool kOneStep, bool kWide = false, bool kSigned = false,
          typename A>
__device__ __forceinline__ void count_band(const A* a, int rows,
                                           int cols, int stride,
                                           bool prefix16, int pass, int shift,
                                           unsigned prefix, unsigned* mine) {
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  // counts this lane's values of row r's step from column c0 by digit
  auto count = [&](int r, int c0) {
    float v[8];  // the step's values of this lane, loaded together
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int c = c0 + lane + kWarp * u;
      v[u] = c < cols ? to_float(a[r * stride + c]) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const unsigned key = select_key<kSigned>(v[u], prefix16);
      const bool counted = c0 + lane + kWarp * u < cols &&
                           (pass == 0 || (key >> (shift + 8)) == prefix);
      count_key<kWide>(mine, (key >> shift) & 255u, counted);
    }
  };
  for (int r = threadIdx.x >> 5; r < rows; r += nw) {
    if (kOneStep) {
      count(r, 0);
    } else {
      for (int c0 = 0; c0 < cols; c0 += kRowStep) count(r, c0);
    }
  }
}

// min(hi, keep-th largest key) over the non-negative fp32 values that the
// CTAs of the calling cluster hold in shared memory, each `rows` x `cols`
// (cols <= kRowStep, at most 4 CTAs, hist_counts_fit) at row stride
// `stride`; select_key's keys. Digit by digit from the top, 8 bits a pass
// (2 passes on 16-bit keys, 4 on 32-bit ones): each CTA counts its keys
// that match the digits chosen so far by their next digit, and one warp of
// each CTA sums the cluster's counts through distributed shared memory and
// picks the digit. Every CTA returns the same key. This is the value a
// bisection returns from [0, hi], for any keys, since both find the
// largest v <= hi with count(key >= v) >= keep; the keep-th largest key is
// never above the largest, so hi at the top of the key space gives the
// bisection from [0, max] of the JAX kernels.
//
// The keys of a map share their top digits, so one histogram would take
// 32 lanes' atomics on a few counters. Lane l counts into copy l % 16 at
// word (digit / 2) * 16 + l % 16: at most two lanes of a warp share a bank.
// The CTA then sums the copies into its counts for the pass before the
// cluster barrier (radix_pass_end). `smem` (radix_smem_ints ints, shared,
// 16-byte aligned) is zeroed by the caller before a barrier that precedes
// the call, which also publishes `a`. Called by every thread of every CTA.
// Up to 256 tokens (K1's own launch, K2, K4/K5's normalize); above,
// cluster_map_select's long path. kSigned: select_key<true>'s keys.
template <bool kSigned = false>
__device__ __forceinline__ unsigned cluster_radix_select(
    const float* a, int rows, int cols, int stride, bool prefix16, int keep,
    unsigned hi, int* smem) {
  cg::cluster_group cluster = cg::this_cluster();
  int* sel = smem + 4 * 256;
  unsigned* mine = hist_copy(smem);
  const int bits = prefix16 ? 16 : 32;
  unsigned prefix = 0;
  int k = keep;
  for (int pass = 0; pass < bits / 8; ++pass) {
    const int shift = bits - 8 * (pass + 1);
    count_band<true, false, kSigned>(a, rows, cols, stride, prefix16, pass,
                                     shift, prefix, mine);
    radix_pass_end(cluster, pass, k, smem);
    prefix = (prefix << 8) | static_cast<unsigned>(sel[0]);
    k -= sel[1];
  }
  cluster.sync();  // no CTA leaves while another still reads its counts
  return min(prefix, hi);
}

// The select above 256 columns (cluster_radix_select_long) keeps, after
// the select's ints: kSelectCtl control ints (the CTA's list length, the
// lists' total; padded to 16 bytes), each CTA's compact list of the keys
// that share the top 16 bits chosen (kSelectListCap keys), then the
// cluster's lists copied (select_gather_cap(cols) keys; before they
// arrive, the space holds the CTA's own counts of a pass). The listed keys
// share their top 16 bits, so a list holds the low 16 bits of each. The
// copy takes 7,168 keys above 512 columns and 3,072 below; either way
// three CTAs an SM fit at 257 tokens and two at 577. The models' maps at
// 577 tokens put up to ~4,700 keys there (seeded random weights, K1's
// exact map; chip_smoke.py prints the largest total of each run,
// select_route).
constexpr int kSelectCtl = 4;
constexpr int kSelectListCap = 1024;

__host__ __device__ constexpr int select_gather_cap(int cols) {
  return cols > 512 ? 7168 : 3072;
}

// The route record of the select above 256 columns, one per translation
// unit (K2's launches, K4/K5's normalize): the largest lists' total and
// the largest CTA list a cluster met, and the clusters whose lists
// overflowed, so that they ran the last two passes over their bands.
// Rank 0 of each cluster (one sample) adds to it once a launch.
static __device__ int g_select_route[3];

// Copies the route record of this translation unit into out[0..2], and
// zeroes it where `reset`.
static inline cudaError_t read_select_route(int* out, bool reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, g_select_route, sizeof(int) * 3);
  if (e == cudaSuccess && reset) {
    const int zero[3] = {0, 0, 0};
    e = cudaMemcpyToSymbol(g_select_route, zero, sizeof(zero));
  }
  return e;
}

// The cluster barrier split in two (PTX barrier.cluster): a thread
// arrives once it no longer reads another CTA's shared memory, and waits
// before its CTA may exit, so that work between the two overlaps the
// barrier.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// The digit of the k-th largest key from the CTA's 256 counts of a pass,
// read by one warp (lane l: digits 255 - 8l - u), into sel[0] and sel[1].
__device__ __forceinline__ void warp_pick_from(const int* counts, int k,
                                               int* sel) {
  const int lane = threadIdx.x & 31;
  const int4 lo = *reinterpret_cast<const int4*>(counts + 248 - 8 * lane);
  const int4 hi = *reinterpret_cast<const int4*>(counts + 252 - 8 * lane);
  const int c[8] = {hi.w, hi.z, hi.y, hi.x, lo.w, lo.z, lo.y, lo.x};
  warp_pick_digit(c, k, sel);
}

// v added to the int at `p` in the shared memory of the cluster's CTA
// `rank` (p an address in the caller's own shared memory), fire and
// forget: a later cluster barrier makes it visible there.
__device__ __forceinline__ void cluster_red_add(int* p, int rank, int v) {
  const uint32_t local = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(local), "r"(rank));
  asm volatile("red.shared::cluster.add.u32 [%0], %1;\n" ::"r"(remote),
               "r"(v) : "memory");
}

// radix_pass_end for up to kMaxMapClusterSize CTAs, with no read of
// another CTA's memory: the CTA sums its histogram copies, then adds each
// non-zero count into the totals of the pass (totals[0 .. 255], zero
// before) of every CTA of the cluster, itself included; after the cluster
// barrier each CTA's totals are the cluster's counts, and one warp picks
// the digit from them. `first`: the call completes the barrier that the
// CTAs arrived at once their totals were zeroed (cluster_map_select), so
// that no count lands before the zeros. kWide: the 32-bit copies.
template <bool kWide>
__device__ __forceinline__ void radix_pass_end_long(
    cg::cluster_group& cluster, int k, int* smem, int* local, int* totals,
    bool first = false) {
  const int nranks = static_cast<int>(cluster.num_blocks());
  int* sel = smem + 4 * 256;
  __syncthreads();
  if constexpr (kWide)
    sum_hist_copies_wide(reinterpret_cast<unsigned*>(sel + 4), local);
  else
    sum_hist_copies(reinterpret_cast<unsigned*>(sel + 4), local);
  __syncthreads();
  if (first) cluster_wait();
  for (int t = threadIdx.x; t < 256; t += blockDim.x) {
    const int c = local[t];
    if (c != 0)
      for (int q = 0; q < nranks; ++q) cluster_red_add(totals + t, q, c);
  }
  cluster.sync();
  if (threadIdx.x < kWarp) warp_pick_from(totals, k, sel);
  __syncthreads();
}

// cluster_radix_select for cluster_map_select above 256 columns (bands of
// up to 64 rows in clusters of up to kMaxMapClusterSize CTAs), with the
// same result. Pass 0's digits were counted as the band arrived
// (load_band<true>), and each cluster pass pushes the CTA's counts into
// every CTA's totals before its barrier, so that none reads another CTA's
// memory after it (radix_pass_end_long). On 32-bit keys, once the top 16
// bits are chosen, each CTA writes its keys that still match them into
// its compact list; after one cluster barrier every CTA copies the
// cluster's lists into its own shared memory and runs the last two passes
// over the copy, with no cluster barrier: every CTA counts the same keys
// and picks the same digits. Where a list or the copy would overflow (a
// flat map, or one of few distinct values), the cluster runs passes 2 and
// 3 over its bands instead. `ctl` (kSelectCtl ints) is zeroed with the
// select's ints. Returns after its arrival on the cluster barrier: the
// caller calls cluster_wait() before its CTA exits. kWide: the band passes
// count into 32-bit copies (the global route, whose band `a` of A lies in
// global memory; the passes over the copied lists keep 16-bit copies,
// which no list of at most select_gather_cap keys overflows). kSigned:
// select_key<true>'s keys.
template <bool kWide, bool kSigned = false, typename A>
__device__ __forceinline__ unsigned cluster_radix_select_long(
    const A* a, int rows, int cols, int stride, bool prefix16, int keep,
    unsigned hi, int* smem, int* ctl, unsigned short* list,
    unsigned short* gathered) {
  cg::cluster_group cluster = cg::this_cluster();
  const int nranks = static_cast<int>(cluster.num_blocks());
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  const int gather_cap = select_gather_cap(cols);
  int* sel = smem + 4 * 256;
  unsigned* mine = hist_copy(smem);
  // the CTA's own counts of a pass, in the space of the copied lists
  // (free until the last passes); the cluster's in counts[pass]
  int* local = reinterpret_cast<int*>(gathered);
  const int bits = prefix16 ? 16 : 32;
  unsigned prefix = 0;
  int k = keep;
  auto next = [&]() {
    prefix = (prefix << 8) | static_cast<unsigned>(sel[0]);
    k -= sel[1];
  };
  // a pass over the bands, ended over the cluster
  auto band_pass = [&](int pass) {
    if (pass > 0)
      count_band<false, kWide, kSigned>(a, rows, cols, stride, prefix16,
                                        pass, bits - 8 * (pass + 1), prefix,
                                        mine);
    radix_pass_end_long<kWide>(cluster, k, smem, local, smem + pass * 256,
                               pass == 0);
    next();
  };
  band_pass(0);
  band_pass(1);
  if (prefix16) {
    cluster_arrive();
    return min(prefix, hi);
  }
  // the low 16 bits of the CTA's keys whose top 16 bits are `prefix`, in
  // its list; their count in ctl[0]
  for (int r = threadIdx.x >> 5; r < rows; r += nw) {
    for (int c0 = 0; c0 < cols; c0 += kRowStep) {
      float v[8];  // the step's values of this lane, loaded together
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int c = c0 + lane + kWarp * u;
        v[u] = c < cols ? to_float(a[r * stride + c]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const unsigned key = select_key<kSigned>(v[u], false);
        if (c0 + lane + kWarp * u < cols && (key >> 16) == prefix) {
          const int pos = atomicAdd(ctl, 1);
          if (pos < kSelectListCap)
            list[pos] = static_cast<unsigned short>(key);
        }
      }
    }
  }
  __syncthreads();
  cluster.sync();  // every CTA's list written
  // ctl[1]: the lists' total, or -1 where one overflows; offs: where each
  // CTA's list starts in the copy, in pass 3's counts (left zero where
  // the lists overflow, for pass 3 over the bands)
  int* offs = smem + 3 * 256;
  if (threadIdx.x < kWarp) {
    const int n = lane < nranks ? *cluster.map_shared_rank(ctl, lane) : 0;
    int incl = n;
#pragma unroll
    for (int o = 1; o < kWarp; o <<= 1) {
      const int x = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += x;
    }
    const int sum = __shfl_sync(0xffffffffu, incl, kWarp - 1);
    const int most = __reduce_max_sync(0xffffffffu, n);
    const bool over = most > kSelectListCap || sum > gather_cap;
    if (!over && lane <= nranks) offs[lane] = incl - n;
    if (lane == 0) {
      ctl[1] = over ? -1 : sum;
      if (cluster.block_rank() == 0) {
        atomicMax(g_select_route, sum);
        atomicMax(g_select_route + 1, most);
        if (over) atomicAdd(g_select_route + 2, 1);
      }
    }
  }
  __syncthreads();
  const int total = ctl[1];
  if (total < 0) {
    band_pass(2);
    band_pass(3);
    cluster_arrive();
    return min(prefix, hi);
  }
  // copy the lists: warp w those of CTAs w, w + 8, ..., a lane's keys
  // loaded together
  for (int q = threadIdx.x >> 5; q < nranks; q += nw) {
    const unsigned short* src = cluster.map_shared_rank(list, q);
    unsigned short* dst = gathered + offs[q];
    const int n = offs[q + 1] - offs[q];
    for (int i0 = lane; i0 < n; i0 += 8 * kWarp) {
      unsigned short key[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (i0 + kWarp * j < n) key[j] = src[i0 + kWarp * j];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (i0 + kWarp * j < n) dst[i0 + kWarp * j] = key[j];
    }
  }
  cluster_arrive();  // no more reads of another CTA's memory
  __syncthreads();
  const unsigned top = prefix << 16;
  for (int pass = 2; pass < 4; ++pass) {
    const int sh = 32 - 8 * (pass + 1);
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const unsigned key = top | gathered[e];
      count_digit(mine, (key >> sh) & 255u, (key >> (sh + 8)) == prefix);
    }
    __syncthreads();
    int* counts = smem + pass * 256;
    sum_hist_copies(reinterpret_cast<unsigned*>(sel + 4), counts);
    __syncthreads();
    if (threadIdx.x < kWarp) warp_pick_from(counts, k, sel);
    __syncthreads();
    next();
  }
  return min(prefix, hi);
}

// Zeroes the select's shared ints; a barrier must follow before the call.
__device__ __forceinline__ void zero_radix_smem(int* smem, bool wide = false) {
  for (int e = threadIdx.x; e < radix_smem_ints(wide) / 4; e += blockDim.x)
    reinterpret_cast<int4*>(smem)[e] = make_int4(0, 0, 0, 0);
}

// Launch configuration of a (groups * cs, B) grid of `threads`-thread
// CTAs in clusters of cs along x: `groups` clusters a sample (one by
// default, blockIdx.x then the CTA's rank), blockIdx.y the sample. `attr`
// must outlive the launch call.
inline cudaLaunchConfig_t cluster_launch_config(int cs, int B, int threads,
                                                size_t smem,
                                                cudaStream_t stream,
                                                cudaLaunchAttribute* attr,
                                                int groups = 1) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(groups * cs, B, 1);
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

// Rows of the map a CTA holds up to 512 rows, its threads, and the CTAs an
// SM holds at once: as many as the shared memory of ~50-row bands of 197
// fp32 allows, so that more of B=160's clusters of 4 run in the first round
// (the kernels' __launch_bounds__ cap their registers to fit). Above 512
// rows the cluster grows to kMaxMapClusterSize CTAs instead (37 rows of 577
// fp32 are ~86 KB: two CTAs an SM).
constexpr int kMapBandRows = 64;
constexpr int kMapThreads = 256;
constexpr int kMapCtasPerSm = 4;

// The CTAs an SM holds at once above kRowStep columns (bands of 52-64 rows
// up to 512 rows: 3 CTAs of ~75 KB at 257; 2 of ~114 KB at 577): a
// register cap of 85 a thread.
constexpr int kMapCtasPerSmLong = 3;

// The __launch_bounds__ CTA count of a map kernel (kOneStep: up to
// kRowStep columns).
__host__ __device__ constexpr int map_ctas_per_sm(bool one_step) {
  return one_step ? kMapCtasPerSm : kMapCtasPerSmLong;
}

// CTAs per sample: 1 up to 64 rows, 4 at 197 or 256 rows (bands of 49-64
// rows), 5 at 257, 8 from 449 to 512 rows, and kMaxMapClusterSize (16)
// above 512 rows (bands of 33-40 rows).
__host__ __device__ inline int map_cluster_size(int rows) {
  if (rows > kMaxClusterSize * kMapBandRows) return kMaxMapClusterSize;
  return (rows + kMapBandRows - 1) / kMapBandRows;
}

// Rows of the largest band of a map of `rows` rows.
__host__ __device__ inline int map_band_rows(int rows) {
  const int cs = map_cluster_size(rows);
  return (rows + cs - 1) / cs;
}

// Where the band starts in shared memory: after the select's ints and,
// above kRowStep columns, the compact key list (cluster_radix_select_long).
// `wide`: the global route's layout (32-bit histogram copies, no band).
__host__ __device__ inline size_t map_list_offset(bool wide = false) {
  return align16(radix_smem_ints(wide) * sizeof(int));
}

__host__ __device__ inline size_t map_gather_offset(bool wide = false) {
  return map_list_offset(wide) + kSelectCtl * sizeof(int) +
         kSelectListCap * sizeof(unsigned short);
}

__host__ __device__ inline size_t map_band_offset(int cols) {
  return cols > kRowStep ? map_gather_offset() +
                               select_gather_cap(cols) *
                                   sizeof(unsigned short)
                         : map_list_offset();
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
  const size_t band = map_band_rows(rows);
  return map_band_offset(cols) +
         (3 + band * band_stride(cols, stride)) * sizeof(float);
}

// The routes of the map select (cluster_map_select), chosen by shape:
// kMapOneStep up to kRowStep columns; kMapLong up to kMapLongCols, each
// CTA's band in shared memory as fp32; kMapGlobal above: each CTA reads
// its band in place, in the map's own dtype, on every pass (from L2 while
// the map stays there), and counts into 32-bit histogram copies, so no
// band size overflows them. The band in shared memory fits a block up to
// ~850 columns, but there it holds one CTA an SM, 7 clusters of 16 on the
// card, against the in-place route's 42 (35 on a bf16 map): the in-place
// route reads faster from 641 columns on (measured on an H100, PERF.md).
// The cluster, the lists and the select's digits are the long route's,
// so every route returns the same key.
constexpr int kMapOneStep = 0;
constexpr int kMapLong = 1;
constexpr int kMapGlobal = 2;
constexpr int kMapLongCols = 640;

__host__ __device__ inline int map_route(int rows, int cols, int stride) {
  if (cols <= kRowStep) return kMapOneStep;
  return cols <= kMapLongCols ? kMapLong : kMapGlobal;
}

// Shared bytes of one CTA of the select on `route` (map_route's).
__host__ __device__ inline size_t map_route_smem(int route, int rows,
                                                 int cols, int stride) {
  if (route != kMapGlobal) return map_band_smem(rows, cols, stride);
  return map_gather_offset(true) +
         select_gather_cap(cols) * sizeof(unsigned short);
}

// Whether `route` (map_route's, or kMapLong past kMapLongCols) takes a
// map of `rows` x `cols` values at row stride `stride`: the in-place
// route any, the band in shared memory where it fits a block and the
// 16-bit histogram counters hold it (the in-place route counts in 32
// bits).
__host__ __device__ inline bool map_route_takes(int route, int rows,
                                                int cols, int stride) {
  return route == kMapGlobal ||
         (map_band_smem(rows, cols, stride) <= kMaxSmemPerBlock &&
          hist_counts_fit(map_band_rows(rows), cols));
}

// Lets a kernel take clusters of `cs` CTAs where that is above the portable
// 8 (map_cluster_size above 512 rows); called before its launch and its
// occupancy queries.
template <typename K>
inline cudaError_t allow_map_clusters(K kernel, int cs) {
  return cs > kMaxClusterSize
             ? cudaFuncSetAttribute(
                   kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)
             : cudaSuccess;
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
// aligned chunk lands on 16 bytes. kCount: each value is also counted by
// its select key's top digit into the lane's histogram copy `mine` (the
// select's pass 0) between its load and its store, select_key<kSigned>'s.
template <bool kCount, bool kSigned = false, typename T>
__device__ __forceinline__ void load_band(float* dst, int dstride,
                                          const T* src, int rows, int cols,
                                          int stride, bool prefix16,
                                          unsigned* mine) {
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
    if (kCount) {
      const int top = prefix16 ? 8 : 24;
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const int c = c0[u] + j;
          count_digit(mine, select_key<kSigned>(v[u][j], prefix16) >> top,
                      c >= 0 && c < cols);
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

// A CTA's share of one sample's map: its rows, resident in shared memory
// as fp32 (A = float), or in place in global memory (the global route).
template <typename A>
struct MapBand {
  A* a;            // the band's first row
  int stride;      // its row stride (band_stride, or the map's)
  int row0;        // the map row it starts at
  int rows;
};

template <int kRoute, typename T>
using map_band_t =
    MapBand<std::conditional_t<kRoute == kMapGlobal, T, float>>;

// The keep-th largest key, at most `hi` (cluster_radix_select; 0 takes the
// top of the key space), of one sample's real `rows` x `cols` map of T at
// row stride `stride`, split over the calling cluster of
// map_cluster_size(rows) CTAs (blockIdx.x the rank): each CTA takes a band
// of whole rows, rows * rank / cs up to the next, and the cluster selects
// over the bands. On kMapOneStep and kMapLong (map_route) the CTA loads
// its band into `smem` (map_band_smem bytes) as fp32, pad columns left
// out; on kMapGlobal the band is the map's own rows, read in place (`smem`
// map_route_smem bytes). The rows are whole, so each CTA's epilogue on
// `band` needs no cluster traffic. Called by every thread of every CTA.
// kMapOneStep (cols <= kRowStep) runs cluster_radix_select; the others
// cluster_radix_select_long, after which the caller calls cluster_wait()
// before its CTA exits. kSigned: select_key<true>'s keys (mixed-sign maps;
// threshold_from_key<true> maps the key back).
template <int kRoute, bool kSigned = false, typename T>
__device__ __forceinline__ unsigned cluster_map_select(
    const T* map, int rows, int cols, int stride, bool prefix16, int keep,
    unsigned char* smem, map_band_t<kRoute, T>& band, unsigned hi = 0) {
  const int cs = static_cast<int>(gridDim.x);
  const int rank = static_cast<int>(blockIdx.x);
  band.row0 = rank * rows / cs;
  band.rows = (rank + 1) * rows / cs - band.row0;
  int* radix = reinterpret_cast<int*>(smem);
  const T* src = map + (size_t)band.row0 * stride;
  if (hi == 0) hi = prefix16 ? 0xFFFFu : 0xFFFFFFFFu;
  if constexpr (kRoute == kMapGlobal) {
    band.a = const_cast<T*>(src);
    band.stride = stride;
    zero_radix_smem(radix, true);
    int* ctl = reinterpret_cast<int*>(smem + map_list_offset(true));
    if (threadIdx.x < kSelectCtl) ctl[threadIdx.x] = 0;
    __syncthreads();  // the zeroed counts, before pass 0 counts into them
    // as below: no CTA adds into another's totals before all zeroed them
    cluster_arrive();
    count_band<false, true, kSigned>(src, band.rows, cols, stride, prefix16,
                                     0, prefix16 ? 8 : 24, 0u,
                                     hist_copy(radix));
    return cluster_radix_select_long<true, kSigned>(
        src, band.rows, cols, stride, prefix16, keep, hi, radix, ctl,
        reinterpret_cast<unsigned short*>(ctl + kSelectCtl),
        reinterpret_cast<unsigned short*>(smem + map_gather_offset(true)));
  } else {
    const int pad = static_cast<int>(
        (reinterpret_cast<uintptr_t>(src) / sizeof(T)) & 3);
    float* a = reinterpret_cast<float*>(smem + map_band_offset(cols)) + pad;
    band.a = a;
    band.stride = band_stride(cols, stride);
    zero_radix_smem(radix);
    if constexpr (kRoute == kMapOneStep) {
      load_band<false>(a, band.stride, src, band.rows, cols, stride,
                       prefix16, nullptr);
      __syncthreads();  // publishes the band and the zeroed counts
      return cluster_radix_select<kSigned>(a, band.rows, cols, band.stride,
                                           prefix16, keep, hi, radix);
    } else {
      int* ctl = reinterpret_cast<int*>(smem + map_list_offset());
      if (threadIdx.x < kSelectCtl) ctl[threadIdx.x] = 0;
      __syncthreads();  // the zeroed counts, before the load counts into them
      // the cluster's counts of a pass are added into every CTA's zeroed
      // totals: no CTA adds before every CTA has zeroed them (the wait is
      // in the select's first pass end, behind the load)
      cluster_arrive();
      load_band<true, kSigned>(a, band.stride, src, band.rows, cols, stride,
                               prefix16, hist_copy(radix));
      // the select's first barrier publishes the band and pass 0's counts
      return cluster_radix_select_long<false, kSigned>(
          a, band.rows, cols, band.stride, prefix16, keep, hi, radix,
          ctl, reinterpret_cast<unsigned short*>(ctl + kSelectCtl),
          reinterpret_cast<unsigned short*>(smem + map_gather_offset()));
    }
  }
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

// Closes the thread's current group of copies (possibly empty), so that
// every thread counts the same groups.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most `kPending` of the thread's groups are in flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// The copies of load_head_async (below) with the thread's first row and
// column, and its step in both, from copy_steps: a ring of chunks, copied
// again and again at the same width, computes them once, so a copy costs
// a few integer operations instead of a division.
struct CopySteps {
  int n0, c0, dn, dc, width;
};

template <typename T>
__device__ __forceinline__ CopySteps copy_steps(int width) {
  constexpr int kVec = 16 / sizeof(T);
  const int cpr = width / kVec;
  CopySteps st;
  st.n0 = threadIdx.x / cpr;
  st.c0 = (threadIdx.x - st.n0 * cpr) * kVec;
  st.dn = blockDim.x / cpr;
  st.dc = (blockDim.x - st.dn * cpr) * kVec;
  st.width = width;
  return st;
}

template <typename T>
__device__ __forceinline__ void load_rows_async(const T* qkv_b, int C3,
                                                int col, int hd,
                                                int rows_valid, int rows_alloc,
                                                T* dst, int stride,
                                                const CopySteps& st) {
  int n = st.n0, c = st.c0;
  if (st.dc == 0) {  // the block's threads cover whole rows: c is fixed
    const bool col_ok = c < hd;
    const T* src = qkv_b + (size_t)n * C3 + col + c;
    T* d = dst + n * stride + c;
    const size_t src_step = (size_t)st.dn * C3;
    const int dst_step = st.dn * stride;
    for (; n < rows_alloc; n += st.dn, src += src_step, d += dst_step) {
      const bool ok = col_ok && n < rows_valid;
      cp_async16(d, ok ? src : qkv_b, ok ? 16 : 0);
    }
    return;
  }
  while (n < rows_alloc) {
    const bool ok = n < rows_valid && c < hd;
    const T* src = ok ? qkv_b + (size_t)n * C3 + col + c : qkv_b;
    cp_async16(dst + n * stride + c, src, ok ? 16 : 0);
    n += st.dn;
    c += st.dc;
    if (c >= st.width) {
      c -= st.width;
      ++n;
    }
  }
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
  load_rows_async(qkv_b, C3, col, hd, rows_valid, rows_alloc, dst, stride,
                  copy_steps<T>(width));
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

// a - b, a + b, a * b on bf16 pairs, each rounded once to bf16 (nearest
// even). For bf16 operands this is the fp32 operation rounded to bf16: a
// product is exact in fp32; a sum or difference is too unless one operand
// is below 2^-16 of the other, and then both give the larger operand's
// neighbourhood alike, since the small one lies far below half a bf16 ulp.
__device__ __forceinline__ uint32_t sub_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("sub.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t add_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("add.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}

__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
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

// O (16 x 16 hk) += P V, fp32 accumulation; Vs holds 16 KT value rows.
template <int KT>
__device__ __forceinline__ void warp_pv_add(float (&O)[8][4],
                                            const uint32_t (&pa)[KT][4],
                                            const __nv_bfloat16* Vs,
                                            int vstride, int hk) {
  const int lane = threadIdx.x & 31;
  const int row = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int col = (lane >> 4) * 8;
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

// O (16 x 16 hk) = P V.
template <int KT>
__device__ __forceinline__ void warp_pv(float (&O)[8][4],
                                        const uint32_t (&pa)[KT][4],
                                        const __nv_bfloat16* Vs, int vstride,
                                        int hk) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) O[n][e] = 0.f;
  warp_pv_add<KT>(O, pa, Vs, vstride, hk);
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
// and pad columns only. Above 256 tokens: 0. Those counts go to the long
// kernels instead (kLongMinTokens), which stream the keys through shared
// memory a chunk of 4 or 8 tiles at a time.
__host__ __device__ inline int key_tiles(int N) {
  const int t = (N + 15) / 16;
  if (t <= 8) return t <= 2 ? 2 : (t + 1) / 2 * 2;
  return t <= 10 ? 10 : t <= 13 ? 13 : t <= 16 ? 16 : 0;
}

// The fewest tokens the long attention kernels take; up to 256 the
// kernels keep every key of a head in shared memory and registers.
constexpr int kLongMinTokens = 257;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
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
