// Shared device helpers for the port's Hopper kernels (K1-K3).
//
// Every kernel here runs one thread block per sample (or per row tile of
// a sample), keeps the per-head K/V tiles in shared memory and computes on
// CUDA cores with explicit IEEE rounding (__fmul_rn / __fadd_rn /
// __fdiv_rn) wherever the JAX reference rounds, so each step matches the
// plain PyTorch version beside the wrapper.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace ppf {

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

__device__ __forceinline__ int warp_sum_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_max_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide sums / maxima; `red` is shared scratch of >= 32 ints. Every
// thread gets the result. The leading barrier keeps a previous call's
// readers off `red` while it is rewritten.
__device__ __forceinline__ int block_sum_int(int v, int* red) {
  v = warp_sum_int(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
  const int nw = blockDim.x >> 5;
  for (int w = 0; w < nw; ++w) total += red[w];
  return total;
}

__device__ __forceinline__ int block_max_int(int v, int* red) {
  v = warp_max_int(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = red[0];
  const int nw = blockDim.x >> 5;
  for (int w = 1; w < nw; ++w) m = max(m, red[w]);
  return m;
}

// Two consecutive elements as floats (bf16 widens exactly).
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Bisection key of a non-negative map value: the fp32 bit pattern, or its
// high 16 bits (a logical shift, as the JAX kernels do) in prefix16 mode.
__device__ __forceinline__ int bisect_key(float x, bool prefix16) {
  return prefix16 ? static_cast<int>(__float_as_uint(x) >> 16)
                  : __float_as_int(x);
}

// Largest key v in [lo, hi] with count(key(a[e]) >= v) >= keep, by `steps`
// bisection steps over the block-resident map `a` of E values. The caller
// has synchronised after writing `a`.
__device__ __forceinline__ int block_bisect(const float* a, int E, int keep,
                                            bool prefix16, int lo, int hi,
                                            int steps, int* red) {
  for (int it = 0; it < steps; ++it) {
    const int mid = lo + (hi - lo + 1) / 2;
    int c = 0;
    for (int e = threadIdx.x; e < E; e += blockDim.x)
      c += bisect_key(a[e], prefix16) >= mid;
    c = block_sum_int(c, red);
    if (c >= keep) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

__device__ __forceinline__ float threshold_from_key(int lo, bool prefix16) {
  return __int_as_float(prefix16 ? (lo << 16) : lo);
}

// s[i] = sum_j a[i, j] * [a[i, j] >= t] over the resident (N, N) map, one
// warp per row.
__device__ __forceinline__ void block_masked_row_sums(const float* a, int N,
                                                      float t, float* s) {
  const int lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int i = threadIdx.x >> 5; i < N; i += nw) {
    float acc = 0.f;
    for (int j = lane; j < N; j += kWarp) {
      const float v = a[i * N + j];
      acc += v >= t ? v : 0.f;
    }
    acc = warp_sum(acc);
    if (lane == 0) s[i] = acc;
  }
}

// Dot products of one query row (fp32 in shared memory) with the key rows
// j = lane + 32 * u, u < MAXT, of a shared (N, kstride) K tile; fp32
// accumulation. kstride = hd + 2 elements keeps the lanes' 4- and 8-byte
// loads on distinct banks.
template <typename T, int MAXT>
__device__ __forceinline__ void row_dots(const float* q, const T* Ks,
                                         int kstride, int N, int hd,
                                         float (&dots)[MAXT]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int u = 0; u < MAXT; ++u) dots[u] = 0.f;
  for (int d = 0; d < hd; d += 2) {
    const float2 qv = *reinterpret_cast<const float2*>(q + d);
#pragma unroll
    for (int u = 0; u < MAXT; ++u) {
      const int j = lane + kWarp * u;
      if (j < N) {
        const float2 kv = load2(Ks + j * kstride + d);
        dots[u] = fmaf(qv.x, kv.x, dots[u]);
        dots[u] = fmaf(qv.y, kv.y, dots[u]);
      }
    }
  }
}

// out[d] = sum_j p[j] * V[j, d] for this lane's column pairs, fp32
// accumulation in ascending j; p is the warp's shared probability row.
template <typename T, typename TO>
__device__ __forceinline__ void row_av(const float* p, const T* Vs, int N,
                                       int hd, TO* out) {
  const int lane = threadIdx.x & 31;
  for (int d = 2 * lane; d < hd; d += 2 * kWarp) {
    float ox = 0.f, oy = 0.f;
    for (int j = 0; j < N; ++j) {
      const float pj = p[j];
      const float2 v = load2(Vs + j * hd + d);
      ox = fmaf(pj, v.x, ox);
      oy = fmaf(pj, v.y, oy);
    }
    store2(out + d, ox, oy);
  }
}

// Copy one head's (N, hd) slice at column offset `col` of the packed
// (N, 3C) qkv rows into a shared tile of row stride `stride`; rows at or
// past `zero_from` are written as zeros.
template <typename T>
__device__ __forceinline__ void load_head(const T* qkv_b, int N, int C3,
                                          int col, int hd, T* dst,
                                          int stride, int zero_from) {
  const int pairs = hd / 2;
  for (int idx = threadIdx.x; idx < N * pairs; idx += blockDim.x) {
    const int n = idx / pairs;
    const int d = 2 * (idx - n * pairs);
    if (n < zero_from) {
      const float2 v = load2(qkv_b + (size_t)n * C3 + col + d);
      store2(dst + n * stride + d, v.x, v.y);
    } else {
      store2(dst + n * stride + d, 0.f, 0.f);
    }
  }
}

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~size_t(15); }

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
