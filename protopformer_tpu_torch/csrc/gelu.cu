// The tanh GELU of a bf16 tensor in one pass.
//
// Replaces no TPU kernel: protopformer_tpu/ops/activations.py::gelu_speed
// is plain jnp, which XLA fuses into one loop. PyTorch runs the port's
// eager statement of it (ops/activations.py::gelu_speed_plain) as 11
// launches over the whole MLP hidden, each writing an fp32 intermediate:
// the cast up, three products by a scalar, three by a tensor, two adds,
// the tanh and the cast down. This pass reads each bf16 value once, does
// the same fp32 arithmetic in registers and writes the bf16 result once.
//
// Bits: the eager expression in its own order, each operation rounded to
// nearest on its own (__fmul_rn / __fadd_rn: nvcc would otherwise contract
// a product and a sum into one FMA), with the constants as PyTorch's
// scalar operations round them (the Python double cast to fp32), the
// accurate tanhf (no --use_fast_math) and a round-to-nearest-even cast
// down: the eager chain's bits on the card (tests/test_torch_gpu.py holds
// every bf16 value).
//
// Bound on an H100: bytes. The hidden of DeiT-B/16@384 at B=160 is
// 160 x 577 x 3072 = 283.6 M values, 1.134 GB read and written, 0.339 ms
// at 3.35 TB/s (the chain moves 28.4 GB). The accurate tanhf and ~10 float
// operations are ~35 instructions a value, close to that time on 132 SMs,
// so the loop body is kept lean: each thread takes two 16-byte vectors of
// 8 values an iteration of a grid-stride loop (two loads in flight before
// any arithmetic), over a grid of as many 256-thread blocks as the card
// holds at once, and no shared memory. A head of up to 7 values before the
// first 16-byte boundary and a tail after the last whole vector go one
// value a thread; an input and output that lie differently against 16
// bytes (a view of the input that starts off a boundary) take the scalar
// loop throughout.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;         // bf16 values in a 16-byte access
constexpr int kMaxDevices = 64;

// PyTorch's scalar operations on an fp32 tensor take the scalar as fp32
constexpr float kCube = static_cast<float>(0.044715);
constexpr float kSqrt2OverPi = static_cast<float>(0.7978845608028654);

__device__ __forceinline__ float gelu_tanh(float x) {
  // 0.7978845608028654 * (x + 0.044715 * x * x * x)
  const float cube = __fmul_rn(__fmul_rn(__fmul_rn(kCube, x), x), x);
  const float inner = __fmul_rn(kSqrt2OverPi, __fadd_rn(x, cube));
  // x * 0.5 * (1.0 + tanh(inner))
  return __fmul_rn(__fmul_rn(x, 0.5f), __fadd_rn(1.0f, tanhf(inner)));
}

__device__ __forceinline__ __nv_bfloat16 gelu_tanh(__nv_bfloat16 x) {
  return __float2bfloat16_rn(gelu_tanh(__bfloat162float(x)));
}

__device__ __forceinline__ uint4 gelu_tanh(uint4 v) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    h[k] = __floats2bfloat162_rn(gelu_tanh(f.x), gelu_tanh(f.y));
  }
  return v;
}

// head: values before x + head and y + head lie on 16 bytes (vector only)
__global__ void __launch_bounds__(kThreads)
gelu_tanh_kernel(const __nv_bfloat16* __restrict__ x,
                 __nv_bfloat16* __restrict__ y, long long n, int head,
                 bool vector) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (!vector) {
    for (long long i = tid; i < n; i += stride) y[i] = gelu_tanh(x[i]);
    return;
  }
  const long long nvec = (n - head) / kVec;
  const long long tail = head + nvec * kVec;
  if (tid < head) y[tid] = gelu_tanh(x[tid]);
  if (tid < n - tail) y[tail + tid] = gelu_tanh(x[tail + tid]);
  const uint4* xv = reinterpret_cast<const uint4*>(x + head);
  uint4* yv = reinterpret_cast<uint4*>(y + head);
  for (long long i = tid; i < nvec; i += 2 * stride) {
    const bool second = i + stride < nvec;
    const uint4 a = xv[i];
    uint4 b = make_uint4(0, 0, 0, 0);
    if (second) b = xv[i + stride];
    yv[i] = gelu_tanh(a);
    if (second) yv[i + stride] = gelu_tanh(b);
  }
}

// Blocks of the kernel the current device holds at once (cached a device).
cudaError_t resident_blocks(int* blocks) {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gelu_tanh_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return cudaSuccess;
}

}  // namespace

// x, y: n contiguous bf16 values each (y does not overlap x); y = the tanh
// GELU of x with gelu_speed's fp32 arithmetic. Returns the launch's
// cudaError_t (nothing is launched for n = 0).
extern "C" int ppf_gelu_tanh_bf16(const void* x, void* y, long long n,
                                  void* stream) {
  if (n <= 0) return cudaSuccess;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  const uintptr_t ya = reinterpret_cast<uintptr_t>(y);
  const bool vector = xa % 16 == ya % 16;
  long long head = vector ? static_cast<long long>((16 - xa % 16) % 16 / 2)
                          : 0;
  if (head > n) head = n;
  const long long work = vector ? (n - head) / kVec : n;
  int resident = 0;
  cudaError_t err = resident_blocks(&resident);
  if (err != cudaSuccess) return err;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;  // a head and tail alone (at most 14 values)
  gelu_tanh_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<__nv_bfloat16*>(y), n,
      static_cast<int>(head), vector);
  return cudaGetLastError();
}
