// The PointNet eval epilogue for Hopper (sm_90a): BatchNorm with its
// running statistics, ReLU, the empty-section mask and the slot max-pool,
// one pass after each PointNet GEMM.
//
// Replaces no TPU kernel. The JAX package leaves this epilogue to XLA,
// which fuses it with the matmul's consumer (frustum_convnet_tpu/models/
// net.py: TorchBN's eval branch, DenseBNReLU, PointNetScale's mask and
// slot_max_pool). Eager PyTorch ran it as four passes over every GEMM
// output (subtract, multiply, add, ReLU) and, after a scale's last GEMM,
// three more (masked_fill's clone and fill, amax). Two entry points take
// their place:
//   * bn_relu_kernel: in place on a (rows, C) GEMM output, every PointNet
//     layer but the last of each scale;
//   * bn_relu_mask_maxpool_kernel: (B, M, K, C) -> (B, M, C), the last
//     layer of each scale.
// The contract, bit for bit with the plain versions in
// frustum_convnet_tpu_torch/ops/pointnet_epilogue.py:
//   * inv = (1 / sqrt(var + eps)) * weight from the BatchNorm's running
//     variance and weight, each step correctly rounded (__fadd_rn,
//     __fsqrt_rn, __frcp_rn, __fmul_rn), as torch's add, sqrt, reciprocal
//     and mul round them in models/net.py `_normalize`; a thread works it
//     out once for its channels, so the host launches nothing for it;
//   * each element becomes relu(((y - mean) * inv) + bias), each step
//     rounded on its own (__fsub_rn, __fmul_rn, __fadd_rn: nothing is
//     contracted into an FMA), in the order of models/net.py `_normalize`;
//     the ReLU passes NaN through, as torch's clamp_min does;
//   * the pool writes 0 for a section whose cnt is 0 (its slots are never
//     read), else the max over the K slots, NaN propagating as amax does;
//     the first slot wins a tie.
//
// What bounds it on this card: HBM bytes. The arithmetic is 4 operations
// an element, far under the float32 rate.
//   * bn_relu_kernel reads y once and writes it once: 8 B an element. At
//     the car shapes (B=256) a layer is 37-147 MB of y, 0.02-0.09 ms at
//     3.35 TB/s.
//   * bn_relu_mask_maxpool_kernel reads y once (4 B an element) and writes
//     the pooled (B, M, C), 1/K of that.
// What the design does about it:
//   * every load and store is 16 B (float4): every width is a multiple of
//     4 (the model's are multiples of 64), and the wrapper checks the
//     alignment;
//   * bn_relu_kernel runs one resident wave of blocks (the occupancy API
//     sizes it to the card's SMs, once a device) striding over the tensor,
//     with kUnroll
//     independent loads in flight a thread; the stride is a multiple of
//     C/4, so a thread's channels never change and it loads its statistics
//     once;
//   * bn_relu_mask_maxpool_kernel gives a section C/4 threads, one float4
//     column each, and a block 256 / (C/4) sections, so the block shape
//     comes from C and every slot a warp reads is one contiguous run of
//     C * 4 bytes; each thread walks its column down the K slots, kUnroll
//     loads ahead of its running max (K = 32-256 at the model's shapes,
//     any K is taken), and the loads stream past L1 (y is read once);
//   * neither kernel needs shared memory or a second pass.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads a block
constexpr int kUnroll = 8;     // independent 16-byte loads in flight a thread
constexpr int kMaxDevices = 64;

// The per-channel BatchNorm scale of one channel quad.
__device__ __forceinline__ float4 bn_inv4(const float4* var, const float4* weight, int q,
                                          float eps) {
  const float4 v = __ldg(var + q), w = __ldg(weight + q);
  return make_float4(__fmul_rn(__frcp_rn(__fsqrt_rn(__fadd_rn(v.x, eps))), w.x),
                     __fmul_rn(__frcp_rn(__fsqrt_rn(__fadd_rn(v.y, eps))), w.y),
                     __fmul_rn(__frcp_rn(__fsqrt_rn(__fadd_rn(v.z, eps))), w.z),
                     __fmul_rn(__frcp_rn(__fsqrt_rn(__fadd_rn(v.w, eps))), w.w));
}

__device__ __forceinline__ float bn_relu(float y, float mean, float inv, float bias) {
  const float t = __fadd_rn(__fmul_rn(__fsub_rn(y, mean), inv), bias);
  return isnan(t) ? t : fmaxf(t, 0.0f);
}

__device__ __forceinline__ float4 bn_relu4(float4 y, float4 m, float4 s, float4 b) {
  return make_float4(bn_relu(y.x, m.x, s.x, b.x), bn_relu(y.y, m.y, s.y, b.y),
                     bn_relu(y.z, m.z, s.z, b.z), bn_relu(y.w, m.w, s.w, b.w));
}

// amax's rule with the first slot winning a tie: keep `a` unless `b` is
// larger or NaN (a NaN `a` is kept).
__device__ __forceinline__ float max_first(float a, float b) {
  return (isnan(a) || a >= b) ? a : b;
}

__device__ __forceinline__ float4 max_first4(float4 a, float4 b) {
  return make_float4(max_first(a.x, b.x), max_first(a.y, b.y), max_first(a.z, b.z),
                     max_first(a.w, b.w));
}

// y (n4 float4s, rows of c4) in place. gridDim.x * kThreads is a multiple
// of c4, so thread t handles channel quad t % c4 alone.
__global__ void __launch_bounds__(kThreads)
    bn_relu_kernel(float4* __restrict__ y, const float4* __restrict__ mean,
                   const float4* __restrict__ var, const float4* __restrict__ weight,
                   const float4* __restrict__ bias, float eps, int64_t n4, int c4) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int q = static_cast<int>(first % c4);
  const float4 m = __ldg(mean + q), s = bn_inv4(var, weight, q, eps), b = __ldg(bias + q);
  for (int64_t base = first; base < n4; base += stride * kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = base + u * stride;
      if (j < n4) v[u] = y[j];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t j = base + u * stride;
      if (j < n4) y[j] = bn_relu4(v[u], m, s, b);
    }
  }
}

// y (n_sections, k, c4) float4s, cnt (n_sections) -> out (n_sections, c4).
// Block (c4, sections a block); section blockIdx.x * blockDim.y + threadIdx.y.
__global__ void __launch_bounds__(kThreads)
    bn_relu_mask_maxpool_kernel(const float4* __restrict__ y, const int32_t* __restrict__ cnt,
                                const float4* __restrict__ mean, const float4* __restrict__ var,
                                const float4* __restrict__ weight,
                                const float4* __restrict__ bias, float eps,
                                float4* __restrict__ out, int64_t n_sections, int k, int c4) {
  const int64_t sec = static_cast<int64_t>(blockIdx.x) * blockDim.y + threadIdx.y;
  if (sec >= n_sections) return;
  const int q = threadIdx.x;
  float4* dst = out + sec * c4 + q;
  if (__ldg(cnt + sec) == 0) {
    *dst = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    return;
  }
  const float4 m = __ldg(mean + q), s = bn_inv4(var, weight, q, eps), b = __ldg(bias + q);
  const float4* src = y + sec * k * c4 + q;
  float4 acc = bn_relu4(__ldcs(src), m, s, b);
  int j = 1;
  for (; j + kUnroll <= k; j += kUnroll) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcs(src + static_cast<int64_t>(j + u) * c4);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) acc = max_first4(acc, bn_relu4(v[u], m, s, b));
  }
  for (; j < k; ++j) {
    acc = max_first4(acc, bn_relu4(__ldcs(src + static_cast<int64_t>(j) * c4), m, s, b));
  }
  *dst = acc;
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// Blocks of bn_relu_kernel resident on `device` at once, asked once a
// device and kept.
cudaError_t resident_wave(int device, int64_t* wave) {
  static int64_t cached[kMaxDevices] = {};
  if (device >= 0 && device < kMaxDevices && cached[device] > 0) {
    *wave = cached[device];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bn_relu_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  *wave = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  if (device >= 0 && device < kMaxDevices) cached[device] = *wave;
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Both entry points launch on `stream` (a cudaStream_t) of `device` and
// return cudaGetLastError() after the launch (0 = cudaSuccess). Shapes,
// dtypes and alignment are checked by the Python wrappers
// (frustum_convnet_tpu_torch/ops/pointnet_epilogue.py); `channels` is a
// multiple of 4 and every pointer 16-byte aligned. `mean`, `var`, `weight`
// and `bias` are the BatchNorm's running mean and variance and its affine
// weight and bias, (channels,) each; `eps` its epsilon.

// y (n / channels rows, channels) in place.
int fcn_bn_relu(float* y, const float* mean, const float* var, const float* weight,
                const float* bias, float eps, int64_t n, int channels, int device,
                void* stream) {
  if (n <= 0 || channels < 4 || channels % 4) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int64_t wave = 0;
  err = resident_wave(device, &wave);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int c4 = channels / 4;
  const int64_t n4 = n / 4;
  // one resident wave, or fewer blocks where the tensor is small; a whole
  // number of units, so that the stride is a multiple of c4
  const int64_t unit = c4 / gcd(c4, kThreads);
  int64_t blocks = (n4 + kThreads - 1) / kThreads;
  if (blocks > wave) blocks = wave;
  blocks = (blocks + unit - 1) / unit * unit;
  bn_relu_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<float4*>(y), reinterpret_cast<const float4*>(mean),
      reinterpret_cast<const float4*>(var), reinterpret_cast<const float4*>(weight),
      reinterpret_cast<const float4*>(bias), eps, n4, c4);
  return static_cast<int>(cudaGetLastError());
}

// y (n_sections, k, channels), cnt (n_sections) -> out (n_sections, channels).
int fcn_bn_relu_mask_maxpool(const float* y, const int32_t* cnt, const float* mean,
                             const float* var, const float* weight, const float* bias,
                             float eps, float* out, int64_t n_sections, int k, int channels,
                             int device, void* stream) {
  if (n_sections <= 0 || k < 1 || channels < 4 || channels % 4 ||
      channels / 4 > kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int c4 = channels / 4;
  const int per_block = kThreads / c4;
  const int64_t blocks = (n_sections + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidConfiguration);
  bn_relu_mask_maxpool_kernel<<<static_cast<unsigned>(blocks), dim3(c4, per_block), 0,
                                static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(y), cnt, reinterpret_cast<const float4*>(mean),
      reinterpret_cast<const float4*>(var), reinterpret_cast<const float4*>(weight),
      reinterpret_cast<const float4*>(bias), eps, reinterpret_cast<float4*>(out), n_sections,
      k, c4);
  return static_cast<int>(cudaGetLastError());
}

const char* fcn_epilogue_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
