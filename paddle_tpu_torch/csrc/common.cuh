// Shared helpers for the port's hand-written Hopper kernels: fp32, bf16
// and fp16 load-store conversions and the dtype codes the Python
// wrappers pass (0 = float32, 1 = bfloat16, 2 = int8 codes of a
// quantized KV pool, 3 = float16). Every kernel computes in fp32.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace ptt {

enum DType : int { kFloat32 = 0, kBFloat16 = 1, kInt8 = 2, kFloat16 = 3 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// to nearest even; past fp16's range (65504) inf, never saturated
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// The head dims every attention kernel (K1, K3, K4, K5) takes: 8 to 128
// in steps of 8, so a 16-bit row is whole 16-byte chunks. Each body is
// instantiated at a padded head dim, 64 or 128 (padded_head_dim), and
// takes the real one at run time: loads past it are zero-filled in
// shared memory, so the padded columns add 0 to every product over the
// head dim, and stores past it are predicated off. The Python wrappers
// apply the same predicate (ops/kernels/flash_attention.py HEAD_DIMS).
inline bool head_dim_ok(int d) { return d >= 8 && d <= 128 && d % 8 == 0; }
inline int padded_head_dim(int d) { return d <= 64 ? 64 : 128; }

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

// The current device's SMs: queried once a device for the first
// kCachedDevices, on every call past them; 0 if the query fails.
inline int sm_count() {
  constexpr int kCachedDevices = 16;
  static int cached[kCachedDevices] = {};
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kCachedDevices && cached[dev] != 0) return cached[dev];
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  if (dev < kCachedDevices) cached[dev] = n;
  return n;
}

}  // namespace ptt
