// K2: LayerNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/layer_norm.py
// (_ln_fwd_kernel, reached through _ln_forward / layer_norm_pallas).
// Per row of x (R, C): fp32 mean, the CENTRED variance mean((x-mean)^2)
// (not E[x^2]-mean^2, matching layer_norm.py:34-37), rstd =
// rsqrt(var + eps), y = (x-mean)*rstd*w + b cast to x's dtype, plus the
// fp32 mean and rstd (R, 1) that the training slice's backward will use.
//
// Bound on the H100: bytes. Each row is read and written once over HBM
// (R*C*(in+out) bytes plus w and b); the arithmetic is a few flops per
// element, far below the card's ~20 flop/byte fp32 balance point.
// Design: one CTA of 256 threads per row with warp-shuffle reductions.
// The row is re-read for the variance and output passes; at the serving
// widths (C = 768, 3 KB fp32) the re-reads hit L1/L2, so HBM sees one
// read. Vectorised 16-byte loads and several rows per CTA for small C
// are later work.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// Sum over the CTA; every thread gets the result. `red` must hold
// kThreads/32 floats. The leading barrier makes back-to-back calls safe.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = ptt::warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (lane < kThreads / 32) t = red[lane];
  return ptt::warp_sum(t);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    ln_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ b, T* __restrict__ y,
                  float* __restrict__ mean, float* __restrict__ rstd, int C,
                  float eps) {
  __shared__ float red[kThreads / 32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * C;
  T* yr = y + row * C;
  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) s += ptt::to_f(xr[c]);
  const float mu = block_sum(s, red) / C;
  float v = 0.f;
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float d = ptt::to_f(xr[c]) - mu;
    v += d * d;
  }
  const float rs = rsqrtf(block_sum(v, red) / C + eps);
  for (int c = threadIdx.x; c < C; c += kThreads) {
    float o = (ptt::to_f(xr[c]) - mu) * rs;
    if (w != nullptr) o *= ptt::to_f(w[c]);
    if (b != nullptr) o += ptt::to_f(b[c]);
    yr[c] = ptt::from_f<T>(o);
  }
  if (threadIdx.x == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* b, void* y,
                   void* mean, void* rstd, int R, int C, float eps,
                   cudaStream_t stream) {
  ln_fwd_kernel<T><<<R, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const T*>(b), static_cast<T*>(y),
      static_cast<float*>(mean), static_cast<float*>(rstd), C, eps);
  return cudaGetLastError();
}

}  // namespace

// w and b may be null (the four cases of layer_norm.py:62-73).
// Returns the launch's cudaError_t (0 = launched).
extern "C" int ptt_layer_norm_fwd(const void* x, const void* w, const void* b,
                                  void* y, void* mean, void* rstd, int R,
                                  int C, float eps, int dtype, void* stream) {
  if (R < 1 || C < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kFloat32:
      return static_cast<int>(
          launch<float>(x, w, b, y, mean, rstd, R, C, eps, st));
    case ptt::kBFloat16:
      return static_cast<int>(
          launch<__nv_bfloat16>(x, w, b, y, mean, rstd, R, C, eps, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
