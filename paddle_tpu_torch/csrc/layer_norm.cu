// K2: LayerNorm forward for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/layer_norm.py
// (_ln_fwd_kernel, reached through _ln_forward / layer_norm_pallas).
// Per row of x (R, C): fp32 mean, the CENTRED variance mean((x-mean)^2)
// (not E[x^2]-mean^2, matching layer_norm.py:34-37), rstd =
// rsqrt(var + eps), y = (x-mean)*rstd*w + b cast to x's dtype, plus the
// fp32 mean and rstd (R, 1) that the backward uses. w and b may be null.
//
// Bound on the H100: bytes. Each row is read and written once over HBM
// (R*C*(in+out) bytes plus w and b); the arithmetic is a few flops per
// element, far below the card's ~20 flop/byte fp32 balance point.
//
// Two kernels, chosen by the C entry from C, the dtype and the pointers:
//
// ln_warp_kernel<T, VPL> (C a multiple of a 16-byte vector, at most
// 32 * kMaxVecs vectors: C <= 1024 fp32, 2048 bf16 or fp16; every
// pointer 16-byte aligned): one warp a row,
// kWarps warps a CTA, a grid sized to the CTAs the card holds at once,
// warps striding over rows. A lane holds its vectors lane, lane + 32, ...
// of the row in registers (VPL 16-byte vectors: at C 768, 6 float4 in
// fp32, 3 x 8 halves in bf16 or fp16), so the row is read once from HBM
// and every pass after that runs on registers: the sum (warp shuffles, no
// __syncthreads), the centred variance, the output. w and b are loaded
// once a warp, by the same lane mapping, and kept in registers for every
// row the warp takes. y leaves as 16-byte vectors; lane 0 writes mean
// and rstd. The mean is taken in two steps, m1 = sum(x) / C and then the
// mean of x - m1, which is exact in fp32 where x lies within a factor 2
// of m1 (a row of large mean and small spread): the row is centred on
// m1 + c, not on a rounded mean whose error would pass into every y.
//
// ln_row_kernel<T, kStaged> (rows wider than that, C of no whole
// vectors, or a pointer off 16 bytes, such as an offset view): one CTA a
// row, the row staged once in shared memory (16-byte loads where x allows
// them, still one HBM read), then the same three sums over the CTA and
// the output. A row too wide for one CTA's shared memory (past ~227 KB)
// is not staged: each pass reads it again from global memory.
//
// T is float, __nv_bfloat16 or __half (type codes 0, 1, 3): one source,
// the 16-bit types differing only in Pack<T>'s conversions.
//
// Neither is a fallback: a kernel the launch refuses returns its error.
#include <algorithm>
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kWarps = 4;              // rows a CTA holds at once
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxVecs = 8;            // 16-byte vectors a lane may hold
                                       // (x, w and b: 3 x 8 x 16 bytes)
constexpr int kRowThreads = 256;       // ln_row_kernel: one CTA a row

// 16 bytes of T as N floats, and back (bf16 and fp16 rounded to nearest
// even, as torch's .to(bfloat16) and .to(float16); an fp16 value past
// 65504 becomes inf, never saturated)
template <typename T>
struct Pack;
template <>
struct Pack<float> {
  static constexpr int N = 4;
  __device__ static void load(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 store(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Pack<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ static void load(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t pair(float lo, float hi) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static uint4 store(const float* f) {
    return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]),
                      pair(f[6], f[7]));
  }
};
template <>
struct Pack<__half> {
  static constexpr int N = 8;
  __device__ static void load(const uint4& u, float* f) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 p =
          __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      f[2 * i] = p.x;
      f[2 * i + 1] = p.y;
    }
  }
  __device__ static uint32_t pair(float lo, float hi) {
    const __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  __device__ static uint4 store(const float* f) {
    return make_uint4(pair(f[0], f[1]), pair(f[2], f[3]), pair(f[4], f[5]),
                      pair(f[6], f[7]));
  }
};

template <typename T, int VPL>
__global__ void __launch_bounds__(kThreads)
    ln_warp_kernel(const T* __restrict__ x, const T* __restrict__ w,
                   const T* __restrict__ b, T* __restrict__ y,
                   float* __restrict__ mean, float* __restrict__ rstd, int R,
                   int C, float eps) {
  using P = Pack<T>;
  constexpr int N = P::N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nv = C / N;  // 16-byte vectors a row
  // this warp's w and b, for every row it takes
  uint4 wv[VPL], bv[VPL];
#pragma unroll
  for (int v = 0; v < VPL; ++v) {
    const int i = lane + 32 * v;
    if (i < nv) {
      if (w != nullptr) wv[v] = reinterpret_cast<const uint4*>(w)[i];
      if (b != nullptr) bv[v] = reinterpret_cast<const uint4*>(b)[i];
    }
  }
  for (int row = blockIdx.x * kWarps + warp; row < R;
       row += gridDim.x * kWarps) {
    const uint4* xr =
        reinterpret_cast<const uint4*>(x + static_cast<int64_t>(row) * C);
    uint4 xv[VPL];
#pragma unroll
    for (int v = 0; v < VPL; ++v)
      if (lane + 32 * v < nv) xv[v] = xr[lane + 32 * v];
    float f[N], s = 0.f;
#pragma unroll
    for (int v = 0; v < VPL; ++v)
      if (lane + 32 * v < nv) {
        P::load(xv[v], f);
#pragma unroll
        for (int e = 0; e < N; ++e) s += f[e];
      }
    const float m1 = ptt::warp_sum(s) / C;
    float s1 = 0.f;
#pragma unroll
    for (int v = 0; v < VPL; ++v)
      if (lane + 32 * v < nv) {
        P::load(xv[v], f);
#pragma unroll
        for (int e = 0; e < N; ++e) s1 += f[e] - m1;
      }
    const float c = ptt::warp_sum(s1) / C;
    float s2 = 0.f;
#pragma unroll
    for (int v = 0; v < VPL; ++v)
      if (lane + 32 * v < nv) {
        P::load(xv[v], f);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          const float d = (f[e] - m1) - c;
          s2 += d * d;
        }
      }
    const float rs = rsqrtf(ptt::warp_sum(s2) / C + eps);
    uint4* yr = reinterpret_cast<uint4*>(y + static_cast<int64_t>(row) * C);
#pragma unroll
    for (int v = 0; v < VPL; ++v)
      if (lane + 32 * v < nv) {
        P::load(xv[v], f);
        float o[N], a[N];
#pragma unroll
        for (int e = 0; e < N; ++e) o[e] = ((f[e] - m1) - c) * rs;
        if (w != nullptr) {
          P::load(wv[v], a);
#pragma unroll
          for (int e = 0; e < N; ++e) o[e] *= a[e];
        }
        if (b != nullptr) {
          P::load(bv[v], a);
#pragma unroll
          for (int e = 0; e < N; ++e) o[e] += a[e];
        }
        yr[lane + 32 * v] = P::store(o);
      }
    if (lane == 0) {
      mean[row] = m1 + c;
      rstd[row] = rs;
    }
  }
}

// Sum over the CTA; every thread gets the result. `red` must hold
// kRowThreads/32 floats. The leading barrier makes back-to-back calls
// safe.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = ptt::warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (lane < kRowThreads / 32) t = red[lane];
  return ptt::warp_sum(t);
}

// One CTA a row. kStaged: the row staged in shared memory, else read
// from global memory on each pass. `vec`: x, y, w and b 16-byte aligned
// and C a whole number of vectors.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kRowThreads)
    ln_row_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ b, T* __restrict__ y,
                  float* __restrict__ mean, float* __restrict__ rstd, int C,
                  float eps, bool vec) {
  constexpr int N = Pack<T>::N;
  extern __shared__ float4 smem4[];
  __shared__ float red[kRowThreads / 32];
  const int64_t row = blockIdx.x;
  const T* xr = x + row * C;
  T* yr = y + row * C;
  const T* xs = kStaged ? reinterpret_cast<const T*>(smem4) : xr;
  if constexpr (kStaged) {
    T* st = reinterpret_cast<T*>(smem4);
    if (vec) {
      for (int i = threadIdx.x; i < C / N; i += kRowThreads)
        reinterpret_cast<uint4*>(st)[i] =
            reinterpret_cast<const uint4*>(xr)[i];
    } else {
      for (int c = threadIdx.x; c < C; c += kRowThreads) st[c] = xr[c];
    }
    __syncthreads();
  }
  float s = 0.f;
  for (int c = threadIdx.x; c < C; c += kRowThreads) s += ptt::to_f(xs[c]);
  const float m1 = block_sum(s, red) / C;
  float s1 = 0.f;
  for (int c = threadIdx.x; c < C; c += kRowThreads)
    s1 += ptt::to_f(xs[c]) - m1;
  const float cc = block_sum(s1, red) / C;
  float s2 = 0.f;
  for (int c = threadIdx.x; c < C; c += kRowThreads) {
    const float d = (ptt::to_f(xs[c]) - m1) - cc;
    s2 += d * d;
  }
  const float rs = rsqrtf(block_sum(s2, red) / C + eps);
  auto out = [&](int c) {
    float o = ((ptt::to_f(xs[c]) - m1) - cc) * rs;
    if (w != nullptr) o *= ptt::to_f(w[c]);
    if (b != nullptr) o += ptt::to_f(b[c]);
    return o;
  };
  if (vec) {
    for (int i = threadIdx.x; i < C / N; i += kRowThreads) {
      float o[N];
#pragma unroll
      for (int e = 0; e < N; ++e) o[e] = out(i * N + e);
      reinterpret_cast<uint4*>(yr)[i] = Pack<T>::store(o);
    }
  } else {
    for (int c = threadIdx.x; c < C; c += kRowThreads)
      yr[c] = ptt::from_f<T>(out(c));
  }
  if (threadIdx.x == 0) {
    mean[row] = m1 + cc;
    rstd[row] = rs;
  }
}

// The grid: at most the CTAs the card holds at once (its SMs times the
// kernel's CTAs an SM, the latter queried once: the build is for one
// architecture).
template <typename T, int VPL>
cudaError_t launch_warp(const T* x, const T* w, const T* b, T* y,
                        float* mean, float* rstd, int R, int C, float eps,
                        cudaStream_t stream) {
  auto kern = ln_warp_kernel<T, VPL>;
  static const int per_sm = [kern] {
    int n = 0;
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kern, kThreads,
                                                         0) == cudaSuccess
               ? n
               : 0;
  }();
  const int full = ptt::sm_count() * per_sm;
  if (full == 0) return cudaErrorInvalidValue;
  const int grid = static_cast<int>(
      std::min<int64_t>((static_cast<int64_t>(R) + kWarps - 1) / kWarps,
                        full));
  kern<<<grid, kThreads, 0, stream>>>(x, w, b, y, mean, rstd, R, C, eps);
  return cudaGetLastError();
}

// The smallest instantiation whose VPL holds ceil(nv / 32) vectors.
template <typename T>
cudaError_t by_vectors(int need, const T* x, const T* w, const T* b, T* y,
                       float* mean, float* rstd, int R, int C, float eps,
                       cudaStream_t st) {
  if (need <= 1) return launch_warp<T, 1>(x, w, b, y, mean, rstd, R, C, eps, st);
  if (need <= 2) return launch_warp<T, 2>(x, w, b, y, mean, rstd, R, C, eps, st);
  if (need <= 3) return launch_warp<T, 3>(x, w, b, y, mean, rstd, R, C, eps, st);
  if (need <= 4) return launch_warp<T, 4>(x, w, b, y, mean, rstd, R, C, eps, st);
  if (need <= 6) return launch_warp<T, 6>(x, w, b, y, mean, rstd, R, C, eps, st);
  return launch_warp<T, kMaxVecs>(x, w, b, y, mean, rstd, R, C, eps, st);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch(const void* xp, const void* wp, const void* bp, void* yp,
                   void* mp, void* rp, int R, int C, float eps,
                   cudaStream_t stream) {
  constexpr int N = Pack<T>::N;
  const T* x = static_cast<const T*>(xp);
  const T* w = static_cast<const T*>(wp);
  const T* b = static_cast<const T*>(bp);
  T* y = static_cast<T*>(yp);
  float* mean = static_cast<float*>(mp);
  float* rstd = static_cast<float*>(rp);
  const bool vec = C % N == 0 && aligned16(x) && aligned16(y) &&
                   (w == nullptr || aligned16(w)) &&
                   (b == nullptr || aligned16(b));
  const int need = (C / N + 31) / 32;
  if (vec && need <= kMaxVecs)
    return by_vectors<T>(need, x, w, b, y, mean, rstd, R, C, eps, stream);
  // the row kernel: the row staged in dynamic shared memory where one
  // CTA's share (the card's opt-in most, less `red`) holds it
  const size_t smem = static_cast<size_t>(C) * sizeof(T);
  int dev = 0, most = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (e != cudaSuccess) return e;
  if (smem + sizeof(float) * (kRowThreads / 32) > static_cast<size_t>(most)) {
    ln_row_kernel<T, false><<<R, kRowThreads, 0, stream>>>(
        x, w, b, y, mean, rstd, C, eps, vec);
    return cudaGetLastError();
  }
  auto kern = ln_row_kernel<T, true>;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  kern<<<R, kRowThreads, smem, stream>>>(x, w, b, y, mean, rstd, C, eps, vec);
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
    case ptt::kFloat16:
      return static_cast<int>(
          launch<__half>(x, w, b, y, mean, rstd, R, C, eps, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
