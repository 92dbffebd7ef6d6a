// K3: flash attention backward for Hopper (sm_90a), three kernels.
//
// Replaces the TPU backward kernels of paddle_tpu/ops/pallas/
// flash_attention.py:
//  - K3a _bwd_fused_kernel (:362, via _flash_bwd :516, max(Sq, Sk) <=
//    8192): ptt_flash_bwd_fused, flash_dkv_kernel<WITH_DQ = true>;
//  - K3b _bwd_dkv_stream_kernel (:162) and _bwd_dq_stream_kernel (:215)
//    (via _flash_bwd_stream :436, beyond 8192): ptt_flash_bwd_dkv,
//    flash_dkv_kernel<WITH_DQ = false>, and ptt_flash_bwd_dq,
//    flash_dq_kernel.
// The wrapper keeps JAX's route (_use_streaming, 8192), so each TPU
// kernel's counterpart runs where JAX runs it. On the H100 the choice is
// between fp32 atomics (fused) and a deterministic two-pass split
// (streaming), not a VMEM limit.
//
// Per (query tile, key tile) pair both recompute, from the saved lse and
// delta = rowsum(dO * O) (computed by the wrapper in torch, as JAX does
// in XLA, :522):
//   S = Q K^T * scale (masked -1e30),  P = exp(S - lse),
//   dP = dO V^T,  dS = P * (dP - delta) * scale.
// flash_dkv_kernel: one CTA per (64-row key tile, batch * head) loops
// over the query tiles from the diagonal on, accumulating dV += P^T dO
// and dK += dS^T Q in fp32 registers, and writes both once. With WITH_DQ
// it also adds each tile's dQ += dS K into a zeroed fp32 (B, Sq, H, D)
// buffer by atomicAdd (the wrapper casts it): K3a's fp32 dQ output,
// which on the TPU stayed resident across the key-block grid axis. The
// atomics make dQ's last bits differ from run to run.
// flash_dq_kernel: one CTA per (64-row query tile, batch * head) sweeps
// the key tiles up to the diagonal with dQ in fp32 registers, written
// once in the input dtype.
//
// Bound on the H100: operations. The backward does 2.5x the forward's
// products (64.4 GFLOP per layer at the training shape: B 16, S 1024,
// H 12, D 64, causal) over about twice its bytes, so even at the bf16
// tensor-core peak it is operations; on the CUDA cores in fp32, where
// this version computes, that is ~0.96 ms at the 67 TFLOP/s peak. The
// fused kernel computes P and dS once for all three gradients; the split
// pays the S and dP products twice. Same register micro-tiles and float4
// shared-memory reads as the forward; tensor cores are the next step.
#include "flash_common.cuh"

namespace {

using namespace ptt;
using namespace ptt::flash;

// P and dS of one (query tile q0, key tile k0) pair into shared memory,
// both rounded to T where the Pallas kernels round them. Thread (ty, tx)
// computes rows ty + 16i, keys tx + 16j.
template <typename T, int D, int LDS>
__device__ __forceinline__ void p_and_ds(const Args& a, const float* qs,
                                         const float* dos, const float* ks,
                                         const float* vs, const float* lse_s,
                                         const float* delta_s, float* ps,
                                         float* dss, int q0, int k0, int ty,
                                         int tx) {
  float s[4][4], dp[4][4];
  dot_tile<D, LDS>(s, qs, ks, ty, tx);
  dot_tile<D, LDS>(dp, dos, vs, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const float lse = lse_s[r], delta = delta_s[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float p =
          visible(a, q0 + r, k0 + c) ? expf(s[i][j] * a.scale - lse) : 0.f;
      const float ds = p * (dp[i][j] - delta) * a.scale;
      if (ps != nullptr) ps[r * kPS + c] = round_t<T>(p);
      dss[r * kPS + c] = round_t<T>(ds);
    }
  }
}

// dq[i][j] += sum_c dS[ty + 16i][c] * K[c][tx + 16j] over one key tile.
template <int D, int LDS>
__device__ __forceinline__ void add_ds_k(float (&dq)[4][D / 16],
                                         const float* __restrict__ dss,
                                         const float* __restrict__ ks, int ty,
                                         int tx) {
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 ds[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      ds[i] = *reinterpret_cast<const float4*>(dss + (ty + 16 * i) * kPS + c);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      const float* kc = ks + c * LDS + tx + 16 * j;
      const float k0 = kc[0], k1 = kc[LDS], k2 = kc[2 * LDS],
                  k3 = kc[3 * LDS];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dq[i][j] += (ds[i].x * k0 + ds[i].y * k1) + (ds[i].z * k2 + ds[i].w * k3);
    }
  }
}

template <typename T, int D, bool WITH_DQ>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(const Args a) {
  constexpr int LDS = D + 4;
  constexpr int DJ = D / 16;
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);  // 64 x LDS each
  float* vs = ks + kTile * LDS;
  float* qs = vs + kTile * LDS;
  float* dos = qs + kTile * LDS;
  float* ps = dos + kTile * LDS;  // 64 x kPS each
  float* dss = ps + kTile * kPS;
  float* lse_s = dss + kTile * kPS;  // 64 each
  float* delta_s = lse_s + kTile;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int k0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const T* q = static_cast<const T*>(a.q);
  const T* dout = static_cast<const T*>(a.dout);
  const int64_t o_ss = static_cast<int64_t>(a.H) * D;  // dO is contiguous

  load_tile<T, D, LDS>(ks, static_cast<const T*>(a.k), b, h, k0, a.Sk,
                       a.kv_sb, a.kv_ss, a.kv_sh);
  load_tile<T, D, LDS>(vs, static_cast<const T*>(a.v), b, h, k0, a.Sk,
                       a.kv_sb, a.kv_ss, a.kv_sh);
  // keys ty + 16i, dims tx + 16j
  float dk[4][DJ], dv[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  // causal (top-left): row r sees key k0 only if r >= k0, and the query
  // and key tiles are the same height, so the sweep starts at tile k0/64
  const int nq = (a.Sq + kTile - 1) / kTile;
  for (int q0 = a.causal ? k0 : 0; q0 < nq * kTile; q0 += kTile) {
    load_tile<T, D, LDS>(qs, q, b, h, q0, a.Sq, a.q_sb, a.q_ss, a.q_sh);
    load_tile<T, D, LDS>(dos, dout, b, h, q0, a.Sq, a.Sq * o_ss, o_ss, D);
    load_rows(lse_s, a.lse, bh, q0, a.Sq);
    load_rows(delta_s, a.delta, bh, q0, a.Sq);
    __syncthreads();
    p_and_ds<T, D, LDS>(a, qs, dos, ks, vs, lse_s, delta_s, ps, dss, q0, k0,
                        ty, tx);
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q over this tile's 64 query rows
#pragma unroll 4
    for (int r = 0; r < kTile; ++r) {
      const float* pr = ps + r * kPS + ty;
      const float* dsr = dss + r * kPS + ty;
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = pr[16 * i];
        dsv[i] = dsr[16 * i];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float dov = dos[r * LDS + tx + 16 * j];
        const float qv = qs[r * LDS + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv[i][j] += pv[i] * dov;
          dk[i][j] += dsv[i] * qv;
        }
      }
    }
    if (WITH_DQ) {
      float dq[4][DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) dq[i][j] = 0.f;
      add_ds_k<D, LDS>(dq, dss, ks, ty, tx);
      float* dq_acc = static_cast<float*>(a.out);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + ty + 16 * i;
        if (row >= a.Sq) continue;
        float* dqr =
            dq_acc + ((static_cast<int64_t>(b) * a.Sq + row) * a.H + h) * D;
#pragma unroll
        for (int j = 0; j < DJ; ++j) atomicAdd(dqr + tx + 16 * j, dq[i][j]);
      }
    }
    __syncthreads();
  }

  T* dk_out = static_cast<T*>(a.dk);
  T* dv_out = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= a.Sk) continue;
    const int64_t off = ((static_cast<int64_t>(b) * a.Sk + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk_out[off + tx + 16 * j] = from_f<T>(dk[i][j]);
      dv_out[off + tx + 16 * j] = from_f<T>(dv[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(const Args a) {
  constexpr int LDS = D + 4;
  constexpr int DJ = D / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // 64 x LDS each
  float* dos = qs + kTile * LDS;
  float* ks = dos + kTile * LDS;
  float* vs = ks + kTile * LDS;
  float* dss = vs + kTile * LDS;  // 64 x kPS
  float* lse_s = dss + kTile * kPS;
  float* delta_s = lse_s + kTile;

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const int64_t o_ss = static_cast<int64_t>(a.H) * D;

  load_tile<T, D, LDS>(qs, static_cast<const T*>(a.q), b, h, q0, a.Sq,
                       a.q_sb, a.q_ss, a.q_sh);
  load_tile<T, D, LDS>(dos, static_cast<const T*>(a.dout), b, h, q0, a.Sq,
                       a.Sq * o_ss, o_ss, D);
  load_rows(lse_s, a.lse, bh, q0, a.Sq);
  load_rows(delta_s, a.delta, bh, q0, a.Sq);
  float dq[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq[i][j] = 0.f;

  const int k_end = a.causal ? min(q0 + kTile, a.Sk) : a.Sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    load_tile<T, D, LDS>(ks, k, b, h, k0, a.Sk, a.kv_sb, a.kv_ss, a.kv_sh);
    load_tile<T, D, LDS>(vs, v, b, h, k0, a.Sk, a.kv_sb, a.kv_ss, a.kv_sh);
    __syncthreads();
    p_and_ds<T, D, LDS>(a, qs, dos, ks, vs, lse_s, delta_s, nullptr, dss, q0,
                        k0, ty, tx);
    __syncthreads();
    add_ds_k<D, LDS>(dq, dss, ks, ty, tx);
    __syncthreads();
  }

  T* dq_out = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Sq) continue;
    T* dqr = dq_out + ((static_cast<int64_t>(b) * a.Sq + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqr[tx + 16 * j] = from_f<T>(dq[i][j]);
  }
}

enum class Kind { kFused, kDkv, kDq };

template <typename T, int D>
cudaError_t bwd(const Args& a, Kind kind, cudaStream_t st) {
  constexpr int LDS = D + 4;
  if (kind == Kind::kDq) {
    const size_t smem =
        sizeof(float) * (4 * kTile * LDS + kTile * kPS + 2 * kTile);
    const dim3 grid((a.Sq + kTile - 1) / kTile, a.B * a.H);
    return launch(flash_dq_kernel<T, D>, grid, smem, st, a);
  }
  const size_t smem =
      sizeof(float) * (4 * kTile * LDS + 2 * kTile * kPS + 2 * kTile);
  const dim3 grid((a.Sk + kTile - 1) / kTile, a.B * a.H);
  return kind == Kind::kFused
             ? launch(flash_dkv_kernel<T, D, true>, grid, smem, st, a)
             : launch(flash_dkv_kernel<T, D, false>, grid, smem, st, a);
}

int run(const Args& a, int D, int dtype, Kind kind, void* stream) {
  if (!valid_args(a, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case kFloat32:
      return static_cast<int>(D == 64 ? bwd<float, 64>(a, kind, st)
                                      : bwd<float, 128>(a, kind, st));
    case kBFloat16:
      return static_cast<int>(D == 64 ? bwd<__nv_bfloat16, 64>(a, kind, st)
                                      : bwd<__nv_bfloat16, 128>(a, kind, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Common arguments: q, k, v (B, S, H, D) with strides (sb, ss, sh, 1), k
// and v sharing theirs; dO contiguous (B, Sq, H, D); lse and delta fp32
// (B, H, Sq); dK, dV contiguous (B, Sk, H, D) in the input dtype. Each
// returns the launch's cudaError_t (0 = launched).
#define PTT_FLASH_BWD_PARAMS                                                \
  int B, int H, int Sq, int Sk, int D, int64_t q_sb, int64_t q_ss,          \
      int64_t q_sh, int64_t kv_sb, int64_t kv_ss, int64_t kv_sh, float scale, \
      int causal, int dtype, void *stream
#define PTT_FLASH_BWD_ARGS                                                  \
  Args a = make_args(q, k, v, B, H, Sq, Sk, q_sb, q_ss, q_sh, kv_sb, kv_ss, \
                     kv_sh, scale, causal);                                 \
  a.dout = dout;                                                            \
  a.lse = static_cast<const float*>(lse);                                   \
  a.delta = static_cast<const float*>(delta)

// K3a: dq_acc is a ZEROED fp32 (B, Sq, H, D) buffer the kernel adds into.
extern "C" int ptt_flash_bwd_fused(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const void* lse, const void* delta,
                                   void* dq_acc, void* dk, void* dv,
                                   PTT_FLASH_BWD_PARAMS) {
  PTT_FLASH_BWD_ARGS;
  a.out = dq_acc;
  a.dk = dk;
  a.dv = dv;
  return run(a, D, dtype, Kind::kFused, stream);
}

// K3b, first pass: dK and dV.
extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 PTT_FLASH_BWD_PARAMS) {
  PTT_FLASH_BWD_ARGS;
  a.dk = dk;
  a.dv = dv;
  return run(a, D, dtype, Kind::kDkv, stream);
}

// K3b, second pass: dQ (B, Sq, H, D) contiguous in the input dtype.
extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq,
                                PTT_FLASH_BWD_PARAMS) {
  PTT_FLASH_BWD_ARGS;
  a.out = dq;
  return run(a, D, dtype, Kind::kDq, stream);
}
