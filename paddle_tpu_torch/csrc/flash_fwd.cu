// K1: flash attention forward for Hopper (sm_90a).
//
// Replaces both TPU forward kernels of paddle_tpu/ops/pallas/
// flash_attention.py: _fwd_kernel (:54, K/V resident in VMEM, reached
// through _flash_fwd_resident) and _fwd_stream_kernel (:108, K/V
// streamed over a grid axis, through _flash_fwd_stream for
// max(Sq, Sk) > 8192). On Hopper the two are one design: nothing stays
// resident across CTAs, and a CTA streams its key tiles through shared
// memory either way, so each route launches this one kernel.
//
// One CTA per (64-row query tile, batch * head). It stages its Q tile
// once, then loops over 64-row K/V tiles up to the causal diagonal with
// the online-softmax recurrence of :80-88: m and l fp32 per row (held in
// registers by the warp that owns the row), acc fp32 in registers, P
// rounded to V's dtype before P.V. It writes O in the input dtype and
// lse = m + log(l) in fp32 (B, H, Sq), the backward's residual.
//
// Bound on the H100. At the training shape (B 16, S 1024, H 12, D 64,
// causal, bf16) the kernel moves ~100 MB (q, k, v, O: 30 us at 3.35
// TB/s) and does 4*B*H*S*S*D/2 = 25.8 GFLOP (26 us at the bf16
// tensor-core peak), so the card's bound is about even between bytes
// and operations; in fp32 (67 TFLOP/s on the CUDA cores) it is
// operations, 0.39 ms. This version does its products on the CUDA
// cores in fp32 for both dtypes, so operations bound it. The design
// answers with register micro-tiles (16 scores, or 4 x D/16 outputs,
// per thread) fed by float4 shared-memory reads, and a grid of
// B*H*S/64 CTAs (3072 at the training shape) that fills the 132 SMs.
// Tensor-core tiles (mma / wgmma) are the next step.
#include "flash_common.cuh"

namespace {

using namespace ptt;
using namespace ptt::flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Args a) {
  constexpr int LDS = D + 4;
  constexpr int DJ = D / 16;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // 64 x LDS
  float* ks = qs + kTile * LDS;                  // 64 x LDS
  float* vs = ks + kTile * LDS;                  // 64 x LDS
  float* ps = vs + kTile * LDS;                  // 64 x kPS: logits, then P
  float* alpha_s = ps + kTile * kPS;             // 64
  float* l_s = alpha_s + kTile;                  // 64

  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kTile;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);

  load_tile<T, D, LDS>(qs, q, b, h, q0, a.Sq, a.q_sb, a.q_ss, a.q_sh);
  // rows warp + 8r (r < 8) belong to this warp in the softmax step
  float m_row[8], l_row[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m_row[r] = kMasked;
    l_row[r] = 0.f;
  }
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // causal: the tile's last row is q0 + 63, so keys past it are dead
  const int k_end = a.causal ? min(q0 + kTile, a.Sk) : a.Sk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    load_tile<T, D, LDS>(ks, k, b, h, k0, a.Sk, a.kv_sb, a.kv_ss, a.kv_sh);
    load_tile<T, D, LDS>(vs, v, b, h, k0, a.Sk, a.kv_sb, a.kv_ss, a.kv_sh);
    __syncthreads();
    float s[4][4];
    dot_tile<D, LDS>(s, qs, ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + ty + 16 * i, col = k0 + tx + 16 * j;
        // rows past Sq compute harmless values and are never written
        const bool keep = col < a.Sk && (!a.causal || row >= col);
        ps[(ty + 16 * i) * kPS + tx + 16 * j] =
            keep ? s[i][j] * a.scale : kMasked;
      }
    __syncthreads();
    // online softmax, one warp per row; every row sees column 0 in the
    // first tile, so m is a real logit from then on and masked entries
    // give p = exp(-1e30 - m) = 0
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      float* pr = ps + (warp + 8 * r) * kPS;
      const float x0 = pr[lane], x1 = pr[lane + 32];
      const float m_new = fmaxf(m_row[r], warp_max(fmaxf(x0, x1)));
      const float p0 = expf(x0 - m_new), p1 = expf(x1 - m_new);
      const float alpha = expf(m_row[r] - m_new);
      l_row[r] = l_row[r] * alpha + warp_sum(p0 + p1);
      m_row[r] = m_new;
      pr[lane] = round_t<T>(p0);
      pr[lane + 32] = round_t<T>(p1);
      if (lane == 0) alpha_s[warp + 8 * r] = alpha;
    }
    __syncthreads();
    // acc = acc * alpha + P.V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = alpha_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 2
    for (int c = 0; c < kTile; c += 4) {
      float4 p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kPS + c);
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float* vc = vs + c * LDS + tx + 16 * j;
        const float v0 = vc[0], v1 = vc[LDS], v2 = vc[2 * LDS],
                    v3 = vc[3 * LDS];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i][j] += (p[i].x * v0 + p[i].y * v1) + (p[i].z * v2 + p[i].w * v3);
      }
    }
    __syncthreads();
  }

  float* lse = a.lse_out + static_cast<int64_t>(bh) * a.Sq;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = warp + 8 * r;
    if (lane == 0) {
      l_s[row] = l_row[r];
      if (q0 + row < a.Sq) lse[q0 + row] = m_row[r] + logf(l_row[r]);
    }
  }
  __syncthreads();
  T* o = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Sq) continue;
    const float l = l_s[ty + 16 * i];
    T* orow = o + ((static_cast<int64_t>(b) * a.Sq + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      orow[tx + 16 * j] = from_f<T>(acc[i][j] / l);
  }
}

template <typename T, int D>
cudaError_t fwd(const Args& a, cudaStream_t st) {
  constexpr int LDS = D + 4;
  const size_t smem =
      sizeof(float) * (3 * kTile * LDS + kTile * kPS + 2 * kTile);
  const dim3 grid((a.Sq + kTile - 1) / kTile, a.B * a.H);
  return launch(flash_fwd_kernel<T, D>, grid, smem, st, a);
}

template <typename T>
cudaError_t by_dim(const Args& a, int D, cudaStream_t st) {
  return D == 64 ? fwd<T, 64>(a, st) : fwd<T, 128>(a, st);
}

}  // namespace

// q, k, v (B, S, H, D) with strides (sb, ss, sh, 1), k and v sharing
// theirs; o contiguous (B, Sq, H, D) in the input dtype; lse fp32
// (B, H, Sq). Returns the launch's cudaError_t (0 = launched).
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* o, void* lse, int B, int H, int Sq, int Sk,
                             int D, int64_t q_sb, int64_t q_ss, int64_t q_sh,
                             int64_t kv_sb, int64_t kv_ss, int64_t kv_sh,
                             float scale, int causal, int dtype, void* stream) {
  Args a = make_args(q, k, v, B, H, Sq, Sk, q_sb, q_ss, q_sh, kv_sb, kv_ss,
                     kv_sh, scale, causal);
  a.out = o;
  a.lse_out = static_cast<float*>(lse);
  if (!valid_args(a, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case ptt::kFloat32:
      return static_cast<int>(by_dim<float>(a, D, st));
    case ptt::kBFloat16:
      return static_cast<int>(by_dim<__nv_bfloat16>(a, D, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
