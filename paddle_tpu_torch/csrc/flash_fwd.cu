// K1: flash attention forward for Hopper (sm_90a).
//
// Replaces both TPU forward kernels of paddle_tpu/ops/pallas/
// flash_attention.py: _fwd_kernel (:54, K/V resident in VMEM, reached
// through _flash_fwd_resident) and _fwd_stream_kernel (:108, K/V
// streamed over a grid axis, through _flash_fwd_stream for
// max(Sq, Sk) > 8192). On Hopper the two are one design: nothing stays
// resident across CTAs, and a CTA streams its key tiles through shared
// memory either way, so each route launches the kernel of its dtype.
//
// Both kernels run the online-softmax recurrence of :80-88: m and l fp32
// per row, acc fp32, P rounded to V's dtype before P.V; they write O in
// the input dtype and lse = m + log(l) in fp32 (B, H, Sq), the
// backward's residual.
//
// Bound on the H100. At the training shape (B 16, S 1024, H 12, D 64,
// causal, bf16) the kernel moves ~100 MB (q, k, v, O: 30 us at 3.35
// TB/s) and does 4*B*H*S*S*D/2 = 25.8 GFLOP (26 us at the bf16
// tensor-core peak): bytes and operations are about even. In fp32 (67
// TFLOP/s on the CUDA cores) operations bound it, 0.39 ms.
//
// bf16: flash_fwd_mma_kernel, both products on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulate; flash_mma.cuh). A CTA
// owns 128 query rows of one (batch, head), 8 warps of 16 rows each.
// Its Q tile is staged once by cp.async and held in registers as A
// fragments for the whole key loop; 64-key K and V tiles stream through
// a two-stage cp.async ring, tile j + 1's copies issued before tile j's
// math, so loads overlap the products. S = Q.K^T stays in registers
// (K's B fragments by ldmatrix), the online softmax runs on the
// accumulator fragments (row max and sum over the 4 lanes of a row by
// shuffles), and P, rounded to bf16, becomes the A operand of P.V in
// registers (V's B fragments by ldmatrix.trans). No score tile goes
// through shared memory. Under causal masking a warp skips a key tile
// whose keys all lie past its last row (an exact no-op of the recurrence),
// and the CTAs of the longest query tiles launch first. Rows past Sq or
// Sk are zero-filled by cp.async, never read. Against the even bound:
// the products run at tensor-core rates, and the bytes move in 16-byte
// chunks (cp.async in, O staged through shared memory and stored 16
// bytes a lane), q read once, k and v once per 128-row query tile.
//
// fp32: flash_fwd_kernel, products on the CUDA cores in fp32 (no TF32:
// the fp32 contract is 1e-4 of the plain version), register micro-tiles
// (16 scores, or 4 x D/16 outputs, per thread) fed by float4
// shared-memory reads; a grid of B*H*S/64 CTAs.
#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace ptt;
using namespace ptt::flash;

template <int D>
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
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);

  load_tile<D, LDS>(qs, q, b, h, q0, a.Sq, a.q_sb, a.q_ss, a.q_sh);
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
    load_tile<D, LDS>(ks, k, b, h, k0, a.Sk, a.kv_sb, a.kv_ss, a.kv_sh);
    load_tile<D, LDS>(vs, v, b, h, k0, a.Sk, a.kv_sb, a.kv_ss, a.kv_sh);
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
      pr[lane] = p0;  // P in V's dtype, fp32 here (:85)
      pr[lane + 32] = p1;
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
  float* o = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Sq) continue;
    const float l = l_s[ty + 16 * i];
    float* orow = o + ((static_cast<int64_t>(b) * a.Sq + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      orow[tx + 16 * j] = acc[i][j] / l;
  }
}


constexpr int kRowsQ = 128;  // query rows per bf16 CTA: 8 warps x 16
constexpr float kLog2e = 1.4426950408889634f;

// exp(x - m) for the softmax: one ex2 on the multiplied difference
__device__ __forceinline__ float exp_diff(float x, float m) {
  return exp2f((x - m) * kLog2e);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_mma_kernel(const Args a) {
  using mma::bf16;
  constexpr int LDS = D + 8;  // bf16 row stride: 16 bytes of padding
  constexpr int KD = D / 16;  // k16 steps of Q.K^T
  constexpr int ND = D / 8;   // n8 tiles of the output
  constexpr int NS = kTile / 8;  // n8 tiles of a score tile
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);  // kRowsQ x LDS, then O
  bf16* ks = qs + kRowsQ * LDS;               // 2 stages x kTile x LDS
  bf16* vs = ks + 2 * kTile * LDS;            // 2 stages x kTile x LDS

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // causal: the last query tiles see the most keys; launch them first
  const int tile = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * kRowsQ, w0 = q0 + warp * 16;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.kv_sb + h * a.kv_sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.kv_sb + h * a.kv_sh;
  // causal: keys past the tile's last row are dead
  const int k_end = a.causal ? min(q0 + kRowsQ, a.Sk) : a.Sk;
  const int n_tiles = (k_end + kTile - 1) / kTile;

  // groups in flight: Q, then K and V of tile 0
  mma::tile_async<kRowsQ, D, LDS, kThreads>(qs, q, q0, a.Sq, a.q_ss);
  mma::cp_async_commit();
  mma::tile_async<kTile, D, LDS, kThreads>(ks, k, 0, a.Sk, a.kv_ss);
  mma::cp_async_commit();
  mma::tile_async<kTile, D, LDS, kThreads>(vs, v, 0, a.Sk, a.kv_ss);
  mma::cp_async_commit();
  mma::cp_async_wait<2>();
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    mma::ldsm_x4(qf[kd], mma::a_x4<LDS>(qs, warp * 16, kd * 16, lane));

  // this thread's rows: w0 + g (i = 0) and w0 + g + 8 (i = 1)
  float m[2] = {kMasked, kMasked}, l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    const bf16* kt = ks + (j & 1) * kTile * LDS;
    const bf16* vt = vs + (j & 1) * kTile * LDS;
    const bool more = j + 1 < n_tiles;
    // K_j has landed (V_j may not have); every warp is done with tile
    // j - 1, whose stage the copies of tile j + 1 now overwrite
    mma::cp_async_wait<1>();
    __syncthreads();
    if (more) {
      bf16* kn = ks + ((j + 1) & 1) * kTile * LDS;
      bf16* vn = vs + ((j + 1) & 1) * kTile * LDS;
      mma::tile_async<kTile, D, LDS, kThreads>(kn, k, k0 + kTile, a.Sk,
                                               a.kv_ss);
      mma::cp_async_commit();
      mma::tile_async<kTile, D, LDS, kThreads>(vn, v, k0 + kTile, a.Sk,
                                               a.kv_ss);
      mma::cp_async_commit();
    }
    // warp-uniform: under causal masking every key of the tile lies
    // past this warp's last row, so p = 0 and alpha = 1 throughout
    const bool live = !a.causal || w0 + 15 >= k0;
    float s[NS][4];
    if (live) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
#pragma unroll
        for (int n = 0; n < NS; n += 2) {
          uint32_t kf[4];
          mma::ldsm_x4(kf, mma::b_x4<LDS>(kt, n * 8, kd * 16, lane));
          mma::mma_bf16(s[n], qf[kd], kf[0], kf[1]);
          mma::mma_bf16(s[n + 1], qf[kd], kf[2], kf[3]);
        }
      // tiles wholly below the diagonal and inside Sk skip the test
      const bool edge =
          k0 + kTile > a.Sk || (a.causal && k0 + kTile - 1 > w0);
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[n][e] * a.scale;
          if (edge) {
            const int row = w0 + g + (e / 2) * 8;
            const int col = k0 + n * 8 + 2 * t + e % 2;
            if (col >= a.Sk || (a.causal && row < col)) x = kMasked;
          }
          s[n][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
        }
      // the 4 lanes of a quad hold one row; every row sees key 0 in
      // tile 0, so m is a real logit from then on and a masked logit
      // gives p = exp(-1e30 - m) = 0
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        alpha[i] = exp_diff(m[i], mx[i]);
        m[i] = mx[i];
        l[i] *= alpha[i];  // this lane's partial sum; quads add at the end
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[n][e] = exp_diff(s[n][e], m[e / 2]);
          l[e / 2] += s[n][e];
        }
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e / 2];
    }
    // V_j has landed (tile j + 1's K and V may not have)
    if (more)
      mma::cp_async_wait<2>();
    else
      mma::cp_async_wait<0>();
    __syncthreads();
    if (live) {
      // acc += P.V, P rounded to bf16 (V's dtype, :85)
#pragma unroll
      for (int kk = 0; kk < NS / 2; ++kk) {
        uint32_t pa[4];
        mma::pack_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < ND; n += 2) {
          uint32_t vf[4];
          mma::ldsm_x4_trans(vf, mma::bt_x4<LDS>(vt, kk * 16, n * 8, lane));
          mma::mma_bf16(o[n], pa, vf[0], vf[1]);
          mma::mma_bf16(o[n + 1], pa, vf[2], vf[3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  float* lse = a.lse_out + static_cast<int64_t>(bh) * a.Sq;
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (w0 + g + 8 * i < a.Sq) lse[w0 + g + 8 * i] = m[i] + logf(l[i]);
  }
  // O = acc / l in bf16, staged through this warp's own 16 rows of the Q
  // tile (its Q fragments are in registers) into 16-byte stores
  bf16* os = qs + warp * 16 * LDS;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<uint32_t*>(os + g * LDS + n * 8 + 2 * t) =
        mma::pack_bf16(o[n][0] / l[0], o[n][1] / l[0]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * LDS + n * 8 + 2 * t) =
        mma::pack_bf16(o[n][2] / l[1], o[n][3] / l[1]);
  }
  __syncwarp();
  bf16* out = static_cast<bf16*>(a.out);
  constexpr int CPR = D / 8;
#pragma unroll
  for (int idx = lane; idx < 16 * CPR; idx += 32) {
    const int r = idx / CPR, c = idx % CPR, row = w0 + r;
    if (row < a.Sq)
      *reinterpret_cast<uint4*>(
          out + ((static_cast<int64_t>(b) * a.Sq + row) * a.H + h) * D +
          c * 8) = *reinterpret_cast<const uint4*>(os + r * LDS + c * 8);
  }
}

template <int D>
cudaError_t fwd_f32(const Args& a, cudaStream_t st) {
  constexpr int LDS = D + 4;
  const size_t smem =
      sizeof(float) * (3 * kTile * LDS + kTile * kPS + 2 * kTile);
  const dim3 grid((a.Sq + kTile - 1) / kTile, a.B * a.H);
  return launch(flash_fwd_kernel<D>, grid, smem, st, a);
}

// the bf16 kernel's shared memory: the Q tile and two stages of K and V,
// rows of D + 8 bf16
template <int D>
constexpr size_t bf16_smem() {
  return sizeof(__nv_bfloat16) * (kRowsQ + 4 * kTile) * (D + 8);
}

template <int D>
cudaError_t fwd_bf16(const Args& a, cudaStream_t st) {
  const dim3 grid((a.Sq + kRowsQ - 1) / kRowsQ, a.B * a.H);
  return launch(flash_fwd_mma_kernel<D>, grid, bf16_smem<D>(), st, a);
}

template <int D>
cudaError_t bf16_occupancy(int* ctas, int* smem) {
  *smem = static_cast<int>(bf16_smem<D>());
  cudaError_t e = allow_smem(flash_fwd_mma_kernel<D>, bf16_smem<D>());
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, flash_fwd_mma_kernel<D>, kThreads, bf16_smem<D>());
}

}  // namespace

// q, k, v (B, S, H, D) with strides (sb, ss, sh, 1), k and v sharing
// theirs; o contiguous (B, Sq, H, D) in the input dtype; lse fp32
// (B, H, Sq). bf16 also needs the alignment of mma_aligned. Returns the
// launch's cudaError_t (0 = launched).
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
      return static_cast<int>(D == 64 ? fwd_f32<64>(a, st)
                                      : fwd_f32<128>(a, st));
    case ptt::kBFloat16:
      if (!mma_aligned(a, a.out))
        return static_cast<int>(cudaErrorInvalidValue);
      return static_cast<int>(D == 64 ? fwd_bf16<64>(a, st)
                                      : fwd_bf16<128>(a, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16 kernel at head dim D: how many of its CTAs one SM holds, as
// the CUDA runtime computes it from the kernel's registers and shared
// memory, into *ctas, and its dynamic shared memory in bytes into *smem.
extern "C" int ptt_flash_fwd_occupancy(int D, int* ctas, int* smem) {
  switch (D) {
    case 64:
      return static_cast<int>(bf16_occupancy<64>(ctas, smem));
    case 128:
      return static_cast<int>(bf16_occupancy<128>(ctas, smem));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
