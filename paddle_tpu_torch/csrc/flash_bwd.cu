// K3: flash attention backward for Hopper (sm_90a).
//
// Replaces the TPU backward kernels of paddle_tpu/ops/pallas/
// flash_attention.py:
//  - K3a _bwd_fused_kernel (:362, via _flash_bwd :516, max(Sq, Sk) <=
//    8192): ptt_flash_bwd_fused, the dK/dV body with dQ;
//  - K3b _bwd_dkv_stream_kernel (:162) and _bwd_dq_stream_kernel (:215)
//    (via _flash_bwd_stream :436, beyond 8192): ptt_flash_bwd_dkv, the
//    dK/dV body without dQ, and ptt_flash_bwd_dq, the dQ body.
// The wrapper keeps JAX's route (_use_streaming, 8192), so each TPU
// kernel's counterpart runs where JAX runs it. On the H100 the choice is
// between fp32 atomics (fused) and a deterministic two-pass split
// (streaming), not a VMEM limit.
//
// Per (query tile, key tile) pair every body recomputes, from the saved
// lse and delta = rowsum(dO * O) (computed by the wrapper in torch, as
// JAX does in XLA, :522):
//   S = Q K^T * scale (masked top-left causal, row >= col),
//   P = exp(S - lse),  dP = dO V^T,  dS = P * (dP - delta) * scale,
// and accumulates dV += P^T dO, dK += dS^T Q (and dQ += dS K) in fp32,
// with P and dS rounded to the input dtype before those products (:408,
// :417, :422). The dK/dV bodies own one 64-row key tile of one (batch,
// head) and sweep the query tiles from the causal diagonal on, writing
// dK and dV once; with dQ they add each tile's dQ into a zeroed fp32
// (B, Sq, H, D) buffer by atomics (the wrapper casts it): K3a's fp32 dQ
// output, which on the TPU stayed resident across the key-block grid
// axis. The atomics make dQ's last bits differ from run to run.
// The dQ bodies own one 64-row query tile and sweep the key tiles up to
// the diagonal with dQ in fp32 registers, written once (no atomics: the
// streaming dQ is the same from run to run).
//
// Bound on the H100: operations. The backward does 2.5x the forward's
// products (64.4 GFLOP per layer at the training shape: B 16, S 1024,
// H 12, D 64, causal) over about twice its bytes: 65 us at the bf16
// tensor-core peak against ~30 us of bytes; in fp32 on the CUDA cores
// ~0.96 ms at 67 TFLOP/s. The dQ pass alone does 1.5x the forward's
// products (S, dP and dS K) over 5 tensors' bytes, also bound by
// operations: 26.6 GFLOP at S 8320 (B 1, H 2, D 64, causal), 27 us at
// 989 TFLOP/s against 3 us for its 10.6 MB.
//
// bf16 dK/dV body, flash_bwd_mma_kernel<D, WITH_DQ>: every product on
// the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate;
// flash_mma.cuh). A CTA of 4 warps owns 64 keys, 16 per warp; two CTAs
// share an SM. K and V are staged once by cp.async; at D 64 each warp
// then holds its 16 rows of both as A fragments in registers for the
// whole sweep. At D 128 the dK/dV accumulators alone take 128 registers,
// so the fragments are re-read from shared memory at each use and a
// tile's queries go in 16-query chunks (32 at D 64) in a loop that is
// not unrolled: that body uses 253-255 registers and spills none. Q, dO
// and the tile's
// lse and delta rows stream through a two-stage cp.async ring, tile
// j + 1 issued before tile j's math. The products run transposed, so
// P^T and dS^T never leave registers for dK and dV: per query chunk
// a warp computes S^T = K_w Q^T and dP^T = V_w dO^T (Q and dO rows by
// ldmatrix as B fragments), P^T and dS^T on the accumulators (lse and
// delta read per accumulator column), and then dV_w += P^T dO and
// dK_w += dS^T Q with two n8 accumulator tiles, rounded to bf16, as the
// k16 A fragment (pack_a; dO and Q by ldmatrix.trans). dQ sums over the
// CTA's 64 keys, so with dQ each warp also stores its dS^T rows (bf16)
// into one shared tile; after a barrier the warps split the tile's 64
// queries, 16 each, compute dQ = dS K (dS by ldmatrix.trans from the
// key-major tile, at_x4; K by ldmatrix.trans) and add it into the fp32
// buffer by vector atomics (float2, sm_90). The barrier at the top of
// the next tile orders the dQ pass's reads of the dS tile and of the
// ring stage before their overwrite. Rows past Sq or Sk are zero-filled
// by cp.async, never read, and masked. Against the bound: the products
// run at tensor-core rates, and every input byte moves once per CTA in
// 16-byte chunks; what is left is latency at 8 warps an SM (one barrier
// a tile, two with dQ), the shared-memory reads of the B fragments (each
// warp reads the whole Q and dO tile, twice: as is and transposed), and
// with dQ the atomics.
//
// bf16 dQ body, flash_dq_mma_kernel<D>: the dK/dV body's mirror, in the
// natural orientation (queries on the accumulator rows). A CTA of 4
// warps owns 64 queries of one (batch, head), 16 per warp; two CTAs
// share an SM (at S 8320, B 1, H 2: 260 CTAs on 264 slots, one wave).
// Q and dO are staged once by cp.async, and each warp then holds its 16
// rows of both as A fragments for the whole sweep (at D 128, beside the
// 64 dQ accumulators, that takes 254 registers, no spill, and still
// beats re-reading them from shared memory at each use: k3_variants.py).
// Each lane reads the lse and delta of its two rows once into registers.
// K and V stream through a two-stage cp.async ring, key tile j + 1
// issued before tile j's math, one barrier a tile. Per key tile a warp
// computes S = Q_w K^T and dP = dO_w V^T (K and V rows by ldmatrix as B
// fragments), P = exp2(S scale log2 e - lse log2 e) and dS = P (dP -
// delta) scale on the accumulators (the mask test only on the diagonal
// and Sk-edge tiles), and dQ_w += dS K with dS rounded to bf16 and
// packed as the k16 A fragment (pack_a; K by ldmatrix.trans).
// No shared dS tile, no atomics: the warp writes its 16 dQ rows once as
// bf16 pairs. Under causal masking the CTAs of the longest sweeps launch
// first. Rows past Sq or Sk are zero-filled by cp.async, never read; keys
// past Sk are masked, rows past Sq never stored. Against the bound: the
// three products run at tensor-core rates, each K and V byte moves once
// per query tile in 16-byte chunks; what is left is latency at 8 warps an
// SM and the shared-memory reads of the K and V fragments (each warp
// reads K twice, as is and transposed, and V once).
//
// fp32: the CUDA-core bodies, products in fp32 on register micro-tiles
// fed by float4 shared-memory reads (no TF32: the fp32 contract is 1e-4
// of the plain version).
#include "flash_common.cuh"
#include "flash_mma.cuh"

namespace {

using namespace ptt;
using namespace ptt::flash;

// P and dS (fp32) of one (query tile q0, key tile k0) pair into shared
// memory. Thread (ty, tx) computes rows ty + 16i, keys tx + 16j.
template <int D, int LDS>
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
      if (ps != nullptr) ps[r * kPS + c] = p;
      dss[r * kPS + c] = ds;
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

// fp32 dK/dV body on the CUDA cores (with WITH_DQ, K3a's dQ too).
template <int D, bool WITH_DQ>
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
  const float* q = static_cast<const float*>(a.q);
  const float* dout = static_cast<const float*>(a.dout);
  const int64_t o_ss = static_cast<int64_t>(a.H) * D;  // dO is contiguous

  load_tile<D, LDS>(ks, static_cast<const float*>(a.k), b, h, k0, a.Sk,
                    a.kv_sb, a.kv_ss, a.kv_sh);
  load_tile<D, LDS>(vs, static_cast<const float*>(a.v), b, h, k0, a.Sk,
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
    load_tile<D, LDS>(qs, q, b, h, q0, a.Sq, a.q_sb, a.q_ss, a.q_sh);
    load_tile<D, LDS>(dos, dout, b, h, q0, a.Sq, a.Sq * o_ss, o_ss, D);
    load_rows(lse_s, a.lse, bh, q0, a.Sq);
    load_rows(delta_s, a.delta, bh, q0, a.Sq);
    __syncthreads();
    p_and_ds<D, LDS>(a, qs, dos, ks, vs, lse_s, delta_s, ps, dss, q0, k0, ty,
                     tx);
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

  float* dk_out = static_cast<float*>(a.dk);
  float* dv_out = static_cast<float*>(a.dv);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= a.Sk) continue;
    const int64_t off = ((static_cast<int64_t>(b) * a.Sk + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk_out[off + tx + 16 * j] = dk[i][j];
      dv_out[off + tx + 16 * j] = dv[i][j];
    }
  }
}

constexpr int kMmaThreads = 128;  // bf16 K3 bodies: 4 warps x 16 rows
constexpr float kLog2e = 1.4426950408889634f;

// the bf16 body's shared memory: K, V, two ring stages of Q and dO (rows
// of D + 8 bf16), two stages of lse and delta, and with dQ the dS^T tile
// (64 key rows of 64 + 8 bf16)
template <int D, bool WITH_DQ>
constexpr size_t mma_smem() {
  return sizeof(__nv_bfloat16) *
             (6 * kTile * (D + 8) + (WITH_DQ ? kTile * (kTile + 8) : 0)) +
         sizeof(float) * 4 * kTile;
}

template <int D, bool WITH_DQ>
__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_bwd_mma_kernel(const Args a) {
  using mma::bf16;
  constexpr int LDS = D + 8;       // row stride of K, V, Q, dO
  constexpr int LDP = kTile + 8;   // row stride of the dS^T tile
  constexpr int TILE = kTile * LDS;
  constexpr int KD = D / 16;       // k16 steps over the head dim
  constexpr int ND = D / 8;        // n8 tiles over the head dim
  constexpr int QC = D == 64 ? 32 : 16;  // queries per chunk of a tile
  constexpr int NC = QC / 8;       // n8 tiles over a chunk's queries
  constexpr bool HOLD = D == 64;   // K and V fragments held in registers
  constexpr int DQC = 64;          // dQ columns per pass
  extern __shared__ float4 smem4[];
  bf16* ks = reinterpret_cast<bf16*>(smem4);
  bf16* vs = ks + TILE;
  bf16* qs = vs + TILE;     // 2 stages
  bf16* dos = qs + 2 * TILE;  // 2 stages
  float* lse_s = reinterpret_cast<float*>(dos + 2 * TILE);  // 2 stages
  float* delta_s = lse_s + 2 * kTile;                       // 2 stages
  bf16* dss = reinterpret_cast<bf16*>(delta_s + 2 * kTile);  // with dQ

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = blockIdx.x * kTile, kw = k0 + warp * 16;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.kv_sb + h * a.kv_sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.kv_sb + h * a.kv_sh;
  const int64_t o_ss = static_cast<int64_t>(a.H) * D;  // dO is contiguous
  const bf16* dout = static_cast<const bf16*>(a.dout) +
                     static_cast<int64_t>(b) * a.Sq * o_ss + h * D;
  const float* lse = a.lse + static_cast<int64_t>(bh) * a.Sq;
  const float* delta = a.delta + static_cast<int64_t>(bh) * a.Sq;
  // causal (top-left): rows before k0 see none of these keys, and query
  // and key tiles are the same height, so the sweep starts at tile k0/64
  const int q_first = a.causal ? k0 : 0;
  const int n_tiles =
      q_first < a.Sq ? (a.Sq - q_first + kTile - 1) / kTile : 0;
  const float scale_l2 = a.scale * kLog2e;

  // one commit group: query tile j's Q, dO, lse and delta into stage j % 2
  // (a tile wholly past Sq is all zero-fill)
  const auto stage_tile = [&](int j) {
    const int st = j & 1, r0 = q_first + j * kTile;
    mma::tile_async<kTile, D, LDS, kMmaThreads>(qs + st * TILE, q, r0, a.Sq,
                                                a.q_ss);
    mma::tile_async<kTile, D, LDS, kMmaThreads>(dos + st * TILE, dout, r0,
                                                a.Sq, o_ss);
    mma::rows_async<kTile>(lse_s + st * kTile, lse, r0, a.Sq);
    mma::rows_async<kTile>(delta_s + st * kTile, delta, r0, a.Sq);
    mma::cp_async_commit();
  };

  // groups in flight: K and V, then query tile 0
  mma::tile_async<kTile, D, LDS, kMmaThreads>(ks, k, k0, a.Sk, a.kv_ss);
  mma::tile_async<kTile, D, LDS, kMmaThreads>(vs, v, k0, a.Sk, a.kv_ss);
  mma::cp_async_commit();
  stage_tile(0);
  mma::cp_async_wait<1>();
  __syncthreads();
  uint32_t kf[HOLD ? KD : 1][4], vf[HOLD ? KD : 1][4];
  if constexpr (HOLD) {
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      mma::ldsm_x4(kf[kd], mma::a_x4<LDS>(ks, warp * 16, kd * 16, lane));
      mma::ldsm_x4(vf[kd], mma::a_x4<LDS>(vs, warp * 16, kd * 16, lane));
    }
  }

  // this lane's keys: kw + g (accumulator entries 0, 1) and kw + g + 8
  // (2, 3); dims n * 8 + 2t (+1)
  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int q0 = q_first + j * kTile;
    const int st = j & 1;
    const bf16* qt = qs + st * TILE;
    const bf16* dt = dos + st * TILE;
    const float* lt = lse_s + st * kTile;
    const float* delt = delta_s + st * kTile;
    // tile j has landed; every warp is done with tile j - 1: with its
    // ring stage, which tile j + 1's copies now refill, and with the dS
    // tile, which this tile's dS^T overwrites
    mma::cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < n_tiles) stage_tile(j + 1);
    // the causal diagonal and the ragged edges take the mask test
    const bool edge = (a.causal && q0 < k0 + kTile) || q0 + kTile > a.Sq ||
                      k0 + kTile > a.Sk;
    // at D 128 the chunks stay a loop: unrolled, they spill
#pragma unroll(D == 64 ? kTile / QC : 1)
    for (int c = 0; c < kTile; c += QC) {
      // S^T = K_w Q^T and dP^T = V_w dO^T over this chunk's queries
      float s[NC][4], dp[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
        uint32_t ka[4], va[4];
        if constexpr (HOLD) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            ka[i] = kf[kd][i];
            va[i] = vf[kd][i];
          }
        } else {
          mma::ldsm_x4(ka, mma::a_x4<LDS>(ks, warp * 16, kd * 16, lane));
          mma::ldsm_x4(va, mma::a_x4<LDS>(vs, warp * 16, kd * 16, lane));
        }
#pragma unroll
        for (int n = 0; n < NC; n += 2) {
          uint32_t bq[4], bd[4];
          mma::ldsm_x4(bq, mma::b_x4<LDS>(qt, c + n * 8, kd * 16, lane));
          mma::mma_bf16(s[n], ka, bq[0], bq[1]);
          mma::mma_bf16(s[n + 1], ka, bq[2], bq[3]);
          mma::ldsm_x4(bd, mma::b_x4<LDS>(dt, c + n * 8, kd * 16, lane));
          mma::mma_bf16(dp[n], va, bd[0], bd[1]);
          mma::mma_bf16(dp[n + 1], va, bd[2], bd[3]);
        }
      }
      // P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) scale,
      // lse and delta per accumulator column: queries q0 + c + 8n + 2t
      // (entries 0, 2) and + 1 (entries 1, 3)
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int col = c + n * 8 + 2 * t;
        const float2 l2 = *reinterpret_cast<const float2*>(lt + col);
        const float2 d2 = *reinterpret_cast<const float2*>(delt + col);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float lse_c = e % 2 ? l2.y : l2.x;
          const float delta_c = e % 2 ? d2.y : d2.x;
          float p = exp2f(s[n][e] * scale_l2 - lse_c * kLog2e);
          if (edge) {
            const int row = q0 + col + e % 2, key = kw + g + (e / 2) * 8;
            if (row >= a.Sq || key >= a.Sk || (a.causal && row < key))
              p = 0.f;
          }
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - delta_c) * a.scale;
        }
      }
      // dV_w += P^T dO and dK_w += dS^T Q: two n8 tiles of P^T (dS^T),
      // rounded to bf16 (P to dO's dtype :408, dS to Q's :417), are one
      // k16 A fragment
#pragma unroll
      for (int kk = 0; kk < NC / 2; ++kk) {
        uint32_t pa[4], da[4];
        mma::pack_a(pa, s[2 * kk], s[2 * kk + 1]);
        mma::pack_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < ND; n += 2) {
          uint32_t bf[4];
          mma::ldsm_x4_trans(bf, mma::bt_x4<LDS>(dt, c + kk * 16, n * 8, lane));
          mma::mma_bf16(dv[n], pa, bf[0], bf[1]);
          mma::mma_bf16(dv[n + 1], pa, bf[2], bf[3]);
          mma::ldsm_x4_trans(bf, mma::bt_x4<LDS>(qt, c + kk * 16, n * 8, lane));
          mma::mma_bf16(dk[n], da, bf[0], bf[1]);
          mma::mma_bf16(dk[n + 1], da, bf[2], bf[3]);
        }
        if constexpr (WITH_DQ) {
          // dS^T in bf16 (K's dtype, :422) into the tile: key rows,
          // query columns
          bf16* r = dss + (warp * 16 + g) * LDP + c + kk * 16 + 2 * t;
          *reinterpret_cast<uint32_t*>(r) = da[0];
          *reinterpret_cast<uint32_t*>(r + 8 * LDP) = da[1];
          *reinterpret_cast<uint32_t*>(r + 8) = da[2];
          *reinterpret_cast<uint32_t*>(r + 8 * LDP + 8) = da[3];
        }
      }
    }
    if constexpr (WITH_DQ) {
      // every warp's dS^T rows are in the tile
      __syncthreads();
      // dQ = dS K over the CTA's 64 keys for this warp's 16 queries,
      // q0 + 16 warp + g (entries 0, 1) and + 8 (2, 3), DQC dims a pass
      float* dq_acc = static_cast<float*>(a.out);
#pragma unroll
      for (int dc = 0; dc < D; dc += DQC) {
        float dq[DQC / 8][4];
#pragma unroll
        for (int n = 0; n < DQC / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          uint32_t sa[4];
          mma::ldsm_x4_trans(sa,
                             mma::at_x4<LDP>(dss, warp * 16, kk * 16, lane));
#pragma unroll
          for (int n = 0; n < DQC / 8; n += 2) {
            uint32_t bf[4];
            mma::ldsm_x4_trans(bf,
                               mma::bt_x4<LDS>(ks, kk * 16, dc + n * 8, lane));
            mma::mma_bf16(dq[n], sa, bf[0], bf[1]);
            mma::mma_bf16(dq[n + 1], sa, bf[2], bf[3]);
          }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int row = q0 + warp * 16 + g + 8 * i;
          if (row >= a.Sq) continue;
          float* dqr = dq_acc +
                       ((static_cast<int64_t>(b) * a.Sq + row) * a.H + h) * D +
                       dc + 2 * t;
#pragma unroll
          for (int n = 0; n < DQC / 8; ++n)
            atomicAdd(reinterpret_cast<float2*>(dqr + n * 8),
                      make_float2(dq[n][2 * i], dq[n][2 * i + 1]));
        }
      }
    }
  }

  bf16* dk_out = static_cast<bf16*>(a.dk);
  bf16* dv_out = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = kw + g + 8 * i;
    if (key >= a.Sk) continue;
    const int64_t off =
        ((static_cast<int64_t>(b) * a.Sk + key) * a.H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(dk_out + off + n * 8) =
          mma::pack_bf16(dk[n][2 * i], dk[n][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dv_out + off + n * 8) =
          mma::pack_bf16(dv[n][2 * i], dv[n][2 * i + 1]);
    }
  }
}

// fp32 dQ pass on the CUDA cores.
template <int D>
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
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const int64_t o_ss = static_cast<int64_t>(a.H) * D;

  load_tile<D, LDS>(qs, static_cast<const float*>(a.q), b, h, q0, a.Sq,
                    a.q_sb, a.q_ss, a.q_sh);
  load_tile<D, LDS>(dos, static_cast<const float*>(a.dout), b, h, q0, a.Sq,
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
    load_tile<D, LDS>(ks, k, b, h, k0, a.Sk, a.kv_sb, a.kv_ss, a.kv_sh);
    load_tile<D, LDS>(vs, v, b, h, k0, a.Sk, a.kv_sb, a.kv_ss, a.kv_sh);
    __syncthreads();
    p_and_ds<D, LDS>(a, qs, dos, ks, vs, lse_s, delta_s, nullptr, dss, q0,
                     k0, ty, tx);
    __syncthreads();
    add_ds_k<D, LDS>(dq, dss, ks, ty, tx);
    __syncthreads();
  }

  float* dq_out = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= a.Sq) continue;
    float* dqr = dq_out + ((static_cast<int64_t>(b) * a.Sq + row) * a.H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) dqr[tx + 16 * j] = dq[i][j];
  }
}

// the bf16 dQ body's shared memory: Q and dO, and two ring stages of K
// and V, rows of D + 8 bf16
template <int D>
constexpr size_t dq_mma_smem() {
  return sizeof(__nv_bfloat16) * 6 * kTile * (D + 8);
}

template <int D>
__global__ void __launch_bounds__(kMmaThreads, 2)
    flash_dq_mma_kernel(const Args a) {
  using mma::bf16;
  constexpr int LDS = D + 8;       // row stride of Q, dO, K, V
  constexpr int TILE = kTile * LDS;
  constexpr int KD = D / 16;       // k16 steps over the head dim
  constexpr int ND = D / 8;        // n8 tiles over the head dim
  constexpr int KC = 64;           // keys per chunk of a key tile
  constexpr int NC = KC / 8;       // n8 tiles over a chunk's keys
  extern __shared__ float4 smem4[];
  bf16* qs = reinterpret_cast<bf16*>(smem4);
  bf16* dos = qs + TILE;
  bf16* ks = dos + TILE;     // 2 stages
  bf16* vs = ks + 2 * TILE;  // 2 stages

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  // causal: the last query tiles sweep the most keys; launch them first
  const int tile = a.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = tile * kTile, w0 = q0 + warp * 16;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const bf16* q = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* k = static_cast<const bf16*>(a.k) + b * a.kv_sb + h * a.kv_sh;
  const bf16* v = static_cast<const bf16*>(a.v) + b * a.kv_sb + h * a.kv_sh;
  const int64_t o_ss = static_cast<int64_t>(a.H) * D;  // dO is contiguous
  const bf16* dout = static_cast<const bf16*>(a.dout) +
                     static_cast<int64_t>(b) * a.Sq * o_ss + h * D;
  // causal (top-left): keys past the tile's last row are dead
  const int k_end = a.causal ? min(q0 + kTile, a.Sk) : a.Sk;
  const int n_tiles = (k_end + kTile - 1) / kTile;
  const float scale_l2 = a.scale * kLog2e;

  // one commit group: key tile j's K and V into stage j % 2
  const auto stage_kv = [&](int j) {
    const int st = j & 1;
    mma::tile_async<kTile, D, LDS, kMmaThreads>(ks + st * TILE, k, j * kTile,
                                                a.Sk, a.kv_ss);
    mma::tile_async<kTile, D, LDS, kMmaThreads>(vs + st * TILE, v, j * kTile,
                                                a.Sk, a.kv_ss);
    mma::cp_async_commit();
  };

  // groups in flight: Q and dO, then key tile 0
  mma::tile_async<kTile, D, LDS, kMmaThreads>(qs, q, q0, a.Sq, a.q_ss);
  mma::tile_async<kTile, D, LDS, kMmaThreads>(dos, dout, q0, a.Sq, o_ss);
  mma::cp_async_commit();
  stage_kv(0);
  // this lane's rows, w0 + g (accumulator entries 0, 1) and w0 + g + 8
  // (2, 3), never change: their lse (times log2 e) and delta are read
  // once (a row past Sq reads row Sq - 1 and is never stored)
  const float* lse = a.lse + static_cast<int64_t>(bh) * a.Sq;
  const float* delta = a.delta + static_cast<int64_t>(bh) * a.Sq;
  float lse_l2[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = min(w0 + g + 8 * i, a.Sq - 1);
    lse_l2[i] = lse[row] * kLog2e;
    delta_r[i] = delta[row];
  }
  mma::cp_async_wait<1>();
  __syncthreads();
  // this warp's 16 rows of Q and dO as A fragments, for the whole sweep
  uint32_t qf[KD][4], df[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd) {
    mma::ldsm_x4(qf[kd], mma::a_x4<LDS>(qs, warp * 16, kd * 16, lane));
    mma::ldsm_x4(df[kd], mma::a_x4<LDS>(dos, warp * 16, kd * 16, lane));
  }

  // dims n * 8 + 2t (+1) of this lane's two rows
  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile, st = j & 1;
    const bf16* kt = ks + st * TILE;
    const bf16* vt = vs + st * TILE;
    // key tile j has landed; every warp is done with tile j - 1, whose
    // stage tile j + 1's copies now refill
    mma::cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < n_tiles) stage_kv(j + 1);
    // the causal diagonal and the Sk edge take the mask test
    const bool edge =
        (a.causal && k0 + kTile - 1 > w0) || k0 + kTile > a.Sk;
#pragma unroll
    for (int c = 0; c < kTile; c += KC) {
      // S = Q_w K^T and dP = dO_w V^T over this chunk's keys
      float s[NC][4], dp[NC][4];
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kd = 0; kd < KD; ++kd) {
#pragma unroll
        for (int n = 0; n < NC; n += 2) {
          uint32_t bk[4], bv[4];
          mma::ldsm_x4(bk, mma::b_x4<LDS>(kt, c + n * 8, kd * 16, lane));
          mma::mma_bf16(s[n], qf[kd], bk[0], bk[1]);
          mma::mma_bf16(s[n + 1], qf[kd], bk[2], bk[3]);
          mma::ldsm_x4(bv, mma::b_x4<LDS>(vt, c + n * 8, kd * 16, lane));
          mma::mma_bf16(dp[n], df[kd], bv[0], bv[1]);
          mma::mma_bf16(dp[n + 1], df[kd], bv[2], bv[3]);
        }
      }
      // P = exp(S scale - lse) and dS = P (dP - delta) scale on the
      // accumulators: row w0 + g + 8 (e / 2), key k0 + c + 8n + 2t + e % 2
#pragma unroll
      for (int n = 0; n < NC; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = exp2f(s[n][e] * scale_l2 - lse_l2[e / 2]);
          if (edge) {
            const int row = w0 + g + (e / 2) * 8;
            const int key = k0 + c + n * 8 + 2 * t + e % 2;
            if (key >= a.Sk || (a.causal && row < key)) p = 0.f;
          }
          dp[n][e] = p * (dp[n][e] - delta_r[e / 2]) * a.scale;
        }
      // dQ_w += dS K: two n8 tiles of dS, rounded to bf16 (K's dtype,
      // :255), are one k16 A fragment; K by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < NC / 2; ++kk) {
        uint32_t sa[4];
        mma::pack_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int n = 0; n < ND; n += 2) {
          uint32_t bf[4];
          mma::ldsm_x4_trans(bf, mma::bt_x4<LDS>(kt, c + kk * 16, n * 8, lane));
          mma::mma_bf16(dq[n], sa, bf[0], bf[1]);
          mma::mma_bf16(dq[n + 1], sa, bf[2], bf[3]);
        }
      }
    }
  }

  // dQ in bf16 pairs, each row written once by its lane quad
  bf16* dq_out = static_cast<bf16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = w0 + g + 8 * i;
    if (row >= a.Sq) continue;
    const int64_t off =
        ((static_cast<int64_t>(b) * a.Sq + row) * a.H + h) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(dq_out + off + n * 8) =
          mma::pack_bf16(dq[n][2 * i], dq[n][2 * i + 1]);
  }
}

enum class Kind { kFused, kDkv, kDq };

template <int D>
cudaError_t dq_f32(const Args& a, cudaStream_t st) {
  constexpr int LDS = D + 4;
  const size_t smem =
      sizeof(float) * (4 * kTile * LDS + kTile * kPS + 2 * kTile);
  const dim3 grid((a.Sq + kTile - 1) / kTile, a.B * a.H);
  return launch(flash_dq_kernel<D>, grid, smem, st, a);
}

template <int D>
cudaError_t dq_bf16(const Args& a, cudaStream_t st) {
  const dim3 grid((a.Sq + kTile - 1) / kTile, a.B * a.H);
  return launch(flash_dq_mma_kernel<D>, grid, dq_mma_smem<D>(), st, a,
                kMmaThreads);
}

template <int D>
cudaError_t dkv_f32(const Args& a, bool fused, cudaStream_t st) {
  constexpr int LDS = D + 4;
  const size_t smem =
      sizeof(float) * (4 * kTile * LDS + 2 * kTile * kPS + 2 * kTile);
  const dim3 grid((a.Sk + kTile - 1) / kTile, a.B * a.H);
  return fused ? launch(flash_dkv_kernel<D, true>, grid, smem, st, a)
               : launch(flash_dkv_kernel<D, false>, grid, smem, st, a);
}

template <int D>
cudaError_t dkv_bf16(const Args& a, bool fused, cudaStream_t st) {
  const dim3 grid((a.Sk + kTile - 1) / kTile, a.B * a.H);
  return fused ? launch(flash_bwd_mma_kernel<D, true>, grid,
                        mma_smem<D, true>(), st, a, kMmaThreads)
               : launch(flash_bwd_mma_kernel<D, false>, grid,
                        mma_smem<D, false>(), st, a, kMmaThreads);
}

cudaError_t dispatch(const Args& a, int D, int dtype, Kind kind,
                     cudaStream_t st) {
  const bool d64 = D == 64;
  if (dtype == kFloat32) {
    if (kind == Kind::kDq) return d64 ? dq_f32<64>(a, st) : dq_f32<128>(a, st);
    const bool fused = kind == Kind::kFused;
    return d64 ? dkv_f32<64>(a, fused, st) : dkv_f32<128>(a, fused, st);
  }
  if (!mma_aligned(a, a.dout)) return cudaErrorInvalidValue;
  if (kind == Kind::kDq) return d64 ? dq_bf16<64>(a, st) : dq_bf16<128>(a, st);
  const bool fused = kind == Kind::kFused;
  return d64 ? dkv_bf16<64>(a, fused, st) : dkv_bf16<128>(a, fused, st);
}

int run(const Args& a, int D, int dtype, Kind kind, void* stream) {
  if (!valid_args(a, D) || (dtype != kFloat32 && dtype != kBFloat16))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(
      dispatch(a, D, dtype, kind, static_cast<cudaStream_t>(stream)));
}

// How many CTAs of a tensor-core body of kMmaThreads threads and `bytes`
// of dynamic shared memory one SM holds, as the CUDA runtime computes it
// from the kernel's registers and shared memory, into *ctas, and the
// bytes into *smem.
template <typename K>
cudaError_t mma_occupancy(K kern, size_t bytes, int* ctas, int* smem) {
  *smem = static_cast<int>(bytes);
  cudaError_t e = allow_smem(kern, bytes);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kern,
                                                       kMmaThreads, bytes);
}

}  // namespace

// Common arguments: q, k, v (B, S, H, D) with strides (sb, ss, sh, 1), k
// and v sharing theirs; dO contiguous (B, Sq, H, D); lse and delta fp32
// (B, H, Sq); dK, dV contiguous (B, Sk, H, D) in the input dtype. The
// bf16 dK/dV body also needs the alignment of mma_aligned (q, k, v, dO).
// Each returns the launch's cudaError_t (0 = launched).
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

// The bf16 dK/dV body at head dim D, with dQ (fused != 0, K3a) or without
// (K3b's first pass): how many of its CTAs one SM holds, as the CUDA
// runtime computes it from the kernel's registers and shared memory, into
// *ctas, and its dynamic shared memory in bytes into *smem.
extern "C" int ptt_flash_bwd_occupancy(int D, int fused, int* ctas,
                                       int* smem) {
  cudaError_t e = cudaErrorInvalidValue;
  if (D == 64)
    e = fused ? mma_occupancy(flash_bwd_mma_kernel<64, true>,
                              mma_smem<64, true>(), ctas, smem)
              : mma_occupancy(flash_bwd_mma_kernel<64, false>,
                              mma_smem<64, false>(), ctas, smem);
  else if (D == 128)
    e = fused ? mma_occupancy(flash_bwd_mma_kernel<128, true>,
                              mma_smem<128, true>(), ctas, smem)
              : mma_occupancy(flash_bwd_mma_kernel<128, false>,
                              mma_smem<128, false>(), ctas, smem);
  return static_cast<int>(e);
}

// The same for the bf16 dQ body (K3b's second pass) at head dim D.
extern "C" int ptt_flash_bwd_dq_occupancy(int D, int* ctas, int* smem) {
  cudaError_t e = cudaErrorInvalidValue;
  if (D == 64)
    e = mma_occupancy(flash_dq_mma_kernel<64>, dq_mma_smem<64>(), ctas, smem);
  else if (D == 128)
    e = mma_occupancy(flash_dq_mma_kernel<128>, dq_mma_smem<128>(), ctas,
                      smem);
  return static_cast<int>(e);
}
