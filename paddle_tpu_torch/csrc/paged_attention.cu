// K4: paged decode/verify attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// (_paged_kernel, reached through paged_attention_pallas), both branches:
// full-precision pools, and int8 code pools with (num_blocks, H) scales
// (:134-136). q (b, s <= 16, H, D) at per-slot offsets t (b,) attends its
// slot's KV through the block table; query row i reads cols <= t + i.
// Layouts are paged_common.cuh's.
//
// Bound on the H100: bytes. Decode reads each slot's committed K and V
// once (sum over slots of (t+1)*H*D*2 elements) and does ~4 flops per
// element read, far below the balance point; at the serving shape (8
// slots at t up to 1000, 12 heads) that is 0.0037 ms of bf16 bytes. What
// is left above it is latency: a slot's keys read in order by few CTAs.
//
// Two bodies, by q's type:
//
// bf16 q: paged_decode_mma_kernel, both products on the tensor cores
// (mma.sync m16n8k16, bf16 in, fp32 accumulate; flash_mma.cuh), over
// bf16 pools or int8 code pools.
//  - Grid (kSplits, b * H) in clusters of (kSplits, 1, 1): the kSplits
//    CTAs of a cluster split one (slot, head)'s key walk. One CTA per
//    (slot, head) would give 96 CTAs on 132 SMs at 8 slots, each walking
//    its slot's whole history (16 tiles at t 1000) alone; the cluster
//    gives 768, each walking at most 2. Each CTA reads t[slot] on the
//    device, takes the slot's reach, min(t + s - 1, bp * bs - 1), and its
//    T = reach / kTile + 1 tiles, and rank r takes tiles [r T / kSplits,
//    (r + 1) T / kSplits): every slot's walk splits evenly whatever its
//    length, and the host never reads t. A rank with no tiles still
//    takes part in both cluster barriers, its partial m = -1e30, l = 0.
//    Clusters of 8, the portable maximum: 4 is faster at 8 slots (its 384
//    CTAs are resident at once, where the card holds 77 clusters of 8,
//    616 of the 768) but slower for a lone request; 16 is slower at 8
//    slots (k4_variants.py, PERF.md).
//  - The s rows are one m16 tile: Q is staged once by cp.async (rows past
//    s zero-filled, never stored) and held as A fragments by every warp.
//    The warps split keys, not rows: warp w takes keys [w * kWarpKeys,
//    +kWarpKeys) of each tile, so S is two n8 products a k16 step and P
//    is one k16 A fragment of P.V. Each warp keeps its own m, l and o
//    (16 x D fp32 accumulators) and stages its own key rows through its
//    own 2-stage cp.async ring, so the walk needs no CTA barrier: the
//    ring waits are the warp's, ordered by __syncwarp.
//  - Key rows are gathered row by row through the table as K5's body
//    gathers them: 16-byte chunks of (table[col / bs] * bs + col % bs) *
//    H * D + h * D; rows past the reach are zero-filled from the address
//    of row `reach` (src-size 0). No row, table entry or scale past the
//    reach is ever read. A rank's keys end at the reach, so the reach mask
//    has keys to mask only where the table's end falls inside a warp's
//    slice (a table of blocks of no multiple of 16 rows).
//  - The online softmax runs on the accumulators in log2 units (a row's
//    max and sum over its quad by shuffles, scale * log2(e) folded into
//    exp2), P is packed to bf16 by pack_a, V read by ldmatrix.trans.
//    Masked logits are -1e30, never -inf (paged_attention.py:55); a warp
//    whose keys so far are all masked for a row keeps p = 0 there.
//  - Int8 pools: codes land at one byte an element beside one 4-byte
//    scale copy a key row; the warp turns its codes into a bf16 K slice
//    and an fp16 V slice, both exact (|code| <= 128). The k scale
//    multiplies S's column; the v scale goes into P before its rounding,
//    as p * vs / fv with fv the slice's largest v scale, so P lies in [0,
//    1]. That P is rounded to fp16, not bf16: a code times its scale
//    reaches the block's absmax, several times a unit-normal value, and
//    bf16's 8 bits of P times such values break 4e-3 + 1e-2 |O| (K5's
//    finding, tests/test_torch_chunk_layout.py); fp16 keeps 11. o
//    carries the fv of its last slice, so every warp (and every split)
//    holds o in a unit of its own: a partial's o is multiplied by its fv
//    before partials are added.
//  - The merge: each warp writes its rows' m, l and o * fv to shared
//    memory, the CTA folds its warps into one partial (m = max m_w, l =
//    sum l_w 2^(m_w - m), o likewise), then cluster.sync(), and rank r
//    merges every 8-column chunk whose index is r modulo kSplits from all
//    ranks' partials, read through distributed shared memory (no
//    workspace, counter, fence or second launch), into 16-byte bf16
//    stores. A second cluster.sync() follows the last remote read: no CTA
//    exits while another reads its shared memory.
//  - cp.async needs 16-byte aligned q, out and pools and pool rows of a
//    multiple of 16 bytes: the C entry refuses anything else
//    (cudaErrorInvalidValue).
//
// fp32 q: paged_f32_kernel (paged_common.cuh), on the CUDA cores in fp32
// (no TF32: the fp32 contract is 2e-5 of the plain version): the s rows
// are one 16-row tile of a (slot, head), its key walk split across a
// cluster as here, its products register-tiled; K5's fp32 q runs it too.
#include <cooperative_groups.h>

#include "flash_mma.cuh"
#include "paged_common.cuh"

namespace {

namespace cg = cooperative_groups;
using ptt::mma::bf16;

constexpr int kMaxRows = 16;  // query rows a slot: one 16-row tile

constexpr int kSplits = 8;     // bf16 body: CTAs of a cluster, one walk
constexpr int kTile = 64;      // keys of a tile, the unit split by rank
constexpr int kWarps = 4;
constexpr int kWarpKeys = 16;  // keys of a tile each warp takes
constexpr int kStages = 2;     // cp.async ring depth, a warp's
constexpr int kMmaThreads = 32 * kWarps;
constexpr float kLog2e = 1.4426950408889634f;

// The bf16 body's dynamic shared memory: the Q tile; a region per warp,
// its ring of K and V slices (kWarpKeys rows a stage; bf16 pools in rows
// of D + 8, int8 pools as codes in rows of D bytes with each row's two
// scales, plus the converted bf16 K and fp16 V slice), which holds the
// warp's partial o (kMaxRows x D fp32) once its walk is done; then m and
// l of each warp's rows and of the CTA's.
template <int D, typename TP>
struct DecodeSmem {
  static constexpr bool kCode = ptt::IsCode<TP>::value;
  static constexpr int LDS = D + 8;  // bf16 row stride: 16 bytes of padding
  static constexpr size_t ring =
      kCode ? 2 * kStages * kWarpKeys * (D + sizeof(float))
            : 2 * kStages * kWarpKeys * LDS * sizeof(bf16);
  static constexpr size_t conv = kCode ? 2 * kWarpKeys * LDS * sizeof(bf16)
                                       : 0;
  static constexpr size_t warp = ring + conv;
  static constexpr size_t q = kMaxRows * LDS * sizeof(bf16);
  static constexpr size_t bytes =
      q + kWarps * warp + (kWarps + 1) * 2 * kMaxRows * sizeof(float);
  static_assert(warp % 16 == 0 && q % 16 == 0, "16-byte aligned regions");
  static_assert(warp >= kMaxRows * D * sizeof(float),
                "a warp's partial o fits its ring");
};

template <int D, typename TP>
__global__ void __launch_bounds__(kMmaThreads)
    paged_decode_mma_kernel(const bf16* __restrict__ q,
                            const TP* __restrict__ kp,
                            const TP* __restrict__ vp,
                            const float* __restrict__ ksp,
                            const float* __restrict__ vsp,
                            const int* __restrict__ table,
                            const int* __restrict__ tv,
                            bf16* __restrict__ out, int s, int H, int bs,
                            int bp, float scale) {
  namespace mma = ptt::mma;
  using L = DecodeSmem<D, TP>;
  constexpr bool kCode = L::kCode;
  constexpr int LDS = L::LDS;
  constexpr int KD = D / 16;                // k16 steps of Q.K^T
  constexpr int ND = D / 8;                 // n8 tiles of the output
  constexpr int NS = kWarpKeys / 8;         // n8 tiles of a warp's scores
  constexpr int PLD = kCode ? D : LDS;      // row stride of a ring stage
  constexpr int CPR = D * sizeof(TP) / 16;  // 16-byte chunks a key row
  constexpr int EPC = 16 / sizeof(TP);      // elements a chunk
  constexpr int SL = kStages * kWarpKeys;   // key rows of a warp's ring
  static_assert(kWarpKeys * CPR % 32 == 0, "chunks must split evenly");
  extern __shared__ float4 smem4[];
  char* sm = reinterpret_cast<char*>(smem4);
  bf16* qs = reinterpret_cast<bf16*>(sm);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  char* wr = sm + L::q + warp * L::warp;    // this warp's region
  TP* kr = reinterpret_cast<TP*>(wr);       // SL rows of PLD
  TP* vr = kr + SL * PLD;
  float* ksc = reinterpret_cast<float*>(vr + SL * PLD);  // int8 pools
  float* vsc = ksc + SL;
  bf16* kc = reinterpret_cast<bf16*>(vsc + SL);  // converted K (int8)
  bf16* vc = kc + kWarpKeys * LDS;               // converted V, fp16 bits
  float* wm = reinterpret_cast<float*>(sm + L::q + kWarps * L::warp);
  float* wl = wm + kWarps * kMaxRows;       // each warp's rows' m, l
  float* pm = wl + kWarps * kMaxRows;       // the CTA's partial m, l
  float* pl = pm + kMaxRows;
  float* po = reinterpret_cast<float*>(sm + L::q);  // and o, over warp 0's

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int slot = blockIdx.y / H, h = blockIdx.y % H;
  const int64_t rs = static_cast<int64_t>(H) * D;  // row stride, elements
  const int t0 = tv[slot];                          // position of row 0
  const int reach = min(t0 + s - 1, bp * bs - 1);
  const int n_tiles = reach / kTile + 1;
  // this rank's tiles: an even share of the slot's, whatever its length
  const int tile_lo = rank * n_tiles / kSplits,
            tile_hi = (rank + 1) * n_tiles / kSplits;
  const int k_lo = tile_lo * kTile, k_hi = min(tile_hi * kTile, reach + 1);
  // the rank's keys in slices of kWarpKeys; warp w takes slices w, w +
  // kWarps, ... (with 16 keys a slice, its quarter of every tile)
  const int n_slices =
      k_hi > k_lo ? (k_hi - k_lo + kWarpKeys - 1) / kWarpKeys : 0;
  const int n_mine =
      n_slices > warp ? (n_slices - warp + kWarps - 1) / kWarps : 0;
  const int* trow = table + static_cast<int64_t>(slot) * bp;

  // the warp's slice u (the rank's slice warp + u * kWarps) into stage st
  auto stage_slice = [&](int u, int st) {
    const int k0 = k_lo + (warp + u * kWarps) * kWarpKeys;
#pragma unroll
    for (int x = 0; x < kWarpKeys * CPR / 32; ++x) {
      const int idx = lane + x * 32, r = idx / CPR, c = idx % CPR;
      const int col = k0 + r, cl = min(col, reach);
      const int64_t off =
          (static_cast<int64_t>(trow[cl / bs]) * bs + cl % bs) * rs + h * D +
          c * EPC;
      const int at = (st * kWarpKeys + r) * PLD + c * EPC;
      mma::cp_async_16(kr + at, kp + off, col <= reach);
      mma::cp_async_16(vr + at, vp + off, col <= reach);
    }
    if constexpr (kCode) {  // k scales, then v scales, one a key row
#pragma unroll
      for (int x = lane; x < 2 * kWarpKeys; x += 32) {
        const int r = x % kWarpKeys, col = k0 + r, cl = min(col, reach);
        const int64_t at = static_cast<int64_t>(trow[cl / bs]) * H + h;
        if (x < kWarpKeys)
          mma::cp_async_4(ksc + st * kWarpKeys + r, ksp + at, col <= reach);
        else
          mma::cp_async_4(vsc + st * kWarpKeys + r, vsp + at, col <= reach);
      }
    }
  };

  // groups in flight: Q, then the warp's slices 0 .. kStages - 2 (one
  // group each, empty past its last, so the count stays fixed)
  mma::tile_async<kMaxRows, D, LDS, kMmaThreads>(
      qs, q + static_cast<int64_t>(slot) * s * rs + h * D, 0, s, rs);
  mma::cp_async_commit();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_mine) stage_slice(st, st);
    mma::cp_async_commit();
  }
  mma::cp_async_wait<kStages - 1>();
  __syncthreads();  // Q has landed, every thread's share of it
  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    mma::ldsm_x4(qf[kd], mma::a_x4<LDS>(qs, 0, kd * 16, lane));

  // this thread's rows: g (i = 0) and g + 8 (i = 1); m in log2 units
  const float scale_l2 = scale * kLog2e;
  float m[2] = {ptt::kMaskedLogit, ptt::kMaskedLogit}, l[2] = {0.f, 0.f};
  // int8 pools: o holds O * l / f, f the v scale it was last put in
  float f = 1.f;
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int u = 0; u < n_mine; ++u) {
    const int st = u % kStages;
    const int k0 = k_lo + (warp + u * kWarps) * kWarpKeys;
    // slice u has landed; the warp is done with slice u - 1, whose stage
    // (and, over int8 pools, the converted slice) may be refilled
    mma::cp_async_wait<kStages - 2>();
    __syncwarp();
    if (u + kStages - 1 < n_mine)
      stage_slice(u + kStages - 1, (u + kStages - 1) % kStages);
    mma::cp_async_commit();
    const bf16* kt = kc;  // the slice as bf16 K and V rows of LDS
    const bf16* vt = vc;
    if constexpr (!kCode) {
      kt = reinterpret_cast<const bf16*>(kr) + st * kWarpKeys * LDS;
      vt = reinterpret_cast<const bf16*>(vr) + st * kWarpKeys * LDS;
    } else {
      // codes -> bf16 (K) and fp16 (V), 16 a chunk: exact, |code| <= 128
      constexpr int CC = D / 16;
#pragma unroll
      for (int x = 0; x < kWarpKeys * CC / 32; ++x) {
        const int idx = lane + x * 32, r = idx / CC, c = idx % CC;
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const int4 raw = *reinterpret_cast<const int4*>(
              (y ? vr : kr) + (st * kWarpKeys + r) * D + c * 16);
          const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
          uint32_t w[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float lo = b[2 * e], hi = b[2 * e + 1];
            w[e] = y ? mma::pack_f16(lo, hi) : mma::pack_bf16(lo, hi);
          }
          uint4* dst = reinterpret_cast<uint4*>((y ? vc : kc) + r * LDS +
                                                c * 16);
          dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
          dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
        }
      }
      __syncwarp();
    }
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
    for (int kd = 0; kd < KD; ++kd)
#pragma unroll
      for (int n = 0; n < NS; n += 2) {
        uint32_t kf[4];
        mma::ldsm_x4(kf, mma::b_x4<LDS>(kt, n * 8, kd * 16, lane));
        mma::mma_bf16(sc[n], qf[kd], kf[0], kf[1]);
        mma::mma_bf16(sc[n + 1], qf[kd], kf[2], kf[3]);
      }
    // slices wholly at or below row 0's position and inside the reach
    // skip the test
    const bool edge =
        k0 + kWarpKeys - 1 > t0 || k0 + kWarpKeys - 1 > reach;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + e % 2;  // key of the slice
        float x = sc[n][e] * scale_l2;
        if constexpr (kCode) x *= ksc[st * kWarpKeys + c];
        if (edge) {
          const int pos = t0 + g + (e / 2) * 8, col = k0 + c;
          if (col > pos || col > reach) x = ptt::kMaskedLogit;
        }
        sc[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    // int8 pools: p * vs[blk(j)] / fv, fv the slice's largest v scale,
    // lies in [0, 1], where fp16 keeps 11 bits; o moves from units of f
    // to units of fv with the softmax's rescale
    float inv_fv = 1.f, rescale = 1.f;
    if constexpr (kCode) {
      float v = vsc[st * kWarpKeys + lane % kWarpKeys];
#pragma unroll
      for (int r = lane + 32; r < kWarpKeys; r += 32)
        v = fmaxf(v, vsc[st * kWarpKeys + r]);
      float fv = ptt::warp_max(v);
      if (fv == 0.f) fv = f;  // every v of the slice is 0: P.V adds 0
      inv_fv = 1.f / fv;
      rescale = f * inv_fv;
      f = fv;
    }
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f(m[i] - mx[i]);
      m[i] = mx[i];
      l[i] *= alpha[i];  // this lane's partial sum; quads add at the end
    }
    // a row whose keys so far are all masked keeps m = -1e30 and p = 0;
    // past its first real logit a masked one gives exp2(-1e30 - m) = 0
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = m[e / 2] == ptt::kMaskedLogit
                            ? 0.f
                            : exp2f(sc[n][e] - m[e / 2]);
        l[e / 2] += p;
        sc[n][e] = p;
        if constexpr (kCode)
          sc[n][e] *= vsc[st * kWarpKeys + n * 8 + 2 * t + e % 2] * inv_fv;
      }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e / 2] * rescale;
    // O += P.V, P rounded to bf16 (int8 pools: fp16, against fp16 codes)
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      uint32_t pa[4];
      if constexpr (kCode)
        mma::pack_a_f16(pa, sc[2 * kk], sc[2 * kk + 1]);
      else
        mma::pack_a(pa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t vf[4];
        mma::ldsm_x4_trans(vf, mma::bt_x4<LDS>(vt, kk * 16, n * 8, lane));
        if constexpr (kCode) {
          mma::mma_f16(o[n], pa, vf[0], vf[1]);
          mma::mma_f16(o[n + 1], pa, vf[2], vf[3]);
        } else {
          mma::mma_bf16(o[n], pa, vf[0], vf[1]);
          mma::mma_bf16(o[n + 1], pa, vf[2], vf[3]);
        }
      }
    }
  }

  // the warp's partial over its own ring, rows < s only: m, l (summed
  // over the quad) and o * f, so every warp's and split's o is in one
  // unit (f = 1 for bf16 pools)
  mma::cp_async_wait<0>();
  __syncwarp();
  float* wo = reinterpret_cast<float*>(wr);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int row = g + 8 * i;
    if (row < s) {
#pragma unroll
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(wo + row * D + n * 8 + 2 * t) =
            make_float2(o[n][2 * i] * f, o[n][2 * i + 1] * f);
      if (t == 0) {
        wm[warp * kMaxRows + row] = m[i];
        wl[warp * kMaxRows + row] = l[i];
      }
    }
  }
  __syncthreads();
  // the warps' partials into the CTA's, o in place over warp 0's (each
  // element read and written by one thread)
  for (int e = threadIdx.x; e < s * D; e += kMmaThreads) {
    const int row = e / D, col = e % D;
    float mm = ptt::kMaskedLogit;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wm[w * kMaxRows + row]);
    float ls = 0.f, os = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = exp2f(wm[w * kMaxRows + row] - mm);
      ls += wl[w * kMaxRows + row] * a;
      os += reinterpret_cast<const float*>(sm + L::q + w * L::warp)[row * D +
                                                                    col] *
            a;
    }
    po[row * D + col] = os;
    if (col == 0) {
      pm[row] = mm;
      pl[row] = ls;
    }
  }
  // every rank's partial is in its shared memory
  cluster.sync();
  // rank r merges the 8-column chunks idx = r, r + kSplits, ... of the
  // s rows: m = max m_r, l = sum l_r 2^(m_r - m), O = sum o_r 2^(m_r - m)
  // / l. Every row reads column 0 (rank 0's), so l > 0.
  constexpr int OC = D / 8;
  for (int idx = rank + kSplits * threadIdx.x; idx < s * OC;
       idx += kSplits * kMmaThreads) {
    const int row = idx / OC, c = idx % OC;
    float mr[kSplits];
    float mm = ptt::kMaskedLogit;
#pragma unroll
    for (int r = 0; r < kSplits; ++r) {
      mr[r] = *cluster.map_shared_rank(pm + row, r);
      mm = fmaxf(mm, mr[r]);
    }
    float ls = 0.f, acc[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[e] = 0.f;
#pragma unroll
    for (int r = 0; r < kSplits; ++r) {
      const float a = exp2f(mr[r] - mm);
      ls += *cluster.map_shared_rank(pl + row, r) * a;
      const float4* p = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(po + row * D + c * 8, r));
      const float4 x0 = p[0], x1 = p[1];
      acc[0] += x0.x * a;
      acc[1] += x0.y * a;
      acc[2] += x0.z * a;
      acc[3] += x0.w * a;
      acc[4] += x1.x * a;
      acc[5] += x1.y * a;
      acc[6] += x1.z * a;
      acc[7] += x1.w * a;
    }
    const float inv = 1.f / ls;
    *reinterpret_cast<uint4*>(out + (static_cast<int64_t>(slot) * s + row) *
                                        rs +
                              h * D + c * 8) =
        make_uint4(mma::pack_bf16(acc[0] * inv, acc[1] * inv),
                   mma::pack_bf16(acc[2] * inv, acc[3] * inv),
                   mma::pack_bf16(acc[4] * inv, acc[5] * inv),
                   mma::pack_bf16(acc[6] * inv, acc[7] * inv));
  }
  // no CTA leaves while another still reads its shared memory
  cluster.sync();
}

template <int D, typename TP>
cudaError_t prepare_decode() {
  return cudaFuncSetAttribute(paged_decode_mma_kernel<D, TP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(DecodeSmem<D, TP>::bytes));
}

// The launch: grid (kSplits, b * H) in clusters of (kSplits, 1, 1).
template <int D, typename TP>
cudaLaunchConfig_t decode_config(int b, int H, cudaStream_t st,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSplits, b * H);
  cfg.blockDim = dim3(kMmaThreads);
  cfg.dynamicSmemBytes = DecodeSmem<D, TP>::bytes;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kSplits;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int D, typename TP>
cudaError_t launch_decode(const void* q, const void* kp, const void* vp,
                          const float* ks, const float* vs, const int* table,
                          const int* t, void* out, int b, int s, int H,
                          int bs, int bp, float scale, cudaStream_t st) {
  cudaError_t e = prepare_decode<D, TP>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = decode_config<D, TP>(b, H, st, &attr);
  e = cudaLaunchKernelEx(&cfg, paged_decode_mma_kernel<D, TP>,
                         static_cast<const bf16*>(q),
                         static_cast<const TP*>(kp),
                         static_cast<const TP*>(vp), ks, vs, table, t,
                         static_cast<bf16*>(out), s, H, bs, bp, scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// cp.async takes 16-byte chunks: q, out and both pools 16-byte aligned, a
// pool row (H * D elements; q's rows are as long or longer) a multiple of
// 16 bytes; int8 scales 4-byte aligned.
bool decode_aligned(const void* q, const void* kp, const void* vp,
                    const void* ks, const void* vs, const void* out,
                    int pool, int H, int D) {
  const auto al = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  const int row = H * D * (pool == ptt::kInt8 ? 1 : 2);
  return al(q, 16) && al(out, 16) && al(kp, 16) && al(vp, 16) &&
         (pool != ptt::kInt8 || (al(ks, 4) && al(vs, 4))) && row % 16 == 0;
}

template <int D, typename TP>
cudaError_t decode_occupancy(int* clusters, int* smem) {
  *smem = static_cast<int>(DecodeSmem<D, TP>::bytes);
  cudaError_t e = prepare_decode<D, TP>();
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = decode_config<D, TP>(1, 1, nullptr, &attr);
  return cudaOccupancyMaxActiveClusters(clusters,
                                        paged_decode_mma_kernel<D, TP>, &cfg);
}

template <typename TP>
cudaError_t f32_by_dim(const void* q, const void* kp, const void* vp,
                       const float* ks, const float* vs, const int* table,
                       const int* t, void* out, int b, int s, int H, int D,
                       int bs, int bp, float scale, cudaStream_t st) {
  if (D == 64)
    return ptt::launch_f32<TP, 64, kMaxRows>(q, kp, vp, ks, vs, table, t, out,
                                             b, s, H, bs, bp, scale, st);
  return ptt::launch_f32<TP, 128, kMaxRows>(q, kp, vp, ks, vs, table, t, out,
                                            b, s, H, bs, bp, scale, st);
}

}  // namespace

// fp32 q: returns the launch's cudaError_t (0 = launched). `dtype` is q's
// type code (kFloat32 only: bf16 q has ptt_paged_decode_fwd), `pool` the
// pools' (kFloat32, or kInt8 with both scales). Pools or an out that
// cp.async and float4 stores cannot take (16 bytes) are refused
// (cudaErrorInvalidValue) and nothing is launched.
extern "C" int ptt_paged_attention_fwd(const void* q, const void* k_pool,
                                       const void* v_pool,
                                       const void* k_scale,
                                       const void* v_scale, const void* table,
                                       const void* t, void* out, int b, int s,
                                       int H, int D, int bs, int bp,
                                       float scale, int dtype, int pool,
                                       void* stream) {
  if (b < 1 || s < 1 || s > kMaxRows || H < 1 || bs < 1 || bp < 1 ||
      (D != 64 && D != 128) || dtype != ptt::kFloat32 ||
      (pool != ptt::kFloat32 && pool != ptt::kInt8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(table);
  const int* tv = static_cast<const int*>(t);
  if (pool == ptt::kInt8)
    return static_cast<int>(f32_by_dim<int8_t>(
        q, k_pool, v_pool, static_cast<const float*>(k_scale),
        static_cast<const float*>(v_scale), tbl, tv, out, b, s, H, D, bs, bp,
        scale, st));
  return static_cast<int>(f32_by_dim<float>(q, k_pool, v_pool, nullptr,
                                            nullptr, tbl, tv, out, b, s, H,
                                            D, bs, bp, scale, st));
}

// bf16 q: the tensor-core cluster body over `pool` (kBFloat16, or kInt8
// with both scales). Returns the launch's cudaError_t (0 = launched); a
// pointer or pool row cp.async cannot take is refused
// (cudaErrorInvalidValue) and nothing is launched.
extern "C" int ptt_paged_decode_fwd(const void* q, const void* k_pool,
                                    const void* v_pool, const void* k_scale,
                                    const void* v_scale, const void* table,
                                    const void* t, void* out, int b, int s,
                                    int H, int D, int bs, int bp, float scale,
                                    int pool, void* stream) {
  if (b < 1 || s < 1 || s > kMaxRows || H < 1 ||
      static_cast<int64_t>(b) * H > 65535 || bs < 1 || bp < 1 ||
      (D != 64 && D != 128) ||
      (pool != ptt::kBFloat16 && pool != ptt::kInt8) ||
      !decode_aligned(q, k_pool, v_pool, k_scale, v_scale, out, pool, H, D))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tbl = static_cast<const int*>(table);
  const int* tv = static_cast<const int*>(t);
  if (pool == ptt::kInt8) {
    if (ks == nullptr || vs == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        D == 64 ? launch_decode<64, int8_t>(q, k_pool, v_pool, ks, vs, tbl,
                                            tv, out, b, s, H, bs, bp, scale,
                                            st)
                : launch_decode<128, int8_t>(q, k_pool, v_pool, ks, vs, tbl,
                                             tv, out, b, s, H, bs, bp, scale,
                                             st));
  }
  return static_cast<int>(
      D == 64 ? launch_decode<64, bf16>(q, k_pool, v_pool, nullptr, nullptr,
                                        tbl, tv, out, b, s, H, bs, bp, scale,
                                        st)
              : launch_decode<128, bf16>(q, k_pool, v_pool, nullptr, nullptr,
                                         tbl, tv, out, b, s, H, bs, bp, scale,
                                         st));
}

// The bf16 body at head dim D over pools of type code `pool` (kBFloat16
// or kInt8): how many of its clusters the card holds at once, as the CUDA
// runtime computes it from the kernel's registers, shared memory and
// cluster size, into *clusters, and its dynamic shared memory in bytes
// into *smem.
extern "C" int ptt_paged_decode_occupancy(int D, int pool, int* clusters,
                                          int* smem) {
  if (D == 64 && pool == ptt::kBFloat16)
    return static_cast<int>(decode_occupancy<64, bf16>(clusters, smem));
  if (D == 128 && pool == ptt::kBFloat16)
    return static_cast<int>(decode_occupancy<128, bf16>(clusters, smem));
  if (D == 64 && pool == ptt::kInt8)
    return static_cast<int>(decode_occupancy<64, int8_t>(clusters, smem));
  if (D == 128 && pool == ptt::kInt8)
    return static_cast<int>(decode_occupancy<128, int8_t>(clusters, smem));
  return static_cast<int>(cudaErrorInvalidValue);
}
