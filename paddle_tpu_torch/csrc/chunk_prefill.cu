// K5: chunk-prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/chunk_prefill.py
// (_chunk_kernel, reached through chunk_prefill_pallas), both branches:
// full-precision pools, and int8 code pools with (num_blocks, H) scales
// (:126-128). A prompt chunk q (b, s, H, D) at start offset t (b,; the
// wrapper broadcasts the engine's scalar) attends the paged pool: row i
// reads cols <= start + i — causal inside the chunk, full attention over
// the committed prefix. Layouts are paged_common.cuh's.
//
// Bound on the H100: for a 128-row chunk over a prefix of a few hundred
// rows the kernel moves ~(start+s)*H*D*2 elements and does
// ~4*s*(start+s/2)*H*D flops; in bf16 the bytes bind (0.0007 ms at start
// 517), so what is left is latency: few CTAs, each walking its keys in
// order.
//
// bf16 or fp16 q: chunk_prefill_mma_kernel<D, T, TP>, both products on
// the tensor cores (mma.sync m16n8k16, T in, fp32 accumulate;
// flash_mma.cuh), over pools of q's type or int8 code pools (whose P.V
// runs in fp16, below). One source for both types: Elem<T> gives the
// product (.bf16 or .f16) and the rounding of P and of the output (fp16:
// to nearest, overflow to inf, never satfinite); the logits, their
// scale, mask and running max stay fp32 in either.
//  - Grid (b * ceil(s / 64), H), whatever q-block the wrapper picked: a
//    CTA of 4 warps owns 64 query rows of one (slot, head), 16 a warp
//    (the rows are independent, chunk_prefill.py:30-43), so a chunk of
//    100 runs as two tiles. The chunk's last tile, which reads the most
//    keys, launches first. Query rows past s are zero-filled and never
//    stored.
//  - Q is staged once by cp.async and held as A fragments. 64-key K and
//    V tiles come through a cp.async ring of kStages stages, gathered row
//    by row through the table: key row col of the slot sits at
//    (table[col / bs] * bs + col % bs) * H * dh + h * dh, dh contiguous
//    elements, so 16-byte chunks (8-byte ones over int8 codes of a head
//    dim no multiple of 16; paged_common.cuh's head-dim note). Each thread reads the table entry of
//    every key row it copies once a tile, for K and V together. Rows
//    past the CTA's reach, min(base + rows - 1, bp * bs - 1), are
//    zero-filled from the address of row `reach` (src-size 0): no row,
//    table entry or scale past the reach is ever read.
//  - S = Q.K^T on the accumulators (K by ldmatrix), the online softmax
//    on the fragments (a row's max and sum over its quad by shuffles,
//    m and l in registers, scale * log2(e) folded into exp2), P rounded
//    to T by Elem<T>::pack_a as the A operand of P.V (V by
//    ldmatrix.trans).
//    Masked logits are -1e30, never -inf (paged_attention.py:55); the
//    mask is tested only on tiles that cross the warp's diagonal or the
//    reach, and a warp skips tiles wholly past its deepest row.
//  - Int8 pools: the codes land by cp.async at one byte an element,
//    beside each key row's (block, head) scales (one 4-byte copy a row).
//    Once a tile has landed, the CTA turns its codes into a K tile of T
//    and an fp16 V tile in shared memory, both exact (|code| <= 128). The
//    k scale multiplies S's fp32 column of its key, S[i,j] = ks[blk(j)] *
//    sum_d q[i,d] code[j,d]. The v scale goes into P before its rounding,
//    sum_j (p[i,j] * vs[blk(j)]) * code[j,d], and l sums the unscaled p.
//    That P is rounded to fp16, not bf16, as p * vs / fv with fv the
//    tile's largest v scale, so in [0, 1]: 11 bits where bf16 keeps 8,
//    because a code times its scale reaches the block's absmax, several
//    times a unit-normal value, and the bf16 rounding of P times such
//    values passes 4e-3 + 1e-2 |O| (tests/test_torch_chunk_layout.py).
//    o carries the factor fv of its last tile; the softmax's rescale
//    moves it to the next tile's, and the store divides by l / fv.
//  - O / l is written in T through the warp's own rows of the Q tile
//    into 16-byte stores. Every row reads column 0, so l > 0.
//  - cp.async needs 16-byte aligned q, out and pools (pool rows of a head
//    dim dh % 16 != 0 over int8 codes go as 8-byte copies, paged_common.cuh
//    cp_row_chunk): the C entry refuses anything else
//    (cudaErrorInvalidValue).
//
// fp32 q: paged_f32_kernel (paged_common.cuh), K4's fp32 body, on the
// CUDA cores in fp32 (no TF32: the fp32 contract is 2e-5 of the plain
// version). The chunk is cut into row tiles of its own (ptt::f32_rows: 16,
// 32 or 64 rows by s, whatever q-block the wrapper picked; qbs is
// checked, not used), each tile's key walk split across a cluster.
#include "flash_mma.cuh"
#include "paged_common.cuh"

namespace {

using ptt::mma::bf16;

constexpr int kMaxQbs = 64;  // the wrapper's q-block cap (pick_qbs)

constexpr int kRows = 64;  // tensor-core body: query rows a CTA, 4 warps x 16
constexpr int kKeys = 64;        // keys a tile
constexpr int kMmaThreads = 128;
constexpr int kStages = 2;       // cp.async ring depth
constexpr float kLog2e = 1.4426950408889634f;

// The tensor-core body's dynamic shared memory (the same for bf16 and
// fp16 q, both 2 bytes): the Q tile (then O), and for 16-bit pools
// kStages K and V tiles (rows of D + 8 elements); for int8 pools
// one converted K and V tile, kStages code tiles of each (rows of D
// bytes) and kStages rows of k and v scales.
template <int D, typename TP>
constexpr size_t mma_smem() {
  constexpr bool code = ptt::IsCode<TP>::value;
  return sizeof(bf16) * (kRows + 2 * (code ? 1 : kStages) * kKeys) * (D + 8) +
         (code ? 2 * kStages * kKeys * (D + sizeof(float)) : 0);
}

// T: q's and out's type (bf16 or __half); TP: the pools' (T or int8_t)
template <int D, typename T, typename TP>
__global__ void __launch_bounds__(kMmaThreads)
    chunk_prefill_mma_kernel(const T* __restrict__ q,
                             const TP* __restrict__ kp,
                             const TP* __restrict__ vp,
                             const float* __restrict__ ksp,
                             const float* __restrict__ vsp,
                             const int* __restrict__ table,
                             const int* __restrict__ tv,
                             T* __restrict__ out, int s, int ntile, int H,
                             int dh, int bs, int bp, float scale) {
  namespace mma = ptt::mma;
  using E = mma::Elem<T>;
  constexpr bool kCode = ptt::IsCode<TP>::value;
  constexpr int LDS = D + 8;         // row stride: 16 bytes of padding
  constexpr int KD = D / 16;         // k16 steps of Q.K^T
  constexpr int ND = D / 8;          // n8 tiles of the output
  constexpr int NS = kKeys / 8;      // n8 tiles of a score tile
  constexpr int KV = kCode ? 1 : kStages;  // 16-bit K and V tiles
  constexpr int PLD = kCode ? D : LDS;     // row stride of a ring stage
  constexpr int CPR = D * sizeof(TP) / 16; // 16-byte chunks a key row
  constexpr int EPC = 16 / sizeof(TP);     // elements a chunk
  static_assert(kKeys * CPR % kMmaThreads == 0, "chunks must split evenly");
  extern __shared__ float4 smem4[];
  T* qs = reinterpret_cast<T*>(smem4);  // kRows x LDS, then O
  T* ks = qs + kRows * LDS;             // KV x kKeys x LDS
  T* vs = ks + KV * kKeys * LDS;        // KV x kKeys x LDS (int8: fp16 bits)
  // the ring: 16-bit pools fill ks / vs; int8 pools their codes and scales
  TP* kr = kCode ? reinterpret_cast<TP*>(vs + kKeys * LDS)
                 : reinterpret_cast<TP*>(ks);
  TP* vr = kCode ? kr + kStages * kKeys * D : reinterpret_cast<TP*>(vs);
  float* ksc = reinterpret_cast<float*>(vr + kStages * kKeys * D);
  float* vsc = ksc + kStages * kKeys;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int slot = blockIdx.x / ntile;
  // the chunk's last tile reads the most keys: it launches first
  const int tile = ntile - 1 - blockIdx.x % ntile;
  const int h = blockIdx.y;
  const int64_t rs = static_cast<int64_t>(H) * dh;  // row stride, elements
  const int r0 = tile * kRows;
  const int rows = min(kRows, s - r0);
  const int base = tv[slot] + r0;                  // position of row 0
  const int reach = min(base + rows - 1, bp * bs - 1);
  const int n_tiles = reach / kKeys + 1;
  const int* trow = table + static_cast<int64_t>(slot) * bp;
  const int wbase = base + warp * 16;  // position of the warp's row 0
  const bool warp_live = warp * 16 < rows;

  // key rows [j * kKeys, +kKeys) of this slot and head into ring stage st
  auto stage_tile = [&](int j, int st) {
    const int j0 = j * kKeys;
#pragma unroll
    for (int u = 0; u < kKeys * CPR / kMmaThreads; ++u) {
      const int idx = threadIdx.x + u * kMmaThreads, r = idx / CPR,
                c = idx % CPR;
      const int col = j0 + r, cl = min(col, reach);
      const int64_t off =
          (static_cast<int64_t>(trow[cl / bs]) * bs + cl % bs) * rs + h * dh;
      const int at = (st * kKeys + r) * PLD + c * EPC;
      ptt::cp_row_chunk(kr + at, kp + off, c, dh, col <= reach);
      ptt::cp_row_chunk(vr + at, vp + off, c, dh, col <= reach);
    }
    if constexpr (kCode) {  // threads 0-63: k scales, 64-127: v scales
      const int r = threadIdx.x % kKeys, col = j0 + r, cl = min(col, reach);
      const int64_t at = static_cast<int64_t>(trow[cl / bs]) * H + h;
      if (threadIdx.x < kKeys)
        mma::cp_async_4(ksc + st * kKeys + r, ksp + at, col <= reach);
      else
        mma::cp_async_4(vsc + st * kKeys + r, vsp + at, col <= reach);
    }
  };

  // groups in flight: Q, then tiles 0 .. kStages - 2 (one group each,
  // empty past the last tile, so the count stays fixed)
  mma::tile_async<kRows, D, LDS, kMmaThreads>(
      qs, q + static_cast<int64_t>(slot) * s * rs + h * dh, r0, s, rs, dh);
  mma::cp_async_commit();
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) stage_tile(st, st);
    mma::cp_async_commit();
  }
  mma::cp_async_wait<kStages - 1>();
  __syncthreads();
  uint32_t qf[KD][4];
#pragma unroll
  for (int kd = 0; kd < KD; ++kd)
    mma::ldsm_x4(qf[kd], mma::a_x4<LDS>(qs, warp * 16, kd * 16, lane));

  // this thread's rows: wbase + g (i = 0) and wbase + g + 8 (i = 1);
  // m is in log2 units
  const float scale_l2 = scale * kLog2e;
  float m[2] = {ptt::kMaskedLogit, ptt::kMaskedLogit}, l[2] = {0.f, 0.f};
  // int8 pools: o holds O * l / f, f the v scale it was last put in
  float f = 1.f;
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int j0 = j * kKeys, st = j % kStages;
    // tile j has landed; every warp is done with tile j - 1, whose stage
    // (and, for int8 pools, the converted tiles) may be refilled
    mma::cp_async_wait<kStages - 2>();
    __syncthreads();
    if (j + kStages - 1 < n_tiles)
      stage_tile(j + kStages - 1, (j + kStages - 1) % kStages);
    mma::cp_async_commit();
    const T* kt = ks + (kCode ? 0 : st * kKeys * LDS);
    const T* vt = vs + (kCode ? 0 : st * kKeys * LDS);
    if constexpr (kCode) {
      // codes -> T (K) and fp16 (V), 16 a chunk: exact, |code| <= 128
      constexpr int CC = D / 16;
#pragma unroll
      for (int u = 0; u < kKeys * CC / kMmaThreads; ++u) {
        const int idx = threadIdx.x + u * kMmaThreads, r = idx / CC,
                  c = idx % CC;
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          const int4 raw = *reinterpret_cast<const int4*>(
              (x ? vr : kr) + (st * kKeys + r) * D + c * 16);
          const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
          uint32_t w[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float lo = b[2 * e], hi = b[2 * e + 1];
            w[e] = x ? mma::pack_f16(lo, hi) : E::pack(lo, hi);
          }
          uint4* dst = reinterpret_cast<uint4*>((x ? vs : ks) + r * LDS +
                                                c * 16);
          dst[0] = make_uint4(w[0], w[1], w[2], w[3]);
          dst[1] = make_uint4(w[4], w[5], w[6], w[7]);
        }
      }
      __syncthreads();
    }
    // warp-uniform: every row of the warp lies past s, or every key of
    // the tile past the warp's deepest row (p = 0, alpha = 1 throughout)
    if (!warp_live || j0 > wbase + 15) continue;
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
        E::mma(sc[n], qf[kd], kf[0], kf[1]);
        E::mma(sc[n + 1], qf[kd], kf[2], kf[3]);
      }
    // tiles wholly below the warp's diagonal and inside the reach skip
    // the test
    const bool edge = j0 + kKeys - 1 > wbase || j0 + kKeys - 1 > reach;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + e % 2;  // key of the tile
        float x = sc[n][e] * scale_l2;
        if constexpr (kCode) x *= ksc[st * kKeys + c];
        if (edge) {
          const int pos = wbase + g + (e / 2) * 8, col = j0 + c;
          if (col > pos || col > reach) x = ptt::kMaskedLogit;
        }
        sc[n][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    // every row reads key 0 in tile 0, so m is a real logit from then on
    // and a masked logit gives p = exp2(-1e30 - m) = 0
    // int8 pools: p * vs[blk(j)] / fv, fv the tile's largest v scale,
    // lies in [0, 1], where fp16 keeps 11 bits; o moves from units of f
    // to units of fv with the softmax's rescale
    float inv_fv = 1.f, rescale = 1.f;
    if constexpr (kCode) {
      float fv = ptt::warp_max(fmaxf(vsc[st * kKeys + lane],
                                     vsc[st * kKeys + lane + 32]));
      if (fv == 0.f) fv = f;  // every v of the tile is 0: P.V adds 0
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
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(sc[n][e] - m[e / 2]);
        l[e / 2] += p;
        sc[n][e] = p;
        if constexpr (kCode)
          sc[n][e] *= vsc[st * kKeys + n * 8 + 2 * t + e % 2] * inv_fv;
      }
#pragma unroll
    for (int n = 0; n < ND; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[n][e] *= alpha[e / 2] * rescale;
    // O += P.V, P rounded to T (int8 pools: fp16, against fp16 codes)
#pragma unroll
    for (int kk = 0; kk < NS / 2; ++kk) {
      uint32_t pa[4];
      if constexpr (kCode)
        mma::pack_a_f16(pa, sc[2 * kk], sc[2 * kk + 1]);
      else
        E::pack_a(pa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int n = 0; n < ND; n += 2) {
        uint32_t vf[4];
        mma::ldsm_x4_trans(vf, mma::bt_x4<LDS>(vt, kk * 16, n * 8, lane));
        if constexpr (kCode) {
          mma::mma_f16(o[n], pa, vf[0], vf[1]);
          mma::mma_f16(o[n + 1], pa, vf[2], vf[3]);
        } else {
          E::mma(o[n], pa, vf[0], vf[1]);
          E::mma(o[n + 1], pa, vf[2], vf[3]);
        }
      }
    }
  }
  if (!warp_live) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    l[i] /= f;  // O = o * f / l (f = 1 for 16-bit pools)
  }
  // O / l in T, staged through this warp's own 16 rows of the Q tile
  // (its Q fragments are in registers) into 16-byte stores
  T* os = qs + warp * 16 * LDS;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < ND; ++n) {
    *reinterpret_cast<uint32_t*>(os + g * LDS + n * 8 + 2 * t) =
        E::pack(o[n][0] / l[0], o[n][1] / l[0]);
    *reinterpret_cast<uint32_t*>(os + (g + 8) * LDS + n * 8 + 2 * t) =
        E::pack(o[n][2] / l[1], o[n][3] / l[1]);
  }
  __syncwarp();
  T* oh = out + static_cast<int64_t>(slot) * s * rs + h * dh;
  constexpr int OCR = D / 8;  // 16-byte chunks of an output row
#pragma unroll
  for (int idx = lane; idx < 16 * OCR; idx += 32) {
    const int r = idx / OCR, c = idx % OCR, row = r0 + warp * 16 + r;
    if (row < s && c * 8 < dh)
      *reinterpret_cast<uint4*>(oh + row * rs + c * 8) =
          *reinterpret_cast<const uint4*>(os + r * LDS + c * 8);
  }
}

template <int D, typename T, typename TP>
cudaError_t allow_mma_smem() {
  return cudaFuncSetAttribute(chunk_prefill_mma_kernel<D, T, TP>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(mma_smem<D, TP>()));
}

template <int D, typename T, typename TP>
cudaError_t launch_mma(const void* q, const void* kp, const void* vp,
                       const float* ks, const float* vs, const int* table,
                       const int* t, void* out, int b, int s, int H, int dh,
                       int bs, int bp, float scale, cudaStream_t st) {
  cudaError_t e = allow_mma_smem<D, T, TP>();
  if (e != cudaSuccess) return e;
  const int ntile = (s + kRows - 1) / kRows;
  const dim3 grid(b * ntile, H);
  chunk_prefill_mma_kernel<D, T, TP><<<grid, kMmaThreads, mma_smem<D, TP>(),
                                       st>>>(
      static_cast<const T*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), ks, vs, table, t, static_cast<T*>(out), s,
      ntile, H, dh, bs, bp, scale);
  return cudaGetLastError();
}

// The tensor-core body stages 16-byte chunks by cp.async: q, out and both
// pools 16-byte aligned (a 16-bit row of dh % 8 == 0 elements keeps every
// row 16-byte aligned; an int8 row 8-byte, which cp_row_chunk's 8-byte
// copies take); int8 scales 4-byte aligned.
bool mma_aligned(const void* q, const void* kp, const void* vp,
                 const void* ks, const void* vs, const void* out, int pool) {
  const auto al = [](const void* p, uintptr_t n) {
    return reinterpret_cast<uintptr_t>(p) % n == 0;
  };
  return al(q, 16) && al(out, 16) && al(kp, 16) && al(vp, 16) &&
         (pool != ptt::kInt8 || (al(ks, 4) && al(vs, 4)));
}

// q of type T over pools of type code `pool` (T's, or kInt8 with both
// scales), at head dim dh (head_dim_ok), on the body of its padded one
template <typename T>
cudaError_t mma_by_pool(int pool, const void* q, const void* kp,
                        const void* vp, const float* ks, const float* vs,
                        const int* table, const int* t, void* out, int b,
                        int s, int H, int dh, int bs, int bp, float scale,
                        cudaStream_t st) {
  if (!mma_aligned(q, kp, vp, ks, vs, out, pool))
    return cudaErrorInvalidValue;
  const bool d64 = ptt::padded_head_dim(dh) == 64;
  if (pool == ptt::kInt8) {
    if (ks == nullptr || vs == nullptr) return cudaErrorInvalidValue;
    return d64 ? launch_mma<64, T, int8_t>(q, kp, vp, ks, vs, table, t, out,
                                           b, s, H, dh, bs, bp, scale, st)
               : launch_mma<128, T, int8_t>(q, kp, vp, ks, vs, table, t, out,
                                            b, s, H, dh, bs, bp, scale, st);
  }
  return d64 ? launch_mma<64, T, T>(q, kp, vp, nullptr, nullptr, table, t,
                                    out, b, s, H, dh, bs, bp, scale, st)
             : launch_mma<128, T, T>(q, kp, vp, nullptr, nullptr, table, t,
                                     out, b, s, H, dh, bs, bp, scale, st);
}

template <int D, typename TP>
cudaError_t mma_occupancy(int* ctas, int* smem) {
  *smem = static_cast<int>(mma_smem<D, TP>());
  cudaError_t e = allow_mma_smem<D, bf16, TP>();
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      ctas, chunk_prefill_mma_kernel<D, bf16, TP>, kMmaThreads,
      mma_smem<D, TP>());
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched). D is any head dim of
// head_dim_ok (common.cuh); `dtype` is q's type code, `pool` the pools'
// (equal to dtype, or kInt8 with both scales).
// Both bodies tile the chunk by rows of their own (qbs is checked, not
// used): bf16 and fp16 q run the tensor-core body in 64-row tiles, fp32
// q runs paged_f32_kernel, whose pools and out must be 16-byte aligned (else
// cudaErrorInvalidValue, and nothing is launched).
extern "C" int ptt_chunk_prefill_fwd(const void* q, const void* k_pool,
                                     const void* v_pool, const void* k_scale,
                                     const void* v_scale, const void* table,
                                     const void* t, void* out, int b, int s,
                                     int qbs, int H, int D, int bs, int bp,
                                     float scale, int dtype, int pool,
                                     void* stream) {
  if (b < 1 || s < 1 || qbs < 1 || qbs > kMaxQbs || s % qbs != 0 ||
      H < 1 || H > 65535 || bs < 1 || bp < 1 || !ptt::head_dim_ok(D) ||
      (pool != dtype && pool != ptt::kInt8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tbl = static_cast<const int*>(table);
  const int* tv = static_cast<const int*>(t);
  switch (dtype) {
    case ptt::kFloat32:
      return static_cast<int>(
          pool == ptt::kInt8
              ? ptt::f32_by_dim<int8_t>(q, k_pool, v_pool, ks, vs, tbl, tv,
                                        out, b, s, H, D, bs, bp, scale, st)
              : ptt::f32_by_dim<float>(q, k_pool, v_pool, nullptr, nullptr,
                                       tbl, tv, out, b, s, H, D, bs, bp,
                                       scale, st));
    case ptt::kBFloat16:
      return static_cast<int>(mma_by_pool<bf16>(pool, q, k_pool, v_pool, ks,
                                                vs, tbl, tv, out, b, s, H, D,
                                                bs, bp, scale, st));
    case ptt::kFloat16:
      return static_cast<int>(mma_by_pool<__half>(pool, q, k_pool, v_pool, ks,
                                                  vs, tbl, tv, out, b, s, H,
                                                  D, bs, bp, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The bf16-q body at head dim D over pools of type code `pool` (kBFloat16
// or kInt8; the fp16-q body's shared memory is the same): how many of its CTAs one SM holds, as the CUDA runtime
// computes it from the kernel's registers and shared memory, into *ctas,
// and its dynamic shared memory in bytes into *smem.
extern "C" int ptt_chunk_prefill_occupancy(int D, int pool, int* ctas,
                                           int* smem) {
  if (D == 64 && pool == ptt::kBFloat16)
    return static_cast<int>(mma_occupancy<64, bf16>(ctas, smem));
  if (D == 128 && pool == ptt::kBFloat16)
    return static_cast<int>(mma_occupancy<128, bf16>(ctas, smem));
  if (D == 64 && pool == ptt::kInt8)
    return static_cast<int>(mma_occupancy<64, int8_t>(ctas, smem));
  if (D == 128 && pool == ptt::kInt8)
    return static_cast<int>(mma_occupancy<128, int8_t>(ctas, smem));
  return static_cast<int>(cudaErrorInvalidValue);
}
