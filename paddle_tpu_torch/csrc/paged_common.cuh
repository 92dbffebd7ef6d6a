// The CUDA-core attention body that K4 (paged decode/verify) and K5
// (chunk prefill) run for fp32 queries. bf16 queries run tensor-core
// bodies instead: K4's cluster-split paged_decode_mma_kernel in
// paged_attention.cu, K5's chunk_prefill_mma_kernel in chunk_prefill.cu.
// Here one CTA owns `rows` consecutive query rows of one slot and one
// head, and walks that slot's KV through the block table.
//
// Layouts (all contiguous, checked by the Python wrappers):
//   q, out   (b, s, H, D)             query row r of slot n at (n*s + r)
//   k/v pool (num_blocks, bs, H, D)   one block of one head is bs rows
//                                     strided by H*D, never a dense tile
//   k/v scale (num_blocks, H) fp32    quantized pools only: the absmax
//                                     scale of each (block, head)
//   table    (b, bp) int32            logical block j -> physical block
//   t        (b,) int32               absolute position of q row 0
//
// The pool type TP is q's type TQ for full-precision pools, or int8_t
// for quantized ones (the int8 branch of the TPU kernels,
// paged_attention.py:134-136 and chunk_prefill.py:126-128). The Pallas
// kernels dequantize a whole (bs, D) block in VMEM by its scale. Here a
// thread loads int8 codes (a quarter of the fp32 bytes, which is where
// the memory-bound decode wins) and, with each row, that row's (block,
// h) scale; the code x scale product is formed where the tile converts
// to fp32 shared memory, so everything after the store (QK^T, online
// softmax, P.V) is the full-precision body unchanged.
//
// The Pallas kernels run their key-block axis as a sequential grid
// dimension carrying (m, l, acc) in VMEM scratch. Hopper runs CTAs in
// no order, so here that axis is a loop INSIDE the CTA: the online
// softmax state stays on chip (m, l in shared memory, acc in fp32
// registers) for the whole walk and the output is written once.
//
// Each pass of the loop works on a tile of KT logical key rows (several
// pool blocks, gathered row by row through the table) staged in shared
// memory as fp32: QK^T (each thread one key against its share of the
// rows, float4 shared-memory reads), the online-softmax update (one warp
// per row), and P.V (each thread one output dim of its share of the
// rows, one accumulator chain per row). The next tile's loads, KT*D*2/NT
// per thread, are issued into registers before that work and stored
// after it, so global latency hides behind the compute.
//
// Contracts kept from the TPU kernels:
//  - query row i (absolute position base+i) reads columns col <= base+i;
//    masked logits are -1e30, never -inf (paged_attention.py:55), so
//    exp() and max() stay NaN-free;
//  - no row past the CTA's reach, min(base+rows-1, bp*bs-1), is ever
//    loaded, nor its scale: tile rows beyond it are zero-filled in
//    shared memory (their logits are masked and their p is 0), so a
//    poisoned pool proves it;
//  - row independence (chunk_prefill.py:30-43): no state crosses query
//    rows, masking uses absolute positions, and only rows committed
//    before the launch are read.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace ptt {

constexpr float kMaskedLogit = -1e30f;

// Keys per tile: 64 at D=64, 32 at D=128 (the tile's staging registers,
// KT*D*2/NT per thread, stay the same).
template <int D>
struct KeyTile {
  static constexpr int value = D == 64 ? 64 : 32;
};

// Dynamic shared memory the kernel needs, in bytes.
inline size_t paged_smem_bytes(int rows, int D, int KT) {
  return sizeof(float) *
         (static_cast<size_t>(rows) * D         // q rows
          + static_cast<size_t>(KT) * (D + 4)   // K tile (+4 pad: banks)
          + static_cast<size_t>(KT) * D         // V tile
          + static_cast<size_t>(rows) * KT      // logits, then p
          + 3 * static_cast<size_t>(rows));     // m, l, alpha per row
}

template <typename TP>
struct IsCode {  // int8 codes of a quantized pool
  static constexpr bool value = false;
};
template <>
struct IsCode<int8_t> {
  static constexpr bool value = true;
};

// The share of one key tile a thread stages: LD elements of K and of V,
// key rows c0, c0 + CP, ... of the tile, head dim d. They are held in
// the pool's own type: converting right after each load would make the
// thread wait for it, and serialise the tile's loads. A quantized pool
// also stages each element's row scale (LD floats per tensor; a row's
// block, and so its scale, changes every bs rows, which is a run-time
// size).
template <typename TP, int D, int NT, int KT>
struct TileRegs {
  static constexpr int LD = KT * D / NT;  // elements of each tensor
  static constexpr int CP = NT / D;       // key rows covered per step
  static constexpr int LS = IsCode<TP>::value ? LD : 1;
  TP k[LD], v[LD];
  float ksc[LS], vsc[LS];
};

// Issue the loads of logical rows [j0, j0+KT) of one head into `r`.
// Rows past `reach` stay 0 (and their scales 0) and are never loaded.
// The block of a row steps along with it (one division per tile, not
// per element).
template <typename TP, int D, int NT, int KT>
__device__ __forceinline__ void load_tile(
    TileRegs<TP, D, NT, KT>& r, const TP* __restrict__ kp,
    const TP* __restrict__ vp, const float* __restrict__ ksp,
    const float* __restrict__ vsp, const int* __restrict__ trow, int j0,
    int reach, int bs, int H, int h) {
  using R = TileRegs<TP, D, NT, KT>;
  constexpr bool kCode = IsCode<TP>::value;
  const int64_t rs = static_cast<int64_t>(H) * D;
  const int d = threadIdx.x % D;
  int col = j0 + threadIdx.x / D;
  int jb = col / bs, rb = col % bs;
#pragma unroll
  for (int u = 0; u < R::LD; ++u) {
    if constexpr (kCode) {
      r.k[u] = 0;
      r.v[u] = 0;
      r.ksc[u] = 0.f;
      r.vsc[u] = 0.f;
    } else {
      r.k[u] = from_f<TP>(0.f);
      r.v[u] = from_f<TP>(0.f);
    }
    if (col <= reach) {
      const int64_t blk = trow[jb];
      const int64_t off = (blk * bs + rb) * rs + h * D + d;
      r.k[u] = kp[off];
      r.v[u] = vp[off];
      if constexpr (kCode) {
        r.ksc[u] = ksp[blk * H + h];
        r.vsc[u] = vsp[blk * H + h];
      }
    }
    col += R::CP;
    for (rb += R::CP; rb >= bs; rb -= bs) ++jb;
  }
}

// Store a loaded tile into shared memory as fp32 (K rows padded to
// STRIDE floats, V rows dense); int8 codes are dequantized here, code
// times its row's scale, as the plain version's codes.float() * scale.
template <int STRIDE, typename TP, int D, int NT, int KT>
__device__ __forceinline__ void store_tile(const TileRegs<TP, D, NT, KT>& r,
                                           float* __restrict__ ks,
                                           float* __restrict__ vs) {
  using R = TileRegs<TP, D, NT, KT>;
  const int d = threadIdx.x % D, c0 = threadIdx.x / D;
#pragma unroll
  for (int u = 0; u < R::LD; ++u) {
    const int c = c0 + u * R::CP;
    if constexpr (IsCode<TP>::value) {
      ks[c * STRIDE + d] = to_f(r.k[u]) * r.ksc[u];
      vs[c * D + d] = to_f(r.v[u]) * r.vsc[u];
    } else {
      ks[c * STRIDE + d] = to_f(r.k[u]);
      vs[c * D + d] = to_f(r.v[u]);
    }
  }
}

// NT threads, at most MAXROWS query rows per CTA. q and out are TQ,
// the pools TP (TQ, or int8_t with the scale pools ksp/vsp, which are
// null on the full-precision path).
template <typename TQ, typename TP, int D, int NT, int MAXROWS>
__global__ void __launch_bounds__(NT)
    paged_attn_kernel(const TQ* __restrict__ q, const TP* __restrict__ kp,
                      const TP* __restrict__ vp,
                      const float* __restrict__ ksp,
                      const float* __restrict__ vsp,
                      const int* __restrict__ table,
                      const int* __restrict__ tv, TQ* __restrict__ out,
                      int s, int rows, int nq, int H, int bs, int bp,
                      float scale) {
  constexpr int KT = KeyTile<D>::value;
  constexpr int KP = D + 4;        // padded K row: conflict-free float4
  constexpr int QG = NT / KT;      // row groups of the QK phase
  constexpr int RQ = MAXROWS / QG; // rows per thread in QK
  constexpr int PG = NT / D;       // row groups of the PV phase
  constexpr int RP = MAXROWS / PG; // rows per thread in PV
  static_assert(NT % KT == 0 && NT % D == 0 && MAXROWS % QG == 0 &&
                    MAXROWS % PG == 0 && (KT * D) % NT == 0 && KT % 4 == 0,
                "tile shapes must divide the CTA");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // rows * D
  float* ks = qs + rows * D;                     // KT * KP
  float* vs = ks + KT * KP;                      // KT * D
  float* ps = vs + KT * D;                       // rows * KT
  float* ms = ps + rows * KT;                    // rows
  float* ls = ms + rows;                         // rows
  float* as = ls + rows;                         // rows

  const int tid = threadIdx.x;
  const int u = blockIdx.x, h = blockIdx.y;
  const int slot = u / nq, qi = u % nq;
  const int64_t rs = static_cast<int64_t>(H) * D;
  const int64_t q_row0 = static_cast<int64_t>(slot) * s + qi * rows;
  const int base = tv[slot] + qi * rows;  // position of this CTA's row 0
  const int reach = min(base + rows - 1, bp * bs - 1);
  const int* trow = table + static_cast<int64_t>(slot) * bp;

  for (int e = tid; e < rows * D; e += NT) {
    const int i = e / D, d = e % D;
    qs[e] = to_f(q[(q_row0 + i) * rs + h * D + d]);
  }
  for (int i = tid; i < rows; i += NT) {
    ms[i] = kMaskedLogit;
    ls[i] = 0.f;
  }
  const int c_own = tid % KT, gq = tid / KT;  // QK: one key, rows gq+k*QG
  const int d_own = tid % D, gp = tid / D;    // PV: one dim, rows gp+k*PG
  float acc[RP];
#pragma unroll
  for (int k = 0; k < RP; ++k) acc[k] = 0.f;
  const int warp = tid >> 5, lane = tid & 31;

  // software pipeline: the next tile's loads are in flight while this
  // tile is computed, and land in shared memory after its last read
  TileRegs<TP, D, NT, KT> regs;
  load_tile(regs, kp, vp, ksp, vsp, trow, 0, reach, bs, H, h);
  for (int j0 = 0; j0 <= reach; j0 += KT) {
    store_tile<KP>(regs, ks, vs);
    __syncthreads();
    if (j0 + KT <= reach)
      load_tile(regs, kp, vp, ksp, vsp, trow, j0 + KT, reach, bs, H, h);
    if (gq < rows) {  // logits of this tile
      // four partial sums per row (one per float4 lane): short
      // dependency chains even when a thread owns a single row
      float4 dot[RQ];
#pragma unroll
      for (int k = 0; k < RQ; ++k) dot[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4* kr = reinterpret_cast<const float4*>(ks + c_own * KP);
#pragma unroll 4
      for (int x = 0; x < D / 4; ++x) {
        const float4 kv = kr[x];
#pragma unroll
        for (int k = 0; k < RQ; ++k) {
          const int i = gq + k * QG;
          if (i < rows) {
            const float4 qv = reinterpret_cast<const float4*>(qs + i * D)[x];
            dot[k].x += qv.x * kv.x;
            dot[k].y += qv.y * kv.y;
            dot[k].z += qv.z * kv.z;
            dot[k].w += qv.w * kv.w;
          }
        }
      }
      // col <= reach also masks the columns past the table (bp*bs),
      // which a pad row of a chunk running off the table could name
      const int col = j0 + c_own;
#pragma unroll
      for (int k = 0; k < RQ; ++k) {
        const int i = gq + k * QG;
        const float sum = (dot[k].x + dot[k].y) + (dot[k].z + dot[k].w);
        if (i < rows)
          ps[i * KT + c_own] =
              col <= base + i && col <= reach ? sum * scale : kMaskedLogit;
      }
    }
    __syncthreads();
    // online softmax, one warp per query row
    for (int i = warp; i < rows; i += NT / 32) {
      float mx = kMaskedLogit;
      for (int c = lane; c < KT; c += 32) mx = fmaxf(mx, ps[i * KT + c]);
      mx = warp_max(mx);
      const float m_prev = ms[i];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = lane; c < KT; c += 32) {
        const float p = expf(ps[i * KT + c] - m_new);
        ps[i * KT + c] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        as[i] = alpha;
        ls[i] = ls[i] * alpha + sum;
        ms[i] = m_new;
      }
    }
    __syncthreads();
    // P.V: four keys' V values are read once and feed every row the
    // thread owns, one independent accumulator chain per row
    if (gp < rows) {
#pragma unroll
      for (int k = 0; k < RP; ++k) {
        const int i = gp + k * PG;
        if (i < rows) acc[k] *= as[i];
      }
#pragma unroll 2
      for (int c = 0; c < KT / 4; ++c) {
        const float* vc = vs + 4 * c * D + d_own;
        const float v0 = vc[0], v1 = vc[D], v2 = vc[2 * D], v3 = vc[3 * D];
#pragma unroll
        for (int k = 0; k < RP; ++k) {
          const int i = gp + k * PG;
          if (i < rows) {
            const float4 p = reinterpret_cast<const float4*>(ps + i * KT)[c];
            // the chain through acc is one add per four keys
            acc[k] += (p.x * v0 + p.y * v1) + (p.z * v2 + p.w * v3);
          }
        }
      }
    }
    __syncthreads();
  }
  // every row reads at least column 0 (base >= 0), so l > 0
#pragma unroll
  for (int k = 0; k < RP; ++k) {
    const int i = gp + k * PG;
    if (i < rows)
      out[(q_row0 + i) * rs + h * D + d_own] = from_f<TQ>(acc[k] / ls[i]);
  }
}

// Launch with dynamic shared memory, raising the per-kernel limit past
// the default 48 KB when the tile needs it.
template <typename TQ, typename TP, int D, int NT, int MAXROWS>
cudaError_t launch_paged(const void* q, const void* kp, const void* vp,
                         const float* ksp, const float* vsp,
                         const int* table, const int* tv, void* out,
                         int grid_x, int H, int s, int rows, int nq, int bs,
                         int bp, float scale, cudaStream_t stream) {
  if (IsCode<TP>::value && (ksp == nullptr || vsp == nullptr))
    return cudaErrorInvalidValue;
  auto kern = paged_attn_kernel<TQ, TP, D, NT, MAXROWS>;
  const size_t smem = paged_smem_bytes(rows, D, KeyTile<D>::value);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  dim3 grid(grid_x, H);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(kp),
      static_cast<const TP*>(vp), ksp, vsp, table, tv, static_cast<TQ*>(out),
      s, rows, nq, H, bs, bp, scale);
  return cudaGetLastError();
}

}  // namespace ptt
