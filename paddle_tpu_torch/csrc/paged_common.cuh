// The CUDA-core attention body that K4 (paged decode/verify) and K5
// (chunk prefill) run for fp32 queries, over fp32 pools or int8 code
// pools. bf16 queries run tensor-core bodies instead: K4's cluster-split
// paged_decode_mma_kernel in paged_attention.cu, K5's
// chunk_prefill_mma_kernel in chunk_prefill.cu. fp32 stays on the CUDA
// cores in fp32 (no TF32, no HMMA): the fp32 contract is 2e-5 of the
// plain version.
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
// Bound on the H100: K4 reads each slot's committed K and V once and does
// ~4 flops an element read, so bytes bind it; K5's chunk of 128 rows over
// a prefix of ~500 does ~4 * 128 * 581 * H * D flops and binds on the
// CUDA cores' 67 TFLOP/s. What held the first version back was neither:
// one CTA per (slot, head, q-block) walked its keys alone (24 CTAs on 132
// SMs for a chunk, 96 for the decode step), K5's q-block followed the
// reference's (25 CTAs of 4 rows a head at s 100, each re-reading the
// prefix), and each FMA read its operand from shared memory.
//
// paged_f32_kernel<TP, D, RT> (TP: float, or int8_t codes):
//  - Its own row tile: a CTA owns RT query rows (16, 32 or 64, chosen by
//    the C entry from s, whatever q-block the wrapper picked) of one
//    (slot, head); the rows are independent (chunk_prefill.py:30-43).
//    Grid C * b * ceil(s / RT) * H (on x) in clusters of C: the C CTAs
//    of a cluster split one row tile's key walk. Each reads t[slot] on
//    the device, takes the tile's reach, min(base + rows - 1, bp*bs - 1),
//    and its T = reach / KT + 1 key tiles, and rank r walks tiles
//    [r T / C, (r + 1) T / C): the host never reads t. C comes from the
//    grid's CTAs against the SM count and from the table's size
//    (f32_splits), never from t. The
//    chunk's last row tile, which reads the most keys, launches first.
//  - Key tiles of KT rows (64 at D 64, 32 at D 128) come through a
//    two-stage cp.async ring, both stages issued before the first is
//    read, gathered row by row through the table: key row col of the
//    slot sits at (table[col / bs] * bs + col % bs) * H * D + h * D, D
//    contiguous elements, so 16-byte chunks. Rows past the reach are
//    zero-filled from the address of row `reach` (src-size 0): no row,
//    table entry or scale past the reach is ever read. int8 codes land at
//    a byte an element beside each row's (block, head) scales (one
//    4-byte copy a row), and are turned into an fp32 tile, code times its
//    row's scale (the plain version's codes.float() * scale), before QK.
//  - Register tiles. The 256 threads are 16 row groups of 16 lanes; a
//    thread owns rows grp + 16 r (r < RT / 16). In QK a lane owns keys
//    lane + 16 c of the tile: each step reads a float4 of q for each of
//    its rows and of K for each of its keys (K rows padded to D + 4
//    floats: eight lanes' float4 cover the 32 banks once) and does rows
//    x keys x 4 FMAs. The online softmax runs on those registers: a row's
//    max and sum over its group's 16 lanes by shuffles, in log2 units (q
//    is scaled by scale * log2(e) as it is staged). P goes to shared
//    memory, and in P.V a lane owns dims 4 lane + 64 x: each step of four
//    keys reads a float4 of P for each row and one of V for each key and
//    dim slice, and does rows x 4 x 4 FMAs into its accumulators.
//  - The merge: each CTA writes its rows' m, l and o over its q rows,
//    then cluster.sync(), and rank r merges every float4 of output whose
//    index is r modulo C from all ranks' partials through distributed
//    shared memory (m = max m_r, l = sum l_r 2^(m_r - m), O likewise /
//    l). A second cluster.sync() follows the last remote read. A rank
//    with no tile takes part with m = -1e30, l = 0, o = 0.
//
// Contracts kept from the TPU kernels:
//  - query row i (absolute position base+i) reads columns col <= base+i;
//    masked logits are -1e30, never -inf (paged_attention.py:55), so
//    exp() and max() stay NaN-free; a row whose keys so far are all
//    masked (a rank's keys can all lie past it) keeps p = 0;
//  - no row past the tile's reach is loaded, nor its scale, so a
//    poisoned pool proves it;
//  - row independence (chunk_prefill.py:30-43): no state crosses query
//    rows, masking uses absolute positions, and only rows committed
//    before the launch are read.
//  - cp.async needs 16-byte aligned pools, and float4 stores a 16-byte
//    aligned out: the C entries refuse anything else
//    (cudaErrorInvalidValue). q is staged by plain loads.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "common.cuh"
#include "flash_mma.cuh"

namespace ptt {

constexpr float kMaskedLogit = -1e30f;

template <typename TP>
struct IsCode {  // int8 codes of a quantized pool
  static constexpr bool value = false;
};
template <>
struct IsCode<int8_t> {
  static constexpr bool value = true;
};

constexpr int kF32Threads = 256;
constexpr int kF32Lanes = 16;   // lanes of a row group
constexpr int kF32Groups = kF32Threads / kF32Lanes;
constexpr int kF32Stages = 2;   // cp.async ring depth
constexpr int kF32MaxSplits = 8;  // CTAs of a cluster, the portable most
constexpr int kF32CTAsPerSM = 4;  // the split's target: grid CTAs an SM
                                  // at 16-row tiles (4 * 16 / RT at RT)

// Key rows a tile: 64 at D 64, 32 at D 128 (a stage stays ~33 KB).
template <int D>
struct F32Keys {
  static constexpr int value = D == 64 ? 64 : 32;
};

// The body's dynamic shared memory: q rows (then the CTA's partial o),
// P, each row's m and l, over int8 pools one converted fp32 K and V tile,
// and the ring's stages (fp32 K and V rows, or codes and their scales).
template <typename TP, int D, int RT>
struct F32Smem {
  static constexpr bool kCode = IsCode<TP>::value;
  static constexpr int KT = F32Keys<D>::value;
  static constexpr int KP = D + 4;   // K row stride, floats
  static constexpr int PP = KT + 4;  // P row stride, floats
  static constexpr size_t q = RT * KP;               // floats
  static constexpr size_t p = RT * PP;
  static constexpr size_t ml = 2 * RT;
  static constexpr size_t tile = KT * KP + KT * D;   // an fp32 K, V tile
  static constexpr size_t stage =                    // bytes
      kCode ? 2 * KT * D + 2 * KT * sizeof(float) : tile * sizeof(float);
  static constexpr size_t bytes =
      (q + p + ml + (kCode ? tile : 0)) * sizeof(float) + kF32Stages * stage;
  static_assert(stage % 16 == 0 && (q + p + ml) % 4 == 0 && tile % 4 == 0,
                "16-byte aligned regions");
};

// CTAs an SM the register budget is cut for: 3 at 16-row tiles, 2 above
// (1 at D 128 and 64 rows, whose tiles need more than 128 registers)
template <int D, int RT>
struct F32Occupancy {
  static constexpr int value = RT == 16 ? 3 : D == 128 && RT == 64 ? 1 : 2;
};

template <typename TP, int D, int RT>
__global__ void __launch_bounds__(kF32Threads, F32Occupancy<D, RT>::value)
    paged_f32_kernel(const float* __restrict__ q, const TP* __restrict__ kp,
                     const TP* __restrict__ vp, const float* __restrict__ ksp,
                     const float* __restrict__ vsp,
                     const int* __restrict__ table,
                     const int* __restrict__ tv, float* __restrict__ out,
                     int s, int ntile, int H, int bs, int bp, float scale) {
  namespace cg = cooperative_groups;
  using L = F32Smem<TP, D, RT>;
  constexpr bool kCode = L::kCode;
  constexpr int KT = L::KT, KP = L::KP, PP = L::PP;
  constexpr int NT = kF32Threads;
  constexpr int MR = RT / kF32Groups;  // rows a thread
  constexpr int MC = KT / kF32Lanes;   // keys a lane (QK)
  constexpr int MD = D / 64;           // float4 dim slices a lane (PV)
  static_assert(RT % kF32Groups == 0 && KT % kF32Lanes == 0 && D % 64 == 0,
                "tile shapes must divide the CTA");
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);  // RT x KP, then o (RT x D)
  float* ps = qs + L::q;                         // RT x PP
  float* pm = ps + L::p;                         // RT
  float* pl = pm + RT;                           // RT
  float* cv = pl + RT;                           // int8: KT x KP, KT x D
  char* ring = reinterpret_cast<char*>(cv + (kCode ? L::tile : 0));

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int nsplit = static_cast<int>(cluster.num_blocks());
  const int h = blockIdx.x / nsplit % H, unit = blockIdx.x / nsplit / H;
  const int slot = unit / ntile;
  const int tile = ntile - 1 - unit % ntile;  // the deepest tile first
  const int row0 = tile * RT, nrows = min(RT, s - row0);
  const int64_t rs = static_cast<int64_t>(H) * D;  // row stride, elements
  const int64_t q_row0 = static_cast<int64_t>(slot) * s + row0;
  const int base = tv[slot] + row0;  // position of this tile's row 0
  const int reach = min(base + nrows - 1, bp * bs - 1);
  const int n_tiles = reach / KT + 1;
  // this rank's key tiles: an even share of the row tile's
  const int tile_lo = rank * n_tiles / nsplit,
            tile_hi = (rank + 1) * n_tiles / nsplit;
  const int* trow = table + static_cast<int64_t>(slot) * bp;
  const int tid = threadIdx.x, grp = tid / kF32Lanes, lane = tid % kF32Lanes;
  // the 16 lanes of this thread's row group, for the group's shuffles
  const unsigned gmask = 0xffffu << (16 * (grp & 1));
  const bool busy = grp < nrows;  // the thread owns a row of the tile

  // key tile j into the ring stage (j - tile_lo) % kF32Stages
  auto issue = [&](int j) {
    char* sb = ring + ((j - tile_lo) % kF32Stages) * L::stage;
    if constexpr (!kCode) {
      float* kd = reinterpret_cast<float*>(sb);
      float* vd = kd + KT * KP;
      constexpr int CPR = D / 4;  // 16-byte chunks a row
      static_assert(KT * CPR % NT == 0, "chunks must split evenly");
#pragma unroll
      for (int x = 0; x < KT * CPR / NT; ++x) {
        const int idx = tid + x * NT, r = idx / CPR, c = idx % CPR;
        const int col = j * KT + r, cl = min(col, reach);
        const int64_t off =
            (static_cast<int64_t>(trow[cl / bs]) * bs + cl % bs) * rs +
            h * D + c * 4;
        mma::cp_async_16(kd + r * KP + c * 4, kp + off, col <= reach);
        mma::cp_async_16(vd + r * D + c * 4, vp + off, col <= reach);
      }
    } else {
      int8_t* kd = reinterpret_cast<int8_t*>(sb);
      int8_t* vd = kd + KT * D;
      float* ksd = reinterpret_cast<float*>(vd + KT * D);
      float* vsd = ksd + KT;
      constexpr int CPR = D / 16;
      static_assert(KT * CPR % NT == 0, "chunks must split evenly");
#pragma unroll
      for (int x = 0; x < KT * CPR / NT; ++x) {
        const int idx = tid + x * NT, r = idx / CPR, c = idx % CPR;
        const int col = j * KT + r, cl = min(col, reach);
        const int64_t off =
            (static_cast<int64_t>(trow[cl / bs]) * bs + cl % bs) * rs +
            h * D + c * 16;
        mma::cp_async_16(kd + r * D + c * 16, kp + off, col <= reach);
        mma::cp_async_16(vd + r * D + c * 16, vp + off, col <= reach);
      }
      if (tid < 2 * KT) {  // the k scales, then the v scales, one a row
        const int r = tid % KT, col = j * KT + r, cl = min(col, reach);
        const int64_t at = static_cast<int64_t>(trow[cl / bs]) * H + h;
        if (tid < KT)
          mma::cp_async_4(ksd + r, ksp + at, col <= reach);
        else
          mma::cp_async_4(vsd + r, vsp + at, col <= reach);
      }
    }
  };

  if (tile_hi > tile_lo) {
    // the tile's q rows in log2 units (rows past nrows 0, never stored)
    const float sl = scale * 1.4426950408889634f;
    for (int e = tid; e < RT * D; e += NT) {
      const int i = e / D, d = e % D;
      qs[i * KP + d] = i < nrows ? q[(q_row0 + i) * rs + h * D + d] * sl : 0.f;
    }
  }
  // groups in flight: this rank's first two tiles (empty past its last)
#pragma unroll
  for (int u = 0; u < kF32Stages; ++u) {
    if (tile_lo + u < tile_hi) issue(tile_lo + u);
    mma::cp_async_commit();
  }

  float m[MR], l[MR], acc[MR][MD][4];
#pragma unroll
  for (int r = 0; r < MR; ++r) {
    m[r] = kMaskedLogit;
    l[r] = 0.f;
#pragma unroll
    for (int x = 0; x < MD; ++x)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[r][x][e] = 0.f;
  }

  for (int j = tile_lo; j < tile_hi; ++j) {
    mma::cp_async_wait<kF32Stages - 1>();
    __syncthreads();  // tile j has landed, every thread's share (and q)
    const char* sb = ring + ((j - tile_lo) % kF32Stages) * L::stage;
    const float* kt = reinterpret_cast<const float*>(sb);
    const float* vt = kt + KT * KP;
    if constexpr (kCode) {
      // codes times their row's scale into the fp32 tile
      const int8_t* kc = reinterpret_cast<const int8_t*>(sb);
      const int8_t* vc = kc + KT * D;
      const float* ksd = reinterpret_cast<const float*>(vc + KT * D);
      const float* vsd = ksd + KT;
      float* kd = cv;
      float* vd = cv + KT * KP;
      for (int e = tid; e < KT * D / 4; e += NT) {
        const int r = e / (D / 4), c = e % (D / 4);
        const char4 a = reinterpret_cast<const char4*>(kc + r * D)[c];
        const char4 v = reinterpret_cast<const char4*>(vc + r * D)[c];
        const float ks = ksd[r], vs = vsd[r];
        *reinterpret_cast<float4*>(kd + r * KP + c * 4) =
            make_float4(a.x * ks, a.y * ks, a.z * ks, a.w * ks);
        *reinterpret_cast<float4*>(vd + r * D + c * 4) =
            make_float4(v.x * vs, v.y * vs, v.z * vs, v.w * vs);
      }
      __syncthreads();
      // the stage is free: tile j + 2 may land in it
      if (j + kF32Stages < tile_hi) issue(j + kF32Stages);
      mma::cp_async_commit();
      kt = kd;
      vt = vd;
    }
    if (busy) {
      // S = q.K^T of this thread's rows and keys
      float sc[MR][MC];
#pragma unroll
      for (int r = 0; r < MR; ++r)
#pragma unroll
        for (int c = 0; c < MC; ++c) sc[r][c] = 0.f;
      // a row a thread: half the loads in flight, within 3 CTAs' registers
#pragma unroll (MR == 1 ? 2 : 4)
      for (int x = 0; x < D / 4; ++x) {
        float4 qv[MR], kv[MC];
#pragma unroll
        for (int r = 0; r < MR; ++r)
          qv[r] = reinterpret_cast<const float4*>(
              qs + (grp + kF32Groups * r) * KP)[x];
#pragma unroll
        for (int c = 0; c < MC; ++c)
          kv[c] = reinterpret_cast<const float4*>(
              kt + (lane + kF32Lanes * c) * KP)[x];
#pragma unroll
        for (int r = 0; r < MR; ++r)
#pragma unroll
          for (int c = 0; c < MC; ++c) {
            float a = sc[r][c];
            a = fmaf(qv[r].x, kv[c].x, a);
            a = fmaf(qv[r].y, kv[c].y, a);
            a = fmaf(qv[r].z, kv[c].z, a);
            a = fmaf(qv[r].w, kv[c].w, a);
            sc[r][c] = a;
          }
      }
      // the masks and the online softmax, a row over its group's lanes
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        const int i = grp + kF32Groups * r, pos = base + i;
        float mx = kMaskedLogit;
#pragma unroll
        for (int c = 0; c < MC; ++c) {
          // col <= reach also masks the columns past the table (bp*bs),
          // which a pad row of a chunk running off the table could name
          const int col = j * KT + lane + kF32Lanes * c;
          if (col > pos || col > reach) sc[r][c] = kMaskedLogit;
          mx = fmaxf(mx, sc[r][c]);
        }
#pragma unroll
        for (int o = kF32Lanes / 2; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(gmask, mx, o));
        const float mn = fmaxf(m[r], mx);
        const float alpha = exp2f(m[r] - mn);
        m[r] = mn;
        float sum = 0.f;
#pragma unroll
        for (int c = 0; c < MC; ++c) {
          const float p = mn == kMaskedLogit ? 0.f : exp2f(sc[r][c] - mn);
          ps[i * PP + lane + kF32Lanes * c] = p;
          sum += p;
        }
        l[r] = l[r] * alpha + sum;  // this lane's share; the group adds
#pragma unroll
        for (int x = 0; x < MD; ++x)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][x][e] *= alpha;
      }
    }
    __syncthreads();  // P is complete
    if (busy) {
      // O += P.V: four keys a step
#pragma unroll 2
      for (int c = 0; c < KT; c += 4) {
        float4 pv[MR];
#pragma unroll
        for (int r = 0; r < MR; ++r)
          pv[r] = *reinterpret_cast<const float4*>(
              ps + (grp + kF32Groups * r) * PP + c);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float4 vv[MD];
#pragma unroll
          for (int x = 0; x < MD; ++x)
            vv[x] = *reinterpret_cast<const float4*>(vt + (c + k) * D +
                                                     4 * lane + 64 * x);
#pragma unroll
          for (int r = 0; r < MR; ++r) {
            const float p = k == 0   ? pv[r].x
                            : k == 1 ? pv[r].y
                            : k == 2 ? pv[r].z
                                     : pv[r].w;
#pragma unroll
            for (int x = 0; x < MD; ++x) {
              acc[r][x][0] = fmaf(p, vv[x].x, acc[r][x][0]);
              acc[r][x][1] = fmaf(p, vv[x].y, acc[r][x][1]);
              acc[r][x][2] = fmaf(p, vv[x].z, acc[r][x][2]);
              acc[r][x][3] = fmaf(p, vv[x].w, acc[r][x][3]);
            }
          }
        }
      }
    }
    if constexpr (!kCode) {
      __syncthreads();  // every thread is done with the stage
      if (j + kF32Stages < tile_hi) issue(j + kF32Stages);
      mma::cp_async_commit();
    }
  }

  // the CTA's partial: m, l (summed over the group) and o over the q rows
  mma::cp_async_wait<0>();
  __syncthreads();  // no thread still reads q
  float* po = qs;
  if (busy) {
#pragma unroll
    for (int r = 0; r < MR; ++r) {
      float lr = l[r];
#pragma unroll
      for (int o = kF32Lanes / 2; o > 0; o >>= 1)
        lr += __shfl_xor_sync(gmask, lr, o);
      const int i = grp + kF32Groups * r;
      if (i < nrows) {
#pragma unroll
        for (int x = 0; x < MD; ++x)
          *reinterpret_cast<float4*>(po + i * D + 4 * lane + 64 * x) =
              make_float4(acc[r][x][0], acc[r][x][1], acc[r][x][2],
                          acc[r][x][3]);
        if (lane == 0) {
          pm[i] = m[r];
          pl[i] = lr;
        }
      }
    }
  }
  // every rank's partial is in its shared memory
  cluster.sync();
  // rank r merges the float4 chunks idx = r, r + C, ... of the tile's
  // rows. Some rank reads column 0 of every row, so l > 0.
  constexpr int OC = D / 4;
  for (int idx = rank + nsplit * tid; idx < nrows * OC;
       idx += nsplit * NT) {
    const int row = idx / OC, c = idx % OC;
    float mr[kF32MaxSplits];
    float mm = kMaskedLogit;
#pragma unroll
    for (int r = 0; r < kF32MaxSplits; ++r)
      if (r < nsplit) {
        mr[r] = *cluster.map_shared_rank(pm + row, r);
        mm = fmaxf(mm, mr[r]);
      }
    float ls = 0.f;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < kF32MaxSplits; ++r)
      if (r < nsplit) {
        const float a = exp2f(mr[r] - mm);
        ls += *cluster.map_shared_rank(pl + row, r) * a;
        const float4 x = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(po + row * D + c * 4, r));
        o.x += x.x * a;
        o.y += x.y * a;
        o.z += x.z * a;
        o.w += x.w * a;
      }
    const float inv = 1.f / ls;
    *reinterpret_cast<float4*>(out + (q_row0 + row) * rs + h * D + c * 4) =
        make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv);
  }
  // no CTA leaves while another still reads its shared memory
  cluster.sync();
}

// CTAs of a cluster for a grid of `units` walks of RT-row tiles over a
// table of `max_tiles` key tiles: the largest of 8, 4, 2, 1 that keeps the
// grid within kF32CTAsPerSM * 16 / RT CTAs an SM and is no larger than
// max_tiles. A 16-row tile's walk does little arithmetic: latency binds
// it, and 4 CTAs an SM hide it. A 64-row tile's products bind: one CTA
// an SM has the SM's FMAs to itself, more share them and add merges. A
// cluster of more CTAs than the table has key tiles leaves ranks idle.
// Both come from the launch's shape and the card's `sms`, never from t.
inline int f32_splits(int64_t units, int RT, int max_tiles, int sms) {
  const int64_t target = static_cast<int64_t>(kF32CTAsPerSM) * 16 / RT * sms;
  int c = kF32MaxSplits;
  while (c > 1 && (units * c > target || c > max_tiles)) c /= 2;
  return c;
}

// cp.async and the float4 stores: 16-byte aligned pools and out.
inline bool f32_aligned(const void* kp, const void* vp, const void* out) {
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return al(kp) && al(vp) && al(out);
}

// Launch paged_f32_kernel<TP, D, RT> on b slots of s query rows: grid
// C * b * ceil(s / RT) * H in clusters of C.
template <typename TP, int D, int RT>
cudaError_t launch_f32(const void* q, const void* kp, const void* vp,
                       const float* ksp, const float* vsp, const int* table,
                       const int* tv, void* out, int b, int s, int H, int bs,
                       int bp, float scale, cudaStream_t stream) {
  if ((IsCode<TP>::value && (ksp == nullptr || vsp == nullptr)) ||
      !f32_aligned(kp, vp, out))
    return cudaErrorInvalidValue;
  auto kern = paged_f32_kernel<TP, D, RT>;
  const size_t smem = F32Smem<TP, D, RT>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const int sms = sm_count();
  if (sms == 0) return cudaErrorInvalidDevice;
  const int ntile = (s + RT - 1) / RT;
  const int64_t units = static_cast<int64_t>(b) * ntile * H;
  if (units * kF32MaxSplits > 0x7fffffff ||
      static_cast<int64_t>(bp) * bs > (1 << 30))
    return cudaErrorInvalidValue;
  const int c = f32_splits(units, RT, (bp * bs + F32Keys<D>::value - 1) /
                                          F32Keys<D>::value, sms);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(c * units));
  cfg.blockDim = dim3(kF32Threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = c;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const float*>(q),
                         static_cast<const TP*>(kp),
                         static_cast<const TP*>(vp), ksp, vsp, table, tv,
                         static_cast<float*>(out), s, ntile, H, bs, bp,
                         scale);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace ptt
