// Flash attention for Hopper (sm_90a): what the forward (flash_fwd.cu)
// and the backward kernels (flash_bwd.cu) share.
//
// Layouts. q, k, v are paddle's (B, S, H, dh) with the last dim
// contiguous and any strides on (B, S, H) (GPT passes the per-head
// q/k/v slices of one qkv projection, no copies); k and v share
// strides. O, dO, dQ, dK and dV are contiguous (B, S, H, dh); lse and
// delta are fp32 (B, H, Sq).
//
// Head dims. The forward's bodies are instantiated at a padded head dim
// D, 64 or 128, and take the real one, dh (8 to 128 in steps of 8,
// common.cuh head_dim_ok), at run time: tiles are staged with the
// columns past dh zero-filled, so they add 0 to Q.K^T and P.V, and every
// store past dh is predicated off. The caller's softmax scale
// (1/sqrt(dh) for paddle's attention) is used as given, never
// 1/sqrt(D). The backward's bodies take dh = D, 64 or 128, only: the
// D-128 dK/dV body already uses 253-255 registers, and a run-time bound
// spilled it; the wrapper pads q, k, v and dO of another head dim with
// zero columns (ops/kernels/flash_attention.py BWD_HEAD_DIMS).
//
// Tiles of the CUDA-core kernels (the fp32 kernels): 64-row query tiles
// against 64-row key tiles of one (batch, head), staged in shared memory.
// A CTA has 256 threads in a 16 x 16 grid (ty, tx). In a score tile
// (query rows x key rows) thread (ty, tx) owns rows ty + 16i and columns
// tx + 16j, i, j < 4; in an output tile (rows x head dim) it owns rows
// ty + 16i and dims tx + 16j, j < D/16. Products run on the CUDA cores
// in fp32 (float4 shared-memory reads, K and Q rows padded to D + 4
// floats so eight threads reading eight rows hit 32 distinct banks).
// Every bf16 kernel runs on the tensor cores instead (mma.sync fed by
// ldmatrix and cp.async, flash_mma.cuh): the forward, the dK/dV body
// (K3a, K3b's first pass) and the dQ body (K3b's second pass); their
// designs are in flash_fwd.cu and flash_bwd.cu. wgmma with TMA staging
// is later work.
//
// Contracts kept from paddle_tpu/ops/pallas/flash_attention.py:
//  - the causal mask is TOP-LEFT aligned, rows >= cols (:74-79);
//  - a masked logit is -1e30, never -inf (:33), so max() and exp()
//    stay finite;
//  - bf16 rounds where the Pallas kernels round: P to V's dtype before
//    P.V (:85), P to dO's dtype before dV += P^T dO, dS to the input
//    dtype before dK += dS^T Q and dQ += dS K (:408, :417, :422);
//    softmax state, logits and every accumulator stay fp32.
// Ragged edges: the Pallas kernels pick blocks that divide S; here the
// tiles are fixed and rows past S are zero in shared memory and masked.
#pragma once

#include <cstdint>

#include "common.cuh"

namespace ptt {
namespace flash {

constexpr int kTile = 64;       // query rows and key rows per tile
constexpr int kThreads = 256;   // a 16 x 16 thread grid
constexpr int kPS = kTile + 16; // score-tile row stride: rows ty, ty + 1
                                // of one warp sit 16 banks apart
constexpr float kMasked = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;     // dO, contiguous (B, Sq, H, D); backward only
  const float* lse;     // (B, H, Sq); backward input
  const float* delta;   // rowsum(dO * O), (B, H, Sq); backward only
  void* out;            // O (forward), dQ (fp32 accumulator or T)
  void* dk;
  void* dv;
  float* lse_out;       // forward output
  int B, H, Sq, Sk;
  int dh;               // the real head dim; the body's D is padded
  int64_t q_sb, q_ss, q_sh, kv_sb, kv_ss, kv_sh;
  float scale;
  int causal;
};

// Stage rows [r0, r0 + kTile) of head h, batch b of a fp32 (B, S, H, dh)
// tensor with strides (sb, ss, sh, 1) into `dst`, row stride LDS, D >= dh
// columns. Rows at or past S and columns at or past dh are zero and never
// read from memory. Every load is issued before the first store, so a
// thread's loads are in flight together.
template <int D, int LDS>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int b, int h, int r0, int S,
                                          int64_t sb, int64_t ss, int64_t sh,
                                          int dh) {
  constexpr int N = kTile * D / kThreads;  // elements per thread
  constexpr int RP = kThreads / D;         // rows covered per step
  const int d = threadIdx.x % D, r = threadIdx.x / D;
  const float* base = src + b * sb + h * sh + d;
  float reg[N];
#pragma unroll
  for (int u = 0; u < N; ++u) {
    const int row = r0 + r + u * RP;
    reg[u] = row < S && d < dh ? base[row * ss] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < N; ++u) dst[(r + u * RP) * LDS + d] = reg[u];
}

// Rows [r0, r0 + kTile) of a (B, H, S) fp32 vector (lse, delta).
__device__ __forceinline__ void load_rows(float* __restrict__ dst,
                                          const float* __restrict__ src,
                                          int bh, int r0, int S) {
  const int t = threadIdx.x;
  if (t < kTile)
    dst[t] = r0 + t < S ? src[static_cast<int64_t>(bh) * S + r0 + t] : 0.f;
}

// acc[i][j] = sum_d A[ty + 16i][d] * Bm[tx + 16j][d]: one 64 x 64 score
// tile from two row-major shared-memory tiles of row stride LDS.
template <int D, int LDS>
__device__ __forceinline__ void dot_tile(float (&acc)[4][4],
                                         const float* __restrict__ A,
                                         const float* __restrict__ Bm,
                                         int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int x = 0; x < D / 4; ++x) {
    float4 a[4], bb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = reinterpret_cast<const float4*>(A + (ty + 16 * i) * LDS)[x];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      bb[j] = reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * LDS)[x];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] += (a[i].x * bb[j].x + a[i].y * bb[j].y) +
                     (a[i].z * bb[j].z + a[i].w * bb[j].w);
  }
}

// Whether query row `row` may read key column `col`.
__device__ __forceinline__ bool visible(const Args& a, int row, int col) {
  return row < a.Sq && col < a.Sk && (!a.causal || row >= col);
}

// Raise the kernel's dynamic shared-memory limit when it needs more than
// the default 48 KB.
template <typename K>
cudaError_t allow_smem(K kern, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// Launch the kernel on `grid` x `threads` with `smem` bytes of dynamic
// shared memory.
template <typename K>
cudaError_t launch(K kern, dim3 grid, size_t smem, cudaStream_t stream,
                   const Args& a, int threads = kThreads) {
  cudaError_t e = allow_smem(kern, smem);
  if (e != cudaSuccess) return e;
  kern<<<grid, threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The shape and stride fields every entry point fills the same way.
inline Args make_args(const void* q, const void* k, const void* v, int B,
                      int H, int Sq, int Sk, int dh, int64_t q_sb,
                      int64_t q_ss, int64_t q_sh, int64_t kv_sb, int64_t kv_ss,
                      int64_t kv_sh, float scale, int causal) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.B = B;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.dh = dh;
  a.q_sb = q_sb;
  a.q_ss = q_ss;
  a.q_sh = q_sh;
  a.kv_sb = kv_sb;
  a.kv_ss = kv_ss;
  a.kv_sh = kv_sh;
  a.scale = scale;
  a.causal = causal;
  return a;
}

// The checks every entry point makes before it launches.
inline bool valid_args(const Args& a) {
  return a.B >= 1 && a.H >= 1 && a.Sq >= 1 && a.Sk >= 1 &&
         head_dim_ok(a.dh) && static_cast<int64_t>(a.B) * a.H <= 65535;
}

// The tensor-core kernels stage 16-byte chunks by cp.async: q, k, v and
// `extra` (the forward's O, the backward's dO) 16-byte aligned, and
// every stride on (B, S, H) a multiple of 8 bf16 elements.
inline bool mma_aligned(const Args& a, const void* extra) {
  const auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  return al(a.q) && al(a.k) && al(a.v) && al(extra) &&
         (a.q_sb | a.q_ss | a.q_sh | a.kv_sb | a.kv_ss | a.kv_sh) % 8 == 0;
}

}  // namespace flash
}  // namespace ptt
