// K4: paged decode/verify attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// (_paged_kernel, reached through paged_attention_pallas), full-precision
// branch. q (b, s, H, D) at per-slot offsets t (b,) attends its slot's
// KV through the block table; query row i reads cols <= t + i.
//
// Bound on the H100: bytes. Decode reads each slot's committed K and V
// once (sum over slots of (t+1)*H*D*2 elements) and does ~4 flops per
// element read — far below the balance point, so the only lever is to
// read fewer bytes and keep enough of them in flight. The design reads
// exactly the rows a slot can attend (the walk stops at t+s-1) straight
// from the pool through the table, never a gathered dense (b, max_len)
// view (the plain version gathers and masks the whole table row), and
// stages them in tiles of 64 keys (32 at D=128) with every load of a
// tile issued before the first store.
//
// Grid (b, H): one CTA per (slot, head) holds the slot's s <= 16 query
// rows. At b=8 and H=12 this fills 96 of the 132 SMs, and one CTA
// streams a whole slot's history alone, so the longest slot sets the
// time; splitting the walk across CTAs with a logsumexp merge
// (flash-decoding) is later work.
#include "paged_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRows = 16;

template <typename T>
cudaError_t by_dim(const void* q, const void* kp, const void* vp,
                   const int* table, const int* t, void* out, int b, int s,
                   int H, int D, int bs, int bp, float scale,
                   cudaStream_t st) {
  if (D == 64)
    return ptt::launch_paged<T, 64, kThreads, kMaxRows>(
        q, kp, vp, table, t, out, b, H, s, /*rows=*/s, /*nq=*/1, bs, bp,
        scale, st);
  if (D == 128)
    return ptt::launch_paged<T, 128, kThreads, kMaxRows>(
        q, kp, vp, table, t, out, b, H, s, /*rows=*/s, /*nq=*/1, bs, bp,
        scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched).
extern "C" int ptt_paged_attention_fwd(const void* q, const void* k_pool,
                                       const void* v_pool, const void* table,
                                       const void* t, void* out, int b, int s,
                                       int H, int D, int bs, int bp,
                                       float scale, int dtype, void* stream) {
  if (b < 1 || s < 1 || s > kMaxRows || H < 1 || bs < 1 || bp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(table);
  const int* tv = static_cast<const int*>(t);
  switch (dtype) {
    case ptt::kFloat32:
      return static_cast<int>(by_dim<float>(q, k_pool, v_pool, tbl, tv, out,
                                            b, s, H, D, bs, bp, scale, st));
    case ptt::kBFloat16:
      return static_cast<int>(by_dim<__nv_bfloat16>(
          q, k_pool, v_pool, tbl, tv, out, b, s, H, D, bs, bp, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
