// K4: paged decode/verify attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/paged_attention.py
// (_paged_kernel, reached through paged_attention_pallas), both branches:
// full-precision pools, and int8 code pools with (num_blocks, H) scales
// (:134-136; the dequant design is in paged_common.cuh). q (b, s, H, D)
// at per-slot offsets t (b,) attends its slot's KV through the block
// table; query row i reads cols <= t + i.
//
// Bound on the H100: bytes. Decode reads each slot's committed K and V
// once (sum over slots of (t+1)*H*D*2 elements) and does ~4 flops per
// element read — far below the balance point, so the only lever is to
// read fewer bytes and keep enough of them in flight. int8 pools read a
// quarter of fp32's bytes (plus one 4-byte scale per block and head).
// The design reads exactly the rows a slot can attend (the walk stops
// at t+s-1) straight from the pool through the table, never a gathered
// dense (b, max_len) view (the plain version gathers and masks the whole
// table row), and stages them in tiles of 64 keys (32 at D=128) with every load of a
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

template <typename TQ, typename TP>
cudaError_t by_dim(const void* q, const void* kp, const void* vp,
                   const float* ks, const float* vs, const int* table,
                   const int* t, void* out, int b, int s, int H, int D,
                   int bs, int bp, float scale, cudaStream_t st) {
  if (D == 64)
    return ptt::launch_paged<TQ, TP, 64, kThreads, kMaxRows>(
        q, kp, vp, ks, vs, table, t, out, b, H, s, /*rows=*/s, /*nq=*/1,
        bs, bp, scale, st);
  if (D == 128)
    return ptt::launch_paged<TQ, TP, 128, kThreads, kMaxRows>(
        q, kp, vp, ks, vs, table, t, out, b, H, s, /*rows=*/s, /*nq=*/1,
        bs, bp, scale, st);
  return cudaErrorInvalidValue;
}

// Full-precision pools share q's type; int8 pools carry their scales.
template <typename TQ>
cudaError_t by_pool(int pool, const void* q, const void* kp, const void* vp,
                    const float* ks, const float* vs, const int* table,
                    const int* t, void* out, int b, int s, int H, int D,
                    int bs, int bp, float scale, cudaStream_t st) {
  if (pool == ptt::kInt8)
    return by_dim<TQ, int8_t>(q, kp, vp, ks, vs, table, t, out, b, s, H, D,
                              bs, bp, scale, st);
  return by_dim<TQ, TQ>(q, kp, vp, nullptr, nullptr, table, t, out, b, s, H,
                        D, bs, bp, scale, st);
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched). `dtype` is q's type
// code, `pool` the pools' (equal to dtype, or kInt8 with both scales).
extern "C" int ptt_paged_attention_fwd(const void* q, const void* k_pool,
                                       const void* v_pool,
                                       const void* k_scale,
                                       const void* v_scale, const void* table,
                                       const void* t, void* out, int b, int s,
                                       int H, int D, int bs, int bp,
                                       float scale, int dtype, int pool,
                                       void* stream) {
  if (b < 1 || s < 1 || s > kMaxRows || H < 1 || bs < 1 || bp < 1 ||
      (pool != dtype && pool != ptt::kInt8))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* ks = static_cast<const float*>(k_scale);
  const float* vs = static_cast<const float*>(v_scale);
  const int* tbl = static_cast<const int*>(table);
  const int* tv = static_cast<const int*>(t);
  switch (dtype) {
    case ptt::kFloat32:
      return static_cast<int>(by_pool<float>(pool, q, k_pool, v_pool, ks, vs,
                                             tbl, tv, out, b, s, H, D, bs,
                                             bp, scale, st));
    case ptt::kBFloat16:
      return static_cast<int>(by_pool<__nv_bfloat16>(
          pool, q, k_pool, v_pool, ks, vs, tbl, tv, out, b, s, H, D, bs, bp,
          scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
