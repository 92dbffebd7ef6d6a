// K5: chunk-prefill attention for Hopper (sm_90a).
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/chunk_prefill.py
// (_chunk_kernel, reached through chunk_prefill_pallas), full-precision
// branch. A prompt chunk q (b, s, H, D) at start offset t (b,; the
// wrapper broadcasts the engine's scalar) attends the paged pool: row i
// reads cols <= start + i — causal inside the chunk, full attention over
// the committed prefix.
//
// Bound on the H100: for a 128-row chunk over a prefix of a few hundred
// rows the kernel moves ~(start+s)*H*D*2 elements and does
// ~4*s*(start+s/2)*H*D flops, so it sits near the balance point. This
// version does its dot products on the CUDA cores in fp32 (register
// micro-tiles fed by float4 shared-memory reads) and is bound by them
// and by its few CTAs. Tensor-core tiles (mma/wgmma) and TMA staging of
// the K/V tiles are later work.
//
// Grid (b * nq, H): the chunk is cut into nq q-blocks of qbs rows
// (_pick_qbs(s) of chunk_prefill.py:159, capped at 64 by the wrapper:
// the q tile and the qbs x 64 logit tile in shared memory, and up to
// qbs*D/256 fp32 accumulators per thread in registers, must fit one
// CTA). Each CTA walks only the key rows its deepest row can read,
// min(base+qbs-1, bp*bs-1). Non-power-of-two chunk lengths run with the
// q-block _pick_qbs gives them (1 for odd lengths).
#include "paged_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRows = 64;

template <typename T>
cudaError_t by_dim(const void* q, const void* kp, const void* vp,
                   const int* table, const int* t, void* out, int b, int s,
                   int qbs, int H, int D, int bs, int bp, float scale,
                   cudaStream_t st) {
  const int nq = s / qbs;
  if (D == 64)
    return ptt::launch_paged<T, 64, kThreads, kMaxRows>(
        q, kp, vp, table, t, out, b * nq, H, s, qbs, nq, bs, bp, scale, st);
  if (D == 128)
    return ptt::launch_paged<T, 128, kThreads, kMaxRows>(
        q, kp, vp, table, t, out, b * nq, H, s, qbs, nq, bs, bp, scale, st);
  return cudaErrorInvalidValue;
}

}  // namespace

// Returns the launch's cudaError_t (0 = launched).
extern "C" int ptt_chunk_prefill_fwd(const void* q, const void* k_pool,
                                     const void* v_pool, const void* table,
                                     const void* t, void* out, int b, int s,
                                     int qbs, int H, int D, int bs, int bp,
                                     float scale, int dtype, void* stream) {
  if (b < 1 || s < 1 || qbs < 1 || qbs > kMaxRows || s % qbs != 0 ||
      H < 1 || bs < 1 || bp < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(table);
  const int* tv = static_cast<const int*>(t);
  switch (dtype) {
    case ptt::kFloat32:
      return static_cast<int>(by_dim<float>(q, k_pool, v_pool, tbl, tv, out,
                                            b, s, qbs, H, D, bs, bp, scale,
                                            st));
    case ptt::kBFloat16:
      return static_cast<int>(by_dim<__nv_bfloat16>(
          q, k_pool, v_pool, tbl, tv, out, b, s, qbs, H, D, bs, bp, scale,
          st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
