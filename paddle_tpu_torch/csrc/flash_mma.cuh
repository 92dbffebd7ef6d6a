// Warp-level tensor-core building blocks for the attention kernels on
// Hopper (sm_90a): cp.async staging, ldmatrix fragment loads and the
// bf16 and fp16 mma.sync.m16n8k16 products, each as inline PTX. The
// forward (flash_fwd.cu), the dK/dV and dQ backward bodies
// (flash_bwd.cu), in bf16 and fp16 alike, and the bf16 chunk prefill
// (chunk_prefill.cu) and paged decode (paged_attention.cu) are built
// from them. The fp16 fragments have the bf16 ones' layout, and cp.async
// and ldmatrix move 16-bit elements whatever they hold, so the staging
// and the address patterns take either type; what differs is the
// product instruction and the rounding of fp32 values into operands and
// outputs (Elem<T>).
//
// Fragment layouts, as the PTX ISA fixes them for
// mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, with
// lane = 0..31, g = lane / 4 (the group) and t = lane % 4:
//  - A, 16 x 16 row-major, four 32-bit registers of two bf16 each:
//      a0 = A[g][2t, 2t+1],     a1 = A[g+8][2t, 2t+1],
//      a2 = A[g][2t+8, 2t+9],   a3 = A[g+8][2t+8, 2t+9];
//  - B, 16 x 8 ("col", i.e. stored n-major), two registers:
//      b0 = B[2t, 2t+1][g],     b1 = B[2t+8, 2t+9][g];
//  - C / D, 16 x 8 fp32, four registers:
//      c0, c1 = C[g][2t, 2t+1], c2, c3 = C[g+8][2t, 2t+1].
// The lower 16 bits of a register hold the element of the lower index.
//
// ldmatrix.x4 loads four 8 x 8 b16 matrices; lane l names the address of
// row l % 8 of matrix l / 8, each row 16 contiguous bytes in shared
// memory. Without .trans, lane l receives row l / 4, elements 2(l % 4)
// and 2(l % 4) + 1 of each matrix: an A fragment of a row-major tile, or
// a B fragment of a tile stored n-major (K rows for Q.K^T: a K row is a
// column of K^T). With .trans it receives rows 2(l % 4), 2(l % 4) + 1 of
// column l / 4: a B fragment of a tile stored k-major (V rows for P.V),
// or an A fragment of a tile stored column-major (the backward's dS^T
// tile, key rows, read as the A operand of dQ = dS.K). The address
// patterns for the four uses are a_x4, b_x4, bt_x4 and at_x4.
//
// Two n8 accumulator tiles side by side are, once rounded to bf16, one
// k16 A fragment of the next product (pack_a): P = softmax(Q.K^T) goes
// from the first product's accumulators into the second's A operand in
// registers, with no shuffle and no shared-memory round trip.
//
// Shared-memory tiles are bf16 rows padded by 16 bytes (row stride
// D + 8 elements): the eight 16-byte rows that one ldmatrix phase reads
// start 4 banks apart, so they cover all 32 banks once (no conflict),
// and every row start stays 16-byte aligned for cp.async.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_fp16.h>

namespace ptt {
namespace mma {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously. With `valid`
// false the source size is 0: the 16 bytes are zero-filled and nothing
// is read; `src` must still be an address inside the tensor (callers
// clamp the row), so no out-of-range address is ever formed.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 8 bytes from global to shared memory, asynchronously (.ca), zero-filled
// when !valid, `src` clamped by the caller as for cp_async_16: the int8
// pool rows of a head dim that is no multiple of 16 (paged_common.cuh).
__device__ __forceinline__ void cp_async_8(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}

// 4 bytes (one fp32 value) from global to shared memory, asynchronously
// (.ca: the .cg form takes 16 bytes only); zero-filled when !valid, with
// `src` clamped by the caller as for cp_async_16.
__device__ __forceinline__ void cp_async_4(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
// Other threads' copies are visible only after a barrier as well.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a . b: one 16 x 8 x 16 bf16 product, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a . b with fp16 operands, fp32 accumulate (K5's int8 body: P
// and the V codes, which fp16 holds exactly).
__device__ __forceinline__ void mma_f16(float (&d)[4], const uint32_t (&a)[4],
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to fp16 (to nearest even), lo in the lower half. Not
// saturating: a value past fp16's range (65504) becomes inf, so an
// overflow of P, dS or an output reaches the caller (the loss scaler
// skips the step on it) instead of turning into a finite wrong value.
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  const __half2 v = __float22half2_rn(make_float2(lo, hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (lo, hi) rounded to bf16 (to nearest even), lo in the lower half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __float22bfloat162_rn(make_float2(lo, hi));
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The k16 A fragment formed by two adjacent n8 accumulator tiles c (keys
// 0-7 of the k-step) and c8 (keys 8-15), rounded to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&c)[4],
                                       const float (&c8)[4]) {
  a[0] = pack_bf16(c[0], c[1]);
  a[1] = pack_bf16(c[2], c[3]);
  a[2] = pack_bf16(c8[0], c8[1]);
  a[3] = pack_bf16(c8[2], c8[3]);
}

// pack_a, rounded to fp16.
__device__ __forceinline__ void pack_a_f16(uint32_t (&a)[4],
                                           const float (&c)[4],
                                           const float (&c8)[4]) {
  a[0] = pack_f16(c[0], c[1]);
  a[1] = pack_f16(c[2], c[3]);
  a[2] = pack_f16(c8[0], c8[1]);
  a[3] = pack_f16(c8[2], c8[3]);
}

// The element types of the tensor-core bodies: the m16n8k16 product of
// two fragments of T (fp32 accumulate), and fp32 values rounded to T,
// two to a register (pack) or as the k16 A fragment of two n8
// accumulator tiles (pack_a).
template <typename T>
struct Elem;

template <>
struct Elem<bf16> {
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_bf16(d, a, b0, b1);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return pack_bf16(lo, hi);
  }
  static __device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                                const float (&c)[4],
                                                const float (&c8)[4]) {
    ::ptt::mma::pack_a(a, c, c8);
  }
};

template <>
struct Elem<__half> {
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    mma_f16(d, a, b0, b1);
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    return pack_f16(lo, hi);
  }
  static __device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                                const float (&c)[4],
                                                const float (&c8)[4]) {
    pack_a_f16(a, c, c8);
  }
};

// Lane addresses for ldmatrix.x4 in a tile of row stride LDS elements:
//  a_x4:  the A fragment of rows [r0, r0 + 16) x cols [c0, c0 + 16);
//  b_x4:  B fragments (b0, b1) of n8 tiles n0 and n0 + 8 at k [c0, c0 +
//         16), the tile stored n-major (row n holds k contiguous);
//  bt_x4: with .trans, B fragments (b0, b1) of n8 tiles c0 and c0 + 8 at
//         k [r0, r0 + 16), the tile stored k-major (row k holds n);
//  at_x4: with .trans, the A fragment of rows [r0, r0 + 16) x cols
//         [c0, c0 + 16), the tile stored column-major (storage row c
//         holds column c of A, its rows contiguous). Matrix l / 8 is
//         A's 8 x 8 block (rows r0 + 8 ((l / 8) % 2), cols c0 + 8 (l /
//         16)), so the four land in a0..a3's order.
template <int LDS, typename T>
__device__ __forceinline__ const T* a_x4(const T* s, int r0, int c0,
                                            int lane) {
  return s + (r0 + lane % 16) * LDS + c0 + (lane / 16) * 8;
}
template <int LDS, typename T>
__device__ __forceinline__ const T* b_x4(const T* s, int n0, int c0,
                                            int lane) {
  return s + (n0 + (lane / 16) * 8 + lane % 8) * LDS + c0 +
         ((lane / 8) % 2) * 8;
}
template <int LDS, typename T>
__device__ __forceinline__ const T* bt_x4(const T* s, int r0, int c0,
                                             int lane) {
  return s + (r0 + ((lane / 8) % 2) * 8 + lane % 8) * LDS + c0 +
         (lane / 16) * 8;
}

template <int LDS, typename T>
__device__ __forceinline__ const T* at_x4(const T* s, int r0, int c0,
                                             int lane) {
  return s + (c0 + (lane / 16) * 8 + lane % 8) * LDS + r0 +
         ((lane / 8) % 2) * 8;
}

// Stage rows [r0, r0 + ROWS) of one (batch, head) of a 16-bit (B, S, H, dh)
// tensor into `dst` (row stride LDS, D >= dh columns) with NT threads, 16
// bytes a thread per step. `src` points at row 0 of the (batch, head);
// rows are `ss` elements apart. Rows at or past S, and the columns past
// the head dim dh (a multiple of 8, so whole 16-byte chunks), are
// zero-filled and never read: the padded columns add 0 to every product
// over the head dim. Needs `src` 16-byte aligned and `ss` a multiple of 8
// elements.
template <int ROWS, int D, int LDS, int NT, typename T>
__device__ __forceinline__ void tile_async(T* __restrict__ dst,
                                           const T* __restrict__ src,
                                           int r0, int S, int64_t ss,
                                           int dh) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  static_assert(ROWS * CPR % NT == 0, "chunks must split evenly");
#pragma unroll
  for (int u = 0; u < ROWS * CPR / NT; ++u) {
    const int idx = threadIdx.x + u * NT, r = idx / CPR, c = idx % CPR;
    const int row = r0 + r;
    const bool col = c * 8 < dh;
    cp_async_16(dst + r * LDS + c * 8,
                src + static_cast<int64_t>(min(row, S - 1)) * ss +
                    (col ? c * 8 : 0),
                row < S && col);
  }
}

// Rows [r0, r0 + ROWS) of one fp32 row vector (the backward's lse and
// delta) into `dst`, one value a thread; rows at or past S are
// zero-filled and never read.
template <int ROWS>
__device__ __forceinline__ void rows_async(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int r0, int S) {
  const int i = threadIdx.x, row = r0 + i;
  if (i < ROWS) cp_async_4(dst + i, src + min(row, S - 1), row < S);
}

}  // namespace mma
}  // namespace ptt
