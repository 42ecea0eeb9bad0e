// Tensor-core pieces of the bf16 kernels: K1, K3 and K4 in their bf16
// forms (corr_lookup_moenc.cu, deform_conv.cu, window_attention.cu).
//
// One pass of mma.sync.m16n8k16 with bf16 operands and fp32 accumulators.
// A product of two bf16 values is exact in fp32, so a tile's sums differ
// from an fp32 matrix product of the same bf16 values only in summation
// order: this single pass is the TPU kernels' bf16 x bf16 -> fp32
// contraction (beside tf32_mma.cuh's 3xTF32 split of fp32 operands).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bf {

// x rounded to bf16 (to nearest even), back in fp32.
__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Two values rounded to bf16 and packed as one mma operand register: lo
// in the low half (the lower k index of the pair), hi in the high half.
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The two bf16 halves of a packed register, in fp32.
__device__ __forceinline__ float lo(uint32_t v) {
  return __uint_as_float(v << 16);
}
__device__ __forceinline__ float hi(uint32_t v) {
  return __uint_as_float(v & 0xffff0000u);
}

// d += a · b for one m16n8k16 tile. With g = lane / 4, t = lane % 4:
// a[0] rows g, k 2t, 2t + 1; a[1] row g + 8, the same k; a[2] row g, k
// 2t + 8, 2t + 9; a[3] row g + 8, those k. b0: k 2t, 2t + 1 of column g;
// b1: k 2t + 8, 2t + 9 of column g. d: rows g, g + 8 x columns 2t, 2t + 1
// (d[0], d[1] row g; d[2], d[3] row g + 8), as tf32_mma.cuh's tile.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8 x 8 bf16 matrices from shared memory, transposed: lanes 8i ..
// 8i + 7 give the row addresses of matrix i; register i of lane (g, t)
// receives rows 2t, 2t + 1 of column g of matrix i, i.e. an mma B fragment
// when the matrix rows are k and its columns n.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* row) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// 16 bytes from src to dst (shared), or 16 zero bytes when !live.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(d), "l"(src), "r"(live ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(kPending) : "memory");
}

}  // namespace bf
